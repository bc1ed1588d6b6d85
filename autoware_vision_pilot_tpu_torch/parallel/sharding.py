"""Batch sharding and the collectives of data parallelism, the port of
autoware_vision_pilot_tpu/parallel/sharding.py.

Under JAX one SPMD program sees the whole batch, and XLA inserts the
reductions. Here each rank of a world mesh runs its rows of the batch, so
what the JAX program computes over the whole batch is made explicit:

- ``shard_batch`` gives each device its rows (or the whole batch, when its
  rows do not divide the mesh, as JAX replicates it);
- ``pmean_gradients`` averages the gradients over the ranks, once a step;
- inside ``batch_sharded(mesh)`` (the train step's forward and loss) the
  layers and losses see that they hold one rank's rows of a batch:
  BatchNorm2d normalizes with the whole batch's statistics, dropout draws
  the whole batch's mask and keeps the rank's rows (nn/layers.py), and the
  losses' batch-wide sums, quantiles and extrema run over the group
  (``batch_normalizer``, ``batch_gather``).

The rule that makes W ranks give one rank's step: each rank's loss is its
share of the whole batch's loss, so that their mean over the ranks is the
whole batch's loss; the gradients are then averaged. A mean over rows is
its own share, and a sum over the batch divided by a batch-wide normalizer
divides by ``batch_normalizer``, the normalizer over W.

Collectives are all-reduces only: gloo reduces tensors on a card but does
not gather them, and a gather here is an all-reduce of a buffer that holds
each rank's tensor in its own slot and zeros elsewhere (adding zeros is
exact).
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, Iterable, Optional

import torch
import torch.distributed as dist

from ..core.dtypes import tree_map
from ..core.mesh import Mesh, data_devices


def shard_batch(mesh: Mesh, batch: Any) -> list:
    """The batch (a tensor or a tree of them) as each of this process's data
    devices holds it, one tree a device: dim 0 split over the data axis
    where it divides the mesh's size (on a world mesh this rank's rows),
    the whole tensor where it does not, as JAX replicates it."""
    world = mesh.group is not None
    devices = mesh.local_devices if world else data_devices(mesh)
    n = mesh.size if world else len(devices)

    def piece(x, i):
        if not isinstance(x, torch.Tensor):
            return x
        if x.dim() >= 1 and x.shape[0] % mesh.size == 0:
            x = x.chunk(n)[mesh.rank if world else i]
        return x.to(devices[i])

    return [tree_map(lambda x, i=i: piece(x, i), batch) for i in range(len(devices))]


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group; its gradient is the sum of the ranks' gradients
    (each rank's loss depends on every rank's input)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def cross_replica_psum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``x`` summed over the ranks of a world mesh (differentiable); ``x``
    on a mesh of one process."""
    if mesh.group is None:
        return x
    return _AllReduceSum.apply(x, mesh.group)


def all_reduce_mean(mesh: Mesh, value: torch.Tensor) -> torch.Tensor:
    """The mean over the data axis of each shard's mean, shape (1,): on a
    world mesh ``value`` is this rank's shard; on a local mesh it is the
    whole value, split over the data devices."""
    if mesh.group is not None:
        m = value.float().mean().reshape(1)
        dist.all_reduce(m, group=mesh.group)
        return m / mesh.size
    shards = value.chunk(len(data_devices(mesh)))
    return (torch.stack([s.float().mean() for s in shards]).sum() / len(shards)).reshape(1)


def _flat_view(t: torch.Tensor) -> torch.Tensor:
    """``t``'s elements as a 1-D view in memory order (a gradient is dense,
    contiguous or channels_last like its parameter)."""
    if not (t.is_contiguous() or t.is_contiguous(memory_format=torch.channels_last)):
        raise ValueError(f"a gradient of shape {tuple(t.shape)} and strides {t.stride()} is "
                         "not dense")
    return t.as_strided((t.numel(),), (1,), t.storage_offset())


def pmean_gradients(grads: Iterable[Optional[torch.Tensor]], mesh: Mesh) -> None:
    """Average the gradients over the ranks of a world mesh, in place: one
    flat buffer (the gradients in memory order, so that a channels_last
    one is not copied apart first), one all-reduce, and the means copied
    back with a few fused launches. Nones are skipped: every rank has the
    same."""
    views = [_flat_view(g) for g in grads if g is not None]
    if mesh.group is None or not views:
        return
    flat = torch.cat(views)
    dist.all_reduce(flat, group=mesh.group)
    flat.div_(mesh.size)
    torch._foreach_copy_(views, flat.split([v.numel() for v in views]))


@dataclasses.dataclass(frozen=True)
class BatchShard:
    """This rank's place in a batch split over a world: ``world`` equal
    shards of rows, this rank's is number ``rank``."""
    group: Any
    world: int
    rank: int


_SHARD = contextvars.ContextVar("batch_shard", default=None)


@contextlib.contextmanager
def batch_sharded(mesh: Optional[Mesh]):
    """Inside: the forward and the loss hold this rank's rows of a batch
    split in equal shards over the world ``mesh``. A mesh of one process,
    or None, changes nothing."""
    if mesh is None or mesh.group is None or mesh.size == 1:
        yield None
        return
    token = _SHARD.set(BatchShard(mesh.group, mesh.size, mesh.rank))
    try:
        yield _SHARD.get()
    finally:
        _SHARD.reset(token)


def batch_shard() -> Optional[BatchShard]:
    """The enclosing ``batch_sharded``'s shard, or None."""
    return _SHARD.get()


def batch_gather(x: torch.Tensor) -> torch.Tensor:
    """The whole batch's ``x`` (the ranks' rows concatenated in rank order
    along dim 0) inside ``batch_sharded``, ``x`` outside; differentiable."""
    shard = _SHARD.get()
    if shard is None:
        return x
    buf = x.new_zeros((shard.world, *x.shape))
    buf = buf.index_copy(0, torch.tensor([shard.rank], device=x.device), x[None])
    return _AllReduceSum.apply(buf, shard.group).reshape(shard.world * x.shape[0],
                                                         *x.shape[1:])


def batch_normalizer(local: torch.Tensor, min_value: float) -> torch.Tensor:
    """The normalizer of a loss that divides a sum over the batch by a sum
    over the batch, ``local`` this rank's part of the second: outside
    ``batch_sharded`` ``local`` clamped at ``min_value``; inside it the sum
    over the ranks, clamped, over the world size (each rank's share)."""
    shard = _SHARD.get()
    if shard is None:
        return torch.clamp_min(local, min_value)
    whole = local.detach().clone()
    dist.all_reduce(whole, group=shard.group)
    return torch.clamp_min(whole, min_value) / shard.world


def eval_rows(mesh: Optional[Mesh], n: int) -> slice:
    """This rank's rows of an evaluation batch of ``n`` rows over a world
    mesh: ``np.array_split``'s part for its rank (possibly empty), so that
    the ranks cover each row once; all ``n`` without one."""
    if mesh is None or mesh.group is None:
        return slice(0, n)
    base, extra = divmod(n, mesh.size)
    r = mesh.rank
    start = r * base + min(r, extra)
    return slice(start, start + base + (r < extra))


def gather_rows(mesh: Optional[Mesh], rows: list) -> list:
    """Each rank's list of per-row results (``eval_rows``'s rows) gathered
    in rank order, the same on every rank; ``rows`` without a world
    mesh."""
    if mesh is None or mesh.group is None:
        return rows
    parts = [None] * mesh.size
    dist.all_gather_object(parts, rows, group=mesh.group)
    return [row for part in parts for row in part]
