"""The segmentation train step on one card, the port of
autoware_vision_pilot_tpu/train/train_step.py.

The JAX step is one jitted SPMD program over a mesh; here it is an eager
PyTorch step: forward in train mode (BatchNorm on batch statistics,
dropout and stochastic depth from an explicit generator), autograd, the
optimizer, then the EMA. Gradient accumulation (the reference's
batch-size-by-accumulation trick, train_scene_seg.py:113-129) runs the
microbatches in order, the BatchNorm running statistics carried from one
to the next, and averages their gradients, as the JAX scan does.

Over a world mesh (core/mesh.py; one process a card, as torch DDP runs)
every rank is given the whole batch and runs its rows of each microbatch,
as JAX shards the (microbatches, B / microbatches) reshape of it: rank r's
part of microbatch i is rows i B / mb + r B / (mb W) up to the next
rank's. Its forward and loss run inside ``parallel.sharding.
batch_sharded``, so BatchNorm, dropout and the losses see the whole
microbatch (parallel/sharding.py); the gradients are averaged over the
ranks once, after the last microbatch; the optimizer and the EMA then step
alike on every rank, whose weights stay bit-equal. A batch whose
microbatches do not divide the world runs whole on every rank, as JAX
replicates it. A mesh of one device changes nothing.

``TrainState`` holds the module (the JAX ``params`` and ``batch_stats``
are its parameters and buffers), the optimizer (``opt_state``), the step
and the EMA copies of the parameters. ``adamw`` stands in for
``optax.adamw(lr)`` with optax's defaults. bf16 compute is
``compute_dtype=torch.bfloat16``: autocast over f32 master weights, the
counterpart of a flax net with ``dtype=jnp.bfloat16`` and f32 params.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from ..convert.from_jax import variables_to_state_dict
from ..core.mesh import Mesh
from ..nn.layers import dropout_generator, init_seeded
from ..parallel.sharding import all_reduce_mean, batch_sharded, pmean_gradients
from . import optim


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    ema: Optional[Dict[str, torch.Tensor]] = None


def adamw(lr, weight_decay: float = 1e-4, **kw):
    """``optax.adamw(lr)``: a factory of an AdamW over the parameters it is
    given, with optax's defaults, betas (0.9, 0.999), eps 1e-8 outside the
    square root and weight decay 1e-4 (torch's own default is 1e-2). Every
    parameter is decayed, BatchNorm scales and biases included, as optax
    decays every leaf. ``lr`` may be a schedule of the update count
    (train/optim.py, which also has the other optax pieces)."""
    return optim.adamw(lr, weight_decay=weight_decay, **kw)


def create_seg_train_state(model: nn.Module, tx: Callable, ema: bool = False) -> TrainState:
    """A TrainState over ``model`` as it is (its weights set by init_seeded
    or loaded): its float parameters are set to require gradients (the
    port's layers create theirs without), ``tx`` (e.g. ``adamw(1e-4)``)
    builds the optimizer over them, given as ``(name, parameter)`` pairs;
    with ``ema`` the EMA starts as a copy of them."""
    params = [(n, p) for n, p in model.named_parameters() if p.is_floating_point()]
    for _, p in params:
        p.requires_grad_(True)
    copies = {n: p.detach().clone() for n, p in params} if ema else None
    return TrainState(model, tx(params), 0, copies)


def optimizer_step(optimizer: torch.optim.Optimizer) -> None:
    """``optimizer.step()`` with a zero gradient for every parameter that got
    none (a frozen subtree): optax updates every leaf, so AdamW's weight
    decay still applies there, where torch would skip the parameter."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
    optimizer.step()


def data_mesh(mesh: Optional[Mesh]) -> Optional[Mesh]:
    """The mesh a train step runs over: a world mesh (one process a rank),
    or None for None and for a mesh of one device. A local mesh of several
    devices raises: a step over several cards runs a process a card."""
    if mesh is None or mesh.group is not None:
        return mesh
    if mesh.size != 1:
        raise ValueError(f"a train step over several devices runs one process a device; "
                         f"got the local {mesh}: launch one process a card (torchrun) and "
                         "make_mesh() inside the world (parallel/distributed.py)")
    return None


def shard_rows(mesh: Optional[Mesh], n: int):
    """This rank's rows of a (micro)batch of ``n`` rows -> (first, count,
    sharded): its equal shard over a world mesh when ``n`` divides by the
    world size, else all ``n`` (replicated, not sharded)."""
    if mesh is None or n % mesh.size:
        return 0, n, False
    count = n // mesh.size
    return mesh.rank * count, count, True


def average_gradients(optimizer: torch.optim.Optimizer, mesh: Optional[Mesh]) -> None:
    """The optimizer's gradients averaged over a world mesh's ranks, in
    place (nothing without one)."""
    if mesh is not None:
        pmean_gradients((p.grad for g in optimizer.param_groups for p in g["params"]), mesh)


def make_seg_train_step(loss_fn: Callable, mesh=None, microbatches: int = 1,
                        ema_decay: Optional[float] = None,
                        compute_dtype: torch.dtype = torch.float32):
    """The train step ``step(state, images, targets, generator) -> (state,
    mean loss)`` (a 0-d tensor on the device; nothing waits for it).

    loss_fn(logits, targets) -> scalar, on the logits in f32 (cast up from
    ``compute_dtype``). ``images`` (B, 3, H, W) and
    ``targets`` are on the model's device; with ``microbatches`` > 1 their
    leading dim is split into that many equal slices, run in order, and
    the gradients averaged. ``generator`` (on any device; its masks are
    moved to the images') draws the dropout and stochastic-depth masks.
    The update is in place: the module, the optimizer and the EMA of
    ``state`` change, and its step counts one more. Over a world ``mesh``
    each rank passes the whole batch and the same generator state, runs
    its rows, and gets the whole batch's mean loss (see the module's
    docstring)."""
    mesh = data_mesh(mesh)

    def step(state: TrainState, images: torch.Tensor, targets: torch.Tensor,
             generator: torch.Generator):
        model, opt = state.model, state.optimizer
        B = images.shape[0]
        if B % microbatches:
            raise ValueError(f"batch {B} does not split into {microbatches} microbatches")
        n = B // microbatches
        first, rows, sharded = shard_rows(mesh, n)
        model.train()
        opt.zero_grad(set_to_none=True)
        losses = []
        with dropout_generator(generator), batch_sharded(mesh if sharded else None):
            for i in range(microbatches):
                lo = i * n + first
                with torch.autocast(images.device.type, dtype=compute_dtype,
                                    enabled=compute_dtype != torch.float32):
                    out = model(images[lo:lo + rows])
                loss = loss_fn(out.float(), targets[lo:lo + rows])
                loss.backward()
                losses.append(loss.detach())
        average_gradients(opt, mesh)
        if microbatches > 1:
            for group in opt.param_groups:
                for p in group["params"]:
                    if p.grad is not None:
                        p.grad.div_(microbatches)
        optimizer_step(opt)
        if ema_decay is not None and state.ema is not None:
            ema_update(state, model, ema_decay)
        state.step += 1
        loss = torch.stack(losses).mean()
        return state, all_reduce_mean(mesh, loss)[0] if sharded else loss

    return step


@contextlib.contextmanager
def weights_swapped_in(model: nn.Module, weights: Optional[Dict[str, torch.Tensor]]):
    """Inside the block ``model``'s parameters named in ``weights`` (an EMA)
    hold those values; after it their own again. None changes nothing."""
    if not weights:
        yield model
        return
    params = dict(model.named_parameters())
    saved = {n: params[n].detach().clone() for n in weights}
    with torch.no_grad():
        for n, w in weights.items():
            params[n].copy_(w)
    try:
        yield model
    finally:
        with torch.no_grad():
            for n, w in saved.items():
                params[n].copy_(w)


def ema_update(state: TrainState, model: nn.Module, decay) -> None:
    """``ema = ema * d + p * (1 - d)`` for each parameter of ``state.ema``,
    in place; ``decay`` a float, or a float32 numpy scalar whose 1 - d is
    then taken in float32, as JAX's traced EMA does."""
    one_minus = float(np.float32(1) - decay) if isinstance(decay, np.floating) else 1 - decay
    d = float(decay)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name in state.ema:
                e = state.ema[name]
                e.copy_(e * d + p * one_minus)


def to_device_images(images_u8: np.ndarray, device: torch.device) -> torch.Tensor:
    """(B, H, W, 3) uint8 on the host -> (B, 3, H, W) f32 ``/ 255`` on
    ``device``, channels_last (the YOLO convention: no mean and std)."""
    x = torch.from_numpy(np.ascontiguousarray(images_u8)).to(device)
    return x.permute(0, 3, 1, 2).float() / 255.0


def load_variables(model: torch.nn.Module, variables: Optional[dict], seed: int):
    """``model`` with the JAX ``variables`` (strict, convert/from_jax.py), or
    seeded by ``init_seeded`` from ``seed`` when there are none."""
    if variables is None:
        return init_seeded(model, torch.Generator().manual_seed(seed))
    model.load_state_dict(variables_to_state_dict(variables, model), strict=True)
    return model
