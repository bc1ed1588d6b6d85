"""Batch-parallel inference over several devices, the port of
autoware_vision_pilot_tpu/parallel/multichip_inference.py.

The batched-clip configuration (BASELINE config 3; the time axis of a clip
is the one to shard) scaled over a local mesh: one process, a replica of
the module on each data device, the batch split over the ``data`` axis and
the outputs concatenated in batch order on the first device. The forward
has no collective.
"""
from __future__ import annotations

import copy
from typing import Sequence

import torch
from torch import nn

from ..core.mesh import Mesh, data_devices, data_sharding, make_mesh


def module_device(module: nn.Module) -> torch.device:
    """The device of ``module``'s first parameter or buffer (the CPU if it
    has neither)."""
    for t in (*module.parameters(), *module.buffers()):
        return t.device
    return torch.device("cpu")


def replicas_on(module: nn.Module, devices: Sequence[torch.device]) -> dict:
    """One module a distinct device of ``devices``: ``module`` itself on its
    own device, a copy on each other one."""
    own = module_device(module)
    return {d: module if d == own else copy.deepcopy(module).to(d)
            for d in dict.fromkeys(torch.device(d) for d in devices)}


def concat_outputs(outs: list, device: torch.device):
    """The shards' outputs (tensors, or tuples, lists and dicts of them)
    concatenated along dim 0 in shard order, on ``device``."""
    first = outs[0]
    if isinstance(first, torch.Tensor):
        return torch.cat([o.to(device) for o in outs])
    if isinstance(first, dict):
        return {k: concat_outputs([o[k] for o in outs], device) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(concat_outputs(list(p), device) for p in zip(*outs))
    return first


def local_mesh(mesh: Mesh, what: str) -> Mesh:
    if mesh.group is not None:
        raise ValueError(f"{what} runs one process over a local mesh's devices, not a world "
                         "mesh of ranks")
    return mesh


def make_sharded_infer(model: nn.Module, mesh: Mesh = None):
    """-> infer(batch): ``model(batch)`` with the batch split over the
    mesh's data devices (one replica of ``model`` a device) and the outputs
    concatenated in batch order on the first one, without gradients. The
    batch's dim 0 must divide over the data devices."""
    mesh = local_mesh(mesh or make_mesh(), "make_sharded_infer")
    devices = data_devices(mesh)
    replicas = replicas_on(model, devices)

    @torch.no_grad()
    def infer(batch: torch.Tensor):
        pieces = data_sharding(mesh, batch.dim()).pieces(batch)
        return concat_outputs([replicas[d](p) for d, p in zip(devices, pieces)], devices[0])

    return infer
