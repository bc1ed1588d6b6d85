"""Tensor parallelism for the conv nets, the port of
autoware_vision_pilot_tpu/parallel/tensor_parallel.py: weights split on
their output channels over a ``model`` mesh axis.

The reference has no tensor parallelism; the JAX package added it as a TPU
extension, where XLA propagates the weight shardings and inserts the
collectives. Here the split is explicit, on a local mesh: each Conv2d,
ConvTranspose2d and Linear whose output channels divide the axis becomes a
``ChannelSplit``, whose part m holds slice m of the weight and bias on the
m-th device of the ``model`` axis, computes its slice of the output from
the whole input, and the slices are gathered in channel order (the JAX
``_kernel_spec``: conv weights on O, the transposed conv's on its O, the
Linear's on its outputs, biases on their one dim). The rest of the network
runs on the first device of its data row. With a ``data`` axis as well,
each data row holds such a replica and takes its rows of the batch.

Usage:
    mesh = make_mesh((dp, tp), axis_names=("data", "model"), devices=...)
    tp_models = shard_variables_tp(model, mesh)
    out = make_tp_infer(tp_models, mesh)(batch)
"""
from __future__ import annotations

import copy
from typing import Sequence

import numpy as np
import torch
from torch import nn

from ..core.mesh import DATA_AXIS, MODEL_AXIS, Mesh, data_sharding
from ..nn.layers import Conv2d, ConvTranspose2d, Linear
from .multichip_inference import concat_outputs, local_mesh

_OUT_DIM = {Conv2d: 0, ConvTranspose2d: 1, Linear: 0}  # a weight's output-channel dim


def splits(layer: nn.Module, n: int) -> bool:
    """Whether ``layer``'s output channels split over ``n`` devices: a
    Conv2d, ConvTranspose2d or Linear whose output channels divide by n
    (and a grouped conv's groups too)."""
    if type(layer) not in _OUT_DIM:
        return False
    out = layer.weight.shape[_OUT_DIM[type(layer)]]
    groups = getattr(layer, "groups", 1)
    return out % n == 0 and (groups == 1 or groups % n == 0)


def _part(layer: nn.Module, m: int, n: int) -> nn.Module:
    part = copy.copy(layer)
    part._parameters = dict(layer._parameters)
    dim = _OUT_DIM[type(layer)]
    size = layer.weight.shape[dim] // n
    for name in ("weight", "bias"):
        t = getattr(layer, name)
        if t is not None:
            d = dim if name == "weight" else 0
            part._parameters[name] = nn.Parameter(t.narrow(d, m * size, size).clone(),
                                                  requires_grad=False)
    if getattr(layer, "groups", 1) > 1:
        part.groups = layer.groups // n
    return part


class ChannelSplit(nn.Module):
    """``layer`` with its output channels split over ``devices``: part m,
    on devices[m], computes output channels [m O / n, (m + 1) O / n) (a
    grouped conv from its groups' input channels only); the parts' outputs
    are gathered in channel order on the input's device."""

    def __init__(self, layer: nn.Module, devices: Sequence[torch.device]):
        super().__init__()
        n = len(devices)
        self.devices = list(devices)
        self.parts = nn.ModuleList(_part(layer, m, n).to(d) for m, d in enumerate(devices))
        self.channel_dim = -1 if isinstance(layer, Linear) else 1
        groups = getattr(layer, "groups", 1)
        self.in_size = layer.weight.shape[1] * groups // n if groups > 1 else None

    def forward(self, x):
        outs = []
        for m, (part, d) in enumerate(zip(self.parts, self.devices)):
            xin = x if self.in_size is None else x.narrow(1, m * self.in_size, self.in_size)
            outs.append(part(xin.to(d)).to(x.device))
        return torch.cat(outs, self.channel_dim)


def _rows(mesh: Mesh) -> np.ndarray:
    """The mesh's devices as (data, model)."""
    names = mesh.axis_names
    if not set(names) <= {DATA_AXIS, MODEL_AXIS}:
        raise ValueError(f"a tensor-parallel mesh has the axes data and model, not {names}")
    arr = mesh.devices
    if MODEL_AXIS not in names:
        return arr.reshape(-1, 1)
    if DATA_AXIS not in names:
        return arr.reshape(1, -1)
    return np.moveaxis(arr, names.index(DATA_AXIS), 0)


def shard_variables_tp(model: nn.Module, mesh: Mesh) -> list:
    """One copy of ``model`` a data row of ``mesh``, its layers that split
    over the ``model`` axis made ``ChannelSplit``s over that row's devices,
    the rest on the row's first device. ``model`` is not changed."""
    rows = _rows(local_mesh(mesh, "tensor parallelism"))
    replicas = []
    for row in rows:
        devices = [torch.device(d) for d in row]
        replica = copy.deepcopy(model).to(devices[0])
        targets = [(parent, name, child) for parent in replica.modules()
                   for name, child in parent.named_children() if splits(child, len(devices))]
        for parent, name, child in targets:
            setattr(parent, name, ChannelSplit(child, devices))
        replicas.append(replica)
    return replicas


def make_tp_infer(tp_models: list, mesh: Mesh):
    """-> infer(batch): the batch split over the data axis, each data row's
    rows through its tensor-parallel replica (``shard_variables_tp``), the
    outputs concatenated in batch order on the first row's device, without
    gradients."""
    rows = _rows(local_mesh(mesh, "tensor parallelism"))
    if len(tp_models) != len(rows):
        raise ValueError(f"{len(tp_models)} replicas for {len(rows)} data rows")

    first = torch.device(rows[0][0])

    @torch.no_grad()
    def infer(batch: torch.Tensor):
        pieces = (data_sharding(mesh, batch.dim()).pieces(batch)
                  if DATA_AXIS in mesh.axis_names else [batch.to(first)])
        return concat_outputs([m(p) for m, p in zip(tp_models, pieces)], first)

    return infer
