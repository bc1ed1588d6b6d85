"""Weight bridge between the JAX package and the port: flax variables ->
the port's state_dict (``variables_to_state_dict``, the inverse of
autoware_vision_pilot_tpu/convert/torch_import.py), and back
(``state_dict_to_variables``, for the flax msgpack files the port writes).

Leaf transforms, by flax leaf name:
  ``w``  conv kernel HWIO            -> ``weight`` OIHW  (3, 2, 0, 1)
  ``wt`` conv-transpose (kh,kw,O,I)  -> ``weight`` IOHW  (3, 2, 0, 1)
  ``wl`` linear kernel (in, out)     -> ``weight`` (out, in)
  ``w1`` Conv1d kernel (k, in, out)  -> ``weight`` (out, in, k) (2, 1, 0)
  ``b``, ``bias``                    -> ``bias``
  ``scale``                          -> ``weight``   (BatchNorm)
  ``mean``, ``var`` (batch_stats)    -> ``running_mean``, ``running_var``
  ``w_scale``, ``wt_scale``, ``x_scale`` (int8)
                                     -> ``weight_scale``, ``weight_scale``,
                                        ``input_scale``

An int8 ``w`` or ``wt`` (export/quantize.py::quantize_variables_for_int8_conv)
keeps its dtype and loads into an ``Int8Conv2d`` or ``Int8ConvTranspose2d``
of the port's own quantized module (export/quantize.py), the latter in its
(kh, kw, O, I) memory layout (``load_state_dict`` copies into it); every
other leaf becomes f32. An int8 leaf for
a float key, or the other way round, raises like a shape mismatch.

Flax paths merge a torch index into its parent (``encoder_1_0``); whether a
``_0`` is such an index (``encoder.1.0``) or part of a name
(``context_layer_0``) is read off the target module's own keys. So is
whether a path part ``bn`` is the inner module of the JAX ``BatchNorm2d``
wrapper, which is dropped (``bn.scale`` -> ``weight``), or a BatchNorm of
that name, which is kept (the Lite ``ConvBNReLU``: ``aspp.b0.bn.scale`` ->
``aspp.b0.bn.weight``). Leaves come as numpy arrays, anything
``np.asarray`` takes, or CPU tensors (the bfloat16 leaves of
export/checkpoints.py::load_msgpack); nothing here imports JAX.
"""
from __future__ import annotations

from collections.abc import Mapping
from typing import Dict

import numpy as np
import torch
from torch import nn

from ..nn import layers

_TRANSPOSE = {"w": (3, 2, 0, 1), "wt": (3, 2, 0, 1), "wl": (1, 0), "w1": (2, 1, 0)}
_TORCH_LEAF = {"w": "weight", "wt": "weight", "wl": "weight", "w1": "weight", "b": "bias",
               "scale": "weight", "bias": "bias", "mean": "running_mean",
               "var": "running_var", "w_scale": "weight_scale",
               "wt_scale": "weight_scale", "x_scale": "input_scale"}


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, object]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, path))
        else:
            out[path] = v
    return out


def _merge_digits(key: str) -> str:
    """torch 'encoder.1.0.block' -> flax-style 'encoder_1_0.block'."""
    merged = []
    for p in key.split("."):
        if p.isdigit() and merged:
            merged[-1] = f"{merged[-1]}_{p}"
        else:
            merged.append(p)
    return ".".join(merged)


def variables_to_state_dict(flax_vars: Mapping, module: nn.Module
                            ) -> Dict[str, torch.Tensor]:
    """{'params', 'batch_stats'} trees -> a state_dict for ``module`` (f32,
    on the CPU) that ``module.load_state_dict(..., strict=True)`` takes.
    Raises KeyError on a leaf with no place in ``module`` or a key of
    ``module`` left unfilled, ValueError on a shape or int8/float mismatch.
    Int8 leaves stay int8."""
    targets = module.state_dict()
    by_merged = {_merge_digits(k): k for k in targets}
    out = {}
    for collection in ("params", "batch_stats"):
        for path, value in _flatten(flax_vars.get(collection, {})).items():
            parts = path.split(".")
            leaf = parts.pop()
            if leaf not in _TORCH_LEAF:
                raise KeyError(f"no torch counterpart for flax leaf {path}")
            if parts and parts[-1] == "bn" and \
                    ".".join([*parts, _TORCH_LEAF[leaf]]) not in by_merged:
                parts.pop()  # the inner module of nn/layers.py's BatchNorm2d wrapper
            key = by_merged.get(".".join([*parts, _TORCH_LEAF[leaf]]))
            if key is None:
                raise KeyError(f"{collection}/{path} has no key in "
                               f"{type(module).__name__}")
            if isinstance(value, torch.Tensor):  # a bfloat16 leaf of load_msgpack
                value = value.float() if value.dtype == torch.bfloat16 else value
                value = value.numpy()
            a = np.asarray(value)
            if (a.dtype == np.int8) != (targets[key].dtype == torch.int8):
                raise ValueError(f"dtype mismatch at {key}: flax {a.dtype} vs "
                                 f"torch {targets[key].dtype}")
            if a.dtype != np.int8:
                a = a.astype(np.float32)
            if leaf in _TRANSPOSE:
                a = a.transpose(_TRANSPOSE[leaf])
            if a.shape != tuple(targets[key].shape):
                raise ValueError(f"shape mismatch at {key}: flax {a.shape} vs "
                                 f"torch {tuple(targets[key].shape)}")
            out[key] = torch.from_numpy(np.array(a, order="C"))  # keeps 0-d
    missing = sorted(set(targets) - set(out))
    if missing:
        raise KeyError(f"no flax leaf for {missing[:10]}"
                       f"{' ...' if len(missing) > 10 else ''}")
    return out


# the flax (collection, leaf) of each parameter and buffer, by port module type
_FLAX_LEAF = {
    layers.Conv2d: {"weight": ("params", "w"), "bias": ("params", "b")},
    layers.Int8Conv2d: {"weight": ("params", "w"), "weight_scale": ("params", "w_scale"),
                        "input_scale": ("params", "x_scale"), "bias": ("params", "b")},
    layers.ConvTranspose2d: {"weight": ("params", "wt"), "bias": ("params", "b")},
    layers.Int8ConvTranspose2d: {"weight": ("params", "wt"),
                                 "weight_scale": ("params", "wt_scale"),
                                 "input_scale": ("params", "x_scale"), "bias": ("params", "b")},
    layers.Linear: {"weight": ("params", "wl"), "bias": ("params", "b")},
    layers.Conv1dCenter: {"weight": ("params", "w1"), "bias": ("params", "b")},
    layers.BatchNorm2d: {"weight": ("params", "scale"), "bias": ("params", "bias"),
                         "running_mean": ("batch_stats", "mean"),
                         "running_var": ("batch_stats", "var")},
}


def state_dict_to_variables(module: nn.Module) -> Dict[str, dict]:
    """The inverse of ``variables_to_state_dict``: ``module``'s parameters
    and buffers -> {'params', 'batch_stats'} trees in the JAX package's
    layout (flax paths, HWIO kernels), as numpy arrays on the host: int8
    leaves stay int8, every other leaf becomes f32. A collection with no
    leaf is left out, as flax's init leaves it out. Raises KeyError for a
    parameter or buffer of a module type the table does not know."""
    out = {"params": {}, "batch_stats": {}}
    for name, m in module.named_modules():
        leaves = {**dict(m.named_parameters(recurse=False)),
                  **dict(m.named_buffers(recurse=False))}
        table = _FLAX_LEAF.get(type(m), {})
        unknown = sorted(k for k, t in leaves.items() if t is not None and k not in table)
        if unknown:
            raise KeyError(f"no flax leaf for {type(m).__name__} {name!r}: {unknown}")
        path = _merge_digits(name).split(".") if name else []
        for key, t in leaves.items():
            if t is None:
                continue
            collection, leaf = table[key]
            a = t.detach().cpu()
            a = a.numpy() if a.dtype == torch.int8 else a.float().numpy()
            if leaf in _TRANSPOSE:
                a = a.transpose(np.argsort(_TRANSPOSE[leaf]))
            node = out[collection]
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = np.array(a, order="C")
    return {k: v for k, v in out.items() if v}
