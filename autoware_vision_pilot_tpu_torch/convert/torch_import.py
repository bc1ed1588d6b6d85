"""A reference PyTorch ``state_dict`` -> the port's modules, the port of
autoware_vision_pilot_tpu/convert/torch_import.py::import_state_dict
(:70-185).

The port's modules keep the reference's torch names and layouts (conv
OIHW, conv-transpose IOHW, linear (out, in), Conv1d (out, in, k),
BatchNorm ``weight``/``bias``/``running_mean``/``running_var``), so a
reference key is the port's key once ``prefix_map`` has rewritten it: no
transposes and no merging of index components, which the JAX importer
needs for its flax paths. The contract is the JAX importer's: the longest
matching prefix of ``prefix_map`` is rewritten first, a shape mismatch
raises ValueError, and with ``strict`` a KeyError lists the module's keys
the state_dict lacks ("missing torch weights for: [...]") or the
state_dict's keys nothing used ("unused torch weights: [...]";
``num_batches_tracked``, anchors and strides are dropped). Values come as
numpy arrays or CPU tensors; nothing here imports JAX.
"""
from __future__ import annotations

from typing import Dict, Mapping, Union

import numpy as np
import torch
from torch import nn

Targets = Union[nn.Module, Mapping[str, torch.Tensor]]


def targets_of(module: Targets) -> Dict[str, torch.Tensor]:
    """The keys to fill and their current tensors: ``module.state_dict()``,
    or the mapping itself."""
    return dict(module.state_dict() if isinstance(module, nn.Module) else module)


def as_tensor(value) -> torch.Tensor:
    """A numpy array, anything ``np.asarray`` takes, or a tensor -> a CPU tensor."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu()
    return torch.from_numpy(np.array(value))


def _unused_ok(key: str) -> bool:
    return key.endswith("num_batches_tracked") or "anchors" in key or "strides" in key


def import_state_dict(module: Targets, state_dict: Mapping[str, object],
                      prefix_map: Mapping[str, str] | None = None,
                      strict: bool = True) -> Dict[str, torch.Tensor]:
    """Fill the keys of ``module`` (a module or its state_dict) from a
    torch ``state_dict`` -> a full state_dict for ``module``: each found
    value in the target's dtype, on the CPU; every key not found keeps the
    target's own tensor object (so a caller can tell them apart, as
    fold_missing_bn does). Load it with ``module.load_state_dict``.

    prefix_map: reference-prefix -> port-prefix rewrites applied first
    (longest match wins), e.g. {'model.': ''}."""
    targets = targets_of(module)

    def rewrite(key: str) -> str:
        if prefix_map:
            for src in sorted(prefix_map, key=len, reverse=True):
                if key.startswith(src):
                    return prefix_map[src] + key[len(src):]
        return key

    by_key = {rewrite(k): k for k in state_dict}
    out = dict(targets)
    used, missing = set(), []
    for key, target in targets.items():
        src = by_key.get(key)
        if src is None:
            missing.append(key)
            continue
        used.add(src)
        v = as_tensor(state_dict[src])
        if tuple(v.shape) != tuple(target.shape):
            raise ValueError(f"shape mismatch at {key}: torch {tuple(v.shape)} vs port "
                             f"{tuple(target.shape)}")
        out[key] = v.to(dtype=target.dtype)
    if strict:
        if missing:
            raise KeyError(f"missing torch weights for: {missing[:10]}"
                           f"{' ...' if len(missing) > 10 else ''}")
        unused = [k for k in state_dict if k not in used and not _unused_ok(k)]
        if unused:
            raise KeyError(f"unused torch weights: {unused[:10]}"
                           f"{' ...' if len(unused) > 10 else ''}")
    return out
