"""Dtype and precision policy, the port of
autoware_vision_pilot_tpu/core/dtypes.py.

Two operating points:

- PARITY: float32 parameters and compute, with TF32 off for matmuls and
  convolutions (the counterpart of ``lax.Precision.HIGHEST``). The parity
  tests hold the card to the CPU at 1e-3 this way.
- FAST: bfloat16 parameters and compute on the tensor cores, which
  accumulate in f32; no loss scaling is needed for bf16.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Optional

import torch
from torch import nn


def tree_map(fn, x):
    """``fn`` over the leaves of a tree of dicts, lists and tuples."""
    if isinstance(x, dict):
        return {k: tree_map(fn, v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(tree_map(fn, v) for v in x)
    return fn(x)


@dataclasses.dataclass(frozen=True)
class Policy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    # "highest": f32 matmuls and convolutions without TF32; None: the
    # backend's default
    precision: Optional[str] = None

    def cast(self, x: Any):
        """Cast the floating tensors of an activation tree (dicts, lists,
        tuples) to the compute dtype; other leaves stay."""
        return tree_map(lambda a: a.to(self.compute_dtype)
                         if isinstance(a, torch.Tensor) and a.is_floating_point() else a, x)

    def cast_params(self, params):
        """A module's floating parameters and buffers, or a tree of tensors,
        in the parameter dtype (a module is cast in place and returned)."""
        if isinstance(params, nn.Module):
            return params.to(self.param_dtype)
        return tree_map(lambda a: a.to(self.param_dtype)
                         if isinstance(a, torch.Tensor) and a.is_floating_point() else a, params)

    @contextlib.contextmanager
    def matmul_precision(self):
        """Inside: TF32 off for matmuls and cuDNN convolutions when the
        policy asks for "highest"; the flags are restored after."""
        if self.precision != "highest":
            yield
            return
        flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


PARITY = Policy(param_dtype=torch.float32, compute_dtype=torch.float32, precision="highest")
FAST = Policy(param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16, precision=None)


def default_policy() -> Policy:
    return PARITY
