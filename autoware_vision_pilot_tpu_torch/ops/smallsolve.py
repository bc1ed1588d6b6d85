"""Closed-form 3x3 solve, the port of autoware_vision_pilot_tpu/ops/smallsolve.py.

Every solve of the lateral stack is a 3x3 normal-equations system; Cramer's
rule through the adjugate is a handful of elementwise ops, with no LAPACK or
cuSOLVER call and no host synchronisation.
"""
from __future__ import annotations

import torch


def solve3x3(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A @ x = b for (..., 3, 3) A and (..., 3) b via the adjugate,
    with the JAX package's operations in the same order. A singular A gives
    inf/nan, as a division by zero does."""
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a10, a11, a12 = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    a20, a21, a22 = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    c00 = a11 * a22 - a12 * a21
    c01 = a12 * a20 - a10 * a22
    c02 = a10 * a21 - a11 * a20
    det = a00 * c00 + a01 * c01 + a02 * c02
    # adjugate rows (cofactor transpose)
    x0 = (c00 * b0 + (a02 * a21 - a01 * a22) * b1
          + (a01 * a12 - a02 * a11) * b2)
    x1 = (c01 * b0 + (a00 * a22 - a02 * a20) * b1
          + (a02 * a10 - a00 * a12) * b2)
    x2 = (c02 * b0 + (a01 * a20 - a00 * a21) * b1
          + (a00 * a11 - a01 * a10) * b2)
    return torch.stack([x0, x1, x2], -1) / det[..., None]
