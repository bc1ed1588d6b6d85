"""PathFinder: BEV lane points (meters) -> fused CTE / yaw / curvature via a
14-state scalar-Gaussian Bayes filter, the port of
autoware_vision_pilot_tpu/perception/path_finder.py.

Rebuild of production_release/src/path_planning/{path_finder,estimator,
poly_fit}.cpp: predict adds process noise (sd 0.5), update multiplies
Gaussians per state (NaN measurement -> variance x1.25 inflation,
estimator.cpp:33-37), then inverse-variance fusion of groups
CTE[0,3)->3, yaw[5,7)->7, curvature[9,11)->11 (path_finder.cpp:26-31).
The AutoSteer angle substitutes the curvature feed-forward
(path_finder.cpp:95-97, 180).

State layout (14): [cte_path, cte_left, cte_right, cte_fused,
yaw_path, yaw_left, yaw_right, yaw_fused, curv_path, curv_left,
curv_right, curv_fused, lane_width, width_aux].

Tensor ops only, on any device, with no host synchronisation. NaN is data
here (a fit with fewer than 3 points, the unmeasured states) and is kept.
Every function takes leading stream axes: a batch of streams is one set of
launches, each stream on its own.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from ..ops.device import constant_on
from ..ops.smallsolve import solve3x3

STATE_DIM = 14
PROC_SD = 0.5
STD_M_CTE = 0.1
STD_M_YAW = 0.01
STD_M_CURV = 0.1
STD_M_WIDTH = 0.01
NAN = float("nan")
NOISE_EPS = 1e-5  # process-noise mean drawn from U(-eps, eps) each update

# fusion groups: (start, end) -> fused written at index `end`
FUSION_RULES = ((0, 3), (5, 7), (9, 11))


class BayesState(NamedTuple):
    mean: torch.Tensor      # (14,)
    var: torch.Tensor       # (14,)

    @staticmethod
    def init(default_lane_width: float = 4.0, device="cuda", streams=()) -> "BayesState":
        """``streams``: the leading axes, () for one stream or (N,)."""
        mean = torch.zeros((*streams, STATE_DIM), device=device)
        var = torch.full((*streams, STATE_DIM), 1e3, device=device)
        mean[..., 12] = default_lane_width
        var[..., 12] = 0.25
        return BayesState(mean, var)


def bayes_predict(s: BayesState, process_mean, process_var) -> BayesState:
    return BayesState(s.mean + process_mean, s.var + process_var)


def bayes_update(s: BayesState, meas_mean, meas_var) -> BayesState:
    isnan = torch.isnan(meas_mean)
    v0, m0 = s.var, s.mean
    v1 = meas_var
    m1 = torch.where(isnan, 0.0, meas_mean)
    v2 = (v0 * v1) / (v0 + v1)
    m2 = (m0 * v1 + m1 * v0) / (v0 + v1)
    var = torch.where(isnan, v0 * 1.25, v2)
    mean = torch.where(isnan, m0, m2)

    for start, end in FUSION_RULES:
        g_var = var[..., start:end]
        g_mean = mean[..., start:end]
        pos = g_var > 0.0
        inv = torch.where(pos, 1.0 / g_var, 0.0)
        wsum = torch.where(pos, g_mean / g_var, 0.0)
        inv_sum = inv.sum(-1)
        fused_var = 1.0 / torch.clamp(inv_sum, min=1e-30)
        fused_mean = fused_var * wsum.sum(-1)
        ok = inv_sum > 0.0
        var = _set(var, end, torch.where(ok, fused_var, var[..., end]))
        mean = _set(mean, end, torch.where(ok, fused_mean, mean[..., end]))
    return BayesState(mean, var)


def _set(v: torch.Tensor, i: int, value: torch.Tensor) -> torch.Tensor:
    """``v`` with ``v[..., i] = value`` (one value a stream), as a new
    tensor: jnp's .at[i].set."""
    return torch.cat([v[..., :i], value[..., None], v[..., i + 1:]], -1)


def fit_quad_poly(pts, mask):
    """Masked least-squares x = c0*y^2 + c1*y + c2 (poly_fit.cpp fitQuadPoly)
    on (..., P, 2) points [x, y] and a (..., P) mask. -> (..., 3) coeffs,
    NaN when fewer than 3 points."""
    m = mask.to(torch.float32)
    n = m.sum(-1)
    y, x = pts[..., 1], pts[..., 0]
    A = torch.stack([y * y, y, torch.ones_like(y)], -1)
    Am = A * m[..., None]
    AtA = Am.transpose(-1, -2) @ A + 1e-9 * torch.eye(3, device=pts.device)
    Atb = (Am.transpose(-1, -2) @ x[..., None])[..., 0]
    c = solve3x3(AtA, Atb)
    return torch.where(n[..., None] > 2, c, NAN)


class PathFinderOutput(NamedTuple):
    cte: torch.Tensor
    yaw_error: torch.Tensor
    curvature: torch.Tensor
    lane_width: torch.Tensor
    cte_variance: torch.Tensor
    yaw_variance: torch.Tensor
    curv_variance: torch.Tensor
    lane_width_variance: torch.Tensor
    left_coeff: torch.Tensor
    right_coeff: torch.Tensor
    left_valid: torch.Tensor
    right_valid: torch.Tensor
    fused_valid: torch.Tensor


def process_noise(generator, device) -> torch.Tensor:
    """(14,) f32 drawn from U(-NOISE_EPS, NOISE_EPS) with ``generator``, a
    generator on ``device``: the port's counterpart of the JAX package's
    draw from a key (the two give different numbers). A tuple of N
    generators, one a stream, draws (N, 14), a row from each."""
    if isinstance(generator, (tuple, list)):
        u = torch.stack([torch.rand(STATE_DIM, generator=g, device=device) for g in generator])
    else:
        u = torch.rand(STATE_DIM, generator=generator, device=device)
    return noise_from_uniform(u)


def noise_from_uniform(u: torch.Tensor) -> torch.Tensor:
    """The process noise from ``torch.rand``'s U(0, 1) draws: a program
    exported with its draw as an input (export/native_app.py) computes it
    in the graph."""
    return u * (2 * NOISE_EPS) - NOISE_EPS


def path_finder_update(state: BayesState, left_pts_m, left_mask,
                       right_pts_m, right_mask, autosteer_rad,
                       generator: Optional[torch.Generator] = None,
                       noise: Optional[torch.Tensor] = None,
                       default_lane_width: float = 4.0):
    """One PathFinder::update step (path_finder.cpp:47-194), for one stream
    or a batch (leading axes on every input and on the state). The process
    noise mean is ``noise`` when given (a test passes in the JAX package's
    draw), else drawn from ``generator`` (a tuple of them for a batch, one
    a stream). -> (PathFinderOutput, new state)."""
    if noise is None:
        if generator is None:
            raise ValueError("path_finder_update needs a generator or a noise tensor")
        noise = process_noise(generator, state.mean.device)
    state = bayes_predict(state, noise, PROC_SD ** 2)

    lc = fit_quad_poly(left_pts_m, left_mask)
    rc = fit_quad_poly(right_pts_m, right_mask)
    # derived metrics at y=0 (vehicle position), poly_fit.cpp FittedCurve
    one = torch.ones_like(lc[..., 1])
    l_cte = -lc[..., 2]
    l_yaw = -torch.atan2(lc[..., 1], one)
    r_cte = -rc[..., 2]
    r_yaw = -torch.atan2(rc[..., 1], one)

    width = state.mean[..., 12]
    steering = autosteer_rad

    meas_var = _meas_var(state.mean.device)
    both_nan = torch.isnan(l_cte) & torch.isnan(r_cte)
    one_nan = torch.isnan(l_cte) | torch.isnan(r_cte)
    width_meas = torch.where(
        both_nan, default_lane_width,
        torch.where(one_nan, width, r_cte - l_cte))

    nan = torch.full_like(width, NAN)
    meas_mean = torch.stack([
        nan, l_cte + width / 2.0, r_cte - width / 2.0, nan,   # cte
        nan, l_yaw, r_yaw, nan,                               # yaw
        nan, steering, steering, nan,                         # curvature
        width_meas, nan,                                      # width
    ], -1)
    state = bayes_update(state, meas_mean, meas_var)

    cte = state.mean[..., 3]
    yaw = state.mean[..., 7]
    curv = steering  # AutoSteer feed-forward substitutes curvature
    out = PathFinderOutput(
        cte=cte, yaw_error=yaw, curvature=curv,
        lane_width=state.mean[..., 12],
        cte_variance=state.var[..., 3], yaw_variance=state.var[..., 7],
        curv_variance=state.var[..., 11], lane_width_variance=state.var[..., 12],
        left_coeff=lc, right_coeff=rc,
        left_valid=~torch.isnan(l_cte), right_valid=~torch.isnan(r_cte),
        fused_valid=~(torch.isnan(cte) | torch.isnan(yaw) | torch.isnan(curv)),
    )
    return out, state


_MEAS_VAR = torch.tensor([STD_M_CTE ** 2] * 4 + [STD_M_YAW ** 2] * 4
                         + [STD_M_CURV ** 2] * 4 + [STD_M_WIDTH ** 2] * 2)


@functools.lru_cache(maxsize=8)
def _meas_var(device) -> torch.Tensor:
    """The measurement variances on ``device``, copied there once."""
    return constant_on(_MEAS_VAR, device)
