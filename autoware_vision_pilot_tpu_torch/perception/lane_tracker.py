"""Lane tracking: perspective lane fits -> BEV corridor + dual-view metrics,
the port of autoware_vision_pilot_tpu/perception/lane_tracker.py.

Rebuild of production_release/src/lane_tracking/lane_tracking.cpp:
- coefficient upscaling from model space to image space (:55-75)
- sample the quadratic every 5 rows, warp through the hard-coded calibration
  homography (lane_tracking.hpp:73-77) into a 640x640 BEV grid
- missing-lane recovery: shift the surviving lane by the cached BEV lane
  width (EMA 0.9/0.1, default 180 px) and refit (:136-202)
- quadratic refit + lane offset / yaw / curvature in both views (:300-452)

Point lists are fixed-size (MAX_PTS, 2) tensors with validity masks; every
step is a tensor op on the inputs' device, with no host synchronisation.
Every function takes leading stream axes (..., ·): a batch of streams is
one set of launches, each stream on its own.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..ops.device import constant_on
from ..ops.smallsolve import solve3x3

# calibration homography (lane_tracking.hpp:73-77), rounded to f32
H_ORIG_TO_BEV = torch.tensor([
    [-1.79887412e-01, -6.05811422e-01, 6.02998251e+02],
    [1.85824549e-14, -1.28170839e+00, 8.63871455e+02],
    [2.95628463e-17, -1.76125061e-03, 1.00000000e+00],
], dtype=torch.float32)
# Its inverse as the JAX package computes it: with float64 off, its
# `astype(float64)` stays f32 and the inverse is an f32 LAPACK inverse.
# torch.linalg.inv gives other last bits (up to 3 ulps), so the nine f32
# values are written out.
H_BEV_TO_ORIG = torch.tensor([float.fromhex(v) for v in (
    "-0x1.63c73p+2", "0x1.527436p+3", "-0x1.698cfap+12",
    "-0x1.6b227ep-43", "0x1.0ae7a4p+2", "-0x1.c255bcp+11",
    "-0x1.13fa16p-53", "0x1.e15e4ep-8", "-0x1.56181ap+2")],
    dtype=torch.float32).reshape(3, 3)

BEV_SIZE = 640.0
BEV_CENTER_X = 320.0
DEFAULT_BEV_WIDTH = 180.0
WIDTH_EMA = 0.9
SAMPLE_STEP = 5
MAX_PTS = 256  # covers image heights up to 1280 at step 5

# BEV pixel -> meters (main.cpp:333-357)
BEV_RANGE_M = 40.0
BEV_SCALE = BEV_RANGE_M / BEV_SIZE


class LaneTrackerState(NamedTuple):
    bev_width: torch.Tensor          # () f32
    has_width_history: torch.Tensor  # () bool

    @staticmethod
    def init(device="cuda", streams=()) -> "LaneTrackerState":
        """``streams``: the leading axes, () for one stream or (N,)."""
        return LaneTrackerState(
            torch.full(streams, DEFAULT_BEV_WIDTH, device=device),
            torch.zeros(streams, dtype=torch.bool, device=device))


@functools.lru_cache(maxsize=32)
def _on(device: torch.device, *values: float) -> torch.Tensor:
    """An f32 constant vector on ``device``, copied there once."""
    return constant_on(torch.tensor(values, dtype=torch.float32), device)


@functools.lru_cache(maxsize=8)
def homographies(device: torch.device):
    """(H_ORIG_TO_BEV, H_BEV_TO_ORIG) on ``device``, copied there once."""
    return constant_on(H_ORIG_TO_BEV, device), constant_on(H_BEV_TO_ORIG, device)


def upscale_coeffs(c6, model_hw, image_hw):
    """Model-space quadratic (..., 6) -> image space (lane_tracking.cpp:55-75):
    [0, a*sx/sy^2, b*sx/sy, c*sx, ymin*sy, ymax*sy]. The divisors are a
    tensor, so the division is a true division on every device (PyTorch on
    CUDA multiplies by the reciprocal of a Python number)."""
    mh, mw = model_hw
    ih, iw = image_hw
    sx = iw / mw
    sy = ih / mh
    mul = _on(c6.device, sx, sx, sx, sy, sy)
    div = _on(c6.device, sy * sy, sy, 1.0, 1.0, 1.0)
    return torch.cat([torch.zeros_like(c6[..., :1]), c6[..., 1:] * mul / div], -1)


def _gen_points(c6):
    """Sample x = a*y^2 + b*y + c every SAMPLE_STEP rows inside [ymin, ymax].
    -> (..., MAX_PTS, 2) points and a (..., MAX_PTS) validity mask."""
    steps = torch.arange(MAX_PTS, dtype=torch.float32, device=c6.device)
    ys = c6[..., 4:5] + SAMPLE_STEP * steps
    valid = ys <= c6[..., 5:6]
    a = torch.where(c6[..., 1:2] != 0, c6[..., 1:2], 0.0)
    xs = a * ys * ys + c6[..., 2:3] * ys + c6[..., 3:4]
    return torch.stack([xs, ys], -1), valid


def warp_points(pts, H):
    """Perspective transform of (..., N, 2) points by a (3, 3) H."""
    p = torch.cat([pts, torch.ones_like(pts[..., :1])], -1) @ H.T
    w = p[..., 2:]
    return p[..., :2] / torch.clamp(w.abs(), min=1e-12) * torch.sign(w)


def _masked_quadfit(pts, mask):
    """Least-squares x = a*y^2 + b*y + c on masked points (..., P, 2) and
    (..., P); returns ([0,a,b,c,ymin,ymax] (..., 6), ok (...)). y
    normalized internally for conditioning."""
    y = pts[..., 1]
    x = pts[..., 0]
    m = mask.to(torch.float32)
    n = m.sum(-1)
    ysc = 1.0 / torch.clamp((y.abs() * m).amax(-1), min=1.0)
    yn = y * ysc[..., None]
    A = torch.stack([yn * yn, yn, torch.ones_like(yn)], -1)
    Am = A * m[..., None]
    AtA = Am.transpose(-1, -2) @ A + 1e-8 * torch.eye(3, device=pts.device)
    Atb = (Am.transpose(-1, -2) @ x[..., None])[..., 0]
    q = solve3x3(AtA, Atb)
    a = q[..., 0] * ysc * ysc
    b = q[..., 1] * ysc
    c = q[..., 2]
    ymin = torch.where(mask, y, float("inf")).amin(-1)
    ymax = torch.where(mask, y, float("-inf")).amax(-1)
    ok = n >= 3
    return torch.stack([torch.zeros_like(a), a, b, c, ymin, ymax], -1), ok


def _offset(c6, y):
    return c6[..., 1] * y * y + c6[..., 2] * y + c6[..., 3]


def _yaw(c6, y):
    return torch.atan(2 * c6[..., 1] * y + c6[..., 2])


def _curvature(c6, y):
    dxdy = 2 * c6[..., 1] * y + c6[..., 2]
    d2 = 2 * c6[..., 1]
    denom = (1 + dxdy * dxdy) ** 1.5
    return torch.where(denom.abs() < 1e-6, 0.0, d2.abs() / denom)


class LaneTrackerOutput(NamedTuple):
    left_coeffs: torch.Tensor      # (6,) model space
    right_coeffs: torch.Tensor
    center_coeffs: torch.Tensor
    path_valid: torch.Tensor
    # dual-view metrics
    orig_lane_offset: torch.Tensor
    orig_yaw_offset: torch.Tensor
    orig_curvature: torch.Tensor
    bev_lane_offset: torch.Tensor
    bev_yaw_offset: torch.Tensor
    bev_curvature: torch.Tensor
    # BEV points for PathFinder (pixels) + masks
    bev_left_pts: torch.Tensor     # (MAX_PTS, 2)
    bev_left_mask: torch.Tensor
    bev_right_pts: torch.Tensor
    bev_right_mask: torch.Tensor
    bev_width: torch.Tensor


def _last_valid_x(bev, mask):
    """x of the bottom-most valid sample (of sample 0 if none is valid)."""
    # the row indices as f32 (exact below 2**24): inductor's Triton code for
    # an int64 max over a where() does not compile (torch 2.11)
    rows = torch.arange(MAX_PTS, dtype=torch.float32, device=bev.device)
    idx = torch.where(mask, rows, -1.0).amax(-1).clamp(0, MAX_PTS - 1).long()
    return bev[..., 0].gather(-1, idx[..., None])[..., 0]


def lane_tracker_update(left_c6, left_valid, right_c6, right_valid,
                        state: LaneTrackerState,
                        model_hw=(80, 160), image_hw=(640, 1280)):
    """One LaneTracker::update step, for one stream or a batch (leading
    axes on every input and on the state); -> (LaneTrackerOutput, new
    state)."""
    H, H_inv = homographies(left_c6.device)

    def side_points(c6, valid):
        up = upscale_coeffs(c6, model_hw, image_hw)
        pts, mask = _gen_points(up)
        return warp_points(pts, H), mask & valid[..., None]

    left_bev, lmask = side_points(left_c6, left_valid)
    right_bev, rmask = side_points(right_c6, right_valid)

    both = left_valid & right_valid

    # width update at the bottom-most valid sample of each lane
    w_now = (_last_valid_x(right_bev, rmask) - _last_valid_x(left_bev, lmask)).abs()
    new_width = torch.where(
        both,
        torch.where(state.has_width_history,
                    state.bev_width * WIDTH_EMA + w_now * (1 - WIDTH_EMA),
                    w_now),
        state.bev_width)
    new_hist = state.has_width_history | both

    # missing-lane recovery via width shift in BEV
    can_recover = state.has_width_history
    recover_left = (~left_valid) & right_valid & can_recover
    recover_right = left_valid & (~right_valid) & can_recover

    shift = torch.stack([new_width, torch.zeros_like(new_width)], -1)[..., None, :]
    rec_l, rec_r = recover_left[..., None], recover_right[..., None]
    left_bev = torch.where(rec_l[..., None], right_bev - shift, left_bev)
    lmask = torch.where(rec_l, rmask, lmask)
    right_bev = torch.where(rec_r[..., None], left_bev + shift, right_bev)
    rmask = torch.where(rec_r, lmask, rmask)

    # reproject recovered lanes to model space and refit for output coeffs
    (mh, mw), (ih, iw) = model_hw, image_hw
    scale = _on(left_c6.device, iw / mw, ih / mh)

    def refit_model(bev, mask):
        return _masked_quadfit(warp_points(bev, H_inv) / scale, mask)

    fit_l, _ = refit_model(left_bev, lmask)
    left_out = torch.where(rec_l, fit_l, left_c6)
    fit_r, _ = refit_model(right_bev, rmask)
    right_out = torch.where(rec_r, fit_r, right_c6)

    have_both_pts = lmask.any(-1) & rmask.any(-1)

    # BEV center fit + metrics at the vehicle row (y = 640)
    center_bev = (left_bev + right_bev) * 0.5
    cmask = lmask & rmask
    bev_center_c6, _ = _masked_quadfit(center_bev, cmask)
    bev_car_y = BEV_SIZE
    bev_off = _offset(bev_center_c6, bev_car_y) - BEV_CENTER_X
    bev_yaw = _yaw(bev_center_c6, bev_car_y)
    bev_curv = _curvature(bev_center_c6, bev_car_y)

    center_c6 = (left_out + right_out) / 2.0
    orig_car_y = float(mh - 1)
    orig_off = _offset(center_c6, orig_car_y) - mw / 2.0
    orig_yaw = _yaw(center_c6, orig_car_y)
    orig_curv = _curvature(center_c6, orig_car_y)

    def gated(v):
        lead = have_both_pts.shape
        return torch.where(have_both_pts.reshape(lead + (1,) * (v.dim() - len(lead))), v, 0.0)

    return LaneTrackerOutput(
        left_coeffs=left_out,
        right_coeffs=right_out,
        center_coeffs=gated(center_c6),
        path_valid=have_both_pts,
        orig_lane_offset=gated(orig_off),
        orig_yaw_offset=gated(orig_yaw),
        orig_curvature=gated(orig_curv),
        bev_lane_offset=gated(bev_off),
        bev_yaw_offset=gated(bev_yaw),
        bev_curvature=gated(bev_curv),
        bev_left_pts=left_bev,
        bev_left_mask=lmask,
        bev_right_pts=right_bev,
        bev_right_mask=rmask,
        bev_width=new_width,
    ), LaneTrackerState(new_width, new_hist)


def bev_pixels_to_meters(pts):
    """(..., 2) BEV pixels -> meters, vehicle at bottom center
    (main.cpp transformPixelsToMeters)."""
    x = (pts[..., 0] - BEV_CENTER_X) * BEV_SCALE
    y = (BEV_SIZE - pts[..., 1]) * BEV_SCALE
    return torch.stack([x, y], -1)
