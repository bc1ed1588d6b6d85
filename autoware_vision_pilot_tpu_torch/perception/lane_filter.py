"""Lane filtering: raw EgoLanes masks -> clean polynomial lane fits, the port
of autoware_vision_pilot_tpu/perception/lane_filter.py.

Rebuild of production_release/src/lane_filtering/lane_filter.cpp, with the
JAX package's behaviour:

- ROI start-point scan over the lower half of the mask, outward from the
  mid column (findStartingPoints): ``_find_start``.
- momentum-guided sliding-window search, bi-directional, with
  perspective-aware window width (1 px in the upper half, 6 px below),
  strict-ego mode in the upper half, >=3-pixel windows accepted,
  12-empty-window cutoff, horizon cutoff at 25% height
  (slidingWindowSearch): ``_sliding_search``. Its result is a weight image
  that counts how many windows took each pixel.
- weighted least-squares fit, quadratic from 30 points on, else linear, on
  the weight image compacted to its top-K cells; coeffs packed
  [a3, a2, a1, a0, y_min, y_max] (fitPoly): ``_weighted_fit``. The
  reference's RANSAC loop never changes the result and is not computed; the
  JAX package's unused RANSAC key is dropped.
- EMA temporal smoothing (factor 0.5) against the previous valid fit.

``_find_start`` and ``_sliding_search`` are the plain version of the
lane-filter walk kernel (ops/kernels/lane_filter_kernel.py), which
``lane_filter_update`` calls: the walk's ~45 tensor ops a step, 2 sides x 2
directions x H/4 steps, become one launch on the card.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.kernels.lane_filter_kernel import lane_filter_walk
from ..ops.smallsolve import solve3x3

# --- constants (lane_filter.hpp:30-63) ---
# The start-point ROI and the window-width / strictness switch sit at the
# mask's half height (rows 40..79 of the reference's 80-row mask).


def _roi_y_min(h: int) -> int:
    return h // 2


WIN_H = 4
MIN_WIN_W = 1
MAX_WIN_W = 6
MIN_PIXELS_FOR_FIT = 4
EMPTY_THRESHOLD = 12
SMOOTHING = 0.5
TOP_K = 2048


class LaneFilterState(NamedTuple):
    prev_left: torch.Tensor         # (6,) [a3,a2,a1,a0,ymin,ymax]
    prev_left_valid: torch.Tensor   # () bool
    prev_right: torch.Tensor
    prev_right_valid: torch.Tensor

    @staticmethod
    def init(device="cuda") -> "LaneFilterState":
        return LaneFilterState(
            torch.zeros(6, device=device),
            torch.zeros((), dtype=torch.bool, device=device),
            torch.zeros(6, device=device),
            torch.zeros((), dtype=torch.bool, device=device))


def _find_start(ego, is_left: bool, width: int):
    """Lowest ROI row with a mask pixel on this side of the mid column, and
    in that row the pixel nearest to it. ego: (H, W) float mask.
    -> (x, y, found): 0-d int32, int32, bool."""
    h, w = ego.shape
    mid = width // 2
    cols = torch.arange(w, device=ego.device)
    if is_left:
        valid_x = cols < mid
        xkey = torch.where(valid_x, cols, -1)  # prefer larger x
    else:
        valid_x = cols >= mid
        xkey = torch.where(valid_x, w - cols, -1)  # prefer smaller x
    roi = ego[_roi_y_min(h):] > 0.5
    rowhit = (roi & valid_x).any(1)
    roi_h = roi.shape[0]
    rows = torch.arange(roi_h, device=ego.device)
    best_row = torch.where(rowhit, rows, -1).max()  # bottom-most hit row
    found = best_row >= 0
    row = best_row.clamp(0, roi_h - 1)
    rowmask = roi.index_select(0, row.reshape(1))[0]
    key = torch.where(rowmask, xkey, -1)
    x = torch.argmax(key)  # the first index of the largest key, as jnp.argmax
    y = row + _roi_y_min(h)
    return x.to(torch.int32), y.to(torch.int32), found


def _round_away(v):
    """std::round semantics (half away from zero) for the centroid cast."""
    return torch.where(v >= 0, torch.floor(v + 0.5), torch.ceil(v - 0.5))


def _sliding_search(ego, other, start_xy, found):
    """Bi-directional momentum window walk from ``start_xy`` (0-d int32
    tensors). -> (H, W) int32 weight image counting how many windows
    contributed each pixel. The up and down walks run side by side, as a
    batch of two, over the fixed budget of H / WIN_H steps."""
    h, w = ego.shape
    dev = ego.device
    i32 = torch.int32
    ys = torch.arange(h, device=dev)[None, :, None]
    xs = torch.arange(w, device=dev)[None, None, :]
    ego_b = ego > 0.5
    other_b = other > 0.5
    step_y = torch.arange(2, dtype=i32, device=dev) * 2 - 1  # up, down
    up = step_y < 0

    px = start_xy[0].expand(2)
    py = start_xy[1] + torch.where(up, 0, WIN_H).to(i32)
    dx = torch.zeros(2, device=dev)
    dy = step_y.to(torch.float32)
    empty = torch.zeros(2, dtype=i32, device=dev)
    stopped = (~found).expand(2)
    weights = torch.zeros((2, h, w), dtype=i32, device=dev)

    def win(v):
        return v[:, None, None]

    for _ in range(h // WIN_H):
        oob = (px < 0) | (px >= w) | torch.where(up, py < 0, py >= h)
        stopped = stopped | oob

        strict = py < h // 2
        cur_w = torch.where(strict, MIN_WIN_W, MAX_WIN_W).to(i32)
        wy0 = torch.where(up, torch.clamp(py - WIN_H, min=0), py)
        wy1 = torch.where(up, py, torch.clamp(py + WIN_H, max=h))
        wx0 = torch.clamp(px - cur_w, min=0)
        wx1 = torch.clamp(px + cur_w, max=w)

        in_win = ((ys >= win(wy0)) & (ys < win(wy1))
                  & (xs >= win(wx0)) & (xs < win(wx1)))
        ego_win = in_win & ego_b
        oth_win = in_win & other_b & ~win(strict)
        n_ego = ego_win.sum((1, 2))
        n_oth = oth_win.sum((1, 2))

        use_ego = n_ego >= 3
        use_oth = (~use_ego) & (n_oth >= 3)
        found_valid = use_ego | use_oth
        sel = torch.where(win(use_ego), ego_win, oth_win & win(use_oth))

        cnt = torch.clamp(sel.sum((1, 2)), min=1).to(torch.float32)
        cx = (sel * xs).sum((1, 2)).to(torch.float32) / cnt
        cy = (sel * ys).sum((1, 2)).to(torch.float32) / cnt

        take = found_valid & ~stopped
        weights = weights + (sel & win(take)).to(i32)

        # momentum + position update
        ddx = cx - px.to(torch.float32)
        ddy = cy - py.to(torch.float32)
        ln = torch.sqrt(ddx * ddx + ddy * ddy)
        upd_dir = take & (ln > 0.1)
        dx = torch.where(upd_dir, ddx / ln, dx)
        dy = torch.where(upd_dir, ddy / ln, dy)

        new_px = torch.where(take, _round_away(cx).to(i32), px)
        new_py = torch.where(take, _round_away(cy).to(i32), py)

        # miss branch
        horizon_cut = up & (py < h // 4) & ~found_valid
        stopped = stopped | horizon_cut
        empty = torch.where(take, 0, empty + 1).to(i32)
        stopped = stopped | (empty >= EMPTY_THRESHOLD)
        blind_px = px + (dx * WIN_H).to(i32)  # truncation toward zero
        blind_py = py + (dy * WIN_H).to(i32)
        new_px = torch.where(take, new_px, blind_px)
        new_py = torch.where(take, new_py, blind_py)

        # forced movement for termination
        new_py = torch.where(
            up, torch.where(new_py >= wy1 - 1, new_py - WIN_H, new_py),
            torch.where(new_py <= wy0 + 1, new_py + WIN_H, new_py))

        px = torch.where(stopped, px, new_px)
        py = torch.where(stopped, py, new_py)
    return weights[0] + weights[1]


def lane_filter_walk_plain(masks):
    """The plain version of the lane-filter walk kernel. masks: (H, W, 3)
    f32 [ego_left, ego_right, other]. -> (weights (2, H, W) int32, starts
    (2, 3) int32 [x, y, found]), left then right."""
    w = masks.shape[1]
    other = masks[..., 2]
    weights, starts = [], []
    for side in (0, 1):
        ego = masks[..., side]
        sx, sy, found = _find_start(ego, side == 0, w)
        weights.append(_sliding_search(ego, other, (sx, sy), found))
        starts.append(torch.stack([sx, sy, found.to(torch.int32)]))
    return torch.stack(weights), torch.stack(starts)


def _weighted_fit(weights):
    """Weighted least-squares fit of x(y) on (..., H, W) int weight images
    (the point multiset). -> (coeffs6 (..., 6), valid (...,)). y is
    normalized to [0, 1] for f32 conditioning; coefficients are rescaled to
    pixel space."""
    h, w = weights.shape[-2:]
    dev = weights.device
    ys = torch.arange(h, device=dev)[:, None] * torch.ones((1, w), device=dev)
    xs = torch.ones((h, 1), device=dev) * torch.arange(w, device=dev)[None, :]
    wt_full = weights.flatten(-2).to(torch.float32)

    n = wt_full.sum(-1)
    yf_full = ys.reshape(-1)
    y_min = torch.where(wt_full > 0, yf_full, float("inf")).amin(-1)
    y_max = torch.where(wt_full > 0, yf_full, float("-inf")).amax(-1)

    # The point multiset compacted to its top-K cells by weight: exact
    # whenever <= K cells are nonzero (at 80x160 the walk marks at most
    # 2 x 20 windows of 48 pixels, 1,920 cells). Ties may come in another
    # order than lax.top_k's, which only reorders the f32 sums below.
    K = min(TOP_K, h * w)
    wt, top_idx = torch.topk(wt_full, K)
    yf = yf_full[top_idx]
    xf = xs.reshape(-1)[top_idx]

    order = torch.where(n < 30, 1, 2)
    sc = 1.0 / (h - 1)

    yn = yf * sc
    # columns [y^2, y, 1]; the linear order zeroes the y^2 column
    c2 = torch.where(order[..., None] == 2, yn * yn, 0.0)
    A = torch.stack([c2, yn, torch.ones_like(yn)], -1)
    Aw = A * wt[..., None]
    AtA = Aw.transpose(-1, -2) @ A
    # degenerate guard for the linear order: a tiny ridge on the dead column
    e00 = (torch.arange(3, device=dev)[:, None] == 0) & (torch.arange(3, device=dev) == 0)
    AtA = AtA + e00 * torch.where(order == 1, 1e-6, 0.0)[..., None, None]
    Atb = (Aw.transpose(-1, -2) @ xf[..., None])[..., 0]
    coef = solve3x3(AtA, Atb)  # in normalized-y space [q2, q1, q0]

    # rescale to pixel y: x = q2*(y*sc)^2 + q1*(y*sc) + q0
    a2 = coef[..., 0] * sc * sc
    a1 = coef[..., 1] * sc
    a0 = coef[..., 2]
    coeffs6 = torch.stack([torch.zeros_like(a2), a2, a1, a0, y_min, y_max], -1)
    valid = (n >= MIN_PIXELS_FOR_FIT) & (wt.sum(-1) >= order + 1)
    return coeffs6, valid


def lane_filter_update(masks, state: LaneFilterState):
    """One LaneFilter::update step, on the masks' device.

    masks: (H, W, 3) f32 binary masks [ego_left, ego_right, other], the
    layout ``threshold_channels`` gives (the JAX function takes the three
    channels as separate arguments). Returns (left_coeffs6, left_valid,
    right_coeffs6, right_valid, new_state, left_weights, right_weights).
    """
    weights, starts = lane_filter_walk(masks)
    coeffs, valid = _weighted_fit(weights)
    found = starts[:, 2] > 0
    valid = valid & found
    prev = torch.stack([state.prev_left, state.prev_right])
    prev_valid = torch.stack([state.prev_left_valid, state.prev_right_valid])
    smoothed = torch.where(prev_valid[:, None],
                           SMOOTHING * coeffs + (1 - SMOOTHING) * prev, coeffs)
    out = torch.where(valid[:, None], smoothed, coeffs)
    # reference semantics: start not found -> invalidate history; valid
    # fit -> smoothed fit becomes history; invalid fit with start found ->
    # history untouched
    new_prev = torch.where(valid[:, None], out, prev)
    new_valid = found & (valid | prev_valid)
    new_state = LaneFilterState(new_prev[0], new_valid[0], new_prev[1], new_valid[1])
    return out[0], valid[0], out[1], valid[1], new_state, weights[0], weights[1]
