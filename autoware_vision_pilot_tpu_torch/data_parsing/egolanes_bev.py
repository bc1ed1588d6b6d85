"""The port of autoware_vision_pilot_tpu/data_parsing/egolanes_bev.py.

EgoLanes BEV ground-truth generation — the per-dataset parse paths.

Reference: Models/data_parsing/EgoLanes/{CurveLanes,TuSimple,CULane,
OpenLane}/parse_*_bev.py — four ~800-1000 LoC scripts that are the same
algorithm with per-dataset camera/frame parameters. This module is that
algorithm ONCE, with the dataset differences as `BEVConfig` presets, and
produces the identical master-JSON schema (per-frame bev_egopath /
reproj_egopath / bev_ego{left,right} as (x, y, flag, valid) tuples +
the 3x3 homomatrix) the EgoLanes BEV losses train on.

Geometry (parse_curvelanes_bev.py:294-455, identical in the siblings):

1. Anchor each egoline at the image bottom by extending its last segment
   (`line_anchor` = process_curvelanes.getLineAnchor).
2. Source trapezoid: LS/RS = egoline anchors at y=h; LE/RE placed at the
   ego height along the mean anchor direction, preserving the measured
   lane width there (`find_source_points` = findSourcePointsBEV).
3. 4-point homography onto the fixed BEV rectangle (BEV_PTS), computed
   with the repo's DLT (calibration/homography.py) instead of
   cv2.findHomography — exact for 4 points.
4. Drivable path -> BEV -> order-2 polyfit resampled on a fixed y grid
   (11 points at y_step 128), per-point flag (last in-frame point) and
   validity (in-frame prefix) lists (`fit_bev_line` = polyfit_BEV).
5. Ego sides = BEV egopath shifted by the BEV-transformed half-width
   (`ego_side` = calEgoSide + calTransformedDistance).
6. Frame sanity checks: polyfit ordering, anchor-centrality, anchor
   angle <= 45 deg, angle-direction consistency
   (parse_curvelanes_bev.py:705-757).
"""
from __future__ import annotations

import dataclasses
import json
import math
import pathlib
from typing import Optional, Sequence

import numpy as np

from ..calibration.homography import compute_homography, apply_homography

Point = tuple[float, float]


@dataclasses.dataclass(frozen=True)
class BEVConfig:
    """Per-dataset parameters of the shared BEV parse algorithm."""
    frame_w: int
    frame_h: int
    bev_w: int = 640
    bev_h: int = 1280
    # fixed BEV destination trapezoid (LS, RS, LE, RE)
    bev_pts: tuple = ((240, 1280), (400, 1280), (240, 0), (400, 0))
    y_step: int = 128
    polyfit_order: int = 2
    min_points: int = 30
    anchor_angle_deg: float = 45.0
    anchor_distance_frac: float = 0.3


# the published camera/frame configs (parse_*_bev.py __main__ blocks):
CURVELANES = BEVConfig(frame_w=800, frame_h=400)     # CurveLanes:554-560
TUSIMPLE = BEVConfig(frame_w=1280, frame_h=720)      # TuSimple:558-571
CULANE = BEVConfig(frame_w=1440, frame_h=430)        # CULane:504-517
OPENLANE = BEVConfig(frame_w=1920, frame_h=1280)     # OpenLane:679-685

DATASETS = {"curvelanes": CURVELANES, "tusimple": TUSIMPLE,
            "culane": CULANE, "openlane": OPENLANE}


def line_anchor(line: Sequence[Point], img_height: float):
    """Extend a polyline's first segment to y = img_height.

    Returns (x0, slope a, intercept b); a and b are None for degenerate
    vertical/horizontal first segments (getLineAnchor,
    process_curvelanes.py:80-109 — including its quirk of scanning for
    the first point that differs in BOTH coordinates)."""
    (x2, y2) = line[0]
    (x1, y1) = line[1]
    for i in range(1, len(line) - 1):
        if (line[i][0] != x2) and (line[i][1] != y2):
            (x1, y1) = line[i]
            break
    if x1 == x2 or y1 == y2:
        return (x1, None, None)
    a = (y2 - y1) / (x2 - x1)
    b = y1 - a * x1
    return ((img_height - b) / a, a, b)


def interp_line(line: Sequence[Point], points_quota: int) -> list[Point]:
    """Resample a polyline to >= points_quota points, evenly by arc
    length (process_curvelanes.interpLine)."""
    if len(line) >= points_quota:
        return list(line)
    x = np.array([p[0] for p in line], np.float64)
    y = np.array([p[1] for p in line], np.float64)
    d = np.cumsum(np.sqrt(np.diff(x, prepend=x[0]) ** 2 +
                          np.diff(y, prepend=y[0]) ** 2))
    d[0] = 0
    t = np.linspace(d[0], d[-1], points_quota)
    return list(zip(np.interp(t, d, x), np.interp(t, d, y)))


def interp_x(line: Sequence[Point], y: float) -> float:
    """x on the polyline at a given y (sorted-by-y interp)."""
    pts = np.asarray(line, np.float64)
    xs, ys = pts[:, 0], pts[:, 1]
    if not np.all(np.diff(ys) > 0):
        order = np.argsort(ys)
        xs, ys = xs[order], ys[order]
    return float(np.interp(y, ys, xs))


def normalize_coords(line, width, height):
    return [(x / width, y / height) for x, y in line]


def anchor_angle(line: Sequence[Point]) -> float:
    """Angle vs the vertical axis at the anchor, degrees; +/- = right/
    left-leaning (parse_curvelanes_bev.calAngle)."""
    return math.degrees(math.atan2(line[1][0] - line[0][0],
                                   -(line[1][1] - line[0][1])))


def find_source_points(cfg: BEVConfig, egoleft: Sequence[Point],
                       egoright: Sequence[Point]) -> dict:
    """Source trapezoid for the BEV homography from NORMALIZED egolines
    (findSourcePointsBEV, parse_curvelanes_bev.py:294-369)."""
    h, w = cfg.frame_h, cfg.frame_w
    egoleft = [[p[0] * w, p[1] * h] for p in egoleft]
    egoright = [[p[0] * w, p[1] * h] for p in egoright]

    anchor_left = line_anchor(egoleft, h)
    anchor_right = line_anchor(egoright, h)
    sps = {"LS": [anchor_left[0], h], "RS": [anchor_right[0], h]}

    mid_start = [(sps["LS"][0] + sps["RS"][0]) / 2, h]
    sps["midanchor_start"] = mid_start
    ego_height = max(egoleft[-1][1], egoright[-1][1])

    if anchor_left[1] is None and anchor_right[1] is None:
        mid_end = [mid_start[0], h]
        end_w = sps["RS"][0] - sps["LS"][0]
    else:
        left_deg = (90 if anchor_left[1] is None
                    else math.degrees(math.atan(anchor_left[1])) % 180)
        right_deg = (90 if anchor_right[1] is None
                     else math.degrees(math.atan(anchor_right[1])) % 180)
        mid_deg = (left_deg + right_deg) / 2
        mid_grad = -math.tan(math.radians(mid_deg))
        mid_intercept = h - mid_grad * mid_start[0]
        mid_end = [(ego_height - mid_intercept) / mid_grad, ego_height]
        end_w = interp_x(egoright, ego_height) - interp_x(egoleft,
                                                          ego_height)

    sps["LE"] = [mid_end[0] - end_w / 2, ego_height]
    sps["RE"] = [mid_end[0] + end_w / 2, ego_height]
    for k in ("LS", "RS", "LE", "RE", "midanchor_start"):
        sps[k] = (int(sps[k][0]), int(sps[k][1]))
    sps["ego_h"] = ego_height
    return sps


def bev_homography(cfg: BEVConfig, sps: dict) -> np.ndarray:
    """Exact 4-point DLT homography source trapezoid -> BEV rectangle."""
    src = np.array([sps["LS"], sps["RS"], sps["LE"], sps["RE"]],
                   np.float64)
    dst = np.array(cfg.bev_pts, np.float64)
    return compute_homography(src, dst)


def fit_bev_line(cfg: BEVConfig, bev_line: Sequence[Point]):
    """Order-2 polyfit on the fixed BEV y grid + flag/validity lists
    (polyfit_BEV, parse_curvelanes_bev.py:229-283). Returns
    (points hi->lo y, flags, validity) or (None, None, None)."""
    valid = [p for p in bev_line
             if 0 <= p[0] < cfg.bev_w and 0 <= p[1] < cfg.bev_h]
    if not valid:
        return None, None, None
    z = np.polyfit([p[1] for p in valid], [p[0] for p in valid],
                   cfg.polyfit_order)
    y_new = np.linspace(0, cfg.bev_h, cfg.bev_h // cfg.y_step + 1)
    x_new = np.poly1d(z)(y_new)
    fitted = sorted(zip(x_new, y_new), key=lambda p: p[1], reverse=True)

    flags = [0] * len(fitted)
    for i, p in enumerate(fitted):
        if not 0 <= p[0] <= cfg.bev_w:
            flags[i - 1] = 1
            break
    if 1 not in flags:
        flags[-1] = 1
    validity = [1] * len(fitted)
    for i in range(flags.index(1) + 1, len(fitted)):
        validity[i] = 0
    return fitted, flags, validity


def transform_bev(cfg: BEVConfig, line: Sequence[Point], sps: dict,
                  H: np.ndarray):
    """NORMALIZED drivable path -> (bev_line, reproj_line, flags,
    validity, ok) (transformBEV, parse_curvelanes_bev.py:372-454,
    minus the image warp — GT generation needs only the geometry)."""
    pts = [(p[0] * cfg.frame_w, p[1] * cfg.frame_h) for p in line
           if p[1] * cfg.frame_h >= sps["ego_h"]]
    if not pts:
        return None, None, None, None, False
    pts = interp_line(pts, cfg.min_points)
    # float32 before int-truncation: the reference's cv2.perspectiveTransform
    # path is f32, and the truncation boundary must agree with it
    bev = apply_homography(H, np.asarray(pts, np.float64)).astype(
        np.float32)
    bev = [(int(x), int(y)) for x, y in bev]
    fitted, flags, validity = fit_bev_line(cfg, bev)
    if not fitted:
        return None, None, None, None, False
    reproj = apply_homography(np.linalg.inv(H),
                              np.asarray(fitted, np.float64)).astype(
                                  np.float32)
    reproj = [(int(x), int(y)) for x, y in reproj]
    return fitted, reproj, flags, validity, True


def transformed_distance(a: Point, b: Point, H: np.ndarray) -> float:
    pa, pb = apply_homography(H, np.asarray([a, b], np.float64))
    return float(np.linalg.norm(pa - pb))


def ego_side(cfg: BEVConfig, bev_egopath: Sequence[Point],
             anchor_offset: float, H: np.ndarray):
    """Shift the BEV egopath laterally by the BEV half-width; reproject;
    flag/validity (calEgoSide, parse_curvelanes_bev.py:473-525)."""
    bev = [(int(x + anchor_offset), int(y)) for x, y in bev_egopath]
    orig = apply_homography(np.linalg.inv(H),
                            np.asarray(bev, np.float64)).astype(np.float32)
    orig = [(int(x), int(y)) for x, y in orig]
    flags = [0] * len(bev)
    for i, p in enumerate(bev):
        if not 0 <= p[0] <= cfg.bev_w:
            flags[i - 1] = 1
            break
    if 1 not in flags:
        flags[-1] = 1
    validity = [1] * len(bev)
    for i in range(flags.index(1) + 1, len(bev)):
        validity[i] = 0
    return bev, orig, flags, validity


def _pack(line, flags, validity, w, h):
    return [(round(x / w, 6), round(y / h, 6), f, v)
            for (x, y), f, v in zip(line, flags, validity)]


def frame_bev_gt(cfg: BEVConfig, frame: dict) -> tuple[Optional[dict],
                                                       Optional[str]]:
    """One frame's annotation dict {drivable_path, egoleft_lane,
    egoright_lane} (normalized) -> (master-JSON entry, None) or
    (None, skip reason) — the full per-frame path of parse_*_bev.py's
    main loop including every sanity check (lines 636-757)."""
    try:
        sps = find_source_points(cfg, frame["egoleft_lane"],
                                 frame["egoright_lane"])
        H = bev_homography(cfg, sps)
        bev_path, reproj_path, flags, validity, ok = transform_bev(
            cfg, frame["drivable_path"], sps, H)
        if not ok:
            return None, "Null EgoPath from BEV transformation algorithm."
        off = transformed_distance(sps["LS"], sps["midanchor_start"], H)
        bev_l, orig_l, flags_l, val_l = ego_side(cfg, bev_path, -off, H)
        bev_r, orig_r, flags_r, val_r = ego_side(cfg, bev_path, +off, H)
    except Exception as e:  # reference logs + skips on any error
        return None, str(e)

    # sanity checks, same order as the reference main loop
    if not (bev_l[0][0] <= bev_path[0][0] <= bev_r[0][0]
            and bev_l[-1][0] <= bev_path[-1][0] <= bev_r[-1][0]):
        return None, "Polyfit went horribly wrong."
    lo = cfg.bev_w * cfg.anchor_distance_frac
    hi = cfg.bev_w * (1 - cfg.anchor_distance_frac)
    if not lo <= bev_path[0][0] <= hi:
        return None, "EgoPath anchor is too far left or right."
    a_path = anchor_angle(bev_path)
    a_left = anchor_angle(bev_l)
    a_right = anchor_angle(bev_r)
    if abs(a_path) > cfg.anchor_angle_deg:
        return None, f"EgoPath anchor angle is too steep: {a_path}"
    if not ((a_path > 0 and a_left > 0 and a_right > 0)
            or (a_path < 0 and a_left < 0 and a_right < 0)):
        return None, ("EgoPath/EgoLeft/EgoRight anchor angles are not "
                      "consistent.")

    w, h, bw, bh = cfg.frame_w, cfg.frame_h, cfg.bev_w, cfg.bev_h
    return {
        "bev_egopath": _pack(bev_path, flags, validity, bw, bh),
        "reproj_egopath": _pack(reproj_path, flags, validity, w, h),
        "bev_egoleft": _pack(bev_l, flags_l, val_l, bw, bh),
        "reproj_egoleft": _pack(orig_l, flags_l, val_l, w, h),
        "bev_egoright": _pack(bev_r, flags_r, val_r, bw, bh),
        "reproj_egoright": _pack(orig_r, flags_r, val_r, w, h),
        "homomatrix": H.tolist(),
    }, None


def parse_dataset(json_path: str | pathlib.Path, dataset: str,
                  out_path: str | pathlib.Path | None = None,
                  skipped_path: str | pathlib.Path | None = None,
                  early_stopping: int | None = None) -> dict:
    """drivable_path.json -> drivable_path_bev.json for one dataset
    (the parse_*_bev.py __main__ loop, minus the per-frame image/viz
    writes)."""
    cfg = DATASETS[dataset]
    with open(json_path) as f:
        data = json.load(f)
    master, skipped = {}, {}
    for i, (frame_id, frame) in enumerate(data.items()):
        entry, reason = frame_bev_gt(cfg, frame)
        if entry is None:
            skipped[frame_id] = reason
        else:
            master[frame_id] = entry
        if early_stopping is not None and i + 1 >= early_stopping:
            break
    if out_path:
        with open(out_path, "w") as f:
            json.dump(master, f, indent=4)
    if skipped_path:
        with open(skipped_path, "w") as f:
            json.dump(skipped, f, indent=4)
    return master
