"""The port of autoware_vision_pilot_tpu/data_parsing/jiqing_once3d.py.

Jiqing Expressway + Once3DLane EgoLanes parsers.

Reference roles:
- Models/data_parsing/EgoLanes/Jiqing/process_jiqing.py (1920x1080 frames,
  120 px bottom crop; GT text files with "label: (x,y)(x,y)..." lines)
- Models/data_parsing/EgoLanes/Once3DLane/process_once3d.py (1920x1020;
  3D lane points projected through the camera intrinsics, order-2 polyfit
  resampling, acceptance filters)

Both share the same ego-lane classification: extrapolate each line to the
image bottom ("anchor" x), sort lines left-to-right by anchor, and the
first anchor at or right of the image centre marks the ego-right lane
(its left neighbour is ego-left). The GT mask is 3 channels
[ego-left, ego-right, other] rasterized at 4 px width.
"""
from __future__ import annotations

import ast
from typing import List, Optional, Sequence, Tuple

import numpy as np

JIQING_WH = (1920, 1080)
JIQING_CROP_BOTTOM = 120
ONCE3D_WH = (1920, 1020)


def line_anchor(line: np.ndarray, height: int) -> float:
    """x where the line through its two bottom-most points meets the image
    bottom. Lines are sorted by descending y; vertical/horizontal pairs
    anchor at their own x (getLineAnchor)."""
    (x2, y2), (x1, y1) = line[0], line[1]
    if x1 == x2 or y1 == y2:
        return float(x1)
    a = (y2 - y1) / (x2 - x1)
    b = y1 - a * x1
    return float((height - b) / a)


def classify_ego_pair(lines: Sequence[np.ndarray], width: int, height: int,
                      presorted: bool = False,
                      anchors: Optional[Sequence[float]] = None
                      ) -> Optional[Tuple[int, int, List[int]]]:
    """Ego pair by bottom-anchor scan: indices (left, right, others) into
    `lines`, or None when no anchor reaches the right half."""
    if anchors is None:
        anchors = [line_anchor(ln, height) for ln in lines]
    order = list(range(len(lines))) if presorted else \
        sorted(range(len(lines)), key=lambda i: anchors[i])
    for pos, i in enumerate(order):
        if anchors[i] >= width / 2:
            if pos == 0:
                li, ri = order[0], order[1]
            else:
                li, ri = order[pos - 1], order[pos]
            others = [j for j in order if j != li and j != ri]
            return li, ri, others
    return None


def rasterize_ego_mask(lines: Sequence[np.ndarray], ego: Tuple,
                       image_hw: Tuple[int, int],
                       thickness: int = 4) -> np.ndarray:
    """(H, W, 3) uint8 {0,255} mask [ego-left, ego-right, other]."""
    import cv2
    h, w = image_hw
    li, ri, others = ego
    mask = np.zeros((h, w, 3), np.uint8)
    groups = ([li], [ri], others)
    for ch, idxs in enumerate(groups):
        plane = np.zeros((h, w), np.uint8)  # channel views aren't cv-compat
        for i in idxs:
            pts = np.round(lines[i]).astype(np.int32).reshape(-1, 1, 2)
            cv2.polylines(plane, [pts], False, 255, thickness)
        mask[..., ch] = plane
    return mask


# ---- Jiqing ----------------------------------------------------------------

def parse_jiqing_gt(text: str, image_wh: Tuple[int, int] = JIQING_WH,
                    crop_bottom: int = JIQING_CROP_BOTTOM
                    ) -> Optional[dict]:
    """One Jiqing GT file -> {'egoleft_lane', 'egoright_lane',
    'other_lanes', 'mask'} or None when the frame is rejected.

    GT lines look like "lane_1: (x,y)(x,y)...". Points at or below the
    cropped height are dropped; lines need >= 2 points; frames need >= 2
    lines and a resolvable ego pair.
    """
    w, h = image_wh
    new_h = h - crop_bottom
    lanes = []
    for raw in text.splitlines():
        raw = raw.strip()
        if not raw or ":" not in raw:
            continue
        body = raw.split(":", 1)[1].strip()
        if not body:
            continue
        pts = [ast.literal_eval(p)
               for p in body.replace(")(", ")|(").split("|")]
        pts = sorted([p for p in pts if p[1] < new_h],
                     key=lambda p: p[1], reverse=True)
        if len(pts) >= 2:
            lanes.append(np.asarray(pts, np.float64))
    if len(lanes) < 2:
        return None
    ego = classify_ego_pair(lanes, w, new_h, presorted=True)
    if ego is None:
        return None
    li, ri, others = ego
    return {
        "egoleft_lane": lanes[li],
        "egoright_lane": lanes[ri],
        "other_lanes": [lanes[i] for i in others],
        "mask": rasterize_ego_mask(lanes, ego, (new_h, w)),
    }


# ---- Once3DLane -------------------------------------------------------------

def _polyfit_resample(line_xy: np.ndarray, y_range: Tuple[float, float],
                      order: int = 2, n: int = 10) -> np.ndarray:
    """Fit x = f(y), resample n points over y_range, return sorted by
    descending y (process_once3d.py polyfit)."""
    z = np.polyfit(line_xy[:, 1], line_xy[:, 0], order)
    ys = np.linspace(y_range[0], y_range[1], n)
    xs = np.polyval(z, ys)
    pts = np.stack([xs, ys], -1)
    return pts[np.argsort(-pts[:, 1])]


def parse_once3d_entry(label_data: dict,
                       image_wh: Tuple[int, int] = ONCE3D_WH
                       ) -> Optional[dict]:
    """One Once3DLane JSON entry ({'lane_num', 'lanes' 3D points,
    'calibration' 3x3-or-3x4 intrinsics}) -> ego-classified 2D lanes +
    mask, or None when rejected (same filters as the reference: >= 2 and
    <= 6 usable lines, lines starting in the lower third, ego anchor pair
    centred within the middle 50% of the frame)."""
    w, h = image_wh
    if label_data.get("lane_num", 0) < 2:
        return None
    K = np.asarray(label_data["calibration"], np.float64)
    lines_2d = []
    for line_3d in label_data["lanes"]:
        p = np.asarray(line_3d, np.float64)[:, :3]
        homo = np.c_[p, np.ones(len(p))]
        img = homo @ K.T if K.shape == (3, 4) else p @ K.T
        img = img / img[:, 2:3]
        pts = img[:, :2]
        if len(pts) < 2:
            continue
        pts = _polyfit_resample(pts, (pts[-1, 1], pts[0, 1]))
        if pts[0, 1] <= h * 2 / 3:     # must reach the lower third
            continue
        anchor = line_anchor(pts, h)
        pts = np.vstack([[anchor, h - 1], pts])
        lines_2d.append(pts)
    if not 2 <= len(lines_2d) <= 6:
        return None
    lines_2d = sorted(lines_2d, key=lambda l: l[0][0])
    # Once3D classifies by the prepended bottom-anchor x directly
    ego = classify_ego_pair(lines_2d, w, h, presorted=True,
                            anchors=[l[0][0] for l in lines_2d])
    if ego is None:
        return None
    li, ri, others = ego
    mid = (lines_2d[li][0][0] + lines_2d[ri][0][0]) / 2
    if not (w * 0.25 <= mid <= w * 0.75):
        return None
    return {
        "egoleft_lane": lines_2d[li],
        "egoright_lane": lines_2d[ri],
        "other_lanes": [lines_2d[i] for i in others],
        "mask": rasterize_ego_mask(lines_2d, ego, (h, w)),
    }
