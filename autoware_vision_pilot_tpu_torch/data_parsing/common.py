"""The port of autoware_vision_pilot_tpu/data_parsing/common.py.

Dataset parsing framework: open-dataset annotations -> the unified GT
format the trainers consume.

The reference converts ~20 datasets with per-dataset scripts
(Models/data_parsing/, 17.5k LoC). Here a small shared core does the
common work — lane polyline rasterization into the 3-class EgoLanes
convention, unified color-coded mask writing, and sparse-LiDAR depth
densification (Scene3D/common/lidar_depth_fill.py) — and thin per-dataset
modules translate each annotation format.
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None

# EgoLanes GT channels: 0 ego-left, 1 ego-right, 2 other
UNIFIED_LANE_COLORS = ((255, 0, 0), (0, 0, 255), (0, 255, 0))


def classify_ego_lanes(lanes: Sequence[np.ndarray], image_w: int
                       ) -> Tuple[Optional[int], Optional[int]]:
    """Pick the ego pair: nearest lane left / right of center by the
    bottom-most x. Returns (left_idx, right_idx)."""
    mid = image_w / 2
    best_l, best_r = None, None
    best_lx, best_rx = -np.inf, np.inf
    for i, lane in enumerate(lanes):
        if len(lane) == 0:
            continue
        x = lane[np.argmax(lane[:, 1]), 0]  # x at max y (closest to car)
        if x <= mid and x > best_lx:
            best_lx, best_l = x, i
        elif x > mid and x < best_rx:
            best_rx, best_r = x, i
    return best_l, best_r


def rasterize_lanes(lanes: Sequence[np.ndarray], image_hw: Tuple[int, int],
                    thickness: int = 4) -> np.ndarray:
    """Lane polylines -> (H, W, 3) float binary masks
    [ego_left, ego_right, other]."""
    h, w = image_hw
    masks = np.zeros((h, w, 3), np.float32)
    li, ri = classify_ego_lanes(lanes, w)
    for i, lane in enumerate(lanes):
        if len(lane) < 2:
            continue
        ch = 0 if i == li else 1 if i == ri else 2
        plane = np.zeros((h, w), np.uint8)
        pts = np.round(lane).astype(np.int32).reshape(-1, 1, 2)
        cv2.polylines(plane, [pts], False, 1, thickness)
        masks[..., ch] = np.maximum(masks[..., ch], plane)
    return masks


def write_unified_sample(out_dir: str | Path, name: str,
                         image_bgr: np.ndarray, label_rgb: np.ndarray):
    """Write an image/label pair in the unified directory layout
    (<root>/images/*.png + <root>/labels/*.png)."""
    out = Path(out_dir)
    (out / "images").mkdir(parents=True, exist_ok=True)
    (out / "labels").mkdir(parents=True, exist_ok=True)
    cv2.imwrite(str(out / "images" / f"{name}.png"), image_bgr)
    cv2.imwrite(str(out / "labels" / f"{name}.png"),
                cv2.cvtColor(label_rgb, cv2.COLOR_RGB2BGR))


def lidar_depth_fill(sparse_depth: np.ndarray,
                     max_iters: int = 50) -> np.ndarray:
    """Densify a sparse projected-LiDAR depth map by iterative
    nearest-valid dilation (Scene3D/common/lidar_depth_fill.py role).
    Zeros are holes; each iteration fills holes adjacent to valid pixels
    with the local max-pooled depth."""
    d = sparse_depth.astype(np.float32).copy()
    kernel = np.ones((3, 3), np.uint8)
    for _ in range(max_iters):
        holes = d <= 0
        if not holes.any():
            break
        filled = cv2.dilate(d, kernel)
        d[holes] = filled[holes]
    return d
