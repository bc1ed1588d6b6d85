"""The port of autoware_vision_pilot_tpu/data_parsing/kitti_depth.py.

KITTI LiDAR -> dense depth GT (Models/data_parsing/Scene3D/KITTI role):
project velodyne points through the calibration into the image, keep the
nearest depth per pixel, densify with lidar_depth_fill.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from .common import lidar_depth_fill


def parse_kitti_calib(text: str) -> Dict[str, np.ndarray]:
    """KITTI calib file: 'KEY: v v v ...' lines -> {KEY: array}."""
    out = {}
    for line in text.splitlines():
        if ":" not in line:
            continue
        k, v = line.split(":", 1)
        vals = np.fromstring(v, sep=" ")
        if vals.size:
            out[k.strip()] = vals
    return out


def velodyne_to_depth(points_xyz: np.ndarray, P2: np.ndarray,
                      R0_rect: np.ndarray, Tr_velo_to_cam: np.ndarray,
                      image_hw: Tuple[int, int],
                      fill: bool = True) -> np.ndarray:
    """points (N,>=3) velodyne frame -> (H, W) depth meters.

    P2 (3,4) projection, R0_rect (3,3), Tr_velo_to_cam (3,4) — the standard
    KITTI chain: x_img = P2 @ [R0|0] @ [Tr|0;1] @ x_velo.
    """
    h, w = image_hw
    pts = np.c_[points_xyz[:, :3], np.ones(len(points_xyz))]
    cam = (Tr_velo_to_cam @ pts.T)          # (3, N)
    cam = R0_rect @ cam
    front = cam[2] > 0.1
    cam = cam[:, front]
    proj = P2 @ np.vstack([cam, np.ones(cam.shape[1])])
    u = (proj[0] / proj[2]).round().astype(int)
    v = (proj[1] / proj[2]).round().astype(int)
    z = cam[2]
    ok = (u >= 0) & (u < w) & (v >= 0) & (v < h)
    depth = np.zeros((h, w), np.float32)
    # keep nearest point per pixel: sort far->near so near overwrites
    order = np.argsort(-z[ok])
    uu, vv, zz = u[ok][order], v[ok][order], z[ok][order]
    depth[vv, uu] = zz
    return lidar_depth_fill(depth) if fill else depth
