"""The port of autoware_vision_pilot_tpu/data_parsing/reprojection.py.

Camera/ground-plane reprojection math for BEV lane GT generation
(Models/data_parsing/EgoLanes/*/parse_*_bev.py and
EgoLanes/Comma2k19/utils/ camera/coordinate/orientation helpers).

Pinhole camera model; lanes annotated in 3D (or on the ground plane) are
projected into the image, and image points on the ground plane are lifted
back to BEV metric coordinates.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def euler_to_rotation(roll: float, pitch: float, yaw: float) -> np.ndarray:
    """XYZ-intrinsic Euler angles (rad) -> 3x3 rotation."""
    cr, sr = np.cos(roll), np.sin(roll)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cy, sy = np.cos(yaw), np.sin(yaw)
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def project_points(points_cam: np.ndarray, K: np.ndarray) -> np.ndarray:
    """Camera-frame 3D points (N,3, z forward) -> image pixels (N,2)."""
    p = (np.asarray(K) @ np.asarray(points_cam, np.float64).T).T
    return p[:, :2] / p[:, 2:3]


def world_to_camera(points_world: np.ndarray, R: np.ndarray,
                    t: np.ndarray) -> np.ndarray:
    """x_cam = R @ (x_world - t)."""
    return (np.asarray(R) @ (np.asarray(points_world, np.float64) -
                             np.asarray(t)).T).T


def image_to_ground(pixels: np.ndarray, K: np.ndarray, R: np.ndarray,
                    cam_height: float) -> np.ndarray:
    """Lift image pixels to the ground plane (y_world = 0) assuming a
    camera at height `cam_height` with rotation R (cam->world). Returns
    (N, 2) ground (x lateral, z forward) in meters. Rays parallel to the
    ground produce inf."""
    Kinv = np.linalg.inv(np.asarray(K, np.float64))
    rays_cam = (Kinv @ np.c_[pixels, np.ones(len(pixels))].T).T
    rays = (np.asarray(R) @ rays_cam.T).T
    # camera convention: x right, y DOWN, z forward; the ground plane sits
    # cam_height below the camera, i.e. at y = +cam_height. Solve
    # s * ray_y = cam_height (s < 0 or inf => above the horizon).
    with np.errstate(divide="ignore", invalid="ignore"):
        s = cam_height / rays[:, 1]
    x = s * rays[:, 0]
    z = s * rays[:, 2]
    return np.stack([x, z], -1)


def ground_to_bev_pixels(ground_xz: np.ndarray,
                         bev_size: Tuple[int, int] = (640, 640),
                         bev_range_m: float = 40.0) -> np.ndarray:
    """Ground meters (x lateral, z forward) -> BEV pixels with the
    runtime's convention (vehicle at bottom center,
    main.cpp transformPixelsToMeters inverse)."""
    h, w = bev_size
    scale = h / bev_range_m
    px = ground_xz[:, 0] * scale + w / 2.0
    py = h - ground_xz[:, 1] * scale
    return np.stack([px, py], -1)
