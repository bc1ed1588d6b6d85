"""The port of autoware_vision_pilot_tpu/data_parsing/depth_datasets.py.

Stereo/LiDAR depth dataset parsers: DrivingStereo, Argoverse, DDAD.

Reference roles:
- Models/data_parsing/Scene3D/DrivingStereo/process_driving_stereo.py
  (uint16 depth PNG / 256 -> meters; 40 px side crop)
- Models/data_parsing/Scene3D/Argoverse/process_argoverse.py
  (disparity PNG / 256 -> depth = f*B/d with B=0.2986 m, far cap 200 m;
  row crop 518:1750; per-log focal length from the calibration JSON)
- Models/data_parsing/Scene3D/DDAD/process_ddad.py
  (DGP-provided sparse LiDAR depth; crop (268, 200, 1668, 900))

All three share the same output contract: densify the sparse map with
lidar_depth_fill, derive a validity mask from non-zero depth BEFORE
filling, crop the region where GT exists, save image / depth .npy /
validity PNG in the unified layout.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, Tuple

import numpy as np

from .common import lidar_depth_fill

ARGOVERSE_BASELINE_M = 0.2986
ARGOVERSE_FAR_CAP_M = 200.0

# (left, top, right, bottom) crops of the GT-valid region
DRIVINGSTEREO_SIDE_CROP_PX = 40
ARGOVERSE_ROW_CROP = (518, 1750)
DDAD_CROP = (268, 200, 1668, 900)


def drivingstereo_depth_from_png(depth_u16: np.ndarray) -> np.ndarray:
    """DrivingStereo uint16 depth PNG -> float32 meters (value / 256)."""
    assert depth_u16.max() > 255, "expected 16-bit depth PNG"
    return depth_u16.astype(np.float32) / 256.0


def argoverse_depth_from_disparity(disp_u16: np.ndarray,
                                   focal_length_px: float,
                                   baseline_m: float = ARGOVERSE_BASELINE_M
                                   ) -> np.ndarray:
    """Argoverse uint16 disparity PNG -> float32 depth meters.

    depth = f * B / disparity; invalid (zero) disparity and depths beyond
    the 200 m cap become 0 (process_argoverse.py createDepthMap).
    """
    assert disp_u16.max() > 255, "expected 16-bit disparity PNG"
    d = disp_u16.astype(np.float32) / 256.0
    valid = d > 0
    depth = (focal_length_px * baseline_m) / (d + (1.0 - valid))
    depth = depth * valid
    depth[depth > ARGOVERSE_FAR_CAP_M] = 0
    return depth


def parse_argoverse_calib(calib_json: Dict,
                          camera: str = "image_raw_stereo_front_left_rect"
                          ) -> float:
    """Argoverse vehicle_calibration_info JSON -> focal_length_y_px of the
    rectified front-left stereo camera."""
    for cam in calib_json["camera_data_"]:
        if cam["key"] == camera:
            return float(cam["value"]["focal_length_y_px_"])
    raise KeyError(f"camera {camera!r} not in calibration")


def make_depth_sample(image: np.ndarray, sparse_depth: np.ndarray,
                      crop_ltrb: Tuple[int, int, int, int] | None = None
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(image, sparse depth) -> (image, dense depth, validity) cropped to
    the GT-valid region. Validity marks pixels with measured (pre-fill)
    depth coverage after densification, matching the reference (validity
    from the FILLED map's non-zeros)."""
    dense = lidar_depth_fill(sparse_depth)
    validity = (dense != 0).astype(np.uint8)
    if crop_ltrb is not None:
        l, t, r, b = crop_ltrb
        image = image[t:b, l:r]
        dense = dense[t:b, l:r]
        validity = validity[t:b, l:r]
    return image, dense, validity


def drivingstereo_sample(image: np.ndarray, depth_u16: np.ndarray):
    h, w = depth_u16.shape[:2]
    c = DRIVINGSTEREO_SIDE_CROP_PX
    return make_depth_sample(image, drivingstereo_depth_from_png(depth_u16),
                             (c, 0, w - c, h))


def argoverse_sample(image: np.ndarray, disp_u16: np.ndarray,
                     focal_length_px: float):
    h, w = disp_u16.shape[:2]
    t, b = ARGOVERSE_ROW_CROP
    return make_depth_sample(
        image, argoverse_depth_from_disparity(disp_u16, focal_length_px),
        (0, t, w, min(b, h)))


def ddad_sample(image: np.ndarray, sparse_depth: np.ndarray):
    return make_depth_sample(image, sparse_depth, DDAD_CROP)


def save_depth_sample(out_dir: str | Path, index: int, image_bgr: np.ndarray,
                      depth: np.ndarray, validity: np.ndarray):
    """Unified layout: image/N.png + depth/N.npy + validity/N.png."""
    import cv2
    out = Path(out_dir)
    for sub in ("image", "depth", "validity"):
        (out / sub).mkdir(parents=True, exist_ok=True)
    cv2.imwrite(str(out / "image" / f"{index}.png"), image_bgr)
    np.save(out / "depth" / f"{index}.npy", depth)
    cv2.imwrite(str(out / "validity" / f"{index}.png"), validity * 255)
