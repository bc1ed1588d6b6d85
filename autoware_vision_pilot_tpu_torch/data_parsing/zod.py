"""The port of autoware_vision_pilot_tpu/data_parsing/zod.py.

ZOD (Zenseact Open Dataset) AutoDrive auto-labeling pipeline.

Reference role: Models/data_parsing/AutoDrive/zod/ — associate camera
frames with radar (16 Hz) and vehicle-control (100 Hz) streams by
timestamp, derive the driven-path curvature from the steering wheel via
the Ackermann bicycle model (Volvo XC90 geometry), cluster radar returns,
and pick the CIPO (closest in-path object) whose azimuth lies on the
curvature arc. The accepted (distance, curvature, cipo-present) triple
becomes the AutoDrive training label (d_norm, curvature, flag).

The math here is rebuilt vectorized (numpy); the DBSCAN clustering is a
small self-contained implementation over the same polar-velocity metric
so the parser has no sklearn dependency.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

# Volvo XC90 (the ZOD collection vehicle) steering geometry
STEERING_COLUMN_RATIO = 16.8     # steering-wheel deg per tyre deg
WHEELBASE_M = 2.984
MAX_RANGE_M = 200.0              # radar usable range
MODEL_WH = (1024, 512)           # AutoSpeed input (50-deg center crop)


def curvature_from_steering(steering_wheel_rad: float) -> float:
    """Ackermann bicycle model: tyre = wheel/ratio,
    curvature = tan(tyre)/wheelbase (step1_timestamp_association.py:68-76).
    """
    tyre = steering_wheel_rad / STEERING_COLUMN_RATIO
    return float(np.tan(tyre) / WHEELBASE_M)


def find_closest_idx(query_ts: int, ref_ts: np.ndarray) -> int:
    """Nearest-timestamp association (camera <- radar/vehicle streams)."""
    return int(np.argmin(np.abs(ref_ts.astype(np.int64) - int(query_ts))))


def radar_spherical_to_cartesian(azimuth: np.ndarray, elevation: np.ndarray,
                                 rng: np.ndarray
                                 ) -> Tuple[np.ndarray, ...]:
    """ZOD radar frame: X forward, Y left, Z up; angles in radians."""
    az = np.asarray(azimuth, np.float64)
    el = np.asarray(elevation, np.float64)
    rg = np.asarray(rng, np.float64)
    return (rg * np.cos(el) * np.cos(az),
            rg * np.cos(el) * np.sin(az),
            rg * np.sin(el))


def path_azimuth_at_range(curvature_inv_m: float, range_m: float) -> float:
    """Azimuth (rad) of the constant-curvature arc at a given range:
    chord geometry theta = 2*arcsin(r/(2R)), az = atan2(y, x) — NOT the
    small-angle k*r (run_cipo_radar.py:228-244)."""
    k = curvature_inv_m
    if abs(k) < 1e-9:
        return 0.0
    R = 1.0 / k
    r = min(range_m, 2 * abs(R) - 1e-6)
    theta = 2 * np.arcsin(r / (2 * R))
    x = R * np.sin(theta)
    y = R * (1 - np.cos(theta))
    return float(np.arctan2(y, x))


def pixel_to_h_angle_deg(u: float, width: float, hfov_deg: float) -> float:
    """Horizontal angle from the optical axis, linear in pixels."""
    return ((u - width / 2) / (width / 2)) * (hfov_deg / 2)


def center_crop_50deg(image_wh: Tuple[int, int], hfov_deg: float,
                      target_fov: float = 50.0) -> Dict[str, float]:
    """Crop window for the 50-deg-HFOV 2:1 model view -> crop_info dict
    (center_crop_50deg_resize geometry; resize itself is the caller's)."""
    img_w, img_h = image_wh
    cw = int(round(img_w * target_fov / hfov_deg))
    ch = cw // 2
    return {
        "crop_x": (img_w - cw) // 2,
        "crop_y": (img_h - ch) // 2,
        "orig_crop_w": cw, "orig_crop_h": ch,
        "model_w": MODEL_WH[0], "model_h": MODEL_WH[1],
        "fov_deg": target_fov,
    }


def pixel_to_h_angle_deg_50(u_model: float, crop_info: Dict) -> float:
    """bbox-center x in model pixels -> angle in the 50-deg window."""
    cw = crop_info["orig_crop_w"]
    u_crop = (u_model / crop_info["model_w"]) * cw
    return ((u_crop - cw / 2) / (cw / 2)) * (crop_info["fov_deg"] / 2)


def bbox_crop_to_full(box, crop_info: Dict) -> Tuple[float, ...]:
    """Model-space bbox -> full-frame pixels."""
    sx = crop_info["orig_crop_w"] / crop_info["model_w"]
    sy = crop_info["orig_crop_h"] / crop_info["model_h"]
    cx, cy = crop_info["crop_x"], crop_info["crop_y"]
    x1, y1, x2, y2 = box
    return (x1 * sx + cx, y1 * sy + cy, x2 * sx + cx, y2 * sy + cy)


# ---- radar clustering -------------------------------------------------------

def _polar_vel_features(x: np.ndarray, y: np.ndarray, v: np.ndarray,
                        range_scale: float, lat_buffer: float,
                        vel_scale: float) -> np.ndarray:
    """Feature space for clustering: scaled range, lateral offset,
    radial velocity."""
    rg = np.hypot(x, y)
    return np.stack([rg / range_scale, y / lat_buffer, v / vel_scale], -1)


def cluster_radar_points(x: np.ndarray, y: np.ndarray, z: np.ndarray,
                         vel: np.ndarray, z_min: float = -0.5,
                         z_max: float = 1.0, range_scale: float = 4.0,
                         lat_buffer: float = 0.5, vel_scale: float = 1.5,
                         eps: float = 1.0, min_samples: int = 2,
                         max_range_m: float = MAX_RANGE_M) -> List[Dict]:
    """DBSCAN over the polar-velocity feature space -> cluster summaries
    [{range, azimuth, lateral, velocity, n}] sorted by range
    (get_radar_clusters role)."""
    x, y, z, vel = (np.asarray(a, np.float64) for a in (x, y, z, vel))
    keep = (z > z_min) & (z < z_max) & (np.hypot(x, y) < max_range_m)
    x, y, vel = x[keep], y[keep], vel[keep]
    if len(x) == 0:
        return []
    feats = _polar_vel_features(x, y, vel, range_scale, lat_buffer,
                                vel_scale)
    labels = _dbscan(feats, eps, min_samples)
    out = []
    for lbl in set(labels.tolist()):
        if lbl < 0:
            continue
        m = labels == lbl
        cx, cy, cv = x[m].mean(), y[m].mean(), vel[m].mean()
        out.append({"range": float(np.hypot(cx, cy)),
                    "azimuth": float(np.arctan2(cy, cx)),
                    "lateral": float(cy), "velocity": float(cv),
                    "n": int(m.sum())})
    return sorted(out, key=lambda c: c["range"])


def _dbscan(X: np.ndarray, eps: float, min_samples: int) -> np.ndarray:
    """Minimal exact DBSCAN (euclidean), O(N^2) — radar frames hold a few
    hundred points, so this stays trivial."""
    n = len(X)
    d2 = np.sum((X[:, None] - X[None]) ** 2, -1)
    neigh = d2 <= eps * eps
    counts = neigh.sum(1)
    core = counts >= min_samples
    labels = np.full(n, -1, int)
    cid = 0
    for i in range(n):
        if labels[i] != -1 or not core[i]:
            continue
        # BFS expand
        stack = [i]
        labels[i] = cid
        while stack:
            j = stack.pop()
            if not core[j]:
                continue
            for k in np.nonzero(neigh[j])[0]:
                if labels[k] == -1:
                    labels[k] = cid
                    stack.append(k)
        cid += 1
    return labels


def find_cipo_on_path(clusters: List[Dict], curvature_inv_m: float,
                      lat_buffer_m: float = 1.0,
                      max_range_m: float = MAX_RANGE_M) -> Optional[Dict]:
    """Nearest cluster whose lateral offset from the curvature arc at its
    range is within the buffer (find_nearest_cluster_on_path role)."""
    best = None
    for c in clusters:
        if c["range"] > max_range_m:
            continue
        az_path = path_azimuth_at_range(curvature_inv_m, c["range"])
        lat_off = abs(c["range"] * np.sin(c["azimuth"] - az_path))
        if lat_off <= lat_buffer_m and (
                best is None or c["range"] < best["range"]):
            best = c
    return best


def make_autodrive_label(cipo: Optional[Dict], curvature_inv_m: float,
                         max_range_m: float = MAX_RANGE_M) -> Dict:
    """The AutoDrive training triple: normalized CIPO distance, path
    curvature, CIPO-present flag (auto_drive_trainer.py d_norm/flag)."""
    if cipo is None:
        return {"d_norm": 0.0, "curvature": float(curvature_inv_m),
                "flag": 0}
    return {"d_norm": float(min(cipo["range"], max_range_m) / max_range_m),
            "curvature": float(curvature_inv_m), "flag": 1}
