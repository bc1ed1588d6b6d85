"""The port of autoware_vision_pilot_tpu/data_parsing/comma2k19.py.

Comma2k19 drivable-path parser.

Reference role: Models/data_parsing/EgoLanes/Comma2k19/process_comma2k19.py
plus its utils/{camera,coordinates,orientation}.py — project the ego
vehicle's future ECEF trajectory into the camera image to auto-label a
drivable-path polyline, with the same acceptance filters (distance
horizon, ROI crop, monotonicity, bottom extrapolation, start/end x bands,
polygon-area cap).

All math is rebuilt vectorized: quaternion -> rotation, ECEF -> local
device frame, EON camera intrinsics, WGS84 geodetic <-> ECEF, NED local
frames. Formulas are the standard ones; constants (EON focal 910,
1164x874 full frame, ROI (62,84)+1048x524, thresholds) follow the
reference so converted labels match.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

# ---- EON camera model ------------------------------------------------------

FULL_FRAME_WH = (1164, 874)
EON_FOCAL = 910.0
EON_INTRINSICS = np.array([[EON_FOCAL, 0.0, FULL_FRAME_WH[0] / 2],
                           [0.0, EON_FOCAL, FULL_FRAME_WH[1] / 2],
                           [0.0, 0.0, 1.0]])

# device frame: x forward, y right, z down; view frame: x right, y down,
# z forward
VIEW_FROM_DEVICE = np.array([[0.0, 1.0, 0.0],
                             [0.0, 0.0, 1.0],
                             [1.0, 0.0, 0.0]])

# ROI crop applied to every frame before labeling
ROI_XY = (62, 84)
ROI_WH = (1048, 524)

DIST_HORIZON_M = 100.0       # future-path distance cap
FUTURE_FRAMES = 100          # frames that must remain in the segment
PATH_HEIGHT_M = 1.2          # camera height above the path
AREA_CAP_PX = 17000.0        # reject curvy/ambiguous paths


def quat_to_rot(q: np.ndarray) -> np.ndarray:
    """(..., 4) [w, x, y, z] unit quaternion(s) -> (..., 3, 3) rotation."""
    q = np.asarray(q, np.float64)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = np.empty(q.shape[:-1] + (3, 3))
    R[..., 0, 0] = w * w + x * x - y * y - z * z
    R[..., 0, 1] = 2 * (x * y - w * z)
    R[..., 0, 2] = 2 * (w * y + x * z)
    R[..., 1, 0] = 2 * (x * y + w * z)
    R[..., 1, 1] = w * w - x * x + y * y - z * z
    R[..., 1, 2] = 2 * (y * z - w * x)
    R[..., 2, 0] = 2 * (x * z - w * y)
    R[..., 2, 1] = 2 * (w * x + y * z)
    R[..., 2, 2] = w * w - x * x - y * y + z * z
    return R


def euler_to_quat(eulers: np.ndarray) -> np.ndarray:
    """(..., 3) [roll, pitch, yaw] -> (..., 4) [w, x, y, z], w >= 0."""
    e = np.asarray(eulers, np.float64)
    r, p, y = e[..., 0] / 2, e[..., 1] / 2, e[..., 2] / 2
    cr, sr, cp, sp, cy, sy = (np.cos(r), np.sin(r), np.cos(p), np.sin(p),
                              np.cos(y), np.sin(y))
    q = np.stack([cr * cp * cy + sr * sp * sy,
                  sr * cp * cy - cr * sp * sy,
                  cr * sp * cy + sr * cp * sy,
                  cr * cp * sy - sr * sp * cy], axis=-1)
    return np.where(q[..., :1] < 0, -q, q)


# ---- WGS84 geodetic <-> ECEF <-> NED --------------------------------------

_WGS_A = 6378137.0
_WGS_B = 6356752.3142
_WGS_ESQ = 6.69437999014e-3


def geodetic_to_ecef(geodetic: np.ndarray) -> np.ndarray:
    """(..., 3) [lat_deg, lon_deg, alt_m] -> ECEF meters."""
    g = np.asarray(geodetic, np.float64)
    lat = np.radians(g[..., 0])
    lon = np.radians(g[..., 1])
    alt = g[..., 2]
    xi = np.sqrt(1 - _WGS_ESQ * np.sin(lat) ** 2)
    x = (_WGS_A / xi + alt) * np.cos(lat) * np.cos(lon)
    y = (_WGS_A / xi + alt) * np.cos(lat) * np.sin(lon)
    z = (_WGS_A / xi * (1 - _WGS_ESQ) + alt) * np.sin(lat)
    return np.stack([x, y, z], axis=-1)


def ecef_to_geodetic(ecef: np.ndarray) -> np.ndarray:
    """ECEF meters -> (..., 3) [lat_deg, lon_deg, alt_m], Ferrari's
    closed-form solution (utils/coordinates.py ecef2geodetic)."""
    p = np.asarray(ecef, np.float64)
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    a, b, esq = _WGS_A, _WGS_B, _WGS_ESQ
    e1sq = 6.73949674228e-3
    r = np.sqrt(x * x + y * y)
    Esq = a * a - b * b
    F = 54 * b * b * z * z
    G = r * r + (1 - esq) * z * z - esq * Esq
    C = (esq * esq * F * r * r) / G ** 3
    S = np.cbrt(1 + C + np.sqrt(C * C + 2 * C))
    P = F / (3 * (S + 1 / S + 1) ** 2 * G * G)
    Q = np.sqrt(1 + 2 * esq * esq * P)
    r0 = (-(P * esq * r) / (1 + Q)
          + np.sqrt(0.5 * a * a * (1 + 1.0 / Q)
                    - P * (1 - esq) * z * z / (Q * (1 + Q))
                    - 0.5 * P * r * r))
    U = np.sqrt((r - esq * r0) ** 2 + z * z)
    V = np.sqrt((r - esq * r0) ** 2 + (1 - esq) * z * z)
    Z0 = b * b * z / (a * V)
    h = U * (1 - b * b / (a * V))
    lat = np.degrees(np.arctan((z + e1sq * Z0) / r))
    lon = np.degrees(np.arctan2(y, x))
    return np.stack([lat, lon, h], axis=-1)


def ned_matrix(lat_deg: float, lon_deg: float) -> np.ndarray:
    """NED->ECEF rotation at a geodetic anchor."""
    lat, lon = np.radians(lat_deg), np.radians(lon_deg)
    sl, cl, so, co = np.sin(lat), np.cos(lat), np.sin(lon), np.cos(lon)
    return np.array([[-sl * co, -so, -cl * co],
                     [-sl * so, co, -cl * so],
                     [cl, 0.0, -sl]])


class LocalCoord:
    """Local NED frame anchored at a geodetic/ECEF origin
    (utils/coordinates.py LocalCoord)."""

    def __init__(self, init_geodetic):
        g = np.asarray(init_geodetic, np.float64)
        self.init_ecef = geodetic_to_ecef(g)
        self.ned2ecef_matrix = ned_matrix(g[0], g[1])
        self.ecef2ned_matrix = self.ned2ecef_matrix.T

    @classmethod
    def from_geodetic(cls, init_geodetic):
        return cls(init_geodetic)

    @classmethod
    def from_ecef(cls, init_ecef):
        return cls(ecef_to_geodetic(init_ecef))

    def ecef_to_ned(self, ecef):
        rel = np.asarray(ecef, np.float64) - self.init_ecef
        return rel @ self.ecef2ned_matrix.T

    def ned_to_ecef(self, ned):
        return np.asarray(ned, np.float64) @ self.ned2ecef_matrix.T + \
            self.init_ecef

    def geodetic_to_ned(self, geodetic):
        return self.ecef_to_ned(geodetic_to_ecef(geodetic))

    def ned_to_geodetic(self, ned):
        return ecef_to_geodetic(self.ned_to_ecef(ned))


def quat_to_euler(q: np.ndarray) -> np.ndarray:
    """(..., 4) [w, x, y, z] -> (..., 3) [roll, pitch, yaw]
    (utils/orientation.py quat2euler)."""
    q = np.asarray(q, np.float64)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    roll = np.arctan2(2 * (w * x + y * z), w * w - x * x - y * y + z * z)
    pitch = np.arcsin(np.clip(2 * (w * y - z * x), -1.0, 1.0))
    yaw = np.arctan2(2 * (w * z + x * y), w * w + x * x - y * y - z * z)
    return np.stack([roll, pitch, yaw], axis=-1)


# ---- trajectory -> image labeling ------------------------------------------

def local_path(frame_idx: int, positions_ecef: np.ndarray,
               orientations_quat: np.ndarray,
               horizon_m: float = DIST_HORIZON_M) -> np.ndarray:
    """Future ego positions in the devices's local frame at frame_idx,
    truncated at the distance horizon (get_frame_positions_local role)."""
    R = quat_to_rot(orientations_quat[frame_idx])       # ecef<-device
    rel = positions_ecef[frame_idx:] - positions_ecef[frame_idx]
    local = rel @ R                                      # == R.T @ rel^T
    dist = np.linalg.norm(rel, axis=1)
    end = len(dist)
    beyond = np.nonzero(dist > horizon_m)[0]
    if len(beyond):
        end = int(beyond[0])
    return local[:end]


def project_to_image(pt_device: np.ndarray) -> np.ndarray:
    """(N, 3) device-frame pts -> (N, 2) full-frame pixels; NaN where the
    point is behind the camera or off-frame (img_from_device+denormalize)."""
    pt_view = pt_device @ VIEW_FROM_DEVICE.T
    pt_view = np.where(pt_view[:, 2:3] < 0, np.nan, pt_view)
    with np.errstate(divide="ignore", invalid="ignore"):
        norm = pt_view[:, :2] / pt_view[:, 2:3]
    pix = norm * EON_FOCAL + np.array(
        [FULL_FRAME_WH[0] / 2, FULL_FRAME_WH[1] / 2])
    w, h = FULL_FRAME_WH
    off = (pix[:, 0] < 0) | (pix[:, 0] > w) | (pix[:, 1] < 0) | \
        (pix[:, 1] > h)
    return np.where(off[:, None], np.nan, pix)


def _polygon_area(x: np.ndarray, y: np.ndarray, img_h: int) -> float:
    if len(x) < 3:
        return 10000.0
    x = np.append(x, x[-1])
    y = np.append(y, img_h)
    corr = x[-1] * y[0] - y[-1] * x[0]
    main = np.dot(x[:-1], y[1:]) - np.dot(y[:-1], x[1:])
    return 0.5 * abs(main + corr)


def _extrapolate_to_bottom(pts: np.ndarray, img_h: int) -> np.ndarray:
    """Extend the polyline to touch the image bottom (reference
    extrapolate_to_bottom)."""
    below = np.nonzero(pts[:, 1] > img_h)[0]
    if len(below):
        idx = int(below.max())
        if idx >= 1:
            x1, y1 = pts[idx - 1]
            x2, y2 = pts[idx]
            if y2 != y1:
                x = int(x1 + (x2 - x1) * (img_h - y1) / (y2 - y1))
                return np.vstack(([x, img_h], pts[idx:]))
    x1, y1 = pts[0]
    x2, y2 = pts[1]
    if x2 == x1 or y1 == y2:
        x = x1
    else:
        slope = (y2 - y1) / (x2 - x1)
        x = int((img_h - (y1 - slope * x1)) / slope)
    return np.vstack(([x, img_h], pts))


def drivable_path_points(frame_idx: int, positions_ecef: np.ndarray,
                         orientations_quat: np.ndarray,
                         height: float = PATH_HEIGHT_M
                         ) -> Optional[np.ndarray]:
    """One frame -> (N, 2) ROI-space drivable-path polyline, or None when
    the sample fails the reference's acceptance filters."""
    x_off, y_off = ROI_XY
    img_w, img_h = ROI_WH
    device_path = local_path(frame_idx, positions_ecef, orientations_quat)
    device_path = device_path + np.array([0.0, 0.0, height])
    pix = project_to_image(device_path)
    pix = pix[np.isfinite(pix).all(axis=1)].astype(int)
    if len(pix) == 0:
        return None
    # stable unique
    pix = pix[np.sort(np.unique(pix, axis=0, return_index=True)[1])]
    pix = pix - [x_off, y_off]
    keep = (pix[:, 0] >= 0) & (pix[:, 0] < img_w) & (pix[:, 1] >= 0)
    pix = pix[keep]
    if len(pix) < 5:
        return None
    # reject near-horizontal pile-ups / points above the horizon band
    _, counts = np.unique(pix[pix[:, 1].argsort()][:, 1],
                          return_counts=True)
    if np.any(counts > 50) or np.any(pix[:, 1] < 200):
        return None
    pix = _extrapolate_to_bottom(pix, img_h)
    if pix[0][0] < 250 or pix[0][0] > 750 or \
            pix[-1][0] < 150 or pix[-1][0] > 950:
        return None
    if _polygon_area(pix[:, 0].astype(float), pix[:, 1].astype(float),
                     img_h) > AREA_CAP_PX:
        return None
    return pix


def rasterize_drivable_path(pts: np.ndarray,
                            image_hw: Tuple[int, int] = (524, 1048),
                            thickness: int = 3) -> np.ndarray:
    """(N, 2) polyline -> (H, W) uint8 {0,255} mask."""
    import cv2
    mask = np.zeros(image_hw, np.uint8)
    cv2.polylines(mask, [np.asarray(pts, np.int32).reshape(-1, 1, 2)],
                  False, 255, thickness)
    return mask


def normalize_path(pts: np.ndarray,
                   image_wh: Tuple[int, int] = ROI_WH) -> list:
    """Polyline -> [0,1]-normalized [[x, y]...] (the drivable_path.json
    payload)."""
    w, h = image_wh
    return [[float(x) / w, float(y) / h] for x, y in np.asarray(pts)]
