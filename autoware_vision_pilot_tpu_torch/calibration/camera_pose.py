"""Camera pose standardization ("standard pose" protocol), a copy of
autoware_vision_pilot_tpu/calibration/camera_pose.py for the port (which
imports nothing of the JAX package).

Rebuild of VisionPilot/calibration/calibration.py: undistort with camera
intrinsics -> rotation homography H = K R K^-1 from the mounting Euler
angles -> optional height compression -> warp, so every camera feed
matches the pose the models were trained for
(calibration/README.md:63-75).
"""
from __future__ import annotations

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


def get_rotation_matrix(pitch_deg: float, yaw_deg: float,
                        roll_deg: float) -> np.ndarray:
    """Euler angles (deg) -> 3x3 rotation via the Rodrigues vector, same
    convention as the reference (calibration.py:16-45)."""
    rot_vector = np.radians([pitch_deg, yaw_deg, roll_deg]).astype(np.float64)
    R, _ = cv2.Rodrigues(rot_vector)
    return R


def undistort_image(image: np.ndarray, intrinsic_matrix: np.ndarray,
                    distortion_coeffs: np.ndarray) -> np.ndarray:
    return cv2.undistort(image, np.asarray(intrinsic_matrix, np.float64),
                         np.asarray(distortion_coeffs, np.float64))


def rotation_homography(K: np.ndarray, R: np.ndarray) -> np.ndarray:
    """Pure-rotation perspective warp H = K R K^-1."""
    K = np.asarray(K, np.float64)
    return K @ np.asarray(R, np.float64) @ np.linalg.inv(K)


def standardize_pose(image: np.ndarray, K: np.ndarray,
                     distortion_coeffs: np.ndarray,
                     pitch_deg: float = 0.0, yaw_deg: float = 0.0,
                     roll_deg: float = 0.0,
                     height_scale: float = 1.0) -> np.ndarray:
    """Full protocol: undistort -> rotate to standard pose -> optional
    vertical (height) compression -> warp."""
    img = undistort_image(image, K, distortion_coeffs)
    H = rotation_homography(K, get_rotation_matrix(pitch_deg, yaw_deg,
                                                   roll_deg))
    if height_scale != 1.0:
        S = np.diag([1.0, height_scale, 1.0])
        H = S @ H
    h, w = img.shape[:2]
    return cv2.warpPerspective(img, H, (w, h))
