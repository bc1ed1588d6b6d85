"""Ground-plane homography estimation (image px -> world meters), a copy
of autoware_vision_pilot_tpu/calibration/homography.py for the port (which
imports nothing of the JAX package).

Rebuild of middleware_recipes/Calibration/compute_homography.py: DLT
least-squares homography from >=4 image/world correspondences (e.g.
LiDAR-projected ground points), consistency check against ground truth,
YAML save/load in the format ObjectFinder consumes
(object_finder.cpp:27-52: flat list or {rows, cols, data}).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import yaml


def compute_homography(image_pts: np.ndarray,
                       world_pts: np.ndarray) -> np.ndarray:
    """DLT: image (N,2) px -> world (N,2) m, N >= 4. Normalized for
    conditioning; H scaled so H[2,2] = 1."""
    src = np.asarray(image_pts, np.float64)
    dst = np.asarray(world_pts, np.float64)
    n = len(src)
    if n < 4:
        raise ValueError("need at least 4 correspondences")

    def norm_T(p):
        c = p.mean(0)
        s = np.sqrt(2) / max(np.mean(np.linalg.norm(p - c, axis=1)), 1e-12)
        return np.array([[s, 0, -s * c[0]], [0, s, -s * c[1]], [0, 0, 1]])

    Ts, Td = norm_T(src), norm_T(dst)
    sh = (Ts @ np.c_[src, np.ones(n)].T).T
    dh = (Td @ np.c_[dst, np.ones(n)].T).T

    A = []
    for (x, y, _), (u, v, _) in zip(sh, dh):
        A.append([-x, -y, -1, 0, 0, 0, u * x, u * y, u])
        A.append([0, 0, 0, -x, -y, -1, v * x, v * y, v])
    _, _, Vt = np.linalg.svd(np.asarray(A))
    Hn = Vt[-1].reshape(3, 3)
    H = np.linalg.inv(Td) @ Hn @ Ts
    return H / H[2, 2]


def compute_homography_ransac(image_pts: np.ndarray,
                              world_pts: np.ndarray,
                              threshold: float = 5.0,
                              max_iters: int = 2000,
                              confidence: float = 0.995,
                              seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """RANSAC-robust homography, the analog of the reference's
    ``cv2.findHomography(src, dst, cv2.RANSAC, 5.0)``
    (middleware_recipes/Calibration/compute_homography.py:102): one bad
    LiDAR/keypoint correspondence must not ruin H.

    Minimal 4-point DLT hypotheses; a point is an inlier when its
    transfer error ``||dst - H src||`` in destination units is below
    `threshold` (OpenCV's convention). Adaptive iteration count from the
    running inlier ratio, then a final DLT refit on all inliers.

    Returns (H, inlier_mask[bool (N,)]).
    """
    src = np.asarray(image_pts, np.float64)
    dst = np.asarray(world_pts, np.float64)
    n = len(src)
    if n < 4:
        raise ValueError("need at least 4 correspondences")
    rng = np.random.default_rng(seed)

    best_mask = None
    best_count = -1
    best_err = np.inf
    iters = max_iters
    it = 0
    while it < iters:
        it += 1
        idx = rng.choice(n, 4, replace=False)
        try:
            H = compute_homography(src[idx], dst[idx])
        except np.linalg.LinAlgError:
            continue
        if not np.all(np.isfinite(H)):
            continue
        err = np.linalg.norm(apply_homography(H, src) - dst, axis=1)
        mask = err < threshold
        count = int(mask.sum())
        mean_err = float(err[mask].mean()) if count else np.inf
        if count > best_count or (count == best_count and mean_err < best_err):
            best_count, best_mask, best_err = count, mask, mean_err
            w = max(count / n, 1e-9)  # inlier ratio -> adaptive stop
            denom = np.log(max(1.0 - w ** 4, 1e-12))
            iters = min(max_iters,
                        int(np.ceil(np.log(1.0 - confidence) / denom)))
    if best_mask is None or best_count < 4:
        raise ValueError("RANSAC failed: no non-degenerate hypothesis "
                         "reached 4 inliers")
    H = compute_homography(src[best_mask], dst[best_mask])
    return H, best_mask


def apply_homography(H: np.ndarray, pts: np.ndarray) -> np.ndarray:
    p = np.c_[np.asarray(pts, np.float64), np.ones(len(pts))] @ H.T
    return p[:, :2] / p[:, 2:]


def homography_reprojection_error(H: np.ndarray, image_pts: np.ndarray,
                                  world_pts: np.ndarray) -> float:
    """Mean Euclidean error in world units (the test_with_gt.py check)."""
    proj = apply_homography(H, image_pts)
    return float(np.mean(np.linalg.norm(proj - np.asarray(world_pts),
                                        axis=1)))


def save_homography_yaml(H: np.ndarray, path: str | Path):
    data = {"H": {"rows": 3, "cols": 3,
                  "data": [float(v) for v in np.asarray(H).reshape(-1)]}}
    Path(path).write_text(yaml.safe_dump(data))


def load_homography_yaml(path: str | Path) -> np.ndarray:
    node = yaml.safe_load(Path(path).read_text())["H"]
    data = node if isinstance(node, list) else node["data"]
    return np.asarray(data, np.float64).reshape(3, 3)
