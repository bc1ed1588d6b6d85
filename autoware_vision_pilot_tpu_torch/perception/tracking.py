"""Multi-object tracking with CIPO selection (closest in-path object).

Rebuild of production_release/src/tracking/* (object_finder.cpp 438 LoC,
kalman_filter.cpp, tracking_utils.cpp, cipo_utils.cpp, cipo_history.cpp,
feature_matching_utils.cpp). Behavior preserved:

- greedy data association scored 0.5*IoU + 0.3*centroid + 0.2*size with
  threshold 0.55 (tracking_utils.cpp:80-86, object_finder.cpp:18)
- homography image->world on the bbox bottom-center, Euclidean distance
- per-track 1D constant-velocity Kalman (predict/update on match; tracks
  survive 3 unmatched frames)
- CIPO = closest class-1/class-2 track (level 1 wins ties,
  cipo_utils.cpp:25-41); 30-frame snapshot history
- on CIPO track change: ORB feature match between crops (Lowe 0.75,
  confidence = matches/avg_keypoints >= 0.3) -> same vehicle (transfer
  Kalman) vs cut-in (reset Kalman, flag for the longitudinal PID)

This module runs on host, in numpy: the object count is tiny (<10 tracks)
and the logic is branch-heavy scalar state machine work. The heavy upstream
(detector + NMS) runs on the card. It is the port's own copy of
autoware_vision_pilot_tpu/perception/tracking.py, whose package imports
JAX; cv2 stays optional as there (without it the ORB gate says False).
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import List, Optional, Tuple

import numpy as np

try:
    import cv2
    _HAS_CV2 = True
except ImportError:  # pragma: no cover
    _HAS_CV2 = False

MATCHING_THRESHOLD = 0.55
MAX_FRAMES_UNMATCHED = 3
FEATURE_MATCH_THRESHOLD = 0.3
LOWE_RATIO = 0.75
CIPO_HISTORY = 30


class KalmanFilter1D:
    """1D constant-velocity Kalman (kalman_filter.cpp)."""

    def __init__(self, q_pos=1.0, q_vel=1.0, r=1.0):
        self.q_pos, self.q_vel, self.r = q_pos, q_vel, r
        self.reset()

    def reset(self):
        self.x = np.zeros(2, np.float64)
        self.P = np.diag([1000.0, 1000.0])
        self.initialized = False

    def initialize(self, position: float):
        self.x = np.array([position, 0.0])
        self.P = np.diag([10.0, 100.0])
        self.initialized = True

    def predict(self, dt: float):
        if not self.initialized:
            return
        F = np.array([[1.0, dt], [0.0, 1.0]])
        self.x = F @ self.x
        self.P = F @ self.P @ F.T + np.diag([self.q_pos, self.q_vel])

    def update(self, z: float):
        if not self.initialized:
            self.initialize(z)
            return
        innovation = z - self.x[0]
        S = self.P[0, 0] + self.r
        K = self.P[:, 0] / S
        self.x = self.x + K * innovation
        I_KH = np.eye(2) - np.outer(K, [1.0, 0.0])
        self.P = I_KH @ self.P

    @property
    def position(self):
        return float(self.x[0])

    @property
    def velocity(self):
        return float(self.x[1])

    def copy(self):
        k = KalmanFilter1D(self.q_pos, self.q_vel, self.r)
        k.x = self.x.copy()
        k.P = self.P.copy()
        k.initialized = self.initialized
        return k


def iou(a, b) -> float:
    """boxes as (x, y, w, h) ints."""
    x1 = max(a[0], b[0])
    y1 = max(a[1], b[1])
    x2 = min(a[0] + a[2], b[0] + b[2])
    y2 = min(a[1] + a[3], b[1] + b[3])
    inter = max(0, x2 - x1) * max(0, y2 - y1)
    union = a[2] * a[3] + b[2] * b[3] - inter
    return inter / union if union > 0 else 0.0


def matching_score(det_bbox, track_bbox, img_w, img_h) -> float:
    i = iou(det_bbox, track_bbox)
    ca = (det_bbox[0] + det_bbox[2] / 2.0, det_bbox[1] + det_bbox[3] / 2.0)
    cb = (track_bbox[0] + track_bbox[2] / 2.0, track_bbox[1] + track_bbox[3] / 2.0)
    dist = math.hypot(ca[0] - cb[0], ca[1] - cb[1])
    max_dist = math.hypot(img_w, img_h)
    norm_dist = 1.0 - min(dist / max_dist, 1.0)
    area_a, area_b = det_bbox[2] * det_bbox[3], track_bbox[2] * track_bbox[3]
    size_sim = (min(area_a, area_b) / max(area_a, area_b)
                if area_a and area_b else 0.0)
    return 0.5 * i + 0.3 * norm_dist + 0.2 * size_sim


@dataclasses.dataclass
class TrackedObject:
    track_id: int
    class_id: int
    bbox: Tuple[int, int, int, int]
    confidence: float
    distance_m: float = 0.0
    velocity_ms: float = 0.0
    frames_tracked: int = 1
    frames_unmatched: int = 0
    last_update_time: float = 0.0
    kalman: KalmanFilter1D = dataclasses.field(default_factory=KalmanFilter1D)


@dataclasses.dataclass
class CIPOInfo:
    exists: bool = False
    track_id: int = -1
    class_id: int = -1
    distance_m: float = 0.0
    velocity_ms: float = 0.0


@dataclasses.dataclass
class CIPOSnapshot:
    track_id: int
    class_id: int
    bbox: Tuple[int, int, int, int]
    distance_m: float
    velocity_ms: float
    frame_crop: Optional[np.ndarray]


@dataclasses.dataclass
class TrackingResult:
    tracked_objects: List[TrackedObject]
    cipo: CIPOInfo
    cut_in_detected: bool = False
    kalman_reset: bool = False


def extract_safe_crop(frame: np.ndarray, bbox) -> Optional[np.ndarray]:
    x, y, w, h = bbox
    H, W = frame.shape[:2]
    x0, y0 = max(0, x), max(0, y)
    x1, y1 = min(W, x + w), min(H, y + h)
    if x1 <= x0 or y1 <= y0:
        return None
    return frame[y0:y1, x0:x1].copy()


def orb_same_object(crop1, crop2, threshold=FEATURE_MATCH_THRESHOLD) -> bool:
    """ORB keypoints + Hamming BF knn + Lowe ratio; confidence =
    matches / avg keypoints (feature_matching_utils.cpp:75-153)."""
    if not _HAS_CV2 or crop1 is None or crop2 is None:
        return False
    orb = cv2.ORB_create(nfeatures=500)
    k1, d1 = orb.detectAndCompute(crop1, None)
    k2, d2 = orb.detectAndCompute(crop2, None)
    if d1 is None or d2 is None or len(k1) == 0 or len(k2) == 0:
        return False
    matcher = cv2.BFMatcher(cv2.NORM_HAMMING, crossCheck=False)
    try:
        knn = matcher.knnMatch(d1, d2, k=2)
    except cv2.error:
        return False
    good = [m[0] for m in knn
            if len(m) >= 2 and m[0].distance < LOWE_RATIO * m[1].distance]
    avg_kp = (len(k1) + len(k2)) / 2.0
    confidence = min(len(good) / avg_kp, 1.0) if avg_kp else 0.0
    return confidence >= threshold


class ObjectFinder:
    """Tracker + CIPO state machine (object_finder.cpp)."""

    TRACKABLE_CLASSES = (1, 2)

    def __init__(self, homography: np.ndarray, image_width: int,
                 image_height: int, clock=time.monotonic):
        self.H = np.asarray(homography, np.float64).reshape(3, 3)
        self.image_width = image_width
        self.image_height = image_height
        self.clock = clock
        self.next_track_id = 0
        self.tracks: List[TrackedObject] = []
        self.cipo_history: List[CIPOSnapshot] = []
        self.cut_in_detected = False
        self.kalman_reset = False

    def image_to_world(self, pt) -> Tuple[float, float]:
        v = self.H @ np.array([pt[0], pt[1], 1.0])
        return (v[0] / v[2], v[1] / v[2])

    def _associate(self, detections) -> List[Tuple[int, int]]:
        """detections: list of (x1, y1, x2, y2, conf, class_id)."""
        associations = []
        track_matched = [False] * len(self.tracks)
        for di, det in enumerate(detections):
            cls = int(det[5])
            if cls not in self.TRACKABLE_CLASSES:
                continue
            det_bbox = (int(det[0]), int(det[1]),
                        int(det[2] - det[0]), int(det[3] - det[1]))
            best, best_score = -1, 0.0
            for ti, tr in enumerate(self.tracks):
                if track_matched[ti] or tr.class_id != cls:
                    continue
                s = matching_score(det_bbox, tr.bbox,
                                   self.image_width, self.image_height)
                if s > MATCHING_THRESHOLD and s > best_score:
                    best, best_score = ti, s
            if best >= 0:
                track_matched[best] = True
            associations.append((di, best))
        return associations

    def update(self, detections, frame=None) -> List[TrackedObject]:
        now = self.clock()
        new_tracks: List[TrackedObject] = []
        associations = self._associate(detections)
        matched_tracks = {t for _, t in associations if t >= 0}

        for di, ti in associations:
            det = detections[di]
            bbox = (int(det[0]), int(det[1]),
                    int(det[2] - det[0]), int(det[3] - det[1]))
            bottom_center = (bbox[0] + bbox[2] / 2.0, bbox[1] + bbox[3])
            wx, wy = self.image_to_world(bottom_center)
            measured = math.hypot(wx, wy)

            if ti >= 0:
                obj = self.tracks[ti]
                obj.frames_tracked += 1
                obj.frames_unmatched = 0
                dt = now - obj.last_update_time
                obj.kalman.predict(dt)
                obj.kalman.update(measured)
                obj.distance_m = obj.kalman.position
                obj.velocity_ms = obj.kalman.velocity
            else:
                obj = TrackedObject(
                    track_id=self.next_track_id, class_id=int(det[5]),
                    bbox=bbox, confidence=float(det[4]))
                self.next_track_id += 1
                obj.kalman.initialize(measured)
                obj.distance_m = measured
                obj.velocity_ms = 0.0
            obj.bbox = bbox
            obj.confidence = float(det[4])
            obj.last_update_time = now
            new_tracks.append(obj)

        for ti, tr in enumerate(self.tracks):
            if ti in matched_tracks:
                continue
            tr.frames_unmatched += 1
            if tr.frames_unmatched <= MAX_FRAMES_UNMATCHED:
                new_tracks.append(tr)

        self.prev_tracks = list(self.tracks)
        self.tracks = new_tracks
        return self.tracks

    def get_cipo(self, frame=None) -> CIPOInfo:
        cipo = CIPOInfo()
        self.cut_in_detected = False
        self.kalman_reset = False

        def closest(level):
            best, best_d = -1, math.inf
            for i, t in enumerate(self.tracks):
                if t.class_id == level and 0 < t.distance_m < best_d:
                    best, best_d = i, t.distance_m
            return best

        i1, i2 = closest(1), closest(2)
        if i1 < 0 and i2 < 0:
            return cipo
        if i1 < 0:
            main_idx = i2
        elif i2 < 0:
            main_idx = i1
        else:
            main_idx = i1 if (self.tracks[i1].distance_m
                              <= self.tracks[i2].distance_m) else i2

        main = self.tracks[main_idx]
        cipo.exists = True
        cipo.track_id = main.track_id
        cipo.class_id = main.class_id
        cipo.distance_m = main.distance_m

        crop = (extract_safe_crop(frame, main.bbox)
                if frame is not None else None)
        snap = CIPOSnapshot(main.track_id, main.class_id, main.bbox,
                            main.distance_m, main.velocity_ms, crop)
        self.cipo_history.append(snap)
        if len(self.cipo_history) > CIPO_HISTORY:
            self.cipo_history.pop(0)

        changed = (len(self.cipo_history) >= 2 and
                   self.cipo_history[-2].track_id != snap.track_id)
        if not changed:
            cipo.velocity_ms = main.velocity_ms
            return cipo

        prev_snap = self.cipo_history[-2]
        if prev_snap.frame_crop is None or snap.frame_crop is None:
            cipo.velocity_ms = main.velocity_ms
            return cipo

        if orb_same_object(prev_snap.frame_crop, snap.frame_crop):
            # model confusion (Level 1 <-> 2): carry Kalman state over
            for prev_obj in getattr(self, "prev_tracks", []):
                if prev_obj.track_id == prev_snap.track_id:
                    main.kalman = prev_obj.kalman.copy()
                    break
        else:
            # real cut-in: reset the filter, flag downstream
            self.cut_in_detected = True
            self.kalman_reset = True
            main.kalman.reset()
            main.kalman.initialize(main.distance_m)
            main.velocity_ms = 0.0

        cipo.velocity_ms = main.velocity_ms
        return cipo

    def update_and_get_cipo(self, detections, frame=None) -> TrackingResult:
        self.update(detections, frame)
        cipo = self.get_cipo(frame)
        result = TrackingResult(
            tracked_objects=list(self.tracks), cipo=cipo,
            cut_in_detected=self.cut_in_detected,
            kalman_reset=self.kalman_reset)
        self.cut_in_detected = False
        self.kalman_reset = False
        return result
