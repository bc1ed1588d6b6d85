"""Rerun telemetry logger (N25 equivalent; production_release/src/rerun/
rerun_logger.cpp, include/rerun/rerun_logger.hpp:33-89): the port's own
copy of autoware_vision_pilot_tpu/utils/rerun_logger.py (host numpy).

Full reference signal set, same entity paths:
- ``camera/image``           resized input frame (BGR in, logged RGB)
- ``lanes/ego_left`` / ``lanes/ego_right`` / ``lanes/other``  float masks
- ``visualization/stacked_view``  final composite (BGR in, logged RGB)
- ``can/steering_angle_deg`` / ``can/speed_kmph``  (0.0 when CAN invalid,
  rerun_logger.cpp:113-120)
- ``control/pid_steering_raw_deg`` / ``control/pid_steering_filtered_deg``
  / ``control/autosteer_angle_deg``
- ``pathfinder/cte`` / ``pathfinder/yaw_error`` / ``pathfinder/curvature``
  (only when ``fused_valid``, rerun_logger.cpp:131-139)
- ``metrics/inference_time_ms``

Gated: degrades to a no-op when the rerun SDK is not installed (same
optional-feature contract as ENABLE_RERUN). Constructor contract from
rerun_logger.cpp:16-75: with neither a viewer nor a save path there is
no sink, so the stream is never created (prevents unbounded RAM
buffering); save() is wired before spawn().
"""
from __future__ import annotations

from typing import Optional

import numpy as np

try:
    import rerun as rr
    _HAS_RERUN = True
except ImportError:  # pragma: no cover
    rr = None
    _HAS_RERUN = False


class RerunLogger:
    def __init__(self, app_id: str = "visionpilot_tpu",
                 spawn_viewer: bool = False,
                 save_path: Optional[str] = None):
        self.enabled = False
        if not _HAS_RERUN:
            print("[rerun] SDK not installed — telemetry disabled")
            return
        if not spawn_viewer and not save_path:
            # no output sink -> don't init at all (rerun_logger.cpp:22-25)
            print("[rerun] not initialized (no viewer or save path)")
            return
        rr.init(app_id)
        if save_path:  # save FIRST, then spawn (rerun_logger.cpp:30-57)
            rr.save(save_path)
        if spawn_viewer:
            rr.spawn()
        self.enabled = True

    def log_data(self, frame_number: int, *,
                 frame_bgr: Optional[np.ndarray] = None,
                 ego_left: Optional[np.ndarray] = None,
                 ego_right: Optional[np.ndarray] = None,
                 other_lanes: Optional[np.ndarray] = None,
                 stacked_view_bgr: Optional[np.ndarray] = None,
                 can_steering_deg: float = 0.0,
                 can_speed_kmph: float = 0.0,
                 can_valid: bool = False,
                 pid_steering_raw_deg: Optional[float] = None,
                 pid_steering_filtered_deg: Optional[float] = None,
                 autosteer_deg: Optional[float] = None,
                 cte: Optional[float] = None,
                 yaw_error: Optional[float] = None,
                 curvature: Optional[float] = None,
                 fused_valid: bool = True,
                 inference_us: Optional[float] = None):
        """One frame of telemetry — the logData contract
        (rerun_logger.cpp:81-146)."""
        if not self.enabled:
            return
        rr.set_time_sequence("frame", frame_number)
        if frame_bgr is not None:
            rr.log("camera/image", rr.Image(frame_bgr[..., ::-1]))
        for path, mask in [("lanes/ego_left", ego_left),
                           ("lanes/ego_right", ego_right),
                           ("lanes/other", other_lanes)]:
            if mask is not None:
                rr.log(path, rr.Image(
                    (np.asarray(mask) * 255).astype(np.uint8)))
        if stacked_view_bgr is not None:
            rr.log("visualization/stacked_view",
                   rr.Image(stacked_view_bgr[..., ::-1]))
        # CAN scalars are always logged; invalid state logs 0.0
        rr.log("can/steering_angle_deg",
               rr.Scalar(float(can_steering_deg) if can_valid else 0.0))
        rr.log("can/speed_kmph",
               rr.Scalar(float(can_speed_kmph) if can_valid else 0.0))
        for path, v in [
                ("control/pid_steering_raw_deg", pid_steering_raw_deg),
                ("control/pid_steering_filtered_deg",
                 pid_steering_filtered_deg),
                ("control/autosteer_angle_deg", autosteer_deg)]:
            if v is not None:
                rr.log(path, rr.Scalar(float(v)))
        if fused_valid:
            for path, v in [("pathfinder/cte", cte),
                            ("pathfinder/yaw_error", yaw_error),
                            ("pathfinder/curvature", curvature)]:
                if v is not None:
                    rr.log(path, rr.Scalar(float(v)))
        if inference_us is not None:
            rr.log("metrics/inference_time_ms",
                   rr.Scalar(float(inference_us) / 1000.0))
