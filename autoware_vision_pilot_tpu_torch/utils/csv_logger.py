"""CSV flight recorder: one row of every control quantity per frame
(production_release/main.cpp:827-838, 1008-1031 — the csv_log_path sink);
the port's own copy of autoware_vision_pilot_tpu/utils/csv_logger.py."""
from __future__ import annotations

import csv
import pathlib

FIELDS = [
    "frame", "steering_deg", "steering_raw_deg", "autosteer_deg",
    "cte_m", "yaw_error_rad", "curvature_inv_m", "lane_width_m",
    "path_valid",
    "cipo_exists", "cipo_distance_m", "cipo_velocity_ms",
    "set_speed_ms", "accel_effort_ms2", "fcw", "aeb", "cut_in",
    "kalman_reset", "ego_speed_ms", "can_valid",
    "latency_ms",
]


class CsvFlightRecorder:
    def __init__(self, path: str | pathlib.Path):
        self.path = pathlib.Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._f = open(self.path, "w", newline="")
        self._w = csv.DictWriter(self._f, fieldnames=FIELDS,
                                 extrasaction="ignore")
        self._w.writeheader()

    def log(self, **row):
        self._w.writerow(row)

    def close(self):
        self._f.flush()
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
