"""The port of autoware_vision_pilot_tpu/data_parsing/curvelanes.py.

CurveLanes parser (Models/data_parsing/EgoLanes/CurveLanes role):
per-image JSON with {"Lines": [[{"x": "..", "y": ".."}, ...], ...]}
(coordinates are strings in the original dataset).
"""
from __future__ import annotations

import json
from typing import List

import numpy as np


def parse_curvelanes_label(json_text: str) -> List[np.ndarray]:
    rec = json.loads(json_text)
    lanes = []
    for line in rec.get("Lines", []):
        pts = np.asarray([[float(p["x"]), float(p["y"])] for p in line],
                         np.float32)
        if len(pts) >= 2:
            # sort by y so rasterization draws continuous polylines
            lanes.append(pts[np.argsort(pts[:, 1])])
    return lanes


def curvelanes_to_unified(json_path: str, image_hw,
                          thickness: int = 6) -> np.ndarray:
    from .common import rasterize_lanes
    with open(json_path) as f:
        lanes = parse_curvelanes_label(f.read())
    return rasterize_lanes(lanes, image_hw, thickness)
