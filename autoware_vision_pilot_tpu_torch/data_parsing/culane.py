"""The port of autoware_vision_pilot_tpu/data_parsing/culane.py.

CULane lane dataset parser (Models/data_parsing/EgoLanes/CULane/ role).

CULane annotations are per-image .lines.txt files: one lane per line as
"x1 y1 x2 y2 ..." floating point pairs.
"""
from __future__ import annotations

from typing import List

import numpy as np


def parse_culane_lines(text: str) -> List[np.ndarray]:
    lanes = []
    for line in text.splitlines():
        vals = [float(v) for v in line.split()]
        if len(vals) >= 4:
            pts = np.asarray(vals, np.float32).reshape(-1, 2)
            lanes.append(pts)
    return lanes


def culane_to_unified(lines_path: str, image_hw=(590, 1640),
                      thickness: int = 6) -> np.ndarray:
    from .common import rasterize_lanes
    with open(lines_path) as f:
        lanes = parse_culane_lines(f.read())
    return rasterize_lanes(lanes, image_hw, thickness)
