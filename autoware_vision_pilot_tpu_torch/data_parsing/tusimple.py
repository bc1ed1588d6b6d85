"""The port of autoware_vision_pilot_tpu/data_parsing/tusimple.py.

TuSimple lane dataset parser (Models/data_parsing/AutoSteer/TuSimple/
and EgoLanes/TuSimple/ role).

TuSimple labels are JSON lines: {"lanes": [[x...]...], "h_samples": [y...],
"raw_file": path}; x = -2 marks no sample at that row.
"""
from __future__ import annotations

import json
from typing import List

import numpy as np


def parse_tusimple_label(json_line: str) -> dict:
    """One JSON-line -> {'lanes': [(N,2) arrays], 'raw_file': str}."""
    rec = json.loads(json_line)
    h = np.asarray(rec["h_samples"], np.float32)
    lanes = []
    for xs in rec["lanes"]:
        xs = np.asarray(xs, np.float32)
        valid = xs >= 0
        if valid.sum() >= 2:
            lanes.append(np.stack([xs[valid], h[valid]], -1))
    return {"lanes": lanes, "raw_file": rec.get("raw_file", "")}


def tusimple_to_unified(json_path: str, image_hw=(720, 1280),
                        thickness: int = 6) -> List[dict]:
    """Parse a label file -> list of {'raw_file', 'masks' (H,W,3)}."""
    from .common import rasterize_lanes
    out = []
    with open(json_path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = parse_tusimple_label(line)
            rec["masks"] = rasterize_lanes(rec["lanes"], image_hw, thickness)
            out.append(rec)
    return out
