"""The port of autoware_vision_pilot_tpu/data_parsing/openlane.py.

OpenLane CIPO parser (Models/data_parsing/AutoSpeed/OpenLane role):
per-frame JSON with 2D boxes and CIPO levels -> detection samples for the
AutoSpeed trainer (classes = CIPO levels 1..4 -> ids 0..3).
"""
from __future__ import annotations

import json
from typing import Dict

import numpy as np


def parse_openlane_cipo(json_text: str) -> Dict:
    """One OpenLane CIPO annotation file -> {'boxes' (N,4) xyxy,
    'labels' (N,) int in [0,4)}. Entries without a valid box or level are
    dropped."""
    rec = json.loads(json_text)
    boxes, labels = [], []
    for obj in rec.get("results", rec.get("objects", [])):
        level = obj.get("cipo_level", obj.get("attribute"))
        box = obj.get("box2d") or obj.get("bbox")
        if level is None or box is None:
            continue
        try:
            level = int(level)
        except (TypeError, ValueError):
            continue
        if not 1 <= level <= 4:
            continue
        if isinstance(box, dict):
            x1, y1, x2, y2 = box["x1"], box["y1"], box["x2"], box["y2"]
        else:
            x1, y1, x2, y2 = box
        if x2 <= x1 or y2 <= y1:
            continue
        boxes.append([x1, y1, x2, y2])
        labels.append(level - 1)
    return {
        "boxes": np.asarray(boxes, np.float32).reshape(-1, 4),
        "labels": np.asarray(labels, np.int64),
        "raw_file": rec.get("raw_file", rec.get("file_path", "")),
    }
