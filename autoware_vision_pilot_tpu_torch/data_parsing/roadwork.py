"""The port of autoware_vision_pilot_tpu/data_parsing/roadwork.py.

ROADWork parser (Models/data_parsing/DomainSeg/ROADWork role): instance
polygon annotations -> binary roadwork-zone masks for DomainSeg.
"""
from __future__ import annotations

import json
from typing import List, Tuple

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


def polygons_to_binary_mask(polygons: List[np.ndarray],
                            image_hw: Tuple[int, int]) -> np.ndarray:
    """List of (N,2) polygons -> (H, W) float {0,1} mask."""
    mask = np.zeros(image_hw, np.uint8)
    for poly in polygons:
        pts = np.round(np.asarray(poly)).astype(np.int32).reshape(-1, 1, 2)
        if len(pts) >= 3:
            cv2.fillPoly(mask, [pts], 1)
    return mask.astype(np.float32)


def parse_roadwork_annotation(json_text: str) -> List[np.ndarray]:
    """COCO-style segmentation entries -> list of polygons."""
    rec = json.loads(json_text)
    polys = []
    anns = rec.get("annotations", rec if isinstance(rec, list) else [])
    for ann in anns:
        seg = ann.get("segmentation", [])
        for flat in seg if isinstance(seg, list) else []:
            arr = np.asarray(flat, np.float32).reshape(-1, 2)
            polys.append(arr)
    return polys
