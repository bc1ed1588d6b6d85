"""The port of autoware_vision_pilot_tpu/data_parsing/bdd100k.py.

BDD100K parser (Models/data_parsing/SceneSeg/BDD100K/ role): semantic
masks -> the unified SceneSeg color coding.
"""
from __future__ import annotations

import numpy as np

from ..train.datasets import SCENESEG_COLOURS

# BDD100K semantic ids (cityscapes trainIds) -> unified class color
_BDD_TO_UNIFIED = {
    0: "road",                    # road
    1: "background_objects",      # sidewalk
    2: "background_objects",      # building
    3: "background_objects",      # wall
    4: "background_objects",      # fence
    5: "background_objects",      # pole
    6: "background_objects",      # traffic light
    7: "background_objects",      # traffic sign
    8: "background_objects",      # vegetation
    9: "background_objects",      # terrain
    10: "sky",                    # sky
    11: "vulnerable_living",      # person
    12: "vulnerable_living",      # rider
    13: "large_mobile_vehicle",   # car
    14: "large_mobile_vehicle",   # truck
    15: "large_mobile_vehicle",   # bus
    16: "large_mobile_vehicle",   # train
    17: "small_mobile_vehicle",   # motorcycle
    18: "small_mobile_vehicle",   # bicycle
}


def bdd100k_drivable_to_sceneseg(train_id_mask: np.ndarray) -> np.ndarray:
    """(H, W) trainId mask -> (H, W, 3) unified RGB color label."""
    h, w = train_id_mask.shape
    out = np.zeros((h, w, 3), np.uint8)  # default: unlabelled (0,0,0)
    for tid, name in _BDD_TO_UNIFIED.items():
        out[train_id_mask == tid] = SCENESEG_COLOURS[name]
    return out
