"""The port of autoware_vision_pilot_tpu/data_parsing/cityscapes_like.py.

Cityscapes-labelId-family parsers: ACDC, MUSES, Cityscapes, IDD-AW.

These datasets (Models/data_parsing/SceneSeg/{ACDC,MUSES,IDDAW}/ and the
Lite dataloaders) all annotate with Cityscapes label ids; one table maps
them into the unified SceneSeg color code.
"""
from __future__ import annotations

import numpy as np

from ..train.datasets import SCENESEG_COLOURS

# Cityscapes labelIds (not trainIds): id -> unified class color name
_CS_LABELID_TO_UNIFIED = {
    7: "road",
    8: "background_objects",    # sidewalk
    11: "background_objects",   # building
    12: "background_objects",   # wall
    13: "background_objects",   # fence
    17: "background_objects",   # pole
    19: "background_objects",   # traffic light
    20: "background_objects",   # traffic sign
    21: "background_objects",   # vegetation
    22: "background_objects",   # terrain
    23: "sky",
    24: "vulnerable_living",    # person
    25: "vulnerable_living",    # rider
    26: "large_mobile_vehicle",  # car
    27: "large_mobile_vehicle",  # truck
    28: "large_mobile_vehicle",  # bus
    31: "large_mobile_vehicle",  # train
    32: "small_mobile_vehicle",  # motorcycle
    33: "small_mobile_vehicle",  # bicycle
}


def cityscapes_labelids_to_sceneseg(label_ids: np.ndarray) -> np.ndarray:
    """(H, W) Cityscapes labelId mask -> (H, W, 3) unified RGB label."""
    h, w = label_ids.shape
    out = np.zeros((h, w, 3), np.uint8)
    for lid, name in _CS_LABELID_TO_UNIFIED.items():
        out[label_ids == lid] = SCENESEG_COLOURS[name]
    return out


# comma10k class colors (their mask convention) -> unified
_COMMA10K_TO_UNIFIED = {
    (64, 32, 32): "road",                 # road
    (255, 0, 0): "background_objects",    # lane markings -> background
    (128, 128, 96): "background_objects",  # undrivable
    (0, 255, 102): "large_mobile_vehicle",  # movable (vehicles)
    (204, 0, 255): "vulnerable_living",   # my car? signals etc.
}


def comma10k_to_sceneseg(mask_rgb: np.ndarray) -> np.ndarray:
    """(H, W, 3) comma10k color mask -> unified RGB label
    (Models/data_parsing/SceneSeg/comma10k role)."""
    h, w = mask_rgb.shape[:2]
    out = np.zeros((h, w, 3), np.uint8)
    flat = mask_rgb.reshape(-1, 3)
    for color, name in _COMMA10K_TO_UNIFIED.items():
        m = np.all(flat == color, axis=1).reshape(h, w)
        out[m] = SCENESEG_COLOURS[name]
    return out
