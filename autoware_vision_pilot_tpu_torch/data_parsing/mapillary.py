"""The port of autoware_vision_pilot_tpu/data_parsing/mapillary.py.

Mapillary Vistas parsers (three reference roles, all vectorized):

1. SceneSeg coarse classes from Vistas v1.2 label ids
   (Models/data_parsing/SceneSeg/Mapillary_Vistas/process_mapillary_vistas.py
   :11-250 — its 60-branch per-pixel loop becomes one LUT gather), with the
   same validity rules: snow pixels invalidate the sample, and samples
   where road pixels don't outnumber other-drivable pixels are dropped.
2. DomainSeg binary roadwork masks from Vistas v2.0 color masks
   (DomainSeg/Mapillary_Vistas_2.0/process_mapillary_vistas.py:20-70):
   traffic cones (210,60,60) + temporary barriers (250,170,35) -> 255.
3. Lite models: Vistas ids -> Cityscapes trainIds
   (Lite/mapillary/mapillary2cityscapes_map.py).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from ..train.datasets import SCENESEG_COLOURS

# ---- 1. SceneSeg coarse mapping (Vistas v1.2, 66 label ids) --------------

_V1_GROUPS = {
    "sky": [27],
    "background_objects": [17, 45, 47, 48, 50, 49, 46, 30, 29, 0,
                           10, 11, 12, 15, 16, 18, 25, 26, 28, 31, 32, 33,
                           34, 35, 37, 38, 39, 40, 42, 43, 44, 51, 63, 64],
    "vulnerable_living": [19, 1],
    "small_mobile_vehicle": [20, 21, 22, 57, 52],
    "large_mobile_vehicle": [55, 61, 54, 58, 53, 56, 59, 60, 62],
    "road_edge_delimiter": [2, 6, 3, 4, 5, 9],
    "road": [13, 7, 8, 14, 23, 24, 36, 41],
}
# other-drivable surfaces that compete with road for scene validity
_V1_DRIVABLE_OTHER = (10, 11, 12, 15)   # parking, ped. area, rail, sidewalk
_V1_SNOW = 28
_V1_ROAD = 13

_V1_LUT = np.zeros((256, 3), np.uint8)
for _name, _ids in _V1_GROUPS.items():
    for _i in _ids:
        _V1_LUT[_i] = SCENESEG_COLOURS[_name]


def mapillary_ids_to_sceneseg(label_ids: np.ndarray
                              ) -> Tuple[np.ndarray, bool]:
    """(H, W) Vistas v1.2 ids -> ((H, W, 3) unified RGB, is_valid).

    is_valid reproduces createMask's checks: any snow pixel invalidates
    (snowy roads conflict across datasets), and road pixel count must
    exceed the other-drivable pixel count for an on-road scene.
    """
    ids = label_ids.astype(np.int64)
    rgb = _V1_LUT[np.clip(ids, 0, 255)]
    has_snow = bool((ids == _V1_SNOW).any())
    road_sum = int((ids == _V1_ROAD).sum())
    other_sum = int(np.isin(ids, _V1_DRIVABLE_OTHER).sum())
    return rgb, (not has_snow) and road_sum > other_sum


# ---- 2. DomainSeg roadwork binary masks (Vistas v2.0 colors) --------------

ROADWORK_COLORS = ((210, 60, 60),     # object--traffic-cone
                   (250, 170, 35))    # construction--barrier--temporary


def mapillary_v2_to_roadwork(mask_rgb: np.ndarray
                             ) -> Tuple[np.ndarray, bool]:
    """(H, W, 3) Vistas v2.0 color mask -> ((H, W) uint8 {0,255} roadwork
    mask, class_present). Samples without either class are dropped by the
    caller, matching the reference's is_class_present filter."""
    m = np.zeros(mask_rgb.shape[:2], bool)
    for color in ROADWORK_COLORS:
        m |= np.all(mask_rgb[..., :3] == color, axis=-1)
    return (m.astype(np.uint8) * 255), bool(m.any())


# ---- 3. Lite: Vistas -> Cityscapes trainIds -------------------------------

MAPILLARY_TO_CITYSCAPES = {
    "animal--bird": 255, "animal--ground-animal": 255,
    "construction--barrier--curb": 1,
    "construction--barrier--fence": 4,
    "construction--barrier--guard-rail": 4,
    "construction--barrier--other-barrier": 255,
    "construction--barrier--wall": 3,
    "construction--flat--bike-lane": 0,
    "construction--flat--crosswalk-plain": 0,
    "construction--flat--curb-cut": 1,
    "construction--flat--parking": 0,
    "construction--flat--pedestrian-area": 1,
    "construction--flat--rail-track": 16,
    "construction--flat--road": 0,
    "construction--flat--service-lane": 0,
    "construction--flat--sidewalk": 1,
    "construction--structure--bridge": 2,
    "construction--structure--building": 2,
    "construction--structure--tunnel": 2,
    "human--person": 11,
    "human--rider--bicyclist": 12,
    "human--rider--motorcyclist": 12,
    "human--rider--other-rider": 12,
    "marking--crosswalk-zebra": 0, "marking--general": 0,
    "nature--mountain": 9, "nature--sand": 9, "nature--sky": 10,
    "nature--snow": 9, "nature--terrain": 9, "nature--vegetation": 8,
    "nature--water": 255,
    "object--banner": 255, "object--bench": 255, "object--bike-rack": 255,
    "object--billboard": 255, "object--catch-basin": 255,
    "object--cctv-camera": 255, "object--fire-hydrant": 255,
    "object--junction-box": 255, "object--mailbox": 255,
    "object--manhole": 255, "object--phone-booth": 255,
    "object--pothole": 255, "object--street-light": 255,
    "object--support--pole": 5,
    "object--support--traffic-sign-frame": 7,
    "object--support--utility-pole": 5,
    "object--traffic-light": 6,
    "object--traffic-sign--back": 7,
    "object--traffic-sign--front": 7,
    "object--trash-can": 255,
    "object--vehicle--bicycle": 18, "object--vehicle--boat": 255,
    "object--vehicle--bus": 15, "object--vehicle--car": 13,
    "object--vehicle--caravan": 255, "object--vehicle--motorcycle": 17,
    "object--vehicle--on-rails": 16, "object--vehicle--other-vehicle": 255,
    "object--vehicle--trailer": 255, "object--vehicle--truck": 14,
    "object--vehicle--wheeled-slow": 255,
    "void--car-mount": 255, "void--ego-vehicle": 255,
    "void--unlabeled": 255,
}


def mapillary_to_cityscapes_trainids(label_ids: np.ndarray,
                                     label_names: Sequence[str]
                                     ) -> np.ndarray:
    """(H, W) Vistas ids + the dataset config's ordered label names ->
    (H, W) Cityscapes trainIds (255 = ignore)."""
    lut = np.full(max(len(label_names), 256), 255, np.uint8)
    for i, name in enumerate(label_names):
        lut[i] = MAPILLARY_TO_CITYSCAPES.get(name, 255)
    return lut[np.clip(label_ids.astype(np.int64), 0, len(lut) - 1)]
