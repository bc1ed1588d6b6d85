"""The port of autoware_vision_pilot_tpu/data_parsing/__init__.py."""
from .common import (
    rasterize_lanes,
    UNIFIED_LANE_COLORS,
    write_unified_sample,
    lidar_depth_fill,
)
from .tusimple import parse_tusimple_label
from .culane import parse_culane_lines
from .bdd100k import bdd100k_drivable_to_sceneseg
from .mapillary import (
    mapillary_ids_to_sceneseg,
    mapillary_v2_to_roadwork,
    mapillary_to_cityscapes_trainids,
)
from .depth_datasets import (
    drivingstereo_sample,
    argoverse_sample,
    ddad_sample,
)
from .jiqing_once3d import parse_jiqing_gt, parse_once3d_entry
from .comma2k19 import drivable_path_points
from .zod import curvature_from_steering, find_cipo_on_path
