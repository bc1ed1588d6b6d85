from .visualization import (
    SCENE_SEG_PALETTE,
    EGO_LANES_COLORS,
    draw_lane_masks,
    draw_polyfit_lanes,
    draw_detections,
    draw_hud,
    depth_to_colormap,
    blend,
)
from .csv_logger import CsvFlightRecorder
