from .config import Config, load_config
from .timers import FpsTimer, PerformanceMetrics
from .pipeline import (
    LateralPipeline,
    LongitudinalPipeline,
    PipelineEngine,
    ThreadSafeQueue,
    DoubleFrameBuffer,
    FrameResult,
    build_lateral_step,
    init_lateral_state,
)
from .fleet import (
    FleetLateralPipeline,
    FleetLongitudinalPipeline,
    FleetEngine,
    unpack_fleet_scalars,
)
