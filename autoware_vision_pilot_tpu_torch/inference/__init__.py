from .infer import (
    SceneSegInfer,
    Scene3DInfer,
    DomainSegInfer,
    EgoLanesInfer,
    AutoSpeedInfer,
    AutoSteerInfer,
)
