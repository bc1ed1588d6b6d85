"""Training of the port: the losses, the metrics, the datasets, the train
step on one card or over a world mesh of cards (data parallelism), the
optax pieces (train/optim.py), the legacy, detection, AutoSteer,
AutoSteer-temporal, AutoDrive and Lite trainers, the YOLO data, the
augmentations, the depth teacher and QAT (train/qat.py)."""
from .losses import (
    segmentation_ce_loss,
    binary_seg_loss,
    ssi_mae_depth_loss,
    edge_loss,
    lanes_bce_edge_loss,
)
from .train_step import (
    TrainState,
    make_seg_train_step,
    create_seg_train_state,
)
from .metrics import (
    confusion_matrix,
    miou_from_confusion,
    detection_map,
)
from .datasets import (
    SceneSegDataset,
    SyntheticSegDataset,
    decode_scene_seg_mask,
    round_robin_interleave,
)
from .legacy_trainer import LegacySegTrainer, LegacyTrainerConfig
from .lite_trainer import LiteTrainer, load_experiment_config
