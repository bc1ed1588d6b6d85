"""The trainer of the runtime AutoSteerTemporalNet (the 61-way steering
classifier on stacked EgoLanes masks), the port of
autoware_vision_pilot_tpu/train/autosteer_temporal_trainer.py.

The reference ships only the ONNX of this model; the recipe follows its
runtime contract (autosteer_engine.cpp: classes 0..60 are -30..+30
degrees, two outputs for consecutive frames): both heads supervised with
label-smoothed cross-entropy on (prev_angle, curr_angle) classes, AdamW on
a cosine decay.
"""
from __future__ import annotations

import dataclasses
import pathlib
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..convert.from_jax import state_dict_to_variables
from ..export.checkpoints import save_msgpack
from ..models.auto_steer_temporal import NUM_CLASSES, AutoSteerTemporalNet
from .optim import cosine_decay_schedule
from .train_step import adamw, create_seg_train_state, load_variables, optimizer_step


def angle_to_class(angle_deg: torch.Tensor) -> torch.Tensor:
    """Degrees [-30, 30] -> class ids [0, 60] (round half to even)."""
    return (torch.round(angle_deg) + 30).clamp(0, NUM_CLASSES - 1).to(torch.int64)


def smoothed_ce(logits, target_ids, smoothing: float = 0.05):
    """Cross-entropy against one-hot targets smoothed by ``smoothing``."""
    onehot = F.one_hot(target_ids, NUM_CLASSES).to(logits.dtype)
    soft = onehot * (1 - smoothing) + smoothing / NUM_CLASSES
    return -torch.mean(torch.sum(soft * F.log_softmax(logits, -1), -1))


@dataclasses.dataclass
class AutoSteerTemporalTrainerConfig:
    lr: float = 1e-3
    max_steps: int = 5000
    weight_decay: float = 1e-4
    smoothing: float = 0.05
    ckpt_dir: str = "runs/autosteer_temporal"


class AutoSteerTemporalTrainer:
    """AutoSteerTemporalNet on 80x160 masks, its weights ``variables`` (a
    JAX tree) or seeded from ``seed``, on ``device``."""

    def __init__(self, cfg: AutoSteerTemporalTrainerConfig, seed: int = 0, *,
                 variables: Optional[dict] = None, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.model = load_variables(AutoSteerTemporalNet(), variables, seed).to(self.device)
        self.schedule = cosine_decay_schedule(cfg.lr, cfg.max_steps)
        self.state = create_seg_train_state(
            self.model, adamw(self.schedule, weight_decay=cfg.weight_decay))

    def fit_step(self, stacked_masks, prev_angle_deg, curr_angle_deg) -> torch.Tensor:
        """stacked_masks (B, 80, 160, 6) float NHWC; angles in degrees ->
        the loss, a 0-d tensor on the device."""
        x = torch.from_numpy(np.ascontiguousarray(stacked_masks, np.float32)).to(self.device)
        prev, curr = (angle_to_class(torch.as_tensor(np.asarray(a), device=self.device))
                      for a in (prev_angle_deg, curr_angle_deg))
        opt = self.state.optimizer
        self.model.train()
        opt.zero_grad(set_to_none=True)
        prev_l, curr_l = self.model(x.permute(0, 3, 1, 2))
        loss = (smoothed_ce(prev_l, prev, self.cfg.smoothing) +
                smoothed_ce(curr_l, curr, self.cfg.smoothing))
        loss.backward()
        optimizer_step(opt)
        self.state.step += 1
        return loss.detach()

    def save(self, name: str = "last"):
        p = pathlib.Path(self.cfg.ckpt_dir)
        p.mkdir(parents=True, exist_ok=True)
        save_msgpack(p / f"{name}.msgpack", state_dict_to_variables(self.model))
