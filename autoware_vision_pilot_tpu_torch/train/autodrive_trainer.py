"""The AutoDrive trainer, the port of
autoware_vision_pilot_tpu/train/autodrive_trainer.py (the reference's
Models/training/{auto_drive_trainer,train_auto_drive,
train_autodrive_qat}.py): two-frame regression with L1 on the normalized
distance, L1 on the curvature and BCE on the cut-in flag; the AutoSpeed
backbone as a warm start; optionally the backbone frozen (optax's
``multi_transform`` with ``set_to_zero``: no update, no weight decay) and
QAT by int8 fake-quant of every parameter with a straight-through
gradient, the PT2E/XNNPACK QAT analog.
"""
from __future__ import annotations

import dataclasses
import pathlib
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

from ..convert.from_jax import state_dict_to_variables
from ..export.checkpoints import save_msgpack
from ..models.auto_drive import AutoDriveNetwork
from ..nn.layers import dropout_generator
from .optim import multi_transform, set_to_zero
from .train_step import (adamw, create_seg_train_state, load_variables, optimizer_step,
                         to_device_images)


def fake_quant_int8(w: torch.Tensor) -> torch.Tensor:
    """Symmetric per-tensor int8 fake-quant, max|w| / 127 the step, with a
    straight-through gradient (the identity's)."""
    scale = torch.clamp_min(w.detach().abs().max(), 1e-8) / 127.0
    q = torch.clamp(torch.round(w.detach() / scale), -127, 127) * scale
    return w + (q - w).detach()


def autodrive_loss(d_norm, curvature, flag_logit, gt_d, gt_curv, gt_flag,
                   w_d: float = 1.0, w_c: float = 1.0, w_f: float = 1.0):
    """(B, 1) outputs, (B,) targets -> (total, parts)."""
    l_d = torch.mean(torch.abs(d_norm[:, 0] - gt_d))
    l_c = torch.mean(torch.abs(curvature[:, 0] - gt_curv))
    z = flag_logit[:, 0]
    l_f = torch.mean(z.clamp_min(0) - z * gt_flag + torch.log1p(torch.exp(-z.abs())))
    return w_d * l_d + w_c * l_c + w_f * l_f, {"distance": l_d, "curvature": l_c, "flag": l_f}


@dataclasses.dataclass
class AutoDriveTrainerConfig:
    input_hw: Tuple[int, int] = (512, 1024)
    lr: float = 1e-4
    weight_decay: float = 1e-2
    qat: bool = False
    freeze_backbone: bool = False
    ckpt_dir: str = "runs/autodrive"


class AutoDriveTrainer:
    """AutoDriveNetwork at ``cfg.input_hw``, its weights ``variables`` (a
    JAX tree) or seeded from ``seed``, on ``device``."""

    def __init__(self, cfg: AutoDriveTrainerConfig, seed: int = 0, *,
                 variables: Optional[dict] = None, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.model = load_variables(AutoDriveNetwork(*cfg.input_hw), variables, seed).to(
            self.device, memory_format=torch.channels_last)
        tx = adamw(cfg.lr, weight_decay=cfg.weight_decay)
        if cfg.freeze_backbone:
            tx = multi_transform(
                {"train": tx, "frozen": set_to_zero()},
                lambda name: "frozen" if name.startswith("backbone") else "train")
        self.state = create_seg_train_state(self.model, tx)
        self.generator = torch.Generator(device=self.device).manual_seed(seed + 1)

    def warm_start_from_autospeed(self, autospeed_state_dict: Dict[str, torch.Tensor]) -> int:
        """Copy the AutoSpeed backbone's parameters (``net.*`` of an
        AutoSpeedNetwork's state_dict) into ``backbone.*`` where the shapes
        match (autodrive_network.py:38-79); the BatchNorm statistics stay,
        as JAX moves only ``params``. -> the tensors moved."""
        params = dict(self.model.named_parameters())
        matched = 0
        with torch.no_grad():
            for k, v in autospeed_state_dict.items():
                dst = params.get(f"backbone.{k[4:]}") if k.startswith("net.") else None
                if dst is not None and tuple(dst.shape) == tuple(v.shape):
                    dst.copy_(v)
                    matched += 1
        print(f"[autodrive] transferred {matched} backbone tensors")
        return matched

    def fit_step(self, prev_u8, curr_u8, gt_d, gt_curv, gt_flag) -> torch.Tensor:
        """One step on frames (B, H, W, 3) uint8 at t-1 and t and (B,)
        targets -> the loss, a 0-d tensor on the device."""
        xp, xc = (to_device_images(a, self.device) for a in (prev_u8, curr_u8))
        tgt = [torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(self.device)
               for a in (gt_d, gt_curv, gt_flag)]
        opt = self.state.optimizer
        self.model.train()
        self.model.zero_grad(set_to_none=True)  # the frozen parameters' too
        with dropout_generator(self.generator):
            if self.cfg.qat:
                used = {n: fake_quant_int8(p) for n, p in self.model.named_parameters()}
                d, c, f = functional_call(self.model, used, (xp, xc))
            else:
                d, c, f = self.model(xp, xc)
        loss, _ = autodrive_loss(d, c, f, *tgt)
        loss.backward()
        optimizer_step(opt)
        self.state.step += 1
        return loss.detach()

    def save(self, name: str = "last"):
        p = pathlib.Path(self.cfg.ckpt_dir)
        p.mkdir(parents=True, exist_ok=True)
        save_msgpack(p / f"{name}.msgpack", state_dict_to_variables(self.model))
