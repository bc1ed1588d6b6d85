"""The AutoSteer 2.0 trainer, the port of
autoware_vision_pilot_tpu/train/autosteer_trainer.py (the reference's
Models/training/auto_steer_trainer.py :63-140): the masked L1 on the
soft-argmax lane-position vector (the prediction times the height-validity
target, so that rows without a lane add nothing), BCE with logits on the
height map, the EMA, a warm-up cosine schedule and AdamW; validation by
the lane metrics and the vector AP at 0.02, 0.05 and 0.10.

The loss and the metrics take JAX's NHWC (B, H, 1, 1) layout; the port's
network gives NCHW, which the trainer permutes. On one card, or over a
world mesh as train/train_step.py runs one (each rank its rows; the
validation's rows gathered, so every rank reports the whole set's
metrics).
"""
from __future__ import annotations

import dataclasses
import pathlib
from typing import Optional, Tuple

import numpy as np
import torch

from ..convert.from_jax import state_dict_to_variables
from ..export.checkpoints import save_msgpack
from ..models.auto_steer import AutoSteerNetwork
from ..nn.layers import dropout_generator
from .metrics import vector_ap
from .optim import warmup_cosine_decay_schedule
from ..parallel.sharding import all_reduce_mean, batch_sharded, eval_rows, gather_rows
from .train_step import (adamw, average_gradients, create_seg_train_state, data_mesh,
                         ema_update, load_variables, optimizer_step, shard_rows,
                         to_device_images, weights_swapped_in)

MAP_THRESHOLDS = (0.02, 0.05, 0.10)


def autosteer_loss(lane_value, height_logits, target_xp, target_h, xp_weight: float = 10.0):
    """lane_value (B, H, 1, 1) and height_logits (B, H, 1, 1), NHWC, and
    targets in that layout -> (xp_weight * masked L1 + BCE, parts)."""
    l_xp = torch.mean(torch.abs(lane_value * target_h - target_xp))
    z = height_logits
    l_h = torch.mean(z.clamp_min(0) - z * target_h + torch.log1p(torch.exp(-z.abs())))
    return xp_weight * l_xp + l_h, {"xp": l_xp, "h_vector": l_h}


def add_line_hits(lane, prob, t_xp, t_h, tp, fp, conf):
    """The vector AP's decisions of a batch, one a line (auto_steer_trainer.py
    :203-224): a hit at t when the mean |x error| of the masked lines
    (prediction where prob > 0.5, target where t_h > 0.5) is < t, for each t
    of ``tp``; the line's confidence is its mean height probability."""
    dist = np.abs(lane * (prob > 0.5) - t_xp * (t_h > 0.5)).mean(axis=1)
    for t in tp:
        hit = dist < t
        tp[t].extend(hit.astype(int).tolist())
        fp[t].extend((~hit).astype(int).tolist())
    conf.extend(prob.mean(axis=1).tolist())


def nhwc(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 2, 3, 1)


@dataclasses.dataclass
class AutoSteerTrainerConfig:
    input_hw: Tuple[int, int] = (512, 1024)
    lr: float = 1e-3
    warmup_steps: int = 500
    max_steps: int = 10000
    weight_decay: float = 5e-4
    ema_decay: float = 0.9999
    xp_weight: float = 10.0
    ckpt_dir: str = "runs/autosteer"


class AutoSteerTrainer:
    """AutoSteer 2.0 "n" at ``cfg.input_hw``, its weights ``variables`` (a
    JAX tree) or seeded from ``seed``, on ``device``; ``mesh`` a world mesh
    to train over, or None."""

    def __init__(self, cfg: AutoSteerTrainerConfig, mesh=None, seed: int = 0, *,
                 variables: Optional[dict] = None, device="cuda"):
        self.mesh = data_mesh(mesh)
        self.cfg = cfg
        self.device = torch.device(device)
        model = AutoSteerNetwork("n", *cfg.input_hw)
        self.model = load_variables(model, variables, seed).to(self.device,
                                                                memory_format=torch.channels_last)
        self.schedule = warmup_cosine_decay_schedule(0.0, cfg.lr, cfg.warmup_steps,
                                                     cfg.max_steps, end_value=cfg.lr * 0.01)
        self.state = create_seg_train_state(
            self.model, adamw(self.schedule, weight_decay=cfg.weight_decay), ema=True)
        self.generator = torch.Generator(device=self.device).manual_seed(seed + 1)

    def forward(self, images_u8: np.ndarray):
        """-> (lane_value, height logits), NHWC (B, H / 8, 1, 1)."""
        x = to_device_images(images_u8, self.device)
        lane, height = self.model(x)
        return nhwc(lane), nhwc(height)

    def fit_step(self, images_u8, target_xp, target_h) -> torch.Tensor:
        """One step; targets (B, H / 8, 1, 1) NHWC -> the loss, a 0-d tensor
        on the device."""
        opt = self.state.optimizer
        first, rows, sharded = shard_rows(self.mesh, len(images_u8))
        rows = slice(first, first + rows)
        t_xp, t_h = (torch.from_numpy(np.ascontiguousarray(t[rows], np.float32)).to(self.device)
                     for t in (target_xp, target_h))
        self.model.train()
        opt.zero_grad(set_to_none=True)
        with dropout_generator(self.generator), batch_sharded(self.mesh if sharded else None):
            lane, height = self.forward(images_u8[rows])
        loss, _ = autosteer_loss(lane, height, t_xp, t_h, self.cfg.xp_weight)
        loss.backward()
        average_gradients(opt, self.mesh)
        optimizer_step(opt)
        self.state.step += 1
        ema_update(self.state, self.model, self.cfg.ema_decay)
        loss = loss.detach()
        return all_reduce_mean(self.mesh, loss)[0] if sharded else loss

    @torch.no_grad()
    def _outputs(self, val_batches):
        """(lane (B, H), height probability (B, H), t_xp, t_h) a batch, numpy,
        from the EMA weights in eval mode; over a world mesh each rank runs
        its rows and the batch is gathered."""
        self.model.eval()
        with weights_swapped_in(self.model, self.state.ema):
            for images, t_xp, t_h in val_batches:
                rows = eval_rows(self.mesh, len(images))
                n = rows.stop - rows.start
                mine = []
                if n:
                    lane, height = self.forward(images[rows])
                    lane = lane.cpu().numpy().reshape(n, -1)
                    prob = 1.0 / (1.0 + np.exp(-height.cpu().numpy().reshape(n, -1)))
                    mine = [(lane, prob, np.asarray(t_xp, np.float32)[rows].reshape(n, -1),
                             np.asarray(t_h, np.float32)[rows].reshape(n, -1))]
                parts = gather_rows(self.mesh, mine)
                yield tuple(np.concatenate(p) for p in zip(*parts))

    def validate(self, val_batches, detect_thresh: float = 0.5):
        """Over (images, t_xp, t_h) batches, from one forward each: the mean
        |xp error| on rows with a lane, height-validity precision and
        recall, and the vector mAP / mAP@50 (AutoSteer/README.md:12-14;
        auto_steer_trainer.py:163-248)."""
        abs_err_sum = n_rows = 0.0
        tp = fp = fn = 0.0
        ap_tp = {t: [] for t in MAP_THRESHOLDS}
        ap_fp = {t: [] for t in MAP_THRESHOLDS}
        conf, n_lines = [], 0
        for lane, prob, t_xp, t_h in self._outputs(val_batches):
            valid = t_h > 0.5
            abs_err_sum += np.abs(lane[valid] - t_xp[valid]).sum()
            n_rows += valid.sum()
            pred = prob > detect_thresh
            tp += (pred & valid).sum()
            fp += (pred & ~valid).sum()
            fn += (~pred & valid).sum()
            add_line_hits(lane, prob, t_xp, t_h, ap_tp, ap_fp, conf)
            n_lines += len(lane)
        out = {"xp_mae": float(abs_err_sum / max(n_rows, 1)),
               "h_precision": float(tp / max(tp + fp, 1)),
               "h_recall": float(tp / max(tp + fn, 1)), "map": 0.0, "map50": 0.0}
        if n_lines:
            _, _, out["map"], out["map50"] = vector_ap(ap_tp, ap_fp, conf, n_lines)
        return out

    def validate_map(self, val_batches, thresholds=MAP_THRESHOLDS):
        """The lane-vector mAP alone, comparable to the reference's published
        numbers (mAP 0.9546 / mAP@50 0.9691): a line is a hit at t when its
        mean masked normalized-x error is < t, ranked by the mean height
        confidence, 101-point AP a threshold; mAP@50 is the AP at 0.05."""
        tp = {t: [] for t in thresholds}
        fp = {t: [] for t in thresholds}
        conf, n_lines = [], 0
        for lane, prob, t_xp, t_h in self._outputs(val_batches):
            add_line_hits(lane, prob, t_xp, t_h, tp, fp, conf)
            n_lines += len(lane)
        if not n_lines:
            return {"map": 0.0, "map50": 0.0, "precision": 0.0, "recall": 0.0}
        m_pre, m_rec, mean_ap, map50 = vector_ap(tp, fp, conf, n_lines)
        return {"map": mean_ap, "map50": map50, "precision": m_pre, "recall": m_rec}

    def variables(self) -> dict:
        """The EMA weights and the BatchNorm statistics as a JAX tree."""
        with weights_swapped_in(self.model, self.state.ema):
            return state_dict_to_variables(self.model)

    def save(self, name: str = "last"):
        """``ckpt_dir/name.msgpack`` (rank 0 over a world mesh)."""
        if self.mesh is not None and self.mesh.rank != 0:
            return
        p = pathlib.Path(self.cfg.ckpt_dir)
        p.mkdir(parents=True, exist_ok=True)
        save_msgpack(p / f"{name}.msgpack", self.variables())
