"""The detection trainer, the port of
autoware_vision_pilot_tpu/train/detection_trainer.py (the reference's
Models/training/auto_speed_trainer.py, train/val :22-248): the EMA shadow
weights with their ramp, a linear warm-up then cosine learning rate,
gradients clipped by their global norm, AdamW with weight decay, and
validation by mAP@50 and mAP@[.5:.95].

The JAX trainer is one jitted SPMD step over a mesh; here it is an eager
step, on one card or over a world mesh (a process a card, as
train/train_step.py runs it: each rank its rows of the batch, the loss's
normalizer over the whole batch, the gradients averaged). Over a world
mesh each rank scores its rows of every validation batch and the
detections are gathered, so every rank reports the whole set's mAP. The
validation's NMS is the port's kernel on
the card (ops/kernels/nms_kernel.py, after nms_topk, as nms_fixed runs
them): one launch a validation
batch, a stream an image, each stream's k = min(4 * max_det, A)
candidates (1,200 at max_det 300 and 512x1024).
"""
from __future__ import annotations

import dataclasses
import pathlib
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from ..convert.from_jax import state_dict_to_variables
from ..export.checkpoints import save_msgpack
from ..nn.layers import dropout_generator
from ..ops.kernels.nms_kernel import nms_greedy
from ..ops.postprocess import nms_topk
from .detection_loss import detection_loss
from .metrics import detection_map
from .optim import warmup_cosine_decay_schedule
from ..parallel.sharding import all_reduce_mean, batch_sharded, eval_rows, gather_rows
from .train_step import (adamw, average_gradients, create_seg_train_state,
                         data_mesh, ema_update, load_variables, optimizer_step, shard_rows,
                         to_device_images, weights_swapped_in)


@dataclasses.dataclass
class DetectionTrainerConfig:
    num_classes: int = 4
    input_hw: Tuple[int, int] = (512, 1024)
    max_boxes: int = 64
    lr: float = 1e-3
    min_lr_ratio: float = 0.01
    warmup_steps: int = 500
    max_steps: int = 10000
    weight_decay: float = 5e-4
    ema_decay: float = 0.9999
    # the effective decay ramps as decay * (1 - exp(-updates / tau)), so the
    # EMA tracks the live weights early (the reference's ModelEMA,
    # Models/training/auto_speed_util.py:438-460)
    ema_tau: float = 2000.0
    grad_clip_norm: float = 10.0
    gains: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {"box": 7.5, "cls": 0.5, "dfl": 1.5})
    ckpt_dir: str = "runs/autospeed"


class DetectionTrainer:
    """model: an AutoSpeedNetwork (its train mode gives the raw maps). Its
    weights are ``variables`` (a JAX tree) or seeded from ``seed``; it moves
    to ``device``. f32, as the JAX trainer. ``mesh``: a world mesh to train
    over (every rank passes the same batches and seed), or None."""

    def __init__(self, model, cfg: DetectionTrainerConfig, mesh=None, seed: int = 0, *,
                 variables: Optional[dict] = None, device="cuda"):
        self.mesh = data_mesh(mesh)
        self.cfg = cfg
        self.device = torch.device(device)
        self.model = load_variables(model, variables, seed).to(self.device,
                                                                memory_format=torch.channels_last)
        self.schedule = warmup_cosine_decay_schedule(
            0.0, cfg.lr, cfg.warmup_steps, cfg.max_steps, end_value=cfg.lr * cfg.min_lr_ratio)
        self.state = create_seg_train_state(
            self.model, adamw(self.schedule, weight_decay=cfg.weight_decay,
                              clip_norm=cfg.grad_clip_norm), ema=True)
        self.generator = torch.Generator(device=self.device).manual_seed(seed + 1)

    @property
    def step(self) -> int:
        return self.state.step

    def ema_decay(self, n_updates: int) -> np.float32:
        """The ramped decay after ``n_updates`` updates, in float32."""
        cfg = self.cfg
        return np.float32(cfg.ema_decay) * (
            np.float32(1) - np.exp(-np.float32(n_updates) / np.float32(cfg.ema_tau)))

    def fit_step(self, images_u8: np.ndarray, boxes: np.ndarray, labels: np.ndarray,
                 mask: np.ndarray) -> torch.Tensor:
        """One optimization step on a YoloBatcher batch -> the loss, a 0-d
        tensor on the device (nothing waits for it)."""
        model, opt = self.model, self.state.optimizer
        first, rows, sharded = shard_rows(self.mesh, len(images_u8))
        rows = slice(first, first + rows)
        x = to_device_images(images_u8[rows], self.device)
        tgt = [torch.from_numpy(np.ascontiguousarray(a[rows])).to(self.device)
               for a in (boxes, labels, mask)]
        model.train()
        opt.zero_grad(set_to_none=True)
        with dropout_generator(self.generator), batch_sharded(self.mesh if sharded else None):
            outs = model(x)
            loss, _ = detection_loss(outs, *tgt, nc=self.cfg.num_classes, gains=self.cfg.gains)
        loss.backward()
        average_gradients(opt, self.mesh)
        optimizer_step(opt)
        self.state.step += 1
        ema_update(self.state, model, self.ema_decay(self.state.step))
        loss = loss.detach()
        return all_reduce_mean(self.mesh, loss)[0] if sharded else loss

    @torch.no_grad()
    def candidates(self, images_u8: np.ndarray, conf: float = 0.001, max_det: int = 300):
        """The eval-mode forward of a batch, its boxes as xyxy with each
        anchor's best class, and their top k = min(4 * max_det, A) a stream
        (ops/postprocess.py::nms_topk) -> boxes (B, k, 4), scores (B, k),
        classes (B, k) int32, on the device."""
        self.model.eval()
        out = self.model(to_device_images(images_u8, self.device))
        xywh, scores = out[..., :4], out[..., 4:]
        boxes = torch.stack([xywh[..., 0] - xywh[..., 2] / 2, xywh[..., 1] - xywh[..., 3] / 2,
                             xywh[..., 0] + xywh[..., 2] / 2, xywh[..., 1] + xywh[..., 3] / 2],
                            -1)
        return nms_topk(boxes.contiguous(), scores.amax(-1).contiguous(),
                        scores.argmax(-1).to(torch.int32).contiguous(), max_det=max_det,
                        conf_thresh=conf)

    def predictions(self, images_u8: np.ndarray, conf: float = 0.001, iou: float = 0.65,
                    max_det: int = 300):
        """The batch's detections: ``candidates``, then the NMS kernel (its
        plain version on the CPU), one launch for the batch, a stream an
        image -> boxes (B, max_det, 4) xyxy, scores, classes, valid
        (B, max_det), on the device."""
        return nms_greedy(*self.candidates(images_u8, conf, max_det), max_det=max_det,
                          iou_thresh=iou, conf_thresh=conf)

    def validate(self, val_batches: Iterator, conf: float = 0.001, iou: float = 0.65,
                 max_det: int = 300, use_ema: bool = True) -> Tuple[float, float]:
        """val_batches yields (images_u8, gt_boxes_xyxy_px list, gt_cls list).
        Scores the EMA weights (with the live BatchNorm statistics) by
        default; use_ema=False the live ones. -> (mAP@50, mAP@[.5:.95])."""
        preds, gts = [], []
        with weights_swapped_in(self.model, self.state.ema if use_ema else None):
            for images, gt_boxes, gt_cls in val_batches:
                rows = eval_rows(self.mesh, len(images))
                mine = []
                if rows.stop > rows.start:
                    bb, ss, cc, vv = (t.cpu().numpy() for t in self.predictions(
                        images[rows], conf, iou, max_det))
                    mine = [((bb[b][v], ss[b][v], cc[b][v]),
                             (np.asarray(gt_boxes[rows.start + b]),
                              np.asarray(gt_cls[rows.start + b])))
                            for b, v in enumerate(vv)]
                for pred, gt in gather_rows(self.mesh, mine):
                    preds.append(pred)
                    gts.append(gt)
        return detection_map(preds, gts, self.cfg.num_classes)

    def variables(self) -> dict:
        """The EMA weights and the BatchNorm statistics as a JAX tree."""
        with weights_swapped_in(self.model, self.state.ema):
            return state_dict_to_variables(self.model)

    def save(self, name: str = "last"):
        """``ckpt_dir/name.msgpack``: the EMA weights and the BatchNorm
        statistics in flax's layout, which the JAX package's load_msgpack
        reads. Over a world mesh rank 0 writes it."""
        if self.mesh is not None and self.mesh.rank != 0:
            return
        p = pathlib.Path(self.cfg.ckpt_dir)
        p.mkdir(parents=True, exist_ok=True)
        save_msgpack(p / f"{name}.msgpack", self.variables())
