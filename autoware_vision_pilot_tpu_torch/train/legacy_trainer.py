"""Legacy-style trainer, the port of
autoware_vision_pilot_tpu/train/legacy_trainer.py: multi-dataset sample
interleave with the per-epoch batch schedule.

Rebuild of the reference's SceneSeg-family training scheme
(Models/training/train_scene_seg.py): datasets are interleaved
sample-by-sample with per-epoch shuffle (:104-160), the optimizer steps
every `batch_size` samples with the batch size decayed per epoch
(32->16->8->4->3->2->1, :113-129), and validation + checkpoint run every
`val_every` samples (:229-240). As in the JAX package, the samples of one
optimizer step go through the network as one device batch, normalized on
the device; the interleave draws from ``np.random.default_rng(seed)`` as
JAX's does, so a seed gives the same sample order.

The trainer's losses take the port's NCHW outputs; dense (B, H, W, C)
labels are handed over as NCHW.
"""
from __future__ import annotations

import dataclasses
import pathlib
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..convert.from_jax import state_dict_to_variables
from ..export.checkpoints import save_msgpack
from ..nn.layers import dropout_generator, init_seeded
from ..ops.preprocess import IMAGENET_MEAN, IMAGENET_STD
from .datasets import batched_loader, resize_sample, round_robin_interleave
from .losses import segmentation_ce_loss
from .metrics import confusion_matrix, miou_from_confusion
from .train_step import adamw, create_seg_train_state, optimizer_step

BATCH_SIZE_SCHEDULE = (32, 16, 8, 4, 3, 2, 1)  # per-epoch decay


@dataclasses.dataclass
class LegacyTrainerConfig:
    num_epochs: int = 7
    lr: float = 1e-4
    val_every: int = 8000
    hw: tuple = (320, 640)
    num_classes: int = 3
    ckpt_dir: str = "runs/legacy"
    log_every: int = 250
    batch_schedule: Sequence[int] = BATCH_SIZE_SCHEDULE
    task: str = "seg"  # 'seg' (mIoU validation) | 'dense' (val-loss only)
    qat: bool = False  # quantization-aware training (train/qat.py)
    qat_min_channels: int = 32


class LegacySegTrainer:
    """model: a port seg network, whose weights init_seeded fills from
    ``seed``; datasets: a list with the SceneSegDataset interface. The
    model, its optimizer (``adamw(cfg.lr)``) and the step are
    ``self.state``; dropout and stochastic depth draw from a generator on
    ``device`` seeded with ``seed``."""

    def __init__(self, model, datasets, cfg: LegacyTrainerConfig,
                 loss_fn: Optional[Callable] = None, seed: int = 0, device="cuda"):
        self.device = torch.device(device)
        self.model = init_seeded(model, torch.Generator().manual_seed(seed)).to(self.device)
        self.datasets = datasets
        self.cfg = cfg
        self.loss_fn = loss_fn or (lambda logits, tgt, w: segmentation_ce_loss(logits, tgt, w))
        self.state = create_seg_train_state(self.model, adamw(cfg.lr))
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.np_rng = np.random.default_rng(seed)
        self.sample_count = 0
        self.history = []
        self._mean = IMAGENET_MEAN.to(self.device).reshape(1, 3, 1, 1)
        self._std = IMAGENET_STD.to(self.device).reshape(1, 3, 1, 1)

    def normalized(self, images_u8: np.ndarray) -> torch.Tensor:
        """(B, H, W, 3) uint8 -> (B, 3, H, W) f32 ImageNet-normalized on the
        device, channels_last."""
        x = torch.from_numpy(images_u8).to(self.device).permute(0, 3, 1, 2).float() / 255.0
        return (x - self._mean) / self._std

    def _labels(self, labels: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(labels).to(self.device)
        return t.permute(0, 3, 1, 2) if t.dim() == 4 else t

    def grad_step(self, images_u8: np.ndarray, labels: np.ndarray, weights: np.ndarray):
        """One optimizer step on one device batch -> the loss (a 0-d device
        tensor)."""
        cfg, model = self.cfg, self.model
        x = self.normalized(images_u8)
        model.train()
        self.state.optimizer.zero_grad(set_to_none=True)
        with dropout_generator(self.generator):
            if cfg.qat:
                from .qat import qat_apply
                out = qat_apply(model, x, min_channels=cfg.qat_min_channels)
            else:
                out = model(x)
        w = torch.from_numpy(weights).to(self.device).mean(0)
        loss = self.loss_fn(out, self._labels(labels), w)
        loss.backward()
        optimizer_step(self.state.optimizer)
        self.state.step += 1
        return loss.detach()

    @torch.no_grad()
    def val_step(self, images_u8: np.ndarray, labels: np.ndarray) -> np.ndarray:
        self.model.eval()
        pred = self.model(self.normalized(images_u8)).argmax(1)
        return confusion_matrix(pred.cpu().numpy(), labels, self.cfg.num_classes)

    def _epoch_batch_size(self, epoch):
        s = self.cfg.batch_schedule
        return s[min(epoch, len(s) - 1)]

    def train(self, max_samples: Optional[int] = None,
              callbacks: Optional[Callable] = None):
        cfg = self.cfg
        for epoch in range(cfg.num_epochs):
            bs = self._epoch_batch_size(epoch)
            order = list(round_robin_interleave(self.datasets, self.np_rng))
            # group interleaved samples into device batches of size bs
            i = 0
            while i < len(order):
                group = order[i:i + bs]
                i += bs
                imgs, labs, ws = [], [], []
                for d_idx, s_idx in group:
                    img, ids, w = self.datasets[d_idx].get_train(s_idx)
                    img, ids = resize_sample(img, ids, cfg.hw)
                    imgs.append(img)
                    labs.append(ids)
                    ws.append(w)
                loss = self.grad_step(np.stack(imgs), np.stack(labs), np.stack(ws))
                self.sample_count += len(group)
                if (self.sample_count // bs) % cfg.log_every == 0:
                    self.history.append((self.sample_count, float(loss)))
                if callbacks:
                    callbacks(self, float(loss))
                if max_samples and self.sample_count >= max_samples:
                    return self.history
                if cfg.val_every and self.sample_count % cfg.val_every < bs:
                    self.validate_and_save(epoch)
        return self.history

    def validate_and_save(self, epoch):
        """mIoU over every dataset's validation split (task 'seg'), and the
        weights as a flax msgpack file in ``ckpt_dir`` that the JAX
        package's load_msgpack reads. -> (mIoU, overall) or None."""
        cm_total = None
        if self.cfg.task == "seg":
            for ds in self.datasets:
                n_val = ds.item_count()[1]
                for imgs, labs, _ in batched_loader(ds, range(n_val), 4, self.cfg.hw,
                                                    train=False):
                    cm = self.val_step(imgs, labs)
                    cm_total = cm if cm_total is None else cm_total + cm
        p = pathlib.Path(self.cfg.ckpt_dir)
        p.mkdir(parents=True, exist_ok=True)
        save_msgpack(p / f"iter_{self.sample_count}_epoch_{epoch}.msgpack",
                     state_dict_to_variables(self.model))
        if cm_total is None:
            return None
        iou, miou, overall = miou_from_confusion(cm_total)
        return miou, overall


def make_scene3d_trainer(model, datasets, cfg: LegacyTrainerConfig = None,
                         edge_scale: float = 1.0, **kw):
    """Scene3D legacy trainer: SSI robust-mAE + multi-scale edge loss
    (scene_3d_trainer.py:151-196). Dataset labels are float depth maps."""
    from .losses import ssi_mae_depth_loss
    cfg = cfg or LegacyTrainerConfig(task="dense", ckpt_dir="runs/scene3d")

    def loss(logits, tgt, w):
        tgt = tgt[:, None] if tgt.dim() == 3 else tgt
        total, _, _ = ssi_mae_depth_loss(logits, tgt, edge_scale)
        return total

    return LegacySegTrainer(model, datasets, cfg, loss_fn=loss, **kw)


def make_domainseg_trainer(model, datasets, cfg: LegacyTrainerConfig = None, **kw):
    """DomainSeg legacy trainer: BCE on the binary roadwork head
    (domain_seg_trainer.py role; also the EgoSpace scheme, binary seg on
    the frozen SceneSeg upstream)."""
    from .losses import binary_seg_loss
    cfg = cfg or LegacyTrainerConfig(task="dense", ckpt_dir="runs/domainseg")

    def loss(logits, tgt, w):
        tgt = tgt[:, None] if tgt.dim() == 3 else tgt
        return binary_seg_loss(logits, tgt)

    return LegacySegTrainer(model, datasets, cfg, loss_fn=loss, **kw)


def make_egolanes_trainer(model, datasets, cfg: LegacyTrainerConfig = None,
                          channel_weights: bool = True,
                          bev_loss_weight: float = 0.0,
                          bev_homography=None,
                          bev_wh=(640, 640), perspective_wh=(640, 320),
                          **kw):
    """EgoLanes legacy trainer (ego_lanes_trainer.py:268-542): per-channel
    BCE + multi-scale edge loss with the reference's 2/2/1 ego-left/
    ego-right/other weighting; labels are (N, 3, h, w) binary masks.

    With bev_loss_weight > 0 the BEV/reprojected corridor terms are added
    for batches that carry BEV GT: the target is then a dict {"masks":
    (N, 3, h, w), "bev_gt": {name: (2, K)}, "bev_pred": {name: (K,)},
    "reproj_gt": {name: (2, K)} (optional)}."""
    from .losses import corridor_bev_losses, lanes_bce_edge_loss, weighted_egolanes_loss
    cfg = cfg or LegacyTrainerConfig(task="dense", ckpt_dir="runs/egolanes")

    def seg_loss(logits, tgt):
        if channel_weights:
            total, _ = weighted_egolanes_loss(logits, tgt)
        else:
            total, _, _ = lanes_bce_edge_loss(logits, tgt)
        return total

    def loss(logits, tgt, w):
        if isinstance(tgt, dict):
            total = seg_loss(logits, tgt["masks"])
            if bev_loss_weight > 0 and "bev_gt" in tgt:
                bev = corridor_bev_losses(tgt["bev_gt"], tgt["bev_pred"],
                                          gt_reproj=tgt.get("reproj_gt"),
                                          homography=bev_homography,
                                          bev_wh=bev_wh, perspective_wh=perspective_wh)
                total = total + bev_loss_weight * sum(bev.values())
            return total
        return seg_loss(logits, tgt)

    return LegacySegTrainer(model, datasets, cfg, loss_fn=loss, **kw)
