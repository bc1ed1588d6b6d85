"""The Lite trainer, the port of autoware_vision_pilot_tpu/train/
lite_trainer.py (the reference's Models/training/lite_trainer_base.py):
YAML experiment configs (configs/*Lite.yaml: experiment, checkpoint,
dataset, dataloader, training, optimizer, scheduler, loss and network
sections), the optimizers (adamw, sgd) and schedules (none, step, cosine,
warmup_cosine, poly) of ``build_optimizer`` / ``build_schedule`` on
train/optim.py, the three loss types, gradient accumulation, a
``pseudo_labeler`` hook for unlabeled batches (train/teachers.py), mIoU
validation, resume, the ``last`` and ``best_mIoU`` msgpack files and a
``metrics.jsonl`` log (TensorBoard and W&B when they are installed and
asked for).

The JAX trainer is one jitted SPMD step over a mesh; this one runs
train/train_step.py's step, on one card or over a world mesh (a process a
card; the validation's confusion matrix summed over the ranks, and the
files written by rank 0). It keeps its training state with
export/checkpoints.py's
``save_checkpoint`` (the port's ``path/step_N``, where JAX uses orbax), and
resumes from ``checkpoint.load_from`` with ``load_checkpoint``.
"""
from __future__ import annotations

import json
import pathlib
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..convert.from_jax import state_dict_to_variables
from ..export.checkpoints import load_checkpoint, save_checkpoint, save_msgpack
from ..ops.preprocess import device_mean_std
from ..parallel.sharding import cross_replica_psum, eval_rows
from . import optim
from .losses import lanes_bce_edge_loss, segmentation_ce_loss, ssi_mae_depth_loss
from .metrics import confusion_matrix, miou_from_confusion
from .train_step import create_seg_train_state, data_mesh, load_variables, make_seg_train_step


def load_experiment_config(path: str | pathlib.Path) -> Dict[str, Any]:
    """A YAML experiment config (configs/*Lite.yaml) -> its dict."""
    import yaml  # PyYAML: only the config readers need it

    with open(path) as f:
        return yaml.safe_load(f)


def build_optimizer(cfg: Dict[str, Any], schedule) -> Callable:
    """The config's optimizer: adamw (betas, weight_decay) or sgd (optax's
    chain of add_decayed_weights and sgd with momentum); a factory over the
    parameters (train/optim.py)."""
    o = cfg.get("optimizer", {})
    typ = o.get("type", "adamw")
    wd = float(o.get("weight_decay", 1e-2))
    if typ == "adamw":
        betas = o.get("betas", [0.9, 0.999])
        return optim.adamw(schedule, b1=betas[0], b2=betas[1], weight_decay=wd)
    if typ == "sgd":
        return optim.sgd(schedule, momentum=float(o.get("momentum", 0.9)), weight_decay=wd)
    raise ValueError(f"unknown optimizer {typ}")


def build_schedule(cfg: Dict[str, Any]):
    """The config's learning rate: a float (``none``) or a schedule of the
    update count (step, cosine, warmup_cosine, poly)."""
    s = cfg.get("scheduler", {})
    lr = float(cfg.get("optimizer", {}).get("lr", 1e-4))
    typ = s.get("type", "none")
    max_steps = int(cfg.get("training", {}).get("max_steps", 100000))
    if typ in ("none", None):
        return lr
    if typ == "step":
        return optim.exponential_decay(lr, transition_steps=int(s.get("step_size", 30)),
                                       decay_rate=float(s.get("gamma", 0.1)), staircase=True)
    if typ == "cosine":
        return optim.cosine_decay_schedule(lr, max_steps, alpha=float(s.get("min_lr", 1e-6)) / lr)
    if typ == "warmup_cosine":
        warm = int(s.get("warmup_steps", 1000))
        return optim.warmup_cosine_decay_schedule(0.0, lr, warm, max_steps,
                                                  end_value=float(s.get("min_lr", 1e-6)))
    if typ == "poly":
        return optim.polynomial_schedule(lr, float(s.get("min_lr", 1e-6)), power=0.9,
                                         transition_steps=max_steps)
    raise ValueError(f"unknown scheduler {typ}")


class LiteTrainer:
    """Config-driven dense trainer. ``batch_iter()`` yields (images_u8 (B, H,
    W, 3) numpy, labels) forever; ``val_iter()`` yields the validation set
    once a call. Labels are (B, H, W) class ids (cross_entropy, depth_ssi)
    or (B, H, W, C) masks (lanes_bce), JAX's NHWC; a batch whose labels
    are None goes through ``pseudo_labeler(images_u8) -> labels`` (the
    DepthAnythingV2 pseudo-labeling path, lite_trainer_base.py:249-278).
    The model's weights are ``variables`` (a JAX tree) or seeded from the
    config's ``experiment.seed``; it moves to ``device``. ``mesh``: a world
    mesh to train over (every rank iterates the same batches), or None."""

    def __init__(self, model, cfg: Dict[str, Any], batch_iter: Callable,
                 val_iter: Optional[Callable] = None, input_hw=(512, 1024),
                 num_classes: Optional[int] = None, mesh=None,
                 pseudo_labeler: Optional[Callable] = None, *,
                 variables: Optional[dict] = None, device="cuda"):
        self.mesh = data_mesh(mesh)
        self.main_process = self.mesh is None or self.mesh.rank == 0
        self.pseudo_labeler = pseudo_labeler
        self.cfg = cfg
        self.batch_iter = batch_iter
        self.val_iter = val_iter
        self.input_hw = input_hw
        self.device = torch.device(device)
        loss_cfg = cfg.get("loss", {})
        self.num_classes = num_classes or int(loss_cfg.get("num_classes", 3))
        self.ignore_index = loss_cfg.get("ignore_index", None)
        aw = loss_cfg.get("apply_weights", {})
        self.class_weights = (torch.tensor(aw["values"], dtype=torch.float32, device=self.device)
                              if aw and aw.get("enabled") else None)
        self.out_dir = pathlib.Path(cfg.get("experiment", {}).get("output_dir", "runs/lite"))
        if self.main_process:
            self.out_dir.mkdir(parents=True, exist_ok=True)

        seed = int(cfg.get("experiment", {}).get("seed", 42))
        self.model = load_variables(model, variables, seed).to(self.device,
                                                                memory_format=torch.channels_last)
        self.schedule = build_schedule(cfg)
        self.state = create_seg_train_state(self.model, build_optimizer(cfg, self.schedule))
        self.generator = torch.Generator(device=self.device).manual_seed(seed + 1)
        self.loss_type = loss_cfg.get("type", "cross_entropy")
        micro = int(cfg.get("training", {}).get("grad_accum_steps", 1))
        self.run_step = make_seg_train_step(self._loss_fn(loss_cfg), mesh=self.mesh,
                                            microbatches=micro)
        self._mean, self._std = (t.reshape(1, 3, 1, 1) for t in device_mean_std(self.device))
        self.best_miou = -1.0
        self._maybe_resume()
        self._init_loggers()

    def _loss_fn(self, loss_cfg):
        """The loss of the config's task family (the reference's
        scene_seg_lite / scene3d_lite / ego_lanes_lite trainers as one
        switch), on NCHW logits and the device targets."""
        if self.loss_type == "depth_ssi":
            edge_scale = float(loss_cfg.get("edge_scale", 1.0))
            return lambda logits, t: ssi_mae_depth_loss(logits, t, edge_scale)[0]
        if self.loss_type == "lanes_bce":
            return lambda logits, t: lanes_bce_edge_loss(logits, t)[0]

        def ce_loss(logits, targets):
            if self.ignore_index is None:
                return segmentation_ce_loss(logits, targets, self.class_weights)
            valid = targets != self.ignore_index
            onehot = F.one_hot(torch.where(valid, targets, 0).long(), self.num_classes)
            onehot = (onehot.to(logits.dtype) * valid[..., None]).permute(0, 3, 1, 2)
            return segmentation_ce_loss(logits, onehot, self.class_weights)
        return ce_loss

    def normalized(self, images_u8: np.ndarray) -> torch.Tensor:
        """(B, H, W, 3) uint8 -> (B, 3, H, W) f32 ImageNet-normalized on the
        device, channels_last."""
        x = torch.from_numpy(np.ascontiguousarray(images_u8)).to(self.device)
        return (x.permute(0, 3, 1, 2).float() / 255.0 - self._mean) / self._std

    def targets(self, labels) -> torch.Tensor:
        """JAX's label layout -> the loss's: (B, H, W) ids stay (depth:
        (B, 1, H, W)), (B, H, W, C) masks become NCHW."""
        t = torch.as_tensor(np.ascontiguousarray(labels)).to(self.device)
        if t.dim() == 4:
            return t.permute(0, 3, 1, 2)
        return t[:, None] if self.loss_type == "depth_ssi" else t

    # -- checkpointing / resume --
    def _ckpt_dir(self) -> pathlib.Path:
        return self.out_dir / "checkpoints"

    def _maybe_resume(self):
        load_from = (self.cfg.get("checkpoint", {}) or {}).get("load_from")
        if load_from:
            self.state = load_checkpoint(load_from, self.state)
            print(f"[lite] resumed from {load_from} at step {int(self.state.step)}")

    def _init_loggers(self):
        self._wandb = self._tb = self._metrics_file = None
        if not self.main_process:
            return
        w = self.cfg.get("experiment", {}).get("wandb") or {}
        if w.get("enabled"):
            try:
                import wandb
                self._wandb = wandb.init(project=w.get("project_name", "avp_tpu"),
                                         config=self.cfg)
            except Exception as e:  # offline or not installed: train without it
                print(f"[lite] wandb disabled ({e})")
        # TensorBoard (the reference's SummaryWriter) where it is installed;
        # the JSONL log always
        try:
            from torch.utils.tensorboard import SummaryWriter
            self._tb = SummaryWriter(str(self.out_dir / "tb"))
        except ImportError:
            pass
        self._metrics_file = open(self.out_dir / "metrics.jsonl", "a")

    def close(self):
        """Close the metrics log and the TensorBoard writer."""
        if self._metrics_file:
            self._metrics_file.close()
        if self._tb:
            self._tb.close()

    def _log_scalar(self, name: str, value: float, step: int):
        if not self.main_process:
            return
        self._metrics_file.write(json.dumps({"step": step, name: value}) + "\n")
        self._metrics_file.flush()
        if self._tb:
            self._tb.add_scalar(name, value, step)
        if self._wandb:
            self._wandb.log({name: value}, step=step)

    def _save_weights(self, name: str):
        if self.main_process:
            save_msgpack(self.out_dir / name, state_dict_to_variables(self.model))

    # -- training --
    def fit(self, max_steps: Optional[int] = None):
        t = self.cfg.get("training", {})
        max_steps = max_steps or int(t.get("max_steps", 1000))
        val_every = int(t.get("validation", {}).get("every_n_steps", 0) or 0)
        log_every = int(t.get("logging", {}).get("log_every_steps", 50))
        it = self.batch_iter()
        for step in range(int(self.state.step), max_steps):
            images, labels = next(it)
            if labels is None:
                if self.pseudo_labeler is None:
                    raise ValueError("unlabeled batch but no pseudo_labeler")
                labels = self.pseudo_labeler(images)
            self.state, loss = self.run_step(self.state, self.normalized(images),
                                             self.targets(labels), self.generator)
            if (step + 1) % log_every == 0 and self.main_process:
                value = float(loss)
                print(f"[lite] step {step + 1} loss {value:.4f}")
                self._log_scalar("train/loss", value, step + 1)
            if val_every and (step + 1) % val_every == 0:
                self.validate(step + 1)
        if t.get("save_last", True) and self.main_process:
            self._save_weights("last.msgpack")
            save_checkpoint(self._ckpt_dir(), self.state)
        return self.state

    @torch.no_grad()
    def validate(self, step: int):
        """mIoU over ``val_iter()`` (cross_entropy only; the dense
        regressions validate on their loss), logged; a new best is saved as
        best_mIoU.msgpack. Over a world mesh each rank scores its rows of
        each batch and the confusion matrix is summed over the ranks. -> the
        mIoU or None."""
        if self.val_iter is None or self.loss_type != "cross_entropy":
            return None
        self.model.eval()
        cm_total = None
        for images, labels in self.val_iter():
            rows = eval_rows(self.mesh, len(images))
            cm = np.zeros((self.num_classes, self.num_classes), np.int64)
            if rows.stop > rows.start:
                pred = self.model(self.normalized(images[rows])).argmax(1).cpu().numpy()
                cm = confusion_matrix(pred, np.asarray(labels)[rows], self.num_classes,
                                      ignore_index=self.ignore_index)
            cm_total = cm if cm_total is None else cm_total + cm
        if cm_total is None:
            return None
        if self.mesh is not None:
            cm_total = cross_replica_psum(torch.from_numpy(np.asarray(cm_total)).to(self.device),
                                          self.mesh).cpu().numpy()
        _, miou, overall = miou_from_confusion(cm_total)
        if self.main_process:
            print(f"[lite] step {step} val mIoU {miou:.4f} overall {overall:.4f}")
        self._log_scalar("val/miou", miou, step)
        self._log_scalar("val/overall", overall, step)
        if miou > self.best_miou and self.cfg.get("training", {}).get("save_best", True):
            self.best_miou = miou
            self._save_weights("best_mIoU.msgpack")
        return miou
