"""Validation-as-test: the mIoU of a checkpoint over unified datasets (the
Models/training/test_validate_scene_seg.py analog), the port of
tools/validate_checkpoint.py.

Each ``--data <root>:<DATASET>`` is a unified directory
(``<root>/images``, ``<root>/labels``) read by ``SceneSegDataset``; its
validation split (every tenth sample) goes through ``batched_loader`` at
320x640, the ImageNet normalization and SceneSeg in f32, and one confusion
matrix sums every batch of every dataset. The checkpoint is a flax msgpack
file (export/checkpoints.py); a tree in the int8 deployment format (a QAT
export's, tools/qat_closure.py) runs its int8 convs on the int8 kernels
(export/quantize.py::int8_like). Without one the weights come from seed 0.

Run: python -m autoware_vision_pilot_tpu_torch.tools.validate_checkpoint
     --model SceneSeg --checkpoint w.msgpack --data <root>:<DATASET>
     [--data ...] [--batch 4] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import sys
from typing import Callable, Optional, Sequence

import numpy as np
import torch
from torch import nn

CLASS_NAMES = ["background", "foreground", "road"]


def load_model(make_model: Callable[[], nn.Module], checkpoint: str, device) -> nn.Module:
    """make_model() with the weights of ``checkpoint`` (int8 convs where the
    tree has them), else seed 0's, on ``device`` in f32, eval mode."""
    from ..export.checkpoints import load_msgpack
    from ..export.quantize import int8_like
    from ..inference.infer import load_weights

    model = make_model()
    variables = None
    if checkpoint:
        variables = load_msgpack(checkpoint)
        int8_like(model, variables)
    return load_weights(model, variables, device=device, dtype=torch.float32)


@torch.inference_mode()
def class_ids(model: nn.Module, images_u8: np.ndarray, device) -> np.ndarray:
    """(B, h, w, 3) uint8 RGB -> / 255, ImageNet mean and std, the f32
    forward, argmax -> (B, h, w) class ids on the host."""
    from ..ops.preprocess import IMAGENET_MEAN, IMAGENET_STD

    x = torch.from_numpy(np.ascontiguousarray(images_u8)).to(device).float() / 255.0
    x = (x - IMAGENET_MEAN.to(device)) / IMAGENET_STD.to(device)
    out = model(x.permute(0, 3, 1, 2))
    return torch.argmax(out, dim=1).cpu().numpy()


def run(data: Sequence[str], checkpoint: str = "", batch: int = 4, device="cuda", *,
        make_model: Optional[Callable[[], nn.Module]] = None, hw=(320, 640)):
    """-> (the summed confusion matrix, per-class IoU, mIoU, overall pixel
    accuracy); prints each dataset and the per-class lines."""
    from ..models import SceneSegNetwork
    from ..train import SceneSegDataset, confusion_matrix, miou_from_confusion
    from ..train.datasets import batched_loader

    device = torch.device(device)
    model = load_model(make_model or SceneSegNetwork, checkpoint, device)
    cm_total = None
    for spec in data:
        root, name = spec.rsplit(":", 1)
        ds = SceneSegDataset(f"{root}/images", f"{root}/labels", name)
        n_val = ds.item_count()[1]
        for imgs, labs, _ in batched_loader(ds, range(n_val), batch, hw, train=False):
            cm = confusion_matrix(class_ids(model, imgs, device), labs, 3)
            cm_total = cm if cm_total is None else cm_total + cm
        print(f"[val] {name}: done ({n_val} samples)")

    iou, miou, overall = miou_from_confusion(cm_total)
    for n, v in zip(CLASS_NAMES, iou):
        print(f"  IoU {n}: {v:.4f}")
    print(f"mIoU: {miou:.4f}  overall: {overall:.4f}")
    return cm_total, iou, miou, overall


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="SceneSeg")
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--data", action="append", required=True,
                    help="<root>:<DATASET_NAME>, repeatable")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    run(a.data, a.checkpoint, a.batch, a.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
