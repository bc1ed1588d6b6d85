"""End-to-end training demo, the port of tools/e2e_train_demo.py: synthetic
scenes -> SceneSeg training -> mIoU improvement -> checkpoint save/reload
-> inference -> visualization frame.

Exercises the whole loop (the train step, the metrics, the msgpack
checkpoints, an eval-mode forward, the visualization) in one run and
prints a JSON summary with the JAX tool's keys. The synthetic road scenes
come from tools/gen_synthetic_dataset.py::make_scene (sky, road and
vehicle regions in the SceneSeg colour code). The recipe is the JAX
tool's: 48 training and 8 validation scenes at 320x640, each drawn from a
generator seeded by its index, batches by ``rng.choice`` of
``np.random.default_rng(0)``, AdamW 3e-4 (optax's, train/train_step.py),
bf16 compute over f32 weights, the dropout masks from a generator seeded
1, the weights from seed 0 (nn/layers.py::init_seeded).

Run: python -m autoware_vision_pilot_tpu_torch.tools.e2e_train_demo
     [--steps 60] [--batch 8] [--out DIR] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import pathlib
import time
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from .common import default_out

CL = torch.channels_last
N_TRAIN, N_VAL = 48, 8
VAL_SEED0 = 10_000  # validation scene i is drawn from default_rng(VAL_SEED0 + i)


def seg_sample(i: int, hw=(320, 640)):
    """Scene ``i`` -> (image (h, w, 3) f32 in [0, 1], class ids (h, w)
    int32), from its own generator: the split is pinned by index, not by
    the order of construction."""
    from ..train.datasets import decode_scene_seg_mask
    from .gen_synthetic_dataset import make_scene

    img, lab = make_scene(np.random.default_rng(i), hw)
    ids, _weights = decode_scene_seg_mask(lab)
    return img.astype(np.float32) / 255.0, ids.astype(np.int32)


def to_device(x_nhwc: np.ndarray, device) -> torch.Tensor:
    """(B, h, w, 3) f32 on the host -> (B, 3, h, w) channels_last on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(x_nhwc)).to(device).permute(0, 3, 1, 2)


def seeded_model(make_model: Callable[[], nn.Module], seed: int, device) -> nn.Module:
    """make_model() on the CPU in f32, its weights drawn from ``seed``, moved
    to ``device`` in channels_last."""
    from ..nn.layers import init_seeded

    model = init_seeded(make_model(), torch.Generator().manual_seed(seed))
    return model.to(device, memory_format=CL)


@torch.inference_mode()
def predict(model: nn.Module, x: torch.Tensor) -> np.ndarray:
    """The eval-mode forward of ``x`` (B, 3, h, w) in bf16 compute over the
    weights as they are (autocast, as the train step computes) -> argmax
    class ids (B, h, w) int32 on the host."""
    mode = model.training
    model.eval()
    try:
        with torch.autocast(x.device.type, dtype=torch.bfloat16):
            logits = model(x.to(memory_format=CL))
    finally:
        model.train(mode)
    return torch.argmax(logits.float(), dim=1).to(torch.int32).cpu().numpy()


def miou_of(pred: np.ndarray, gt: np.ndarray) -> float:
    """The JAX tools' validation mIoU: per-image confusion matrices summed,
    then ``miou_from_confusion``."""
    from ..train.metrics import confusion_matrix, miou_from_confusion

    cm = sum(confusion_matrix(pred[i], gt[i], 3) for i in range(len(gt)))
    return miou_from_confusion(cm)[1]


def batch_indices(rng: np.random.Generator, n_train: int, batch: int) -> np.ndarray:
    """One step's training indices, as the JAX tool draws them."""
    return rng.choice(n_train, batch, replace=False)


def run(steps: int = 60, batch: int = 8, out: Optional[str] = None, device="cuda", *,
        make_model: Optional[Callable[[], nn.Module]] = None, hw=(320, 640)) -> dict:
    """Train, validate, round-trip the checkpoint and draw the overlay ->
    the JSON summary (also printed). ``make_model`` builds the SceneSeg
    network on the CPU (default: full width and depth for 320x640); ``hw``
    is the scenes' size."""
    from ..export.checkpoints import load_msgpack, save_msgpack
    from ..convert.from_jax import state_dict_to_variables, variables_to_state_dict
    from ..models import SceneSegNetwork
    from ..train import create_seg_train_state, make_seg_train_step, segmentation_ce_loss
    from ..train.train_step import adamw

    device = torch.device(device)
    make_model = make_model or SceneSegNetwork
    out_dir = pathlib.Path(out or default_out("e2e_train_demo"))
    out_dir.mkdir(parents=True, exist_ok=True)

    # --- data ------------------------------------------------------------
    rng = np.random.default_rng(0)
    train = [seg_sample(i, hw) for i in range(N_TRAIN)]
    val = [seg_sample(VAL_SEED0 + i, hw) for i in range(N_VAL)]
    train_x = to_device(np.stack([t[0] for t in train]), device)
    train_y = torch.from_numpy(np.stack([t[1] for t in train])).to(device)
    val_x = to_device(np.stack([v[0] for v in val]), device)
    val_y = np.stack([v[1] for v in val])

    # --- model + train step ----------------------------------------------
    model = seeded_model(make_model, 0, device)
    state = create_seg_train_state(model, adamw(3e-4))
    step_fn = make_seg_train_step(segmentation_ce_loss, compute_dtype=torch.bfloat16)
    miou_before = miou_of(predict(model, val_x), val_y)

    # --- train -----------------------------------------------------------
    generator = torch.Generator(device=device).manual_seed(1)
    losses = []
    t0 = time.perf_counter()
    for _ in range(steps):
        idx = torch.from_numpy(batch_indices(rng, N_TRAIN, batch)).to(device)
        state, loss = step_fn(state, train_x[idx].contiguous(memory_format=CL), train_y[idx],
                              generator)
        losses.append(loss)
    losses = torch.stack(losses).tolist() if losses else []
    train_s = time.perf_counter() - t0
    pred = predict(model, val_x)
    miou_after = miou_of(pred, val_y)

    # --- checkpoint round trip -------------------------------------------
    ckpt = out_dir / "scene_seg_demo.msgpack"
    save_msgpack(ckpt, state_dict_to_variables(model))
    restored = seeded_model(make_model, 1, "cpu")
    restored.load_state_dict(variables_to_state_dict(load_msgpack(ckpt), restored), strict=True)
    restored.to(device, memory_format=CL)
    pred2 = predict(restored, val_x[:1])
    pred1 = predict(model, val_x[:1])
    if not (pred1 == pred2).all():
        raise AssertionError("checkpoint round-trip changed outputs")

    # --- visualization frame ---------------------------------------------
    try:
        import cv2
        from ..utils.visualization import SCENE_SEG_PALETTE, blend
        color = SCENE_SEG_PALETTE[pred1[0] % len(SCENE_SEG_PALETTE)]
        frame = (val[0][0] * 255).astype(np.uint8)
        cv2.imwrite(str(out_dir / "val0_overlay.png"),
                    blend(np.ascontiguousarray(frame[..., ::-1]),
                          np.ascontiguousarray(color[..., ::-1])))
        viz_ok = True
    except Exception as e:  # no cv2 on the host, palette drift: not fatal
        viz_ok = f"skipped: {e}"

    result = {
        "metric": "e2e_train_demo",
        "loss_first5": [round(x, 4) for x in losses[:5]],
        "loss_last5": [round(x, 4) for x in losses[-5:]],
        "miou_before": round(miou_before, 4),
        "miou_after": round(miou_after, 4),
        "train_seconds": round(train_s, 1),
        "steps": steps, "batch": batch,
        "checkpoint_roundtrip": "identical",
        "viz": viz_ok,
    }
    print(json.dumps(result), flush=True)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--out", default=default_out("e2e_train_demo"))
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    run(a.steps, a.batch, a.out, a.device)
    return 0


if __name__ == "__main__":
    main()
