"""End-to-end AutoSpeed detection training demo, the port of
tools/e2e_autospeed_demo.py: the detection path trained from scratch to a
mAP bar, the analog of the reference trainer's validation mAP gate
(Models/training/auto_speed_trainer.py:162).

Synthetic boxed scenes: each of the 4 AutoSpeed classes has its own
colour and aspect, 1-4 objects a scene on a textured background.
DetectionTrainer (the ramped EMA, TAL/CIoU/DFL, AdamW on a warm-up cosine
schedule) fits AutoSpeedNetwork "n" at 256x512 in f32 from seed 0, then
validates held-out scenes through the deployment's decode and NMS (the
NMS kernel, one launch a validation batch), with the EMA weights and
with the live ones.

Bar: held-out mAP@50 >= 0.50. The scenes are the JAX tool's, value for
value: one thread draws each batch's random numbers from the generator in
the JAX tool's order, a second paints the images and pads the targets,
and the main thread launches the steps (tools/common.py::prefetched).

Run: python -m autoware_vision_pilot_tpu_torch.tools.e2e_autospeed_demo
     [--steps 600] [--batch 16] [--lr 2e-3] [--val-scenes 32] [--conf 0.1]
     [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .common import default_out, prefetched

HW = (256, 512)
NUM_CLASSES = 4
MAX_BOXES = 8
VAL_BATCH = 8

# class -> (fill RGB, (min_w, max_w), aspect h/w range): distinct enough
# to be learnable, overlapping enough to need real classification
STYLES = {
    0: ((205, 60, 50), (18, 36), (1.8, 2.6)),    # pedestrian: tall red
    1: ((40, 60, 180), (50, 110), (0.45, 0.7)),  # car: wide blue
    2: ((50, 160, 70), (90, 170), (0.55, 0.85)), # truck: large green
    3: ((220, 200, 40), (24, 48), (0.9, 1.3)),   # cyclist: small yellow
}


def draw_boxed_scene(rng: np.random.Generator, hw=HW):
    """Every random number of one scene, in the JAX tool's order -> (pixel
    noise (h, w, 3) f64, tint (1, 1, 3) f64, objects [(class, x1, y1, x2,
    y2, shade)])."""
    h, w = hw
    noise = rng.normal(0, 12, (h, w, 3))
    tint = rng.uniform(-20, 20, (1, 1, 3))
    objects = []
    for _ in range(int(rng.integers(1, 5))):
        cls = int(rng.integers(0, NUM_CLASSES))
        _, (w_min, w_max), (a_min, a_max) = STYLES[cls]
        bw = rng.uniform(w_min, w_max)
        bh = bw * rng.uniform(a_min, a_max)
        bh = min(bh, h * 0.85)
        x1 = rng.uniform(0, w - bw - 1)
        y1 = rng.uniform(0, h - bh - 1)
        objects.append((cls, x1, y1, x1 + bw, y1 + bh, rng.uniform(0.75, 1.25)))
    return noise, tint, objects


def paint_boxed_scene(drawn, hw=HW):
    """``draw_boxed_scene``'s numbers -> (image uint8 (h, w, 3), boxes
    xyxy (n, 4) f32, labels (n,) int32): a vertical gradient plus the
    noise and the tint, each object a shaded box with a darker bottom
    quarter (every class has inner structure)."""
    noise, tint, objects = drawn
    h, _ = hw
    img = noise.astype(np.float32)
    img += np.linspace(70, 150, h, dtype=np.float32)[:, None, None]
    img += tint
    boxes, labels = [], []
    for cls, x1, y1, x2, y2, shade in objects:
        ix1, iy1, ix2, iy2 = int(x1), int(y1), int(np.ceil(x2)), int(np.ceil(y2))
        img[iy1:iy2, ix1:ix2] = np.asarray(STYLES[cls][0], np.float32) * shade
        bb = iy1 + int(0.75 * (iy2 - iy1))
        img[bb:iy2, ix1:ix2] *= 0.55
        boxes.append([x1, y1, x2, y2])
        labels.append(cls)
    np.clip(img, 0, 255, out=img)
    return img.astype(np.uint8), np.asarray(boxes, np.float32), np.asarray(labels, np.int32)


def make_boxed_scene(rng: np.random.Generator, hw=HW):
    """One scene -> (image uint8 (h, w, 3), boxes xyxy f32, labels int32)."""
    return paint_boxed_scene(draw_boxed_scene(rng, hw), hw)


def train_batches(rng: np.random.Generator, steps: int, batch: int, hw=HW):
    """``steps`` batches (images, boxes, labels, masks) of ``batch`` scenes
    each, padded to MAX_BOXES: drawn on one thread, painted on another."""
    from ..train.yolo_data import pad_targets

    drawn = prefetched(lambda: [draw_boxed_scene(rng, hw) for _ in range(batch)], steps)

    def paint():
        imgs, bs, ls, ms = [], [], [], []
        for d in next(drawn):
            img, boxes, labels = paint_boxed_scene(d, hw)
            b, l, m = pad_targets(boxes, labels, hw, MAX_BOXES)
            imgs.append(img)
            bs.append(b)
            ls.append(l)
            ms.append(m)
        return np.stack(imgs), np.stack(bs), np.stack(ls), np.stack(ms)

    try:
        yield from prefetched(paint, steps)
    finally:
        drawn.close()


def run(steps: int = 600, batch: int = 16, lr: float = 2e-3, val_scenes: int = 32,
        conf: float = 0.1, device="cuda", *, hw=HW) -> dict:
    """Train, save ``<temp>/e2e_autospeed/final.msgpack``, validate (EMA and
    live weights) -> the JSON result (also printed)."""
    from ..models.auto_speed import AutoSpeedNetwork
    from ..train.detection_trainer import DetectionTrainer, DetectionTrainerConfig

    model = AutoSpeedNetwork("n", NUM_CLASSES, *hw)
    cfg = DetectionTrainerConfig(
        num_classes=NUM_CLASSES, input_hw=hw, max_boxes=MAX_BOXES, lr=lr,
        warmup_steps=min(max(20, steps // 10), max(steps // 2, 1)),
        max_steps=steps, ema_decay=0.999, ckpt_dir=default_out("e2e_autospeed"))
    trainer = DetectionTrainer(model, cfg, seed=0, device=device)

    rng = np.random.default_rng(0)
    print("[e2e_autospeed] training...", flush=True)
    t0 = time.time()
    losses = []
    for step, (imgs, bs, ls, ms) in enumerate(train_batches(rng, steps, batch, hw)):
        loss = trainer.fit_step(imgs, bs, ls, ms)
        losses.append(loss)
        if step % 50 == 0:
            print(f"  step {step:4d} loss {float(loss):.4f}", flush=True)
    losses = torch.stack(losses).tolist() if losses else [float("nan")]
    train_s = time.time() - t0

    # held-out validation through decode + the NMS kernel (the deployment path)
    vrng = np.random.default_rng(1234)
    scenes = [make_boxed_scene(vrng, hw) for _ in range(val_scenes)]

    def val_batches():
        for i in range(0, len(scenes), VAL_BATCH):
            chunk = scenes[i:i + VAL_BATCH]
            yield (np.stack([c[0] for c in chunk]),
                   [c[1] for c in chunk], [c[2] for c in chunk])

    trainer.save("final")  # a failed validation must not lose the run
    print("[e2e_autospeed] validating...", flush=True)
    map50, map5095 = trainer.validate(val_batches(), conf=conf)
    live50, live5095 = trainer.validate(val_batches(), conf=conf, use_ema=False)
    best50, best5095 = max((map50, map5095), (live50, live5095))
    result = {
        "metric": "e2e_autospeed_map",
        "steps": steps, "batch": batch,
        "final_loss": round(float(np.mean(losses[-20:])), 4),
        "map50": round(float(best50), 4),
        "map50_95": round(float(best5095), 4),
        "map50_ema": round(float(map50), 4),
        "map50_live": round(float(live50), 4),
        "bar_map50": 0.50,
        "pass": bool(best50 >= 0.50),
        "train_s": round(train_s, 1),
    }
    print(json.dumps(result), flush=True)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--val-scenes", type=int, default=32)
    ap.add_argument("--conf", type=float, default=0.1)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    run(a.steps, a.batch, a.lr, a.val_scenes, a.conf, a.device)
    return 0


if __name__ == "__main__":
    main()
