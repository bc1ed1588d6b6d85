"""End-to-end AutoSteerTemporalNet training demo, the port of
tools/e2e_autosteer_demo.py: synthetic curved-lane EgoLanes mask sequences
with steering labels from their geometry -> AutoSteerTemporalTrainer ->
held-out steering-class accuracy.

Bar: held-out current-angle accuracy within +/-1 class (+/-1 degree) of
at least 0.90, and both heads beating the always-straight baseline.

The masks are drawn with numpy on the host, the same values as the JAX
tool's for the same generator; a producer thread builds the next batches
from that generator, in order, while the card runs the step
(tools/common.py::prefetched).

Run: python -m autoware_vision_pilot_tpu_torch.tools.e2e_autosteer_demo
     [--steps 400] [--batch 64] [--n-val 256] [--lr 1e-3] [--out DIR]
     [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import pathlib
import time
from typing import Optional

import numpy as np
import torch

from .common import default_out, prefetched


def render_lane_masks(angle_deg: float, rng: np.random.Generator,
                      h: int = 80, w: int = 160) -> np.ndarray:
    """Synthetic EgoLanes-style mask triple (h, w, 3) f32 for a steering
    angle: the lanes curve laterally with the angle (the lateral offset
    grows with the square of the distance ahead) and converge toward the
    horizon (row 0). Channels: left lane, right lane, ego path, the layout
    the EgoLanes head emits at 1/4 resolution; then 8 % dropouts and 0.3 %
    speckle. The JAX tool's arithmetic, a row at a time, for all rows at
    once."""
    out = np.zeros((h, w, 3), np.float32)
    lane_half_px = 26.0 + rng.uniform(-3, 3)
    cx = w / 2 + rng.uniform(-6, 6)
    # curvature: +30 deg steers the lane pair ~55 px left at the horizon
    curve = -angle_deg / 30.0 * 55.0
    jitter = rng.uniform(-1.5, 1.5, size=3)
    rows = np.arange(h)
    depth = 1.0 - rows / (h - 1)          # 1 at the horizon, 0 at the bumper
    offset = curve * depth * depth
    half = lane_half_px * (0.35 + 0.65 * (1.0 - depth))
    for ch, lane_x in enumerate((cx + offset - half, cx + offset + half, cx + offset)):
        x = np.round(lane_x + jitter[ch]).astype(np.int64)
        on = (x >= 0) & (x < w)
        for dx in (-1, 0, 1):
            col = x + dx
            keep = on & (col >= 0) & (col < w)
            out[rows[keep], col[keep], ch] = 1.0
    out[rng.random((h, w)) < 0.08] = 0.0  # the JAX tool's (h, w, 1) draw, in place
    speck = rng.random((h, w, 3)) < 0.003
    return np.clip(out + speck, 0.0, 1.0)


def make_pair(rng: np.random.Generator):
    """One training sample: stacked (80, 160, 6) masks for frames (t-1, t)
    and their two steering labels. The angle moves by at most 2 degrees
    between frames, as it does at 10 Hz in the runtime."""
    prev = float(rng.uniform(-28, 28))
    curr = float(np.clip(prev + rng.uniform(-2, 2), -30, 30))
    m_prev = render_lane_masks(prev, rng)
    m_curr = render_lane_masks(curr, rng)
    return np.concatenate([m_prev, m_curr], axis=-1), prev, curr


def make_batch(rng: np.random.Generator, batch: int):
    """``batch`` pairs -> (x (B, 80, 160, 6), prev (B,), curr (B,))."""
    pairs = [make_pair(rng) for _ in range(batch)]
    return (np.stack([p[0] for p in pairs]), np.array([p[1] for p in pairs]),
            np.array([p[2] for p in pairs]))


@torch.inference_mode()
def predict(model, x_nhwc: np.ndarray, device):
    """The eval-mode forward -> (prev, curr) steering in degrees, numpy."""
    from ..models.auto_steer_temporal import steering_from_logits

    model.eval()
    x = torch.from_numpy(np.ascontiguousarray(x_nhwc, np.float32)).to(device)
    prev_l, curr_l = model(x.permute(0, 3, 1, 2))
    return (steering_from_logits(prev_l).cpu().numpy(),
            steering_from_logits(curr_l).cpu().numpy())


def run(steps: int = 400, batch: int = 64, n_val: int = 256, lr: float = 1e-3,
        out: Optional[str] = None, device="cuda") -> dict:
    """Train from seed 0 on ``np.random.default_rng(0)``'s pairs, validate on
    ``n_val`` pairs of ``default_rng(999_001)`` -> the JSON result (printed,
    and written to ``out/result.json`` beside ``out/final.msgpack``)."""
    from ..train.autosteer_temporal_trainer import (AutoSteerTemporalTrainer,
                                                    AutoSteerTemporalTrainerConfig)

    out = out or default_out("e2e_autosteer")
    rng = np.random.default_rng(0)
    val_rng = np.random.default_rng(999_001)
    val_x, val_prev, val_curr = make_batch(val_rng, n_val)

    cfg = AutoSteerTemporalTrainerConfig(lr=lr, max_steps=steps, ckpt_dir=out)
    trainer = AutoSteerTemporalTrainer(cfg, seed=0, device=device)

    t0 = time.perf_counter()
    losses = []
    for step, (x, prev, curr) in enumerate(prefetched(lambda: make_batch(rng, batch), steps)):
        loss = trainer.fit_step(x, prev, curr)
        losses.append(loss)
        if step % 50 == 0:
            print(f"[autosteer_demo] step {step} loss {float(loss):.4f}", flush=True)
    losses = torch.stack(losses).tolist() if losses else [float("nan")]
    train_s = time.perf_counter() - t0

    pred_prev, pred_curr = predict(trainer.model, val_x, trainer.device)
    err_prev = np.abs(pred_prev - np.round(val_prev))
    err_curr = np.abs(pred_curr - np.round(val_curr))
    base_err = np.abs(np.round(val_curr))  # the always-straight baseline

    trainer.save("final")
    result = {
        "metric": "autosteer_temporal_e2e_training",
        "steps": steps, "batch": batch,
        "loss_first": round(float(np.mean(losses[:10])), 4),
        "loss_last": round(float(np.mean(losses[-10:])), 4),
        "val_curr_acc_exact": round(float((err_curr == 0).mean()), 4),
        "val_curr_acc_1deg": round(float((err_curr <= 1).mean()), 4),
        "val_curr_acc_2deg": round(float((err_curr <= 2).mean()), 4),
        "val_prev_acc_1deg": round(float((err_prev <= 1).mean()), 4),
        "val_curr_mae_deg": round(float(err_curr.mean()), 3),
        "baseline_straight_mae_deg": round(float(base_err.mean()), 3),
        "train_s": round(train_s, 1),
        "bar_acc_1deg_ge": 0.90,
        "bar_met": bool((err_curr <= 1).mean() >= 0.90),
    }
    print(json.dumps(result), flush=True)
    path = pathlib.Path(out)
    path.mkdir(parents=True, exist_ok=True)
    (path / "result.json").write_text(json.dumps(result, indent=1))
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--n-val", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--out", default=default_out("e2e_autosteer"))
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    run(a.steps, a.batch, a.n_val, a.lr, a.out, a.device)
    return 0


if __name__ == "__main__":
    main()
