"""Generate a synthetic unified-format dataset (road scenes with geometric
road/sky/vehicle regions) for smoke-training and pipeline demos without
real data; the port of tools/gen_synthetic_dataset.py. The scenes are drawn
with numpy and cv2 on the host, the same bytes as the JAX tool's for the
same arguments.

Run: python -m autoware_vision_pilot_tpu_torch.tools.gen_synthetic_dataset
     out_dir [--n 50] [--hw 320 640]
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from ..data_parsing.common import write_unified_sample
from ..train.datasets import SCENESEG_COLOURS


def make_scene(rng: np.random.Generator, hw):
    """One (image RGB uint8 (h, w, 3), label RGB uint8 (h, w, 3)) scene:
    sky above a random horizon, a background band, a road trapezoid, up to
    two vehicle boxes, Gaussian pixel noise; every draw from ``rng``."""
    import cv2
    h, w = hw
    img = np.zeros((h, w, 3), np.uint8)
    lab = np.zeros((h, w, 3), np.uint8)

    horizon = int(h * rng.uniform(0.35, 0.55))
    img[:horizon] = (200 + rng.integers(-30, 30), 160, 120)
    lab[:horizon] = SCENESEG_COLOURS["sky"]
    img[horizon:] = (90, 90, 90)
    lab[horizon:] = SCENESEG_COLOURS["background_objects"]
    vx = int(w * rng.uniform(0.4, 0.6))
    bl = int(w * rng.uniform(0.0, 0.2))
    br = int(w * rng.uniform(0.8, 1.0))
    pts = np.array([[vx - 10, horizon], [vx + 10, horizon],
                    [br, h - 1], [bl, h - 1]], np.int32)
    cv2.fillPoly(img, [pts], (60, 60, 60))
    cv2.fillPoly(lab, [pts], SCENESEG_COLOURS["road"])
    mask = np.zeros((h, w), np.uint8)
    cv2.fillPoly(mask, [pts], 1)
    lab[mask == 1] = np.array(SCENESEG_COLOURS["road"], np.uint8)
    for _ in range(rng.integers(0, 3)):
        cw = int(rng.integers(20, max(21, w // 8)))
        ch = int(rng.integers(10, max(11, h // 6)))
        if w - cw <= 0 or h - ch <= horizon:
            continue
        x = rng.integers(0, w - cw)
        y = rng.integers(horizon, h - ch)
        img[y:y + ch, x:x + cw] = (0, 0, rng.integers(120, 255))
        lab[y:y + ch, x:x + cw] = SCENESEG_COLOURS["large_mobile_vehicle"]
    noise = rng.normal(0, 8, img.shape)
    img = np.clip(img.astype(np.int16) + noise, 0, 255).astype(np.uint8)
    return img, lab


def run(out_dir: str, n: int = 50, hw=(320, 640)) -> int:
    """Write ``n`` scenes of ``np.random.default_rng(0)`` as
    ``out_dir/{images,labels}/%05d.png`` -> n."""
    rng = np.random.default_rng(0)
    for i in range(n):
        img, lab = make_scene(rng, tuple(hw))
        write_unified_sample(out_dir, f"{i:05d}", img[..., ::-1], lab)
    print(f"wrote {n} samples to {out_dir}")
    return n


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("out_dir")
    ap.add_argument("--n", type=int, default=50)
    ap.add_argument("--hw", type=int, nargs=2, default=(320, 640))
    a = ap.parse_args(argv)
    run(a.out_dir, a.n, tuple(a.hw))
    return 0


if __name__ == "__main__":
    sys.exit(main())
