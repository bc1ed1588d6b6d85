"""The port of autoware_vision_pilot_tpu/utils/check_data.py.

Dataset sanity checker (data_utils/check_data.py + manual_audit_app.py
role, CLI form): validates a unified-format dataset directory — image/
label pairing, decodable colors, class distribution — and optionally
writes blended audit images for eyeball verification.

Run: python -m autoware_vision_pilot_tpu_torch.utils.check_data <root> \
        [--audit-dir DIR] [--limit N]
"""
from __future__ import annotations

import argparse
import pathlib
import sys

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None

from ..train.datasets import decode_scene_seg_mask, SCENESEG_COLOURS


def check_dataset(root: str | pathlib.Path, audit_dir: str | None = None,
                  limit: int | None = None) -> dict:
    root = pathlib.Path(root)
    images = sorted((root / "images").glob("*.png"))
    labels = sorted((root / "labels").glob("*.png"))
    report = {"n_images": len(images), "n_labels": len(labels),
              "mismatched_names": [], "unknown_colors": 0,
              "class_pixels": np.zeros(3, np.int64), "bad_pairs": []}
    if len(images) != len(labels):
        report["bad_pairs"].append(
            f"count mismatch: {len(images)} images vs {len(labels)} labels")

    known = np.array(list(SCENESEG_COLOURS.values()), np.uint8)
    n = min(len(images), len(labels))
    if limit:
        n = min(n, limit)
    for i in range(n):
        if images[i].stem != labels[i].stem:
            report["mismatched_names"].append(
                (images[i].name, labels[i].name))
        img = cv2.imread(str(images[i]))
        lab = cv2.cvtColor(cv2.imread(str(labels[i])), cv2.COLOR_BGR2RGB)
        if img is None or lab is None:
            report["bad_pairs"].append(images[i].name)
            continue
        if img.shape[:2] != lab.shape[:2]:
            report["bad_pairs"].append(
                f"{images[i].name}: size {img.shape[:2]} vs {lab.shape[:2]}")
        flat = lab.reshape(-1, 3)
        unknown = ~np.any(
            np.all(flat[:, None] == known[None], axis=2), axis=1)
        report["unknown_colors"] += int(unknown.sum())
        ids, _ = decode_scene_seg_mask(lab)
        for c in range(3):
            report["class_pixels"][c] += int((ids == c).sum())
        if audit_dir:
            out = pathlib.Path(audit_dir)
            out.mkdir(parents=True, exist_ok=True)
            overlay = cv2.addWeighted(
                img, 0.5, cv2.cvtColor(lab, cv2.COLOR_RGB2BGR), 0.5, 0)
            cv2.imwrite(str(out / images[i].name), overlay)
    return report


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("root")
    ap.add_argument("--audit-dir", default=None)
    ap.add_argument("--limit", type=int, default=None)
    a = ap.parse_args(argv)
    r = check_dataset(a.root, a.audit_dir, a.limit)
    total = max(int(r["class_pixels"].sum()), 1)
    print(f"images={r['n_images']} labels={r['n_labels']} "
          f"unknown_color_px={r['unknown_colors']}")
    for c, name in enumerate(["background", "foreground", "road"]):
        print(f"  {name}: {r['class_pixels'][c] / total:.3%}")
    if r["bad_pairs"] or r["mismatched_names"]:
        print("PROBLEMS:", r["bad_pairs"], r["mismatched_names"])
        return 1
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
