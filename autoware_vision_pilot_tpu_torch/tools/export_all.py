"""Export every model family as a torch.export program at the reference
shapes, the port of tools/export_all.py (the convert_pytorch_to_onnx.py
analog: one command produces the whole artifact set). The programs are
``.pt2`` files (export/stablehlo_export.py); the families of
``EXPORT_SHAPES`` at those shapes in NCHW, AutoSteerTemporal at its
(1, 6, 80, 160) mask stack and SceneSegLite at (1, 3, 320, 640).

Run: python -m autoware_vision_pilot_tpu_torch.tools.export_all
     [--out exports/] [--checkpoint-dir DIR] [--models SceneSeg,EgoLanes,...]
     [--dtype bf16|f32] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import pathlib
import sys

import torch

DEFAULT_MODELS = ("SceneSeg", "Scene3D", "DomainSeg", "EgoLanes", "AutoSpeed",
                  "AutoSteer", "AutoDrive", "AutoSteerTemporal", "SceneSegLite")


def build(name: str):
    """-> (the network on the CPU in f32, its input shape, its inputs)."""
    from ..models import DomainSegNetwork, EgoLanesNetwork, Scene3DNetwork, SceneSegNetwork
    from ..models.auto_drive import AutoDriveNetwork
    from ..models.auto_speed import AutoSpeedNetwork
    from ..models.auto_steer import AutoSteerNetwork
    from ..models.auto_steer_temporal import AutoSteerTemporalNet
    from ..models.lite.deeplabv3plus import DeepLabV3Plus

    nets = {
        "SceneSeg": SceneSegNetwork,
        "Scene3D": Scene3DNetwork,
        "DomainSeg": DomainSegNetwork,
        "EgoLanes": EgoLanesNetwork,
        "AutoSpeed": lambda: AutoSpeedNetwork("n", 4, 512, 1024),
        "AutoSteer": lambda: AutoSteerNetwork("n", 512, 1024),
        "AutoDrive": lambda: AutoDriveNetwork(512, 1024),
        "AutoSteerTemporal": lambda: AutoSteerTemporalNet((80, 160)),
        "SceneSegLite": lambda: DeepLabV3Plus(output_channels=3),
    }
    if name not in nets:
        raise SystemExit(f"unknown model {name}")
    from ..export.stablehlo_export import EXPORT_SHAPES
    shape = EXPORT_SHAPES.get(name, {"AutoSteerTemporal": (1, 6, 80, 160),
                                     "SceneSegLite": (1, 3, 320, 640)}.get(name))
    return nets[name](), shape, 2 if name == "AutoDrive" else 1


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="exports")
    ap.add_argument("--checkpoint-dir", default="",
                    help="dir of <Model>.msgpack weight files")
    ap.add_argument("--models", default=",".join(DEFAULT_MODELS))
    ap.add_argument("--dtype", default="bf16", choices=("bf16", "f32"))
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)

    from ..export.stablehlo_export import export_stablehlo
    from ..inference.infer import load_weights

    dtype = torch.bfloat16 if a.dtype == "bf16" else torch.float32
    paths = []
    for name in a.models.split(","):
        name = name.strip()
        model, shape, n_in = build(name)
        ckpt = pathlib.Path(a.checkpoint_dir) / f"{name}.msgpack" if a.checkpoint_dir else None
        if ckpt is not None and ckpt.exists():
            print(f"[export] {name}: loaded {ckpt}")
        model = load_weights(model, checkpoint=str(ckpt) if ckpt and ckpt.exists() else "",
                             device=a.device, dtype=dtype)
        example = tuple(torch.zeros(shape, dtype=dtype, device=a.device) for _ in range(n_in))
        p = export_stablehlo(model, example, pathlib.Path(a.out) / f"{name}.pt2")
        print(f"[export] {name} -> {p} ({p.stat().st_size // 1024} KiB)")
        paths.append(p)
    return paths


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
