"""Zoo-wide model benchmark, the port of tools/bench_zoo.py: each model of
the zoo at its reference export shape (export/stablehlo_export.py's
EXPORT_SHAPES), batch 1, bf16 weights and inputs in channels_last, as the
port's networks run.

The eight models and shapes are the JAX tool's: SceneSeg, Scene3D,
DomainSeg and EgoLanes at 320x640, AutoSpeed "n" at 640x640, AutoSteer "n"
at 512x1024, AutoDrive on a (t-1, t) pair at 512x1024 and SceneSegLite's
DeepLabV3+ at 320x640. Weights are drawn from seed 0 on the CPU
(nn/layers.py::init_seeded); each model's input is the JAX tool's draw of
``np.random.default_rng(0)`` (one generator, in model order), and the other
inputs of its pool are that input rolled along its columns, all on the card
before the timing. WARMUP calls, then TIMED calls back to back between CUDA
events (tools/common.py::call_times). One JSON line a model with the JAX
tool's keys (``ms_per_forward`` the mean, ``params_m`` counting the float
parameters and BatchNorm statistics, as the JAX tool counts its variables),
the calls' p50 and p99, and the card's name and power limit. A model that
fails prints ``{"model", "error"}`` and the sweep goes on, as in the JAX
tool; the command then exits 1.

Run: python -m autoware_vision_pilot_tpu_torch.tools.bench_zoo [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Callable, Iterator, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .common import bench_device, call_times, card_of, p50_p99

POOL = 4  # distinct inputs a model
WARMUP, TIMED = 10, 50
CL = torch.channels_last


def models() -> Iterator[Tuple[str, Callable[[], nn.Module], Tuple[int, int, int, int]]]:
    """(name, a maker of the f32 CPU module, NHWC input shape) at the
    reference export shapes (convert_pytorch_to_onnx.py:90-97)."""
    from ..models import DomainSegNetwork, EgoLanesNetwork, Scene3DNetwork, SceneSegNetwork
    from ..models.auto_drive import AutoDriveNetwork
    from ..models.auto_speed import AutoSpeedNetwork
    from ..models.auto_steer import AutoSteerNetwork
    from ..models.lite.deeplabv3plus import DeepLabV3Plus

    yield "SceneSeg", SceneSegNetwork, (1, 320, 640, 3)
    yield "Scene3D", Scene3DNetwork, (1, 320, 640, 3)
    yield "DomainSeg", DomainSegNetwork, (1, 320, 640, 3)
    yield "EgoLanes", EgoLanesNetwork, (1, 320, 640, 3)
    yield "AutoSpeed-n", lambda: AutoSpeedNetwork("n", 4, 640, 640), (1, 640, 640, 3)
    yield "AutoSteer-n", lambda: AutoSteerNetwork("n", 512, 1024), (1, 512, 1024, 3)
    yield "AutoDrive", AutoDriveNetwork, (1, 512, 1024, 3)  # (t-1, t) pair
    yield "SceneSegLite-DLV3P", lambda: DeepLabV3Plus(output_channels=3), (1, 320, 640, 3)


def param_count(model: nn.Module) -> int:
    """Float parameters and buffers (the BatchNorm statistics): the JAX
    tool's count of every leaf of its variables (params and batch_stats)."""
    return sum(t.numel() for t in model.state_dict().values() if t.is_floating_point())


def forward_of(name: str, model: nn.Module) -> Callable:
    """The timed call on one input: AutoDrive gets the pair (x, x + 1), as
    the JAX tool feeds it."""
    if name == "AutoDrive":
        return lambda x: model(x, x + 1)
    return model


def bench_model(name: str, make: Callable[[], nn.Module], shape, x_nhwc: np.ndarray, device,
                dtype, card: str, warmup: int = WARMUP, timed: int = TIMED) -> dict:
    from ..nn.layers import init_seeded

    model = init_seeded(make(), torch.Generator().manual_seed(0))
    n_params = param_count(model)
    model.to(device=device, dtype=dtype, memory_format=CL).eval()
    x = torch.from_numpy(x_nhwc).to(device=device, dtype=dtype).permute(0, 3, 1, 2)
    pool = [x] + [torch.roll(x, 37 * i, dims=3).contiguous(memory_format=CL)
                   for i in range(1, POOL)]
    fwd = forward_of(name, model)
    with torch.inference_mode():
        times = call_times(fwd, pool, warmup, timed, device)
    ms = float(np.mean(times))
    p50, p99 = p50_p99(times)
    return {"model": name, "shape": list(shape), "ms_per_forward": round(ms, 3),
            "fps": round(1e3 / ms, 1), "params_m": round(n_params / 1e6, 2),
            "p50_ms": p50, "p99_ms": p99, "card": card}


def run(device="cuda", dtype=torch.bfloat16, *, zoo: Optional[list] = None,
        warmup: int = WARMUP, timed: int = TIMED) -> list:
    """Benchmarks every model of ``zoo`` (default: models()) -> the JSON
    lines (also printed), an ``error`` line for a model that failed."""
    device = bench_device(device)
    card = card_of(device)
    rng = np.random.default_rng(0)
    lines = []
    for name, make, shape in (zoo if zoo is not None else models()):
        try:
            x = rng.normal(size=shape)
            line = bench_model(name, make, shape, x, device, dtype, card, warmup, timed)
        except Exception as e:  # keep sweeping on a per-model failure
            line = {"model": name, "error": str(e)[:200]}
        if device.type == "cuda":
            torch.cuda.empty_cache()
        lines.append(line)
        print(json.dumps(line), flush=True)
    return lines


def parser() -> argparse.ArgumentParser:
    """The command line: the JAX tool's flags, and ``--device``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None):
    a = parser().parse_args(argv)
    lines = run(a.device, torch.bfloat16 if torch.device(a.device).type == "cuda"
                else torch.float32)
    return 1 if any("error" in line for line in lines) else 0


if __name__ == "__main__":
    sys.exit(main())
