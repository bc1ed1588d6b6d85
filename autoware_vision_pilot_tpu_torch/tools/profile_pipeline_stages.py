"""Per-stage cost table of the main path, the port of
tools/profile_pipeline_stages.py: each stage of the fused three-net
pipeline timed on its own, bf16, a 720p frame to 320x640.

  preprocess          720p uint8 -> 320x640 bf16 ImageNet tensor (the
                      fused-preprocess kernel, as the main path runs it)
  backbone            an EfficientNet-B0 trunk with weights of its own
  stack_full          the SceneSeg + Scene3D stack (trunk, contexts, necks,
                      heads)
  egolanes_full       the EgoLanes network
  postprocess         argmax + threshold + depth min-max scale
  fused_everything    the main path, pipeline.py::FusedPipeline
  seg_decoder_derived stack_full minus backbone

The weights are drawn from seed 0 (pipeline.py::build_pipeline_fused's for
the stack and EgoLanes; the trunk from a generator of its own). The
inputs come from ``np.random.default_rng(0)`` in the JAX tool's order (the
frame, then the network input), and further distinct ones after them, all
on the card before the timing. Each stage: WARMUP calls, then TIMED calls
back to back between CUDA events (tools/common.py::call_times); one JSON
line a stage with the JAX tool's ``stage`` and ``ms`` (the mean), the
calls' p50 and p99, and the card's name and power limit.

Run: python -m autoware_vision_pilot_tpu_torch.tools.profile_pipeline_stages
     [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .common import bench_device, call_times, card_of, p50_p99

STAGES = ("preprocess", "backbone", "stack_full", "egolanes_full", "postprocess",
          "fused_everything")
POOL = 8  # distinct inputs a stage
WARMUP, TIMED = 10, 50


def draw_inputs(rng: np.random.Generator, n: int = POOL, frame_hw=(720, 1280),
                out_hw=(320, 640)) -> Dict[str, list]:
    """``n`` inputs of each kind, NHWC numpy: the JAX tool's two draws first
    (the frame, then the N(0, 1) network input), then n - 1 more frames and
    inputs, then the post-processing's ``n`` (seg, depth, lane) logits
    triples (JAX's tool feeds zeros there)."""
    h, w = out_hw
    frames = [rng.integers(0, 256, (*frame_hw, 3), np.uint8)]
    xs = [rng.normal(size=(1, h, w, 3))]
    frames += [rng.integers(0, 256, (*frame_hw, 3), np.uint8) for _ in range(n - 1)]
    xs += [rng.normal(size=(1, h, w, 3)) for _ in range(n - 1)]
    post = [(rng.normal(size=(1, h, w, 3)).astype(np.float32),
             rng.normal(size=(1, h, w, 1)).astype(np.float32),
             rng.normal(size=(1, h // 4, w // 4, 3)).astype(np.float32)) for _ in range(n)]
    return {"frames": frames, "xs": xs, "post": post}


def on_device(inputs: Dict[str, list], device, dtype) -> Dict[str, list]:
    """The inputs on ``device``: frames as uint8, network inputs in ``dtype``
    as NCHW channels_last views, the logits in f32."""
    frames = [torch.from_numpy(f).to(device) for f in inputs["frames"]]
    xs = [torch.from_numpy(x).to(device=device, dtype=dtype).permute(0, 3, 1, 2)
          for x in inputs["xs"]]
    post = [tuple(torch.from_numpy(t).to(device) for t in p) for p in inputs["post"]]
    return {"frames": frames, "xs": xs, "post": post}


def stage_functions(stack: nn.Module, lanes: nn.Module, backbone: nn.Module,
                    out_hw: Tuple[int, int], dtype) -> Dict[str, Tuple[Callable, str]]:
    """name -> (the stage's function, the input kind it takes), on eval-mode
    networks of the stage's device and ``dtype``. Each returns what the JAX
    tool's stage computes before its checksum: the preprocessed (1, 3, h, w)
    tensor; the trunk's last feature map; (seg, depth) logits; the lane
    logits; (class mask, depth in [0, 1], lane masks); FusedPipeline's
    outputs."""
    from ..ops.kernels.preprocess_kernel import fused_preprocess
    from ..ops.postprocess import argmax_mask, depth_minmax_scale, threshold_channels
    from ..pipeline import FusedPipeline

    pipe = FusedPipeline(stack, lanes, out_hw, dtype)

    def post(p):
        seg, depth, lane = p
        return argmax_mask(seg), depth_minmax_scale(depth), threshold_channels(lane)

    return {
        "preprocess": (lambda f: fused_preprocess(f, out_hw, dtype), "frames"),
        "backbone": (lambda x: backbone(x)[4], "xs"),
        "stack_full": (lambda x: stack(x)[:2], "xs"),
        "egolanes_full": (lanes, "xs"),
        "postprocess": (post, "post"),
        "fused_everything": (pipe, "frames"),
    }


def build_models(device, dtype, seed: int = 0, ctx_hw=(10, 20), out_hw=(320, 640)):
    """(stack, EgoLanes, B0 trunk) at full width and depth, seeded on the
    CPU, eval mode, on ``device`` in ``dtype`` and channels_last: the stack
    and EgoLanes are build_pipeline_fused's, the trunk is drawn from its
    own generator of ``seed``."""
    from ..models.efficientnet import EfficientNetB0Features
    from ..nn.layers import init_seeded
    from ..pipeline import build_pipeline_fused

    pipe = build_pipeline_fused(device, dtype, seed, ctx_hw, out_hw)
    trunk = init_seeded(EfficientNetB0Features(), torch.Generator().manual_seed(seed))
    trunk.to(device=device, dtype=dtype, memory_format=torch.channels_last).eval()
    return pipe.stack, pipe.lanes, trunk


def run(device="cuda", dtype=torch.bfloat16, *, frame_hw=(720, 1280), out_hw=(320, 640),
        models: Optional[tuple] = None, warmup: int = WARMUP, timed: int = TIMED) -> list:
    """Times every stage -> the JSON lines (also printed). ``models`` is
    (stack, lanes, trunk) on ``device`` in ``dtype`` (default:
    build_models at full width for ``out_hw``)."""
    device = bench_device(device)
    card = card_of(device)
    stack, lanes, trunk = models or build_models(
        device, dtype, ctx_hw=(out_hw[0] // 32, out_hw[1] // 32), out_hw=out_hw)
    inputs = on_device(draw_inputs(np.random.default_rng(0), POOL, frame_hw, out_hw),
                       device, dtype)
    fns = stage_functions(stack, lanes, trunk, out_hw, dtype)
    ms, lines = {}, []
    with torch.inference_mode():
        for name in STAGES:
            fn, kind = fns[name]
            times = call_times(fn, inputs[kind], warmup, timed, device)
            ms[name] = float(np.mean(times))
            p50, p99 = p50_p99(times)
            lines.append({"stage": name, "ms": round(ms[name], 3), "p50_ms": p50,
                          "p99_ms": p99, "card": card})
    derived = ms["stack_full"] - ms["backbone"]
    lines.append({"stage": "seg_decoder_derived", "ms": round(derived, 3),
                  "card": card})
    for line in lines:
        print(json.dumps(line), flush=True)
    return lines


def parser() -> argparse.ArgumentParser:
    """The command line: the JAX tool's flags, and ``--device``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None):
    a = parser().parse_args(argv)
    run(a.device, torch.bfloat16 if torch.device(a.device).type == "cuda" else torch.float32)
    return 0


if __name__ == "__main__":
    main()
