"""The full application loop's frames/s at several pipeline depths, the port
of tools/bench_app_loop.py: capture -> the lateral step (preprocess kernel,
EgoLanes, AutoSteer, the walk kernel, LaneTracker, Bayes PathFinder,
steering) -> the longitudinal step (letterbox kernel, AutoSpeed, NMS
kernel) -> host tracking, RSS planning and PID, in
runtime/pipeline.py::PipelineEngine with ``target_fps = 0`` (unpaced).

As the JAX tool: EgoLanes, AutoSteer-temporal and AutoSpeed "n" at 640x640
in bf16 from seed 0 (runtime/pipeline.py's build_lateral_pipeline and
build_longitudinal_pipeline, app.py::build_engine's weights); three
configurations (upload with tracking at depths 1 and 8, pre-uploaded with
tracking at 1 and 8, pre-uploaded without tracking at 1, 2, 4 and 8), each
run on a fresh pool of ``n_frames + 1`` distinct 720p frames, pool k from
``np.random.default_rng(1000 + k)`` (pool 0 the warm-up's). ``--int8``:
EgoLanes and AutoSpeed with their convs of at least 256 input channels
int8, calibrated on four frames from ``default_rng(7)``, EgoLanes on their
preprocessed crops ``[420:]``, AutoSpeed on them letterboxed to 640x640
(through the kernels, as the steps feed the networks).

In place of the JAX tool's 150-frame warm-up run: WARM_FRAMES frames (the
first of pool 0). Every pool is drawn before the first run (a thread a
pool) and a pre-uploaded pool goes to the card just before its run. One
JSON line a (configuration, depth): the JAX tool's frames/s and ms a frame
(wall clock over the run), the host loop's p50 and p99
(PerformanceMetrics), upload to results on the host p50 and p99 (CUDA
events, PipelineEngine.device_ms), and the card's name and power limit.

Run: python -m autoware_vision_pilot_tpu_torch.tools.bench_app_loop [n_frames]
     [--int8] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .common import bench_device, card_of, p50_p99

CONFIGS = (
    ("upload   +tracking", "upload", True, (1, 8)),
    ("preupload+tracking", "preuploaded", True, (1, 8)),
    ("preupload no-track", "preuploaded", False, (1, 2, 4, 8)),
)
WARM_FRAMES = 10
POOL_SEED = 1000
INT8_MIN_CHANNELS = 256


def make_pool(seed: int, n: int, frame_hw=(720, 1280)) -> List[np.ndarray]:
    """The JAX tool's ``make_pool``: ``n`` uint8 frames (values 0-254) from
    ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 255, (*frame_hw, 3), dtype=np.uint8) for _ in range(n)]


def make_source(host: list, dev: Optional[list], mode: str):
    """The JAX tool's frame source: frames 1, 2, ... of the pool, cycling;
    the (host, device) pair when pre-uploaded."""
    i = [0]

    def source():
        i[0] += 1
        j = i[0] % len(host)
        if mode == "preuploaded":
            return host[j], dev[j]
        return host[j]
    return source


def calibration_frames(frame_hw=(720, 1280), n: int = 4) -> List[np.ndarray]:
    """The JAX tool's int8 calibration frames: ``n`` from ``default_rng(7)``."""
    rng = np.random.default_rng(7)
    return [rng.integers(0, 255, (*frame_hw, 3), dtype=np.uint8) for _ in range(n)]


def int8_nets(lanes: nn.Module, speed_net: nn.Module, device, dtype,
              min_channels: int = INT8_MIN_CHANNELS, *, frame_hw=(720, 1280), crop_y: int = 420,
              net_hw=(320, 640), input_hw=(640, 640)) -> Tuple[nn.Module, nn.Module]:
    """The JAX tool's --int8 recipe, in place on both networks (on
    ``device`` in ``dtype``): each conv with at least ``min_channels`` input
    channels becomes int8; EgoLanes' activation scales are calibrated on
    calibration_frames' crops ``[crop_y:]`` preprocessed to ``net_hw``,
    AutoSpeed's on the frames letterboxed to ``input_hw``. -> the two."""
    from ..export.quantize import calibrate_int8_activation_scales, quantize_for_int8_conv
    from ..ops.kernels.preprocess_kernel import fused_letterbox, fused_preprocess

    frames = [torch.from_numpy(f).to(device) for f in calibration_frames(frame_hw)]
    with torch.inference_mode():
        quantize_for_int8_conv(lanes, min_channels)
        calibrate_int8_activation_scales(
            lanes, [fused_preprocess(f[crop_y:], net_hw, dtype) for f in frames])
        quantize_for_int8_conv(speed_net, min_channels)
        calibrate_int8_activation_scales(
            speed_net, [fused_letterbox(f, input_hw, dtype)[0] for f in frames])
    return lanes, speed_net


def build(device="cuda", dtype=torch.bfloat16, int8: bool = False):
    """(LateralPipeline, LongitudinalPipeline) at full width, seed 0, on
    ``device`` in ``dtype``; with ``int8`` through int8_nets."""
    from ..runtime.pipeline import build_lateral_pipeline, build_longitudinal_pipeline

    lat = build_lateral_pipeline(device, dtype, 0)
    lon = build_longitudinal_pipeline(device, dtype, 0)
    if int8:
        int8_nets(lat.lanes, lon.net, device, dtype)
    return lat, lon


def run(n_frames: int = 100, int8: bool = False, device="cuda", dtype=torch.bfloat16, *,
        nets: Optional[tuple] = None, frame_hw=(720, 1280), configs=CONFIGS,
        warm_frames: int = WARM_FRAMES) -> list:
    """Every configuration of ``configs`` at each of its depths -> the JSON
    lines (also printed). ``nets`` is (LateralPipeline, LongitudinalPipeline)
    for ``frame_hw`` frames on ``device`` (default: build)."""
    from ..perception.tracking import ObjectFinder
    from ..runtime.config import Config
    from ..runtime.pipeline import PipelineEngine

    device = bench_device(device)
    card = card_of(device)
    cfg = Config()
    cfg.target_fps = 0.0  # unpaced
    lat, lon = nets or build(device, dtype, int8)
    runs = [(label, mode, track, depth) for label, mode, track, depths in configs
            for depth in depths]
    with ThreadPoolExecutor(min(len(runs) + 1, 8)) as pool:
        pools = [pool.submit(make_pool, POOL_SEED, warm_frames, frame_hw)] + [
            pool.submit(make_pool, POOL_SEED + 1 + k, n_frames + 1, frame_hw)
            for k in range(len(runs))]
    finder = lambda: ObjectFinder(np.eye(3), frame_hw[1], frame_hw[0])  # noqa: E731

    def engine(host, mode, track):
        dev = [torch.from_numpy(f).to(device) for f in host] if mode == "preuploaded" else None
        eng = PipelineEngine(cfg, lat, lon, finder() if track else None,
                             frame_source=make_source(host, dev, mode), sink=None)
        eng.metrics.report_every = 10 ** 9  # stdout carries the JSON lines only
        return eng

    # one warm-up run (the programs are shared by every configuration)
    warm = engine(pools[0].result(), "preuploaded", True)
    warm.warmup(frame_hw)
    warm.run(max_frames=warm_frames, pipeline_depth=8)
    del warm
    lines = []
    for k, (label, mode, track, depth) in enumerate(runs):
        host, pools[k + 1] = pools[k + 1].result(), None
        eng = engine(host, mode, track)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        results = eng.run(max_frames=n_frames, pipeline_depth=depth)
        dt = time.perf_counter() - t0
        host_p50, host_p99 = p50_p99(np.asarray(eng.metrics.e2e_samples) * 1e3)
        line = {"config": label, "mode": mode, "tracking": track, "depth": depth,
                "int8": int8, "fps": len(results) / dt,
                "ms_per_frame": dt / len(results) * 1e3, "frames": len(results),
                "host_p50_ms": host_p50, "host_p99_ms": host_p99}
        if eng.device_ms:
            line["p50_ms"], line["p99_ms"] = p50_p99(eng.device_ms)
        line["card"] = card
        lines.append(line)
        print(json.dumps(line), flush=True)
        del eng, host
    return lines


def parser() -> argparse.ArgumentParser:
    """The command line: the JAX tool's flags, and ``--device``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("n_frames", nargs="?", type=int, default=100)
    ap.add_argument("--int8", action="store_true")
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None):
    a = parser().parse_args(argv)
    run(a.n_frames, a.int8, a.device,
        torch.bfloat16 if torch.device(a.device).type == "cuda" else torch.float32)
    return 0


if __name__ == "__main__":
    main()
