"""Fleet serving benchmark, the port of tools/bench_fleet.py: aggregate
frames/s of the full stateful lateral stack (EgoLanes + temporal AutoSteer +
LaneFilter + LaneTracker + Bayes PathFinder + steering) batched over N
independent camera streams, one set of launches a tick
(runtime/fleet.py::FleetLateralPipeline).

As the JAX tool: EgoLanes and AutoSteer from seed 0 in bf16
(runtime/pipeline.py::build_lateral_pipeline's weights), the states from
seed 0, ``--ticks`` distinct ticks of N 720p frames from
``np.random.default_rng(0)`` on the card before the timing, three windows
of ``--ticks`` ticks with the states carried (window w starts at tick
17 w), the median window's aggregate frames/s. ``--int8``: EgoLanes' convs
with at least 128 input channels run int8, calibrated on four N(0, 1)
inputs from ``default_rng(7)`` (pipeline.py::calibration_batches);
AutoSteer stays bf16. ``--pad_to`` runs the step at that physical batch.

In place of the JAX tool's 150 warm-up ticks: WARMUP ticks; each window
has a CUDA event after every tick (the tick p50 and p99 over the three
windows) and is read once at its end. One JSON line per N with the JAX
tool's keys, the ticks' p50 and p99 and the card's name and power limit.

Run: python -m autoware_vision_pilot_tpu_torch.tools.bench_fleet
     [--streams 1,2,4,8] [--ticks 60] [--int8] [--pad_to N] [--device cuda|cpu]
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

WARMUP = 3
WINDOWS = 3
INT8_MIN_CHANNELS = 128


def int8_lanes(lanes: nn.Module, device, dtype, min_channels: int = INT8_MIN_CHANNELS,
               out_hw=(320, 640)) -> nn.Module:
    """The JAX tool's --int8 recipe on EgoLanes, in place: each conv with at
    least ``min_channels`` input channels becomes int8, its activation
    scale calibrated on four N(0, 1) ``out_hw`` inputs from
    ``default_rng(7)`` in ``dtype`` on ``device``. Returns ``lanes``."""
    from ..export.quantize import calibrate_int8_activation_scales, quantize_for_int8_conv
    from ..pipeline import calibration_batches

    quantize_for_int8_conv(lanes, min_channels)
    with torch.inference_mode():
        calibrate_int8_activation_scales(lanes, calibration_batches(out_hw, dtype, device))
    return lanes


def draw_ticks(rng: np.random.Generator, n_streams: int, n_ticks: int,
               frame_hw=(720, 1280)) -> List[np.ndarray]:
    """The JAX tool's ticks: ``n_ticks`` arrays of ``n_streams`` uint8 frames."""
    return [rng.integers(0, 256, (n_streams, *frame_hw, 3), dtype=np.uint8)
            for _ in range(n_ticks)]


def bench_fleet(nets: Tuple[nn.Module, nn.Module], host_ticks: List[np.ndarray], *,
                pad_to: int = 0, device="cuda", dtype=torch.bfloat16,
                warmup_ticks: int = WARMUP, frame_hw=(720, 1280), crop_y: int = 420,
                net_hw=(320, 640)) -> dict:
    """The lateral fleet over ``nets`` (EgoLanes, AutoSteer-temporal) on
    ``device`` in ``dtype``, fed ``host_ticks`` (draw_ticks: N frames a
    tick) -> {"fps": the median window's aggregate frames/s, "tick_ms":
    every timed tick's ms}."""
    from ..runtime import Config, FleetLateralPipeline

    device = torch.device(device)
    cfg = Config()
    n_streams, n_ticks = len(host_ticks[0]), len(host_ticks)
    fleet = FleetLateralPipeline(*nets, cfg, n_streams=n_streams, frame_hw=frame_hw,
                                 crop_y=crop_y, dtype=dtype, pad_to=pad_to, net_hw=net_hw)
    states = fleet.init_states(seed=0)
    ticks = [torch.from_numpy(t).to(device) for t in host_ticks]
    cuda = device.type == "cuda"
    for t in range(warmup_ticks):
        out, states = fleet(ticks[t % n_ticks], states)
    out["scalars"].cpu()

    window_fps, tick_ms = [], []
    for w in range(WINDOWS):
        if cuda:
            events = [torch.cuda.Event(enable_timing=True) for _ in range(n_ticks + 1)]
            events[0].record()
        else:
            stamps = [time.perf_counter()]
        for t in range(n_ticks):
            out, states = fleet(ticks[(w * 17 + t) % n_ticks], states)
            if cuda:
                events[t + 1].record()
            else:
                out["scalars"].cpu()
                stamps.append(time.perf_counter())
        out["scalars"].cpu()  # the carried states chain every tick into this one
        if cuda:
            ms = [events[i].elapsed_time(events[i + 1]) for i in range(n_ticks)]
        else:
            ms = list(np.diff(stamps) * 1e3)
        tick_ms += ms
        window_fps.append(n_streams / (sum(ms) / n_ticks / 1e3))
    window_fps.sort()
    return {"fps": window_fps[len(window_fps) // 2], "tick_ms": tick_ms}


def metric_name(n: int, int8: bool, pad_to: int) -> str:
    suffix = "_int8" if int8 else ""
    if pad_to:
        suffix += f"_pad{pad_to}"
    return f"fleet_lateral_{n}streams_aggregate_fps{suffix}"


def run(streams=(1, 2, 4, 8), ticks: int = 60, int8: bool = False, pad_to: int = 0,
        device="cuda", dtype=torch.bfloat16, *, nets: Optional[Tuple] = None,
        frame_hw=(720, 1280), crop_y: int = 420, net_hw=(320, 640)) -> list:
    """bench_fleet at each N of ``streams``, the networks built once (or
    ``nets``, (EgoLanes, AutoSteer-temporal) on ``device``; ``int8`` then
    only names the lines) and every N's ticks drawn at once (a
    thread each, each from its own ``default_rng(0)``, as the JAX tool's
    calls draw them) -> the JSON lines (also printed)."""
    from ..runtime.pipeline import build_lateral_pipeline

    device = bench_device(device)
    card = card_of(device)
    if nets is None:
        lat = build_lateral_pipeline(device, dtype, 0, frame_hw=frame_hw, crop_y=crop_y,
                                     net_hw=net_hw)
        nets = (lat.lanes, lat.steer_net)
        if int8:
            int8_lanes(lat.lanes, device, dtype, out_hw=net_hw)
    with ThreadPoolExecutor(len(streams)) as pool:
        drawn = [pool.submit(draw_ticks, np.random.default_rng(0), n, ticks, frame_hw)
                 for n in streams]
    lines = []
    for i, n in enumerate(streams):
        host_ticks, drawn[i] = drawn[i].result(), None
        r = bench_fleet(nets, host_ticks, pad_to=pad_to, device=device, dtype=dtype,
                        frame_hw=frame_hw, crop_y=crop_y, net_hw=net_hw)
        del host_ticks
        p50, p99 = p50_p99(r["tick_ms"])
        line = {"metric": metric_name(n, int8, pad_to), "value": round(r["fps"], 2),
                "unit": "frames/sec", "per_stream_fps": round(r["fps"] / n, 2),
                "p50_ms": p50, "p99_ms": p99, "card": card}
        lines.append(line)
        print(json.dumps(line), flush=True)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return lines


def parser() -> argparse.ArgumentParser:
    """The command line: the JAX tool's flags, and ``--device``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--streams", default="1,2,4,8")
    ap.add_argument("--ticks", type=int, default=60)
    ap.add_argument("--int8", action="store_true")
    ap.add_argument("--pad_to", type=int, default=0,
                    help="run the device step at this physical batch (>= streams), "
                         "slicing outputs")
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None):
    a = parser().parse_args(argv)
    run([int(s) for s in a.streams.split(",")], a.ticks, a.int8, a.pad_to, a.device,
        torch.bfloat16 if torch.device(a.device).type == "cuda" else torch.float32)
    return 0


if __name__ == "__main__":
    main()
