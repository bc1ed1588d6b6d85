"""Model benchmarking: warm-up and timed runs, FLOP estimates, profiler
traces, the port of autoware_vision_pilot_tpu/utils/benchmark.py.

Equivalent of Models/data_utils/benchmark.py:17-48 (50 warm-up + 1000 timed
runs with device sync, thop FLOPs :94-95): on the card the time comes from
CUDA events around the timed runs, FLOPs from PyTorch's FlopCounterMode and
traces from torch.profiler. This is the timer only: it writes no benchmark
record.
"""
from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Callable, Dict, Optional

import torch


def benchmark(fn: Callable, *args, warmup: int = 50, runs: int = 1000,
              name: str = "model") -> Dict[str, float]:
    """Time ``fn(*args)``: ``warmup`` calls, then ``runs`` timed calls, with
    CUDA events and a synchronize when an argument lies on a card (else the
    host clock). Returns the stats dict and prints the reference-style
    report."""
    cuda = any(isinstance(a, torch.Tensor) and a.is_cuda for a in args)
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    for _ in range(max(warmup, 1)):
        fn(*args)
    sync()
    if cuda:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(runs):
            fn(*args)
        end.record()
        end.synchronize()
        total = start.elapsed_time(end) / 1e3
    else:
        t0 = time.perf_counter()
        for _ in range(runs):
            fn(*args)
        total = time.perf_counter() - t0
    ms = total / runs * 1e3
    fps = runs / total
    print(f"[bench] {name}: {ms:.3f} ms/iter, {fps:.1f} FPS "
          f"({warmup} warmup + {runs} timed)")
    return {"ms_per_iter": ms, "fps": fps, "runs": runs}


def flops_estimate(fn: Callable, *args) -> Optional[float]:
    """FLOPs of one call of ``fn(*args)`` as PyTorch's FlopCounterMode counts
    them (the thop analog): 2 per multiply-add of the convolutions and matrix
    products; the hand kernels' operators (``torch.ops.avp.*``) count 0.
    None if the call fails, as the JAX package's returns None."""
    from torch.utils.flop_counter import FlopCounterMode

    try:
        with torch.no_grad(), FlopCounterMode(display=False) as counter:
            fn(*args)
        return float(counter.get_total_flops())
    except Exception:
        return None


@contextlib.contextmanager
def profile_trace(logdir: str = os.path.join(tempfile.gettempdir(), "torch_trace")):
    """torch.profiler trace context over the CPU and the card; the Chrome
    trace goes to ``logdir`` (view with TensorBoard or Perfetto)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities,
                                on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)):
        yield logdir


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x).detach().to("cpu", torch.float32)


def tensor_stats(name: str, x) -> str:
    """Debug helper matching the reference's printTensorStats
    (test/test_autosteer.cpp:21-49): min/max/mean/std (the population std,
    as jnp.std) + first values."""
    x = _f32(x)
    s = (f"{name}: shape={tuple(x.shape)} min={float(x.min()):.5f} "
         f"max={float(x.max()):.5f} mean={float(x.mean()):.5f} "
         f"std={float(x.std(correction=0)):.5f} "
         f"first={[round(float(v), 4) for v in x.reshape(-1)[:5]]}")
    print(s)
    return s


def compare_tensors(a, b, name: str = "tensors") -> float:
    """Frame-to-frame identity check (test_autosteer.cpp:51-82 — catches
    'identical tensor' bugs in temporal pipelines). Returns max |diff|."""
    d = float((_f32(a) - _f32(b)).abs().max())
    same = d == 0.0
    print(f"[compare] {name}: max|diff|={d:.6f}"
          f"{'  *** IDENTICAL — temporal buffer bug? ***' if same else ''}")
    return d
