"""Training throughput benchmark, the port of tools/bench_train.py:
sustained samples/s of the SceneSeg train step (forward, backward, AdamW,
the BatchNorm statistics) at the reference's 320x640 training resolution,
bf16 autocast over f32 weights, channels_last
(train/train_step.py::make_seg_train_step).

As the JAX tool: SceneSegNetwork at full width and depth from seed 0,
``adamw(1e-4)`` (optax's AdamW, train_step.py::adamw),
``segmentation_ce_loss``, ``--microbatches`` slices a step, four distinct
batches of ``normal(0.45, 0.22)`` images with class ids ``integers(0, 3)``
from ``np.random.default_rng(0)`` on the card before the timing, the
dropout masks from a generator seeded 1. Under ``torchrun`` the step runs
over the world mesh (``initialize_distributed()``, ``make_mesh()``): every
rank gets the whole batch and runs its rows, and rank 0 prints; alone, no
mesh. ``value`` is the batch over the step's time, as the JAX tool counts
it (the whole batch over every card of the mesh).

In place of the JAX tool's 120 warm-up steps: WARMUP steps; then
``--steps`` steps back to back with a CUDA event after each (the step p50
and p99), read once at the end. One JSON line with the JAX tool's keys,
the step p50 and p99, the warm-up's seconds (the first step's set-up
apart from the steady state), the world size and the card's name and
power limit.

Run: python -m autoware_vision_pilot_tpu_torch.tools.bench_train [--batch 16]
     [--steps 20] [--microbatches 1] [--device cuda|cpu]
     (several cards: torchrun --nproc_per_node=N -m ... with the same flags)
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .common import bench_device, card_of, p50_p99

WARMUP = 3
N_BATCHES = 4
CL = torch.channels_last


def draw_batches(rng: np.random.Generator, batch: int, hw=(320, 640),
                 n: int = N_BATCHES) -> List[Tuple[np.ndarray, np.ndarray]]:
    """The JAX tool's ``n`` batches: NHWC f32 images (drawn in float64,
    then rounded) and int32 class ids."""
    return [(rng.normal(0.45, 0.22, (batch, *hw, 3)).astype(np.float32),
             rng.integers(0, 3, (batch, *hw)).astype(np.int32)) for _ in range(n)]


def run(batch: int = 16, steps: int = 20, microbatches: int = 1, device="cuda", *,
        make_model: Optional[Callable[[], nn.Module]] = None, hw=(320, 640),
        warmup: int = WARMUP, compute_dtype=torch.bfloat16) -> dict:
    """Times ``steps`` train steps -> the JSON line (printed on rank 0).
    ``make_model`` builds the f32 network on the CPU (default:
    SceneSegNetwork at full width for ``hw``)."""
    from ..core.mesh import make_mesh
    from ..models import SceneSegNetwork
    from ..nn.layers import init_seeded
    from ..parallel.distributed import initialize_distributed
    from ..train import create_seg_train_state, make_seg_train_step, segmentation_ce_loss
    from ..train.train_step import adamw

    device = bench_device(device)
    world = initialize_distributed(device=str(device))
    mesh = make_mesh() if world else None
    if world:
        device = mesh.local_devices[0]
    card = card_of(device)
    make_model = make_model or (lambda: SceneSegNetwork((hw[0] // 32, hw[1] // 32)))
    model = init_seeded(make_model(), torch.Generator().manual_seed(0))
    model.to(device, memory_format=CL)
    state = create_seg_train_state(model, adamw(1e-4))
    step = make_seg_train_step(segmentation_ce_loss, mesh=mesh, microbatches=microbatches,
                               compute_dtype=compute_dtype)
    batches = [(torch.from_numpy(x).to(device).permute(0, 3, 1, 2),
                torch.from_numpy(y).to(device).long())
               for x, y in draw_batches(np.random.default_rng(0), batch, hw)]
    gen = torch.Generator(device=device).manual_seed(1)
    t0 = time.perf_counter()
    for i in range(warmup):
        state, loss = step(state, *batches[i % len(batches)], gen)
    if warmup:
        float(loss)
    warmup_s = time.perf_counter() - t0  # the first step's cuDNN set-up included
    cuda = device.type == "cuda"
    if cuda:
        events = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
        torch.cuda.synchronize(device)
        events[0].record()
    else:
        stamps = [time.perf_counter()]
    for i in range(steps):
        state, loss = step(state, *batches[i % len(batches)], gen)
        if cuda:
            events[i + 1].record()
        else:
            stamps.append(time.perf_counter())
    final = float(loss)  # waits for the last step
    step_ms = ([events[i].elapsed_time(events[i + 1]) for i in range(steps)] if cuda
               else list(np.diff(stamps) * 1e3))
    dt = sum(step_ms) / steps / 1e3
    p50, p99 = p50_p99(step_ms)
    line = {"metric": "scene_seg_train_samples_per_sec_per_chip",
            "value": round(batch / dt, 2), "unit": "samples/sec", "batch": batch,
            "step_ms": round(dt * 1e3, 2), "final_loss": round(final, 4),
            "microbatches": microbatches, "world": mesh.size if world else 1,
            "warmup_s": warmup_s, "p50_ms": p50, "p99_ms": p99, "card": card}
    if not world or mesh.rank == 0:
        print(json.dumps(line), flush=True)
    return line


def parser() -> argparse.ArgumentParser:
    """The command line: the JAX tool's flags, and ``--device``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None):
    a = parser().parse_args(argv)
    run(a.batch, a.steps, a.microbatches, a.device,
        compute_dtype=torch.bfloat16 if torch.device(a.device).type == "cuda"
        else torch.float32)
    return 0


if __name__ == "__main__":
    main()
