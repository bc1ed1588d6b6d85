"""Pieces the port's tools share: the default output directory, a
producer thread that builds a tool's next batches on the host while the
card runs the current step, and the bench tools' device, card and timing
helpers."""
from __future__ import annotations

import os
import queue
import subprocess
import tempfile
import threading
import time
from typing import Callable, Iterator, List, Sequence, Tuple, TypeVar

import numpy as np
import torch

T = TypeVar("T")


def default_out(name: str) -> str:
    """``<temp dir>/name``: the JAX tools' ``/tmp/<name>`` under ``TMPDIR``."""
    return os.path.join(tempfile.gettempdir(), name)


def prefetched(make: Callable[[], T], n: int, depth: int = 4) -> Iterator[T]:
    """``make()`` called ``n`` times, in order, on one producer thread that
    keeps up to ``depth`` results ahead of the consumer: the same values in
    the same order as calling it inline (a generator that ``make`` draws
    from is touched by that thread alone). numpy's bulk draws and array
    operations release the GIL, so the batches are built while the main
    thread launches the step. An exception in ``make`` is raised in the
    consumer; leaving the loop early stops the thread."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def work():
        try:
            for _ in range(n):
                if stop.is_set():
                    return
                q.put((True, make()))
        except BaseException as e:  # handed to the consumer
            q.put((False, e))

    t = threading.Thread(target=work, daemon=True)
    t.start()
    try:
        for _ in range(n):
            ok, value = q.get()
            if not ok:
                raise value
            yield value
    finally:
        stop.set()
        while t.is_alive():  # let a blocked put finish so the thread ends
            try:
                q.get_nowait()
            except queue.Empty:
                pass
            t.join(0.01)


def bench_device(device) -> torch.device:
    """``device`` as a torch.device; raises when it names a card and there
    is none (the bench tools never fall back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: torch.cuda.is_available() is false")
    return device


def card_of(device) -> str:
    """The card as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` names it (the line of ``device``'s index), or
    "cpu"."""
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    lines = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    return lines[device.index or 0].strip()


def p50_p99(ms: Sequence[float]) -> Tuple[float, float]:
    a = np.asarray(ms, np.float64)
    return float(np.percentile(a, 50)), float(np.percentile(a, 99))


def call_times(fn: Callable, inputs: Sequence, warmup: int, timed: int, device) -> List[float]:
    """Milliseconds of each of ``timed`` calls ``fn(inputs[i % len])`` run
    back to back after ``warmup`` calls: on a card, between CUDA events
    recorded before and after each call (the calls' device spans; their sum
    is the run's), the events read once at the end; on the CPU, the host
    clock."""
    n = len(inputs)
    for i in range(warmup):
        fn(inputs[i % n])
    if torch.device(device).type != "cuda":
        times = []
        for i in range(timed):
            t0 = time.perf_counter()
            fn(inputs[(warmup + i) % n])
            times.append((time.perf_counter() - t0) * 1e3)
        return times
    events = [torch.cuda.Event(enable_timing=True) for _ in range(timed + 1)]
    torch.cuda.synchronize(device)
    events[0].record()
    for i in range(timed):
        fn(inputs[(warmup + i) % n])
        events[i + 1].record()
    events[-1].synchronize()
    return [events[i].elapsed_time(events[i + 1]) for i in range(timed)]
