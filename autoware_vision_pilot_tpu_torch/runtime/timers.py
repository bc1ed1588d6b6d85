"""Per-stage pipeline timing: the port's own copy of
autoware_vision_pilot_tpu/runtime/timers.py (pure Python), whose
PerformanceMetrics also keeps each frame's end-to-end time.

- FpsTimer: preprocess/inference/output stage timing printed every N frames
  (middleware_recipes/common/benchmark/fps_timer.cpp:5-64).
- PerformanceMetrics: capture/inference/display/e2e accumulators printed
  every 30 frames (production_release/main.cpp:305-313, 1404-1421).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field


class FpsTimer:
    def __init__(self, report_every: int = 100, name: str = "pipeline"):
        self.report_every = report_every
        self.name = name
        self.reset()

    def reset(self):
        self.frames = 0
        self.pre_us = 0.0
        self.inf_us = 0.0
        self.out_us = 0.0
        self._t0 = self._t1 = self._t2 = self._t3 = 0.0
        self._wall0 = time.perf_counter()

    def start_new_frame(self):
        self._t0 = time.perf_counter()

    def record_preprocess_end(self):
        self._t1 = time.perf_counter()

    def record_inference_end(self):
        self._t2 = time.perf_counter()

    def record_output_end(self):
        self._t3 = time.perf_counter()
        self.pre_us += (self._t1 - self._t0) * 1e6
        self.inf_us += (self._t2 - self._t1) * 1e6
        self.out_us += (self._t3 - self._t2) * 1e6
        self.frames += 1
        if self.frames % self.report_every == 0:
            self.print_results()

    def print_results(self):
        n = max(self.frames, 1)
        wall = time.perf_counter() - self._wall0
        fps = self.frames / wall if wall > 0 else 0.0
        print(f"[{self.name}] frames={self.frames} "
              f"pre={self.pre_us / n:.0f}us inf={self.inf_us / n:.0f}us "
              f"out={self.out_us / n:.0f}us fps={fps:.1f}")


@dataclass
class PerformanceMetrics:
    report_every: int = 30
    frames: int = 0
    capture_us: float = 0.0
    inference_us: float = 0.0
    display_us: float = 0.0
    e2e_us: float = 0.0
    _wall0: float = field(default_factory=time.perf_counter)
    # each frame's e2e seconds, for percentiles (the port's addition)
    e2e_samples: list = field(default_factory=list)

    def add_frame(self, capture_s=0.0, inference_s=0.0, display_s=0.0,
                  e2e_s=0.0):
        self.frames += 1
        self.capture_us += capture_s * 1e6
        self.inference_us += inference_s * 1e6
        self.display_us += display_s * 1e6
        self.e2e_us += e2e_s * 1e6
        self.e2e_samples.append(e2e_s)
        if self.frames % self.report_every == 0:
            self.report()

    def report(self):
        n = max(self.frames, 1)
        wall = time.perf_counter() - self._wall0
        fps = self.frames / wall if wall > 0 else 0.0
        print(f"[metrics] frames={self.frames} fps={fps:.1f} "
              f"capture={self.capture_us / n:.0f}us "
              f"infer={self.inference_us / n:.0f}us "
              f"display={self.display_us / n:.0f}us "
              f"e2e={self.e2e_us / n:.0f}us")
