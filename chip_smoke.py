#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0, no result line):
  1. device: CUDA must be available; prints the card's name and power limit.
  2. build:  compiles autoware_vision_pilot_tpu_torch/csrc/*.cu with nvcc
             for sm_90a into build/torch_kernels/ and prints the seconds.
  3. kernel: the fused-preprocess kernel against its plain PyTorch version
             on the card, 720x1280 and 375x1242 -> 320x640, f32 (1e-5
             absolute) and bf16 (one bf16 ulp), with CUDA-event times.
  4. f32:    the main path (build_pipeline_fused, full width and depth) on
             one 720p frame, on the card with TF32 off against the CPU, same
             seeded weights: logits within 1e-3 * max|CPU|.
  5. bf16:   the main path on 60 distinct seeded 720p frames held on the
             card, 10 warm-up and 50 timed with CUDA events; checks shapes,
             dtypes, ranges and that every frame launched the kernel.
Then one JSON line {"kernels": [...]} and, last, the device line
{"ok": true, "device": {...}}. Imports nothing of JAX.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parent
FRAME_HW = (720, 1280)
ODD_HW = (375, 1242)  # a KITTI-sized frame: upscale rows, downscale columns
OUT_HW = (320, 640)
CTX_HW = (10, 20)
SEED = 0
WARM, TIMED = 10, 50


def frames(n, hw, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 256, (n, *hw, 3), dtype=np.uint8))


def cuda_ms(fn, inputs):
    """Mean device milliseconds of fn(x) over ``inputs`` (after 3 warm-up
    calls), from CUDA events around the whole run."""
    for x in inputs[:3]:
        fn(x)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for x in inputs:
        fn(x)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / len(inputs)


def bf16_ulps(a, b):
    """max |a - b| in units of the bf16 spacing at b."""
    a, b = a.float(), b.float()
    ulp = torch.exp2(torch.floor(torch.log2(b.abs())) - 7)
    return ((a - b).abs() / ulp.clamp_min(2.0 ** -133)).max().item()


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    return card


def phase_build():
    from autoware_vision_pilot_tpu_torch.kernels import build
    t0 = time.perf_counter()
    build.load()
    print(f"build: {time.perf_counter() - t0:.1f} s -> "
          f"{build.LIBRARY.relative_to(REPO)}")


def phase_kernel():
    from autoware_vision_pilot_tpu_torch.ops.kernels.preprocess_kernel import fused_preprocess
    from autoware_vision_pilot_tpu_torch.ops.preprocess import preprocess_imagenet

    record = None
    for hw in (FRAME_HW, ODD_HW):
        pool = frames(32, hw, SEED + 1).cuda()  # 88 MB at 720p, above the L2
        for dtype in (torch.float32, torch.bfloat16):
            before = fused_preprocess.launches
            out = fused_preprocess(pool[0], OUT_HW, dtype)
            torch.cuda.synchronize()
            if fused_preprocess.launches != before + 1:
                raise AssertionError("fused_preprocess did not count its launch")
            ref = preprocess_imagenet(pool[0][None], OUT_HW, dtype).permute(0, 3, 1, 2)
            if out.shape != (1, 3, *OUT_HW) or out.dtype != dtype or \
                    not out.is_contiguous(memory_format=torch.channels_last):
                raise AssertionError(f"kernel output {out.shape} {out.dtype}")
            err = (out.float() - ref.float()).abs().max().item()
            ulps = bf16_ulps(out, ref) if dtype == torch.bfloat16 else None
            ok = err <= 1e-5 if dtype == torch.float32 else ulps <= 1.0
            ms = cuda_ms(lambda x: fused_preprocess(x, OUT_HW, dtype), pool)
            plain_ms = cuda_ms(
                lambda x: preprocess_imagenet(x[None], OUT_HW, dtype), pool)
            print(f"kernel fused_preprocess {hw[0]}x{hw[1]}->{OUT_HW[0]}x"
                  f"{OUT_HW[1]} {str(dtype)[6:]}: max_abs_err {err!r}"
                  + (f" ({ulps!r} bf16 ulp, tol 1 ulp)" if ulps is not None
                     else " (tol 1e-5)")
                  + f", kernel {ms!r} ms, plain {plain_ms!r} ms (CUDA events)")
            if not ok:
                raise AssertionError("fused_preprocess disagrees with its plain version")
            if hw == FRAME_HW and dtype == torch.bfloat16:
                record = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
        del pool
    return record


def phase_f32():
    from autoware_vision_pilot_tpu_torch.pipeline import build_pipeline_fused

    # Full f32 on the card: cuDNN convs default to TF32, which keeps ~3
    # decimal digits and could not be held to the CPU at this bar.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    frame = frames(1, FRAME_HW, SEED + 2)[0]
    t0 = time.perf_counter()
    cpu = build_pipeline_fused("cpu", torch.float32, SEED, CTX_HW, OUT_HW)
    ref = cpu.logits(frame)
    del cpu
    t1 = time.perf_counter()
    gpu = build_pipeline_fused("cuda", torch.float32, SEED, CTX_HW, OUT_HW)
    out = [t.cpu() for t in gpu.logits(frame.cuda())]
    del gpu
    torch.cuda.empty_cache()
    print(f"f32 main path: CPU {t1 - t0:.1f} s, card {time.perf_counter() - t1:.1f} s"
          " (build and one frame each)")
    for name, a, b in zip(("seg logits", "depth", "lane logits"), out, ref):
        if a.shape != b.shape:
            raise AssertionError(f"{name}: {a.shape} vs {b.shape}")
        err = (a - b).abs().max().item()
        tol = 1e-3 * b.abs().max().item()
        print(f"f32 card vs CPU {name} {tuple(a.shape)}: max_abs_err {err!r}, "
              f"tol {tol!r}")
        if not err <= tol:
            raise AssertionError(f"{name}: card and CPU disagree")


def phase_bf16(card):
    from autoware_vision_pilot_tpu_torch.ops.kernels.preprocess_kernel import fused_preprocess
    from autoware_vision_pilot_tpu_torch.pipeline import build_pipeline_fused

    pipe = build_pipeline_fused("cuda", torch.bfloat16, SEED, CTX_HW, OUT_HW)
    pool = frames(WARM + TIMED, FRAME_HW, SEED + 3).cuda()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    expect = [((1, *OUT_HW), torch.int32), ((1, *OUT_HW, 1), torch.float32),
              ((1, OUT_HW[0] // 4, OUT_HW[1] // 4, 3), torch.float32)]
    latencies = []
    torch.cuda.synchronize()
    fused_preprocess.launches = 0  # count only the main path's launches
    for i in range(WARM + TIMED):
        start.record()
        outs = pipe(pool[i])
        end.record()
        end.synchronize()
        latencies.append(start.elapsed_time(end))
        mask, depth01, lanes = outs
        for t, (shape, dtype) in zip(outs, expect):
            if tuple(t.shape) != shape or t.dtype != dtype:
                raise AssertionError(f"frame {i}: {tuple(t.shape)} {t.dtype}, "
                                     f"expected {shape} {dtype}")
            if not torch.isfinite(t.float()).all():
                raise AssertionError(f"frame {i}: non-finite output")
        if not (mask.min() >= 0 and mask.max() <= 2):
            raise AssertionError(f"frame {i}: class ids outside 0..2")
        if not (depth01.min() >= 0 and depth01.max() <= 1):
            raise AssertionError(f"frame {i}: depth outside [0, 1]")
        if not ((lanes == 0) | (lanes == 1)).all():
            raise AssertionError(f"frame {i}: lane masks not in {{0, 1}}")
    launches = fused_preprocess.launches
    if launches != WARM + TIMED:
        raise AssertionError(f"{launches} kernel launches for {WARM + TIMED} frames")
    timed = np.asarray(latencies[WARM:])
    p50, p99 = (float(np.percentile(timed, q)) for q in (50, 99))
    print(f"bf16 main path, batch 1, {FRAME_HW[0]}x{FRAME_HW[1]} -> "
          f"{OUT_HW[0]}x{OUT_HW[1]}, {card}: p50 {p50!r} ms, p99 {p99!r} ms, "
          f"mean {float(timed.mean())!r} ms over {TIMED} frames after {WARM} "
          f"warm-up (CUDA events per frame)")
    return launches


def main():
    card = phase_device()
    sys.path.insert(0, str(REPO))
    phase_build()
    record = phase_kernel()
    phase_f32()
    launches = phase_bf16(card)
    print(json.dumps({"kernels": [{
        "name": "fused_preprocess", "route": "cuda",
        "source": "autoware_vision_pilot_tpu_torch/csrc/preprocess.cu",
        "replaces": "autoware_vision_pilot_tpu/ops/pallas/preprocess_kernel.py:51",
        "launches": launches, **record}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
