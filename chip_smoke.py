#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0, no result line):
  1. device: CUDA must be available; prints the card's name and power limit.
  2. build:  compiles each autoware_vision_pilot_tpu_torch/csrc/*.cu with its
             own nvcc for sm_90a, all at once, into build/torch_kernels/.
  3. kernel: the fused-preprocess kernel against its plain PyTorch version
             on the card, 720x1280 and 375x1242 -> 320x640, f32 (1e-5
             absolute) and bf16 (one bf16 ulp), with CUDA-event and
             torch.profiler device times.
  4. int8 kernels: the int8 quantize and conv kernels against their plain
             versions at six main-path shapes, bf16 and f32 outputs, scalar
             and per-channel scales: quantized values, int32 accumulators
             and outputs bit-equal. Times of the kernels, the plain versions
             and a bf16 cuDNN conv of the same shape, as CUDA-event and
             profiler device times.
  5. f32:    the main path (build_pipeline_fused, full width and depth) on
             one 720p frame, on the card with TF32 off against the CPU, same
             seeded weights: logits within 1e-3 * max|CPU|.
  6. bf16:   the main path on 60 distinct seeded 720p frames held on the
             card, 10 warm-up and 50 timed with CUDA events; checks shapes,
             dtypes, ranges and that every frame launched the kernel.
  7. int8:   the same on the selective-int8 main path (int8=True, min_ch
             256, bench.py's default): 72 int8 conv launches per frame; then
             a few frames against the same modules routed through the int8
             kernels' plain versions (masks >= 99.9 % equal, logits within
             1e-2 * max|ref|), and the int8-vs-bf16 mask agreement for
             information (random weights: no bar).
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
CL = torch.channels_last
# (window, cin, cout, h, w) of main-path int8 convs at 320x640
INT8_SHAPES = (
    (3, 1456, 768, 20, 40),   # EgopathNeck.decode_layer_0, K = 13104
    (3, 1280, 768, 20, 40),   # SceneNeck.decode_layer_0
    (3, 512, 512, 80, 160),   # decode_layer_4
    (3, 256, 256, 160, 320),  # SceneSegHead.decode_layer_6, M = 51200
    (1, 1152, 320, 10, 20),   # stage-7 MBConv project
    (1, 672, 28, 1, 1),       # SE fc1, M = 1, N = 28
)
TIMED_INT8 = INT8_SHAPES[3]   # the JSON line's times: the largest M
INT8_REF_FRAMES = 4


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


def device_us(fn, inputs):
    """Mean device microseconds per call of fn(x) over ``inputs``: the sum
    of every kernel's own time in a torch.profiler trace of the run."""
    from torch.profiler import ProfilerActivity, profile

    fn(inputs[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for x in inputs:
            fn(x)
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()) / len(inputs)


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
            kernel = lambda x: fused_preprocess(x, OUT_HW, dtype)  # noqa: E731
            plain = lambda x: preprocess_imagenet(x[None], OUT_HW, dtype)  # noqa: E731
            ms, plain_ms = cuda_ms(kernel, pool), cuda_ms(plain, pool)
            us, plain_us = device_us(kernel, pool), device_us(plain, pool)
            print(f"kernel fused_preprocess {hw[0]}x{hw[1]}->{OUT_HW[0]}x"
                  f"{OUT_HW[1]} {str(dtype)[6:]}: max_abs_err {err!r}"
                  + (f" ({ulps!r} bf16 ulp, tol 1 ulp)" if ulps is not None
                     else " (tol 1e-5)")
                  + f", kernel {ms!r} ms, plain {plain_ms!r} ms (CUDA events); "
                  f"kernel {us!r} us, plain {plain_us!r} us (profiler device time)")
            if not ok:
                raise AssertionError("fused_preprocess disagrees with its plain version")
            if hw == FRAME_HW and dtype == torch.bfloat16:
                record = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
        del pool
    return record


def phase_int8_kernels(card):
    """The int8 kernels against their plain versions at main-path shapes;
    -> the JSON records of int8_quantize and int8_conv."""
    import torch.nn.functional as F
    from autoware_vision_pilot_tpu_torch.ops.kernels.int8_conv import (
        int8_conv, int8_conv_plain, int8_quantize, int8_quantize_plain)

    g = torch.Generator().manual_seed(SEED + 4)
    worst = {"int8_quantize": 0.0, "int8_conv": 0.0}
    records = {}
    for shape in INT8_SHAPES:
        k, cin, cout, h, w = shape
        pad = k // 2
        x = torch.randn(1, cin, h, w, generator=g).contiguous(memory_format=CL)
        weight = torch.randint(-127, 128, (cout, cin, k, k), generator=g,
                               dtype=torch.int8).contiguous(memory_format=CL).cuda()
        w_scale = (torch.rand(cout, generator=g) * 1e-3 + 1e-4).cuda()
        scales = {  # amax / 127 in float64, then f32, as calibration does
            "scalar": torch.tensor(float(x.abs().max()) / 127.0),
            "vector": (x.double().abs().amax(dim=(0, 2, 3)) / 127.0).float()}
        for dtype in (torch.bfloat16, torch.float32):
            xd = x.to(dtype).cuda().contiguous(memory_format=CL)
            bias = (torch.randn(cout, generator=g) * 0.1).to(dtype).cuda()
            for kind, sx in scales.items():
                sx = sx.cuda()
                xq, xq_ref = int8_quantize(xd, sx), int8_quantize_plain(xd, sx)
                acc = int8_conv(xq, weight, w_scale, sx, bias, pad, torch.int32)
                acc_ref = int8_conv_plain(xq_ref, weight, w_scale, sx, bias, pad,
                                          torch.int32)
                y = int8_conv(xq, weight, w_scale, sx, bias, pad, dtype)
                y_ref = int8_conv_plain(xq_ref, weight, w_scale, sx, bias, pad, dtype)
                torch.cuda.synchronize()
                q_err = (xq.int() - xq_ref.int()).abs().max().item()
                acc_err = (acc.long() - acc_ref.long()).abs().max().item()
                y_err = (y.float() - y_ref.float()).abs().max().item()
                ok = (q_err == 0 and acc_err == 0 and y.shape == y_ref.shape
                      and torch.equal(y, y_ref))
                print(f"int8 {k}x{k} {cin}->{cout} at {h}x{w}, {str(dtype)[6:]}, "
                      f"{kind} scale: quantize max_abs_err {q_err}, int32 acc "
                      f"max_abs_err {acc_err}, output max_abs_err {y_err!r} "
                      f"(tol 0: bit-equal)")
                if not ok:
                    raise AssertionError("int8 kernels disagree with their plain versions")
                worst["int8_quantize"] = max(worst["int8_quantize"], float(q_err))
                worst["int8_conv"] = max(worst["int8_conv"], y_err)
            if dtype != torch.bfloat16:
                continue
            # times on the main path's configuration: bf16, scalar scale
            sx = scales["scalar"].cuda()
            xq = int8_quantize(xd, sx)
            w16 = torch.randn(cout, cin, k, k, generator=g).to(
                dtype=dtype, memory_format=CL).cuda()
            reps = [xd] * 20
            fns = {
                "quantize kernel": lambda a: int8_quantize(a, sx),
                "quantize plain": lambda a: int8_quantize_plain(a, sx),
                "conv kernel": lambda a: int8_conv(xq, weight, w_scale, sx, bias, pad, dtype),
                "conv plain": lambda a: int8_conv_plain(xq, weight, w_scale, sx, bias,
                                                         pad, dtype),
                "bf16 cuDNN conv": lambda a: F.conv2d(a, w16, bias, 1, pad),
            }
            t = {name: (cuda_ms(fn, reps), device_us(fn, reps[:5]))
                 for name, fn in fns.items()}
            gop = 2.0 * h * w * cout * cin * k * k / 1e9
            conv_us = t["conv kernel"][1]
            rate = (f"{gop / (conv_us * 1e-6) / 1e3!r} TOP/s" if conv_us > 0
                    else "not measured (no profiler device time)")
            print(f"int8 times {k}x{k} {cin}->{cout} at {h}x{w}, bf16, {card}: "
                  + "; ".join(f"{n} {ms!r} ms (events) {us!r} us (profiler)"
                              for n, (ms, us) in t.items())
                  + f"; {gop!r} GOP, conv kernel {rate}")
            if shape == TIMED_INT8:
                records = {
                    "int8_quantize": dict(ms=t["quantize kernel"][0],
                                          plain_ms=t["quantize plain"][0]),
                    "int8_conv": dict(ms=t["conv kernel"][0],
                                      plain_ms=t["conv plain"][0])}
        del xd, weight
        torch.cuda.empty_cache()
    return {name: dict(max_abs_err=worst[name], **rec) for name, rec in records.items()}


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


def counters():
    from autoware_vision_pilot_tpu_torch.ops.kernels.int8_conv import int8_conv, int8_quantize
    from autoware_vision_pilot_tpu_torch.ops.kernels.preprocess_kernel import fused_preprocess
    return {"fused_preprocess": fused_preprocess, "int8_quantize": int8_quantize,
            "int8_conv": int8_conv}


def drive(pipe, pool, name, card):
    """The main path on every frame of ``pool``, one at a time, with the
    kernels' launch counts set to 0 just before and read just after;
    checks every output and prints p50/p99 of the timed frames. -> the
    counts."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    expect = [((1, *OUT_HW), torch.int32), ((1, *OUT_HW, 1), torch.float32),
              ((1, OUT_HW[0] // 4, OUT_HW[1] // 4, 3), torch.float32)]
    latencies = []
    torch.cuda.synchronize()
    for fn in counters().values():
        fn.launches = 0  # count only this main path's launches
    for i in range(len(pool)):
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
    launches = {k: fn.launches for k, fn in counters().items()}
    timed = np.asarray(latencies[WARM:])
    p50, p99 = (float(np.percentile(timed, q)) for q in (50, 99))
    print(f"{name} main path, batch 1, {FRAME_HW[0]}x{FRAME_HW[1]} -> "
          f"{OUT_HW[0]}x{OUT_HW[1]}, {card}: p50 {p50!r} ms, p99 {p99!r} ms, "
          f"mean {float(timed.mean())!r} ms over {len(timed)} frames after "
          f"{WARM} warm-up (CUDA events per frame); launches {launches}")
    return launches


def expect_launches(launches, expected):
    for k, n in expected.items():
        if launches[k] != n:
            raise AssertionError(f"{launches[k]} {k} launches, expected {n}")


def phase_bf16(card):
    from autoware_vision_pilot_tpu_torch.pipeline import build_pipeline_fused

    pipe = build_pipeline_fused("cuda", torch.bfloat16, SEED, CTX_HW, OUT_HW)
    n = WARM + TIMED
    launches = drive(pipe, frames(n, FRAME_HW, SEED + 3).cuda(), "bf16", card)
    expect_launches(launches, {"fused_preprocess": n, "int8_quantize": 0,
                               "int8_conv": 0})
    return pipe


def mask_agreement(a, b):
    return (a == b).float().mean().item()


def phase_int8(card, bf16_pipe):
    from autoware_vision_pilot_tpu_torch.export.quantize import int8_conv_count
    from autoware_vision_pilot_tpu_torch.nn.layers import Int8Conv2d
    from autoware_vision_pilot_tpu_torch.pipeline import build_pipeline_fused

    t0 = time.perf_counter()
    pipe = build_pipeline_fused("cuda", torch.bfloat16, SEED, CTX_HW, OUT_HW,
                                int8=True, min_ch=256)
    torch.cuda.synchronize()
    convs = int8_conv_count(pipe.stack) + int8_conv_count(pipe.lanes)
    print(f"int8 build (quantize + calibrate on 4 noise batches per network): "
          f"{time.perf_counter() - t0:.1f} s, {convs} int8 convs")
    if convs != 72:
        raise AssertionError(f"{convs} int8 convs, expected 72")
    n = WARM + TIMED
    pool = frames(n, FRAME_HW, SEED + 5).cuda()
    launches = drive(pipe, pool, "int8", card)
    expect_launches(launches, {"fused_preprocess": n, "int8_quantize": 72 * n,
                               "int8_conv": 72 * n})

    # the same modules with the int8 convs routed to the plain versions
    modules = [m for net in (pipe.stack, pipe.lanes) for m in net.modules()
               if isinstance(m, Int8Conv2d)]
    kernel_out = [pipe.logits(pool[i]) for i in range(INT8_REF_FRAMES)]
    for m in modules:
        m.plain = True
    plain_out = [pipe.logits(pool[i]) for i in range(INT8_REF_FRAMES)]
    for m in modules:
        m.plain = False
    bf16_out = [bf16_pipe.logits(pool[i]) for i in range(INT8_REF_FRAMES)]
    for i, (got, ref, b16) in enumerate(zip(kernel_out, plain_out, bf16_out)):
        agree = mask_agreement(got[0].argmax(-1), ref[0].argmax(-1))
        lanes_agree = mask_agreement(got[2] > 0, ref[2] > 0)
        vs_bf16 = mask_agreement(got[0].argmax(-1), b16[0].argmax(-1))
        errs = []
        for name, a, b in zip(("seg", "depth", "lanes"), got, ref):
            err = (a.float() - b.float()).abs().max().item()
            tol = 1e-2 * b.float().abs().max().item()
            errs.append(f"{name} {err!r} (tol {tol!r})")
            if not err <= tol:
                raise AssertionError(f"frame {i} {name}: int8 kernels vs plain {err} > {tol}")
        print(f"int8 frame {i}, kernels vs plain versions: class-mask agreement "
              f"{agree!r}, lane-mask agreement {lanes_agree!r}, logits max_abs_err "
              + ", ".join(errs) + f"; int8 vs bf16 class-mask agreement {vs_bf16!r} "
              "(information only: random weights)")
        if agree < 0.999 or lanes_agree < 0.999:
            raise AssertionError(f"frame {i}: masks of the int8 kernels and the "
                                 "plain versions agree on less than 99.9 %")
    return launches


def main():
    card = phase_device()
    sys.path.insert(0, str(REPO))
    phase_build()
    records = {"fused_preprocess": phase_kernel(), **phase_int8_kernels(card)}
    phase_f32()
    bf16_pipe = phase_bf16(card)
    launches = phase_int8(card, bf16_pipe)  # the slice's main path
    sources = {
        "fused_preprocess": ("autoware_vision_pilot_tpu_torch/csrc/preprocess.cu",
                             "autoware_vision_pilot_tpu/ops/pallas/preprocess_kernel.py:51"),
        "int8_quantize": ("autoware_vision_pilot_tpu_torch/csrc/int8_conv.cu",
                          "autoware_vision_pilot_tpu/nn/layers.py:103"),
        "int8_conv": ("autoware_vision_pilot_tpu_torch/csrc/int8_conv.cu",
                      "autoware_vision_pilot_tpu/nn/layers.py:110"),
    }
    print(card)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": launches[name], **records[name]}
        for name, (src, replaces) in sources.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
