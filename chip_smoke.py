#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py
    python3 chip_smoke.py --parent ROOT       # also time the lane-filter walk
                                              # and NMS kernels of the port in
                                              # ROOT (an earlier commit, from
                                              # git archive) against this
                                              # tree's: parent, this, this,
                                              # parent
    python3 chip_smoke.py --host-costs ROOT   # phase 7's host costs alone, of
                                              # the package in ROOT

Phases, each of which raises on failure (exit code != 0, no result line):
  1. device: CUDA must be available; prints the card's name and power limit.
  2. build:  compiles each autoware_vision_pilot_tpu_torch/csrc/*.cu with its
             own nvcc for sm_90a, all at once, into build/torch_kernels/;
             then the launch floor: the profiler device time of an empty
             kernel (csrc/launch_floor.cu) at the launch shapes of the walk
             and NMS kernels.
  3. kernel: the fused-preprocess kernel against its plain PyTorch version
             on the card, 720x1280 and 375x1242 -> 320x640, 360x640 ->
             180x321 (a width that is not a multiple of 8) and the lateral
             step's crop 720x1280[420:] -> 320x640, f32 and bf16,
             bit-equal, with CUDA-event and torch.profiler device times.
  4. int8 kernels: the int8 quantize and conv kernels against their plain
             versions at shapes that between them take every route of
             int8_conv_plan (wgmma, split-K, mma.sync, pointwise, dot; every
             1x1 conv of the main path, a ragged N, a batch of two), bf16
             and f32 outputs, scalar and per-channel scales, through
             int8_conv on the int8 input and int8_conv2d on the float one:
             quantized values, int32 accumulators and outputs bit-equal.
             Then every one of the 24 distinct int8 conv shapes of the main
             path, bf16 with a scalar scale, timed over rotating inputs
             that together exceed the 50 MB L2: profiler device time of the
             conv and the quantize (and of the conv with one block per unit
             of work in place of the persistent blocks; at a 1x1 conv, of
             int8_conv2d, which absorbs the quantize, and of PR 2's mma.sync
             kernel on the same inputs), the bound, the share of the bound,
             and two yardsticks that the port never calls: the bf16 cuDNN
             conv of the same shape and torch._int_mm on a pre-built im2col
             matrix.
  5. lane filter: the lane-filter walk kernel against its plain version
             (torch.equal on the weight images and start points) on 30 mask
             sets from the script's own rasteriser (10 kinds of scene x 2
             seeds at 80x160, and at 24x48) and 19 edge sets (widths not a
             multiple of 32, 320x320, 4096x25, 1x1, windows at the four
             edges, masks 4 bytes off 16); its profiler time and bound, its
             stage split from the kernel's own %globaltimer stamps, the plain
             version's time and launches (and with --parent the parent's
             kernel, in turns).
  6. f32:    the main path (build_pipeline_fused, full width and depth) on
             one 720p frame, on the card with TF32 off against the CPU, same
             seeded weights: logits within 1e-3 * max|CPU|.
  7. bf16:   the main path on 60 distinct seeded 720p frames held on the
             card, 10 warm-up and 50 timed with CUDA events; checks shapes,
             dtypes, ranges and that every frame launched the kernel.
  8. int8:   the same on the selective-int8 main path (int8=True, min_ch
             256, bench.py's default): 72 int8 conv launches per frame by
             route (18 wgmma, 12 split-K, 22 pointwise, 20 dot, none on
             mma.sync) and 30 quantize launches (the 1x1 convs quantize as
             they load); on one
             frame, each of the 72 int8 convs against its plain version on
             the same input (torch.equal); device time per frame by kind of
             kernel and route over 20 frames (torch.profiler), and the wgmma kernel's
             at each 3x3 int8 conv of the frame; host time per conv call
             at the 72 int8 layers, int8 against bf16, with both paths'
             frame latency p50 from the same rounds; then a
             few frames against the same modules routed through the plain
             versions (masks >= 99.9 % equal, logits within 1e-2 * max|ref|),
             and the int8-vs-bf16 mask agreement for information (random
             weights: no bar).
  9. lateral f32: the lateral program (build_lateral_pipeline, full width)
             in f32 on the card against the CPU over 3 frames: the networks'
             logits within 1e-3 * max|CPU|; fed the CPU's logits, the
             classical chain's masks and flags equal and its lane fits
             within 5e-3 * max|CPU|.
 10. lateral: the lateral program in bf16 on 60 distinct 720p frames with
             the state carried, each step under sync-debug "error" (no host
             synchronisation), 10 warm-up and 50 timed with CUDA events:
             one preprocess and one lane-filter launch a frame, finite
             outputs of the right shapes, and device time by kind of kernel
             over 20 frames (torch.profiler).
 11. letterbox: the preprocess kernel's letterbox mode against its plain
             version (ops/preprocess.py::letterbox), bit-equal in f32 and
             bf16, at 720x1280 -> 640x640, 375x1242 -> 640x640 and 360x640
             -> 181x333 (pad columns, a width that is not a multiple of 8);
             its profiler time at 720p, bound, and the plain version's time.
 12. longitudinal f32: the longitudinal program (build_longitudinal_pipeline,
             AutoSpeed "n" at 640x640) in f32 on the card against the CPU,
             same seeded weights, 3 frames: pred within 1e-3 * max|CPU|;
             fed the CPU's pred, the packed (64, 7) table equal.
 13. NMS: the NMS kernel against its plain version (torch.equal on every
             output) on 35 candidate sets: the CPU's head outputs of phase
             12, and random, dense same-class, all-below-threshold, grid
             (more than 64 survivors), tied-score and small (A < 256) scenes,
             class-aware and not; then at k = 1, 31, 32, 33, 255, 256, 257
             and 1024, live, all-dead, degenerate (clamped, tied) and NaN
             candidates, at clusters of 1, 2, 4 and 8 blocks and the
             wrapper's choice, bit for bit; its profiler time on the head
             outputs, its stage split from its stamps, its bound, and the
             plain version's time and launches (and with --parent the
             parent's kernel, in turns).
 14. longitudinal: the longitudinal program in bf16 on 60 distinct 720p
             frames, each step under sync-debug "error", 10 warm-up and 50
             timed with CUDA events (and the host's enqueue time): one
             letterbox and one NMS launch a frame, a well-formed table, and
             device time by kind of kernel over 20 frames (torch.profiler).
 15. batched kernels: the preprocess kernel on the lateral crop
             frames[:, 420:] of an (N, 720, 1280, 3) batch (read in place),
             the letterbox mode, the walk and NMS at N = 1, 3 and 8, one
             launch a batch: every stream bit-equal to the plain version
             and to a launch on that stream alone; the time at N = 8 beside
             8 x the time at N = 1.
 16. fleet f32: the batched lateral and longitudinal steps at N = 3 in
             f32 against 3 single-stream pipelines on the card over 3
             ticks: the networks within 1e-3 * max|single|; fed the single
             streams' network outputs, masks, flags and AutoSteer equal,
             lane fits within 5e-3 * max|single|, detection tables equal.
 17. engine: app.py::build_engine(Config()) in bf16 at full width on 60
             distinct 720p host frames, pipeline depth 1, 2, 2, 1, every
             dispatch under sync-debug "error": in-order finite results,
             the tracker fed every frame's detections, one launch of each
             of the four kernels a frame; host-loop and CUDA-event p50/p99
             and the device's busy share.
 18. fleet: FleetEngine over 8 streams in bf16 at full width, 30 ticks,
             every dispatch under sync-debug "error": one launch of each of
             the four kernels a tick; tick p50/p99 and frames a second.
The run prints its wall time.
"""
from __future__ import annotations

import json
import math
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
LATERAL_CROP = 420  # the lateral step's crop, frame[420:]: 300x1280
# (source, output, first source row) of phase 3; the third output width is
# not a multiple of 8; the last is the lateral step's crop
PREPROCESS_SIZES = ((FRAME_HW, OUT_HW, 0), (ODD_HW, OUT_HW, 0), ((360, 640), (180, 321), 0),
                    (FRAME_HW, OUT_HW, LATERAL_CROP))
CTX_HW = (10, 20)
SEED = 0
WARM, TIMED = 10, 50
CL = torch.channels_last
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, published
INT8_OPS_PER_S = 1979e12    # H100 SXM int8 tensor cores, dense, published
F32_OPS_PER_S = 67e12       # H100 SXM f32 outside the tensor cores, published
L2_BYTES = 50e6
# (window, cin, cout, h, w, batch, route) checked bit for bit in every
# variant: main-path shapes (every 1x1 one), then more shapes for each route
INT8_SHAPES = (
    (3, 1456, 768, 20, 40, 1, "splitk"),   # EgopathNeck.decode_layer_0, K = 13104
    (3, 1280, 768, 20, 40, 1, "splitk"),   # SceneNeck.decode_layer_0
    (3, 512, 512, 80, 160, 1, "wgmma"),    # decode_layer_4
    (3, 256, 256, 160, 320, 1, "wgmma"),   # SceneSegHead.decode_layer_6, M = 51200
    (1, 320, 1280, 10, 20, 1, "pointwise"),   # stage-8 head conv, 140 tiles, no split
    (1, 1152, 320, 10, 20, 1, "pointwise"),   # stage-7 MBConv project
    (1, 672, 112, 20, 40, 1, "pointwise"),    # stage-5 MBConv project
    (1, 1152, 192, 10, 20, 1, "pointwise"),   # stage-6 MBConv project, 32-row tiles
    (1, 480, 112, 20, 40, 1, "pointwise"),    # stage-4 -> 5 project
    (1, 480, 80, 20, 40, 1, "pointwise"),     # stage-4 project
    (1, 672, 192, 10, 20, 1, "pointwise"),    # stage-5 -> 6 project
    (1, 1152, 48, 1, 1, 1, "dot"),         # SE fc1 of stages 6-7, M = 1
    (1, 672, 28, 1, 1, 1, "dot"),          # SE fc1 of stage 5, N = 28
    (1, 480, 20, 1, 1, 1, "dot"),          # SE fc1 of stage 4, N = 20
    (3, 480, 200, 60, 90, 1, "wgmma"),     # channel tail, ragged N and pixel rectangles
    (3, 672, 100, 9, 13, 1, "splitk"),     # one tile, 11 splits, channel tail, ragged N
    (3, 64, 96, 20, 40, 1, "mma"),         # a 3x3 window with C < 128
    (1, 672, 100, 9, 13, 1, "pointwise"),  # ragged M and N
    (1, 480, 112, 20, 40, 2, "pointwise"),  # a batch of two
    (1, 1152, 48, 1, 1, 2, "dot"),         # a batch of two SE squeezes
)
CONV_KERNEL = {"wgmma": "int8_conv_wgmma", "splitk": "int8_conv_wgmma", "mma": "int8_conv_mma",
               "pointwise": "int8_conv_pointwise", "dot": "int8_conv_dot"}
# (window, cin, cout, h, w, convs per frame): the 24 distinct int8 convs of
# the main path at 320x640 (72 convs, 669.7 GOP)
MAIN_INT8 = (
    (3, 512, 512, 80, 160, 3), (3, 256, 256, 160, 320, 2), (3, 512, 256, 80, 160, 3),
    (3, 256, 128, 160, 320, 2), (3, 768, 512, 40, 80, 3), (3, 1456, 768, 20, 40, 1),
    (3, 512, 512, 40, 80, 3), (3, 256, 256, 80, 160, 1), (3, 1280, 768, 20, 40, 2),
    (3, 768, 768, 20, 40, 3), (3, 256, 128, 80, 160, 1), (3, 512, 1456, 10, 20, 1),
    (3, 512, 1280, 10, 20, 2), (3, 256, 512, 10, 20, 3), (1, 320, 1280, 10, 20, 2),
    (1, 1152, 320, 10, 20, 2), (1, 672, 112, 20, 40, 4), (1, 1152, 192, 10, 20, 6),
    (1, 480, 112, 20, 40, 2), (1, 480, 80, 20, 40, 4), (1, 672, 192, 10, 20, 2),
    (1, 1152, 48, 1, 1, 8), (1, 672, 28, 1, 1, 6), (1, 480, 20, 1, 1, 6),
)
# the shape at which the JSON line reports each kernel
RECORD_SHAPES = {"int8_quantize": (3, 256, 256, 160, 320), "int8_conv_wgmma": (3, 256, 256, 160, 320),
                 "int8_conv_mma": (1, 1152, 320, 10, 20),
                 "int8_conv_pointwise": (1, 1152, 320, 10, 20),
                 "int8_conv_dot": (1, 1152, 48, 1, 1)}
INT8_REF_FRAMES = 4
PROFILE_FRAMES = 20
HOST_FRAMES = 20  # per round; rounds bf16, int8, int8, bf16


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
    of every kernel's own time in a torch.profiler trace of the run. A
    trace that recorded no device time, or fewer device operations than
    calls (each call launches at least one: a trace that dropped records),
    is taken again, up to five times; then the calls are timed queued
    (queued_us)."""
    from torch.profiler import ProfilerActivity, profile

    fn(inputs[0])
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for x in inputs:
                fn(x)
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages())
        ops = sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)
        if total > 0 and ops >= len(inputs):
            return total / len(inputs)
    us = queued_us(fn, inputs)
    print(f"device_us: the profiler's traces of {getattr(fn, '__name__', fn)} dropped records "
          f"five times; {us!r} us a call from CUDA events around the calls queued behind a "
          f"sleep (back to back on the card, the gaps between them included)")
    return us


def queued_us(fn, inputs):
    """Mean device microseconds per call of fn(x) over ``inputs``, from CUDA
    events around the calls while the card runs them back to back: a
    sleep kernel holds the stream for twice the host's time to enqueue
    them, so the host's launch rate does not set the time."""
    t0 = time.perf_counter()
    fn(inputs[0])
    host_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(int(2 * host_s * len(inputs) * 2e9))  # cycles at up to 2 GHz
    start.record()
    for x in inputs:
        fn(x)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e3 / len(inputs)


def bound(ops, nbytes, ops_per_s=INT8_OPS_PER_S):
    """-> (ms, "operations" or "bytes"): the least time for ``ops``
    operations (int8 unless ``ops_per_s`` says otherwise) and ``nbytes``
    moved once, at the published peaks."""
    t_ops, t_bytes = ops / ops_per_s * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


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


def preprocess_bytes(hw, out_hw):
    """The bytes the fused preprocess must move: the source pixels its
    two-tap lerp reads (the union of the rows y0, y1 by the union of the
    columns x0, x1 of ops/preprocess.py::bilinear_taps), 3 bytes each, and
    the bf16 output."""
    from autoware_vision_pilot_tpu_torch.ops.preprocess import bilinear_taps
    rows, cols = (len(np.union1d(*bilinear_taps(n, m)[:2])) for n, m in zip(hw, out_hw))
    return rows * cols * 3 + out_hw[0] * out_hw[1] * 3 * 2


def phase_kernel():
    """-> (the JSON record of the main path's shape, the lateral crop's
    bf16 timings)."""
    from autoware_vision_pilot_tpu_torch.ops.kernels.preprocess_kernel import fused_preprocess
    from autoware_vision_pilot_tpu_torch.ops.preprocess import preprocess_imagenet

    record = crop_record = None
    for hw, out_hw, y0 in PREPROCESS_SIZES:
        pool = frames(32, hw, SEED + 1).cuda()  # 88 MB at 720p, above the L2
        src = [f[y0:] for f in pool]  # frame[420:] of a contiguous frame is contiguous
        src_hw = (hw[0] - y0, hw[1])
        name = f"{hw[0]}x{hw[1]}" + (f"[{y0}:]" if y0 else "")
        for dtype in (torch.float32, torch.bfloat16):
            before = fused_preprocess.launches
            out = fused_preprocess(src[0], out_hw, dtype)
            torch.cuda.synchronize()
            if fused_preprocess.launches != before + 1:
                raise AssertionError("fused_preprocess did not count its launch")
            ref = preprocess_imagenet(src[0][None], out_hw, dtype).permute(0, 3, 1, 2)
            if out.shape != (1, 3, *out_hw) or out.dtype != dtype or \
                    not out.is_contiguous(memory_format=torch.channels_last):
                raise AssertionError(f"kernel output {out.shape} {out.dtype}")
            err = (out.float() - ref.float()).abs().max().item()
            kernel = lambda x: fused_preprocess(x, out_hw, dtype)  # noqa: E731
            plain = lambda x: preprocess_imagenet(x[None], out_hw, dtype)  # noqa: E731
            ms, plain_ms = cuda_ms(kernel, src), cuda_ms(plain, src)
            us, plain_us = device_us(kernel, src), device_us(plain, src)
            print(f"kernel fused_preprocess {name}->{out_hw[0]}x"
                  f"{out_hw[1]} {str(dtype)[6:]}: max_abs_err {err!r} (tol 0: "
                  f"bit-equal), kernel {ms!r} ms, plain {plain_ms!r} ms (CUDA events); "
                  f"kernel {us!r} us, plain {plain_us!r} us (profiler device time)")
            if not torch.equal(out, ref):
                raise AssertionError("fused_preprocess disagrees with its plain version")
            if dtype == torch.bfloat16 and (hw, y0) in ((FRAME_HW, 0), (FRAME_HW, LATERAL_CROP)):
                nbytes = preprocess_bytes(src_hw, out_hw)
                bound_ms, bound_by = bound(0, nbytes)
                print(f"fused_preprocess {name} bound: {nbytes} bytes read once and written "
                      f"once, {bound_ms * 1e3!r} us at 3.35 TB/s; share "
                      f"{bound_ms * 1e3 / us!r}")
                rec = dict(max_abs_err=err, ms=us / 1e3, plain_ms=plain_us / 1e3,
                           bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
                if y0:
                    crop_record = rec
                else:
                    record = rec
        del pool, src
    return record, crop_record


def int8_inputs(g, shape, dtype):
    k, cin, cout, h, w = shape[:5]
    x = torch.randn(1, cin, h, w, generator=g).to(dtype).contiguous(memory_format=CL)
    weight = torch.randint(-127, 128, (cout, cin, k, k), generator=g,
                           dtype=torch.int8).contiguous(memory_format=CL)
    w_scale = torch.rand(cout, generator=g) * 1e-3 + 1e-4
    bias = (torch.randn(cout, generator=g) * 0.1).to(dtype)
    sx = torch.tensor(float(x.float().abs().max()) / 127.0)
    return x.cuda(), weight.cuda(), w_scale.cuda(), bias.cuda(), sx.cuda()


def check_int8_kernels(g):
    """Every route bit-equal to the plain versions at INT8_SHAPES, through
    int8_conv (int8 input) and int8_conv2d (float input; the pointwise and
    dot routes quantize it as they load it, with no quantize launch). ->
    worst error by kernel."""
    from autoware_vision_pilot_tpu_torch.ops.kernels.int8_conv import (
        FUSED_ROUTES, int8_conv, int8_conv2d, int8_conv_plain, int8_conv_plan, int8_quantize,
        int8_quantize_plain)

    worst = dict.fromkeys(("int8_quantize", *CONV_KERNEL.values()), 0.0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for shape in INT8_SHAPES:
        k, cin, cout, h, w, batch, route = shape
        pad = k // 2
        plan = int8_conv_plan(batch, h, w, cin, cout, k, k, pad, sms)
        if plan.route != route:
            raise AssertionError(f"{shape}: plan {plan}, expected route {route}")
        x = torch.randn(batch, cin, h, w, generator=g)
        x = x * torch.linspace(0.5, 2.0, cin).reshape(1, -1, 1, 1)
        weight = torch.randint(-127, 128, (cout, cin, k, k), generator=g,
                               dtype=torch.int8).contiguous(memory_format=CL).cuda()
        w_scale = (torch.rand(cout, generator=g) * 1e-3 + 1e-4).cuda()
        scales = {  # amax / 127 in float64, then f32, as calibration does
            "scalar": torch.tensor(float(x.abs().max()) * 0.9 / 127.0),  # some clip
            "vector": (x.double().abs().amax(dim=(0, 2, 3)) / 127.0).float()}
        conv_name = CONV_KERNEL[route]
        fused = route in FUSED_ROUTES
        for dtype in (torch.bfloat16, torch.float32):
            xd = x.to(dtype).cuda().contiguous(memory_format=CL)
            bias = (torch.randn(cout, generator=g) * 0.1).to(dtype).cuda()
            for kind, sx in scales.items():
                sx = sx.cuda()
                before = dict(int8_conv.route_launches), int8_quantize.launches
                xq, xq_ref = int8_quantize(xd, sx), int8_quantize_plain(xd, sx)
                acc = int8_conv(xq, weight, w_scale, sx, bias, pad, torch.int32)
                acc_ref = int8_conv_plain(xq_ref, weight, w_scale, sx, bias, pad,
                                          torch.int32)
                y = int8_conv(xq, weight, w_scale, sx, bias, pad, dtype)
                y2d = int8_conv2d(xd, weight, w_scale, sx, bias, pad)
                y_ref = int8_conv_plain(xq_ref, weight, w_scale, sx, bias, pad, dtype)
                torch.cuda.synchronize()
                if int8_conv.route_launches[route] != before[0][route] + 3:
                    raise AssertionError(f"{shape}: the convs did not take route {route}")
                if int8_quantize.launches != before[1] + (1 if fused else 2):
                    raise AssertionError(f"{shape}: {int8_quantize.launches - before[1]} "
                                         "quantize launches")
                q_err = (xq.int() - xq_ref.int()).abs().max().item()
                acc_err = (acc.long() - acc_ref.long()).abs().max().item()
                y_err = max((t.float() - y_ref.float()).abs().max().item() for t in (y, y2d))
                ok = (q_err == 0 and acc_err == 0 and y.shape == y_ref.shape
                      and torch.equal(y, y_ref) and torch.equal(y2d, y_ref))
                print(f"int8 {k}x{k} {cin}->{cout} at {batch}x{h}x{w}, route {route} "
                      f"grid {plan.grid}, {str(dtype)[6:]}, {kind} scale: quantize "
                      f"max_abs_err {q_err}, int32 acc max_abs_err {acc_err}, output "
                      f"max_abs_err {y_err!r} (int8 input and float input"
                      + (", quantized on load" if fused else "") + "; tol 0: bit-equal)")
                if not ok:
                    raise AssertionError("int8 kernels disagree with their plain versions")
                worst["int8_quantize"] = max(worst["int8_quantize"], float(q_err))
                worst[conv_name] = max(worst[conv_name], y_err)
        del xd, weight
        torch.cuda.empty_cache()
    return worst


def time_int8_shapes(g, card):
    """The 24 main-path int8 conv shapes, bf16 with a scalar scale, each
    timed over rotating inputs (and weights) that together exceed the L2
    where the shape allows. At a 1x1 shape also int8_conv2d (one launch
    that quantizes on load: what the main path runs) and PR 2's mma.sync
    kernel on the same int8 inputs. -> the JSON records' timings."""
    import torch.nn.functional as F
    from autoware_vision_pilot_tpu_torch.ops.kernels.int8_conv import (
        _launch, _mma_plan, _reciprocal, int8_conv, int8_conv2d, int8_conv_plain,
        int8_conv_plan, int8_quantize, int8_quantize_plain)

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    # the frame's int8 device time from the shapes alone: the 3x3 convs and
    # their quantize, the 1x1 convs as they run now, and as they ran on the
    # mma.sync kernel after a separate quantize
    frame = dict.fromkeys(("3x3 conv", "3x3 quantize", "1x1 conv (quantize on load)",
                           "1x1 on mma.sync + quantize (before)"), 0.0)
    missing = {k: [] for k in frame}  # shapes the profiler recorded nothing of
    records = {}
    for k, cin, cout, h, w, per_frame in MAIN_INT8:
        pad = k // 2
        plan = int8_conv_plan(1, h, w, cin, cout, k, k, pad, sms)
        M, K = h * w, k * k * cin
        set_bytes = h * w * cin * 3 + cout * K * 3  # x bf16 + xq, w int8 + w bf16
        n = max(2, min(64, math.ceil(1.2 * L2_BYTES / set_bytes)))
        sets = [int8_inputs(g, (k, cin, cout, h, w), torch.bfloat16) for _ in range(n)]
        for s in range(n):
            x, weight, w_scale, bias, sx = sets[s]
            sets[s] = (x, weight, w_scale, bias, sx, int8_quantize(x, sx),
                       weight.to(torch.bfloat16))
            _reciprocal(sx)  # kept on the scale, as a static scale's is on the main path
        idx = list(range(n)) * max(1, math.ceil(20 / n))

        def conv(i):
            x, wt, ws, b, sx, xq, _ = sets[i]
            return int8_conv(xq, wt, ws, sx, b, pad, torch.bfloat16)

        def conv2d(i):
            x, wt, ws, b, sx, _, _ = sets[i]
            return int8_conv2d(x, wt, ws, sx, b, pad)

        def old_mma(i):
            x, wt, ws, b, sx, xq, _ = sets[i]
            return _launch(_mma_plan(M, cout, K, sms), xq, wt, ws, sx, b, pad, torch.bfloat16)

        def conv_one_block_a_unit(i):
            x, wt, ws, b, sx, xq, _ = sets[i]
            return _launch(plan._replace(blocks=math.prod(plan.grid)), xq, wt, ws, sx,
                           b, pad, torch.bfloat16)

        def quant(i):
            return int8_quantize(sets[i][0], sets[i][4])

        def cudnn(i):
            x, _, _, b, _, _, w16 = sets[i]
            return F.conv2d(x, w16, b, 1, pad)

        t = {"conv": device_us(conv, idx), "quantize": device_us(quant, idx),
             "cudnn": device_us(cudnn, idx)}
        if k == 1:
            t["conv2d"], t["old_mma"] = device_us(conv2d, idx), device_us(old_mma, idx)
        conv_ms = cuda_ms(conv, idx)
        # the persistent schedule against one block per unit of work
        one_each = (device_us(conv_one_block_a_unit, idx)
                    if plan.route in ("wgmma", "splitk") and plan.blocks < math.prod(plan.grid)
                    else None)
        # torch._int_mm on a pre-built im2col matrix (leaves out the im2col)
        intmm = None
        if M > 16 and K % 8 == 0 and cout % 8 == 0:
            cols = []
            for s in range(min(n, max(1, math.ceil(1.2 * L2_BYTES / (M * K + cout * K))))):
                xq, wt = sets[s][5], sets[s][1]
                # K in (c, r, s) order on both sides: unfold's, and OIHW's
                a = F.unfold(xq.float(), k, padding=pad) if k > 1 else xq.float().flatten(2)
                a = a.transpose(1, 2).reshape(M, K).to(torch.int8).contiguous()
                b2 = wt.contiguous().reshape(cout, K).t()  # (K, N), column-major
                cols.append((a, b2))
            intmm = device_us(lambda i: torch._int_mm(*cols[i % len(cols)]),
                              list(range(len(cols))) * max(1, math.ceil(20 / len(cols))))
            del cols
        ops = 2.0 * M * cout * K
        nbytes = h * w * cin + cout * K + M * cout * 2 + cout * 6
        bms, by = bound(ops, nbytes)
        # int8_conv2d reads the bf16 activation in place of the int8 one
        fused_bms, fused_by = bound(ops, nbytes + h * w * cin)
        q_bms, _ = bound(0, h * w * cin * 3)
        share = bms * 1e3 / t["conv"] if t["conv"] > 0 else float("nan")
        rate = ops / (t["conv"] * 1e-6) / 1e12 if t["conv"] > 0 else float("nan")
        parts = ({"1x1 conv (quantize on load)": t["conv2d"],
                  "1x1 on mma.sync + quantize (before)": t["old_mma"] + t["quantize"]}
                 if k == 1 else {"3x3 conv": t["conv"], "3x3 quantize": t["quantize"]})
        for kind, us in parts.items():
            if math.isnan(us):
                missing[kind].append(f"{k}x{k} {cin}->{cout} at {h}x{w}")
            else:
                frame[kind] += per_frame * us
        fused_note = ""
        if k == 1:
            fused_share = (fused_bms * 1e3 / t["conv2d"] if t["conv2d"] > 0
                           else float("nan"))
            fused_note = (f"; int8_conv2d on the bf16 input (conv and the quantize it "
                          f"absorbs, one launch) {t['conv2d']!r} us, bound "
                          f"{fused_bms * 1e3!r} us by {fused_by}, share {fused_share!r}; "
                          f"PR 2's mma.sync kernel on the same int8 inputs "
                          f"{t['old_mma']!r} us (+ quantize {t['quantize']!r} us)")
        print(f"int8 shape {k}x{k} {cin}->{cout} at {h}x{w} (M {M}, N {cout}, K {K}), "
              f"{per_frame} per frame, route {plan.route} grid {plan.grid}, "
              f"{plan.blocks} blocks, {card}: "
              f"conv {t['conv']!r} us ({rate!r} TOP/s; CUDA events {conv_ms * 1e3!r} us"
              + (f"; one block per unit of work {one_each!r} us" if one_each else "")
              + f"), bound {bms * 1e3!r} us by {by}, share {share!r}{fused_note}; bf16 "
              f"cuDNN conv {t['cudnn']!r} us; torch._int_mm on im2col (no im2col) "
              + (f"{intmm!r} us" if intmm is not None else "not taken (M <= 16 or N % 8)")
              + f"; quantize {t['quantize']!r} us (bound {q_bms * 1e3!r} us, share "
              f"{q_bms * 1e3 / t['quantize'] if t['quantize'] > 0 else float('nan')!r}); "
              f"rotation {n} input sets, "
              f"{n * set_bytes / 1e6:.1f} MB")
        shape = (k, cin, cout, h, w)
        for name, rec_shape in RECORD_SHAPES.items():
            if rec_shape != shape:
                continue
            x, wt, ws, b, sx, xq, _ = sets[0]
            one = [0] * 5
            lib = intmm / 1e3 if intmm is not None else None  # the same accumulators
            if name == "int8_quantize":
                records[name] = dict(
                    ms=t["quantize"] / 1e3, bound_ms=q_bms, bound_by="bytes", library_ms=None,
                    plain_ms=device_us(lambda i: int8_quantize_plain(sets[i][0], sets[i][4]),
                                       idx[:5]) / 1e3)
            elif name in ("int8_conv_pointwise", "int8_conv_dot"):
                # the kernel as the main path runs it: the bf16 input, quantized on load
                records[name] = dict(
                    ms=t["conv2d"] / 1e3, bound_ms=fused_bms, bound_by=fused_by,
                    library_ms=lib, plain_ms=device_us(lambda i: int8_conv2d(
                        x, wt, ws, sx, b, pad, plain=True), one) / 1e3)
            else:
                records[name] = dict(
                    ms=(t["old_mma"] if name == "int8_conv_mma" else t["conv"]) / 1e3,
                    bound_ms=bms, bound_by=by, library_ms=lib,
                    plain_ms=device_us(lambda i: int8_conv_plain(
                        xq, wt, ws, sx, b, pad, torch.bfloat16), one) / 1e3)
        del sets
        torch.cuda.empty_cache()
    print(f"int8 per frame from the 24 shapes x their counts, {card}: "
          + ", ".join(f"{kind} {frame[kind]!r} us"
                      + (f" without {missing[kind]} (not measured)" if missing[kind] else "")
                      for kind in frame)
          + " (profiler device time, rotating inputs)")
    return records


def phase_int8_kernels(card):
    """The int8 kernels against their plain versions, then the 24 shapes'
    times; -> the JSON records of the int8 kernels."""
    g = torch.Generator().manual_seed(SEED + 4)
    worst = check_int8_kernels(g)
    records = time_int8_shapes(g, card)
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


def reset_counts():
    from autoware_vision_pilot_tpu_torch.ops.kernels.int8_conv import (
        ROUTES, int8_conv, int8_quantize)
    from autoware_vision_pilot_tpu_torch.ops.kernels.lane_filter_kernel import lane_filter_walk
    from autoware_vision_pilot_tpu_torch.ops.kernels.nms_kernel import nms_greedy
    from autoware_vision_pilot_tpu_torch.ops.kernels.preprocess_kernel import (fused_letterbox,
                                                                               fused_preprocess)
    for fn in (fused_preprocess, int8_quantize, int8_conv, lane_filter_walk, fused_letterbox,
               nms_greedy):
        fn.launches = 0
    int8_conv.route_launches = dict.fromkeys(ROUTES, 0)


def read_counts():
    """Launches by kernel since reset_counts(); int8_conv counts its two
    conv kernels together, by route."""
    from autoware_vision_pilot_tpu_torch.ops.kernels.int8_conv import int8_conv, int8_quantize
    from autoware_vision_pilot_tpu_torch.ops.kernels.lane_filter_kernel import lane_filter_walk
    from autoware_vision_pilot_tpu_torch.ops.kernels.nms_kernel import nms_greedy
    from autoware_vision_pilot_tpu_torch.ops.kernels.preprocess_kernel import (fused_letterbox,
                                                                               fused_preprocess)
    r = int8_conv.route_launches
    return {"fused_preprocess": fused_preprocess.launches,
            "lane_filter_walk": lane_filter_walk.launches,
            "fused_letterbox": fused_letterbox.launches, "nms_greedy": nms_greedy.launches,
            "int8_quantize": int8_quantize.launches, "int8_conv": int8_conv.launches,
            "int8_conv_wgmma": r["wgmma"] + r["splitk"], "int8_conv_splitk": r["splitk"],
            "int8_conv_mma": r["mma"], "int8_conv_pointwise": r["pointwise"],
            "int8_conv_dot": r["dot"]}


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
    reset_counts()  # count only this main path's launches
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
    launches = read_counts()
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
    expect_launches(launches, {"fused_preprocess": n, "int8_quantize": 0, "int8_conv": 0})
    return pipe


def mask_agreement(a, b):
    return (a == b).float().mean().item()


def int8_modules(pipe):
    from autoware_vision_pilot_tpu_torch.nn.layers import Int8Conv2d
    return [m for net in (pipe.stack, pipe.lanes) for m in net.modules()
            if isinstance(m, Int8Conv2d)]


def check_convs_on_path(pipe, frame):
    """One int8 frame; a hook on each Int8Conv2d holds the kernels' output
    against the plain versions on the same input, with torch.equal."""
    from autoware_vision_pilot_tpu_torch.ops.kernels.int8_conv import int8_conv2d

    checked, bad = [], []

    def hook(m, args, y):
        if m.input_scale is None:
            raise AssertionError("an int8 conv of the main path has no static scale")
        x = args[0].contiguous(memory_format=CL)
        ref = int8_conv2d(x, m.weight, m.weight_scale, m.input_scale, m.bias,
                          m.padding, plain=True)
        checked.append(m)
        if not torch.equal(y, ref):
            bad.append((len(checked) - 1, (y.float() - ref.float()).abs().max().item()))

    handles = [m.register_forward_hook(hook) for m in int8_modules(pipe)]
    try:
        pipe(frame)
        torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    print(f"int8 frame, conv by conv: {len(checked)} int8 convs held against their "
          f"plain versions on the same input, {len(checked) - len(bad)} bit-equal "
          "(torch.equal)" + (f"; differ: {bad[:8]}" if bad else ""))
    if len(checked) != 72 or bad:
        raise AssertionError("int8 convs on the main path disagree with their plain versions")


KINDS = (("int8 conv, wgmma and split-K", "int8_conv_wgmma_kernel"),
         ("int8 conv, pointwise (quantize on load)", "int8_pointwise_kernel"),
         ("int8 conv, dot (quantize on load)", "int8_dot_kernel"),
         ("int8 conv, mma.sync", "int8_conv_kernel"),
         ("int8 quantize", "quantize_kernel"),
         # the 12 split-K arrival counters, and the memsets of the rest of the frame
         ("memsets", "Memset"))


def profile_frames(pipe, pool, card):
    """torch.profiler device time per frame by kind of kernel, and the wgmma
    kernel's device time at each 3x3 int8 conv of the frame (its launches
    in order, matched to the Int8Conv2d calls)."""
    from autoware_vision_pilot_tpu_torch.nn.layers import Int8Conv2d
    from torch.profiler import ProfilerActivity, profile

    order = []

    def note(m, args, y):
        if m.weight.shape[-1] == 3:
            h, w = args[0].shape[-2:]
            order.append(f"3x3 {m.weight.shape[1]}->{m.weight.shape[0]} at {h}x{w}")

    handles = [m.register_forward_hook(note) for m in int8_modules(pipe)]
    pipe(pool[0])
    torch.cuda.synchronize()
    for h in handles:
        h.remove()
    for _ in range(3):  # the profiler drops an event now and then: trace again
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(PROFILE_FRAMES):
                pipe(pool[i])
            torch.cuda.synchronize()
        launches = sorted((e for e in prof.events() if "int8_conv_wgmma_kernel" in e.name
                           and e.device_type == torch.autograd.DeviceType.CUDA),
                          key=lambda e: e.time_range.start)
        if len(launches) == len(order) * PROFILE_FRAMES:
            break
    by_kind = dict.fromkeys([k for k, _ in KINDS] + ["the rest"], 0.0)
    count = dict.fromkeys(by_kind, 0)
    for e in prof.key_averages():
        kind = next((k for k, pat in KINDS if pat in e.key), "the rest")
        by_kind[kind] += e.self_device_time_total / PROFILE_FRAMES
        count[kind] += e.count / PROFILE_FRAMES
    total = sum(by_kind.values())
    print(f"int8 device time per frame by kind (torch.profiler, {PROFILE_FRAMES} "
          f"frames, {card}): " + "; ".join(f"{k} {v!r} us in {count[k]:g} kernels"
                                           for k, v in by_kind.items())
          + f"; total {total!r} us")
    if total <= 0:
        print("int8 device time per frame: not measured (no profiler device time)")
    if len(launches) != len(order) * PROFILE_FRAMES:
        print(f"wgmma kernel by conv: not measured (the profiler recorded "
              f"{len(launches)} of {len(order) * PROFILE_FRAMES} launches, three times)")
        return
    us = np.array([e.time_range.elapsed_us() for e in launches],
                  dtype=float).reshape(PROFILE_FRAMES, len(order))
    by_conv = {}
    for j, name in enumerate(order):
        by_conv.setdefault(name, []).append(float(np.median(us[:, j])))
    print(f"wgmma kernel device time by conv on the int8 path (median over "
          f"{PROFILE_FRAMES} frames, {card}): "
          + "; ".join(f"{k} {float(np.mean(v))!r} us x {len(v)}" for k, v in by_conv.items())
          + f"; per frame {float(us.sum(1).mean())!r} us")


def conv_class(k, hw):
    """The route a main-path int8 conv takes, from its window and map."""
    if k == 1:
        return "1x1 SE (dot)" if hw[0] * hw[1] == 1 else "1x1 (pointwise)"
    return "3x3 from 40x80 up (wgmma)" if hw[0] * hw[1] >= 40 * 80 else "3x3 thin (split-K)"


def host_costs(bf16_pipe, int8_pipe, pool, card):
    """Host time per conv call at the 72 int8 layers of the main path: each
    Int8Conv2d call (quantize and int8 conv) against the same layer's bf16
    cuDNN conv, from a forward pre-hook to the forward hook, by the route
    the int8 conv takes; the host time to enqueue a whole frame; and each
    path's frame latency p50 (CUDA events) from the same rounds: bf16,
    int8, int8, bf16, HOST_FRAMES frames each."""
    from autoware_vision_pilot_tpu_torch.nn.layers import Int8Conv2d

    names = [(i, name) for i, net in enumerate((int8_pipe.stack, int8_pipe.lanes))
             for name, m in net.named_modules() if isinstance(m, Int8Conv2d)]
    stats = {}

    def hooked(pipe, path):
        nets = (pipe.stack, pipe.lanes)
        mods = [dict(nets[i].named_modules())[name] for i, name in names]
        t0 = [0.0]

        def pre(m, args):
            t0[0] = time.perf_counter()

        def post(m, args, y):
            dt = time.perf_counter() - t0[0]
            key = (path, conv_class(m.weight.shape[-1], args[0].shape[-2:]))
            stats.setdefault(key, []).append(dt)

        return [h for m in mods for h in (m.register_forward_pre_hook(pre),
                                         m.register_forward_hook(post))]

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    latency, enqueue = {"bf16": [], "int8": []}, {"bf16": [], "int8": []}
    for pipe in (bf16_pipe, int8_pipe):  # warm-up, not counted
        pipe(pool[0])
    torch.cuda.synchronize()
    handles = hooked(bf16_pipe, "bf16") + hooked(int8_pipe, "int8")
    try:
        for path in ("bf16", "int8", "int8", "bf16"):
            pipe = int8_pipe if path == "int8" else bf16_pipe
            for i in range(HOST_FRAMES):
                start.record()
                t0 = time.perf_counter()
                pipe(pool[i % len(pool)])
                enqueue[path].append(time.perf_counter() - t0)
                end.record()
                end.synchronize()
                latency[path].append(start.elapsed_time(end))
    finally:
        for h in handles:
            h.remove()
    frames_run = 2 * HOST_FRAMES
    per = {}
    for path in ("int8", "bf16"):
        calls = [dt for (p, _), v in stats.items() if p == path for dt in v]
        by_class = {c: v for (p, c), v in stats.items() if p == path}
        per[path] = (1e6 * float(np.mean(calls)), 1e3 * sum(calls) / frames_run)
        print(f"host per conv call, {path} at the 72 int8 layers ({card}; hooks "
              f"around each module call, {frames_run} frames): mean "
              f"{per[path][0]!r} us over {len(calls)} calls, median "
              f"{1e6 * float(np.median(calls))!r} us; "
              + "; ".join(f"{c} {1e6 * float(np.mean(v))!r} us x {len(v) // frames_run}"
                          for c, v in sorted(by_class.items()))
              + f"; {per[path][1]!r} ms a frame in those calls; host enqueue of a "
              f"whole frame p50 {1e3 * float(np.median(enqueue[path]))!r} ms")
    p50 = {k: float(np.median(v)) for k, v in latency.items()}
    print(f"host cost of the int8 path, {card}: int8 conv calls take "
          f"{per['int8'][0] - per['bf16'][0]!r} us more host time each than the bf16 "
          f"convs they replace ({per['int8'][1] - per['bf16'][1]!r} ms a frame); "
          f"frame latency p50 int8 {p50['int8']!r} ms, bf16 {p50['bf16']!r} ms, "
          f"ratio {p50['int8'] / p50['bf16']!r} (CUDA events, the same rounds)")


def phase_int8(card, bf16_pipe):
    from autoware_vision_pilot_tpu_torch.export.quantize import int8_conv_count
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
    expect_launches(launches, {"fused_preprocess": n, "int8_quantize": 30 * n,
                               "int8_conv": 72 * n, "int8_conv_wgmma": 30 * n,
                               "int8_conv_splitk": 12 * n, "int8_conv_pointwise": 22 * n,
                               "int8_conv_dot": 20 * n, "int8_conv_mma": 0})
    check_convs_on_path(pipe, pool[0])
    profile_frames(pipe, pool, card)
    host_costs(bf16_pipe, pipe, pool, card)

    # the same modules with the int8 convs routed to the plain versions
    modules = int8_modules(pipe)
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


# ---------- the lateral program ----------

LANE_HW = (OUT_HW[0] // 4, OUT_HW[1] // 4)  # EgoLanes' masks at 320x640: 80x160
LANE_KINDS = ("straight", "curved", "dashed", "other-lane fallback", "one-sided",
              "empty", "noise", "random 0.05", "random 0.3", "random 0.6")


def lane_masks(hw, kind, seed):
    """(H, W, 3) f32 masks [ego_left, ego_right, other] of a ``kind`` of
    scene: 3-pixel-wide lanes x = f(y) below row H/8 (a slope and a bend
    drawn from ``seed``), dashed, the left lane only in the other mask above
    the bottom quarter, one side only, empty, speckle in the other mask, or
    uniform random at a density."""
    h, w = hw
    rng = np.random.default_rng(seed)
    if kind.startswith("random"):
        return (rng.random((h, w, 3)) < float(kind.split()[1])).astype(np.float32)
    m = np.zeros((h, w, 3), np.float32)
    if kind == "empty":
        return m
    slope, bend = rng.uniform(-0.25, 0.25, 2), rng.uniform(-2.0, 2.0, 2) / h
    for y in range(h // 8, h):
        for c, x0 in ((0, 0.32 * w), (1, 0.66 * w)):
            if (kind == "one-sided" and c == 1) or (kind == "dashed" and (y // 4) % 2 == c):
                continue
            d = y - h
            bent = bend[c] * d * d if kind == "curved" else 0.0
            x = int(round(x0 + slope[c] * d + bent))
            ch = 2 if kind == "other-lane fallback" and c == 0 and y < 3 * h // 4 else c
            m[y, max(0, x - 1):max(0, x + 2), ch] = 1.0
    if kind == "noise":
        m[rng.integers(h // 2, h, h * w // 20), rng.integers(0, w, h * w // 20), 2] = 1.0
    return m


def profile_launches(fn, x):
    """Device kernels (and memsets/copies) one call of fn(x) launches."""
    from torch.profiler import ProfilerActivity, profile

    fn(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn(x)
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)


# (shape, kind, seed) of phase 5 beyond the 30 sets: widths that are not a
# multiple of 32, an H * W * 3 that is not a multiple of 4 (33x65), the
# largest mask the wrapper admits (320x320) and the most rows (4096x25)
LANE_EDGE_SETS = (((33, 65), "random 0.3", 3), ((33, 65), "curved", 3), ((80, 150), "noise", 3),
                  ((80, 150), "other-lane fallback", 3), ((37, 91), "dashed", 3),
                  ((320, 320), "random 0.3", 3), ((320, 320), "curved", 3),
                  ((4096, 25), "straight", 3), ((1, 1), "random 0.6", 3), ((3, 1000), "random 0.6", 3))
LANE_STAGES = ("staging", "bits packed and landed", "start point", "up walk", "down walk",
               "logs landed (the other side's walk)", "count and write-out")


def edge_lane_masks(hw, near):
    """Masks whose lanes run down columns ``near`` and W - 1 - ``near`` (a
    window at the left and right edges), with the other mask's bottom row
    and top third set (windows at the bottom and top)."""
    h, w = hw
    m = np.zeros((h, w, 3), np.float32)
    m[:, near, 0] = m[:, min(near + 1, w - 1), 0] = 1.0
    m[:, w - 1 - near, 1] = m[:, max(w - 2 - near, 0), 1] = 1.0
    m[h - 1, :, 2] = 1.0
    m[:h // 3, :, 2] = 1.0
    return m


def walk_equal(masks, name):
    """The walk kernel on ``masks`` against its plain version: torch.equal
    on the weight images and start points, else raise. -> max |error|."""
    from autoware_vision_pilot_tpu_torch.ops.kernels.lane_filter_kernel import lane_filter_walk
    from autoware_vision_pilot_tpu_torch.perception.lane_filter import lane_filter_walk_plain

    before = lane_filter_walk.launches
    weights, starts = lane_filter_walk(masks)
    torch.cuda.synchronize()
    if lane_filter_walk.launches != before + 1:
        raise AssertionError("lane_filter_walk did not count its launch")
    ref_w, ref_s = lane_filter_walk_plain(masks)
    err = max((weights - ref_w).abs().max().item(), (starts - ref_s).abs().max().item())
    if not (torch.equal(weights, ref_w) and torch.equal(starts, ref_s)):
        raise AssertionError(f"lane_filter_walk disagrees with its plain version on {name}: "
                             f"{starts.tolist()} vs {ref_s.tolist()}, max_abs_err {err}")
    return err


def parent_kernels(root):
    """--parent ROOT: the lane-filter walk and NMS entry points of the port
    in ROOT (an earlier commit unpacked with git archive), compiled from its
    csrc/ with its own flags into ROOT/build/parent_kernels/ and bound with
    its own C signatures. -> (walk(masks), nms(top, kw), each allocating
    its outputs as this tree's wrappers do; and the stamped copies of
    stamped_parent, where the parent's kernels have no stamps), or None
    without ROOT."""
    if root is None:
        return None
    import ctypes
    import importlib.util

    pkg = pathlib.Path(root).resolve() / "autoware_vision_pilot_tpu_torch"
    spec = importlib.util.spec_from_file_location("parent_build", pkg / "kernels" / "build.py")
    pb = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(pb)
    out = pkg.parent / "build" / "parent_kernels"
    out.mkdir(parents=True, exist_ok=True)
    objs = [out / f"{n}.o" for n in ("lane_filter", "nms")]
    pb._run_all([[pb._nvcc(), *pb.NVCC_FLAGS, "-I", str(pkg / "csrc"), "-c", "-o", str(o),
                  str(pkg / "csrc" / f"{o.stem}.cu")] for o in objs])
    lib_path = out / "libparent.so"
    pb._run_all([[pb._nvcc(), *pb.NVCC_FLAGS, "-shared", "-o", str(lib_path), *map(str, objs)]])
    lib = ctypes.CDLL(str(lib_path))
    for name in ("avp_lane_filter_walk", "avp_nms_greedy"):
        getattr(lib, name).argtypes = pb.SIGNATURES[name]
        getattr(lib, name).restype = ctypes.c_int
    # the walk: 6 arguments (no stamps), 7 (stamps), 8 (a batch of N streams);
    # NMS: 13 (no cluster size, no stamps), 15, 16 (a batch of N streams)
    walk_args = len(pb.SIGNATURES["avp_lane_filter_walk"])
    nms_args = len(pb.SIGNATURES["avp_nms_greedy"])

    def walk(masks):
        h, w, _ = masks.shape
        weights = torch.empty((2, h, w), dtype=torch.int32, device=masks.device)
        starts = torch.empty((2, 3), dtype=torch.int32, device=masks.device)
        extra = () if walk_args == 6 else (None,)
        streams = (1,) if walk_args == 8 else ()
        err = lib.avp_lane_filter_walk(masks.data_ptr(), weights.data_ptr(), starts.data_ptr(),
                                       *streams, h, w, *extra,
                                       torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"the parent's avp_lane_filter_walk failed: {err}")
        return weights, starts

    def nms(top, kw):
        from autoware_vision_pilot_tpu_torch.ops.kernels.nms_kernel import cluster_size
        k, md, dev = top[1].shape[0], kw["max_det"], top[1].device
        outs = (torch.empty((md, 4), device=dev), torch.empty(md, device=dev),
                torch.empty(md, dtype=torch.int32, device=dev),
                torch.empty(md, dtype=torch.bool, device=dev))
        extra = () if nms_args == 13 else (cluster_size(k), None)
        streams = (1,) if nms_args == 16 else ()
        err = lib.avp_nms_greedy(*(t.data_ptr() for t in top), *(t.data_ptr() for t in outs),
                                 *streams, k,
                                 md, kw["iou_thresh"], kw["conf_thresh"],
                                 int(kw.get("class_aware", True)), *extra,
                                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"the parent's avp_nms_greedy failed: {err}")
        return outs

    print(f"parent kernels built from {pkg}")
    return walk, nms, stamped_parent(pkg, pb, out) if walk_args == 6 else None


# Stage stamps for the parent's kernels when they have none of their own (the
# single-block walk and NMS kernels before the cluster designs): (source,
# [(anchor, text put before it)]), each anchor found once in the parent's
# source
PARENT_STAMPS = {
    "lane_filter.cu": [
        ("__device__ void walk(", "__device__ unsigned long long* g_stamps;\n"
         "#define STAMP(i) if (g_stamps) { unsigned long long t; asm volatile("
         "\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t)); g_stamps[8 * blockIdx.x + (i)] = t; }\n"),
        ("  if (threadIdx.x == 0) {\n    best_row = -1;", "  if (threadIdx.x == 0) STAMP(0)\n"),
        ("\n  // _find_start: the ROI", "\n  if (threadIdx.x == 0) STAMP(1)"),
        ("  // keys are distinct", "  if (threadIdx.x == 0) STAMP(2)\n"),
        ("}\n\n}  // namespace", "  if (warp < 2 && threadIdx.x % 32 == 0) STAMP(3 + warp)\n"),
        ('extern "C" int avp_lane_filter_walk', 'extern "C" int avp_set_stamps(void* p) {\n'
         "  return (int)cudaMemcpyToSymbol(g_stamps, &p, sizeof(p));\n}\n")],
    "nms.cu": [
        ("__global__ void __launch_bounds__(THREADS) nms_greedy_kernel(",
         "__device__ unsigned long long* g_stamps;\n"
         "#define STAMP(i) if (g_stamps && threadIdx.x == 0) { unsigned long long t; asm "
         "volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t)); g_stamps[i] = t; }\n"),
        ("\n  for (int i = threadIdx.x; i < k; i += THREADS) {\n    const float4 b",
         "\n  STAMP(0)"),
        ("\n  // the suppression bits", "\n  STAMP(1)"),
        ("\n  if (warp == 0) {\n    unsigned alive", "\n  STAMP(2)"),
        ("\n  for (int i = threadIdx.x; i < k; i += THREADS) {\n    const unsigned word",
         "\n  STAMP(3)"),
        ("}\n\nsize_t smem_bytes", "  STAMP(4)\n"),
        ('extern "C" int avp_nms_greedy', 'extern "C" int avp_set_stamps(void* p) {\n'
         "  return (int)cudaMemcpyToSymbol(g_stamps, &p, sizeof(p));\n}\n")],
}


def stamped_parent(pkg, pb, out):
    """The parent's walk and NMS kernels again, each with %globaltimer stamps
    at its stages (PARENT_STAMPS) written into build/parent_kernels/, each
    in its own library. -> {source: (library, stamps tensor)}, or None if an
    anchor is missing."""
    import ctypes

    libs = {}
    for src, edits in PARENT_STAMPS.items():
        text = (pkg / "csrc" / src).read_text()
        for anchor, stamp in edits:
            if text.count(anchor) != 1:
                print(f"parent stage split: not measured ({src} has no single {anchor!r})")
                return None
            text = text.replace(anchor, stamp + anchor)
        path = out / f"stamped_{src}"
        path.write_text(text)
        lib_path = out / f"libstamped_{path.stem}.so"
        pb._run_all([[pb._nvcc(), *pb.NVCC_FLAGS, "-shared", "-o", str(lib_path), str(path)]])
        lib = ctypes.CDLL(str(lib_path))
        name = "avp_lane_filter_walk" if src == "lane_filter.cu" else "avp_nms_greedy"
        getattr(lib, name).argtypes = pb.SIGNATURES[name]
        stamps = torch.zeros(16, dtype=torch.int64, device="cuda")
        if lib.avp_set_stamps(ctypes.c_void_p(stamps.data_ptr())):
            raise RuntimeError("could not set the stamped parent's stamp buffer")
        libs[src] = (lib, stamps)
    return libs


def launch_floor(card):
    """The profiler device time of an empty kernel (csrc/launch_floor.cu) at
    the launch shapes of this script's hand kernels. -> {shape: us}."""
    from autoware_vision_pilot_tpu_torch.kernels import build

    lib, floors = build.load(), {}
    for blocks, threads, cluster in ((1, 32, 1), (2, 1024, 1), (8, 1024, 8), (8, 512, 8)):
        def launch(_):
            err = lib.avp_launch_floor(blocks, threads, cluster,
                                       torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"avp_launch_floor failed: cudaError_t {err}")
        floors[(blocks, threads, cluster)] = device_us(launch, [None] * 50)
    print(f"launch floor, {card}: an empty kernel's profiler device time, " + "; ".join(
        f"{b} block(s) of {t} threads in clusters of {c}: {us!r} us"
        for (b, t, c), us in floors.items()))
    return floors


def alternate(label, fns, inputs, card):
    """Profiler device time of parent, new, new, parent in turns (``fns``:
    name -> fn); prints each. -> {name: [us, us]}."""
    times = {name: [] for name in fns}
    for name in (*fns, *reversed(list(fns))):
        times[name].append(device_us(fns[name], inputs))
        print(f"{label} {name}, {card}: {times[name][-1]!r} us (profiler device time)")
    return times


def phase_lane_filter(card, parent=None):
    """The lane-filter walk kernel against its plain version (torch.equal on
    the weight images and the start points) on 2 seeds of every LANE_KINDS
    at 80x160 and 1 at 24x48, LANE_EDGE_SETS, windows at the four edges and
    masks off 16 bytes; then its time, stage split (from the kernel's
    stamps), bound, the plain version's time and launches, and with
    --parent the parent's kernel on the same inputs. -> the JSON record."""
    from autoware_vision_pilot_tpu_torch.ops.kernels import lane_filter_kernel as lk
    from autoware_vision_pilot_tpu_torch.ops.kernels.lane_filter_kernel import lane_filter_walk
    from autoware_vision_pilot_tpu_torch.perception.lane_filter import lane_filter_walk_plain

    cases = [(LANE_HW, k, s) for k in LANE_KINDS for s in (0, 1)]
    cases += [((24, 48), k, 2) for k in LANE_KINDS]
    worst = 0
    for hw, kind, seed in cases:
        masks = torch.from_numpy(lane_masks(hw, kind, seed)).cuda()
        worst = max(worst, walk_equal(masks, f"{kind} {hw} seed {seed}"))
    print(f"kernel lane_filter_walk: {len(cases)} mask sets ({len(LANE_KINDS)} kinds at "
          f"{LANE_HW[0]}x{LANE_HW[1]} x 2 seeds and at 24x48), weight images and start "
          f"points bit-equal to the plain version (max_abs_err {worst}; tol 0)")
    edge = [(f"{kind} {hw}", torch.from_numpy(lane_masks(hw, kind, seed)).cuda())
            for hw, kind, seed in LANE_EDGE_SETS]
    edge += [(f"lanes on columns {near} and W-1-{near} {hw}",
              torch.from_numpy(edge_lane_masks(hw, near)).cuda())
             for hw in (LANE_HW, (33, 65)) for near in (0, 1, 2)]
    for name, masks in list(edge[:3]):  # 4 bytes off 16
        buf = torch.zeros(masks.numel() + 4, device="cuda")
        buf[1:1 + masks.numel()] = masks.flatten()
        edge.append((f"{name} 4 bytes off 16", buf[1:1 + masks.numel()].view(masks.shape)))
    for name, masks in edge:
        worst = max(worst, walk_equal(masks, name))
    print(f"kernel lane_filter_walk: {len(edge)} edge sets (ragged widths, 320x320, 4096x25, "
          f"1x1, windows at the four edges, masks 4 bytes off 16) bit-equal (max_abs_err "
          f"{worst}; tol 0)")

    pool = [torch.from_numpy(lane_masks(LANE_HW, LANE_KINDS[i % len(LANE_KINDS)], 10 + i))
            .cuda() for i in range(40)]  # 6 MB: in the L2, as the thresholded masks are
    us, ms = device_us(lane_filter_walk, pool), cuda_ms(lane_filter_walk, pool)
    plain_us = device_us(lane_filter_walk_plain, pool[:4])
    plain_launches = profile_launches(lane_filter_walk_plain, pool[0])
    h, w = LANE_HW
    nbytes = h * w * 3 * 4 + 2 * h * w * 4 + 2 * 3 * 4
    bound_ms, bound_by = bound(0, nbytes)
    print(f"kernel lane_filter_walk {h}x{w}, {card}: {us!r} us (profiler device time; "
          f"CUDA events {ms * 1e3!r} us a call, {queued_us(lane_filter_walk, pool)!r} us queued "
          f"back to back), bound {bound_ms * 1e3!r} us by {bound_by} "
          f"({nbytes} bytes), share {bound_ms * 1e3 / us!r}; plain version {plain_us!r} us "
          f"of device time in {plain_launches} launches a call")
    # the stage split: each walking block's %globaltimer stamps, over the pool
    stamps = torch.zeros(16, dtype=torch.int64, device="cuda")
    split = []
    for masks in pool:
        lk._launch(masks, stamps)
        t = stamps.view(2, 8).cpu().numpy().astype(np.float64)
        for g in t:
            split.append([g[1] - g[0], g[2] - g[1], g[3] - g[2], g[4] - g[3], g[5] - g[3],
                          g[6] - max(g[4], g[5]), g[7] - g[6], g[7] - g[0]])
    split = np.asarray(split)
    print(f"kernel lane_filter_walk {h}x{w} stage split, {card} (ns, mean over 40 mask sets "
          f"x 2 sides, %globaltimer): " + ", ".join(
              f"{name} {split[:, i].mean():.0f}" for i, name in enumerate(LANE_STAGES)) +
          f"; first stamp to last {split[:, -1].mean():.0f} of {us * 1e3:.0f} device")
    if parent is not None:
        alternate(f"kernel lane_filter_walk {h}x{w}", {"parent": parent[0], "this tree":
                                                       lane_filter_walk}, pool, card)
    if parent is not None and parent[2] is not None:
        lib, stamps = parent[2]["lane_filter.cu"]
        split = []
        for masks in pool:
            weights = torch.empty((2, h, w), dtype=torch.int32, device="cuda")
            starts = torch.empty((2, 3), dtype=torch.int32, device="cuda")
            lib.avp_lane_filter_walk(masks.data_ptr(), weights.data_ptr(), starts.data_ptr(), h,
                                     w, torch.cuda.current_stream().cuda_stream)
            t = stamps.view(2, 8).cpu().numpy().astype(np.float64)
            split += [[g[1] - g[0], g[2] - g[1], g[3] - g[2], g[4] - g[2],
                       max(g[3], g[4]) - g[0]] for g in t]
        split = np.asarray(split)
        print(f"parent's lane_filter_walk {h}x{w} stage split, {card} (ns, mean over 40 mask "
              f"sets x 2 sides, %globaltimer in a stamped copy): " + ", ".join(
                  f"{name} {split[:, i].mean():.0f}" for i, name in enumerate(
                      ("staging", "start scan", "up walk", "down walk"))) +
              f"; first stamp to last {split[:, -1].mean():.0f}")
    return dict(max_abs_err=float(worst), ms=us / 1e3, plain_ms=plain_us / 1e3,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


LATERAL_KINDS = (("lane-filter walk", ("lane_filter_walk_kernel",)),
                 ("preprocess", ("fused_preprocess_kernel",)),
                 ("convolutions", ("conv", "xmma", "cudnn", "fprop", "implicit")),
                 ("matrix products", ("gemm", "gemv", "cutlass", "dot_kernel")),
                 ("top-k and sorts", ("topk", "sort", "Sort", "radix")),
                 ("copies and memsets", ("Memcpy", "Memset")))


def check_lateral_outputs(outs):
    for i, out in enumerate(outs):
        sc, co, lm = out["scalars"], out["coeffs"], out["lane_masks"]
        if (sc.shape, co.shape, lm.shape) != ((8,), (3, 6), (*LANE_HW, 3)) or \
                sc.dtype != torch.float32 or co.dtype != torch.float32:
            raise AssertionError(f"frame {i}: outputs {sc.shape} {co.shape} {lm.shape}")
        if not torch.isfinite(sc).all():
            raise AssertionError(f"frame {i}: non-finite scalars {sc.tolist()}")
        if not ((lm == 0) | (lm == 1)).all():
            raise AssertionError(f"frame {i}: lane masks not in {{0, 1}}")
        deg = sc[2]
        if not (deg == torch.round(deg) and -30 <= deg <= 30 and
                ((sc[6:] == 0) | (sc[6:] == 1)).all()):
            raise AssertionError(f"frame {i}: scalars {sc.tolist()}")


def profile_by_kind(run, kinds, label, card):
    """torch.profiler device time a frame by kind of kernel, over
    PROFILE_FRAMES calls of run(i)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(PROFILE_FRAMES):
                run(i)
            torch.cuda.synchronize()
        by_kind = dict.fromkeys([k for k, _ in kinds] + ["the rest"], 0.0)
        count = dict.fromkeys(by_kind, 0)
        for e in prof.key_averages():
            kind = next((k for k, pats in kinds if any(p in e.key for p in pats)), "the rest")
            by_kind[kind] += e.self_device_time_total / PROFILE_FRAMES
            count[kind] += e.count / PROFILE_FRAMES
        total = sum(by_kind.values())
        if total > 0:
            break
    if total <= 0:
        print(f"{label} device time per frame: not measured (no profiler device time)")
        return
    print(f"{label} device time per frame by kind (torch.profiler, {PROFILE_FRAMES} frames, "
          f"{card}): " + "; ".join(f"{k} {v!r} us in {count[k]:g} kernels"
                                   for k, v in by_kind.items())
          + f"; total {total!r} us in {sum(count.values()):g} device operations")


def profile_lateral(pipe, pool, state, card):
    """torch.profiler device time per lateral frame by kind of kernel."""
    def run(i):
        nonlocal state
        _, state = pipe(pool[i], state)

    profile_by_kind(run, LATERAL_KINDS, "lateral", card)


def phase_lateral(card):
    """The lateral program at full width (build_lateral_pipeline, bf16):
    60 distinct 720p frames, the state carried, each step under
    sync-debug "error"; -> its launch counts."""
    from autoware_vision_pilot_tpu_torch.runtime.pipeline import build_lateral_pipeline

    t0 = time.perf_counter()
    pipe = build_lateral_pipeline("cuda", torch.bfloat16, SEED)
    n = WARM + TIMED
    pool = frames(n, FRAME_HW, SEED + 6).cuda()
    state = pipe.init_state(SEED)
    torch.cuda.synchronize()
    print(f"lateral build: {time.perf_counter() - t0:.1f} s")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    latencies, enqueue, outs = [], [], []
    reset_counts()  # count only this path's launches
    for i in range(n):
        start.record()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")  # any host sync inside the step raises
        try:
            out, state = pipe(pool[i], state)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        enqueue.append(time.perf_counter() - t0)
        end.record()
        end.synchronize()
        latencies.append(start.elapsed_time(end))
        outs.append(out)
    launches = read_counts()
    check_lateral_outputs(outs)
    expect_launches(launches, {"fused_preprocess": n, "lane_filter_walk": n,
                               "int8_quantize": 0, "int8_conv": 0})
    timed = np.asarray(latencies[WARM:])
    p50, p99 = (float(np.percentile(timed, q)) for q in (50, 99))
    last = dict(zip(("steering_filtered", "steering_raw", "autosteer_deg", "cte"),
                    outs[-1]["scalars"].tolist()))
    print(f"bf16 lateral step, {FRAME_HW[0]}x{FRAME_HW[1]}[{LATERAL_CROP}:] -> "
          f"{OUT_HW[0]}x{OUT_HW[1]}, {card}: p50 {p50!r} ms, p99 {p99!r} ms, mean "
          f"{float(timed.mean())!r} ms over {len(timed)} frames after {WARM} warm-up (CUDA "
          f"events per frame); host enqueue p50 {1e3 * float(np.median(enqueue[WARM:]))!r} "
          f"ms; no host sync in any step (sync-debug \"error\"); launches {launches}; "
          f"last frame {last}")
    profile_lateral(pipe, pool, state, card)
    del pipe, pool
    torch.cuda.empty_cache()
    return launches


def phase_lateral_f32():
    """The lateral program in f32 on the card, TF32 off, against the CPU,
    same seeded weights, 3 frames with the states carried and the same
    PathFinder noise. Each frame the card's EgoLanes and AutoSteer run on
    their own input and are held to the CPU's logits (1e-3 * max|CPU|),
    then return the CPU's logits, so that the classical chain on the card
    gets the CPU's input: its lane masks, AutoSteer angle and flags must
    be equal and its lane fits within 5e-3 * max|CPU| (the lane filter's
    f32 normal equations summed in another order). PathFinder's outputs
    are printed, not held: its unnormalized f32 fit has a condition number
    of ~3e9 at this geometry."""
    from autoware_vision_pilot_tpu_torch.runtime.pipeline import (SCALAR_FIELDS,
                                                                  build_lateral_pipeline)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    cpu = build_lateral_pipeline("cpu", torch.float32, SEED)
    card = build_lateral_pipeline("cuda", torch.float32, SEED)
    fs = frames(3, FRAME_HW, SEED + 7)
    cs, gs = cpu.init_state(SEED), card.init_state(SEED)
    noise = torch.zeros(14)
    ref, own = {}, {}

    def keep(name):
        return lambda m, a, y: ref.__setitem__(name, y)

    def force(name):
        def hook(m, a, y):
            own[name] = y
            return tuple(v.cuda() for v in ref[name]) if name == "steer" else ref[name].cuda()
        return hook

    hooks = [cpu.lanes.register_forward_hook(keep("lanes")),
             cpu.steer_net.register_forward_hook(keep("steer")),
             card.lanes.register_forward_hook(force("lanes")),
             card.steer_net.register_forward_hook(force("steer"))]
    flags = [SCALAR_FIELDS.index(f) for f in ("autosteer_deg", "fused_valid", "path_valid")]
    try:
        for i in range(3):
            cout, cs = cpu(fs[i], cs, noise=noise)
            gout, gs = card(fs[i].cuda(), gs, noise=noise.cuda())
            lanes_err = (own["lanes"].cpu() - ref["lanes"]).abs().max().item()
            lanes_tol = 1e-3 * ref["lanes"].abs().max().item()
            steer_err = (own["steer"][1].cpu() - ref["steer"][1]).abs().max().item()
            steer_tol = 1e-3 * ref["steer"][1].abs().max().item()
            g = {k: v.cpu() for k, v in gout.items()}
            fin = torch.isfinite(cout["coeffs"])
            same_nonfinite = torch.equal(torch.isnan(g["coeffs"]), torch.isnan(cout["coeffs"])) \
                and torch.equal(torch.where(fin | torch.isnan(cout["coeffs"]), 0.0, g["coeffs"]),
                                torch.where(fin | torch.isnan(cout["coeffs"]), 0.0, cout["coeffs"]))
            scale = torch.where(fin, cout["coeffs"], 0.0).abs().amax(-1, keepdim=True)
            fit_err = ((torch.where(fin, g["coeffs"], 0.0) - torch.where(fin, cout["coeffs"], 0.0))
                       .abs() / scale.clamp_min(1e-30)).max().item()
            print(f"f32 lateral frame {i}, card vs CPU: lane logits max_abs_err {lanes_err!r} "
                  f"(tol {lanes_tol!r}), AutoSteer logits {steer_err!r} (tol {steer_tol!r}); "
                  f"fed the CPU's logits: lane masks equal "
                  f"{torch.equal(g['lane_masks'], cout['lane_masks'])}, scalars card "
                  f"{g['scalars'].tolist()} CPU {cout['scalars'].tolist()}, lane fits "
                  f"{fit_err!r} * max|CPU| (tol 5e-3)")
            if not (lanes_err <= lanes_tol and steer_err <= steer_tol):
                raise AssertionError(f"frame {i}: the card's networks and the CPU's disagree")
            if not (torch.equal(g["lane_masks"], cout["lane_masks"])
                    and torch.equal(g["scalars"][flags], cout["scalars"][flags])
                    and same_nonfinite and fit_err <= 5e-3):
                raise AssertionError(f"frame {i}: the card's classical chain and the CPU's "
                                     "disagree")
    finally:
        for h in hooks:
            h.remove()
    print(f"f32 lateral card vs CPU: {time.perf_counter() - t0:.1f} s")
    del cpu, card
    torch.cuda.empty_cache()


# ---------- the longitudinal program ----------

LON_HW = (640, 640)  # AutoSpeed's input: 720x1280 letterboxes to 360x640, pad_y 140
# (source, output) of phase 11: landscape (pad rows), the KITTI size (an
# odd pad), and pad columns with a width that is not a multiple of 8
LETTERBOX_SIZES = ((FRAME_HW, LON_HW), (ODD_HW, LON_HW), ((360, 640), (181, 333)))
CONF, IOU, MAX_DET = 0.5, 0.5, 64  # runtime/config.py's LongitudinalConfig
IOU_OPS = 13  # f32 operations of one IoU test: 4 max/min, 2 sub, 2 clamps, mul, add, sub, div, >


def letterbox_bytes(hw, out_hw):
    """The bytes the letterbox must move: the source pixels its lerp reads
    (the union of the taps' rows by their columns), 3 bytes each, and the
    bf16 output, pad included."""
    from autoware_vision_pilot_tpu_torch.ops.preprocess import bilinear_taps, letterbox_geometry
    _, inner, _ = letterbox_geometry(out_hw, hw)
    rows, cols = (len(np.union1d(*bilinear_taps(n, m)[:2])) for n, m in zip(hw, inner))
    return rows * cols * 3 + out_hw[0] * out_hw[1] * 3 * 2


def phase_letterbox(card):
    """The letterbox mode bit-equal to its plain version; its time at 720p.
    -> the JSON record."""
    from autoware_vision_pilot_tpu_torch.ops.kernels.preprocess_kernel import (fused_letterbox,
                                                                               fused_preprocess)
    from autoware_vision_pilot_tpu_torch.ops.preprocess import letterbox

    record = None
    for hw, out_hw in LETTERBOX_SIZES:
        pool = frames(32, hw, SEED + 8).cuda()
        for dtype in (torch.float32, torch.bfloat16):
            before = fused_letterbox.launches, fused_preprocess.launches
            out, scale, pad = fused_letterbox(pool[0], out_hw, dtype)
            torch.cuda.synchronize()
            if (fused_letterbox.launches, fused_preprocess.launches) != (before[0] + 1, before[1]):
                raise AssertionError("fused_letterbox did not count its launch alone")
            ref, rscale, rpad = letterbox(pool[0][None], out_hw, hw, dtype=dtype)
            ref = ref.permute(0, 3, 1, 2)
            if out.shape != (1, 3, *out_hw) or out.dtype != dtype or (scale, pad) != (rscale, rpad) \
                    or not out.is_contiguous(memory_format=torch.channels_last):
                raise AssertionError(f"letterbox output {out.shape} {out.dtype} {scale} {pad}")
            err = (out.float() - ref.float()).abs().max().item()
            kernel = lambda x: fused_letterbox(x, out_hw, dtype)  # noqa: E731
            plain = lambda x: letterbox(x[None], out_hw, hw, dtype=dtype)  # noqa: E731
            us, plain_us = device_us(kernel, pool), device_us(plain, pool)
            print(f"kernel fused_letterbox {hw[0]}x{hw[1]}->{out_hw[0]}x{out_hw[1]} "
                  f"{str(dtype)[6:]} (scale {scale!r}, pad {pad}): max_abs_err {err!r} (tol 0: "
                  f"bit-equal); kernel {us!r} us, plain {plain_us!r} us (profiler device time)")
            if not torch.equal(out, ref):
                raise AssertionError("fused_letterbox disagrees with its plain version")
            if dtype == torch.bfloat16 and hw == FRAME_HW:
                nbytes = letterbox_bytes(hw, out_hw)
                bound_ms, bound_by = bound(0, nbytes)
                print(f"fused_letterbox {hw[0]}x{hw[1]} bound, {card}: {nbytes} bytes read once "
                      f"and written once, {bound_ms * 1e3!r} us at 3.35 TB/s; share "
                      f"{bound_ms * 1e3 / us!r}")
                record = dict(max_abs_err=err, ms=us / 1e3, plain_ms=plain_us / 1e3,
                              bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
        del pool
    return record


def phase_longitudinal_f32():
    """The longitudinal program in f32 on the card, TF32 off, against the
    CPU, same seeded weights, 3 frames: AutoSpeed's pred within 1e-3 *
    max|CPU|; then the card's network returns the CPU's pred, and the
    packed table must be equal. -> the CPU's decoded candidates of each
    frame (boxes, scores, classes), the head outputs for phase 13."""
    from autoware_vision_pilot_tpu_torch.ops.postprocess import decode_yolo_to_original
    from autoware_vision_pilot_tpu_torch.ops.preprocess import letterbox_geometry
    from autoware_vision_pilot_tpu_torch.runtime.pipeline import build_longitudinal_pipeline

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    cpu = build_longitudinal_pipeline("cpu", torch.float32, SEED)
    gpu = build_longitudinal_pipeline("cuda", torch.float32, SEED)
    fs = frames(3, FRAME_HW, SEED + 9)
    seen, forced = {}, {}

    def force(m, a, y):
        seen["card"] = y
        return forced["pred"]

    hooks = [cpu.net.register_forward_hook(lambda m, a, y: seen.__setitem__("cpu", y)),
             gpu.net.register_forward_hook(force)]
    scale, _, pad = letterbox_geometry(LON_HW, FRAME_HW)
    heads = []
    try:
        for i in range(3):
            ref = cpu(fs[i])
            forced["pred"] = seen["cpu"].cuda()
            out = gpu(fs[i].cuda()).cpu()
            err = (seen["card"].cpu() - seen["cpu"]).abs().max().item()
            tol = 1e-3 * seen["cpu"].abs().max().item()
            n_valid = int(ref[:, 6].sum())
            print(f"f32 longitudinal frame {i}, card vs CPU: pred {tuple(seen['cpu'].shape)} "
                  f"max_abs_err {err!r} (tol {tol!r}); fed the CPU's pred, packed table equal "
                  f"{torch.equal(out, ref)} ({n_valid} of {MAX_DET} rows valid)")
            if not err <= tol:
                raise AssertionError(f"frame {i}: the card's AutoSpeed and the CPU's disagree")
            if not torch.equal(out, ref):
                raise AssertionError(f"frame {i}: the card's decode + NMS and the CPU's disagree")
            heads.append(decode_yolo_to_original(seen["cpu"][0], scale, pad, FRAME_HW))
    finally:
        for h in hooks:
            h.remove()
    print(f"f32 longitudinal card vs CPU: {time.perf_counter() - t0:.1f} s")
    del cpu, gpu
    torch.cuda.empty_cache()
    return heads


def nms_candidates(kind, seed, A=2000):
    """(boxes (A, 4) f32 xyxy, scores (A,) f32, classes (A,) int32) of a
    ``kind`` of scene in a 1280x720 frame, as CPU tensors: random boxes
    (some inverted, of zero area), dense same-class clusters, all below
    0.5, a grid of disjoint boxes (more survivors than max_det), or scores
    with many ties."""
    rng = np.random.default_rng(seed)
    if kind == "grid":
        gx, gy = np.meshgrid(np.arange(50) * 25.0, np.arange(40) * 18.0)
        xy = np.stack([gx.ravel(), gy.ravel()], 1)[:A]
        boxes, cls = np.concatenate([xy, xy + 20.0], 1), rng.integers(0, 4, len(xy))
        scores = rng.uniform(0.5, 1.0, len(xy))
    else:
        if kind == "dense":
            c = rng.uniform(100, 600, (5, 2))[rng.integers(0, 5, A)] + rng.normal(0, 8, (A, 2))
            wh = rng.uniform(60, 90, (A, 2))
            boxes, cls = np.concatenate([c - wh / 2, c + wh / 2], 1), np.zeros(A)
        else:
            xy, wh = rng.uniform(0, 1100, (A, 2)), rng.uniform(-10, 300, (A, 2))
            boxes, cls = np.concatenate([xy, xy + wh], 1), rng.integers(0, 4, A)
        scores = rng.uniform(0, 1, A)
        if kind == "below":
            scores = scores * 0.4999
        if kind == "ties":
            scores = rng.choice([0.3, 0.5, 0.6, 0.75, 1.0], A)
    return (torch.from_numpy(boxes.astype(np.float32)),
            torch.from_numpy(scores.astype(np.float32)),
            torch.from_numpy(cls.astype(np.int32)))


# (kind, A, class_aware) of phase 13, 2 seeds each
NMS_SETS = (("random", 8400, True), ("random", 2000, False), ("dense", 2000, True),
            ("dense", 2000, False), ("below", 2000, True), ("grid", 2000, True),
            ("ties", 2000, True), ("ties", 2000, False), ("random", 100, True),
            ("dense", 200, True), ("dense", 40, False), ("ties", 60, True),
            ("grid", 8400, False), ("below", 8400, False), ("random", 300, True),
            ("dense", 8400, True))


def nms_ops(top, class_aware):
    """The f32 operations the NMS kernel must do on these candidates: the
    IoU tests of every pair i < j whose row i is above the threshold (and
    of one class, class-aware), and the areas."""
    boxes, scores, cls = top
    live = scores >= CONF
    pairs = live[:, None] & torch.ones(len(scores), len(scores), dtype=torch.bool,
                                       device=scores.device).triu(1)
    if class_aware:
        pairs &= cls[:, None] == cls[None, :]
    return int(pairs.sum()) * IOU_OPS + 4 * len(scores)


# (k, kind) of phase 13's edge sets: every cluster size 1, 2, 4 and 8 and
# the one the wrapper picks at k = 1, 31, 32, 33, 255, 256, 257 and 1024, on
# random live boxes, all candidates below the threshold, all live on
# degenerate clamped boxes with tied scores (as seeded AutoSpeed gives),
# and NaN coordinates
NMS_EDGE_K = (1, 31, 32, 33, 255, 256, 257, 1024)
NMS_EDGE_KINDS = ("live", "dead", "degenerate", "nan")
NMS_STAGES = ("staging", "matrix built and landed", "greedy pass", "output")


def nms_edge_candidates(k, kind, seed):
    """``nms_topk``-shaped candidates on the card: (k, 4) f32 boxes in a
    1280x720 frame, (k,) f32 scores sorted descending (all -1 for "dead"),
    (k,) int32 classes of 4."""
    rng = np.random.default_rng(seed)
    xy, wh = rng.uniform(0, 1200, (k, 2)), rng.uniform(0, 200, (k, 2))
    boxes = np.concatenate([xy, xy + wh], 1)
    scores = np.sort(rng.uniform(0.5, 1.0, k))[::-1].copy()
    if kind == "dead":
        scores[:] = -1.0
    if kind == "degenerate":
        boxes, scores[:] = np.clip(np.round(boxes / 400) * 400, 0, 1280), 1.0
    if kind == "nan":
        boxes[rng.random((k, 4)) < 0.1] = np.nan
    return (torch.from_numpy(boxes.astype(np.float32)).cuda(),
            torch.from_numpy(scores.astype(np.float32)).cuda(),
            torch.from_numpy(rng.integers(0, 4, k).astype(np.int32)).cuda())


def bits_equal(a, b):
    """Equal dtype, shape and bits (NaN payloads included)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def phase_nms(card, heads, parent=None):
    """The NMS kernel bit-equal to its plain version on the head outputs,
    2 seeds of NMS_SETS and the edge sets at every cluster size; its time
    and stage split (from the kernel's stamps) on the head outputs, and with
    --parent the parent's kernel on the same inputs. -> the JSON record."""
    from autoware_vision_pilot_tpu_torch.ops.kernels import nms_kernel as nk
    from autoware_vision_pilot_tpu_torch.ops.kernels.nms_kernel import nms_greedy
    from autoware_vision_pilot_tpu_torch.ops.postprocess import nms_greedy_plain, nms_topk

    sets = [(f"head output {i}", tuple(t.cuda() for t in h), True) for i, h in enumerate(heads)]
    sets += [(f"{kind} A={A} seed {seed}" + ("" if aware else " class-agnostic"),
              tuple(t.cuda() for t in nms_candidates(kind, seed, A)), aware)
             for seed in (1, 2) for kind, A, aware in NMS_SETS]
    worst, kept = 0.0, []
    for name, cand, aware in sets:
        top = nms_topk(*cand, max_det=MAX_DET, conf_thresh=CONF)
        kw = dict(max_det=MAX_DET, iou_thresh=IOU, conf_thresh=CONF, class_aware=aware)
        before = nms_greedy.launches
        out = nms_greedy(*top, **kw)
        torch.cuda.synchronize()
        if nms_greedy.launches != before + 1:
            raise AssertionError("nms_greedy did not count its launch")
        ref = nms_greedy_plain(*top, **kw)
        err = max((a.float() - b.float()).abs().max().item() for a, b in zip(out, ref))
        worst = max(worst, err)
        if not all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(out, ref)):
            raise AssertionError(f"nms_greedy disagrees with its plain version on {name}: "
                                 f"max_abs_err {err}")
        kept.append(f"{name}: {int(ref[3].sum())}")
    print(f"kernel nms_greedy: {len(sets)} candidate sets, every output bit-equal to the plain "
          f"version (max_abs_err {worst}; tol 0); kept boxes by set: {'; '.join(kept)}")
    n_edge = 0
    for k in NMS_EDGE_K:
        for kind in NMS_EDGE_KINDS:
            top = nms_edge_candidates(k, kind, k)
            kw = dict(max_det=MAX_DET, iou_thresh=IOU, conf_thresh=CONF, class_aware=True)
            ref = nms_greedy_plain(*top, **kw)
            outs = {f"cluster {cs}": nk._launch(*top, MAX_DET, IOU, CONF, True, cs)
                    for cs in (1, 2, 4, 8)}
            outs[f"the wrapper's cluster {nk.cluster_size(k)}"] = nms_greedy(*top, **kw)
            torch.cuda.synchronize()
            for how, out in outs.items():
                n_edge += 1
                if not all(bits_equal(a, b) for a, b in zip(out, ref)):
                    raise AssertionError(f"nms_greedy disagrees with its plain version at k={k} "
                                         f"on {kind} candidates, {how}")
    print(f"kernel nms_greedy: {n_edge} edge runs (k in {NMS_EDGE_K} x {NMS_EDGE_KINDS} x "
          f"clusters of 1, 2, 4, 8 and the wrapper's min(8, ceil(k / 32))) bit-equal, NaN "
          f"payloads included")

    tops = [nms_topk(*sets[i][1], max_det=MAX_DET, conf_thresh=CONF) for i in range(len(heads))]
    kw = dict(max_det=MAX_DET, iou_thresh=IOU, conf_thresh=CONF)
    kernel = lambda top: nms_greedy(*top, **kw)  # noqa: E731
    plain = lambda top: nms_greedy_plain(*top, **kw)  # noqa: E731
    pool = tops * 10
    us, ms = device_us(kernel, pool), cuda_ms(kernel, pool)
    plain_us = device_us(plain, tops)
    plain_launches = profile_launches(plain, tops[0])
    k = len(tops[0][1])
    nbytes = k * (16 + 4 + 4) + MAX_DET * (16 + 4 + 4 + 1)
    ops = max(nms_ops(top, True) for top in tops)
    bound_ms, bound_by = bound(ops, nbytes, F32_OPS_PER_S)
    live = [int((top[1] >= CONF).sum()) for top in tops]
    print(f"kernel nms_greedy k={k} on the head outputs ({live} of {k} candidates above "
          f"{CONF}; a cluster of {nk.cluster_size(k)}), {card}: {us!r} us (profiler device "
          f"time; CUDA events {ms * 1e3!r} us a call, {queued_us(kernel, pool)!r} us queued back "
          f"to back), bound {bound_ms * 1e3!r} us by "
          f"{bound_by} ({nbytes} bytes, {ops} f32 operations at 67 TFLOP/s), share "
          f"{bound_ms * 1e3 / us!r}: latency sets its time; plain version {plain_us!r} us of "
          f"device time in {plain_launches} launches a call; no PyTorch call computes NMS "
          f"here (library: none)")
    stamps = torch.zeros(5, dtype=torch.int64, device="cuda")
    split = []
    for top in pool:
        nk._launch(*top, MAX_DET, IOU, CONF, True, nk.cluster_size(k), stamps)
        g = stamps.cpu().numpy().astype(np.float64)
        split.append([*np.diff(g), g[4] - g[0]])
    split = np.asarray(split)
    print(f"kernel nms_greedy k={k} stage split, {card} (ns, mean over {len(pool)} calls, "
          f"%globaltimer of block 0): " + ", ".join(
              f"{name} {split[:, i].mean():.0f}" for i, name in enumerate(NMS_STAGES)) +
          f"; first stamp to last {split[:, -1].mean():.0f} of {us * 1e3:.0f} device")
    if parent is not None:
        alternate(f"kernel nms_greedy k={k}", {"parent": lambda top: parent[1](top, kw),
                                               "this tree": kernel}, pool, card)
    if parent is not None and parent[2] is not None:
        lib, stamps = parent[2]["nms.cu"]
        split = []
        for top in pool:
            outs = (torch.empty((MAX_DET, 4), device="cuda"), torch.empty(MAX_DET, device="cuda"),
                    torch.empty(MAX_DET, dtype=torch.int32, device="cuda"),
                    torch.empty(MAX_DET, dtype=torch.bool, device="cuda"))
            lib.avp_nms_greedy(*(t.data_ptr() for t in top), *(t.data_ptr() for t in outs), k,
                               MAX_DET, IOU, CONF, 1, torch.cuda.current_stream().cuda_stream)
            g = stamps[:5].cpu().numpy().astype(np.float64)
            split.append([*np.diff(g), g[4] - g[0]])
        split = np.asarray(split)
        print(f"parent's nms_greedy k={k} stage split, {card} (ns, mean over {len(pool)} calls, "
              f"%globaltimer in a stamped copy): " + ", ".join(
                  f"{name} {split[:, i].mean():.0f}" for i, name in enumerate(
                      ("staging", "matrix", "greedy pass", "output"))) +
              f"; first stamp to last {split[:, -1].mean():.0f}")
    return dict(max_abs_err=float(worst), ms=us / 1e3, plain_ms=plain_us / 1e3,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


LON_KINDS = (("NMS (the kernel)", ("nms_greedy_kernel",)),
             ("letterbox (the preprocess kernel)", ("fused_preprocess_kernel",)),
             ("convolutions", ("conv", "xmma", "cudnn", "fprop", "implicit")),
             ("matrix products", ("gemm", "gemv", "cutlass", "dot_kernel")),
             ("top-k and sorts", ("topk", "sort", "Sort", "radix")),
             ("copies and memsets", ("Memcpy", "Memset")))


def check_tables(tables):
    for i, t in enumerate(tables):
        if t.shape != (MAX_DET, 7) or t.dtype != torch.float32 or not t.is_cuda:
            raise AssertionError(f"frame {i}: table {tuple(t.shape)} {t.dtype} {t.device}")
        if not torch.isfinite(t).all():
            raise AssertionError(f"frame {i}: non-finite table")
        valid = t[:, 6]
        n = int(valid.sum())
        if not (((valid == 0) | (valid == 1)).all() and (valid[:n] == 1).all()):
            raise AssertionError(f"frame {i}: valid flags {valid.tolist()}")
        rows, rest = t[:n], t[n:]
        if not ((rest == 0).all() and (rows[:, 4] >= CONF).all()
                and ((rows[:, 5] >= 0) & (rows[:, 5] <= 3) & (rows[:, 5] == rows[:, 5].round())).all()
                and (rows[:, [0, 2]] >= 0).all() and (rows[:, [0, 2]] <= FRAME_HW[1]).all()
                and (rows[:, [1, 3]] >= 0).all() and (rows[:, [1, 3]] <= FRAME_HW[0]).all()):
            raise AssertionError(f"frame {i}: malformed table {t[:max(n, 1)].tolist()}")


def phase_longitudinal(card):
    """The longitudinal program at full width (build_longitudinal_pipeline,
    bf16): 60 distinct 720p frames, each step under sync-debug "error";
    -> its launch counts."""
    from autoware_vision_pilot_tpu_torch.runtime.pipeline import build_longitudinal_pipeline

    t0 = time.perf_counter()
    pipe = build_longitudinal_pipeline("cuda", torch.bfloat16, SEED)
    n = WARM + TIMED
    pool = frames(n, FRAME_HW, SEED + 10).cuda()
    torch.cuda.synchronize()
    print(f"longitudinal build: {time.perf_counter() - t0:.1f} s")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    latencies, enqueue, tables = [], [], []
    reset_counts()  # count only this path's launches
    for i in range(n):
        start.record()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")  # any host sync inside the step raises
        try:
            table = pipe(pool[i])
        finally:
            torch.cuda.set_sync_debug_mode("default")
        enqueue.append(time.perf_counter() - t0)
        end.record()
        end.synchronize()
        latencies.append(start.elapsed_time(end))
        tables.append(table)
    launches = read_counts()
    check_tables(tables)
    expect_launches(launches, {"fused_letterbox": n, "nms_greedy": n, "fused_preprocess": 0,
                               "int8_quantize": 0, "int8_conv": 0, "lane_filter_walk": 0})
    timed = np.asarray(latencies[WARM:])
    p50, p99 = (float(np.percentile(timed, q)) for q in (50, 99))
    kept = [int(t[:, 6].sum()) for t in tables]
    print(f"bf16 longitudinal step, {FRAME_HW[0]}x{FRAME_HW[1]} -> letterbox {LON_HW[0]}x"
          f"{LON_HW[1]} -> AutoSpeed n -> NMS, {card}: p50 {p50!r} ms, p99 {p99!r} ms, mean "
          f"{float(timed.mean())!r} ms over {len(timed)} frames after {WARM} warm-up (CUDA "
          f"events per frame); host enqueue p50 {1e3 * float(np.median(enqueue[WARM:]))!r} "
          f"ms; no host sync in any step (sync-debug \"error\"); launches {launches}; kept "
          f"boxes a frame {min(kept)}-{max(kept)}; first rows of the last table "
          f"{tables[-1][:2].tolist()}")
    profile_by_kind(lambda i: pipe(pool[i]), LON_KINDS, "longitudinal", card)
    del pipe, pool
    torch.cuda.empty_cache()
    return launches


# ---------- the stream axis, the engine and the fleet ----------

STREAMS = (1, 3, 8)
ENGINE_FRAMES = 60
FLEET_N, FLEET_TICKS = 8, 30


def batched_times(label, fn, pools, card):
    """Profiler device time of fn on batches of 8 streams against 8 times
    its time on one: ``pools`` {1: [x], 8: [x]}. -> (us at N = 8, us at
    N = 1)."""
    us8, us1 = device_us(fn, pools[8]), device_us(fn, pools[1])
    print(f"{label}, {card}: N = 8 {us8!r} us a launch against 8 x N = 1 {8 * us1!r} us "
          f"(N = 1: {us1!r} us; profiler device time)")
    return us8, us1


def phase_batched(card):
    """The preprocess (on the lateral crop frames[:, 420:] of a batch, read
    in place), letterbox, walk and NMS kernels at N in STREAMS, one launch
    a batch: every stream bit-equal to the plain version and to a launch on
    that stream alone; the time of N = 8 beside 8 x N = 1. -> {kernel:
    (us at 8, us at 1)}."""
    from autoware_vision_pilot_tpu_torch.ops.kernels.lane_filter_kernel import lane_filter_walk
    from autoware_vision_pilot_tpu_torch.ops.kernels.nms_kernel import nms_greedy
    from autoware_vision_pilot_tpu_torch.ops.kernels.preprocess_kernel import (fused_letterbox,
                                                                               fused_preprocess)
    from autoware_vision_pilot_tpu_torch.ops.postprocess import nms_greedy_plain
    from autoware_vision_pilot_tpu_torch.ops.preprocess import letterbox, preprocess_imagenet
    from autoware_vision_pilot_tpu_torch.perception.lane_filter import lane_filter_walk_plain

    def crop(b):
        return b[:, LATERAL_CROP:]

    kw = dict(max_det=MAX_DET, iou_thresh=IOU, conf_thresh=CONF)
    cases = {
        "fused_preprocess": (lambda x: fused_preprocess(crop(x), OUT_HW),
                             lambda x: preprocess_imagenet(crop(x), OUT_HW, torch.bfloat16)
                             .permute(0, 3, 1, 2),
                             lambda n, s: frames(n, FRAME_HW, s).cuda(), fused_preprocess),
        "fused_letterbox": (lambda x: fused_letterbox(x, LON_HW)[0],
                            lambda x: letterbox(x, LON_HW, FRAME_HW, dtype=torch.bfloat16)[0]
                            .permute(0, 3, 1, 2),
                            lambda n, s: frames(n, FRAME_HW, s).cuda(), fused_letterbox),
        "lane_filter_walk": (lane_filter_walk, lane_filter_walk_plain,
                             lambda n, s: torch.stack([torch.from_numpy(lane_masks(
                                 LANE_HW, LANE_KINDS[(s + i) % len(LANE_KINDS)], s + i))
                                 for i in range(n)]).cuda(), lane_filter_walk),
        "nms_greedy": (lambda top: nms_greedy(*top, **kw),
                       lambda top: nms_greedy_plain(*top, **kw),
                       lambda n, s: tuple(torch.stack(p) for p in zip(*[
                           nms_edge_candidates(256, NMS_EDGE_KINDS[(s + i) % 4], s + i)
                           for i in range(n)])), nms_greedy),
    }
    times = {}
    for name, (kernel, plain, make, counted) in cases.items():
        for n in STREAMS:
            x = make(n, 70 + n)
            before = counted.launches
            out = kernel(x)
            torch.cuda.synchronize()
            if counted.launches != before + 1:
                raise AssertionError(f"{name} at N = {n}: {counted.launches - before} launches")
            outs = out if isinstance(out, tuple) else (out,)
            ref = plain(x)
            refs = ref if isinstance(ref, tuple) else (ref,)
            if not all(bits_equal(a, b) for a, b in zip(outs, refs)):
                raise AssertionError(f"{name} at N = {n} disagrees with its plain version")
            for i in range(n):
                xi = tuple(t[i:i + 1] for t in x) if isinstance(x, tuple) else x[i:i + 1]
                one = kernel(xi)
                ones = one if isinstance(one, tuple) else (one,)
                if not all(bits_equal(a[i:i + 1], b) for a, b in zip(outs, ones)):
                    raise AssertionError(f"{name} at N = {n}: stream {i} differs from a launch "
                                         "on it alone")
        pools = {n: [make(n, 80 + n * 10 + j) for j in range(4 if n == 8 else 16)]
                 for n in (1, 8)}
        times[name] = batched_times(f"kernel {name}, a batch of streams", kernel, pools, card)
        del pools
    print(f"batched kernels: preprocess (the crop frames[:, {LATERAL_CROP}:] in place), "
          f"letterbox, walk and NMS at N in {STREAMS}: every stream bit-equal to the plain "
          "version and to a launch on it alone (tol 0), one launch a batch")
    torch.cuda.empty_cache()
    return times


def phase_fleet_f32():
    """The batched lateral and longitudinal steps at N = 3 in f32 (TF32
    off) against 3 single-stream pipelines on the card, the same networks,
    3 ticks, the states carried: each network's batch-3 outputs within
    1e-3 * max|single| of the single-stream ones; then, the batched
    networks returning the single-stream outputs (hooks) and the same
    noise, the masks, AutoSteer's angle and the flags equal, the lane fits
    within 5e-3 * max|single|, the detection tables equal. PathFinder's
    outputs are printed, not held (its f32 fit, section 6 of PERF.md)."""
    from autoware_vision_pilot_tpu_torch.runtime.config import Config
    from autoware_vision_pilot_tpu_torch.runtime.fleet import (FleetLateralPipeline,
                                                               FleetLongitudinalPipeline)
    from autoware_vision_pilot_tpu_torch.runtime.pipeline import (SCALAR_FIELDS,
                                                                  build_lateral_pipeline,
                                                                  build_longitudinal_pipeline)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0, n = time.perf_counter(), 3
    lat = build_lateral_pipeline("cuda", torch.float32, SEED)
    lon = build_longitudinal_pipeline("cuda", torch.float32, SEED)
    fleet = FleetLateralPipeline(lat.lanes, lat.steer_net, Config(), n, dtype=torch.float32)
    fleet_lon = FleetLongitudinalPipeline(lon.net, Config(), n, dtype=torch.float32)
    fs = frames(3 * n, FRAME_HW, SEED + 11).cuda().view(3, n, *FRAME_HW, 3)
    states = fleet.init_states(SEED)
    singles = [lat.init_state(SEED) for _ in range(n)]
    noise = torch.zeros((n, 14), device="cuda")
    seen, forced = {}, {}

    def hook(name):
        def fn(m, a, y):
            if name not in forced:  # a single-stream call: keep its output
                seen.setdefault(name, []).append(y)
                return None
            seen[name + " batched"] = y
            return forced[name]
        return fn

    hooks = [lat.lanes.register_forward_hook(hook("lanes")),
             lat.steer_net.register_forward_hook(hook("steer")),
             lon.net.register_forward_hook(hook("pred"))]
    flags = [SCALAR_FIELDS.index(f) for f in ("autosteer_deg", "fused_valid", "path_valid")]
    worst = {}
    try:
        for tick in range(3):
            seen.clear(), forced.clear()
            ones = []
            for i in range(n):
                out, singles[i] = lat(fs[tick, i], singles[i], noise=noise[i])
                ones.append((out, lon(fs[tick, i])))
            forced["lanes"] = torch.cat(seen["lanes"])
            forced["steer"] = tuple(torch.cat(p) for p in zip(*seen["steer"]))
            forced["pred"] = torch.cat(seen["pred"])
            out, states = fleet(fs[tick], states, noise=noise)
            tables = fleet_lon(fs[tick])
            for name in ("lanes", "steer", "pred"):
                own = seen[name + " batched"]
                own, ref = (own[1], forced[name][1]) if name == "steer" else (own, forced[name])
                err = (own - ref).abs().max().item() / ref.abs().max().item()
                worst[name] = max(worst.get(name, 0.0), err)
                if not err <= 1e-3:
                    raise AssertionError(f"tick {tick}: the batch-3 {name} network is "
                                         f"{err!r} * max|single| from the single-stream one")
            for i, (one, table) in enumerate(ones):
                fin = torch.isfinite(one["coeffs"])
                scale = torch.where(fin, one["coeffs"], 0.0).abs().amax(-1, keepdim=True)
                fit = ((torch.where(fin, out["coeffs"][i], 0.0) - torch.where(fin, one["coeffs"],
                                                                              0.0)).abs()
                       / scale.clamp_min(1e-30)).max().item()
                worst["fits"] = max(worst.get("fits", 0.0), fit)
                if not (torch.equal(out["lane_masks"][i], one["lane_masks"])
                        and torch.equal(out["scalars"][i][flags], one["scalars"][flags])
                        and torch.equal(torch.isnan(out["coeffs"][i]), torch.isnan(one["coeffs"]))
                        and fit <= 5e-3 and torch.equal(tables[i], table)):
                    raise AssertionError(f"tick {tick} stream {i}: the batched step and the "
                                         "single-stream one disagree")
            print(f"f32 fleet tick {tick}, N = {n} against {n} single-stream pipelines: "
                  f"scalars batched {out['scalars'][:, :6].tolist()} single "
                  f"{[o['scalars'][:6].tolist() for o, _ in ones]}")
    finally:
        for h in hooks:
            h.remove()
    print(f"f32 fleet N = {n} vs single streams on the card: networks within "
          f"{ {k: v for k, v in worst.items() if k != 'fits'} } * max|single| (tol 1e-3), fed "
          f"the single streams' outputs masks, flags and AutoSteer equal, lane fits "
          f"{worst['fits']!r} * max|single| (tol 5e-3), detection tables equal; "
          f"{time.perf_counter() - t0:.1f} s")
    del lat, lon, fleet, fleet_lon
    torch.cuda.empty_cache()


def busy_share(run):
    """The device's busy share of ``run()``: kernel device time (profiler)
    over the run's wall time. -> (share, device ms, wall ms)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = sum(e.self_device_time_total for e in prof.key_averages()) / 1e3
    return dev / (wall * 1e3), dev, wall * 1e3


def percentiles(xs):
    a = np.asarray(xs, np.float64)
    return float(np.percentile(a, 50)), float(np.percentile(a, 99))


def phase_engine(card):
    """app.py::build_engine(Config()) in bf16 at full width on ENGINE_FRAMES
    distinct 720p frames from a host source, at pipeline depth 1, 2, 2 and
    1 in turns (the host's pace moves between runs), every dispatch under
    sync-debug "error": results in order and finite,
    the tracker fed the live detections of every frame, one preprocess,
    walk, letterbox and NMS launch a frame; p50/p99 end to end from
    PerformanceMetrics (host) and from CUDA events (upload to results on
    the host), and the device's busy share. -> the launch counts."""
    from autoware_vision_pilot_tpu_torch.app import build_engine
    from autoware_vision_pilot_tpu_torch.runtime.config import Config

    cfg = Config()
    cfg.target_fps = 0.0  # unpaced: as fast as the host and the card go
    rng = np.random.default_rng(SEED + 12)
    host = [rng.integers(0, 256, (*FRAME_HW, 3), dtype=np.uint8) for _ in range(ENGINE_FRAMES)]
    t0 = time.perf_counter()
    engine = build_engine(cfg, None, dtype=torch.bfloat16, device="cuda")
    engine.warmup()
    print(f"engine build and warm-up: {time.perf_counter() - t0:.1f} s")
    fed = []
    update = engine.object_finder.update_and_get_cipo

    def counting(dets, frame=None):
        fed.append(len(dets))
        return update(dets, frame)

    engine.object_finder.update_and_get_cipo = counting
    launches = dict.fromkeys(("fused_preprocess", "lane_filter_walk", "fused_letterbox",
                              "nms_greedy"), 0)
    for depth in (1, 2, 2, 1):
        it = iter(host)
        engine.frame_source = lambda: next(it, None)
        engine.metrics = type(engine.metrics)(report_every=10 ** 9)
        engine.device_ms, fed[:] = [], []
        torch.cuda.synchronize()
        reset_counts()  # count only this path's launches
        t0 = time.perf_counter()
        results = engine.run(pipeline_depth=depth, sync_check=True)
        wall = time.perf_counter() - t0
        counts = read_counts()
        expect_launches(counts, {k: ENGINE_FRAMES for k in launches} |
                        {"int8_quantize": 0, "int8_conv": 0})
        for k in launches:
            launches[k] += counts[k]
        if [r.frame_num for r in results] != list(range(ENGINE_FRAMES)):
            raise AssertionError(f"engine results out of order: {[r.frame_num for r in results]}")
        for r in results:
            vals = [r.steering_deg, r.cte, r.yaw_error, r.set_speed, r.accel_effort,
                    r.safe_distance]
            if not np.isfinite(vals).all():
                raise AssertionError(f"frame {r.frame_num}: non-finite result {r}")
        if len(fed) != ENGINE_FRAMES or min(fed) <= 0:
            raise AssertionError(f"the tracker was fed {fed} detections a frame")
        host_p = percentiles(np.asarray(engine.metrics.e2e_samples[WARM:]) * 1e3)
        dev_p = percentiles(engine.device_ms[WARM:])
        print(f"bf16 engine (build_engine: EgoLanes 320x640, AutoSteer, AutoSpeed n 640x640, "
              f"tracking, RSS planning, PID), depth {depth}, {ENGINE_FRAMES} distinct 720p host "
              f"frames, {card}: host loop p50 {host_p[0]!r} ms, p99 {host_p[1]!r} ms "
              f"(PerformanceMetrics, frames {WARM}-{ENGINE_FRAMES - 1}); upload to results on "
              f"the host p50 {dev_p[0]!r} ms, p99 {dev_p[1]!r} ms (CUDA events); "
              f"{ENGINE_FRAMES / wall!r} frames/s over the run; no host sync in any dispatch "
              f"(sync-debug \"error\"); launches {counts}; detections fed to the tracker a "
              f"frame {min(fed)}-{max(fed)}, tracks {min(r.n_tracks for r in results)}-"
              f"{max(r.n_tracks for r in results)}, CIPO on "
              f"{sum(r.cipo_distance >= 0 for r in results)} frames")
    it = iter(host[:20])
    engine.frame_source = lambda: next(it, None)
    share, dev, wall = busy_share(lambda: engine.run(pipeline_depth=2))
    print(f"bf16 engine, depth 2, 20 frames under torch.profiler, {card}: device busy "
          f"{share!r} of the wall time ({dev!r} ms of kernels in {wall!r} ms)")
    del engine
    torch.cuda.empty_cache()
    return launches


def phase_fleet(card):
    """FleetEngine over FLEET_N streams in bf16 at full width (EgoLanes
    320x640 and AutoSpeed n 640x640 at batch FLEET_N, an ObjectFinder,
    SpeedPlanner and PID a stream), FLEET_TICKS ticks of distinct 720p host
    frames, each dispatch under sync-debug "error": one preprocess, walk,
    letterbox and NMS launch a tick; tick p50/p99 (host, between ticks; and
    CUDA events, upload to results on the host) and the aggregate frames a
    second. -> the launch counts."""
    from autoware_vision_pilot_tpu_torch.perception.tracking import ObjectFinder
    from autoware_vision_pilot_tpu_torch.runtime.config import Config
    from autoware_vision_pilot_tpu_torch.runtime.fleet import (FleetEngine,
                                                               FleetLateralPipeline,
                                                               FleetLongitudinalPipeline)
    from autoware_vision_pilot_tpu_torch.runtime.pipeline import (build_lateral_pipeline,
                                                                  build_longitudinal_pipeline)

    cfg = Config()
    lat = build_lateral_pipeline("cuda", torch.bfloat16, SEED)
    lon = build_longitudinal_pipeline("cuda", torch.bfloat16, SEED)
    fleet = FleetLateralPipeline(lat.lanes, lat.steer_net, cfg, FLEET_N)
    fleet_lon = FleetLongitudinalPipeline(lon.net, cfg, FLEET_N)
    rng = np.random.default_rng(SEED + 13)
    base = rng.integers(0, 256, (FLEET_N, *FRAME_HW, 3), dtype=np.uint8)
    ticks = [np.roll(base, 37 * t, axis=2) ^ np.uint8(t) for t in range(FLEET_TICKS)]
    finders = [ObjectFinder(np.eye(3), FRAME_HW[1], FRAME_HW[0]) for _ in range(FLEET_N)]
    stamps = []

    def source(it):
        def next_tick():
            stamps.append(time.perf_counter())
            return next(it, None)
        return next_tick

    warm = FleetEngine(cfg, fleet, fleet_lon, finders, frame_source=source(iter(ticks[:3])))
    warm.run()
    engine = FleetEngine(cfg, fleet, fleet_lon,
                         [ObjectFinder(np.eye(3), FRAME_HW[1], FRAME_HW[0])
                          for _ in range(FLEET_N)], frame_source=source(iter(ticks)))
    stamps.clear()
    torch.cuda.synchronize()
    reset_counts()  # count only this path's launches
    t0 = time.perf_counter()
    results = engine.run(pipeline_depth=1, sync_check=True)
    wall = time.perf_counter() - t0
    counts = read_counts()
    expect_launches(counts, {"fused_preprocess": FLEET_TICKS, "lane_filter_walk": FLEET_TICKS,
                             "fused_letterbox": FLEET_TICKS, "nms_greedy": FLEET_TICKS,
                             "int8_quantize": 0, "int8_conv": 0})
    if len(results) != FLEET_TICKS or any(len(r) != FLEET_N for r in results) or \
            any(x.frame_num != t for t, r in enumerate(results) for x in r):
        raise AssertionError("the fleet's ticks are out of order or short")
    if not all(np.isfinite([x.steering_deg, x.set_speed, x.accel_effort]).all()
               for r in results for x in r):
        raise AssertionError("non-finite fleet results")
    host_p = percentiles(np.diff(stamps)[3:] * 1e3)
    dev_p = percentiles(engine.device_ms[3:])
    print(f"bf16 FleetEngine, N = {FLEET_N} streams at full width, {FLEET_TICKS} ticks, "
          f"{card}: tick p50 {host_p[0]!r} ms, p99 {host_p[1]!r} ms (host, between ticks, "
          f"after 3); upload to results on the host p50 {dev_p[0]!r} ms, p99 {dev_p[1]!r} ms "
          f"(CUDA events); aggregate {FLEET_N * FLEET_TICKS / wall!r} frames/s "
          f"({FLEET_TICKS / wall!r} ticks/s); no host sync in any dispatch; launches {counts}")
    del lat, lon, fleet, fleet_lon, engine, warm
    torch.cuda.empty_cache()
    return counts


def host_costs_of(root):
    """--host-costs ROOT: phase 7's host-cost measurement alone, over the
    port package found in ROOT (this repository, or an earlier commit of it
    unpacked with git archive), to compare two trees in one call."""
    card = phase_device()
    sys.path.insert(0, str(pathlib.Path(root).resolve()))
    from autoware_vision_pilot_tpu_torch.kernels import build
    from autoware_vision_pilot_tpu_torch.pipeline import build_pipeline_fused

    print(f"host costs of the package in {build.PACKAGE.parent}")
    build.load()
    bf16_pipe = build_pipeline_fused("cuda", torch.bfloat16, SEED, CTX_HW, OUT_HW)
    int8_pipe = build_pipeline_fused("cuda", torch.bfloat16, SEED, CTX_HW, OUT_HW,
                                     int8=True, min_ch=256)
    host_costs(bf16_pipe, int8_pipe, frames(HOST_FRAMES, FRAME_HW, SEED + 5).cuda(), card)


T0 = time.perf_counter()


def main():
    if sys.argv[1:2] == ["--host-costs"]:
        return host_costs_of(sys.argv[2])
    parent_root = sys.argv[2] if sys.argv[1:2] == ["--parent"] else None
    card = phase_device()
    sys.path.insert(0, str(REPO))
    phase_build()
    parent = parent_kernels(parent_root)
    launch_floor(card)
    preprocess, crop = phase_kernel()
    records = {"fused_preprocess": preprocess, **phase_int8_kernels(card),
               "lane_filter_walk": phase_lane_filter(card, parent)}
    phase_f32()
    bf16_pipe = phase_bf16(card)
    launches = phase_int8(card, bf16_pipe)  # the selective-int8 main path
    del bf16_pipe
    torch.cuda.empty_cache()
    phase_lateral_f32()
    lateral = phase_lateral(card)  # the lateral program
    launches["lane_filter_walk"] = lateral["lane_filter_walk"]
    records["fused_letterbox"] = phase_letterbox(card)
    heads = phase_longitudinal_f32()
    records["nms_greedy"] = phase_nms(card, heads, parent)
    longitudinal = phase_longitudinal(card)  # the longitudinal program
    launches["fused_letterbox"] = longitudinal["fused_letterbox"]
    launches["nms_greedy"] = longitudinal["nms_greedy"]
    batched = phase_batched(card)
    phase_fleet_f32()
    engine = phase_engine(card)  # the serving engine (app.py::build_engine)
    fleet = phase_fleet(card)  # the N-stream fleet
    for name in ("fused_preprocess", "lane_filter_walk", "fused_letterbox", "nms_greedy"):
        if engine[name] <= 0 or fleet[name] <= 0:
            raise AssertionError(f"the engine or the fleet never launched {name}")
        launches[name] += engine[name] + fleet[name]
    print("batched kernel times at N = 8 against 8 x N = 1, " + card + ": " + "; ".join(
        f"{k} {v[0]!r} us vs {8 * v[1]!r} us" for k, v in batched.items()))
    print(f"fused_preprocess on the lateral crop {FRAME_HW[0]}x{FRAME_HW[1]}[{LATERAL_CROP}:]"
          f" -> {OUT_HW[0]}x{OUT_HW[1]} bf16, {card}: {crop['ms'] * 1e3!r} us, bound "
          f"{crop['bound_ms'] * 1e3!r} us, plain {crop['plain_ms'] * 1e3!r} us (profiler)")
    pkg = "autoware_vision_pilot_tpu_torch/csrc/"
    sources = {
        "fused_preprocess": (pkg + "preprocess.cu",
                             "autoware_vision_pilot_tpu/ops/pallas/preprocess_kernel.py:51"),
        "int8_quantize": (pkg + "int8_conv.cu", "autoware_vision_pilot_tpu/nn/layers.py:103"),
        "int8_conv_wgmma": (pkg + "int8_conv_sm90.cu",
                            "autoware_vision_pilot_tpu/nn/layers.py:110"),
        "int8_conv_mma": (pkg + "int8_conv.cu", "autoware_vision_pilot_tpu/nn/layers.py:110"),
        "int8_conv_pointwise": (pkg + "int8_pointwise.cu",
                                "autoware_vision_pilot_tpu/nn/layers.py:81"),
        "int8_conv_dot": (pkg + "int8_pointwise.cu", "autoware_vision_pilot_tpu/nn/layers.py:81"),
        "lane_filter_walk": (pkg + "lane_filter.cu",
                             "autoware_vision_pilot_tpu/perception/lane_filter.py:113"),
        "fused_letterbox": (pkg + "preprocess.cu",
                            "autoware_vision_pilot_tpu/ops/preprocess.py:86"),
        "nms_greedy": (pkg + "nms.cu", "autoware_vision_pilot_tpu/ops/postprocess.py:88"),
    }
    # PR 2's mma.sync kernel keeps the windows > 1 with C < 128, which the
    # main path has none of: it is checked and timed above, and launched 0
    # times there. Each path's own kernels: the int8 path's counts above,
    # the lateral and longitudinal programs' here.
    for name in sources:
        if launches[name] <= 0 and name != "int8_conv_mma":
            raise AssertionError(f"the main path never launched {name}")
    if lateral["fused_preprocess"] <= 0:
        raise AssertionError("the lateral program never launched fused_preprocess")
    print(f"chip_smoke wall time: {time.perf_counter() - T0:.1f} s")
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
