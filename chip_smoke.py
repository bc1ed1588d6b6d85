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
 19. wrappers f32: the six wrappers of inference/infer.py (SceneSeg,
             Scene3D, DomainSeg, EgoLanes, AutoSpeed, AutoSteer) at full
             width in f32 with TF32 off, on the card against the same
             wrapper on the CPU, one 720p frame: raw forwards within 1e-3 *
             max|CPU|, masks equal wherever the CPU's logits decide them by
             more than twice that, Scene3D's scaled depth within the bar
             over the logits' range; fed the CPU's pred, AutoSpeed's boxes,
             scores, classes and valid flags equal; AutoSteer's degrees.
 20. wrappers bf16: each wrapper's _fwd on 60 distinct 720p frames on the
             card (AutoSteer: 60 logit stacks), 10 warm-up and 50 timed
             with CUDA events, host enqueue time; one preprocess launch a
             frame (AutoSpeed: one letterbox and one NMS launch).
 21. int8 wrappers: SceneSeg, Scene3D, DomainSeg and EgoLanes with
             precision="int8" at int8_min_channels 128, bf16: int8 convs
             by route and launches a frame, every int8 conv of one frame
             bit-equal to its plain version on its own input, p50/p99.
 22. min_channels-128 shapes: the 12 int8 conv shapes that phase 21 adds
             to the main path's (N = 1, 3 and 64 on 128-wide wgmma tiles at
             320x640 and 80x160, 128 -> 128 at M = 204,800, the split-K
             128 -> 256 at 10x20, B0's 1x1 and SE convs with 144-240 input
             channels), each at full size bit-equal to the plain versions
             on every variant of phase 4, then timed as in phase 4.
 23. backend: middleware backend_from_params for each of the four
             families (by file stem, seeded weights, bf16): do_inference
             equal to the matching wrapper's raw forward.
 24. clip: BASELINE config 3 (bench.py::bench_clip): EgoLanes + DomainSeg
             in bf16 on 10-frame windows sliding by one through a 720p clip
             on the card: the preprocess kernel at batch 10 bit-equal to its
             plain version, window p50/p99 and clip frames a second.
 25. AutoSteer 2.0 and AutoDrive at 512x1024 (two frames for AutoDrive)
             and the legacy EgoPath heads (BEVPathContext at 10x20, the
             AutoSteerHead on a 40x80 neck): f32 card vs CPU within 1e-3 *
             max|CPU|, then bf16 p50/p99.
 26. Lite f32: DeepLabV3+ on each Lite config (SceneSegLite, Scene3DLite,
             EgoLanesLite) at 320x640 and UNet++ (SceneSegLite's config,
             model unetplusplus) at 96x192, full width and depth, seed 0,
             eval_lite's forward on a uint8 frame: f32 card vs CPU within
             1e-3 * max|CPU|.
 27. Lite: each of the four at 320x640, bf16 then int8 at min_channels
             128 (40, 38, 38 and 48 int8 convs): p50/p99 over TIMED
             distinct frames, the int8 convs by route and launches a frame,
             every int8 conv of one frame bit-equal to its plain version;
             UNet++'s eight 3x3 shapes with C % 128 != 0 bit-equal on every
             variant of phase 4; the 21 new int8 shapes timed as in phase 4.
 28. Lite CLI: export/eval_lite.py::main on SceneSegLite, --synthetic 4
             --bench, bf16 and --int8: its summary line and launches.
The run prints its wall time, and that of phases 19-25 and 26-28.
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


# the runtime calls that put work on the card, as a trace names them
LAUNCH_CALLS = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cuMemcpy", "cudaMemset", "cuMemset")
GUARDS = 4  # device_us: torch.cuda._sleep kernels (spin_kernel) before and after the calls
CUDA_RECORD = torch.autograd.DeviceType.CUDA


def trace_counts(prof):
    """-> (device records, launches the host made) of a torch.profiler trace."""
    events = prof.events()
    ops = sum(1 for e in events if e.device_type == CUDA_RECORD)
    launches = sum(1 for e in events if e.device_type != CUDA_RECORD
                   and e.name.startswith(LAUNCH_CALLS))
    return ops, launches


def device_us(fn, inputs):
    """Mean device microseconds per call of fn(x) over ``inputs``: the sum
    of every kernel's own time in a torch.profiler trace of the run. The
    trace is taken only when it holds a device record for each launch the
    host made in it (the runtime's launch, copy and set calls), else it is
    taken again, up to five times, and then the calls are timed queued
    (queued_us). A trace can drop device records: from phase 10 on, traces
    on the card lost one to four. GUARDS tiny kernels on each side
    of the calls are left out of the count and the time, so that a record
    lost at either end of the trace is one of theirs."""
    from torch.profiler import ProfilerActivity, profile

    def guards():
        for _ in range(GUARDS):
            torch.cuda._sleep(100)

    fn(inputs[0])
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            guards()
            for x in inputs:
                fn(x)
            guards()
            torch.cuda.synchronize()
        spins = sum(1 for e in prof.events()
                    if e.device_type == CUDA_RECORD and "spin_kernel" in e.name)
        ops, launches = trace_counts(prof)
        ops, launches = ops - spins, launches - 2 * GUARDS
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if "spin_kernel" not in e.key)
        if total > 0 and launches >= len(inputs) and ops >= launches:
            return total / len(inputs)
    us = queued_us(fn, inputs)
    print(f"device_us: the profiler's traces of {getattr(fn, '__name__', fn)} dropped records "
          f"five times (last: {ops} device records for {launches} launches); {us!r} us a call "
          f"from CUDA events around the calls queued behind a sleep (back to back on the card, "
          f"the gaps between them included)")
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


def check_int8_kernels(g, shapes=None):
    """Every route bit-equal to the plain versions at ``shapes`` (by
    default INT8_SHAPES), through int8_conv (int8 input) and int8_conv2d
    (float input; the pointwise and dot routes quantize it as they load
    it, with no quantize launch). -> worst error by kernel."""
    from autoware_vision_pilot_tpu_torch.ops.kernels.int8_conv import (
        FUSED_ROUTES, int8_conv, int8_conv2d, int8_conv_plain, int8_conv_plan, int8_quantize,
        int8_quantize_plain, padded_channels)

    worst = dict.fromkeys(("int8_quantize", *CONV_KERNEL.values()), 0.0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for shape in shapes or INT8_SHAPES:
        k, cin, cout, h, w, batch, route = shape
        pad = k // 2
        plan = int8_conv_plan(batch, h, w, padded_channels(cin), cout, k, k, pad, sms)
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


def time_int8_shapes(g, card, table=MAIN_INT8, what="the 24 shapes"):
    """The int8 conv shapes of ``table`` (by default the 24 of the main
    path), bf16 with a scalar scale, each timed over rotating inputs (and
    weights) that together exceed the L2 where the shape allows. At a 1x1
    shape also int8_conv2d (one launch that quantizes on load: what the
    paths run) and the "mma" route's mma.sync kernel on the same int8 inputs. -> the
    JSON records' timings (of RECORD_SHAPES found in ``table``)."""
    import torch.nn.functional as F
    from autoware_vision_pilot_tpu_torch.ops.kernels.int8_conv import (
        _launch, _mma_plan, _reciprocal, int8_conv, int8_conv2d, int8_conv_plain,
        int8_conv_plan, int8_quantize, int8_quantize_plain, pad_channels, padded_channels)

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    # the frame's int8 device time from the shapes alone: the 3x3 convs and
    # their quantize, the 1x1 convs as they run now, and as they ran on the
    # mma.sync kernel after a separate quantize
    frame = dict.fromkeys(("3x3 conv", "3x3 quantize", "3x3 channel pads (C % 16 != 0)",
                           "1x1 conv (quantize on load)",
                           "1x1 on mma.sync + quantize (before)"), 0.0)
    missing = {k: [] for k in frame}  # shapes the profiler recorded nothing of
    records = {}
    for k, cin, cout, h, w, per_frame in table:
        pad = k // 2
        plan = int8_conv_plan(1, h, w, padded_channels(cin), cout, k, k, pad, sms)
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
        # the kernels' inputs: int8_conv pads C to a multiple of 16 (x and the
        # weights) on every call; the kernels are timed on the padded inputs,
        # the pads apart
        cp = padded_channels(cin)
        extra = cp - cin
        ksets = [(pad_channels(x, cp), pad_channels(wt, cp), ws, b, sx,
                  pad_channels(xq, cp), w16) for x, wt, ws, b, sx, xq, w16 in sets]

        def conv(i):
            x, wt, ws, b, sx, xq, _ = ksets[i]
            return int8_conv(xq, wt, ws, sx, b, pad, torch.bfloat16)

        def conv2d(i):
            x, wt, ws, b, sx, _, _ = ksets[i]
            return int8_conv2d(x, wt, ws, sx, b, pad)

        def old_mma(i):
            x, wt, ws, b, sx, xq, _ = ksets[i]
            return _launch(_mma_plan(M, cout, K, sms), xq, wt, ws, sx, b, pad, torch.bfloat16)

        def conv_one_block_a_unit(i):
            x, wt, ws, b, sx, xq, _ = ksets[i]
            return _launch(plan._replace(blocks=math.prod(plan.grid)), xq, wt, ws, sx,
                           b, pad, torch.bfloat16)

        def quant(i):
            return int8_quantize(ksets[i][0], ksets[i][4])

        def channel_pads(i):  # what int8_conv2d adds to a call at this C
            return pad_channels(sets[i][0], cp), pad_channels(sets[i][1], cp)

        def cudnn(i):
            x, _, _, b, _, _, w16 = sets[i]
            return F.conv2d(x, w16, b, 1, pad)

        t = {"conv": device_us(conv, idx), "quantize": device_us(quant, idx),
             "cudnn": device_us(cudnn, idx),
             "pad": device_us(channel_pads, idx) if extra else 0.0}
        if k == 1:
            t["conv2d"], t["old_mma"] = device_us(conv2d, idx), device_us(old_mma, idx)
        conv_ms = cuda_ms(conv, idx)
        # the persistent schedule against one block per unit of work
        one_each = (device_us(conv_one_block_a_unit, idx)
                    if plan.route in ("wgmma", "splitk") and plan.blocks < math.prod(plan.grid)
                    else None)
        # torch._int_mm on a pre-built im2col matrix (leaves out the im2col)
        intmm = None
        n8 = -(-cout // 8) * 8  # _int_mm takes N in multiples of 8: pad a thin N with zeros
        if M > 16 and K % 8 == 0:
            cols = []
            for s in range(min(n, max(1, math.ceil(1.2 * L2_BYTES / (M * K + n8 * K))))):
                xq, wt = sets[s][5], sets[s][1]
                # K in (c, r, s) order on both sides: unfold's, and OIHW's
                a = F.unfold(xq.float(), k, padding=pad) if k > 1 else xq.float().flatten(2)
                a = a.transpose(1, 2).reshape(M, K).to(torch.int8).contiguous()
                b2 = torch.zeros(n8, K, dtype=torch.int8, device=wt.device)
                b2[:cout] = wt.contiguous().reshape(cout, K)
                cols.append((a, b2.t()))  # (K, N), column-major
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
                 if k == 1 else {"3x3 conv": t["conv"], "3x3 quantize": t["quantize"],
                                 "3x3 channel pads (C % 16 != 0)": t["pad"]})
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
              + (f"C padded to {cp} on every call (int8_conv pads x and the weights: "
                 f"{t['pad']!r} us, not in the conv or quantize time), " if extra else "")
              + f"conv {t['conv']!r} us ({rate!r} TOP/s; CUDA events {conv_ms * 1e3!r} us"
              + (f"; one block per unit of work {one_each!r} us" if one_each else "")
              + f"), bound {bms * 1e3!r} us by {by}, share {share!r}{fused_note}; bf16 "
              f"cuDNN conv {t['cudnn']!r} us; torch._int_mm on im2col (no im2col) "
              + (f"{intmm!r} us" + (f" (N padded to {n8})" if n8 != cout else "")
                 if intmm is not None else "not taken (M <= 16)")
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
        del sets, ksets
        torch.cuda.empty_cache()
    print(f"int8 per frame from {what} x their counts, {card}: "
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
                           and e.device_type == CUDA_RECORD),
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
    """Kernels (and memsets/copies) one call of fn(x) launches, counted on
    the host's side of a trace (a trace can drop device records)."""
    from torch.profiler import ProfilerActivity, profile

    fn(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn(x)
        torch.cuda.synchronize()
    return trace_counts(prof)[1]


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


# ---------- the per-network wrappers, the backend and the clip ----------

# (window, cin, cout, h, w, batch, route) of phase 22: the int8 conv shapes
# that precision="int8" at min_channels 128 adds to the main path's, checked
# bit for bit at their full size
MIN128_SHAPES = (
    (3, 128, 1, 320, 640, 1, "wgmma"),     # Scene3D's SuperDepthHead.decode_layer_10
    (3, 128, 3, 80, 160, 1, "wgmma"),      # EgoLanesHead.decode_layer_8
    (3, 128, 64, 320, 640, 1, "wgmma"),    # SegHead.decode_layer_9 (SceneSeg, DomainSeg)
    (3, 128, 128, 320, 640, 1, "wgmma"),   # SegHead / DepthHead decode_layer_8, M = 204,800
    (3, 128, 256, 10, 20, 1, "splitk"),    # ContextBlock.context_layer_4
    (1, 144, 24, 80, 160, 1, "pointwise"),   # stage-2 project
    (1, 144, 40, 40, 80, 1, "pointwise"),    # stage-3 first project
    (1, 240, 40, 40, 80, 1, "pointwise"),    # stage-3 project
    (1, 240, 80, 20, 40, 1, "pointwise"),    # stage-4 first project
    (1, 192, 1152, 10, 20, 1, "pointwise"),  # stage-6/7 expand
    (1, 144, 6, 1, 1, 1, "dot"),           # SE squeeze of stage 2
    (1, 240, 10, 1, 1, 1, "dot"),          # SE squeeze of stage 3
)
# (window, cin, cout, h, w, convs): those shapes with their count over one
# frame of each of the four int8 wrappers (60 convs)
MIN128_INT8 = tuple((*s[:5], n) for s, n in zip(
    MIN128_SHAPES, (1, 1, 2, 4, 4, 4, 4, 4, 4, 16, 8, 8)))
# int8 convs a frame by route at min_channels 128, from the networks' modules
# (tests/test_torch_int8_plan.py counts the same shapes)
WRAPPER_INT8 = {"SceneSeg": {"wgmma": 8, "splitk": 5, "pointwise": 19, "dot": 14},
                "Scene3D": {"wgmma": 9, "splitk": 5, "pointwise": 19, "dot": 14},
                "DomainSeg": {"wgmma": 8, "splitk": 5, "pointwise": 19, "dot": 14},
                "EgoLanes": {"wgmma": 7, "splitk": 5, "pointwise": 19, "dot": 14}}
CLIP_BATCH = 10   # BASELINE config 3: EgoLanes + DomainSeg over a clip, 10 frames a window
STEER2_HW = (512, 1024)  # AutoSteer 2.0 and AutoDrive: the reference's input


def seg_wrappers():
    from autoware_vision_pilot_tpu_torch.inference import (DomainSegInfer, EgoLanesInfer,
                                                           Scene3DInfer, SceneSegInfer)
    return {"SceneSeg": SceneSegInfer, "Scene3D": Scene3DInfer, "DomainSeg": DomainSegInfer,
            "EgoLanes": EgoLanesInfer}


def no_tf32():
    """Full f32 on the card: cuDNN convs and matmuls default to TF32, which
    keeps ~3 decimal digits and could not be held to the CPU at 1e-3."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def held(name, got, ref, rel=1e-3):
    """max |got - ref| within rel * max|ref|, or raise; -> the error."""
    got, ref = got.float().cpu(), ref.float().cpu()
    if got.shape != ref.shape:
        raise AssertionError(f"{name}: {tuple(got.shape)} vs {tuple(ref.shape)}")
    err = (got - ref).abs().max().item()
    tol = rel * ref.abs().max().item()
    if not err <= tol:
        raise AssertionError(f"{name}: card and CPU disagree, {err} > {tol}")
    return err, tol


MIN_DECIDED = 0.9  # the least share of mask values the CPU's logits must decide


def decided_equal(name, got, ref, logits, margin):
    """The masks ``got`` and ``ref`` equal wherever the reference logits
    (1, h, w, C) decide them by more than ``margin`` (a class margin for
    C > 2 argmax masks, else the distance from 0), and more than
    MIN_DECIDED of the values decided. -> the decided share."""
    lg = logits[0].float().cpu()
    if name == "SceneSeg":
        top = lg.topk(2, dim=-1).values
        where = top[..., 0] - top[..., 1] > margin
    else:
        where = lg.abs() > margin
        where = where[..., 0] if name == "DomainSeg" else where
    share = where.float().mean().item()
    if not share > MIN_DECIDED:
        raise AssertionError(f"{name}: the CPU's logits decide only {share} of the mask")
    got, ref = got.cpu(), ref.cpu()
    if not torch.equal(got[where], ref[where]):
        raise AssertionError(f"{name}: card and CPU masks differ where the logits decide them")
    return share


def phase_wrappers_f32():
    """Phase 19: the six wrappers of inference/infer.py at full width in
    f32 with TF32 off, on the card against the same wrapper on the CPU
    (same seeded weights, one 720p frame): raw forwards within 1e-3 *
    max|CPU|, masks equal wherever the CPU's logits decide them by more than
    twice that bar, depth within the bar; AutoSpeed's rows equal when the
    card is fed the CPU's pred; AutoSteer's degrees equal."""
    from autoware_vision_pilot_tpu_torch.inference import AutoSpeedInfer, AutoSteerInfer

    no_tf32()
    frame = frames(1, FRAME_HW, SEED + 20)[0]
    for name, cls in seg_wrappers().items():
        cpu = cls(dtype=torch.float32, device="cpu")
        ref_logits, ref = cpu.logits(frame), cpu._fwd(frame)
        del cpu
        gpu = cls(dtype=torch.float32)
        logits, out = gpu.logits(frame.cuda()), gpu._fwd(frame.cuda())
        del gpu
        err, tol = held(f"{name} logits", logits, ref_logits)
        if name == "EgoLanes":
            ref, out = ref[1], out[1]  # the thresholded masks (the raw logits held above)
        if name == "Scene3D":
            # the min-max scaling divides the logits' error by their range
            span = (ref_logits.max() - ref_logits.min()).item()
            derr, dtol = held("Scene3D depth01", out, ref, rel=2 * tol / span)
            note = f"depth01 max_abs_err {derr!r} (tol {dtol!r}: twice the logits' over their range)"
        else:
            share = decided_equal(name, out, ref, ref_logits, 2 * tol)
            note = (f"mask equal on the {share!r} of values the CPU's logits decide by more "
                    f"than {2 * tol!r}; overall agreement "
                    f"{(out.cpu() == ref).float().mean().item()!r}")
        print(f"f32 {name}Infer, card vs CPU, {FRAME_HW[0]}x{FRAME_HW[1]} frame: logits "
              f"{tuple(ref_logits.shape)} max_abs_err {err!r} (tol {tol!r}); {note}")
        torch.cuda.empty_cache()

    cpu, gpu = (AutoSpeedInfer(dtype=torch.float32, device=d) for d in ("cpu", "cuda"))
    seen = {}
    hooks = [cpu.model.register_forward_hook(lambda m, a, y: seen.__setitem__("cpu", y)),
             gpu.model.register_forward_hook(lambda m, a, y: seen.__setitem__("card", y))]
    ref = cpu._fwd(frame)
    out = gpu._fwd(frame.cuda())
    err, tol = held("AutoSpeed pred", seen["card"], seen["cpu"])
    hooks[1].remove()
    gpu.model.register_forward_hook(lambda m, a, y: seen["cpu"].cuda())
    fed = gpu._fwd(frame.cuda())
    for a, b, what in zip(fed, ref, ("boxes", "scores", "classes", "valid")):
        if not torch.equal(a.cpu(), b):
            raise AssertionError(f"AutoSpeedInfer {what}: fed the CPU's pred, card and CPU differ")
    rows = gpu.inference(frames(1, FRAME_HW, SEED + 20)[0].numpy())
    print(f"f32 AutoSpeedInfer (letterbox 640x640, AutoSpeed n, conf 0.25, IoU 0.45), card vs "
          f"CPU: pred max_abs_err {err!r} (tol {tol!r}); fed the CPU's pred, boxes, scores, "
          f"classes and valid equal ({int(ref[3].sum())} kept); inference() -> {rows.shape} "
          f"rows")
    del cpu, gpu

    rng = np.random.default_rng(SEED + 21)
    prev, curr = (rng.standard_normal((80, 160, 3)).astype(np.float32) * 4 for _ in range(2))
    cpu, gpu = (AutoSteerInfer(dtype=torch.float32, device=d) for d in ("cpu", "cuda"))
    stacked = torch.from_numpy(np.concatenate([prev, curr], -1))
    with torch.no_grad():
        x = stacked.permute(2, 0, 1)[None].contiguous(memory_format=CL)
        lc, lg = cpu.model(x)[1], gpu.model(x.cuda())[1]
    err, tol = held("AutoSteer logits", lg, lc)
    d_cpu, d_card = cpu.inference(prev, curr), gpu.inference(prev, curr)
    margin = lc.topk(2).values[0]
    if float(margin[0] - margin[1]) > 2 * tol and d_cpu != d_card:
        raise AssertionError(f"AutoSteerInfer: {d_card} degrees on the card, {d_cpu} on the CPU")
    print(f"f32 AutoSteerInfer, card vs CPU: logits max_abs_err {err!r} (tol {tol!r}); "
          f"steering {d_card!r} vs {d_cpu!r} degrees")
    del cpu, gpu
    torch.cuda.empty_cache()


NO_KERNELS = {"fused_preprocess": 0, "fused_letterbox": 0, "nms_greedy": 0,
              "lane_filter_walk": 0, "int8_quantize": 0, "int8_conv": 0}


def time_calls(fn, pool, expected, label, card):
    """fn(pool[i]) for every i, the counts set to 0 just before and read
    just after: CUDA events per call, host enqueue per call; checks the
    launches against ``expected`` (per call; NO_KERNELS for the rest).
    -> (p50, p99, enqueue p50 ms, the counts, the outputs)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    latencies, enqueue, outs = [], [], []
    torch.cuda.synchronize()
    reset_counts()  # count only this path's launches
    for i in range(len(pool)):
        start.record()
        t0 = time.perf_counter()
        out = fn(pool[i])
        enqueue.append(time.perf_counter() - t0)
        end.record()
        end.synchronize()
        latencies.append(start.elapsed_time(end))
        outs.append(out)
    counts = read_counts()
    expect_launches(counts, {k: v * len(pool) for k, v in (NO_KERNELS | expected).items()})
    p50, p99 = percentiles(latencies[WARM:])
    enq = 1e3 * float(np.median(enqueue[WARM:]))
    print(f"{label}, {card}: p50 {p50!r} ms, p99 {p99!r} ms over {len(pool) - WARM} distinct "
          f"inputs after {WARM} warm-up (CUDA events a call); host enqueue p50 {enq!r} ms; "
          f"launches {counts}")
    return p50, p99, enq, counts, outs


def check_finite(name, outs):
    for i, out in enumerate(outs):
        for t in (out if isinstance(out, tuple) else (out,)):
            if not torch.isfinite(t.float()).all():
                raise AssertionError(f"{name}, input {i}: non-finite output")


def phase_wrappers_bf16(card):
    """Phase 20: each wrapper's ``_fwd`` in bf16 on WARM + TIMED distinct
    720p frames held on the card (AutoSteer: distinct (80, 160, 6) logit
    stacks): p50/p99 from CUDA events, host enqueue, one preprocess launch
    a frame (AutoSpeed: one letterbox and one NMS launch). -> the
    launches."""
    from autoware_vision_pilot_tpu_torch.inference import AutoSpeedInfer, AutoSteerInfer

    n = WARM + TIMED
    pool = frames(n, FRAME_HW, SEED + 22).cuda()
    launches = dict.fromkeys(("fused_preprocess", "fused_letterbox", "nms_greedy"), 0)
    shapes = {"SceneSeg": (OUT_HW, torch.int32), "Scene3D": (OUT_HW, torch.float32),
              "DomainSeg": (OUT_HW, torch.bool)}
    for name, cls in seg_wrappers().items():
        w = cls(dtype=torch.bfloat16)
        *_, counts, outs = time_calls(w._fwd, pool, {"fused_preprocess": 1},
                                      f"bf16 {name}Infer._fwd, 720p -> 320x640", card)
        check_finite(name, outs)
        got = outs[-1][1] if name == "EgoLanes" else outs[-1]
        want = (((OUT_HW[0] // 4, OUT_HW[1] // 4, 3), torch.float32) if name == "EgoLanes"
                else shapes[name])
        if (tuple(got.shape), got.dtype) != (tuple(want[0]), want[1]):
            raise AssertionError(f"{name}: {tuple(got.shape)} {got.dtype}, expected {want}")
        launches["fused_preprocess"] += counts["fused_preprocess"]
        del w, outs
    w = AutoSpeedInfer(dtype=torch.bfloat16)
    *_, counts, outs = time_calls(w._fwd, pool, {"fused_letterbox": 1, "nms_greedy": 1},
                                  "bf16 AutoSpeedInfer._fwd, 720p -> letterbox 640x640 -> "
                                  "AutoSpeed n -> NMS (conf 0.25, IoU 0.45)", card)
    check_finite("AutoSpeed", outs)
    for k in ("fused_letterbox", "nms_greedy"):
        launches[k] += counts[k]
    del w, outs
    w = AutoSteerInfer(dtype=torch.bfloat16)
    g = torch.Generator().manual_seed(SEED + 23)
    stacks = (torch.randn(n, 80, 160, 6, generator=g) * 4).cuda()
    *_, _, outs = time_calls(w._fwd, stacks, {}, "bf16 AutoSteerInfer._fwd, two "
                             "80x160x3 logit maps -> degrees", card)
    if not all(-30 <= float(d) <= 30 for d in outs):
        raise AssertionError("AutoSteerInfer: degrees outside -30..30")
    del w, pool, stacks
    torch.cuda.empty_cache()
    return launches


def wrapper_int8_convs(model):
    from autoware_vision_pilot_tpu_torch.nn.layers import Int8Conv2d
    return [m for m in model.modules() if isinstance(m, Int8Conv2d)]


def check_int8_convs(name, model, run, count, new_shapes=None):
    """run() once (one int8 frame); a hook on each Int8Conv2d of ``model``
    holds the kernels' output against the plain versions on the same input
    (torch.equal). There must be ``count`` int8 convs. -> the (window,
    cin, cout, h, w) of each conv, in call order."""
    from autoware_vision_pilot_tpu_torch.ops.kernels.int8_conv import int8_conv2d

    new_shapes = MIN128_INT8 if new_shapes is None else new_shapes
    checked, bad = [], []

    def hook(m, args, y):
        if m.input_scale is None:
            raise AssertionError(f"an int8 conv of {name} has no static scale")
        x = args[0].contiguous(memory_format=CL)
        ref = int8_conv2d(x, m.weight, m.weight_scale, m.input_scale, m.bias, m.padding,
                          plain=True)
        checked.append((m.weight.shape[-1], m.weight.shape[1], m.weight.shape[0],
                        *x.shape[2:]))
        if not torch.equal(y, ref):
            bad.append((checked[-1], (y.float() - ref.float()).abs().max().item()))

    handles = [m.register_forward_hook(hook) for m in wrapper_int8_convs(model)]
    try:
        run()
        torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    new = sorted({s for s in checked if s in {t[:5] for t in new_shapes}})
    print(f"int8 {name}, conv by conv: {len(checked)} int8 convs held against their plain "
          f"versions on the frame's own input, {len(checked) - len(bad)} bit-equal "
          f"(torch.equal), of them at the new shapes: {new}"
          + (f"; differ: {bad[:8]}" if bad else ""))
    if len(checked) != count or bad:
        raise AssertionError(f"{name}: int8 convs disagree with their plain versions")
    return checked


def phase_int8_wrappers(card):
    """Phase 21: SceneSeg, Scene3D, DomainSeg and EgoLanes with
    precision="int8" at int8_min_channels 128 (bf16, calibrated on the four
    noise batches): the int8 convs by route, each frame's launches, every
    int8 conv of one frame bit-equal to its plain version, p50/p99 over
    TIMED distinct frames. -> the launches."""
    from autoware_vision_pilot_tpu_torch.export.quantize import int8_conv_count

    n = WARM + TIMED
    pool = frames(n, FRAME_HW, SEED + 24).cuda()
    keys = ("fused_preprocess", "int8_quantize", "int8_conv_wgmma", "int8_conv_pointwise",
            "int8_conv_dot", "int8_conv_mma")
    launches = dict.fromkeys(keys, 0)
    for name, cls in seg_wrappers().items():
        t0 = time.perf_counter()
        w = cls(dtype=torch.bfloat16, precision="int8")
        torch.cuda.synchronize()
        routes = WRAPPER_INT8[name]
        convs = int8_conv_count(w.model)
        print(f"int8 {name}Infer build (quantize at min_channels 128, calibrate on 4 noise "
              f"batches): {time.perf_counter() - t0:.1f} s, {convs} int8 convs")
        if convs != sum(routes.values()):
            raise AssertionError(f"{name}: {convs} int8 convs, expected {routes}")
        expected = {"fused_preprocess": 1, "int8_conv": convs,
                    "int8_quantize": routes["wgmma"] + routes["splitk"],
                    "int8_conv_wgmma": routes["wgmma"] + routes["splitk"],
                    "int8_conv_splitk": routes["splitk"], "int8_conv_pointwise":
                    routes["pointwise"], "int8_conv_dot": routes["dot"], "int8_conv_mma": 0}
        *_, counts, outs = time_calls(w._fwd, pool, expected,
                                      f"int8 {name}Infer._fwd (min_channels 128; per frame "
                                      f"{routes})", card)
        check_finite(name, outs)
        for k in keys:
            launches[k] += counts[k]
        check_int8_convs(name, w.model, lambda: w._fwd(pool[0]), sum(routes.values()))
        del w, outs
        torch.cuda.empty_cache()
    del pool
    return launches


def phase_min128_shapes(card):
    """Phase 22: the int8 conv shapes that min_channels 128 brings
    (MIN128_SHAPES), each at its full size bit-equal to the plain versions
    on every variant, then timed with its bound and the cuDNN and _int_mm
    yardsticks. -> worst error by kernel."""
    g = torch.Generator().manual_seed(SEED + 25)
    worst = check_int8_kernels(g, MIN128_SHAPES)
    time_int8_shapes(g, card, MIN128_INT8, "the min_channels-128 shapes (one frame of each "
                                           "int8 wrapper)")
    return worst


def phase_backend():
    """Phase 23: middleware backend_from_params for each family, chosen by
    the file stem (no file at the path: weights from seed 0), bf16: its
    do_inference output equals the matching wrapper's raw forward (the same
    weights) bit for bit. -> the preprocess launches."""
    from autoware_vision_pilot_tpu_torch.middleware import backend_from_params

    frame = frames(1, FRAME_HW, SEED + 26)[0]
    launches = 0
    for (name, cls), stem in zip(seg_wrappers().items(),
                                 ("scene_seg", "scene_3d", "domain_seg", "ego_lanes")):
        b = backend_from_params({"model_path": f"/no/such/dir/{stem}.msgpack",
                                 "precision": "bf16"})
        w = cls(dtype=torch.bfloat16)
        reset_counts()
        got = b.do_inference(frame.numpy())
        want = w.logits(frame.cuda())[0].float().cpu().numpy()
        counts = read_counts()
        expect_launches(counts, NO_KERNELS | {"fused_preprocess": 2})
        launches += counts["fused_preprocess"]
        if type(b.model) is not type(w.model) or got.shape != want.shape or \
                not np.array_equal(got, want):
            raise AssertionError(f"backend_from_params({stem}) differs from {name}Infer")
        print(f"backend_from_params {stem}.msgpack (bf16): {type(b.model).__name__}, "
              f"do_inference {got.shape} f32 equal to {name}Infer's raw forward "
              f"(np.array_equal)")
        del b, w
    torch.cuda.empty_cache()
    return launches


def phase_clip(card):
    """Phase 24: BASELINE config 3 (bench.py::bench_clip): EgoLanes +
    DomainSeg in bf16 on windows of CLIP_BATCH frames sliding by one
    through a 720p clip held on the card, every window distinct: the
    preprocess kernel at batch 10 bit-equal to its plain version, then
    window p50/p99 (CUDA events) and clip frames a second. -> the
    preprocess launches."""
    from autoware_vision_pilot_tpu_torch.ops.kernels.preprocess_kernel import fused_preprocess
    from autoware_vision_pilot_tpu_torch.ops.postprocess import threshold_channels
    from autoware_vision_pilot_tpu_torch.ops.preprocess import preprocess_imagenet

    n = WARM + TIMED
    clip = frames(n + CLIP_BATCH - 1, FRAME_HW, SEED + 27).cuda()
    lanes = seg_wrappers()["EgoLanes"](dtype=torch.bfloat16).model
    domain = seg_wrappers()["DomainSeg"](dtype=torch.bfloat16).model
    window = clip[3:3 + CLIP_BATCH]
    x = fused_preprocess(window, OUT_HW, torch.bfloat16)
    ref = preprocess_imagenet(window, OUT_HW, torch.bfloat16).permute(0, 3, 1, 2)
    if not torch.equal(x, ref):
        raise AssertionError("the preprocess kernel at batch 10 differs from its plain version")
    print(f"clip: fused_preprocess on a window of {CLIP_BATCH} 720p frames -> "
          f"{tuple(x.shape)} bf16 equal to its plain version (torch.equal)")

    @torch.inference_mode()
    def step(j):
        x = fused_preprocess(clip[j:j + CLIP_BATCH], OUT_HW, torch.bfloat16)
        masks = threshold_channels(lanes(x).permute(0, 2, 3, 1).float())
        return masks, domain(x).float() > 0

    p50, p99, _, counts, outs = time_calls(
        step, list(range(n)), {"fused_preprocess": 1},
        f"bf16 clip window (EgoLanes + DomainSeg, batch {CLIP_BATCH}, sliding by one through "
        f"a {len(clip)}-frame 720p clip on the card)", card)
    masks, dom = outs[-1]
    if tuple(masks.shape) != (CLIP_BATCH, OUT_HW[0] // 4, OUT_HW[1] // 4, 3) or \
            tuple(dom.shape) != (CLIP_BATCH, 1, *OUT_HW):
        raise AssertionError(f"clip outputs {tuple(masks.shape)}, {tuple(dom.shape)}")
    check_finite("clip", outs)
    # the clip as a stream: the timed windows queued back to back, one wait
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for j in range(WARM, n):
        step(j)
    torch.cuda.synchronize()
    fps = CLIP_BATCH * (n - WARM) / (time.perf_counter() - t0)
    print(f"bf16 clip, {card}: {fps!r} clip frames/s over windows {WARM}-{n - 1} queued back "
          f"to back (host clock, one wait at the end); window p50 {p50!r} ms, p99 {p99!r} ms "
          f"(each window waited for)")
    del clip, lanes, domain, outs
    torch.cuda.empty_cache()
    return counts["fused_preprocess"]


def phase_steer2_drive(card):
    """Phase 25: AutoSteer 2.0 and AutoDrive at 512x1024 (AutoDrive on two
    frames) and the legacy EgoPath heads (BEVPathContext at 10x20, the
    AutoSteerHead on a 10x20 context and a 40x80 neck), seed 0: f32 on the
    card, TF32 off, against the CPU within 1e-3 * max|CPU|; then bf16
    p50/p99 over TIMED distinct inputs."""
    from autoware_vision_pilot_tpu_torch.models.auto_drive import AutoDriveNetwork
    from autoware_vision_pilot_tpu_torch.models.auto_steer import AutoSteerNetwork
    from autoware_vision_pilot_tpu_torch.models.ego_path import AutoSteerHead, BEVPathContext
    from autoware_vision_pilot_tpu_torch.nn.layers import init_seeded

    no_tf32()
    h, w = STEER2_HW
    nets = {"AutoSteer 2.0": (lambda: AutoSteerNetwork("n", h, w), [(1, 3, h, w)]),
            "AutoDrive": (lambda: AutoDriveNetwork(h, w), [(1, 3, h, w), (1, 3, h, w)]),
            "BEVPathContext": (lambda: BEVPathContext(), [(1, 1456, 10, 20)]),
            "AutoSteerHead": (lambda: AutoSteerHead(256, 10, 20),
                              [(1, 256, 10, 20), (1, 256, 40, 80), (1, 64, 10, 20)])}
    g = torch.Generator().manual_seed(SEED + 28)
    for name, (build, shapes) in nets.items():
        net = build()
        init_seeded(net, torch.Generator().manual_seed(SEED))
        net.eval()
        xs = [torch.randn(s, generator=g).contiguous(memory_format=CL) for s in shapes]
        with torch.no_grad():
            ref = net(*xs)
            net.to("cuda", memory_format=CL)
            out = net(*[x.cuda() for x in xs])
        out, ref = (y if isinstance(y, tuple) else (y,) for y in (out, ref))
        errs = [held(f"{name} output {i}", a, b) for i, (a, b) in enumerate(zip(out, ref))]
        print(f"f32 {name}, card vs CPU: outputs {[tuple(t.shape) for t in ref]}, max_abs_err "
              f"(tol) {[(e, t) for e, t in errs]}")
        net.to(torch.bfloat16)
        n = WARM + TIMED
        pool = [[torch.randn(s, generator=g).to(torch.bfloat16).contiguous(
            memory_format=CL).cuda() for s in shapes] for _ in range(n)]
        with torch.no_grad():
            p50, p99, enq, _, outs = time_calls(lambda xs: net(*xs), pool, {},
                                                f"bf16 {name}, inputs {shapes}", card)
        check_finite(name, outs)
        del net, pool, outs
        torch.cuda.empty_cache()


# ---------- the Lite family (models/lite, export/eval_lite.py) ----------

LITE_NETS = ("SceneSegLite", "Scene3DLite", "EgoLanesLite", "UNet++")
# phase 26's input where the CPU reference at 320x640 would take too long
# (UNet++: ~0.7 TFLOP a frame)
LITE_F32_HW = {"UNet++": (96, 192)}
# int8 convs a 320x640 frame by route at eval_lite's --int8-min-ch 128
# (tests/test_torch_lite_int8.py holds the selection against JAX's)
LITE_INT8 = {"SceneSegLite": {"wgmma": 1, "splitk": 0, "pointwise": 24, "dot": 15},
             "Scene3DLite": {"wgmma": 0, "splitk": 0, "pointwise": 23, "dot": 15},
             "EgoLanesLite": {"wgmma": 0, "splitk": 0, "pointwise": 23, "dot": 15},
             "UNet++": {"wgmma": 13, "splitk": 3, "pointwise": 18, "dot": 14}}
# (window, cin, cout, h, w, batch, route): UNet++'s 3x3 convs whose C is not
# a multiple of 128 (the last 128-channel K step partial; C % 16 = 8 is
# padded to 16 by int8_conv), at 320x640, checked bit for bit in every variant
LITE_SHAPES = (
    (3, 136, 64, 40, 80, 1, "splitk"),     # x_2_2_a, C padded to 144
    (3, 152, 64, 40, 80, 1, "splitk"),     # x_2_1_a, C padded to 160
    (3, 216, 128, 80, 160, 1, "wgmma"),    # x_1_2_a, C padded to 224
    (3, 344, 128, 80, 160, 1, "wgmma"),    # x_1_3_a, C padded to 352
    (3, 416, 256, 160, 320, 1, "wgmma"),   # x_0_2_a
    (3, 432, 32, 20, 40, 1, "splitk"),     # x_3_1_a
    (3, 672, 256, 160, 320, 1, "wgmma"),   # x_0_3_a
    (3, 928, 256, 160, 320, 1, "wgmma"),   # x_0_4_a, K = 8,352
)
# (window, cin, cout, h, w, convs): every int8 conv shape of the Lite nets
# at 320x640 that no earlier path ran, with its count over one frame of
# each of the four nets (59 convs)
LITE_INT8_SHAPES = tuple((*s[:5], 1) for s in LITE_SHAPES) + (
    (3, 128, 128, 80, 160, 3),    # UNet++ x_1_{1,2,3}_b
    (3, 256, 3, 160, 320, 1),     # UNet++ head, N = 3 on 400 tiles
    (3, 256, 3, 80, 160, 1),      # SceneSegLite head
    (1, 304, 256, 80, 160, 1),    # SceneSegLite fuse.pw (decoder 256 + 48)
    (1, 1280, 256, 20, 40, 1),    # SceneSegLite aspp.proj
    (1, 320, 256, 20, 40, 4),     # SceneSegLite aspp.b0 and b1-b3.pw, stride 16
    (1, 320, 64, 20, 40, 10),     # Scene3DLite, EgoLanesLite: the same and proj
    (1, 320, 256, 1, 1, 1),       # SceneSegLite aspp.pool, M = 1
    (1, 320, 64, 1, 1, 2),        # Scene3DLite, EgoLanesLite aspp.pool
    (1, 192, 1152, 20, 40, 12),   # stage-6/7 expand, dilated (stride 16)
    (1, 672, 192, 20, 40, 3),     # stage-5 -> 6 project, dilated
    (1, 1152, 192, 20, 40, 9),    # stage-6 project, dilated
    (1, 1152, 320, 20, 40, 3),    # stage-7 project, dilated
)


def lite_config(name):
    """configs/<name>.yaml; UNet++: SceneSegLite's with model unetplusplus."""
    from autoware_vision_pilot_tpu_torch.train.lite_trainer import load_experiment_config
    cfg = load_experiment_config(REPO / "configs" / (
        "SceneSegLite.yaml" if name == "UNet++" else f"{name}.yaml"))
    if name == "UNet++":
        cfg["network"]["model"] = "unetplusplus"
    return cfg


def lite_net(name, device, dtype):
    """The Lite net ``name`` at full width and depth, weights from seed 0,
    on ``device`` in ``dtype`` (eval_lite's smoke mode)."""
    from autoware_vision_pilot_tpu_torch.inference.infer import load_weights
    from autoware_vision_pilot_tpu_torch.models.lite import build_lite_model
    return load_weights(build_lite_model(lite_config(name)), device=device, dtype=dtype)


def phase_lite_f32():
    """Phase 26: DeepLabV3+ on each of the three Lite configs at 320x640 and
    UNet++ at 96x192 (LITE_F32_HW), full width and depth, seed 0, eval_lite's
    forward on one uint8 frame: f32 on the card with TF32 off against the
    CPU. The head conv's logits within 1e-3 * max|CPU| (phase 19's bar);
    the output (bilinear upsampling does not grow the error) within the
    same bar on its own range, or for a sigmoid head within a quarter of
    the logits' bar (the sigmoid's largest slope)."""
    from autoware_vision_pilot_tpu_torch.export.eval_lite import forward_fn

    no_tf32()
    for name in LITE_NETS:
        hw = LITE_F32_HW.get(name, OUT_HW)
        frame = frames(1, hw, SEED + 29)
        logits, outs = [], []
        for device, x in (("cpu", frame), ("cuda", frame.cuda())):
            net = lite_net(name, device, torch.float32)
            net.head.register_forward_hook(lambda m, a, y: logits.append(y))
            outs.append(forward_fn(net, torch.float32)(x))
        err, tol = held(f"{name} f32 logits", logits[1], logits[0])
        sigmoid = lite_config(name)["network"].get("head", {}).get("head_activation")
        rel = tol / 4 / outs[0].abs().max().item() if sigmoid == "sigmoid" else 1e-3
        out_err, out_tol = held(f"{name} f32 output", outs[1], outs[0], rel)
        print(f"f32 {name}, card vs CPU, {hw[0]}x{hw[1]} uint8 frame"
              + (" (not 320x640: the CPU reference's cost)" if name in LITE_F32_HW else "")
              + f": head logits {tuple(logits[0].shape)} max_abs_err {err!r} (tol {tol!r}, "
              f"{err / tol!r} of it); output {tuple(outs[0].shape)} max_abs_err {out_err!r} "
              f"(tol {out_tol!r}" + (", a quarter of the logits' bar: sigmoid" if sigmoid
                                     == "sigmoid" else "") + ")")
        torch.cuda.empty_cache()


def phase_lite(card):
    """Phase 27: each Lite net at 320x640, seed 0, eval_lite's forward on
    WARM + TIMED distinct uint8 frames on the card: bf16 p50/p99, no kernel
    of the port launched; then int8 at min_channels 128 (quantized from the
    bf16 weights, calibrated on eval_lite's four noise batches): the int8
    convs by route and each frame's launches, p50/p99, every int8 conv of
    one frame bit-equal to its plain version; then UNet++'s 3x3 shapes with
    C % 128 != 0 bit-equal to the plain versions on every variant of
    phase 4, and every new int8 shape timed as phase 4 times its shapes.
    -> (the int8 launches, worst error by kernel)."""
    from autoware_vision_pilot_tpu_torch.export.eval_lite import (calibration_batches,
                                                                  forward_fn)
    from autoware_vision_pilot_tpu_torch.export.quantize import (
        calibrate_int8_activation_scales, int8_conv_count, quantize_for_int8_conv)

    n = WARM + TIMED
    pool = frames(n, OUT_HW, SEED + 30).cuda()[:, None]  # (n, 1, 320, 640, 3)
    keys = ("int8_quantize", "int8_conv_wgmma", "int8_conv_pointwise", "int8_conv_dot")
    launches = dict.fromkeys(keys, 0)
    for name in LITE_NETS:
        net = lite_net(name, "cuda", torch.bfloat16)
        fwd = forward_fn(net, torch.bfloat16)
        *_, outs = time_calls(fwd, pool, {}, f"bf16 {name}, 320x640 uint8 frame -> "
                              "normalize -> net (eval_lite's forward)", card)
        check_finite(name, outs)
        shape = tuple(outs[-1].shape)
        t0 = time.perf_counter()
        quantize_for_int8_conv(net, 128)
        calibrate_int8_activation_scales(net, calibration_batches(OUT_HW, "cuda",
                                                                  torch.bfloat16))
        torch.cuda.synchronize()
        routes = LITE_INT8[name]
        convs = int8_conv_count(net)
        print(f"int8 {name} build (quantize at min_channels 128, calibrate on 4 noise "
              f"batches of 2): {time.perf_counter() - t0:.1f} s, {convs} int8 convs")
        if convs != sum(routes.values()):
            raise AssertionError(f"{name}: {convs} int8 convs, expected {routes}")
        three = routes["wgmma"] + routes["splitk"]
        expected = {"int8_conv": convs, "int8_quantize": three, "int8_conv_wgmma": three,
                    "int8_conv_splitk": routes["splitk"],
                    "int8_conv_pointwise": routes["pointwise"], "int8_conv_dot": routes["dot"],
                    "int8_conv_mma": 0}
        *_, counts, outs = time_calls(fwd, pool, expected, f"int8 {name} (min_channels 128; "
                                      f"per frame {routes})", card)
        check_finite(name, outs)
        if tuple(outs[-1].shape) != shape:
            raise AssertionError(f"{name}: int8 output {tuple(outs[-1].shape)}, bf16 {shape}")
        for k in keys:
            launches[k] += counts[k]
        check_int8_convs(name, net, lambda: fwd(pool[0]), convs, LITE_INT8_SHAPES)
        del net, outs
        torch.cuda.empty_cache()
    del pool
    g = torch.Generator().manual_seed(SEED + 31)
    worst = check_int8_kernels(g, LITE_SHAPES)
    time_int8_shapes(g, card, LITE_INT8_SHAPES, "the Lite nets' new shapes (one frame of each "
                                                "net)")
    return launches, worst


def phase_lite_cli(card):
    """Phase 28: the CLI, export/eval_lite.py::main on SceneSegLite at
    320x640, --synthetic 4 --bench, in bf16 and with --int8, the counts set
    to 0 just before each and read just after: no kernel launch in bf16,
    and in int8 each int8 conv once a frame (4 calibration batches, 4
    samples, WARM + 120 timed frames). -> the int8 launches."""
    from autoware_vision_pilot_tpu_torch.export import eval_lite

    config = str(REPO / "configs" / "SceneSegLite.yaml")
    routes = LITE_INT8["SceneSegLite"]
    calls = 4 + 4 + eval_lite.WARM + 120
    three = routes["wgmma"] + routes["splitk"]
    expected = {"int8_conv": sum(routes.values()), "int8_quantize": three,
                "int8_conv_wgmma": three, "int8_conv_splitk": routes["splitk"],
                "int8_conv_pointwise": routes["pointwise"], "int8_conv_dot": routes["dot"],
                "int8_conv_mma": 0}
    for extra in ([], ["--int8"]):
        torch.cuda.synchronize()
        reset_counts()
        summary = eval_lite.main(["--config", config, "--synthetic", "4", "--bench",
                                  "--dtype", "bf16", *extra])
        counts = read_counts()
        expect_launches(counts, NO_KERNELS | ({k: v * calls for k, v in expected.items()}
                                              if extra else {}))
        if not (summary["samples"] == 4 and np.isfinite(summary["miou"])
                and summary["device_ms_per_frame"] > 0 and summary["card"] == card):
            raise AssertionError(f"eval_lite {' '.join(extra)}: summary {summary}")
        print(f"eval_lite SceneSegLite bf16 {' '.join(extra)} --synthetic 4 --bench, {card}: "
              f"p50 {summary['device_ms_per_frame']!r} ms, p99 {summary['device_ms_p99']!r} "
              f"ms, {summary['device_fps']!r} frames/s; launches {counts}")
    return {k: counts[k] for k in ("int8_quantize", "int8_conv_wgmma", "int8_conv_pointwise",
                                   "int8_conv_dot")}


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
    # the per-network wrappers (inference/infer.py), the backend and the clip,
    # each phase's wall time kept
    walls = {}

    def timed(phase, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        walls[phase] = round(time.perf_counter() - t0, 1)
        return out

    timed(19, phase_wrappers_f32)
    paths = {"wrappers bf16": timed(20, phase_wrappers_bf16, card),
             "int8 wrappers": timed(21, phase_int8_wrappers, card)}
    for name, worst in timed(22, phase_min128_shapes, card).items():
        records[name]["max_abs_err"] = max(records[name]["max_abs_err"], worst)
    paths["backend"] = {"fused_preprocess": timed(23, phase_backend)}
    paths["clip"] = {"fused_preprocess": timed(24, phase_clip, card)}
    timed(25, phase_steer2_drive, card)
    print(f"wall time of phases 19-25 (s): {walls}, {sum(walls.values()):.1f} s in all")
    # the Lite family (models/lite, export/eval_lite.py)
    walls.clear()
    timed(26, phase_lite_f32)
    paths["Lite nets"], worst = timed(27, phase_lite, card)
    for name, err in worst.items():
        records[name]["max_abs_err"] = max(records[name]["max_abs_err"], err)
    paths["Lite CLI"] = timed(28, phase_lite_cli, card)
    print(f"wall time of phases 26-28 (s): {walls}, {sum(walls.values()):.1f} s in all")
    for path, counts in paths.items():
        for name, n in counts.items():
            if n <= 0 and name != "int8_conv_mma":
                raise AssertionError(f"the {path} never launched {name}")
            launches[name] += n
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
