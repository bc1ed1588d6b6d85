#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py
    python3 chip_smoke.py --parent ROOT       # also time the lane-filter walk,
                                              # NMS, int8 1x1 ("pointwise",
                                              # "dot"), window conv with C <
                                              # 128, transposed conv,
                                              # strided conv and
                                              # letterbox kernels
                                              # of the port in ROOT (an
                                              # earlier commit, from git
                                              # archive) against this tree's:
                                              # parent, this, this, parent;
                                              # the 1x1, halo, d2s, strided
                                              # and letterbox stage splits;
                                              # phase 8's host costs of ROOT's
                                              # package in turns
    python3 chip_smoke.py --host-costs ROOT   # phase 7's host costs alone, of
                                              # the package in ROOT
    python3 chip_smoke.py --echo KIND A B N   # phase 33's second process

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
             int8_conv_plan (wgmma, split-K, halo, pointwise, dot; every
             1x1 conv of the main path, a ragged N, a batch of two), bf16
             and f32 outputs, scalar and per-channel scales, through
             int8_conv on the int8 input and int8_conv2d on the float one:
             quantized values, int32 accumulators and outputs bit-equal;
             the pointwise route on plans forced at every N tile, both M
             tiles and cluster sizes 1-8, and the dot route at M = 1-8, on
             int8, bf16 and f32 inputs (check_pointwise_variants). With
             --parent, the parent's 1x1 kernels against this tree's at
             PARENT_1X1 in turns, and both stage splits at SPLIT_1X1.
             Then every one of the 24 distinct int8 conv shapes of the main
             path, bf16 with a scalar scale, timed over rotating inputs
             that together exceed the 50 MB L2: profiler device time of the
             conv and the quantize (and of the conv with one block per unit
             of work in place of the persistent blocks; at a 1x1 conv, of
             int8_conv2d, which absorbs the quantize), the bound, the share
             of the bound, and two yardsticks that the port never calls: the
             bf16 cuDNN conv of the same shape and torch._int_mm on a
             pre-built im2col matrix; then the same for the halo route's
             shapes (HALO_TIMED: the QAT export's 64 -> 3 3x3 at 320x640, and
             64 -> 96 at 20x40). With --parent, the parent's transposed conv
             and mma.sync conv against this tree's d2s and halo kernels in
             turns (PARENT_D2S, PARENT_HALO), and the new kernels' stage
             splits from a build with -DAVP_HALO_STAMPS -DAVP_D2S_STAMPS;
             the parent's strided route (called through its own C entry
             point) against this tree's at STRIDED_TIMED in turns, each
             call's device time by kernel, and both stage splits at
             STRIDED_SPLIT (the parent's from a stamped copy, this tree's
             csrc/int8_conv_strided.cu built with -DAVP_STRIDED_STAMPS).
             A parent that calls its int8 kernels as avp operators has its
             1x1, halo, d2s and letterbox turns skipped (they cannot be
             bound to its own library).
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
             halo) and 30 quantize launches (the 1x1 convs quantize as
             they load); on one
             frame, each of the 72 int8 convs against its plain version on
             the same input (torch.equal); device time per frame by kind of
             kernel and route over 20 frames (torch.profiler), and the wgmma kernel's
             at each 3x3 int8 conv of the frame; host time per conv call
             at the 72 int8 layers, int8 against bf16, with both paths'
             frame latency p50 from the same rounds (with --parent, then
             the parent's package, this tree's, this tree's and the
             parent's, each the same measurement in a fresh process); then a
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
 11. letterbox: the letterbox kernel (csrc/letterbox.cu) against its plain
             version (ops/preprocess.py::letterbox), bit-equal in f32 and
             bf16, at 720x1280 -> 640x640, 375x1242 -> 640x640 and 360x640
             -> 181x333 (pad columns, a width that is not a multiple of 8),
             then on frames 1, 5 and 15 bytes past 16 at the first two sizes
             (one frame, and three frame_stride = H W 3 + 7 bytes apart);
             its time at each size (each time says whether the profiler or
             queued CUDA events read it), bound at 720p, and the plain
             version's time. With --parent, the parent's letterbox against
             this tree's in turns at 720p N = 1 and 8 and at 375x1242, and
             both stage splits (source rows, lerp, store, pad rows) from
             stamped copies at 720p, N = 1 and 8.
 12. longitudinal f32: the longitudinal program (build_longitudinal_pipeline,
             AutoSpeed "n" at 640x640) in f32 on the card against the CPU,
             same seeded weights, 3 frames: pred within 1e-3 * max|CPU|;
             fed the CPU's pred, the packed (64, 7) table equal.
 13. NMS: the NMS kernel against its plain version (torch.equal on every
             output) on 35 candidate sets: the CPU's head outputs of phase
             12, and random, dense same-class, all-below-threshold, grid
             (more than 64 survivors), tied-score and small (A < 256) scenes,
             class-aware and not; then at k = 1, 31, 32, 33, 255, 256, 257,
             1024, 1025, 1200 and 1248 (the kernel's most), live, all-dead,
             degenerate (clamped, tied) and NaN
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
             the letterbox kernel, the walk and NMS at N = 1, 3 and 8, one
             launch a batch: every stream bit-equal to the plain version
             and to a launch on that stream alone; the time at N = 8 beside
             8 x the time at N = 1.
 16. fleet f32: the batched lateral and longitudinal steps at N = 3 in
             f32 against 3 single-stream pipelines on the card over 3
             ticks: the networks within 1e-3 * max|single|; fed the single
             streams' network outputs, masks, flags and AutoSteer equal,
             lane fits within 5e-3 * max|single|, detection tables equal.
 17. engine: app.py::build_engine(Config()) in bf16 at full width on 60
             distinct 720p host frames, pipeline depth 1 and 2, every
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
 29. int8 transpose kernel: the int8 transposed conv (k == s; the quantize,
             then the wgmma kernel's d2s variant with its depth-to-space
             TMA-store epilogue, csrc/int8_conv_sm90.cu) against its plain
             version at the main path's five shapes, O = 3, 12, 20, C = 200,
             a batch of two and a K split: f32 and bf16 in, f32, bf16 and
             int32 out, static and dynamic scales, bit for bit; the five
             shapes timed over rotating inputs past the L2 (the pair and the
             quantize alone) with the function's and the pair's bounds and
             shares, the plain version, cuDNN's bf16 conv_transpose2d and
             torch._int_mm (yardsticks only).
 30. int8 + transposes: the main path with quantize_for_int8_conv(...,
             256, quantize_transpose=True) on each network: 72 int8 convs
             and 11 transposed convs a frame (41 quantize launches: each
             transpose quantizes first), one frame under sync-debug
             "error", launches by route over WARM + TIMED frames, every int8
             module of one frame bit-equal to its plain version, p50/p99
             beside phase 8's.
 31. QuantizedInference (weight-only PTQ) of SceneSeg at 320x640 on the
             card: equal to the module holding the same dequantized
             weights, within 1e-3 * max|CPU| of the CPU run; bytes stored.
 32. importers: EgoLanes' seeded weights written as ONNX, named and with
             its ConvBN BatchNorms folded, imported into a fresh network on
             the card (equal; within 1e-3 * max); eval_lite --onnx on a
             written SceneSegLite file gives the seeded run's summary.
 33. host IPC: host/shm.py builds libavp_host.so with g++ from host/src (a
             failed build fails the run); the C++ state size equals the
             ctypes struct's; the SHM state (60 seeded updates), 60 seeded
             720p frames through the frame ring and 60 through an
             Iox2Service each make a round trip through a second process
             (``--echo``), byte for byte, p50/p99 in us; 60 CIPO messages
             through Iox2Transport on a pid-named CIPO service, every field
             equal.
 34. node graph: middleware launch_pipeline on an InProcTransport, four
             nodes on one image topic (SceneSeg, Scene3D depth, EgoLanes,
             AutoSpeed "n" at 0.5/0.5; bf16, seed 0), fed by a
             VideoPublisherNode over 60 distinct seeded 720p frames in
             memory: every message equal to the wrapper's result on the
             same frame, 3 preprocess, 1 letterbox and 1 NMS launch a
             frame, each node's p50/p99 from publish to message; then
             PathFinderNode, the steering and longitudinal controller nodes
             on seeded lane points (means equal to path_finder_update with
             a generator of the same seed).
 35. app outputs: app.py::AppOutputs on build_engine(Config()) in bf16 over
             60 distinct 720p frames, every dispatch and sink call under
             sync-debug "error": the SHM state read back after each frame
             equal to its FrameResult, the CSV, Rerun (a no-op without the
             SDK), and where cv2 imports the composite and the MJPG video
             (60 frames of 1280x720 read back); the host-loop p50 with the
             outputs against phase 17's sink-less engine, in four turns of 20
             frames, and the sink's parts.
36. training: (a) one make_seg_train_step step of SceneSeg (full width and
             depth at 128x256, batch 2, AdamW 1e-4) in f32 with TF32 off on
             the card against the CPU, the same weights and dropout masks:
             the loss, the gradients (one bar, 1e-3 * the largest CPU
             gradient) and the BatchNorm statistics after the step within
             1e-3 * max|CPU|; (b) tools/bench_train.py's configuration,
             SceneSeg at 320x640, batch 16, bf16 autocast over f32 weights:
             step p50/p99 (CUDA events), samples/s, host enqueue, peak
             memory, a finite loss, then with EMA and with EMA and
             microbatches 2 (phase 43's bench_train runs microbatches 2
             alone); (c) LegacySegTrainer with
             qat=True, qat_min_channels 32 at 320x640 for two steps, the
             observers' scales, int8_variables_from_qat, the int8 net on the
             card: launches by route (halo among them), every int8 conv
             bit-equal to its plain version, the float and int8 nets through
             save_msgpack / load_msgpack bit-equal.
37. trainers: (a) one DetectionTrainer step of AutoSpeed "n" at 128x256,
             batch 2 (YoloBatcher batches of seeded synthetic samples), f32
             with TF32 off, on the card against the CPU: the loss, the
             gradients under one bar and the BatchNorm statistics; (b) the
             detection trainer as configs/auto_speed.yaml sets it (AutoSpeed
             "n", 512x1024, batch 16, max_boxes 64, mosaic 1.0, mixup 0.15,
             lr 1e-3, warm-up 500, EMA 0.9999, clip 10), f32: step p50/p99
             over 10 steps (CUDA events), samples/s, host enqueue, peak
             memory, the batcher's host time a batch; then validate over 2
             batches at max_det 300, conf 0.001, iou 0.65: one NMS launch a
             batch (counted), each bit-equal to the plain version on the
             same candidates (k = 1,200 a stream), and the NMS time at
             k = 1,200; (c) a few steps of the AutoSteer 2.0 and AutoDrive
             trainers at 512x1024, the AutoSteer-temporal trainer at its
             80x160 masks, and the Lite trainer on configs/SceneSegLite.yaml
             as written (DeepLabV3+, its 512x1024 crop, batch 8; the head
             built with the loss's 19 classes): finite losses and step p50.
38. data parallelism and the mesh: (a) 36b's step through
             make_seg_train_step(mesh=...) on the world mesh of an NCCL world
             of one process, in turns with no mesh: step p50/p99 of both
             beside 36b's; (b) a gloo world of 2 processes on cuda:0 (spawned
             by parallel/distributed.py::run_world; NCCL refuses two ranks on
             one card): one f32 step of SceneSeg at full depth, 160x320,
             batch 4, microbatches 2, sgd 0.1, held to the same step in one
             process (loss, every weight and BatchNorm statistic within
             1e-3 * max|ref|), the ranks' states bit-equal, its time (one
             card, two ranks: not a speed figure), started after (a) on a
             thread, its ranks starting while (d) and (c)'s checks run;
             (c) the fleet at N = 8 in
             f32 over [cuda:0] (bit-equal to no mesh) and [cuda:0, cuda:0]
             (two shards of 4) against no mesh at phase 18's bars, then
             FleetEngine in bf16 over the two shards: two preprocess, walk,
             letterbox and NMS launches a tick, tick p50/p99 beside phase
             18's; (d) make_sharded_infer on the clip (batch 10, two shards)
             and make_tp_infer on SceneSeg over (data=1, model=2), both on
             [cuda:0, cuda:0], f32, held to the unsharded forward at 1e-3 *
             max|ref|.
39. data:   write_raw_datasets: 4 seeded samples each of TuSimple
             (label_data.json, 720x1280), CULane (.lines.txt, 590x1640),
             BDD100K (train-id PNGs, 720x1280), Mapillary Vistas v1.2 (id
             PNGs, 1080x1920), KITTI (calib, a 120,000-point velodyne sweep,
             375x1242) and DrivingStereo (16-bit depth PNGs, 400x881); the
             port's parsers (data_parsing/*) write the unified layout;
             check_dataset clean on the two SceneSeg layouts; SceneSegDataset,
             DepthDataset and EgoLanesMaskDataset read back every label equal
             to what the parsers wrote; then 4 steps each of the legacy
             SceneSeg, Scene3D and EgoLanes trainers on what they read
             (full-width nets, 320x640, batch 2, bf16 autocast): finite
             losses, parameters moved, no hand-kernel launch; the parsers'
             host seconds a sample and each trainer's step p50.
40. export: (a) the operator library (csrc/torch_ops.cpp, g++ against
             libtorch, linked to the kernels' library): torch.library.opcheck
             of avp::fused_preprocess, fused_letterbox, lane_filter_walk and
             nms_greedy at the exported steps' shapes, each bit-equal to its
             plain version (phases 1-39 reach the four kernels through these
             operators); (b) export_model in bf16 for SceneSeg, Scene3D,
             DomainSeg, EgoLanes (1, 3, 320, 640), AutoSpeed, AutoSteer and
             AutoDrive (1, 3, 512, 1024), each saved, loaded and held to the
             eager module; export_stablehlo of fused_preprocess -> SceneSeg -> argmax_mask from a 720p frame,
             whose graph calls the operator and whose loaded program launches
             the kernel (profiler); (c) the port's tools/export_native_app.py
             --longitudinal on the card (torch.export + AOTInductor of the
             lateral step, f32, and of AutoSpeed "n" at 640x640), the port's
             C++ loop (host/tools/visionpilot_app.cpp, built by g++ on a
             thread since phase 2) with --golden, --lon and --dump over 16
             state-carried frames against a Python replay of the same
             package, each operator called at least once a frame inside the
             C++ process, then 150 frames published to a pid-named /dev/shm
             segment and republished by the port's StatePublisherBridge; the
             AOTInductor compile seconds and the loop's p50/p99; (d)
             export/benchmark_models.py::compare_precisions on SceneSeg
             (f32, bf16, int8 weight-only PTQ): ms/iter and mIoU vs f32.
41. the int8 path whole (JAX's int8 rule on strided convs, the int8
             kernels as avp operators): (a) the longitudinal step (AutoSpeed
             "n" at 640x640, bf16) quantized at min_channels 128 (28 int8
             convs, 3 of them stride 2) and 32 (58, 5), calibrated on 4
             letterboxed seeded frames: 10 warm-up and 50 distinct 720p
             frames each, launches by route (the strided convs on the
             "strided" route), every int8 conv of a frame bit-equal to its
             plain version, p50/p99 beside the bf16 step's; (b) two QAT steps
             of AutoSteer-temporal, int8_variables_from_qat at min_channels
             32 (4 int8 convs, 3 strided, the QAT's own selection), each conv
             bit-equal to its plain version; (c) the int8 main path (72 int8
             convs) and its variant with the transposed convs quantized (83)
             through export_stablehlo and load_stablehlo: bit-equal to eager
             int8 on 3 frames, each int8 operator called as often a frame as
             the eager frame launches its route; (d) the lateral step with
             EgoLanes quantized at min_channels 256 and calibrated on the
             crop, an AOTInductor package exported in a spawned process beside
             40c's, run by the C++ loop with 40c's longitudinal package:
             golden probe and 16-frame trajectory against the Python replay,
             the int8 operators' calls a frame, then 150 frames, its p50/p99
             beside the f32 loop's. Phase 4 checks the strided route (and a
             launch a group) bit for bit at the YOLO nets' strided shapes, a
             dilated, a grouped and a padding-a-dimension conv, strides
             above 8, an 11x11 window and a dilation of 70, and times the
             strided shapes beside their plans (tiles, cluster, blocks;
             bound, cuDNN bf16 at the stride, torch._int_mm on a pre-built
             im2col).
42. the accuracy tools (autoware_vision_pilot_tpu_torch/tools/) at the JAX
             tools' defaults, each to its bar (phase_accuracy_tools).
43. the bench tools (bench_app_loop, bench_train, bench_fleet, bench_zoo,
             profile_pipeline_stages), each as ``python -m`` at the JAX
             tools' defaults: every JSON line's keys, finite positive
             numbers and the card; no error line; one in-process run of each
             path that launches hand kernels, its launches counted (int8
             routes against their plans); the tools' figures beside phases
             7-8, 17, 18 and 36b of the same call.
Order: the AOTInductor bundles of 40c and 41d compile in spawned processes
while phase 42 (accuracy bars, not times) and 40a, 40b and 41c run; 40c
runs the loop once they are done; phase 43 comes last, on an idle host.
Every Python process the run starts shares a bytecode cache under
build/pycache. The run prints its wall time, and that of phases 1-18,
19-25, 26-28, 29-32, 33-35, 36, 37, 38, 39, 41a-41b, 40 with 41c-41d, 42
and 43.
"""
from __future__ import annotations

import contextlib
import json
import math
import multiprocessing
import os
import pathlib
import shutil
import subprocess
import sys
import threading
import time

REPO = pathlib.Path(__file__).resolve().parent
FRAME_HW = (720, 1280)
if __name__ == "__main__":
    # Python's bytecode cache under build/, for this process and every Python
    # process it starts: where the environment sets PYTHONDONTWRITEBYTECODE and
    # torch ships no __pycache__, each process compiles torch's modules as it
    # imports them (~10 s a process on the card machine)
    sys.pycache_prefix = str(REPO / "build" / "pycache")
    sys.dont_write_bytecode = False
    os.environ["PYTHONPYCACHEPREFIX"] = sys.pycache_prefix
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)


def echo(kind, a, b, n):
    """``chip_smoke.py --echo KIND A B N``, the second process of phase 33:
    opens A as a reader and creates B, says "ready", then writes each of the
    N items it reads from A back into B, unchanged; exits after the N-th.
    It runs before torch is imported (the host library needs only numpy),
    so that it starts in a fraction of a second."""
    sys.path.insert(0, str(REPO))
    from autoware_vision_pilot_tpu_torch.host import frame_ring, iox2, shm

    n = int(n)
    if kind == "state":
        with shm.SharedStateReader(a) as rd, shm.SharedStatePublisher(b) as pub:
            print("ready", flush=True)
            last = 0
            while last < n:
                s = rd.read()
                if s.frame_number != last:
                    pub.publish(s)
                    last = s.frame_number
                os.sched_yield()
    elif kind == "ring":
        with frame_ring.FrameRing(a) as rd, \
                frame_ring.FrameRing(b, owner=True, slot_bytes=FRAME_HW[0] * FRAME_HW[1] * 3) \
                as ring:
            print("ready", flush=True)
            last = 0
            while last < n:
                got = rd.read_latest(last)
                if got is not None:
                    ring.publish(got[0], got[1].frame_number, got[1].timestamp_ns)
                    last = got[1].frame_number
                os.sched_yield()
    else:
        with iox2.Iox2Service(a, iox2.RawFrameStruct, timeout_ms=10000) as sub, \
                iox2.Iox2Service(b, iox2.RawFrameStruct, create=True) as pub:
            print("ready", flush=True)
            for _ in range(n):
                got = None
                while got is None:
                    os.sched_yield()
                    got = iox2.receive_frame(sub)
                iox2.publish_frame(pub, got[0], got[1].frame_id)


if __name__ == "__main__" and sys.argv[1:2] == ["--echo"]:
    sys.exit(echo(*sys.argv[2:6]))

import numpy as np
import torch

# AOTInductor's cache (phase 40) under build/, beside the kernels' build
os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", str(REPO / "build" / "inductor_cache"))
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
BF16_OPS_PER_S = 989e12     # H100 SXM bf16 tensor cores, dense, published
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
    (3, 64, 96, 20, 40, 1, "halo"),        # a 3x3 window with C < 128
    (3, 64, 3, 320, 640, 1, "halo"),       # the QAT export's head, N = 3
    (1, 672, 100, 9, 13, 1, "pointwise"),  # ragged M and N
    (1, 480, 112, 20, 40, 2, "pointwise"),  # a batch of two
    (1, 1152, 48, 1, 1, 2, "dot"),         # a batch of two SE squeezes
    (1, 304, 256, 80, 160, 1, "pointwise"),  # 128-row tiles, no split (a Lite 1x1)
    (1, 144, 24, 80, 160, 1, "pointwise"),   # N = 24 on a 64-wide tile, C % 32 = 16
    (1, 1280, 256, 20, 40, 1, "pointwise"),  # a 256-wide tile, a cluster of 8
    (1, 480, 21, 1, 1, 5, "dot"),          # M = 5, a ragged N
    (1, 1152, 48, 1, 1, 8, "dot"),         # M = 8
)
# (bm, bn, cluster size) forced on the pointwise route by check_pointwise_variants,
# at M = 117, C = 1152, N = 100: every N tile, both M tiles, every cluster size
PW_VARIANTS = tuple((bm, bn, cs) for bn in (64, 128, 192, 256) for bm in (64, 128)
                    for cs in (1, 8)) + tuple((64, 128, cs) for cs in range(2, 8))
CONV_KERNEL = {"wgmma": "int8_conv_wgmma", "splitk": "int8_conv_wgmma", "halo": "int8_conv_halo",
               "pointwise": "int8_conv_pointwise", "dot": "int8_conv_dot",
               "strided": "int8_conv_strided"}
# (kh, kw, cin, cout, h, w, stride, pad, convs a frame on path 41a at
# min_channels 32): the strided int8 convs of the YOLO-family nets at their
# input sizes: AutoSpeed "n" at 640x640 (p3_0, p4_0, p5_0, fpn.h3, fpn.h5;
# at min_channels 128 p4_0, p5_0, fpn.h5), AutoSteer-temporal's c2-c4 (80x160
# masks) and AutoSteer's two 2x1 head convs at stride (2, 1) (512x1024)
STRIDED_TIMED = (
    (3, 3, 64, 64, 160, 160, 2, 1, 1), (3, 3, 128, 128, 80, 80, 2, 1, 1),
    (3, 3, 128, 256, 40, 40, 2, 1, 1), (3, 3, 64, 64, 80, 80, 2, 1, 1),
    (3, 3, 128, 128, 40, 40, 2, 1, 1), (3, 3, 32, 64, 40, 80, 2, 1, 0),
    (3, 3, 64, 128, 20, 40, 2, 1, 0), (3, 3, 128, 128, 10, 20, 2, 1, 0),
    (2, 1, 64, 32, 128, 256, (2, 1), 0, 0), (2, 1, 64, 32, 64, 128, (2, 1), 0, 0),
)
STRIDED_RECORD = (3, 3, 128, 128, 80, 80)  # AutoSpeed's p4_0: the JSON line's shape
# (kh, kw, cin, cout, h, w, stride, pad, dilation, groups) checked bit for
# bit besides STRIDED_TIMED: a dilated conv, a grouped one (a launch a
# group), a padding a dimension, a batch of two, strides above the TMA's
# traversal limit of 8 (one output a tile along them), and the strided
# kernel's other tilings
STRIDED_CHECKED = (
    (3, 3, 256, 200, 30, 50, 1, 2, 2, 1), (3, 3, 128, 64, 19, 23, 2, 1, 1, 4),
    (3, 3, 48, 24, 17, 30, (1, 2), (1, 0), 1, 1), (3, 3, 32, 16, 40, 60, 12, 1, 1, 1),
    (1, 1, 16, 24, 300, 300, (9, 3), 0, 1, 1),
    # an 11x11 window whose weights fill a stage: a K step's phase groups in
    # two units, through a one-stage ring; a dilation whose phase halo would
    # not fit: a box a tap along W
    (11, 11, 32, 64, 48, 48, 2, 5, 1, 1), (1, 3, 16, 8, 20, 150, 1, 0, (1, 70), 1),
)
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
                 "int8_conv_halo": (3, 64, 3, 320, 640),
                 "int8_conv_pointwise": (1, 1152, 320, 10, 20),
                 "int8_conv_dot": (1, 1152, 48, 1, 1)}
# (window, cin, cout, h, w, convs per frame) of the halo route timed in
# phase 4: the QAT export's head (1 a frame on its path) and the 3x3 C < 128
# shape of INT8_SHAPES
HALO_TIMED = ((3, 64, 3, 320, 640, 1), (3, 64, 96, 20, 40, 0))
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


class DeviceUs(float):
    """Microseconds, and how device_us read them (``how``): "profiler" (a
    torch.profiler trace's kernel times) or "q" (CUDA events around calls
    queued back to back, the gaps between them included)."""

    def __new__(cls, us, how):
        value = super().__new__(cls, us)
        value.how = how
        return value


def device_us(fn, inputs):
    """Mean device microseconds per call of fn(x) over ``inputs``: the sum
    of every kernel's own time in a torch.profiler trace of the run. The
    trace is taken only when it holds a device record for each launch the
    host made in it (the runtime's launch, copy and set calls), else it is
    taken again, up to five times, and then the calls are timed queued
    (queued_us). A trace can drop device records: from phase 10 on, traces
    on the card lost one to four. GUARDS tiny kernels on each side
    of the calls are left out of the count and the time, so that a record
    lost at either end of the trace is one of theirs. -> a DeviceUs, which
    says which of the two read it."""
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
            return DeviceUs(total / len(inputs), "profiler")
    us = DeviceUs(queued_us(fn, inputs), "q")
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
                  f"kernel {us!r} us ({us.how}), plain {plain_us!r} us ({plain_us.how})")
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


def check_pointwise_variants(g):
    """The pointwise route on every plan PW_VARIANTS forces through
    _launch (a ragged 117 x 1152 -> 100 conv), and the dot route at M =
    1-8 (1152 -> 21): int8, bf16 and f32 inputs, scalar and per-channel
    scales; int32 accumulators and outputs in the input's type (bf16 for
    int8) bit-equal to the plain versions. -> worst error by kernel."""
    from autoware_vision_pilot_tpu_torch.ops.kernels.int8_conv import (
        PW_BK, _launch, int8_conv_plain, int8_conv_plan, int8_quantize_plain)

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    worst = {"int8_conv_pointwise": 0.0, "int8_conv_dot": 0.0}
    cases = []
    base = int8_conv_plan(1, 9, 13, 1152, 100, 1, 1, 0, sms)
    for bm, bn, cs in PW_VARIANTS:
        per = math.ceil(1152 / PW_BK / cs)
        grid = (math.ceil(117 / bm), math.ceil(100 / bn), math.ceil(1152 / PW_BK / per))
        cases.append(((1, 1152, 100, 9, 13), base._replace(
            bm=bm, bn=bn, grid=grid, per_split=per, blocks=math.prod(grid))))
    for batch in range(1, 9):
        cases.append(((batch, 1152, 21, 1, 1), int8_conv_plan(batch, 1, 1, 1152, 21, 1, 1, 0, sms)))
    for (batch, cin, cout, h, w), plan in cases:
        x = torch.randn(batch, cin, h, w, generator=g) * torch.linspace(0.5, 2.0, cin).reshape(1, -1, 1, 1)
        wq = torch.randint(-127, 128, (cout, cin, 1, 1), generator=g,
                           dtype=torch.int8).contiguous(memory_format=CL).cuda()
        ws = (torch.rand(cout, generator=g) * 1e-3 + 1e-4).cuda()
        for scale in (torch.tensor(float(x.abs().max()) * 0.9 / 127.0),
                      (x.double().abs().amax(dim=(0, 2, 3)) / 127.0).float()):
            sx = scale.cuda()
            for dtype in (torch.int8, torch.bfloat16, torch.float32):
                xf = x.to(torch.float32 if dtype == torch.int8 else dtype).contiguous(
                    memory_format=CL).cuda()
                xq = int8_quantize_plain(xf, sx)
                xin = xq if dtype == torch.int8 else xf
                out = torch.bfloat16 if dtype == torch.int8 else dtype
                bias = (torch.randn(cout, generator=g) * 0.1).to(out).cuda()
                acc = _launch(plan, xin, wq, ws, sx, None, 0, torch.int32)
                y = _launch(plan, xin, wq, ws, sx, bias, 0, out)
                torch.cuda.synchronize()
                want = int8_conv_plain(xq, wq, ws, sx, bias, 0, out)
                acc_err = (acc.long() - int8_conv_plain(xq, wq, ws, sx, None, 0, torch.int32)
                           .long()).abs().max().item()
                err = (y.float() - want.float()).abs().max().item()
                if acc_err or not torch.equal(y, want):
                    raise AssertionError(f"{plan.route} bm {plan.bm} bn {plan.bn} grid {plan.grid}"
                                         f" at M {batch * h * w}, {dtype} input: accumulators off by "
                                         f"{acc_err}, output by {err}")
                name = "int8_conv_" + plan.route
                worst[name] = max(worst[name], err)
    print(f"int8 1x1 plans forced: pointwise at {len(PW_VARIANTS)} (bm, bn, cluster) variants "
          f"of 117 x 1152 -> 100 and the dot at M = 1-8 (1152 -> 21), int8, bf16 and f32 "
          f"inputs, scalar and per-channel scales: int32 accumulators and outputs bit-equal "
          f"(max_abs_err {worst}; tol 0)")
    return worst


def time_int8_shapes(g, card, table=MAIN_INT8, what="the 24 shapes"):
    """The int8 conv shapes of ``table`` (by default the 24 of the main
    path), bf16 with a scalar scale, each timed over rotating inputs (and
    weights) that together exceed the L2 where the shape allows. At a 1x1
    shape also int8_conv2d (one launch that quantizes on load: what the
    paths run). -> the JSON records' timings (of RECORD_SHAPES found in
    ``table``)."""
    import torch.nn.functional as F
    from autoware_vision_pilot_tpu_torch.ops.kernels.int8_conv import (
        _launch, _reciprocal, int8_conv, int8_conv2d, int8_conv_plain,
        int8_conv_plan, int8_quantize, int8_quantize_plain, pad_channels, padded_channels)

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    # the frame's int8 device time from the shapes alone: the 3x3 convs and
    # their quantize, and the 1x1 convs
    frame = dict.fromkeys(("3x3 conv", "3x3 quantize", "3x3 channel pads (C % 16 != 0)",
                           "1x1 conv (quantize on load)"), 0.0)
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
            t["conv2d"] = device_us(conv2d, idx)
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
        parts = ({"1x1 conv (quantize on load)": t["conv2d"]}
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
                          f"{fused_bms * 1e3!r} us by {fused_by}, share {fused_share!r}")
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
                    ms=t["conv"] / 1e3,
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


def check_strided_kernels(g):
    """The "strided" route (and a launch a group) bit-equal to the plain
    versions at STRIDED_TIMED's and STRIDED_CHECKED's shapes: int8 input
    (int32, bf16 and f32 outputs) and float input (int8_conv2d), scalar and
    per-channel scales, batches of one and two. -> the worst error."""
    from autoware_vision_pilot_tpu_torch.ops.kernels.int8_conv import (
        int8_conv, int8_conv2d, int8_conv_plain, int8_quantize, int8_quantize_plain)

    shapes = [(*s[:8], 1, 1) for s in STRIDED_TIMED] + list(STRIDED_CHECKED)
    worst = 0.0
    for i, (kh, kw, cin, cout, h, w, stride, pad, dil, groups) in enumerate(shapes):
        batch = 1 + i % 2
        x = (torch.randn(batch, cin, h, w, generator=g)
             * torch.linspace(0.5, 2.0, cin).reshape(1, -1, 1, 1))
        weight = torch.randint(-127, 128, (cout, cin // groups, kh, kw), generator=g,
                               dtype=torch.int8).contiguous(memory_format=CL).cuda()
        w_scale = (torch.rand(cout, generator=g) * 1e-3 + 1e-4).cuda()
        scales = {"scalar": torch.tensor(float(x.abs().max()) * 0.9 / 127.0)}
        if groups == 1:
            scales["vector"] = (x.double().abs().amax(dim=(0, 2, 3)) / 127.0).float()
        kw_ = dict(stride=stride, dilation=dil, groups=groups)
        for dtype in (torch.bfloat16, torch.float32):
            xd = x.to(dtype).cuda().contiguous(memory_format=CL)
            bias = (torch.randn(cout, generator=g) * 0.1).to(dtype).cuda()
            for kind, sx in scales.items():
                sx = sx.cuda()
                before = int8_conv.route_launches["strided"]
                xq, xq_ref = int8_quantize(xd, sx), int8_quantize_plain(xd, sx)
                outs = [int8_conv(xq, weight, w_scale, sx, bias, pad, torch.int32, **kw_),
                        int8_conv(xq, weight, w_scale, sx, bias, pad, dtype, **kw_),
                        int8_conv2d(xd, weight, w_scale, sx, bias, pad, **kw_)]
                refs = [int8_conv_plain(xq_ref, weight, w_scale, sx, bias, pad, t, stride, dil,
                                        groups) for t in (torch.int32, dtype, dtype)]
                torch.cuda.synchronize()
                if int8_conv.route_launches["strided"] != before + 3 * groups:
                    raise AssertionError(f"{shapes[i]}: the convs did not take the strided "
                                         "route")
                errs = [(a.double() - b.double()).abs().max().item() for a, b in zip(outs, refs)]
                ok = torch.equal(xq, xq_ref) and all(
                    a.shape == b.shape and a.is_contiguous(memory_format=CL) and torch.equal(a, b)
                    for a, b in zip(outs, refs))
                print(f"int8 strided {kh}x{kw} {cin}->{cout} at {batch}x{h}x{w}, stride "
                      f"{stride}, pad {pad}, dilation {dil}, groups {groups}, {str(dtype)[6:]}, "
                      f"{kind} scale: int32 acc, output and int8_conv2d max_abs_err {errs} "
                      "(tol 0: bit-equal)")
                if not ok:
                    raise AssertionError("the strided route disagrees with its plain version")
                worst = max(worst, *errs)
        del xd, weight
        torch.cuda.empty_cache()
    return worst


def time_strided_shapes(g, card):
    """STRIDED_TIMED's shapes, bf16 with a scalar scale, each over rotating
    inputs (and weights) that together exceed the L2: profiler device time
    of the conv (the "strided" route) and of its quantize, the bound, the
    share, and the yardsticks the port never calls: the bf16 cuDNN conv at
    the same stride and torch._int_mm on a pre-built im2col. -> the JSON
    record of STRIDED_RECORD."""
    import torch.nn.functional as F
    from autoware_vision_pilot_tpu_torch.ops.kernels.int8_conv import (
        geometry, int8_conv, int8_conv_plain, int8_conv_plan, int8_quantize, out_size)

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    record, frame, frame128 = None, 0.0, 0.0
    for kh, kw, cin, cout, h, w, stride, pad, per_frame in STRIDED_TIMED:
        geo = geometry(pad, stride)
        OH, OW = out_size(h, w, kh, kw, geo)
        plan = int8_conv_plan(1, h, w, cin, cout, kh, kw, pad, sms, stride)
        M, K = OH * OW, kh * kw * cin
        set_bytes = h * w * cin * 3 + cout * K * 3
        n = max(2, min(64, math.ceil(1.2 * L2_BYTES / set_bytes)))
        sets = []
        for _ in range(n):
            x = torch.randn(1, cin, h, w, generator=g).to(torch.bfloat16).contiguous(
                memory_format=CL).cuda()
            weight = torch.randint(-127, 128, (cout, cin, kh, kw), generator=g,
                                   dtype=torch.int8).contiguous(memory_format=CL).cuda()
            ws = (torch.rand(cout, generator=g) * 1e-3 + 1e-4).cuda()
            b = (torch.randn(cout, generator=g) * 0.1).to(torch.bfloat16).cuda()
            sx = torch.tensor(float(x.float().abs().max()) / 127.0, device="cuda")
            sets.append((x, weight, ws, b, sx, int8_quantize(x, sx), weight.to(torch.bfloat16)))
        idx = list(range(n)) * max(1, math.ceil(20 / n))

        def conv(i):
            x, wt, ws, b, sx, xq, _ = sets[i]
            return int8_conv(xq, wt, ws, sx, b, pad, torch.bfloat16, stride=stride)

        def cudnn(i):
            x, _, _, b, _, _, w16 = sets[i]
            return F.conv2d(x, w16, b, stride, pad)

        t = {"conv": device_us(conv, idx), "cudnn": device_us(cudnn, idx),
             "quantize": device_us(lambda i: int8_quantize(sets[i][0], sets[i][4]), idx)}
        conv_ms = cuda_ms(conv, idx)
        n8 = -(-cout // 8) * 8
        cols = []
        for s in range(min(n, max(1, math.ceil(1.2 * L2_BYTES / (M * K + n8 * K))))):
            xq, wt = sets[s][5], sets[s][1]
            a = F.unfold(xq.float(), (kh, kw), padding=geo[:2], stride=geo[2:4])
            a = a.transpose(1, 2).reshape(M, K).to(torch.int8).contiguous()
            b2 = torch.zeros(n8, K, dtype=torch.int8, device=wt.device)
            b2[:cout] = wt.contiguous().reshape(cout, K)
            cols.append((a, b2.t()))
        intmm = (device_us(lambda i: torch._int_mm(*cols[i % len(cols)]),
                           list(range(len(cols))) * max(1, math.ceil(20 / len(cols))))
                 if M > 16 and K % 8 == 0 else None)
        del cols
        ops = 2.0 * M * cout * K
        nbytes = h * w * cin + cout * K + M * cout * 2 + cout * 6
        bms, by = bound(ops, nbytes)
        share = bms * 1e3 / t["conv"] if t["conv"] > 0 else float("nan")
        frame += per_frame * t["conv"]
        if (kh, kw, cin, cout, h, w) in ((3, 3, 128, 128, 80, 80), (3, 3, 128, 256, 40, 40),
                                         (3, 3, 128, 128, 40, 40)):
            frame128 += t["conv"]
        print(f"int8 strided shape {kh}x{kw} {cin}->{cout} at {h}x{w}, stride {stride}, pad "
              f"{pad} -> {OH}x{OW} (M {M}, N {cout}, K {K}), route {plan.route}: tiles (M, N, "
              f"cluster) {plan.grid}, rectangle {plan.th}x{plan.tw}, N tile {plan.bn}, "
              f"{plan.per_split} K steps of 32 channels a rank, {plan.blocks} blocks, {card}: conv "
              f"{t['conv']!r} us ({ops / (t['conv'] * 1e-6) / 1e12 if t['conv'] > 0 else 0!r} "
              f"TOP/s; CUDA events {conv_ms * 1e3!r} us), bound {bms * 1e3!r} us by {by}, share "
              f"{share!r}; bf16 cuDNN conv {t['cudnn']!r} us; torch._int_mm on im2col (no "
              f"im2col) " + (f"{intmm!r} us" if intmm is not None else "not taken")
              + (f" (N padded to {n8})" if n8 != cout and intmm is not None else "")
              + f"; quantize {t['quantize']!r} us; rotation {n} input sets, "
              f"{n * set_bytes / 1e6:.1f} MB")
        if (kh, kw, cin, cout, h, w) == STRIDED_RECORD:
            x, wt, ws, b, sx, xq, _ = sets[0]
            record = dict(ms=t["conv"] / 1e3, bound_ms=bms, bound_by=by,
                          library_ms=intmm / 1e3 if intmm is not None else None,
                          plain_ms=device_us(lambda i: int8_conv_plain(
                              xq, wt, ws, sx, b, pad, torch.bfloat16, stride), [0] * 5) / 1e3)
        del sets
        torch.cuda.empty_cache()
    print(f"strided int8 convs a frame of AutoSpeed \"n\" at 640x640 from the shapes' times, "
          f"{card}: {frame!r} us at min_channels 32 (5 convs), {frame128!r} us at 128 (3 convs)")
    return record


def phase_int8_kernels(card):
    """The int8 kernels against their plain versions, then the 24 shapes'
    times and the strided route's shapes; -> the JSON records of the int8
    kernels."""
    g = torch.Generator().manual_seed(SEED + 4)
    worst = check_int8_kernels(g)
    for name, err in check_pointwise_variants(g).items():
        worst[name] = max(worst[name], err)
    worst["int8_conv_strided"] = check_strided_kernels(g)
    records = time_int8_shapes(g, card)
    records.update(time_int8_shapes(g, card, HALO_TIMED, "the halo route's shapes (the QAT "
                                                          "export's head a frame)"))
    records["int8_conv_strided"] = time_strided_shapes(g, card)
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
        ROUTES, int8_conv, int8_conv_transpose, int8_quantize)
    from autoware_vision_pilot_tpu_torch.ops.kernels.lane_filter_kernel import lane_filter_walk
    from autoware_vision_pilot_tpu_torch.ops.kernels.nms_kernel import nms_greedy
    from autoware_vision_pilot_tpu_torch.ops.kernels.preprocess_kernel import (fused_letterbox,
                                                                               fused_preprocess)
    for fn in (fused_preprocess, int8_quantize, int8_conv, lane_filter_walk, fused_letterbox,
               nms_greedy, int8_conv_transpose):
        fn.launches = 0
    int8_conv.route_launches = dict.fromkeys(ROUTES, 0)


def read_counts():
    """Launches by kernel since reset_counts(); int8_conv counts its two
    conv kernels together, by route."""
    from autoware_vision_pilot_tpu_torch.ops.kernels.int8_conv import (
        int8_conv, int8_conv_transpose, int8_quantize)
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
            "int8_conv_strided": r["strided"],
            "int8_conv_halo": r["halo"], "int8_conv_pointwise": r["pointwise"],
            "int8_conv_dot": r["dot"], "int8_conv_transpose": int8_conv_transpose.launches}


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
    LATENCY[name] = (p50, p99)
    return launches


LATENCY = {}  # drive's (p50, p99) ms by path name, for later phases to print beside theirs


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


def int8_modules(pipe, transposes=False):
    from autoware_vision_pilot_tpu_torch.nn.layers import Int8Conv2d, Int8ConvTranspose2d
    kinds = (Int8Conv2d, Int8ConvTranspose2d) if transposes else Int8Conv2d
    return [m for net in (pipe.stack, pipe.lanes) for m in net.modules()
            if isinstance(m, kinds)]


def plain_of(m, x):
    """The plain version of int8 module ``m`` (an Int8Conv2d with its own
    padding, stride, dilation and groups, or an Int8ConvTranspose2d) on its
    input ``x``, with its static scale."""
    from autoware_vision_pilot_tpu_torch.nn.layers import Int8ConvTranspose2d
    from autoware_vision_pilot_tpu_torch.ops.kernels.int8_conv import (int8_conv2d,
                                                                       int8_conv_transpose)

    x = x.contiguous(memory_format=CL)
    if isinstance(m, Int8ConvTranspose2d):
        return int8_conv_transpose(x, m.weight, m.weight_scale, m.input_scale, m.bias,
                                   plain=True)
    return int8_conv2d(x, m.weight, m.weight_scale, m.input_scale, m.bias, m.padding,
                       stride=m.stride, dilation=m.dilation, groups=m.groups, plain=True)


def check_convs_on_path(pipe, frame, transposes=0):
    """One int8 frame; a hook on each Int8Conv2d (and with ``transposes``,
    each Int8ConvTranspose2d, that many expected) holds the kernels' output
    against the plain versions on the same input, with torch.equal."""
    checked, bad = [], []

    def hook(m, args, y):
        if m.input_scale is None:
            raise AssertionError("an int8 conv of the main path has no static scale")
        ref = plain_of(m, args[0])
        checked.append(m)
        if not torch.equal(y, ref):
            bad.append((len(checked) - 1, (y.float() - ref.float()).abs().max().item()))

    handles = [m.register_forward_hook(hook) for m in int8_modules(pipe, transposes > 0)]
    try:
        pipe(frame)
        torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    print(f"int8 frame, conv by conv: {len(checked)} int8 modules ({transposes} of them "
          f"transposed convs) held against their plain versions on the same input, "
          f"{len(checked) - len(bad)} bit-equal (torch.equal)"
          + (f"; differ: {bad[:8]}" if bad else ""))
    if len(checked) != 72 + transposes or bad:
        raise AssertionError("int8 convs on the main path disagree with their plain versions")


KINDS = (("int8 conv, wgmma and split-K", "int8_conv_wgmma_kernel"),
         ("int8 conv, pointwise (quantize on load)", "int8_pointwise_kernel"),
         ("int8 conv, dot (quantize on load)", "int8_dot_kernel"),
         ("int8 conv, halo", "int8_conv_halo_kernel"),
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


def phase_int8(card, bf16_pipe, parent_root=None):
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
                               "int8_conv_dot": 20 * n, "int8_conv_halo": 0})
    check_convs_on_path(pipe, pool[0])
    profile_frames(pipe, pool, card)
    host_costs(bf16_pipe, pipe, pool, card)
    if parent_root is not None:
        # the same measurement of each package in a fresh process (a long
        # process's host times drift): parent, this, this, parent
        for turn, root in (("parent", parent_root), ("this tree", str(REPO)),
                           ("this tree", str(REPO)), ("parent", parent_root)):
            print(f"host costs, turn of {turn}:", flush=True)
            subprocess.run([sys.executable, str(REPO / "chip_smoke.py"), "--host-costs", root],
                           check=True)

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


def tree_build(root):
    """kernels/build.py of the port in ROOT, loaded as a module of its own."""
    import importlib.util

    pkg = pathlib.Path(root).resolve() / "autoware_vision_pilot_tpu_torch"
    spec = importlib.util.spec_from_file_location(f"build_of_{abs(hash(str(pkg)))}",
                                                  pkg / "kernels" / "build.py")
    pb = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(pb)
    return pkg, pb


def build_library(pb, csrc, sources, lib_path, defines=()):
    """``sources`` compiled with the flags of ``pb`` (a tree's kernels/build.py),
    one nvcc each, all at once, and linked into ``lib_path``. -> the CDLL,
    its entry points declared with that tree's C signatures."""
    import ctypes

    objs = [lib_path.with_name(f"{lib_path.stem}_{src.stem}.o") for src in sources]
    pb._run_all([[pb._nvcc(), *pb.NVCC_FLAGS, *defines, "-I", str(csrc), "-c", "-o", str(o),
                  str(src)] for src, o in zip(sources, objs)])
    pb._run_all([[pb._nvcc(), *pb.NVCC_FLAGS, "-shared", "-o", str(lib_path), *map(str, objs)]])
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in pb.SIGNATURES.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def calls_operators(pkg):
    """Whether the int8 wrapper of the port in ``pkg`` launches its kernels
    as the avp operators (of the library kernels/build.py builds), which
    no other library can stand in for."""
    return "torch.ops.avp" in (pkg / "ops" / "kernels" / "int8_conv.py").read_text()


def int8_wrapper_of(pkg, lib):
    """ops/kernels/int8_conv.py of the port in ``pkg`` as a module of its
    own whose kernels come from ``lib`` (its launch counts apart from this
    tree's): int8_conv2d through another tree's wrapper and plan. Only for
    a tree whose wrapper calls its library through ctypes."""
    import types

    if calls_operators(pkg):
        raise RuntimeError(f"{pkg} calls its int8 kernels as avp operators: they cannot be "
                           "bound to another library (--parent's int8 turns need a parent "
                           "whose int8 wrapper uses ctypes)")

    path = pkg / "ops" / "kernels" / "int8_conv.py"
    text = path.read_text().replace("from ...kernels import build\n", "")
    mod = types.ModuleType(f"int8_conv_of_{abs(hash((str(pkg), id(lib))))}")
    mod.build = types.SimpleNamespace(load=lambda: lib)
    exec(compile(text, str(path), "exec"), mod.__dict__)
    return mod


def preprocess_wrapper_of(pkg, lib):
    """ops/kernels/preprocess_kernel.py of the port in ``pkg`` as a module of
    its own whose kernels come from ``lib`` (its launch counts apart from
    this tree's), its plain versions and tables this tree's ops/preprocess.py
    (unchanged since the letterbox's first port)."""
    import types

    path = pkg / "ops" / "kernels" / "preprocess_kernel.py"
    text = path.read_text().replace("from ...kernels import build\n", "")
    mod = types.ModuleType(f"preprocess_of_{abs(hash((str(pkg), id(lib))))}")
    mod.__package__ = "autoware_vision_pilot_tpu_torch.ops.kernels"
    mod.build = types.SimpleNamespace(load=lambda: lib)
    exec(compile(text, str(path), "exec"), mod.__dict__)
    return mod


def parent_kernels(root):
    """--parent ROOT: the lane-filter walk, NMS, int8 1x1 conv and preprocess
    entry points of the port in ROOT (an earlier commit unpacked with git
    archive), its whole csrc/ compiled with its own flags into
    ROOT/build/parent_kernels/ and bound with its own C signatures. ->
    (walk(masks), nms(top, kw), each allocating its outputs as this tree's
    wrappers do; the stamped copies of stamped_parent, where the parent's
    kernels have no stamps; the parent's int8_conv module over its own
    kernels; its 1x1 kernels stamped as PARENT_PW_STAMPS says; its
    preprocess_kernel module over its own kernels; and its letterbox stamped
    as stamped_letterbox says), or None without ROOT."""
    if root is None:
        return None
    pkg, pb = tree_build(root)
    out = pkg.parent / "build" / "parent_kernels"
    out.mkdir(parents=True, exist_ok=True)
    lib = build_library(pb, pkg / "csrc", pb.sources(pkg / "csrc"), out / "libparent.so")
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
    # a parent that calls its int8 and preprocess kernels as avp operators
    # cannot be bound to its own library: those turns are not measured
    ops = calls_operators(pkg)
    if ops:
        print(f"{pkg} calls its int8 and preprocess kernels as avp operators: the 1x1, halo, "
              "d2s and letterbox turns with it are not measured (the strided route's are, "
              "through its C entry point)")
    return (walk, nms, stamped_parent(pkg, pb, out) if walk_args == 6 else None,
            None if ops else int8_wrapper_of(pkg, lib),
            stamped_pointwise(pkg, pb, out, PARENT_PW_STAMPS),
            None if ops else preprocess_wrapper_of(pkg, lib), stamped_letterbox(pkg, pb, out),
            parent_strided(pkg, pb, out))


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


# Stage stamps for the parent's 1x1 kernels when they have none of their own
# (the mma.sync pointwise and shared-memory dot): [(anchor, text put
# before it)], each anchor found once in its int8_pointwise.cu. Thread 0 of
# each block adds up its SM clocks by stage and writes 8 words a block, as
# this tree's kernels do when built with -DAVP_PW_STAMPS: the first and
# last %globaltimer, the clocks in all, then the stages (pointwise: load
# wait, quantize, MMA, staging and the cluster barrier, epilogue; dot: the
# activation quantized into shared memory and the barrier, the weights and
# sums, the shuffles and stores).
PW_STAMP_STRUCT = """__device__ unsigned long long* g_stamps;
struct PwStamps {
  unsigned long long g0;
  long long c0, t, c[5];
  __device__ __forceinline__ void start() {
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g0));
    c0 = t = clock64();
    for (int i = 0; i < 5; ++i) c[i] = 0;
  }
  __device__ __forceinline__ void lap(int i) {
    const long long now = clock64();
    c[i] += now - t;
    t = now;
  }
  __device__ __forceinline__ void write() {
    if (!g_stamps || threadIdx.x != 0) return;
    unsigned long long* o = g_stamps + 8 * (blockIdx.y * gridDim.x + blockIdx.x);
    unsigned long long g1;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g1));
    o[0] = g0;
    o[1] = g1;
    o[2] = (unsigned long long)(clock64() - c0);
    for (int i = 0; i < 5; ++i) o[3 + i] = (unsigned long long)c[i];
  }
};

"""
PARENT_PW_STAMPS = [
    ("// One block: a BM x BN output tile and the K range [k_begin, k_end) of its",
     PW_STAMP_STRUCT),
    ("\n  cg::cluster_group cluster = cg::this_cluster();\n  const int rank = (int)cluster.block_rank();\n"
     "  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;",
     "\n  PwStamps pw_st;\n  pw_st.start();"),
    ("    if (kt + STAGES - 1 < steps) load_stage(", "    pw_st.lap(0);\n"),
    ("    const unsigned char* bs = stage + A_STAGE;\n", "    pw_st.lap(1);\n"),
    ("  }\n  cp_async_wait<0>();", "    pw_st.lap(2);\n"),
    ("    return;\n  }\n  // Every rank leaves", "    pw_st.lap(4);\n    pw_st.write();\n"),
    ("#pragma unroll\n  for (int i = 0; i < MI; ++i)\n#pragma unroll\n    for (int j = 0; j < NJ; ++j) {\n"
     "      if ((i * NJ + j) % a.cs != rank) continue;", "  pw_st.lap(3);\n"),
    ("}\n\n// The dynamic shared-memory limit is set once per kernel and device.",
     "  pw_st.lap(4);\n  pw_st.write();\n"),
    ("  const int tid = threadIdx.x, lane = tid % 32;\n  const int n = blockIdx.x * DOT_WARPS",
     "  PwStamps pw_st;\n  pw_st.start();\n"),
    ("  if (n >= a.N) return;\n", "  pw_st.lap(0);\n"),
    ("#pragma unroll\n  for (int m = 0; m < DOT_MAX_M; ++m) {\n    if (m < a.M) {\n      int v = acc[m];",
     "  pw_st.lap(1);\n"),
    ("}\n\ntemplate <typename T>\ncudaError_t launch_dot", "  pw_st.lap(2);\n  pw_st.write();\n"),
    ('extern "C" int avp_int8_conv_pointwise(', 'extern "C" int avp_set_stamps(void* p) {\n'
     "  return (int)cudaMemcpyToSymbol(g_stamps, &p, sizeof(p));\n}\n\n"),
]
STAMP_WORDS = 8


def stamped_pointwise(pkg, pb, out, edits=None):
    """The 1x1 kernels of the port in ``pkg`` with stage stamps, in a
    library of their own under ``out``: with ``edits`` (anchor, text) put
    into a copy of its int8_pointwise.cu, else built with -DAVP_PW_STAMPS
    (this tree's own stamps) beside int8_conv_sm90.cu (the weights' map). ->
    (its int8_conv module over that library, the stamps tensor), or None
    if an anchor is missing or the tree calls its kernels as operators."""
    import ctypes

    src = pkg / "csrc" / "int8_pointwise.cu"
    if calls_operators(pkg):
        print(f"stage split of {src}: not measured (its wrapper calls the kernels as avp "
              "operators, which a stamped library cannot stand in for)")
        return None
    if edits:
        text = src.read_text()
        for anchor, stamp in edits:
            if text.count(anchor) != 1:
                print(f"stage split of {src}: not measured (no single {anchor!r})")
                return None
            text = text.replace(anchor, stamp + anchor)
        copy = out / "stamped_int8_pointwise.cu"
        copy.write_text(text)
        lib = build_library(pb, pkg / "csrc", [copy], out / "libstamped_pointwise.so")
        setter = lib.avp_set_stamps
    else:
        lib = build_library(pb, pkg / "csrc", [src, pkg / "csrc" / "int8_conv_sm90.cu"],
                            out / "libstamped_pointwise.so", ("-DAVP_PW_STAMPS",))
        setter = lib.avp_int8_pointwise_set_stamps
    stamps = torch.zeros(STAMP_WORDS * 4096, dtype=torch.int64, device="cuda")
    if setter(ctypes.c_void_p(stamps.data_ptr())):
        raise RuntimeError(f"could not set the stamp buffer of {src}")
    return int8_wrapper_of(pkg, lib), stamps


# the stage names of csrc/letterbox.cu's own stamps (AVP_LB_STAMPS)
LB_STAGES = ("unit decoded, its copies' taps landed", "source bytes copied and landed",
             "lerp and stores", "a piece of the pad (pad blocks)")


def stamped_letterbox(pkg, pb, out):
    """The letterbox of the port in ``pkg`` with its own stage stamps, in a
    library of its own under ``out``: its csrc/letterbox.cu built with
    -DAVP_LB_STAMPS. -> (its preprocess_kernel module over that library,
    the stamps tensor, blocks(n): the grid at 720p -> LON_HW for n frames,
    the stage names), or None for an earlier tree without
    csrc/letterbox.cu, whose split is then not measured."""
    import ctypes

    if not (pkg / "csrc" / "letterbox.cu").exists():
        print(f"stage split of {pkg}'s letterbox: not measured (no csrc/letterbox.cu)")
        return None
    if "torch.ops.avp" in (pkg / "ops" / "kernels" / "preprocess_kernel.py").read_text():
        # its wrapper launches through this process's operator library
        # (csrc/torch_ops.cpp), not a stamped library of its own
        print(f"stage split of {pkg}'s letterbox: not measured (launched through the avp "
              "operators)")
        return None
    lib = build_library(pb, pkg / "csrc", [pkg / "csrc" / "letterbox.cu"],
                        out / "libstamped_letterbox.so", ("-DAVP_LB_STAMPS",))
    mod = preprocess_wrapper_of(pkg, lib)

    def blocks(n):
        return mod.letterbox_plan(n, *FRAME_HW, LON_HW).blocks

    stamps = torch.zeros(STAMP_WORDS * max(blocks(n) for n in (1, 8)), dtype=torch.int64,
                         device="cuda")
    if lib.avp_letterbox_set_stamps(ctypes.c_void_p(stamps.data_ptr())):
        raise RuntimeError(f"could not set the letterbox stamp buffer of {pkg}")
    return mod, stamps, blocks, LB_STAGES


def stage_split(mod, stamps, plan, call, n_stages):
    """Runs ``call(mod)`` (one launch of a stamped kernel) and reads its
    blocks' stamps. -> (mean ns a block by stage, mean and max ns from a
    block's first stamp to its last)."""
    blocks = plan.blocks
    stamps.zero_()
    call(mod)
    torch.cuda.synchronize()
    t = stamps[:STAMP_WORDS * blocks].view(blocks, STAMP_WORDS).cpu().numpy().astype(np.float64)
    span = t[:, 1] - t[:, 0]
    ns_per_clock = span / np.maximum(t[:, 2], 1)
    stages = t[:, 3:3 + n_stages] * ns_per_clock[:, None]
    return stages.mean(axis=0), float(span.mean()), float(span.max())


# (cin, cout, h, w) of --parent's 1x1 comparison: RECORD_SHAPES' two, the
# main path's other 1x1 convs and SE squeezes, and three Lite 1x1 convs
PARENT_1X1 = ((1152, 320, 10, 20), (1152, 48, 1, 1), (320, 1280, 10, 20), (672, 112, 20, 40),
              (1152, 192, 10, 20), (480, 112, 20, 40), (480, 80, 20, 40), (672, 192, 10, 20),
              (672, 28, 1, 1), (480, 20, 1, 1), (304, 256, 80, 160), (1280, 256, 20, 40),
              (1152, 320, 20, 40))
# the shapes of the stage splits: cluster split-K at 10x20, 800 tiles with no
# split at 80x160, a long K at 20x40, and an SE squeeze
SPLIT_1X1 = ((1152, 320, 10, 20), (304, 256, 80, 160), (1280, 256, 20, 40), (1152, 48, 1, 1))
PW_STAGES = ("load wait", "quantize", "MMA", "staging and cluster barrier",
             "epilogue (sums over the ranks, stores)")
DOT_STAGES = {"parent": ("x quantized into shared memory and the barrier", "weights and sums",
                         "shuffles and stores"),
              "this tree": ("weight loads issued", "x loads, quantize and sums",
                            "shuffles and stores")}


def pointwise_sets(g, cin, cout, h, w):
    """Rotating bf16 inputs of a 1x1 shape (scalar scale, its reciprocal
    kept), together above the L2 where the shape allows, as phase 4's."""
    from autoware_vision_pilot_tpu_torch.ops.kernels.int8_conv import _reciprocal

    set_bytes = h * w * cin * 2 + cout * cin
    n = max(2, min(64, math.ceil(1.2 * L2_BYTES / set_bytes)))
    sets = [int8_inputs(g, (1, cin, cout, h, w), torch.bfloat16) for _ in range(n)]
    for x, wt, ws, b, sx in sets:
        _reciprocal(sx)
    return sets, list(range(n)) * max(1, math.ceil(20 / n))


def phase_pointwise_parent(card, parent):
    """--parent: the parent's 1x1 kernels ("pointwise" and "dot", through
    its own int8_conv2d and plan) against this tree's on the same bf16
    inputs, outputs equal, profiler device time in turns (parent, this,
    this, parent) at PARENT_1X1; then each one's stage split at SPLIT_1X1
    from stamped copies (the parent's by PARENT_PW_STAMPS, this tree's
    built with -DAVP_PW_STAMPS), mean ns a block over 8 launches."""
    from autoware_vision_pilot_tpu_torch.kernels import build as this_build
    from autoware_vision_pilot_tpu_torch.ops.kernels import int8_conv as ours

    theirs = parent[3]
    if theirs is None:
        return {}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    g = torch.Generator().manual_seed(SEED + 12)
    times = {}
    for cin, cout, h, w in PARENT_1X1:
        sets, idx = pointwise_sets(g, cin, cout, h, w)
        fns = {name: (lambda i, m=mod: m.int8_conv2d(sets[i][0], sets[i][1], sets[i][2],
                                                     sets[i][4], sets[i][3], 0))
               for name, mod in (("parent", theirs), ("this tree", ours))}
        if not torch.equal(fns["parent"](0), fns["this tree"](0)):
            raise AssertionError(f"1x1 {cin}->{cout} at {h}x{w}: the parent's output differs")
        plans = {name: mod.int8_conv_plan(1, h, w, cin, cout, 1, 1, 0, sms)
                 for name, mod in (("parent", theirs), ("this tree", ours))}
        label = (f"1x1 {cin}->{cout} at {h}x{w}, bf16 in (parent {plans['parent'].route} "
                 f"grid {plans['parent'].grid}; this tree {plans['this tree'].route} "
                 f"bm {plans['this tree'].bm} bn {plans['this tree'].bn} grid "
                 f"{plans['this tree'].grid})")
        t = alternate(label, fns, idx, card)
        times[(cin, cout, h, w)] = {k: float(np.mean(v)) for k, v in t.items()}
        print(f"{label}, {card}: parent {times[(cin, cout, h, w)]['parent']!r} us, this tree "
              f"{times[(cin, cout, h, w)]['this tree']!r} us (mean of two turns each)")
        del sets
        torch.cuda.empty_cache()
    stamped = {"parent": parent[4],
               "this tree": stamped_pointwise(REPO / "autoware_vision_pilot_tpu_torch",
                                              this_build, REPO / "build")}
    for cin, cout, h, w in SPLIT_1X1:
        sets, _ = pointwise_sets(g, cin, cout, h, w)
        for name, st in stamped.items():
            if st is None:
                continue
            mod, stamps = st
            plan = mod.int8_conv_plan(1, h, w, cin, cout, 1, 1, 0, sms)
            names = PW_STAGES if plan.route == "pointwise" else DOT_STAGES[name]
            runs = [stage_split(mod, stamps, plan, lambda m, s=s: m.int8_conv2d(
                s[0], s[1], s[2], s[4], s[3], 0), len(names)) for s in sets[:8]]
            split = np.mean([r[0] for r in runs], axis=0)
            print(f"{name}'s {plan.route} stage split, 1x1 {cin}->{cout} at {h}x{w} bf16, "
                  f"{card} (ns a block, mean over {plan.blocks} blocks x {len(runs)} launches, "
                  f"clock64 laps of thread 0 scaled by %globaltimer): "
                  + ", ".join(f"{n} {v:.0f}" for n, v in zip(names, split))
                  + f"; first stamp to last {np.mean([r[1] for r in runs]):.0f} (slowest block "
                  f"{np.mean([r[2] for r in runs]):.0f})")
        del sets
        torch.cuda.empty_cache()
    return times


# --parent's turns of the two kernels redesigned for this card: the window
# conv with C < 128 at the QAT export's head and INT8_SHAPES' 64 -> 96
# (window, cin, cout, h, w; the parent's mma.sync kernel where the parent
# has one, this tree's halo kernel), and the transposed conv at
# MAIN_TRANSPOSES (the parent's pointwise D2S instance, this tree's quantize
# and d2s)
PARENT_HALO = ((3, 64, 3, 320, 640), (3, 64, 96, 20, 40))
# the stage splits of the new kernels, from this tree built with
# -DAVP_HALO_STAMPS -DAVP_D2S_STAMPS
HALO_STAGES = ("halo wait", "taps (weight waits, wgmma)", "staging",
               "copy out", "the epilogue's first barrier")
D2S_STAGES = ("load wait", "wgmma", "epilogue (staging, bulk stores issued)",
              "split-K sums", "waiting for the last tile's stores to read the staging")


def stamped_int8(pkg, pb, out):
    """The halo and d2s kernels of the port in ``pkg`` with their stage
    stamps: its int8_conv.cu, int8_conv_sm90.cu and int8_conv_halo.cu built
    with -DAVP_HALO_STAMPS -DAVP_D2S_STAMPS into a library of their own
    under ``out``. -> (its int8_conv module over that library, the halo's
    stamps, the d2s stamps), or None where the tree calls its kernels as
    operators."""
    import ctypes

    if calls_operators(pkg):
        print(f"the halo and d2s stage splits of {pkg}: not measured (its wrapper calls the "
              "kernels as avp operators, which a stamped library cannot stand in for)")
        return None
    csrc = pkg / "csrc"
    lib = build_library(pb, csrc, [csrc / "int8_conv.cu", csrc / "int8_conv_sm90.cu",
                                   csrc / "int8_conv_halo.cu"], out / "libstamped_int8.so",
                        ("-DAVP_HALO_STAMPS", "-DAVP_D2S_STAMPS"))
    stamps = []
    for setter in (lib.avp_int8_halo_set_stamps, lib.avp_int8_d2s_set_stamps):
        buf = torch.zeros(STAMP_WORDS * 4096, dtype=torch.int64, device="cuda")
        if setter(ctypes.c_void_p(buf.data_ptr())):
            raise RuntimeError(f"could not set a stamp buffer of {csrc}")
        stamps.append(buf)
    return int8_wrapper_of(pkg, lib), *stamps


def transpose_sets(g, cin, cout, h, w):
    """Rotating bf16 inputs of a 2x2 transposed conv, together above the L2
    where the shape allows, as phase 29's."""
    M, N = h * w, 4 * cout
    set_bytes = M * cin * 2 + N * cin * 3 + M * N * 2
    n = max(2, min(64, math.ceil(1.2 * L2_BYTES / set_bytes)))
    sets = [transpose_inputs(g, (cin, cout, 2, h, w, 1), torch.bfloat16) for _ in range(n)]
    return sets, list(range(n)) * max(1, math.ceil(20 / n))


def phase_d2s_halo_parent(card, parent):
    """--parent: the parent's window conv with C < 128 and transposed conv
    (through its own int8_conv module and plans) against this tree's halo
    and d2s kernels on the same bf16 inputs, outputs equal, profiler device
    time in turns (parent, this, this, parent) at PARENT_HALO and
    MAIN_TRANSPOSES; then this tree's stage splits (stamped_int8) at the
    same shapes, mean ns a block over 4 launches."""
    from autoware_vision_pilot_tpu_torch.kernels import build as this_build
    from autoware_vision_pilot_tpu_torch.ops.kernels import int8_conv as ours
    from autoware_vision_pilot_tpu_torch.ops.kernels.int8_conv import int8_quantize

    theirs = parent[3]
    if theirs is None:
        return
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    g = torch.Generator().manual_seed(SEED + 19)
    mods = (("parent", theirs), ("this tree", ours))
    halo_sets = {}
    for k, cin, cout, h, w in PARENT_HALO:
        set_bytes = h * w * cin + cout * cin * k * k
        n = max(2, min(64, math.ceil(1.2 * L2_BYTES / set_bytes)))
        sets = []
        for _ in range(n):
            x, wt, ws, b, sx = int8_inputs(g, (k, cin, cout, h, w), torch.bfloat16)
            sets.append((int8_quantize(x, sx), wt, ws, b, sx))
        idx = list(range(n)) * max(1, math.ceil(20 / n))
        fns = {name: (lambda i, m=mod: m.int8_conv(*sets[i][:3], sets[i][4], sets[i][3], k // 2,
                                                   torch.bfloat16)) for name, mod in mods}
        if not torch.equal(fns["parent"](0), fns["this tree"](0)):
            raise AssertionError(f"{k}x{k} {cin}->{cout} at {h}x{w}: the parent's output differs")
        routes = {name: mod.int8_conv_plan(1, h, w, cin, cout, k, k, k // 2, sms).route
                  for name, mod in mods}
        label = (f"int8 conv {k}x{k} {cin}->{cout} at {h}x{w}, int8 in, bf16 out (parent "
                 f"{routes['parent']}, this tree {routes['this tree']})")
        t = alternate(label, fns, idx, card)
        print(f"{label}, {card}: parent {float(np.mean(t['parent']))!r} us, this tree "
              f"{float(np.mean(t['this tree']))!r} us (mean of two turns each)")
        halo_sets[(k, cin, cout, h, w)] = sets[:4]
    sx = torch.tensor(0.0213, device="cuda")
    d2s_sets = {}
    for cin, cout, h, w, _ in MAIN_TRANSPOSES:
        sets, idx = transpose_sets(g, cin, cout, h, w)
        fns = {name: (lambda i, m=mod: m.int8_conv_transpose(*sets[i][:3], sx, sets[i][3]))
               for name, mod in mods}
        if not torch.equal(fns["parent"](0), fns["this tree"](0)):
            raise AssertionError(f"transpose {cin}->{cout} at {h}x{w}: the parent's output differs")
        label = (f"int8 transpose 2x2 {cin}->{cout} at {h}x{w}, bf16 in and out (parent one "
                 f"launch, quantize on load; this tree quantize + d2s)")
        t = alternate(label, fns, idx, card)
        print(f"{label}, {card}: parent {float(np.mean(t['parent']))!r} us, this tree "
              f"{float(np.mean(t['this tree']))!r} us (mean of two turns each)")
        d2s_sets[(cin, cout, h, w)] = sets[:4]
        del sets
        torch.cuda.empty_cache()
    stamped = stamped_int8(REPO / "autoware_vision_pilot_tpu_torch", this_build, REPO / "build")
    if stamped is None:
        return
    mod, halo_stamps, d2s_stamps = stamped

    def split(label, stamps, plan, calls, names):
        runs = [stage_split(mod, stamps, plan, call, len(names)) for call in calls]
        mean = np.mean([r[0] for r in runs], axis=0)
        print(f"this tree's {label} stage split, {card} (ns a block, mean over {plan.blocks} "
              f"blocks x {len(runs)} launches, clock64 laps of the first consumer thread scaled "
              f"by %globaltimer): " + ", ".join(f"{n} {v:.0f}" for n, v in zip(names, mean))
              + f"; first stamp to last {np.mean([r[1] for r in runs]):.0f} (slowest block "
              f"{np.mean([r[2] for r in runs]):.0f})")

    for (k, cin, cout, h, w), sets in halo_sets.items():
        plan = mod.int8_conv_plan(1, h, w, cin, cout, k, k, k // 2, sms)
        split(f"halo {k}x{k} {cin}->{cout} at {h}x{w}", halo_stamps, plan,
              [lambda m, s=s: m.int8_conv(*s[:3], s[4], s[3], k // 2, torch.bfloat16)
               for s in sets], HALO_STAGES)
    for (cin, cout, h, w), sets in d2s_sets.items():
        plan = mod.int8_conv_transpose_plan(1, h, w, cin, cout, 2, 2, sms)
        split(f"d2s 2x2 {cin}->{cout} at {h}x{w}", d2s_stamps, plan,
              [lambda m, s=s: m.int8_conv_transpose(*s[:3], sx, s[3]) for s in sets], D2S_STAGES)
    del halo_sets, d2s_sets
    torch.cuda.empty_cache()


# --parent's turns of the strided route (phase 4): the parent's form, the
# strided variant of the wgmma kernel (csrc/int8_conv_sm90.cu there), called
# through its own C entry point with its own plan, against this tree's
# route on the same int8 inputs, at STRIDED_TIMED's shapes; and stage splits
# at STRIDED_SPLIT (window h w, cin, cout, h, w, stride, pad): the parent's
# from a copy of its int8_conv_sm90.cu with PARENT_STRIDED_STAMPS put in
# (built with -DAVP_D2S_STAMPS, whose StageClock the edits then run for every
# variant), this tree's built with -DAVP_STRIDED_STAMPS.
STRIDED_SPLIT = ((3, 3, 64, 64, 160, 160, 2, 1), (3, 3, 128, 128, 80, 80, 2, 1),
                 (2, 1, 64, 32, 128, 256, (2, 1), 0))
# (window, cin, cout, h, w) of the main path's 3x3 convs timed in the same
# turns: the wgmma kernel's stride-1 routes ("wgmma", "splitk"), whose
# kernel lost its strided form, the parent's through the same C entry point
MAIN_TURNS = ((3, 256, 256, 160, 320), (3, 512, 512, 80, 160), (3, 1456, 768, 20, 40))
# (old text, new text, times found) in the parent's int8_conv_sm90.cu; the
# stages: 0 the consumer's start to the first full stage, 1 every later
# load wait, 2 the wgmmas and their group waits, 3 split-K's partial-tile
# store, arrival atomic and read-back, 4 the epilogue's stores
PARENT_STRIDED_STAMPS = [
    ("    if (D2S) st.start();\n", "    st.start();\n", 1),
    ("if (D2S) st.lap(0);", "st.lap(i == 0 ? 0 : 1);", 1),
    ("if (D2S) st.lap(1);", "st.lap(2);", 2),
    ("        if (!last_split) continue;\n", "        st.lap(3);\n        if (!last_split) continue;\n",
     1),
    ("      } else {\n#pragma unroll\n        for (int h = 0; h < 2; ++h) {\n          if (m[h] < 0) "
     "continue;\n", "      } else {\n        st.lap(3);\n#pragma unroll\n        for (int h = 0; "
     "h < 2; ++h) {\n          if (m[h] < 0) continue;\n", 1),
    ("acc[4 * p + 2 * h], acc[4 * p + 2 * h + 1]);\n        }\n      }\n",
     "acc[4 * p + 2 * h], acc[4 * p + 2 * h + 1]);\n        }\n        st.lap(4);\n      }\n", 1),
    ("    if (D2S && threadIdx.x == 128) {", "    if (threadIdx.x == 128) {", 1),
]
OLD_STRIDED_STAGES = ("start to the first full stage", "later load waits", "wgmma",
                      "split-K store, arrival and read-back", "epilogue")
# this tree's (csrc/int8_conv_strided.cu built with -DAVP_STRIDED_STAMPS)
STRIDED_STAGES = ("start to the first batch of stages landed (tables, loads)",
                  "later batches' loads", "wgmma", "the int32 tile staged, the cluster barrier "
                  "and sums", "epilogue")


def stamped_strided(pkg, pb, out):
    """The strided kernel of the port in ``pkg`` with its stage stamps: its
    int8_conv_strided.cu built with -DAVP_STRIDED_STAMPS into a library of
    its own under ``out``, called through its C entry point. -> (call(xq,
    weight, w_scale, x_scale, bias, pad, stride, plan) -> bf16 output, the
    stamps tensor)."""
    import ctypes

    from autoware_vision_pilot_tpu_torch.ops.kernels.int8_conv import geometry, out_size

    lib = build_library(pb, pkg / "csrc", [pkg / "csrc" / "int8_conv_strided.cu"],
                        out / "libstamped_strided.so", ("-DAVP_STRIDED_STAMPS",))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.avp_int8_conv_strided.argtypes = [P] * 6 + [I] * 25 + [P]
    lib.avp_int8_conv_strided.restype = I
    stamps = torch.zeros(STAMP_WORDS * 4096, dtype=torch.int64, device="cuda")
    if lib.avp_int8_strided_set_stamps(ctypes.c_void_p(stamps.data_ptr())):
        raise RuntimeError(f"could not set the stamp buffer of {pkg}'s strided kernel")

    def call(xq, weight, w_scale, x_scale, bias, pad, stride, plan):
        B, C, H, W = xq.shape
        N, _, KH, KW = weight.shape
        geo = geometry(pad, stride)
        OH, OW = out_size(H, W, KH, KW, geo)
        out = torch.empty((B, N, OH, OW), dtype=torch.bfloat16, device=xq.device,
                          memory_format=CL)
        m_tiles, n_tiles, cs = plan.grid
        err = lib.avp_int8_conv_strided(
            xq.data_ptr(), weight.data_ptr(), w_scale.data_ptr(), x_scale.data_ptr(),
            bias.data_ptr(), out.data_ptr(), B, H, W, C, N, KH, KW, *geo, 1, plan.th, plan.tw,
            plan.bn, m_tiles, n_tiles, cs, plan.per_split, plan.stages, int(plan.phases[0]),
            int(plan.phases[1]), plan.phases[2], torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"the stamped avp_int8_conv_strided failed: {err}")
        return out

    return call, stamps


def parent_strided(pkg, pb, out):
    """The strided route of the port in ``pkg`` (the earlier form: the
    wgmma kernel's strided variant, avp_int8_conv_wgmma with traversal
    strides)
    as this script calls it: its int8_conv_sm90.cu built alone into a
    library under ``out``, and again with PARENT_STRIDED_STAMPS; its plan
    from its own int8_conv.py. -> {"plan": plan(B, H, W, C, N, KH, KW, pad,
    sms, stride), "call": call(lib, xq, weight, w_scale, x_scale, bias, pad,
    stride, plan) -> bf16 output, "lib", "stamped": (lib, stamps tensor)},
    or None where ``pkg`` has no strided form in that kernel."""
    import ctypes
    import types

    src = pkg / "csrc" / "int8_conv_sm90.cu"
    text = src.read_text()
    if "strided_box" not in text:
        print(f"the parent's strided route: not measured ({src} has no strided form)")
        return None
    for old, new, count in PARENT_STRIDED_STAMPS:
        if text.count(old) != count:
            print(f"the parent's strided stage split: not measured ({old!r} found "
                  f"{text.count(old)} times, not {count})")
            return None
        text = text.replace(old, new)
    copy = out / "stamped_int8_conv_sm90.cu"
    copy.write_text(text)
    plain = build_library(pb, pkg / "csrc", [src], out / "libparent_strided.so")
    stamped = build_library(pb, pkg / "csrc", [copy], out / "libparent_strided_stamped.so",
                            ("-DAVP_D2S_STAMPS",))
    P, I = ctypes.c_void_p, ctypes.c_int
    for lib in (plain, stamped):
        lib.avp_int8_conv_wgmma.argtypes = [P] * 7 + [I] * 21 + [P]
        lib.avp_int8_conv_wgmma.restype = I
    stamped.avp_int8_d2s_set_stamps.argtypes = [P]
    stamps = torch.zeros(STAMP_WORDS * 4096, dtype=torch.int64, device="cuda")
    if stamped.avp_int8_d2s_set_stamps(ctypes.c_void_p(stamps.data_ptr())):
        raise RuntimeError("could not set the stamp buffer of the parent's strided route")
    path = pkg / "ops" / "kernels" / "int8_conv.py"
    mod = types.ModuleType(f"parent_int8_plan_{abs(hash(str(pkg)))}")
    exec(compile(path.read_text().replace("from . import torch_ops\n", ""), str(path), "exec"),
         mod.__dict__)

    def call(lib, xq, weight, w_scale, x_scale, bias, pad, stride, plan):
        from autoware_vision_pilot_tpu_torch.ops.kernels.int8_conv import geometry, out_size
        B, C, H, W = xq.shape
        N, _, KH, KW = weight.shape
        geo = geometry(pad, stride)
        OH, OW = out_size(H, W, KH, KW, geo)
        m_tiles, n_tiles, splits = plan.grid
        out = torch.empty((B, N, OH, OW), dtype=torch.bfloat16, device=xq.device,
                          memory_format=CL)
        ws = (torch.empty(splits * B * OH * OW * N + m_tiles * n_tiles, dtype=torch.int32,
                          device=xq.device) if splits > 1 else None)
        err = lib.avp_int8_conv_wgmma(
            xq.data_ptr(), weight.data_ptr(), w_scale.data_ptr(), x_scale.data_ptr(),
            bias.data_ptr(), out.data_ptr(), None if ws is None else ws.data_ptr(), B, H, W, C,
            N, KH, KW, *geo, 1, plan.th, plan.tw, m_tiles, n_tiles, splits, plan.per_split,
            plan.blocks, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"the parent's avp_int8_conv_wgmma failed: {err}")
        return out

    print(f"the parent's strided route built from {src} (and a stamped copy)")
    return {"plan": mod.int8_conv_plan, "call": call, "lib": plain,
            "stamped": (stamped, stamps)}


def device_us_by_name(fn, inputs):
    """Device microseconds a call of fn(x) by kernel (and memset) name over
    ``inputs``, from one torch.profiler trace."""
    from torch.profiler import ProfilerActivity, profile

    fn(inputs[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for x in inputs:
            fn(x)
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / len(inputs) for e in prof.key_averages()
            if e.self_device_time_total > 0}


def strided_sets(g, kh, kw, cin, cout, h, w):
    """Rotating int8 inputs of a strided conv (xq, weight, w_scale, bias,
    x_scale), together above the L2 where the shape allows. -> (sets,
    indices of about 20 calls)."""
    from autoware_vision_pilot_tpu_torch.ops.kernels.int8_conv import int8_quantize

    set_bytes = h * w * cin + cout * cin * kh * kw
    n = max(2, min(64, math.ceil(1.2 * L2_BYTES / set_bytes)))
    sets = []
    for _ in range(n):
        x = torch.randn(1, cin, h, w, generator=g).to(torch.bfloat16).contiguous(
            memory_format=CL).cuda()
        weight = torch.randint(-127, 128, (cout, cin, kh, kw), generator=g,
                               dtype=torch.int8).contiguous(memory_format=CL).cuda()
        ws = (torch.rand(cout, generator=g) * 1e-3 + 1e-4).cuda()
        b = (torch.randn(cout, generator=g) * 0.1).to(torch.bfloat16).cuda()
        sx = torch.tensor(float(x.float().abs().max()) / 127.0, device="cuda")
        sets.append((int8_quantize(x, sx), weight, ws, b, sx))
    return sets, list(range(n)) * max(1, math.ceil(20 / n))


def phase_strided_parent(card, parent):
    """--parent: the parent's strided route (parent_strided) against this
    tree's on the same int8 inputs, outputs equal, profiler device time in
    turns (parent, this, this, parent) at STRIDED_TIMED's shapes, each
    call's device time by kernel (the parent's split-K memset apart); then
    both stage splits at STRIDED_SPLIT (the parent's by PARENT_STRIDED_STAMPS,
    this tree's stamped_strided), mean ns a block over 4 launches; and the
    main path's 3x3 convs at MAIN_TURNS in the same turns."""
    from autoware_vision_pilot_tpu_torch.kernels import build as this_build
    from autoware_vision_pilot_tpu_torch.ops.kernels.int8_conv import int8_conv, int8_conv_plan

    old = parent[7] if parent is not None and len(parent) > 7 else None
    if old is None:
        return
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    g = torch.Generator().manual_seed(SEED + 23)
    kept = {}
    for kh, kw, cin, cout, h, w, stride, pad, _ in STRIDED_TIMED:
        sets, idx = strided_sets(g, kh, kw, cin, cout, h, w)
        pplan = old["plan"](1, h, w, cin, cout, kh, kw, pad, sms, stride)
        plan = int8_conv_plan(1, h, w, cin, cout, kh, kw, pad, sms, stride)
        fns = {"parent": lambda i: old["call"](old["lib"], sets[i][0], sets[i][1], sets[i][2],
                                               sets[i][4], sets[i][3], pad, stride, pplan),
               "this tree": lambda i: int8_conv(sets[i][0], sets[i][1], sets[i][2], sets[i][4],
                                                sets[i][3], pad, torch.bfloat16, stride=stride)}
        if not torch.equal(fns["parent"](0), fns["this tree"](0)):
            raise AssertionError(f"strided {kh}x{kw} {cin}->{cout} at {h}x{w}: the parent's "
                                 "output differs")
        label = (f"int8 strided {kh}x{kw} {cin}->{cout} at {h}x{w}, stride {stride}, int8 in, "
                 f"bf16 out (parent grid {pplan.grid} rectangle {pplan.th}x{pplan.tw} "
                 f"{pplan.blocks} blocks; this tree {plan.route} {plan_text(plan)})")
        t = alternate(label, fns, idx, card)
        names = {k: device_us_by_name(f, idx) for k, f in fns.items()}
        print(f"{label}, {card}: parent {float(np.mean(t['parent']))!r} us, this tree "
              f"{float(np.mean(t['this tree']))!r} us (mean of two turns each); device us a "
              f"call by kernel: " + "; ".join(
                  f"{k}: " + ", ".join(f"{n} {v!r}" for n, v in d.items())
                  for k, d in names.items()))
        if (kh, kw, cin, cout, h, w, stride, pad) in STRIDED_SPLIT:
            kept[(kh, kw, cin, cout, h, w, stride, pad)] = (sets[:4], pplan, plan)
        del sets
        torch.cuda.empty_cache()
    for k, cin, cout, h, w in MAIN_TURNS:
        sets, idx = strided_sets(g, k, k, cin, cout, h, w)
        pplan = old["plan"](1, h, w, cin, cout, k, k, 1, sms)
        plan = int8_conv_plan(1, h, w, cin, cout, k, k, 1, sms)
        fns = {"parent": lambda i: old["call"](old["lib"], sets[i][0], sets[i][1], sets[i][2],
                                               sets[i][4], sets[i][3], 1, 1, pplan),
               "this tree": lambda i: int8_conv(sets[i][0], sets[i][1], sets[i][2], sets[i][4],
                                                sets[i][3], 1, torch.bfloat16)}
        if not torch.equal(fns["parent"](0), fns["this tree"](0)):
            raise AssertionError(f"{k}x{k} {cin}->{cout} at {h}x{w}: the parent's output differs")
        label = (f"int8 conv {k}x{k} {cin}->{cout} at {h}x{w}, int8 in, bf16 out (parent "
                 f"{pplan.route} grid {pplan.grid}; this tree {plan.route} grid {plan.grid})")
        t = alternate(label, fns, idx, card)
        print(f"{label}, {card}: parent {float(np.mean(t['parent']))!r} us, this tree "
              f"{float(np.mean(t['this tree']))!r} us (mean of two turns each)")
        del sets
        torch.cuda.empty_cache()
    lib, stamps = old["stamped"]
    new_call, new_stamps = stamped_strided(REPO / "autoware_vision_pilot_tpu_torch", this_build,
                                           REPO / "build")
    for key, (sets, pplan, plan) in kept.items():
        kh, kw, cin, cout, h, w, stride, pad = key
        for who, p, names, run in (
                ("the parent's", pplan, OLD_STRIDED_STAGES,
                 lambda s: old["call"](lib, s[0], s[1], s[2], s[4], s[3], pad, stride, pplan)),
                ("this tree's", plan, STRIDED_STAGES,
                 lambda s: new_call(s[0], s[1], s[2], s[4], s[3], pad, stride, plan))):
            bufs = stamps if who == "the parent's" else new_stamps
            runs = [stage_split(None, bufs, p, lambda _, s=s: run(s), len(names)) for s in sets]
            mean = np.mean([r[0] for r in runs], axis=0)
            print(f"{who} strided stage split {kh}x{kw} {cin}->{cout} at {h}x{w}, stride "
                  f"{stride}, grid {p.grid}, {p.blocks} blocks, {card} (ns a block, mean over "
                  f"the blocks x {len(runs)} launches, clock64 laps of the first consumer "
                  f"thread scaled by %globaltimer): " + ", ".join(
                      f"{n} {v:.0f}" for n, v in zip(names, mean))
                  + f"; first stamp to last {np.mean([r[1] for r in runs]):.0f} (slowest "
                  f"block {np.mean([r[2] for r in runs]):.0f})")
    del kept
    torch.cuda.empty_cache()


def plan_text(plan):
    """A strided plan in a few words."""
    return (f"grid {plan.grid}, rectangle {plan.th}x{plan.tw}, bn {plan.bn}, "
            f"{plan.blocks} blocks")


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
    """Device time of parent, new, new, parent in turns (``fns``: name ->
    fn); prints each. The turns are read by the profiler (device_us); where
    it fell back to queued events on some turns and not others, every turn
    is taken again from queued events, so that the means compare like with
    like. -> {name: [us, us]}, each a DeviceUs."""
    def turns(timer):
        times = {name: [] for name in fns}
        for name in (*fns, *reversed(list(fns))):
            times[name].append(timer(fns[name], inputs))
            print(f"{label} {name}, {card}: {times[name][-1]!r} us ({times[name][-1].how})")
        return times

    times = turns(device_us)
    if len({u.how for v in times.values() for u in v}) > 1:
        print(f"{label}: the turns were read two ways; every turn again from queued events")
        times = turns(lambda fn, xs: DeviceUs(queued_us(fn, xs), "q"))
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
    print(f"kernel lane_filter_walk {h}x{w}, {card}: {us!r} us ({us.how}; "
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


def offset_frames(n, hw, offset, seed, gap=0):
    """n seeded (H, W, 3) frames on the card, each starting ``offset``
    bytes past a 16-byte boundary, ``gap`` bytes apart (a view of one
    buffer: frame_stride = H W 3 + gap)."""
    H, W = hw
    stride = H * W * 3 + gap
    rng = np.random.default_rng(seed)
    buf = torch.from_numpy(rng.integers(0, 256, n * stride + 32, dtype=np.uint8)).cuda()
    base = (16 - buf.data_ptr() % 16) % 16 + offset
    return torch.as_strided(buf, (n, H, W, 3), (stride, 3 * W, 3, 1), base)


LETTERBOX_OFFSETS = (1, 5, 15)  # bytes past 16 of phase 11's offset frames


def phase_letterbox(card):
    """The letterbox kernel bit-equal to its plain version at
    LETTERBOX_SIZES, then on frames 1, 5 and 15 bytes past 16 (one, and a
    batch of three frame_stride bytes apart) at 720p and the KITTI size, in
    f32 and bf16; its time at each size, bound at 720p, and the plain
    version's time. -> the JSON record."""
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
                  f"{str(dtype)[6:]} (scale {scale!r}, pad {pad}), {card}: max_abs_err {err!r} "
                  f"(tol 0: bit-equal); kernel {us!r} us ({us.how}), plain {plain_us!r} us "
                  f"({plain_us.how})")
            if not bits_equal(out, ref):
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
    checked = 0
    for hw, out_hw in LETTERBOX_SIZES[:2]:
        for offset in LETTERBOX_OFFSETS:
            for n, gap in ((1, 0), (3, 7)):
                batch = offset_frames(n, hw, offset, SEED + offset + n, gap)
                for dtype in (torch.float32, torch.bfloat16):
                    out = fused_letterbox(batch, out_hw, dtype)[0]
                    ref = letterbox(batch, out_hw, hw, dtype=dtype)[0].permute(0, 3, 1, 2)
                    if not bits_equal(out, ref):
                        raise AssertionError(f"fused_letterbox on {n} {hw} frame(s) {offset} "
                                             f"bytes past 16 ({dtype}) disagrees")
                    checked += 1
    print(f"kernel fused_letterbox on frames {LETTERBOX_OFFSETS} bytes past 16 bytes, one and "
          f"three {LETTERBOX_SIZES[0][0]} and {LETTERBOX_SIZES[1][0]} frames (the three "
          f"frame_stride = H W 3 + 7 apart), f32 and bf16: {checked} launches bit-equal to the "
          "plain version")
    return record


# (source, streams, frames in the pool) of --parent's letterbox turns:
# 720p at N = 1 and the fleet's N = 8, and the KITTI size; each pool past
# the L2
LETTERBOX_TURNS = ((FRAME_HW, 1, 32), (FRAME_HW, 8, 4), (ODD_HW, 1, 48))


def letterbox_split(mod, stamps, batch, blocks):
    """One launch of a stamped letterbox (``mod``'s fused_letterbox) on
    ``batch``: -> (mean ns by LB_STAGES over the blocks that ran each stage
    (image blocks, pad blocks), mean ns from a block's first stamp to its
    last, ns from the launch's first stamp to its last)."""
    stamps.zero_()
    mod.fused_letterbox(batch, LON_HW)
    torch.cuda.synchronize()
    t = stamps[:STAMP_WORDS * blocks].view(blocks, STAMP_WORDS).cpu().numpy().astype(np.float64)
    t = t[t[:, 0] > 0]  # blocks whose stamping warp ran
    span = t[:, 1] - t[:, 0]
    stages = t[:, 3:7] * (span / np.maximum(t[:, 2], 1))[:, None]
    ran = np.maximum((stages > 0).sum(axis=0), 1)
    return stages.sum(axis=0) / ran, float(span.mean()), float(t[:, 1].max() - t[:, 0].min())


def phase_letterbox_parent(card, parent):
    """--parent: the parent's letterbox (its own wrapper and kernel) against
    this tree's on the same bf16 720p and KITTI inputs, outputs equal, device
    time in turns (parent, this, this, parent) at LETTERBOX_TURNS; then each
    one's stage split from stamped copies (stamped_letterbox), over 8
    launches at 720p, N = 1 and 8. -> {(source, N): {name: mean us}}."""
    from autoware_vision_pilot_tpu_torch.kernels import build as this_build
    from autoware_vision_pilot_tpu_torch.ops.kernels import preprocess_kernel as ours

    theirs = parent[5]
    if theirs is None:
        return {}
    times = {}
    for hw, n, count in LETTERBOX_TURNS:
        pool = [frames(n, hw, SEED + 40 + i).cuda() for i in range(count)]
        if n == 1:
            pool = [x[0] for x in pool]
        fns = {name: (lambda x, m=mod: m.fused_letterbox(x, LON_HW)[0])
               for name, mod in (("parent", theirs), ("this tree", ours))}
        if not bits_equal(fns["parent"](pool[0]), fns["this tree"](pool[0])):
            raise AssertionError(f"letterbox {hw} N = {n}: the parent's output differs")
        label = f"letterbox {hw[0]}x{hw[1]} -> {LON_HW[0]}x{LON_HW[1]} bf16, N = {n}"
        t = alternate(label, fns, pool, card)
        times[(hw, n)] = {k: float(np.mean(v)) for k, v in t.items()}
        hows = sorted({u.how for v in t.values() for u in v})
        print(f"{label}, {card}: parent {times[(hw, n)]['parent']!r} us, this tree "
              f"{times[(hw, n)]['this tree']!r} us (mean of two turns each; read by {hows})")
        del pool
    stamped = {"parent": parent[6],
               "this tree": stamped_letterbox(REPO / "autoware_vision_pilot_tpu_torch",
                                              this_build, REPO / "build")}
    for n in (1, 8):
        batches = [frames(n, FRAME_HW, SEED + 60 + i).cuda() for i in range(8)]
        for name, st in stamped.items():
            if st is None:
                continue
            mod, stamps, grid, stages = st
            blocks = grid(n)
            runs = [letterbox_split(mod, stamps, x, blocks) for x in batches]
            split = np.mean([r[0] for r in runs], axis=0)
            print(f"{name}'s letterbox stage split, 720p -> 640x640 bf16, N = {n}, {card} (ns a "
                  f"block, mean over the blocks of {blocks} that ran each stage x {len(runs)} "
                  "launches, clock64 laps of thread 0 scaled by %globaltimer): "
                  + ", ".join(f"{stage} {v:.0f}" for stage, v in zip(stages, split))
                  + f"; a block's first stamp to its last {np.mean([r[1] for r in runs]):.0f}; "
                  f"the launch's first stamp to its last {np.mean([r[2] for r in runs]):.0f}")
        del batches
    torch.cuda.empty_cache()
    return times


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


def nms_ops(top, class_aware, conf=CONF):
    """The f32 operations the NMS kernel must do on these candidates: the
    IoU tests of every pair i < j whose row i is above the threshold
    ``conf`` (and of one class, class-aware), and the areas."""
    boxes, scores, cls = top
    live = scores >= conf
    pairs = live[:, None] & torch.ones(len(scores), len(scores), dtype=torch.bool,
                                       device=scores.device).triu(1)
    if class_aware:
        pairs &= cls[:, None] == cls[None, :]
    return int(pairs.sum()) * IOU_OPS + 4 * len(scores)


# (k, kind) of phase 13's edge sets: every cluster size 1, 2, 4 and 8 and
# the one the wrapper picks at k = 1, 31, 32, 33, 255, 256, 257, 1024, 1025,
# 1200 (the detection validation's k) and the kernel's MAX_K, 1248, on
# random live boxes, all candidates below the threshold, all live on
# degenerate clamped boxes with tied scores (as seeded AutoSpeed gives),
# and NaN coordinates
NMS_EDGE_K = (1, 31, 32, 33, 255, 256, 257, 1024, 1025, 1200, 1248)
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
             ("letterbox (the letterbox kernel)", ("letterbox_kernel",)),
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
    print(f"{label}, {card}: N = 8 {us8!r} us a launch ({us8.how}) against 8 x N = 1 "
          f"{8 * us1!r} us (N = 1: {us1!r} us, {us1.how})")
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
    distinct 720p frames from a host source, at pipeline depth 1 and 2 (the
    app loop of phase 43 sweeps depths 1-8), every dispatch under
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
    for depth in (1, 2):
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
        if depth == 1:  # phase 43 prints its app loop at depth 1 beside the first run
            LATENCY.setdefault("engine", (*host_p, ENGINE_FRAMES / wall))
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
    LATENCY["fleet"] = host_p
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
    new_shapes = MIN128_INT8 if new_shapes is None else new_shapes
    checked, bad = [], []

    def hook(m, args, y):
        if m.input_scale is None:
            raise AssertionError(f"an int8 conv of {name} has no static scale")
        x = args[0]
        ref = plain_of(m, x)
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
            "int8_conv_dot", "int8_conv_halo")
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
                    routes["pointwise"], "int8_conv_dot": routes["dot"], "int8_conv_halo": 0}
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
                    "int8_conv_halo": 0}
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
                "int8_conv_halo": 0}
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


# ---------- the int8 remainder and the importers ----------

# (cin, cout, h, w, per frame): the main path's int8 transposed convs (k = s
# = 2) at 320x640 with quantize_transpose=True, 11 a frame: SceneNeck and
# DepthNeck 1280, 768, 512; EgopathNeck 1456, 768, 512; both heads' 256
MAIN_TRANSPOSES = ((1280, 1280, 10, 20, 2), (1456, 1456, 10, 20, 1), (768, 768, 20, 40, 3),
                   (512, 512, 40, 80, 3), (256, 256, 80, 160, 2))
# (cin, cout, k, h, w, batch) checked bit for bit in every variant: the five
# above, then O = 3, O = 12 and 20 (stored value by value), C = 200 (K not a
# multiple of 128 or 16: padded), K = 1456 at a batch of two, and split-K
TRANSPOSE_SHAPES = tuple((c, o, 2, h, w, 1) for c, o, h, w, _ in MAIN_TRANSPOSES) + (
    (64, 3, 2, 5, 7, 1), (48, 12, 3, 6, 9, 2), (200, 20, 2, 13, 7, 1), (1456, 1456, 2, 10, 20, 2),
    (1456, 64, 2, 4, 4, 1))  # the last: one output tile, K split over 3 blocks
TRANSPOSE_RECORD = (256, 256, 80, 160)  # the shape the JSON line reports
INT8_TRANSPOSES = 11


def transpose_inputs(g, shape, dtype):
    """Seeded inputs of a transposed conv: x (B, C, h, w) channels_last in
    ``dtype``, int8 (C, O, k, k) weights over a (k, k, O, C) buffer, f32
    per-O scales, a bias in ``dtype``, all on the card."""
    c, o, k, h, w, b = shape
    x = (torch.randn(b, c, h, w, generator=g) * 2).to(dtype)
    weight = torch.randint(-127, 128, (k, k, o, c), generator=g, dtype=torch.int8)
    return (x.cuda().contiguous(memory_format=CL), weight.cuda().permute(3, 2, 0, 1),
            (torch.rand(o, generator=g) * 0.02 + 1e-3).cuda(),
            (torch.randn(o, generator=g) * 0.1).to(dtype).cuda())


def phase_transpose_kernel(card):
    """Phase 29: the int8 transposed conv (the quantize, then the wgmma
    kernel's d2s variant with its depth-to-space TMA-store epilogue)
    against its plain version at TRANSPOSE_SHAPES, f32 and bf16 inputs,
    f32, bf16 and int32 outputs, static and dynamic scales, bit for bit;
    then the five main-path shapes, bf16 with a static scale, over rotating
    inputs past the L2: profiler device time of the pair and of the quantize
    alone (the d2s kernel is their difference), the bounds of the function
    (bf16 in, bf16 out) and of the pair (the int8 activation written and
    read again) and their shares, the plain version's time, and two
    yardsticks the port never calls: cuDNN's bf16 F.conv_transpose2d and
    torch._int_mm on the (M, K) x (K, N) product (accumulators only). ->
    the JSON record."""
    import torch.nn.functional as F
    from autoware_vision_pilot_tpu_torch.ops.kernels.int8_conv import (
        _sm_count, d2s_tma_store, dynamic_input_scale, int8_conv_transpose,
        int8_conv_transpose_plan, int8_quantize, padded_channels)

    g = torch.Generator().manual_seed(SEED + 50)
    worst, checked = 0.0, 0
    for shape in TRANSPOSE_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            x, weight, ws, bias = transpose_inputs(g, shape, dtype)
            for static in (True, False):
                sx = torch.tensor(0.0213, device="cuda") if static else dynamic_input_scale(x)[0]
                for out in (torch.float32, torch.bfloat16, torch.int32):
                    b = bias.to(out) if out != torch.int32 else None
                    got = int8_conv_transpose(x, weight, ws, sx, b, out)
                    want = int8_conv_transpose(x, weight, ws, sx, b, out, plain=True)
                    if not torch.equal(got, want):
                        err = (got.double() - want.double()).abs().max().item()
                        raise AssertionError(f"int8 transpose {shape} {dtype} -> {out} "
                                             f"static={static}: differs by {err}")
                    checked += 1
    print(f"kernel int8_conv_transpose at {len(TRANSPOSE_SHAPES)} shapes (C, O, k, h, w, B) "
          f"{TRANSPOSE_SHAPES}: {checked} launches (f32 and bf16 in; f32, bf16 and int32 out; "
          "static and dynamic scales) bit-equal to the plain version")

    sms = _sm_count(0)
    record = None
    frame_us = {"kernel": 0.0, "cuDNN bf16": 0.0}
    for cin, cout, h, w, per_frame in MAIN_TRANSPOSES:
        M, K, N = h * w, cin, 4 * cout
        plan = int8_conv_transpose_plan(1, h, w, padded_channels(cin), cout, 2, 2, sms)
        set_bytes = M * K * 2 + N * K * 3 + M * N * 2  # x bf16, w int8 + bf16, out bf16
        n = max(2, min(64, math.ceil(1.2 * L2_BYTES / set_bytes)))
        sets = [transpose_inputs(g, (cin, cout, 2, h, w, 1), torch.bfloat16) for _ in range(n)]
        sx = torch.tensor(0.0213, device="cuda")
        idx = list(range(n)) * max(1, math.ceil(20 / n))
        w16 = [(wt.float() * ws.reshape(1, -1, 1, 1)).to(torch.bfloat16) for _, wt, ws, _ in sets]

        def kernel(i):
            x, wt, ws, b = sets[i]
            return int8_conv_transpose(x, wt, ws, sx, b)

        def plain(i):
            x, wt, ws, b = sets[i]
            return int8_conv_transpose(x, wt, ws, sx, b, plain=True)

        def cudnn(i):
            return F.conv_transpose2d(sets[i][0], w16[i], sets[i][3], 2)

        mats = []
        for x, wt, _, _ in sets[:max(1, math.ceil(1.2 * L2_BYTES / (M * K + N * K)))]:
            a = int8_quantize(x, sx).permute(0, 2, 3, 1).reshape(M, K)
            mats.append((a, wt.permute(2, 3, 1, 0).reshape(N, K).t()))  # (K, N) column-major

        t = {"kernel": device_us(kernel, idx), "plain": device_us(plain, [0, 1]),
             "quantize": device_us(lambda i: int8_quantize(sets[i][0], sx), idx),
             "cudnn": device_us(cudnn, idx),
             "int_mm": device_us(lambda i: torch._int_mm(*mats[i % len(mats)]),
                                 list(range(len(mats))) * max(1, math.ceil(20 / len(mats))))}
        ops = 2.0 * M * K * N
        nbytes = M * K * 2 + N * K + M * N * 2 + cout * 6
        bms, by = bound(ops, nbytes)
        pair_bms, pair_by = bound(ops, nbytes + 2 * M * K)  # xq written, then read
        share = bms * 1e3 / t["kernel"] if t["kernel"] > 0 else float("nan")
        d2s_us = t["kernel"] - t["quantize"]
        frame_us["kernel"] += per_frame * t["kernel"]
        frame_us["cuDNN bf16"] += per_frame * t["cudnn"]
        print(f"int8 transpose {cin}->{cout} 2x2 at {h}x{w} -> {2 * h}x{2 * w} (M {M}, K {K}, "
              f"N {N}), {per_frame} per frame, d2s plan {plan.th}x{plan.tw} rectangles grid "
              f"{plan.grid} {plan.blocks} blocks, TMA store {d2s_tma_store(cout, torch.bfloat16)}, "
              f"{card}: quantize + d2s {t['kernel']!r} us ({t['kernel'].how}; quantize "
              f"{t['quantize']!r} us, d2s {d2s_us!r} us), bound of the function {bms * 1e3!r} us "
              f"by {by} ({nbytes / 1e6:.2f} MB, {ops / 1e9:.2f} GOP), share {share!r}; bound of "
              f"the pair {pair_bms * 1e3!r} us by {pair_by}, share "
              f"{pair_bms * 1e3 / t['kernel'] if t['kernel'] > 0 else float('nan')!r}; plain "
              f"{t['plain']!r} us; cuDNN bf16 conv_transpose2d {t['cudnn']!r} us; "
              f"torch._int_mm (M, K) x (K, N) {t['int_mm']!r} us (accumulators only, no "
              f"quantize, no depth to space); rotation {n} input sets, "
              f"{n * set_bytes / 1e6:.1f} MB")
        if (cin, cout, h, w) == TRANSPOSE_RECORD:
            record = dict(max_abs_err=worst, ms=t["kernel"] / 1e3, plain_ms=t["plain"] / 1e3,
                          bound_ms=bms, bound_by=by, library_ms=t["int_mm"] / 1e3)
        del sets, w16, mats
        torch.cuda.empty_cache()
    print(f"int8 transposes per frame from the five shapes x their counts, {card}: "
          + ", ".join(f"{k} {v!r} us" for k, v in frame_us.items()) + " (profiler device time)")
    return record


def phase_int8_transpose(card):
    """Phase 30: the main path in int8 with the transposed convs in int8 too:
    the bf16 FusedPipeline, then quantize_for_int8_conv(net, 256,
    quantize_transpose=True) and calibration on each network (bench.py has
    no option for it: the same two calls bench's int8 path makes, with the
    transposes selected). 72 convs and 11 transposed convs; one frame under
    sync-debug "error"; WARM + TIMED frames with launches by kernel and
    route; each int8 module of one frame against its plain version; p50/p99
    beside phase 8's. -> the launches."""
    from autoware_vision_pilot_tpu_torch.export.quantize import (
        calibrate_int8_activation_scales, int8_conv_count, int8_transpose_count,
        quantize_for_int8_conv)
    from autoware_vision_pilot_tpu_torch.pipeline import build_pipeline_fused, calibration_batches

    t0 = time.perf_counter()
    pipe = build_pipeline_fused("cuda", torch.bfloat16, SEED, CTX_HW, OUT_HW)
    for net in (pipe.stack, pipe.lanes):
        quantize_for_int8_conv(net, 256, quantize_transpose=True)
        calibrate_int8_activation_scales(net, calibration_batches(OUT_HW, torch.bfloat16, "cuda"))
    torch.cuda.synchronize()
    convs = sum(int8_conv_count(n) for n in (pipe.stack, pipe.lanes))
    transposes = sum(int8_transpose_count(n) for n in (pipe.stack, pipe.lanes))
    print(f"int8 + transposes build: {time.perf_counter() - t0:.1f} s, {convs} int8 convs, "
          f"{transposes} int8 transposed convs")
    if (convs, transposes) != (72, INT8_TRANSPOSES):
        raise AssertionError(f"{convs} int8 convs and {transposes} transposes, expected 72 "
                             f"and {INT8_TRANSPOSES}")
    n = WARM + TIMED
    pool = frames(n, FRAME_HW, SEED + 5).cuda()  # phase 8's frames
    pipe(pool[0])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")  # any host sync in the frame raises
    try:
        pipe(pool[1])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    launches = drive(pipe, pool, "int8 + transposes", card)
    # each transposed conv quantizes its input in a launch of its own
    expect_launches(launches, {"fused_preprocess": n,
                               "int8_quantize": (30 + INT8_TRANSPOSES) * n,
                               "int8_conv": 72 * n, "int8_conv_wgmma": 30 * n,
                               "int8_conv_splitk": 12 * n, "int8_conv_pointwise": 22 * n,
                               "int8_conv_dot": 20 * n, "int8_conv_halo": 0,
                               "int8_conv_transpose": INT8_TRANSPOSES * n})
    check_convs_on_path(pipe, pool[2], INT8_TRANSPOSES)
    p50, p99 = LATENCY["int8 + transposes"]
    p50_8, p99_8 = LATENCY["int8"]
    print(f"int8 main path with the transposes in int8 against phase 8's (same call, same "
          f"frames, {card}): p50 {p50!r} ms vs {p50_8!r} ms, p99 {p99!r} ms vs {p99_8!r} ms; "
          "one frame under sync-debug \"error\": no host synchronisation")
    # the two paths in turns (phase 8's rebuilt: int8=True leaves the transposes in bf16)
    paths = {"int8": build_pipeline_fused("cuda", torch.bfloat16, SEED, CTX_HW, OUT_HW,
                                          int8=True, min_ch=256),
             "int8 + transposes": pipe}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    spans = {k: [] for k in paths}
    for name in ("int8", "int8 + transposes", "int8 + transposes", "int8"):
        paths[name](pool[0])
        for i in range(HOST_FRAMES):
            start.record()
            paths[name](pool[WARM + i])
            end.record()
            end.synchronize()
            spans[name].append(start.elapsed_time(end))
    print(f"int8 against int8 + transposes in turns (int8, +T, +T, int8; {HOST_FRAMES} frames "
          f"a turn, CUDA events per frame, {card}): "
          + "; ".join(f"{k} p50 {float(np.median(v))!r} ms, p99 "
                      f"{float(np.percentile(v, 99))!r} ms" for k, v in spans.items()))
    return launches


def phase_quantized_inference(card):
    """Phase 31: export/quantize.py::QuantizedInference of SceneSeg at
    320x640 (seed 0) on the card, f32 input, bf16 dequantize, TF32 off:
    equal to the plain module holding the same dequantized weights, and
    within 1e-3 * max|CPU| of the same wrapper on the CPU; the bytes of
    weights it stores against the f32 parameters'."""
    import copy
    from autoware_vision_pilot_tpu_torch.export.quantize import QuantizedInference
    from autoware_vision_pilot_tpu_torch.inference.infer import load_weights
    from autoware_vision_pilot_tpu_torch.models.scene_seg import SceneSegNetwork
    from autoware_vision_pilot_tpu_torch.ops.kernels.preprocess_kernel import fused_preprocess

    no_tf32()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        model = load_weights(SceneSegNetwork(), device="cuda", dtype=torch.float32)
        qi = QuantizedInference(model, compute_dtype=torch.bfloat16)
        if any(q.device.type != "cuda" for q in qi.q_params.values()):
            raise AssertionError("QuantizedInference keeps its weights off the model's device")
        x = fused_preprocess(frames(1, FRAME_HW, SEED + 51)[0].cuda(), OUT_HW, torch.float32)
        got = qi(x)
        plain = copy.deepcopy(model)
        with torch.no_grad():
            for name, p in plain.named_parameters():
                p.copy_(qi.weights(torch.float32)[name])
            again = plain(x)
        if not torch.equal(got, again):
            raise AssertionError("QuantizedInference differs from the module with its weights")
        cpu = QuantizedInference(load_weights(SceneSegNetwork(), device="cpu",
                                              dtype=torch.float32))
        err, tol = held("QuantizedInference SceneSeg f32 (bf16 weights)", got, cpu(x.cpu()))
        stored = qi.nbytes
        floats = sum(p.numel() * 4 for p in model.parameters())
        print(f"QuantizedInference SceneSeg 320x640 on the card, {card}: equal to the plain "
              f"module with the same dequantized weights; card vs CPU max_abs_err {err!r} (tol "
              f"{tol!r}); weights stored {stored} bytes (int8 values and scales) against "
              f"{floats} bytes of f32 parameters ({stored / floats!r} of them)")
    finally:
        torch.backends.cudnn.deterministic = deterministic


def fold_conv_bn(sd, module):
    """The state_dict ``sd`` of ``module`` with each BatchNorm that follows a
    bias-free conv as index + 1 of a Sequential (ConvBN) folded into it, as
    torch.onnx.export(do_constant_folding=True) fuses them: weight w * g and
    a new conv bias beta - mean * g, g = gamma / sqrt(var + eps); the
    BatchNorm's keys dropped. -> (that state_dict, BatchNorms folded)."""
    from autoware_vision_pilot_tpu_torch.nn.layers import BatchNorm2d, Conv2d
    mods = dict(module.named_modules())
    out = dict(sd)
    folded = 0
    for name, m in mods.items():
        parent, _, idx = name.rpartition(".")
        if not (isinstance(m, BatchNorm2d) and idx.isdigit() and int(idx) > 0):
            continue
        conv = f"{parent}.{int(idx) - 1}"
        if not isinstance(mods.get(conv), Conv2d) or f"{conv}.bias" in sd:
            continue
        g = sd[f"{name}.weight"] / torch.sqrt(sd[f"{name}.running_var"] + m.eps)
        out[f"{conv}.weight"] = sd[f"{conv}.weight"] * g.reshape(-1, 1, 1, 1)
        out[f"{conv}.bias"] = sd[f"{name}.bias"] - sd[f"{name}.running_mean"] * g
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            del out[f"{name}.{leaf}"]
        folded += 1
    return out, folded


def phase_importers(card):
    """Phase 32: the importers on the card. EgoLanes' seed-0 weights written
    as ONNX by save_state_dict_as_onnx, once under their names and once with
    the ConvBN BatchNorms folded into their convs; each imported by
    import_onnx into a fresh network (seed 1) moved to the card: the named
    one's outputs equal the seeded network's, the folded one's within
    1e-3 * max|seeded| (f32, TF32 off). Then eval_lite --onnx on a written
    SceneSegLite file at 320x640 gives the seeded run's summary."""
    from autoware_vision_pilot_tpu_torch.convert import import_onnx, save_state_dict_as_onnx
    from autoware_vision_pilot_tpu_torch.export import eval_lite
    from autoware_vision_pilot_tpu_torch.inference.infer import load_weights
    from autoware_vision_pilot_tpu_torch.models.ego_lanes import EgoLanesNetwork
    from autoware_vision_pilot_tpu_torch.models.lite import build_lite_model
    from autoware_vision_pilot_tpu_torch.nn.layers import init_seeded
    from autoware_vision_pilot_tpu_torch.ops.kernels.preprocess_kernel import fused_preprocess

    out_dir = REPO / "build" / "importers"
    out_dir.mkdir(parents=True, exist_ok=True)
    no_tf32()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        seeded = load_weights(EgoLanesNetwork(), device="cpu", dtype=torch.float32)
        sd = seeded.state_dict()
        seeded.to("cuda")
        x = fused_preprocess(frames(1, FRAME_HW, SEED + 52)[0].cuda(), OUT_HW, torch.float32)
        with torch.no_grad():
            ref = seeded(x)
        folded_sd, folded = fold_conv_bn(sd, EgoLanesNetwork())
        for kind, weights in (("named", sd), ("folded", folded_sd)):
            path = out_dir / f"EgoLanes_{kind}.onnx"
            save_state_dict_as_onnx(weights, path, "EgoLanes")
            fresh = init_seeded(EgoLanesNetwork(), torch.Generator().manual_seed(1))
            fresh.load_state_dict(import_onnx(fresh, path), strict=True)
            fresh.to("cuda", memory_format=CL).eval()
            with torch.no_grad():
                got = fresh(x)
            if kind == "named":
                if not torch.equal(got, ref):
                    raise AssertionError("the named ONNX import differs from the seeded network")
                print(f"importers, {card}: EgoLanes written as ONNX ({len(sd)} initializers, "
                      f"{path.stat().st_size} bytes) and imported into a fresh network on the "
                      "card: outputs equal the seeded network's")
            else:
                err, tol = held("EgoLanes from a BN-folded ONNX", got, ref)
                print(f"importers, {card}: EgoLanes with {folded} ConvBN BatchNorms folded into "
                      f"their convs ({len(weights)} initializers), imported with identity "
                      f"BatchNorm: max_abs_err {err!r} against the seeded network (tol {tol!r})")
            path.unlink()
        name = "SceneSegLite"
        lite = init_seeded(build_lite_model(lite_config(name)), torch.Generator().manual_seed(0))
        path = out_dir / f"{name}.onnx"
        save_state_dict_as_onnx(lite.state_dict(), path, name)
        argv = ["--config", str(REPO / "configs" / f"{name}.yaml"), "--synthetic", "4",
                "--dtype", "bf16"]
        seeded_run = eval_lite.main(argv)
        onnx_run = eval_lite.main(argv + ["--onnx", str(path)])
        path.unlink()
        if onnx_run != seeded_run:
            raise AssertionError(f"eval_lite --onnx {onnx_run} != the seeded run {seeded_run}")
        print(f"eval_lite {name} --onnx (seed-0 weights written as ONNX) at 320x640 bf16 on the "
              f"card, {card}: the seeded run's summary")
    finally:
        torch.backends.cudnn.deterministic = deterministic


# ---------- phases 33-35: the host IPC, the node graph and the app's outputs ----------

IPC_FRAMES = 60


@contextlib.contextmanager
def echo_process(kind, a, b, n):
    """The ``--echo`` process for KIND, once it has opened A and created B;
    waits for it to exit 0 after its N items, and kills it on an error."""
    proc = subprocess.Popen([sys.executable, str(REPO / "chip_smoke.py"), "--echo", kind, a, b,
                             str(n)], stdout=subprocess.PIPE, text=True)
    try:
        if proc.stdout.readline().strip() != "ready":
            raise AssertionError(f"the {kind} echo process did not start")
        yield proc
        if proc.wait(timeout=30) != 0:
            raise AssertionError(f"the {kind} echo process exited with {proc.returncode}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()


def wait_for(fn, what, timeout=10.0):
    """Calls fn() until it returns something other than None."""
    deadline = time.perf_counter() + timeout
    while (got := fn()) is None:
        if time.perf_counter() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        os.sched_yield()
    return got


def phase_host_ipc(card):
    """Phase 33: host/shm.py builds libavp_host.so with g++ from host/src (a
    failed build raises); the C++ state size equals the ctypes struct's; the
    SHM state, IPC_FRAMES distinct seeded 720p frames through the frame ring
    and through an Iox2Service each make a round trip through a second
    process (``--echo``), byte for byte, with p50/p99 of the round trip;
    IPC_FRAMES CIPO messages through Iox2Transport, its topic -> service map
    pointed at pid-named services. Every name holds the pid, so that runs
    side by side on one host, or a run killed midway, leave each other's
    segments alone."""
    import ctypes
    from autoware_vision_pilot_tpu_torch.host import frame_ring, iox2, shm
    from autoware_vision_pilot_tpu_torch.middleware.transport import Iox2Transport, make_transport

    t0 = time.perf_counter()
    lib = shm.build()
    print(f"libavp_host.so built with g++ from host/src in {time.perf_counter() - t0:.1f} s: "
          f"{lib.relative_to(REPO)}")
    native = int(shm._load_lib().avp_shm_state_size())
    if native != ctypes.sizeof(shm.VisionPilotStateStruct):
        raise AssertionError(f"VisionPilotState is {native} bytes in C++, "
                             f"{ctypes.sizeof(shm.VisionPilotStateStruct)} in ctypes")
    rng = np.random.default_rng(SEED + 60)
    pool = [rng.integers(0, 256, (*FRAME_HW, 3), dtype=np.uint8) for _ in range(IPC_FRAMES)]
    trips = {}
    # the state: frame numbers 1..N, every other field seeded
    pid = os.getpid()
    a, b = f"/avp_smoke_state_a_{pid}", f"/avp_smoke_state_b_{pid}"
    us = trips["SHM state (seqlock)"] = []
    with shm.SharedStatePublisher(a) as pub, echo_process("state", a, b, IPC_FRAMES), \
            shm.SharedStateReader(b) as rd:
        for i in range(1, IPC_FRAMES + 1):
            s = shm.VisionPilotStateStruct()
            for field, ctype in s._fields_[2:]:
                setattr(s, field, bool(rng.integers(0, 2)) if ctype is ctypes.c_bool else
                        int(rng.integers(-5, 1000)) if ctype is ctypes.c_int else
                        float(rng.normal(0, 30)))
            s.frame_number = i
            t = time.perf_counter()
            pub.publish(s)
            out = wait_for(lambda: (o if (o := rd.read()).frame_number == i else None),
                           f"state {i}")
            us.append((time.perf_counter() - t) * 1e6)
            if bytes(out)[8:] != bytes(s)[8:]:
                raise AssertionError(f"state {i} came back changed")
    # the frame ring: frame numbers 1..N (a reader never sees 0)
    a, b = f"/avp_smoke_ring_a_{pid}", f"/avp_smoke_ring_b_{pid}"
    slot = FRAME_HW[0] * FRAME_HW[1] * 3
    us = trips["frame ring, 720p"] = []
    with frame_ring.FrameRing(a, owner=True, slot_bytes=slot) as ring, \
            echo_process("ring", a, b, IPC_FRAMES), frame_ring.FrameRing(b) as rd:
        for i, f in enumerate(pool, start=1):
            t = time.perf_counter()
            ring.publish(f, i)
            got, hdr = wait_for(lambda: rd.read_latest(i - 1), f"ring frame {i}")
            us.append((time.perf_counter() - t) * 1e6)
            if hdr.frame_number != i or not np.array_equal(got, f):
                raise AssertionError(f"ring frame {i} came back changed")
    # an Iox2Service carrying RawFrame
    a, b = f"AVPSmoke{pid}/FramesA", f"AVPSmoke{pid}/FramesB"
    us = trips["Iox2Service RawFrame, 720p"] = []
    with iox2.Iox2Service(a, iox2.RawFrameStruct, create=True) as pub, \
            echo_process("iox2", a, b, IPC_FRAMES), \
            iox2.Iox2Service(b, iox2.RawFrameStruct, timeout_ms=10000) as sub:
        for i, f in enumerate(pool):
            t = time.perf_counter()
            iox2.publish_frame(pub, f, i)
            got, hdr = wait_for(lambda: iox2.receive_frame(sub), f"iox2 frame {i}")
            us.append((time.perf_counter() - t) * 1e6)
            if hdr.frame_id != i or not np.array_equal(got, f):
                raise AssertionError(f"iox2 frame {i} came back changed")
    # CIPO messages through the transport, on services of this run's own
    recipe = Iox2Transport._TOPICS
    Iox2Transport._TOPICS = {k: f"AVPSmoke{pid}/{v.split('/')[-1]}" for k, v in recipe.items()}
    tx = rx = None
    try:
        tx = make_transport("iox2", publish_topics=["/cipo"])
        rx = make_transport("iox2")
        got = []
        rx.subscribe("/cipo", got.append)
        for i in range(IPC_FRAMES):
            msg = {"frame_id": i, "exists": bool(i % 3), "track_id": i % 7, "class_id": 1 + i % 3,
                   "distance_m": float(np.float32(rng.uniform(2, 80))),
                   "velocity_ms": float(np.float32(rng.normal(0, 3))),
                   "num_tracked_objects": i % 5}
            tx.publish("/cipo", msg)
            rx.spin_once(timeout=1.0)
            if len(got) != i + 1 or any(got[-1][k] != v for k, v in msg.items()):
                raise AssertionError(f"CIPO message {i} came back as {got[-1:]}")
    finally:
        service = Iox2Transport._TOPICS["cipo"]
        Iox2Transport._TOPICS = recipe
        for t in (tx, rx):
            if t is not None:
                t.close()
    for what, us in trips.items():
        p50, p99 = percentiles(us)
        print(f"{what}: {IPC_FRAMES} round trips through a second process, byte for byte, "
              f"{card}: p50 {p50!r} us, p99 {p99!r} us (host clock, publish to echo read)")
    print(f"Iox2Transport: {IPC_FRAMES} CIPO messages on {service}, every field equal")


class MemoryCapture:
    """cv2.VideoCapture's read() over frames in memory; records when each
    frame was handed out."""

    def __init__(self, frames):
        self.frames = list(frames)
        self.read_at = []

    def read(self):
        if not self.frames:
            return False, None
        self.read_at.append(time.perf_counter())
        return True, self.frames.pop(0)


NODE_PARAMS = {
    "scene_seg": {"ros__parameters": {"model_type": "segmentation", "input_topic": "/image_raw",
                                      "output_topic": "/scene_seg/mask"}},
    "scene_3d": {"ros__parameters": {"model_type": "depth", "input_topic": "/image_raw",
                                     "output_topic": "/scene_3d/depth"}},
    "ego_lanes": {"ros__parameters": {"model_type": "egolanes", "input_topic": "/image_raw",
                                      "output_topic": "/ego_lanes/mask"}},
    "auto_speed": {"ros__parameters": {"model_type": "detection", "input_topic": "/image_raw",
                                       "output_topic": "/auto_speed/detections"}},
}


def phase_node_graph(card):
    """Phase 34: middleware launch_pipeline on an InProcTransport with four
    nodes on one image topic (SceneSeg, Scene3D depth, EgoLanes: bf16
    backends from seed 0; AutoSpeed "n" 640x640 at 0.5/0.5), fed by a
    VideoPublisherNode over IPC_FRAMES distinct seeded 720p frames in
    memory: each message equal to the matching wrapper's result on the same
    frame; each node's p50/p99 from publish to its message. Then
    PathFinderNode -> SteeringControllerNode and LongitudinalControllerNode
    on seeded lane points: the means equal to path_finder_update with a
    generator of the same seed, the commands to the controllers' own.
    -> the graph's launches of the preprocess, letterbox and NMS kernels."""
    from autoware_vision_pilot_tpu_torch.control.steering import SteeringController
    from autoware_vision_pilot_tpu_torch.inference import (AutoSpeedInfer, EgoLanesInfer,
                                                           Scene3DInfer, SceneSegInfer)
    from autoware_vision_pilot_tpu_torch.middleware import (
        InProcTransport, LongitudinalControllerNode, PathFinderNode, SteeringControllerNode,
        VideoPublisherNode, launch_pipeline)
    from autoware_vision_pilot_tpu_torch.perception.path_finder import (BayesState,
                                                                        path_finder_update)

    t = InProcTransport()
    nodes = launch_pipeline(t, NODE_PARAMS)
    topics = {name: p["ros__parameters"]["output_topic"] for name, p in NODE_PARAMS.items()}
    got = {name: [] for name in topics}
    for name, topic in topics.items():
        t.subscribe(topic, lambda m, name=name: got[name].append((time.perf_counter(), m)))
    rng = np.random.default_rng(SEED + 61)
    pool = [rng.integers(0, 256, (*FRAME_HW, 3), dtype=np.uint8) for _ in range(IPC_FRAMES)]
    VideoPublisherNode(t, MemoryCapture(pool[:2])).spin()  # builds and warm-up
    for v in got.values():
        v.clear()
    capture = MemoryCapture(pool)
    torch.cuda.synchronize()
    reset_counts()
    n = VideoPublisherNode(t, capture).spin()
    counts = read_counts()
    expect_launches(counts, {"fused_preprocess": 3 * n, "fused_letterbox": n, "nms_greedy": n,
                             "int8_quantize": 0, "int8_conv": 0})
    if n != IPC_FRAMES or any(len(v) != n for v in got.values()):
        raise AssertionError(f"{n} frames published, messages {[len(v) for v in got.values()]}")
    wrappers = {"scene_seg": SceneSegInfer(dtype=torch.bfloat16),
                "scene_3d": Scene3DInfer(dtype=torch.bfloat16),
                "ego_lanes": EgoLanesInfer(dtype=torch.bfloat16),
                "auto_speed": AutoSpeedInfer(dtype=torch.bfloat16, conf_thresh=0.5,
                                             iou_thresh=0.5)}
    want = {"scene_seg": lambda f: wrappers["scene_seg"].inference(f).astype(np.uint8),
            "scene_3d": lambda f: wrappers["scene_3d"].logits(
                torch.from_numpy(f).cuda())[0, ..., 0].float().cpu().numpy(),
            "ego_lanes": lambda f: wrappers["ego_lanes"].inference(f).astype(np.uint8),
            "auto_speed": wrappers["auto_speed"].inference}
    for name, msgs in got.items():
        for i, (f, (_, msg)) in enumerate(zip(pool, msgs)):
            ref = want[name](f)
            if msg.dtype != ref.dtype or not np.array_equal(msg, ref):
                raise AssertionError(f"{name} node, frame {i}: its message differs from the "
                                     f"wrapper's result")
        lat = [(at - start) * 1e3 for start, (at, _) in zip(capture.read_at, msgs)]
        p50, p99 = percentiles(lat)
        print(f"node graph {name} ({type(nodes[name]).__name__}, subscriber "
              f"{list(topics).index(name) + 1} of 4 on /image_raw), {n} distinct 720p frames, "
              f"{card}: publish to message p50 {p50!r} ms, p99 {p99!r} ms (host clock); every "
              f"message equal to the wrapper's on the same frame")
    print(f"node graph launches: {counts}")
    # PathFinder and the two controllers on seeded lane points
    t = InProcTransport()
    pf = PathFinderNode(t, seed=SEED + 62)
    steer, lon = SteeringControllerNode(t), LongitudinalControllerNode(t)
    states, cmds = [], {"steer": [], "throttle": [], "brake": []}
    t.subscribe("/pathfinder/tracked_states", states.append)
    for topic, key in (("/vehicle/steering_cmd", "steer"), ("/vehicle/throttle_cmd", "throttle"),
                       ("/vehicle/brake_cmd", "brake")):
        t.subscribe(topic, cmds[key].append)
    state, generator = BayesState.init(device="cuda"), torch.Generator("cuda").manual_seed(
        SEED + 62)
    ref_sc = SteeringController(0.33, 0.11, -0.40, 1.0)
    lanes = []
    for i in range(IPC_FRAMES):
        ys = np.sort(rng.uniform(0, 25, 16))
        left = [(1.8 + 0.01 * i + rng.normal(0, 0.05), y) for y in ys]
        right = [(-1.7 + rng.normal(0, 0.05), y) for y in ys]
        lanes.append((left, right))
        t.publish("/egoLaneL", left)
        t.publish("/egoLaneR", right)
        t.publish("/carla/hero/imu", {"linear_acceleration": {"x": float(rng.normal(0, 1))}})
        t.publish("/egoPath", [(0.0, 1.0)])
        t.publish("/hero/odom", {"twist": {"linear": {"x": float(rng.uniform(0, 15))}}})
        lp, lm = pf._pack(left)
        rp, rm = pf._pack(right)
        _, state = path_finder_update(state, lp, lm, rp, rm, torch.zeros((), device="cuda"),
                                      generator=generator)
        if not np.array_equal(states[-1], state.mean.cpu().numpy()):
            raise AssertionError(f"PathFinderNode tick {i}: means differ from "
                                 f"path_finder_update with the same generator")
        angle = ref_sc.compute_steering(float(states[-1][3]), float(states[-1][7]),
                                        float(states[-1][11]))
        if cmds["steer"][-1] != angle:
            raise AssertionError(f"steering node tick {i}: {cmds['steer'][-1]} != {angle}")
    if not (len(cmds["throttle"]) == len(cmds["brake"]) == IPC_FRAMES and
            np.isfinite(cmds["throttle"] + cmds["brake"] + cmds["steer"]).all()):
        raise AssertionError(f"controller commands {cmds}")
    print(f"PathFinderNode on the card ({IPC_FRAMES} ticks of seeded lane points): means equal "
          f"to path_finder_update with the same generator; lane width "
          f"{float(states[-1][12])!r} m, cte {float(states[-1][3])!r} m; steering and "
          f"longitudinal nodes: {IPC_FRAMES} commands each, steering equal to "
          f"SteeringController's")
    del nodes, wrappers
    torch.cuda.empty_cache()
    return {k: counts[k] for k in ("fused_preprocess", "fused_letterbox", "nms_greedy")}


def timed_call(fn, times):
    """fn, with each call's host time in ms appended to ``times``."""
    def call(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        times.append((time.perf_counter() - t0) * 1e3)
        return out
    return call


class TimedWriter:
    """A cv2.VideoWriter whose write() times are appended to ``times``."""

    def __init__(self, writer, times):
        self.writer = writer
        self.write = timed_call(writer.write, times)

    def release(self):
        self.writer.release()


def phase_app_outputs(card):
    """Phase 35: app.py::AppOutputs (the app's sink) on build_engine(Config())
    in bf16 over ENGINE_FRAMES distinct 720p host frames at pipeline depth
    2, every dispatch and every sink call under sync-debug "error": the SHM
    state published to a pid-named segment and read back after each frame
    equal to its FrameResult's fields, the CSV, Rerun (a no-op without the
    SDK), and where cv2 imports the composite and the MJPG video (read back:
    ENGINE_FRAMES frames of 1280x720). Then the host-loop p50 with these
    outputs and with no sink, in four turns (none, outputs, outputs, none),
    20 frames each, and the p50 of the
    sink's parts (composite, video write, SHM publish, CSV row). -> the
    launches."""
    import csv
    import tempfile
    from autoware_vision_pilot_tpu_torch.app import AppOutputs, build_engine
    from autoware_vision_pilot_tpu_torch.host.shm import SharedStatePublisher, SharedStateReader
    from autoware_vision_pilot_tpu_torch.runtime.config import Config
    from autoware_vision_pilot_tpu_torch.runtime.pipeline import PipelineEngine, _sync_debug
    from autoware_vision_pilot_tpu_torch.utils import visualization

    has_cv2 = visualization.cv2 is not None
    rng = np.random.default_rng(SEED + 63)
    host = [rng.integers(0, 256, (*FRAME_HW, 3), dtype=np.uint8) for _ in range(ENGINE_FRAMES)]
    with tempfile.TemporaryDirectory() as tmp:
        def config(tag):
            cfg = Config()
            cfg.target_fps = 0.0
            cfg.output.csv_log_path = f"{tmp}/{tag}.csv"
            cfg.rerun.enabled, cfg.rerun.spawn_viewer = True, False
            cfg.rerun.save_path = f"{tmp}/{tag}.rrd"
            cfg.output.save_video = has_cv2
            cfg.output.output_video_path = f"{tmp}/{tag}.avi"
            return cfg

        cfg = config("run")
        state = f"/avp_smoke_app_state_{os.getpid()}"
        outputs = AppOutputs(cfg, shm=SharedStatePublisher(state))
        print(f"app outputs: cv2 {'imported' if has_cv2 else 'missing'}, Rerun "
              f"{'logging' if outputs.rerun_on else 'a no-op'}; outputs on: SHM, CSV"
              + (", composite, MJPG video" if has_cv2 else "")
              + (", Rerun" if outputs.rerun_on else ""))
        reader = SharedStateReader(state)
        mismatches = []

        def sink(res, lat_out, tracking, frame):
            with _sync_debug(True):
                outputs.sink(res, lat_out, tracking, frame)
            s = reader.read()
            want = (res.frame_num, res.steering_deg, res.cte, res.yaw_error, res.lane_departure,
                    res.cipo_distance >= 0, max(res.cipo_distance, 0.0), res.cipo_velocity,
                    res.cut_in, res.kalman_reset, res.set_speed, res.fcw, res.aeb,
                    res.accel_effort, False)
            have = (s.frame_number, s.steering_pid_deg, s.cte_m, s.yaw_error_rad,
                    s.lane_departure_warning, s.cipo_exists, s.cipo_distance_m,
                    s.cipo_velocity_ms, s.cut_in_detected, s.kalman_reset, s.ideal_speed_ms,
                    s.fcw_active, s.aeb_active, s.control_effort_ms2, s.can_valid)
            if have != want or not np.isnan(s.ego_speed_ms):
                mismatches.append((res.frame_num, have, want))

        it = iter(host)
        engine = build_engine(cfg, lambda: next(it, None), sink=sink, dtype=torch.bfloat16)
        engine.warmup()
        torch.cuda.synchronize()
        reset_counts()
        try:
            results = engine.run(pipeline_depth=2, sync_check=True)
        finally:
            reader.close()
            outputs.close()
        counts = read_counts()
        expect_launches(counts, {k: ENGINE_FRAMES for k in ("fused_preprocess",
                                                             "lane_filter_walk",
                                                             "fused_letterbox", "nms_greedy")})
        if [r.frame_num for r in results] != list(range(ENGINE_FRAMES)) or mismatches:
            raise AssertionError(f"SHM reads differ from the FrameResults: {mismatches[:3]}")
        rows = list(csv.DictReader(open(cfg.output.csv_log_path)))
        if [int(r["frame"]) for r in rows] != list(range(ENGINE_FRAMES)):
            raise AssertionError(f"the CSV has frames {[r['frame'] for r in rows]}")
        if has_cv2:
            cap = visualization.cv2.VideoCapture(cfg.output.output_video_path)
            shapes = []
            while (f := cap.read())[0]:
                shapes.append(f[1].shape)
            cap.release()
            if shapes != [(720, 1280, 3)] * ENGINE_FRAMES:
                raise AssertionError(f"the video reads back as {len(shapes)} frames "
                                     f"{set(shapes)}")
        print(f"app outputs over {ENGINE_FRAMES} frames, {card}: {ENGINE_FRAMES} SHM reads "
              f"equal to their FrameResults, {len(rows)} CSV rows"
              + (f", the video {ENGINE_FRAMES} frames of 1280x720" if has_cv2 else "")
              + f"; no host sync in any dispatch or sink call (sync-debug \"error\"); "
              f"launches {counts}")
        # the outputs' host cost: the host loop with and without them, in turns,
        # and the sink's parts timed on the host clock
        loops = {"no sink": [], "app outputs": []}
        parts = {"composite": [], "video write": [], "SHM publish": [], "CSV row": []}
        turns = ("no sink", "app outputs", "app outputs", "no sink")
        for turn, kind in enumerate(turns):
            it = iter(host[:20])
            turn_outputs = AppOutputs(config(f"turn{turn}"), shm=SharedStatePublisher(state)) \
                if kind == "app outputs" else None
            if turn_outputs:
                turn_outputs.compose = timed_call(turn_outputs.compose, parts["composite"])
                turn_outputs.publish_state = timed_call(turn_outputs.publish_state,
                                                        parts["SHM publish"])
                turn_outputs.csv_log.log = timed_call(turn_outputs.csv_log.log,
                                                      parts["CSV row"])
                if turn_outputs.writer is not None:
                    turn_outputs.writer = TimedWriter(turn_outputs.writer,
                                                      parts["video write"])
            eng = PipelineEngine(cfg, engine.lateral, engine.longitudinal, engine.object_finder,
                                 lambda: next(it, None),
                                 sink=turn_outputs.sink if turn_outputs else None)
            eng.metrics = type(eng.metrics)(report_every=10 ** 9)
            try:
                eng.run(pipeline_depth=2)
            finally:
                if turn_outputs:
                    turn_outputs.close()
            loops[kind] += eng.metrics.e2e_samples[2:]
        p = {k: percentiles(np.asarray(v) * 1e3) for k, v in loops.items()}
        print(f"host loop with the app outputs against without a sink (phase 17's engine), "
              f"depth 2, 20 frames a turn, turns none/outputs/outputs/none, "
              f"{len(loops['no sink'])} and {len(loops['app outputs'])} samples, {card}: p50 "
              f"{p['app outputs'][0]!r} ms against {p['no sink'][0]!r} ms, the outputs' host "
              f"cost {p['app outputs'][0] - p['no sink'][0]!r} ms a frame; p99 "
              f"{p['app outputs'][1]!r} against {p['no sink'][1]!r} ms")
        print(f"the app sink's parts over those {20 * turns.count('app outputs')} frames "
              f"(host clock), {card}: " + "; ".join(
            f"{k} p50 {percentiles(v)[0]!r} ms" for k, v in parts.items() if v))
    del engine
    torch.cuda.empty_cache()
    return {k: counts[k] for k in ("fused_preprocess", "lane_filter_walk", "fused_letterbox",
                                   "nms_greedy")}


# ---------- phase 36: training on the card ----------

TRAIN_F32_HW = (128, 256)  # phase 36a: full depth, a smaller input for the CPU's side
TRAIN_HW, TRAIN_BATCH, TRAIN_WARM, TRAIN_TIMED = (320, 640), 16, 3, 20
QAT_MIN_CHANNELS = 32


def train_step_once(net, images, ids, seed, **kw):
    """One make_seg_train_step step of ``net`` (AdamW 1e-4, the weighted
    CE) with masks from a CPU generator seeded ``seed`` -> (loss, the
    gradients by name, the module's state after the step)."""
    from autoware_vision_pilot_tpu_torch.train import (create_seg_train_state,
                                                       make_seg_train_step,
                                                       segmentation_ce_loss)
    from autoware_vision_pilot_tpu_torch.train.train_step import adamw

    state = create_seg_train_state(net, adamw(1e-4))
    step = make_seg_train_step(segmentation_ce_loss, **kw)
    state, loss = step(state, images, ids, torch.Generator().manual_seed(seed))
    grads = {n: p.grad.detach().clone() for n, p in net.named_parameters()}
    return loss.detach(), grads, {k: t.clone() for k, t in net.state_dict().items()}


def train_batches(n, batch, hw, seed, device):
    """``n`` distinct batches as tools/bench_train.py draws them: images
    N(0.45, 0.22) (normalized floats), class ids 0-2."""
    g = torch.Generator().manual_seed(seed)
    return [((torch.randn(batch, 3, *hw, generator=g) * 0.22 + 0.45).to(device)
             .contiguous(memory_format=CL),
             torch.randint(0, 3, (batch, *hw), generator=g).to(device))
            for _ in range(n)]


def phase_train_f32():
    """Phase 36a: one train step of SceneSeg (full width and depth, at
    TRAIN_F32_HW, batch 2, train mode: batch statistics, the context
    dropout) in f32 on the card with TF32 off against the same step on the
    CPU, the same weights and the same masks (a CPU generator on both
    sides): the loss within 1e-3 * |CPU|, the gradients within 1e-3 * the
    largest CPU gradient, and each parameter and BatchNorm statistic after
    the step within 1e-3 * its max|CPU|."""
    import copy
    from autoware_vision_pilot_tpu_torch.models import SceneSegNetwork
    from autoware_vision_pilot_tpu_torch.nn.layers import init_seeded

    no_tf32()
    ctx = (TRAIN_F32_HW[0] // 32, TRAIN_F32_HW[1] // 32)
    cpu_net = init_seeded(SceneSegNetwork(ctx), torch.Generator().manual_seed(SEED))
    card_net = copy.deepcopy(cpu_net).to("cuda", memory_format=CL)
    (x, ids), = train_batches(1, 2, TRAIN_F32_HW, SEED + 60, "cpu")
    ref = train_step_once(cpu_net, x, ids, SEED + 61)
    got = train_step_once(card_net, x.cuda(), ids.cuda(), SEED + 61)
    err, tol = held("train loss", got[0], ref[0])
    # one bar for all gradients: some are 0 but for rounding (a per-channel
    # shift ahead of a conv and a train-mode BatchNorm), and two runs of the
    # same CPU step already differ there by ~1e-7
    gmax = max(g.abs().max().item() for g in ref[1].values())
    gerr = max((got[1][k].cpu() - g).abs().max().item() for k, g in ref[1].items())
    if not gerr <= 1e-3 * gmax:
        raise AssertionError(f"train step gradients: card and CPU disagree, {gerr} > "
                             f"{1e-3 * gmax}")
    # the BatchNorm statistics the step moved (AdamW moves each weight by
    # about lr in the direction of its gradient's sign, which rounding
    # flips where a gradient is 0 but for rounding: the weights are not held)
    stats = {k: t for k, t in ref[2].items() if k.endswith(("running_mean", "running_var"))}
    worst = 0.0
    for k, t in stats.items():
        e, b = held(f"state {k}", got[2][k], t)
        worst = max(worst, e / b if b else 0.0)
    print(f"train step f32 card vs CPU, SceneSeg full depth {TRAIN_F32_HW[0]}x"
          f"{TRAIN_F32_HW[1]} batch 2, TF32 off, the same masks: loss {float(got[0])!r} vs "
          f"{float(ref[0])!r} (err {err!r}, tol {tol!r}); {len(ref[1])} gradients within "
          f"1e-3 * max|CPU gradient| (max_abs_err {gerr!r}, tol {1e-3 * gmax!r}); "
          f"{len(stats)} BatchNorm statistics after the step within 1e-3 * max|CPU| each "
          f"(worst err / tol {worst:.3f})")


def forward_gflop(net, x):
    """GFLOP of ``net(x)`` counted from the shapes its convs, transposed
    convs and Linears see (2 x multiply-adds; forward hooks), one forward
    without gradients."""
    from autoware_vision_pilot_tpu_torch.nn.layers import Conv2d, ConvTranspose2d, Linear
    flops = []

    def hook(m, args, y):  # weight[0]: the inputs of an output (of an input, transposed)
        n = args[0].numel() if isinstance(m, ConvTranspose2d) else y.numel()
        flops.append(2 * n * m.weight[0].numel())

    handles = [m.register_forward_hook(hook) for m in net.modules()
               if isinstance(m, (Conv2d, ConvTranspose2d, Linear))]
    try:
        with torch.no_grad():
            net(x)
    finally:
        for h in handles:
            h.remove()
    return sum(flops) / 1e9


def phase_train_bench(card):
    """Phase 36b: tools/bench_train.py's configuration on the card:
    SceneSegNetwork at full width and depth, 320x640, batch 16, AdamW(1e-4),
    segmentation_ce_loss, bf16 autocast over f32 weights, channels_last;
    4 distinct seeded batches, TRAIN_WARM + TRAIN_TIMED steps back to back,
    a CUDA event after each: step p50/p99 from the events, samples/s over
    the timed steps, the host's enqueue time a step, the peak of
    max_memory_allocated, a finite final loss; beside them the step's work
    (3 x the forward's FLOPs, forward_gflop) at the bf16 peak. Then, TRAIN_WARM + 10 steps
    each, with EMA 0.999, and with it and microbatches=2 (finite, the EMA
    too); phase 43's bench_train times microbatches=2 alone. -> the p50
    ms."""
    import copy
    from autoware_vision_pilot_tpu_torch.models import SceneSegNetwork
    from autoware_vision_pilot_tpu_torch.nn.layers import init_seeded
    from autoware_vision_pilot_tpu_torch.train import (create_seg_train_state,
                                                       make_seg_train_step,
                                                       segmentation_ce_loss)
    from autoware_vision_pilot_tpu_torch.train.train_step import adamw

    batches = train_batches(4, TRAIN_BATCH, TRAIN_HW, SEED + 62, "cuda")
    seeded = init_seeded(SceneSegNetwork(), torch.Generator().manual_seed(SEED))
    gflop = forward_gflop(copy.deepcopy(seeded).to("cuda", memory_format=CL).eval(),
                          batches[0][0][:1])
    params = sum(p.numel() for p in seeded.parameters())
    step_tflop = 3 * gflop * TRAIN_BATCH / 1e3  # forward, and backward twice its work
    print(f"train work: SceneSeg's forward {gflop!r} GFLOP a {TRAIN_HW[0]}x{TRAIN_HW[1]} "
          f"sample (convs, transposed convs, Linears), {params} parameters; a step of batch "
          f"{TRAIN_BATCH} ~{step_tflop!r} TFLOP, {step_tflop / BF16_OPS_PER_S * 1e15!r} ms at "
          f"the bf16 peak")
    results = {}
    variants = (("", TRAIN_BATCH, TRAIN_TIMED, {}),
                (", EMA 0.999", TRAIN_BATCH, 10, {"ema_decay": 0.999}),
                (", microbatches 2, EMA 0.999", TRAIN_BATCH, 10,
                 {"microbatches": 2, "ema_decay": 0.999}))
    for label, batch, timed, kw in variants:
        net = copy.deepcopy(seeded).to("cuda", memory_format=CL)
        state = create_seg_train_state(net, adamw(1e-4), ema="ema_decay" in kw)
        step = make_seg_train_step(segmentation_ce_loss, compute_dtype=torch.bfloat16, **kw)
        gen = torch.Generator(device="cuda").manual_seed(SEED + 63)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        events = [torch.cuda.Event(enable_timing=True) for _ in range(TRAIN_WARM + timed + 1)]
        enqueue = []
        events[0].record()
        for i in range(TRAIN_WARM + timed):
            x, ids = batches[i % len(batches)]
            t0 = time.perf_counter()
            state, loss = step(state, x[:batch], ids[:batch], gen)
            enqueue.append(time.perf_counter() - t0)
            events[i + 1].record()
        torch.cuda.synchronize()
        steps = [events[i].elapsed_time(events[i + 1])
                 for i in range(TRAIN_WARM, TRAIN_WARM + timed)]
        total = events[TRAIN_WARM].elapsed_time(events[-1])
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        final = float(loss)
        if not math.isfinite(final):
            raise AssertionError(f"train step{label}: non-finite loss {final}")
        if state.ema is not None and not all(torch.isfinite(e).all() for e in state.ema.values()):
            raise AssertionError(f"train step{label}: non-finite EMA")
        p50, p99 = percentiles(steps)
        results[label] = p50
        if not label:
            LATENCY["train step"] = (p50, p99)
        print(f"train step bf16{label}, SceneSeg full width and depth {TRAIN_HW[0]}x"
              f"{TRAIN_HW[1]} batch {batch}, AdamW 1e-4, {card}: p50 {p50!r} ms, p99 "
              f"{p99!r} ms over {timed} steps after {TRAIN_WARM} warm-up (CUDA events between "
              f"steps run back to back), {timed * batch / total * 1e3!r} samples/s, host "
              f"enqueue p50 {1e3 * float(np.median(enqueue[TRAIN_WARM:]))!r} ms a step, peak "
              f"max_memory_allocated {peak!r} GiB, final loss {final!r}")
        del state, step, net
        torch.cuda.empty_cache()
    return results[""]


def phase_qat_export(card):
    """Phase 36c: LegacySegTrainer with qat=True, qat_min_channels
    QAT_MIN_CHANNELS on SceneSeg at 320x640 (two SyntheticSegDatasets, two
    steps of batch 2, f32), then the observers of one QAT forward in eval
    mode (collect_act_scales) and int8_variables_from_qat: the int8 net's
    forward on the card, the launch counts set to 0 just before and read
    just after; every int8 conv of that frame bit-equal to its plain
    version on its own input; the float and the int8 nets through
    save_msgpack / load_msgpack into fresh nets on the card, bit-equal.
    -> the launches."""
    import tempfile
    from autoware_vision_pilot_tpu_torch.convert.from_jax import (state_dict_to_variables,
                                                                   variables_to_state_dict)
    from autoware_vision_pilot_tpu_torch.export.checkpoints import load_msgpack, save_msgpack
    from autoware_vision_pilot_tpu_torch.export.quantize import int8_conv_count
    from autoware_vision_pilot_tpu_torch.models import SceneSegNetwork
    from autoware_vision_pilot_tpu_torch.nn.layers import init_seeded
    from autoware_vision_pilot_tpu_torch.ops.kernels.int8_conv import int8_conv_plan
    from autoware_vision_pilot_tpu_torch.train import LegacySegTrainer, LegacyTrainerConfig
    from autoware_vision_pilot_tpu_torch.train.datasets import SyntheticSegDataset
    from autoware_vision_pilot_tpu_torch.train.qat import (collect_act_scales,
                                                           int8_variables_from_qat, qat_apply)

    t0 = time.perf_counter()
    cfg = LegacyTrainerConfig(num_epochs=1, hw=TRAIN_HW, batch_schedule=(2,), val_every=0,
                              log_every=1, qat=True, qat_min_channels=QAT_MIN_CHANNELS)
    data = [SyntheticSegDataset(2, 0, TRAIN_HW, seed=SEED + s) for s in (64, 65)]
    trainer = LegacySegTrainer(SceneSegNetwork(), data, cfg, seed=SEED, device="cuda")
    history = trainer.train()
    if len(history) != 2 or not all(math.isfinite(l) for _, l in history):
        raise AssertionError(f"QAT trainer: loss history {history}")
    net = trainer.model.eval()
    frame = frames(1, TRAIN_HW, SEED + 66)[0].numpy()
    x = trainer.normalized(frame[None])
    observers = {}
    with torch.no_grad():
        qat_apply(net, x, min_channels=QAT_MIN_CHANNELS, observers=observers)
    int8 = int8_variables_from_qat(net, collect_act_scales(observers), QAT_MIN_CHANNELS)
    torch.cuda.synchronize()
    reset_counts()  # count only this path's launches
    with torch.no_grad():
        out = int8(x)
    torch.cuda.synchronize()
    launches = read_counts()
    check_finite("QAT int8 SceneSeg", [out])
    convs = int8_conv_count(int8)
    expected = {r: 0 for r in ("wgmma", "splitk", "halo", "pointwise", "dot")}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    with torch.no_grad():
        checked = check_int8_convs("QAT export SceneSeg", int8, lambda: int8(x), convs, ())
    for k, c, n, h, w in checked:
        expected[int8_conv_plan(1, h, w, c + -c % 16, n, k, k, (k - 1) // 2, sms).route] += 1
    want = {"int8_conv": convs, "int8_conv_wgmma": expected["wgmma"] + expected["splitk"],
            "int8_conv_splitk": expected["splitk"], "int8_conv_halo": expected["halo"],
            "int8_conv_pointwise": expected["pointwise"], "int8_conv_dot": expected["dot"],
            "int8_quantize": expected["wgmma"] + expected["splitk"] + expected["halo"]}
    expect_launches(launches, want)
    if expected["halo"] <= 0:
        raise AssertionError("the QAT export sent no conv down the halo route")
    with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        other = init_seeded(SceneSegNetwork(), torch.Generator().manual_seed(SEED + 1)).eval()
        for name, model, fresh in (
                ("float", net, SceneSegNetwork()),
                ("int8", int8, int8_variables_from_qat(other, collect_act_scales(observers),
                                                       QAT_MIN_CHANNELS))):
            path = pathlib.Path(tmp) / f"{name}.msgpack"
            save_msgpack(path, state_dict_to_variables(model))
            fresh.load_state_dict(variables_to_state_dict(load_msgpack(path), fresh))
            fresh.to("cuda").eval()
            same = all(torch.equal(t, fresh.state_dict()[k]) for k, t in model.state_dict().items())
            with torch.no_grad():
                same = same and torch.equal(fresh(x), model(x))
            if not same:
                raise AssertionError(f"the {name} net changed through save_msgpack/load_msgpack")
            print(f"QAT {name} SceneSeg through save_msgpack / load_msgpack on the card: "
                  f"{path.stat().st_size} bytes, every tensor and the forward bit-equal")
    print(f"QAT export, {card}: LegacySegTrainer(qat=True, qat_min_channels "
          f"{QAT_MIN_CHANNELS}) 2 steps of batch 2 at {TRAIN_HW[0]}x{TRAIN_HW[1]} (losses "
          f"{[round(l, 4) for _, l in history]}), then int8_variables_from_qat: {convs} int8 "
          f"convs by route {expected}, one frame's launches {launches}; "
          f"{time.perf_counter() - t0:.1f} s")
    del trainer, net, int8
    torch.cuda.empty_cache()
    return {k: launches[k] for k in ("int8_quantize", "int8_conv_wgmma", "int8_conv_pointwise",
                                     "int8_conv_dot", "int8_conv_halo")}


# ---------- phase 37: the remaining trainers on the card ----------

DET_F32_HW = (128, 256)  # phase 37a: a smaller input for the CPU's side
DET_WARM, DET_TIMED, DET_VAL = 3, 10, 2
OTHER_WARM, OTHER_TIMED = 2, 5


def det_samples(n, seed, hw=(360, 640)):
    """``n`` seeded synthetic detection samples: noise images with 2-8
    boxes of the 4 classes (no dataset is in reach on the card)."""
    from autoware_vision_pilot_tpu_torch.train.yolo_data import DetSample
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        k = int(rng.integers(2, 9))
        wh = rng.uniform(20, 200, (k, 2))
        xy = rng.uniform(0, 1, (k, 2)) * (np.array(hw[::-1]) - wh)
        out.append(DetSample(rng.integers(0, 256, (*hw, 3), dtype=np.uint8),
                             np.concatenate([xy, xy + wh], 1), rng.integers(0, 4, k)))
    return out


def det_batches(n, hw, batch, max_boxes, seed, **kw):
    """``n`` YoloBatcher batches over det_samples -> (the batches, the
    host's seconds a batch)."""
    from autoware_vision_pilot_tpu_torch.train.yolo_data import YoloBatcher
    it = iter(YoloBatcher(det_samples(64, seed), input_hw=hw, batch_size=batch,
                          max_boxes=max_boxes, seed=seed, **kw))
    t0 = time.perf_counter()
    out = [next(it) for _ in range(n)]
    return out, (time.perf_counter() - t0) / n


def det_step_once(device, batch, seed):
    """One DetectionTrainer step of AutoSpeed "n" at DET_F32_HW from seed
    ``seed`` on ``device`` -> (loss, the gradients by name, the module's
    state after the step)."""
    from autoware_vision_pilot_tpu_torch.models.auto_speed import AutoSpeedNetwork
    from autoware_vision_pilot_tpu_torch.train.detection_trainer import (DetectionTrainer,
                                                                         DetectionTrainerConfig)
    tr = DetectionTrainer(AutoSpeedNetwork("n", 4, *DET_F32_HW),
                          DetectionTrainerConfig(input_hw=DET_F32_HW, max_boxes=16),
                          seed=seed, device=device)
    loss = tr.fit_step(*batch)
    grads = {n: p.grad.detach().cpu().clone() for n, p in tr.model.named_parameters()}
    return loss.cpu(), grads, {k: t.cpu().clone() for k, t in tr.model.state_dict().items()}


def phase_det_f32():
    """Phase 37a: one detection step (loss, clipping, AdamW at the warm-up's
    lr 0, EMA) in f32 on the card with TF32 off against the same step on
    the CPU, the same seeded weights and batch: the loss within 1e-3 *
    |CPU|, the gradients (clipped) within 1e-3 * the largest CPU gradient,
    and each BatchNorm statistic within 1e-3 * its max|CPU|."""
    no_tf32()
    (batch,), _ = det_batches(1, DET_F32_HW, 2, 16, SEED + 70)
    ref = det_step_once("cpu", batch, SEED + 71)
    got = det_step_once("cuda", batch, SEED + 71)
    err, tol = held("detection loss", got[0], ref[0])
    gmax = max(g.abs().max().item() for g in ref[1].values())
    gerr = max((got[1][k] - g).abs().max().item() for k, g in ref[1].items())
    if not gerr <= 1e-3 * gmax:
        raise AssertionError(f"detection step gradients: card and CPU disagree, {gerr} > "
                             f"{1e-3 * gmax}")
    stats = {k: t for k, t in ref[2].items() if k.endswith(("running_mean", "running_var"))}
    worst = 0.0
    for k, t in stats.items():
        e, b = held(f"state {k}", got[2][k], t)
        worst = max(worst, e / b if b else 0.0)
    print(f"detection step f32 card vs CPU, AutoSpeed n {DET_F32_HW[0]}x{DET_F32_HW[1]} batch "
          f"2, TF32 off: loss {float(got[0])!r} vs {float(ref[0])!r} (err {err!r}, tol "
          f"{tol!r}); {len(ref[1])} gradients within 1e-3 * max|CPU gradient| (max_abs_err "
          f"{gerr!r}, tol {1e-3 * gmax!r}); {len(stats)} BatchNorm statistics within 1e-3 * "
          f"max|CPU| each (worst err / tol {worst:.3f})")


def timed_steps(step, inputs, warm, timed):
    """``step(*inputs[i % len])`` warm + timed times back to back, a CUDA
    event after each -> (p50, p99 ms over the timed ones, their total ms,
    the host's enqueue p50 ms, the last step's output)."""
    events = [torch.cuda.Event(enable_timing=True) for _ in range(warm + timed + 1)]
    enqueue = []
    events[0].record()
    for i in range(warm + timed):
        t0 = time.perf_counter()
        out = step(*inputs[i % len(inputs)])
        enqueue.append(time.perf_counter() - t0)
        events[i + 1].record()
    torch.cuda.synchronize()
    steps = [events[i].elapsed_time(events[i + 1]) for i in range(warm, warm + timed)]
    p50, p99 = percentiles(steps)
    return (p50, p99, events[warm].elapsed_time(events[-1]),
            1e3 * float(np.median(enqueue[warm:])), out)


def val_batches(batches, hw):
    """YoloBatcher batches as validate takes them: the images, and each
    image's valid boxes in xyxy pixels and their classes."""
    h, w = hw
    out = []
    for images, boxes, labels, mask in batches:
        gts, gcs = [], []
        for b in range(len(images)):
            cx, cy, bw, bh = (boxes[b][mask[b]] * [w, h, w, h]).T
            gts.append(np.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], -1))
            gcs.append(labels[b][mask[b]])
        out.append((images, gts, gcs))
    return out


def phase_det_bench(card):
    """Phase 37b: the detection trainer as configs/auto_speed.yaml sets it,
    f32 (the JAX trainer's type) with TF32 off, on seeded synthetic
    YoloBatcher batches; then validate through the NMS kernel. -> the
    validation's launches."""
    from autoware_vision_pilot_tpu_torch.models.auto_speed import AutoSpeedNetwork
    from autoware_vision_pilot_tpu_torch.ops.kernels.nms_kernel import nms_greedy
    from autoware_vision_pilot_tpu_torch.ops.postprocess import nms_greedy_plain
    from autoware_vision_pilot_tpu_torch.train.detection_trainer import (DetectionTrainer,
                                                                         DetectionTrainerConfig)
    from autoware_vision_pilot_tpu_torch.train.lite_trainer import load_experiment_config
    from autoware_vision_pilot_tpu_torch.train.train_step import weights_swapped_in

    no_tf32()
    y = load_experiment_config(REPO / "configs" / "auto_speed.yaml")
    d, t, o = y["dataset"], y["training"], y["optimizer"]
    hw, batch = (d["input_height"], d["input_width"]), t["batch_size"]
    cfg = DetectionTrainerConfig(
        num_classes=y["loss"]["num_classes"], input_hw=hw, max_boxes=d["max_boxes"],
        lr=o["lr"], min_lr_ratio=o["min_lr_ratio"], warmup_steps=t["warmup_steps"],
        max_steps=t["max_steps"], weight_decay=o["weight_decay"], ema_decay=t["ema_decay"],
        grad_clip_norm=t["grad_clip_norm"], gains=y["loss"]["gains"],
        ckpt_dir=str(REPO / "build" / "smoke_autospeed"))
    batches, host_s = det_batches(4, hw, batch, cfg.max_boxes, SEED + 72,
                                  mosaic_prob=d["mosaic_prob"], mixup_prob=d["mixup_prob"])
    tr = DetectionTrainer(AutoSpeedNetwork("n", cfg.num_classes, *hw), cfg, seed=SEED,
                          device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    p50, p99, total, enq, loss = timed_steps(tr.fit_step, batches, DET_WARM, DET_TIMED)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    final = float(loss)
    if not math.isfinite(final) or not all(torch.isfinite(e).all() for e in tr.state.ema.values()):
        raise AssertionError(f"detection trainer: non-finite loss {final} or EMA")
    print(f"detection trainer f32 (TF32 off), AutoSpeed n {hw[0]}x{hw[1]} batch {batch}, "
          f"max_boxes {cfg.max_boxes}, mosaic {d['mosaic_prob']}, mixup {d['mixup_prob']}, lr "
          f"{cfg.lr} warm-up {cfg.warmup_steps}, EMA {cfg.ema_decay}, clip "
          f"{cfg.grad_clip_norm}, {card}: p50 {p50!r} ms, p99 {p99!r} ms over {DET_TIMED} steps "
          f"after {DET_WARM} warm-up (CUDA events, steps back to back), "
          f"{DET_TIMED * batch / total * 1e3!r} samples/s, host enqueue p50 {enq!r} ms a step, "
          f"peak max_memory_allocated {peak!r} GiB, final loss {final!r}; YoloBatcher "
          f"{host_s * 1e3:.1f} ms of host time a batch (made before the timed steps)")
    val = val_batches(batches[:DET_VAL], hw)
    kw = dict(max_det=300, iou_thresh=0.65, conf_thresh=0.001)
    torch.cuda.synchronize()
    reset_counts()  # count only the validation's launches
    map50, map_full = tr.validate(iter(val), conf=0.001, iou=0.65, max_det=300)
    torch.cuda.synchronize()
    launches = read_counts()
    expect_launches(launches, {"nms_greedy": DET_VAL})
    if not (math.isfinite(map50) or math.isnan(map50)):
        raise AssertionError(f"detection validate: mAP {map50}")
    # the same candidates again (EMA weights), the kernel against the plain version
    tops = []
    with weights_swapped_in(tr.model, tr.state.ema), torch.no_grad():
        for images, _, _ in val:
            top = tr.candidates(images, conf=0.001, max_det=300)
            got = nms_greedy(*top, **kw)
            ref = nms_greedy_plain(*top, **kw)
            torch.cuda.synchronize()
            if not all(bits_equal(a, b) for a, b in zip(got, ref)):
                raise AssertionError("the validation's NMS disagrees with its plain version")
            tops.append(top)
    k = tops[0][1].shape[-1]
    live = int((tops[0][1][0] >= 0.001).sum())
    one = tuple(t[0].contiguous() for t in tops[0])
    kernel = lambda top: nms_greedy(*top, **kw)  # noqa: E731
    us = device_us(kernel, [one] * 20)
    batch_us = device_us(kernel, tops * 5)
    plain_us = device_us(lambda top: nms_greedy_plain(*top, **kw), [one])
    ops = nms_ops(one, True, conf=0.001)  # the IoU tests of the live rows, and the areas
    bound_ms, bound_by = bound(ops, k * 24 + 300 * 25, F32_OPS_PER_S)
    print(f"detection validate, {DET_VAL} batches of {batch} at max_det 300, conf 0.001, iou "
          f"0.65: mAP@50 {map50!r}, mAP@[.5:.95] {map_full!r} (random weights); "
          f"{launches['nms_greedy']} NMS launches (one a batch, a stream an image), each "
          f"bit-equal to nms_greedy_plain on the same candidates (k = {k} a stream, {live} of "
          f"them above conf in stream 0)")
    print(f"kernel nms_greedy k={k} (the detection validation's), {card}: {us!r} us a stream "
          f"(profiler device time), {batch_us!r} us a batch of {batch} streams; bound "
          f"{bound_ms * 1e3!r} us by {bound_by} ({ops} f32 operations at 67 TFLOP/s), share "
          f"{bound_ms * 1e3 / us!r}; plain version {plain_us!r} us")
    del tr
    torch.cuda.empty_cache()
    return {"nms_greedy": launches["nms_greedy"]}, dict(us=us, batch_us=batch_us,
                                                         plain_us=plain_us)


def phase_other_trainers(card):
    """Phase 37c: OTHER_WARM + OTHER_TIMED steps of the AutoSteer 2.0,
    AutoDrive, AutoSteer-temporal and Lite trainers at their JAX defaults,
    f32, on seeded synthetic data: finite losses and step p50."""
    from autoware_vision_pilot_tpu_torch.models.lite import build_lite_model
    from autoware_vision_pilot_tpu_torch.train.autodrive_trainer import (AutoDriveTrainer,
                                                                         AutoDriveTrainerConfig)
    from autoware_vision_pilot_tpu_torch.train.autosteer_temporal_trainer import (
        AutoSteerTemporalTrainer, AutoSteerTemporalTrainerConfig)
    from autoware_vision_pilot_tpu_torch.train.autosteer_trainer import (AutoSteerTrainer,
                                                                         AutoSteerTrainerConfig)
    from autoware_vision_pilot_tpu_torch.train.lite_trainer import (LiteTrainer,
                                                                    load_experiment_config)

    rng = np.random.default_rng(SEED + 73)
    hw = (512, 1024)
    results = {}

    def report(name, step, inputs, batch):
        p50, p99, total, enq, loss = timed_steps(step, inputs, OTHER_WARM, OTHER_TIMED)
        value = float(loss)
        if not math.isfinite(value):
            raise AssertionError(f"{name}: non-finite loss {value}")
        results[name] = p50
        print(f"{name} f32, {card}: p50 {p50!r} ms, p99 {p99!r} ms over {OTHER_TIMED} steps "
              f"after {OTHER_WARM} (CUDA events), {OTHER_TIMED * batch / total * 1e3!r} "
              f"samples/s, host enqueue p50 {enq!r} ms, loss {value!r}")

    images = [rng.integers(0, 256, (8, *hw, 3), dtype=np.uint8) for _ in range(2)]
    steer = AutoSteerTrainer(AutoSteerTrainerConfig(input_hw=hw), seed=SEED, device="cuda")
    rows = hw[0] // 8
    t_h = [(rng.random((8, rows, 1, 1)) > 0.3).astype(np.float32) for _ in range(2)]
    report("AutoSteer 2.0 trainer 512x1024 batch 8", steer.fit_step,
           [(im, rng.random(th.shape).astype(np.float32) * th, th)
            for im, th in zip(images, t_h)], 8)
    del steer
    torch.cuda.empty_cache()
    drive = AutoDriveTrainer(AutoDriveTrainerConfig(input_hw=hw), seed=SEED, device="cuda")
    report("AutoDrive trainer 512x1024 batch 8 (two frames a sample)", drive.fit_step,
           [(images[0], images[1], rng.random(8).astype(np.float32),
             rng.uniform(-1, 1, 8).astype(np.float32),
             (rng.random(8) > 0.5).astype(np.float32))], 8)
    del drive
    torch.cuda.empty_cache()
    temporal = AutoSteerTemporalTrainer(AutoSteerTemporalTrainerConfig(), seed=SEED,
                                        device="cuda")
    masks = [((rng.random((32, 80, 160, 6)) > 0.8).astype(np.float32),
              rng.uniform(-30, 30, 32), rng.uniform(-30, 30, 32)) for _ in range(2)]
    report("AutoSteer-temporal trainer 80x160 batch 32", temporal.fit_step, masks, 32)
    del temporal
    cfg = load_experiment_config(REPO / "configs" / "SceneSegLite.yaml")
    cfg["experiment"]["output_dir"] = str(REPO / "build" / "smoke_lite")
    r = cfg["dataset"]["augmentations"]["rescaling"]
    lhw, lb = (r["height"], r["width"]), cfg["dataloader"]["batch_size"]
    nc = cfg["loss"]["num_classes"]
    lite_batches = []
    for _ in range(2):
        lab = rng.integers(0, nc, (lb, *lhw)).astype(np.int32)
        lab[rng.random((lb, *lhw)) < 0.05] = cfg["loss"]["ignore_index"]
        lite_batches.append((rng.integers(0, 256, (lb, *lhw, 3), dtype=np.uint8), lab))

    def cycle():
        while True:
            yield from lite_batches

    # the config's network section sets no output_channels (3 by default, in
    # both packages) while its loss has 19 classes: the head is built with
    # the loss's classes, as a run of this config needs
    lite = LiteTrainer(build_lite_model(cfg, output_channels=nc), cfg, cycle, input_hw=lhw,
                       device="cuda")
    lite.fit(2)  # the user's entry point, two steps
    gen = lite.generator
    step = lambda im, lab: lite.run_step(lite.state, lite.normalized(im), lite.targets(lab),  # noqa: E731
                                         gen)[1]
    report(f"Lite trainer, SceneSegLite.yaml ({cfg['network']['model']}, "
           f"{cfg['network']['backbone']['type']}) {lhw[0]}x{lhw[1]} batch {lb}", step,
           lite_batches, lb)
    lite.close()
    del lite
    torch.cuda.empty_cache()
    return results


# ---------- phase 38: data parallelism and the mesh ----------

DP_HW, DP_BATCH, DP_MICRO = (160, 320), 4, 2  # phase 38b: full-depth SceneSeg, f32
DP_WARM, DP_TIMED = 2, 6  # phase 38a: steps a turn, four turns
MESH_TICKS = 3  # phase 38c's f32 checks


def dp_net(hw, device):
    """SceneSeg at full width and depth for ``hw`` inputs, seeded, on ``device``."""
    from autoware_vision_pilot_tpu_torch.models import SceneSegNetwork
    from autoware_vision_pilot_tpu_torch.nn.layers import init_seeded

    net = init_seeded(SceneSegNetwork((hw[0] // 32, hw[1] // 32)),
                      torch.Generator().manual_seed(SEED))
    return net.to(device, memory_format=CL)


def sgd_step_state(net, images, ids, mesh):
    """One make_seg_train_step step (sgd 0.1, the CE, microbatches
    DP_MICRO, masks from a CPU generator) -> (loss, the state dict on the
    CPU). sgd, not AdamW: AdamW moves a weight by ~lr whatever the sign of a
    gradient that is 0 but for rounding, sgd by the gradient itself."""
    from autoware_vision_pilot_tpu_torch.train import (create_seg_train_state,
                                                       make_seg_train_step,
                                                       segmentation_ce_loss)
    from autoware_vision_pilot_tpu_torch.train.optim import sgd

    state = create_seg_train_state(net, sgd(0.1))
    step = make_seg_train_step(segmentation_ce_loss, mesh=mesh, microbatches=DP_MICRO)
    state, loss = step(state, images, ids, torch.Generator().manual_seed(SEED + 81))
    return float(loss), {k: t.detach().cpu().clone() for k, t in net.state_dict().items()}


def dp_rank(images, ids, ref_path):
    """Phase 38b's rank of a gloo world on cuda:0: the world mesh, and one
    f32 step of its rows of the batch from fresh weights, timed after a
    first step (~17 s of a process's first CUDA work); the state after it
    is held here to the one-process reference state (torch.save'd at
    ``ref_path``) and hashed for the ranks' bit-equality (imports no JAX).
    -> (err, tol) by tensor, the loss, the hash, the step's time, stamps."""
    import hashlib

    from autoware_vision_pilot_tpu_torch.core.mesh import make_mesh

    stamps = {"in the rank": time.time()}
    no_tf32()
    mesh = make_mesh()
    images, ids = images.cuda(), ids.cuda()
    net = dp_net(DP_HW, "cuda")
    stamps["mesh and net"] = time.time()
    sgd_step_state(net, images, ids, mesh)  # the process's first step
    torch.cuda.synchronize()
    stamps["first step"] = time.time()
    net = dp_net(DP_HW, "cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, state = sgd_step_state(net, images, ids, mesh)
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    stamps["second step"] = time.time()
    digest, errors = hashlib.sha256(), {}
    for name, ref in torch.load(ref_path, map_location="cpu").items():
        t = state[name]
        digest.update(t.numpy().tobytes())
        errors[name] = ((t.float() - ref.float()).abs().max().item(),
                        1e-3 * ref.float().abs().max().item())
    return {"rank": mesh.rank, "devices": [str(d) for d in mesh.devices.flat], "loss": loss,
            "errors": errors, "digest": digest.hexdigest(), "s": s, "stamps": stamps}


def phase_dp_world_one(card):
    """Phase 38a: tools/bench_train.py's configuration (SceneSeg, 320x640,
    batch 16, bf16, AdamW 1e-4) through make_seg_train_step(mesh=...) on
    the world mesh of an NCCL world of one process, in turns with the same
    step without a mesh (mesh, none, none, mesh; DP_WARM + DP_TIMED steps a
    turn, CUDA events between steps run back to back): step p50/p99 of
    each beside phase 36b's, finite losses."""
    import copy
    import tempfile

    import torch.distributed as dist
    from autoware_vision_pilot_tpu_torch.core.mesh import make_mesh
    from autoware_vision_pilot_tpu_torch.parallel.distributed import destroy_world, init_world
    from autoware_vision_pilot_tpu_torch.train import (create_seg_train_state,
                                                       make_seg_train_step,
                                                       segmentation_ce_loss)
    from autoware_vision_pilot_tpu_torch.train.train_step import adamw

    batches = train_batches(2, TRAIN_BATCH, TRAIN_HW, SEED + 84, "cuda")
    seeded = dp_net(TRAIN_HW, "cpu")
    times = {"world mesh": [], "no mesh": []}
    with tempfile.TemporaryDirectory() as tmp:
        init_world(1, 0, f"file://{tmp}/store", device="cuda:0")
        try:
            mesh = make_mesh()
            if mesh.group is None or mesh.size != 1 or dist.get_backend() != "nccl":
                raise AssertionError(f"phase 38a: {mesh} on {dist.get_backend()}, expected an "
                                     "NCCL world mesh of 1")
            for label in ("world mesh", "no mesh", "no mesh", "world mesh"):
                net = copy.deepcopy(seeded).to("cuda", memory_format=CL)
                state = create_seg_train_state(net, adamw(1e-4))
                step = make_seg_train_step(segmentation_ce_loss, compute_dtype=torch.bfloat16,
                                           mesh=mesh if label == "world mesh" else None)
                gen = torch.Generator(device="cuda").manual_seed(SEED + 85)
                events = [torch.cuda.Event(enable_timing=True)
                          for _ in range(DP_WARM + DP_TIMED + 1)]
                torch.cuda.synchronize()
                events[0].record()
                for i in range(DP_WARM + DP_TIMED):
                    state, loss = step(state, *batches[i % 2], gen)
                    events[i + 1].record()
                torch.cuda.synchronize()
                times[label] += [events[i].elapsed_time(events[i + 1])
                                 for i in range(DP_WARM, DP_WARM + DP_TIMED)]
                if not math.isfinite(float(loss)):
                    raise AssertionError(f"phase 38a {label}: non-finite loss")
                del state, step, net
                torch.cuda.empty_cache()
        finally:
            destroy_world()
    p36 = LATENCY.get("train step", (float("nan"),) * 2)
    p = {k: percentiles(v) for k, v in times.items()}
    print(f"train step bf16 over the world mesh of an NCCL world of 1, SceneSeg {TRAIN_HW[0]}x"
          f"{TRAIN_HW[1]} batch {TRAIN_BATCH}, AdamW 1e-4, {card}: p50 {p['world mesh'][0]!r} "
          f"ms, p99 {p['world mesh'][1]!r} ms; no mesh in the same turns p50 "
          f"{p['no mesh'][0]!r} ms, p99 {p['no mesh'][1]!r} ms ({2 * DP_TIMED} steps each, "
          f"turns mesh, none, none, mesh); phase 36b's step, no mesh: p50 {p36[0]!r} ms, p99 "
          f"{p36[1]!r} ms")


def dp_batch():
    g = torch.Generator().manual_seed(SEED + 86)
    return (torch.randn(DP_BATCH, 3, *DP_HW, generator=g).contiguous(memory_format=CL),
            torch.randint(0, 3, (DP_BATCH, *DP_HW), generator=g))


def start_dp_world_two():
    """Phase 38b's world, started on a thread after this process has run
    the one-process reference step, whose state goes to the ranks through a
    file: the ranks spend ~30 s starting and loading their CUDA kernels,
    during which 38d and 38c's checks (nothing timed) run here. -> (the
    future of run_world's result, the executor, the start time, the
    reference loss, the file's directory)."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from autoware_vision_pilot_tpu_torch.parallel.distributed import run_world

    no_tf32()
    images, ids = dp_batch()
    ref_loss, ref = sgd_step_state(dp_net(DP_HW, "cuda"), images.cuda(), ids.cuda(), None)
    tmp = tempfile.TemporaryDirectory()
    torch.save(ref, os.path.join(tmp.name, "ref.pt"))
    pool = ThreadPoolExecutor(1)
    return (pool.submit(run_world, dp_rank, 2, images, ids, os.path.join(tmp.name, "ref.pt"),
                        device="cuda:0", backend="gloo", timeout=300),
            pool, time.time(), ref_loss, tmp)


def phase_dp_world_two(card, started):
    """Phase 38b: a gloo world of two processes, both on cuda:0 (NCCL
    refuses two ranks on one card; gloo reduces CUDA tensors), started by
    start_dp_world_two: one f32 step (TF32 off) of SceneSeg at full depth,
    DP_HW, batch DP_BATCH, DP_MICRO microbatches, sgd 0.1, against the same
    step in this process without a mesh: the loss, every weight and every
    BatchNorm statistic within 1e-3 * max|ref|, and the two ranks' states
    bit-equal (their hashes)."""
    future, pool, t0, ref_loss, tmp = started
    try:
        ranks = future.result()
    finally:
        pool.shutdown()
        tmp.cleanup()
    wall = time.time() - t0
    stamps = [{k: round(v - t0, 1) for k, v in r["stamps"].items()} for r in ranks]
    for r, out in enumerate(ranks):
        if out["rank"] != r or out["devices"] != ["cuda:0", "cuda:0"]:
            raise AssertionError(f"phase 38b rank {r}: {out['rank']}, {out['devices']}")
    if ranks[0]["loss"] != ranks[1]["loss"] or ranks[0]["digest"] != ranks[1]["digest"]:
        raise AssertionError("phase 38b: the two ranks' states differ")
    err, tol = held("world of 2 loss", torch.tensor(ranks[0]["loss"]), torch.tensor(ref_loss))
    worst = 0.0
    for k, (e, b) in ranks[0]["errors"].items():
        if not e <= b:
            raise AssertionError(f"world of 2 {k}: it and one process disagree, {e} > {b}")
        worst = max(worst, e / b if b else 0.0)
    print(f"train step f32 over a gloo world of 2 on cuda:0 (one card, two ranks: not a speed "
          f"figure), SceneSeg full depth {DP_HW[0]}x{DP_HW[1]} batch {DP_BATCH}, microbatches "
          f"{DP_MICRO}, sgd 0.1, TF32 off, against the same step without a mesh: loss "
          f"{ranks[0]['loss']!r} vs {ref_loss!r} (err {err!r}, tol {tol!r}); "
          f"{len(ranks[0]['errors'])} weights and BatchNorm statistics within 1e-3 * max|ref| "
          f"each (worst err / tol {worst:.3f}); the ranks' states bit-equal (sha256 "
          f"{ranks[0]['digest'][:16]}...); the step {ranks[0]['s']!r} s / {ranks[1]['s']!r} s "
          f"in the ranks (after a first step), the world {wall:.1f} s from its start, its "
          f"spawn included (seconds from the start by rank: {stamps}), {card}")


class NetRows:
    """A forward hook of phase 38c: "record" keeps each call's output;
    "replay" returns, call by call, the next rows of the recorded outputs
    (a tick's shards ask in stream order); "off" changes nothing."""

    def __init__(self):
        self.calls, self.mode, self.ref, self.pos = [], "record", [], (0, 0)

    def __call__(self, module, args, y):
        if self.mode == "record":
            self.calls.append(y)
        if self.mode != "replay":
            return None
        n = args[0].shape[0]
        k, row = self.pos
        full = self.ref[k]
        rows = lambda t: t[row:row + n]  # noqa: E731
        out = tuple(map(rows, full)) if isinstance(full, tuple) else rows(full)
        row += n
        self.pos = (k + 1, 0) if row == (full[0] if isinstance(full, tuple) else full).shape[0] \
            else (k, row)
        return out


def phase_fleet_mesh_f32():
    """Phase 38c's checks: FleetLateralPipeline and
    FleetLongitudinalPipeline at N = FLEET_N in f32 (TF32 off) over
    MESH_TICKS ticks, the states carried, over a mesh of [cuda:0]
    (bit-equal to no mesh) and of [cuda:0, cuda:0] (two shards of 4)
    against no mesh at phase 18's bars: each network's outputs within 1e-3
    * max|ref|; then, the networks fed the unsharded run's outputs, the
    masks, flags, AutoSteer's angle and the detection tables equal and the
    lane fits within 5e-3 * max|ref|."""
    from autoware_vision_pilot_tpu_torch.core.mesh import make_mesh
    from autoware_vision_pilot_tpu_torch.runtime.config import Config
    from autoware_vision_pilot_tpu_torch.runtime.fleet import (FleetLateralPipeline,
                                                               FleetLongitudinalPipeline)
    from autoware_vision_pilot_tpu_torch.runtime.pipeline import (SCALAR_FIELDS,
                                                                  build_lateral_pipeline,
                                                                  build_longitudinal_pipeline)

    no_tf32()
    n, cfg = FLEET_N, Config()
    one, two = make_mesh(devices=["cuda:0"]), make_mesh(devices=["cuda:0", "cuda:0"])
    lat = build_lateral_pipeline("cuda", torch.float32, SEED)
    lon = build_longitudinal_pipeline("cuda", torch.float32, SEED)
    fs = frames(MESH_TICKS * n, FRAME_HW, SEED + 87).cuda().view(MESH_TICKS, n, *FRAME_HW, 3)
    hooks = {"lanes": NetRows(), "steer": NetRows(), "pred": NetRows()}
    handles = [m.register_forward_hook(hooks[k]) for k, m in
               (("lanes", lat.lanes), ("steer", lat.steer_net), ("pred", lon.net))]

    def run(mesh, mode):
        for h in hooks.values():
            h.mode, h.calls, h.pos = mode, [], (0, 0)
        fleet = FleetLateralPipeline(lat.lanes, lat.steer_net, cfg, n, dtype=torch.float32,
                                     mesh=mesh)
        fleet_lon = FleetLongitudinalPipeline(lon.net, cfg, n, dtype=torch.float32, mesh=mesh)
        states, outs = fleet.init_states(SEED), []
        for tick in range(MESH_TICKS):
            out, states = fleet(fs[tick], states)
            outs.append((out, fleet_lon(fs[tick])))
        return outs

    def same(a, b):
        return all(torch.equal(torch.nan_to_num(a[0][k]), torch.nan_to_num(b[0][k]))
                   for k in a[0]) and torch.equal(a[1], b[1])

    flags = [SCALAR_FIELDS.index(f) for f in ("autosteer_deg", "fused_valid", "path_valid")]
    try:
        ref = run(None, "record")
        for h in hooks.values():
            h.ref = h.calls
        if not all(same(a, b) for a, b in zip(run(one, "off"), ref)):
            raise AssertionError("the fleet over a one-device mesh differs from no mesh")
        run(two, "record")
        worst = {}
        for name, h in hooks.items():
            for k, full in enumerate(h.ref):
                parts = h.calls[2 * k:2 * k + 2]
                if isinstance(full, tuple):
                    full, parts = full[1], [p[1] for p in parts]
                err = (torch.cat(parts) - full).abs().max().item() / full.abs().max().item()
                worst[name] = max(worst.get(name, 0.0), err)
                if not err <= 1e-3:
                    raise AssertionError(f"the {name} network over two shards is {err!r} * "
                                         "max|ref| from no mesh")
        fits = 0.0
        for (out, tables), (want, want_tables) in zip(run(two, "replay"), ref):
            fin = torch.isfinite(want["coeffs"])
            scale = torch.where(fin, want["coeffs"], 0.0).abs().amax(-1, keepdim=True)
            fit = ((torch.where(fin, out["coeffs"], 0.0) - torch.where(fin, want["coeffs"], 0.0))
                   .abs() / scale.clamp_min(1e-30)).max().item()
            fits = max(fits, fit)
            if not (torch.equal(out["lane_masks"], want["lane_masks"])
                    and torch.equal(out["scalars"][:, flags], want["scalars"][:, flags])
                    and torch.equal(torch.isnan(out["coeffs"]), torch.isnan(want["coeffs"]))
                    and fit <= 5e-3 and torch.equal(tables, want_tables)):
                raise AssertionError("the fleet over two shards fed the unsharded networks' "
                                     "outputs differs from no mesh")
    finally:
        for h in handles:
            h.remove()
    print(f"f32 fleet N = {n} over the mesh [cuda:0]: bit-equal to no mesh over {MESH_TICKS} "
          f"ticks; over [cuda:0, cuda:0] (two shards of {n // 2}): networks within "
          f"{worst} * max|ref| (tol 1e-3), fed the unsharded outputs masks, flags and "
          f"AutoSteer equal, lane fits {fits!r} * max|ref| (tol 5e-3), detection tables equal")
    del lat, lon
    torch.cuda.empty_cache()


def phase_fleet_mesh_engine(card):
    """Phase 38c's timing: FleetEngine in bf16 over [cuda:0, cuda:0] (N =
    FLEET_N in two shards) for FLEET_TICKS ticks under sync-debug "error":
    two preprocess, walk, letterbox and NMS launches a tick, tick p50/p99
    beside phase 18's. -> the launch counts."""
    from autoware_vision_pilot_tpu_torch.core.mesh import make_mesh
    from autoware_vision_pilot_tpu_torch.perception.tracking import ObjectFinder
    from autoware_vision_pilot_tpu_torch.runtime.config import Config
    from autoware_vision_pilot_tpu_torch.runtime.fleet import (FleetEngine,
                                                               FleetLateralPipeline,
                                                               FleetLongitudinalPipeline)
    from autoware_vision_pilot_tpu_torch.runtime.pipeline import (build_lateral_pipeline,
                                                                  build_longitudinal_pipeline)

    n, cfg, two = FLEET_N, Config(), make_mesh(devices=["cuda:0", "cuda:0"])
    lat = build_lateral_pipeline("cuda", torch.bfloat16, SEED)
    lon = build_longitudinal_pipeline("cuda", torch.bfloat16, SEED)
    fleet = FleetLateralPipeline(lat.lanes, lat.steer_net, cfg, n, mesh=two)
    fleet_lon = FleetLongitudinalPipeline(lon.net, cfg, n, mesh=two)
    rng = np.random.default_rng(SEED + 88)
    base = rng.integers(0, 256, (n, *FRAME_HW, 3), dtype=np.uint8)
    ticks = [np.roll(base, 41 * t, axis=2) ^ np.uint8(t) for t in range(FLEET_TICKS)]
    stamps = []

    def source(it):
        def next_tick():
            stamps.append(time.perf_counter())
            return next(it, None)
        return next_tick

    def finders():
        return [ObjectFinder(np.eye(3), FRAME_HW[1], FRAME_HW[0]) for _ in range(n)]

    FleetEngine(cfg, fleet, fleet_lon, finders(), frame_source=source(iter(ticks[:3]))).run()
    engine = FleetEngine(cfg, fleet, fleet_lon, finders(), frame_source=source(iter(ticks)))
    stamps.clear()
    torch.cuda.synchronize()
    reset_counts()  # count only this path's launches
    results = engine.run(pipeline_depth=1, sync_check=True)
    counts = read_counts()
    expect_launches(counts, {"fused_preprocess": 2 * FLEET_TICKS,
                             "lane_filter_walk": 2 * FLEET_TICKS,
                             "fused_letterbox": 2 * FLEET_TICKS, "nms_greedy": 2 * FLEET_TICKS,
                             "int8_quantize": 0, "int8_conv": 0})
    if len(results) != FLEET_TICKS or any(len(r) != n for r in results) or not all(
            np.isfinite([x.steering_deg, x.set_speed]).all() for r in results for x in r):
        raise AssertionError("the fleet over two shards: short, out of order or non-finite")
    host_p = percentiles(np.diff(stamps)[3:] * 1e3)
    dev_p = percentiles(engine.device_ms[3:])
    p18 = LATENCY.get("fleet", (float("nan"),) * 2)
    print(f"bf16 FleetEngine over [cuda:0, cuda:0], N = {n} in two shards, {FLEET_TICKS} ticks, "
          f"{card}: tick p50 {host_p[0]!r} ms, p99 {host_p[1]!r} ms (host, between ticks, "
          f"after 3); upload to results p50 {dev_p[0]!r} ms, p99 {dev_p[1]!r} ms (CUDA "
          f"events); phase 18's unsharded tick p50 {p18[0]!r} ms, p99 {p18[1]!r} ms; no host "
          f"sync in any dispatch; launches {counts}")
    del lat, lon, fleet, fleet_lon, engine
    torch.cuda.empty_cache()
    return {k: v for k, v in counts.items() if v}


class ClipNets(torch.nn.Module):
    """BASELINE config 3's forward: a window of uint8 720p frames through
    the preprocess kernel into EgoLanes and DomainSeg."""

    def __init__(self, lanes, domain, dtype):
        super().__init__()
        self.lanes, self.domain, self.dtype = lanes, domain, dtype

    def forward(self, frames_u8):
        from autoware_vision_pilot_tpu_torch.ops.kernels.preprocess_kernel import (
            fused_preprocess)

        x = fused_preprocess(frames_u8, OUT_HW, self.dtype)
        return self.lanes(x), self.domain(x)


def phase_sharded_infer_and_tp(card):
    """Phase 38d, f32 with TF32 off: make_sharded_infer over [cuda:0,
    cuda:0] on the clip (EgoLanes + DomainSeg behind the preprocess kernel,
    a window of CLIP_BATCH 720p frames, two shards of 5: one preprocess
    launch a shard), and make_tp_infer on SceneSeg over (data=1, model=2)
    on [cuda:0, cuda:0] (each conv, transposed conv and Linear split on its
    output channels), each held to the unsharded forward at 1e-3 *
    max|ref|. -> the preprocess launches."""
    from autoware_vision_pilot_tpu_torch.core.mesh import make_mesh
    from autoware_vision_pilot_tpu_torch.parallel.multichip_inference import make_sharded_infer
    from autoware_vision_pilot_tpu_torch.parallel.tensor_parallel import (ChannelSplit,
                                                                          make_tp_infer,
                                                                          shard_variables_tp)

    no_tf32()
    twice = ["cuda:0", "cuda:0"]
    clip = ClipNets(seg_wrappers()["EgoLanes"](dtype=torch.float32).model.eval(),
                    seg_wrappers()["DomainSeg"](dtype=torch.float32).model.eval(), torch.float32)
    window = frames(CLIP_BATCH, FRAME_HW, SEED + 89).cuda()
    with torch.no_grad():
        ref = clip(window)
    torch.cuda.synchronize()
    reset_counts()
    got = make_sharded_infer(clip, make_mesh(devices=twice))(window)
    launches = read_counts()["fused_preprocess"]
    if launches != 2:
        raise AssertionError(f"the sharded clip launched the preprocess kernel {launches} times")
    errs = [held(f"sharded clip {name}", g, r) for name, g, r in
            zip(("EgoLanes", "DomainSeg"), got, ref)]
    del clip, got, ref
    net = dp_net(OUT_HW, "cuda").eval()
    x = (torch.randn(1, 3, *OUT_HW, generator=torch.Generator().manual_seed(SEED + 90))
         .cuda().contiguous(memory_format=CL))
    with torch.no_grad():
        ref = net(x)
    mesh = make_mesh((1, 2), ("data", "model"), twice)
    (replica,) = shard_variables_tp(net, mesh)
    split = sum(isinstance(m, ChannelSplit) for m in replica.modules())
    tp_err, tp_tol = held("tensor-parallel SceneSeg", make_tp_infer([replica], mesh)(x), ref)
    print(f"f32, {card}: make_sharded_infer over [cuda:0, cuda:0] on the clip (EgoLanes + "
          f"DomainSeg, a window of {CLIP_BATCH} 720p frames in two shards of "
          f"{CLIP_BATCH // 2}, one preprocess launch a shard) within 1e-3 * max|ref| of the "
          f"unsharded forward ((max_abs_err, tol) {errs}); make_tp_infer on SceneSeg "
          f"320x640 over (data=1, model=2) on [cuda:0, cuda:0], {split} layers split on their "
          f"output channels: max_abs_err {tp_err!r}, tol {tp_tol!r}")
    del net, replica
    torch.cuda.empty_cache()
    return launches


# ---------- phase 39: raw annotations -> the unified layout -> the trainers ----------

DATA_SAMPLES, DATA_BATCH = 4, 2  # raw samples a dataset, and the trainers' batch
# the datasets' published frame sizes (H, W)
DATA_HW = {"tusimple": (720, 1280), "culane": (590, 1640), "bdd100k": (720, 1280),
           "mapillary": (1080, 1920), "kitti": (375, 1242), "drivingstereo": (400, 881)}
KITTI_CALIB = (  # KITTI's 2011_09_26 calibration in the object benchmark's layout
    "P0: 7.215377e+02 0.000000e+00 6.095593e+02 0.000000e+00 0.000000e+00 7.215377e+02 "
    "1.728540e+02 0.000000e+00 0.000000e+00 0.000000e+00 1.000000e+00 0.000000e+00\n"
    "P2: 7.215377e+02 0.000000e+00 6.095593e+02 4.485728e+01 0.000000e+00 7.215377e+02 "
    "1.728540e+02 2.163791e-01 0.000000e+00 0.000000e+00 1.000000e+00 2.745884e-03\n"
    "R0_rect: 9.999239e-01 9.837760e-03 -7.445048e-03 -9.869795e-03 9.999421e-01 "
    "-4.278459e-03 7.402527e-03 4.351614e-03 9.999631e-01\n"
    "Tr_velo_to_cam: 7.533745e-03 -9.999714e-01 -6.166020e-04 -4.069766e-03 1.480249e-02 "
    "7.280733e-04 -9.998902e-01 -7.631618e-02 9.998621e-01 7.523790e-03 1.480755e-02 "
    "-2.717806e-01\n")
KITTI_POINTS = 120_000  # one HDL-64E sweep


def perspective_lanes(rng, hw, vanish_y, rows):
    """Four lanes through a vanishing point at ``vanish_y``: the x of each
    at ``rows``, NaN where it leaves the frame or a dash is missing."""
    h, w = hw
    vx = w / 2 + rng.normal(0, w / 40)
    bottoms = (np.array([-0.9, -0.3, 0.3, 0.9]) + rng.normal(0, 0.04, 4)) * w / 2 + vx
    t = (rows - vanish_y) / (h - vanish_y)
    xs = vx + (bottoms[:, None] - vx) * t[None] + rng.normal(0, 1.5, (4, len(rows)))
    xs[:, rows <= vanish_y + 10] = np.nan
    xs[(xs < 0) | (xs >= w)] = np.nan
    xs[1::2, (np.arange(len(rows)) // 4) % 2 == 1] = np.nan  # the dashed lanes
    return xs


def blocky_ids(rng, hw, ids, road, cells=(9, 16)):
    """A label map of ``hw``: random ``ids`` on a grid of ``cells``, the
    bottom third ``road``, upsampled by nearest."""
    g = rng.choice(np.asarray(ids, np.uint8), cells)
    g[cells[0] * 2 // 3:] = road
    ry, rx = -(-hw[0] // cells[0]), -(-hw[1] // cells[1])
    return np.ascontiguousarray(np.repeat(np.repeat(g, ry, 0), rx, 1)[:hw[0], :hw[1]])


def velodyne_sweep(rng, n=KITTI_POINTS):
    """One sweep of seeded LiDAR returns in the velodyne frame (x forward,
    y left, z up; 1.73 m above the road): the ground, and obstacles at
    random ranges, 64 beams from -24.8 to +2 degrees. (n, 4) float32."""
    az = rng.uniform(-np.pi, np.pi, n)
    el = np.radians(rng.uniform(-24.8, 2.0, n))
    with np.errstate(divide="ignore"):
        r = np.where(el < -0.01, 1.73 / np.sin(-np.minimum(el, -0.01)), 120.0)
    r = np.minimum(r, np.where(rng.random(n) < 0.3, rng.uniform(4, 60, n), np.inf))
    r = np.minimum(r, 120.0)
    xyz = np.stack([r * np.cos(el) * np.cos(az), r * np.cos(el) * np.sin(az), r * np.sin(el)], -1)
    return np.c_[xyz, rng.random(n)].astype(np.float32)


def write_raw_datasets(root, n=DATA_SAMPLES, seed=SEED):
    """``n`` seeded samples of each raw format, as the datasets ship them,
    at their published frame sizes (no dataset is in reach on the card):
    a TuSimple label_data.json with its clips, CULane .lines.txt files,
    BDD100K train-id PNGs, Mapillary Vistas v1.2 id PNGs, KITTI calib /
    velodyne / image_2 files and DrivingStereo 16-bit depth PNGs, each
    beside its noise image. -> root."""
    import cv2

    root = pathlib.Path(root)
    rng = np.random.default_rng(seed)

    def image(path, hw):
        path.parent.mkdir(parents=True, exist_ok=True)
        cv2.imwrite(str(path), rng.integers(0, 256, (*hw, 3), dtype=np.uint8))

    hw = DATA_HW["tusimple"]
    rows = np.arange(160, 720, 10)
    lines = []
    for i in range(n):
        raw_file = f"clips/0313-1/{60 * (i + 1)}/20.jpg"
        image(root / "tusimple" / raw_file, hw)
        xs = perspective_lanes(rng, hw, 250, rows)
        lanes = [np.where(np.isnan(x), -2, np.round(x)).astype(int).tolist() for x in xs]
        lines.append(json.dumps({"lanes": lanes, "h_samples": rows.tolist(),
                                 "raw_file": raw_file}))
    (root / "tusimple" / "label_data.json").write_text("\n".join(lines) + "\n")
    hw = DATA_HW["culane"]
    rows = np.arange(hw[0] - 1, 260, -10)
    for i in range(n):
        image(root / "culane" / f"{i:05d}.jpg", hw)
        text = "".join(" ".join(f"{x:.3f} {y}" for x, y in zip(xs, rows) if x == x) + " \n"
                       for xs in perspective_lanes(rng, hw, 260, rows))
        (root / "culane" / f"{i:05d}.lines.txt").write_text(text)
    for name, ids, road in (("bdd100k", list(range(19)) + [255], 0),
                            ("mapillary", [i for i in range(66) if i != 28], 13)):
        hw = DATA_HW[name]
        (root / name / "labels").mkdir(parents=True, exist_ok=True)
        for i in range(n):
            image(root / name / "images" / f"{i:05d}.jpg", hw)
            cv2.imwrite(str(root / name / "labels" / f"{i:05d}.png"), blocky_ids(rng, hw, ids, road))
    for sub in ("calib", "velodyne"):
        (root / "kitti" / sub).mkdir(parents=True, exist_ok=True)
    for i in range(n):
        image(root / "kitti" / "image_2" / f"{i:06d}.png", DATA_HW["kitti"])
        (root / "kitti" / "calib" / f"{i:06d}.txt").write_text(KITTI_CALIB)
        velodyne_sweep(rng).tofile(root / "kitti" / "velodyne" / f"{i:06d}.bin")
    hw = DATA_HW["drivingstereo"]
    (root / "drivingstereo" / "depth").mkdir(parents=True, exist_ok=True)
    for i in range(n):
        image(root / "drivingstereo" / "left" / f"{i:05d}.jpg", hw)
        depth = np.where(rng.random(hw) < 0.15, rng.uniform(2, 80, hw) * 256, 0)
        cv2.imwrite(str(root / "drivingstereo" / "depth" / f"{i:05d}.png"), depth.astype(np.uint16))
    return root


def parse_raw_datasets(raw, out, package="autoware_vision_pilot_tpu_torch"):
    """The raw datasets of write_raw_datasets through ``package``'s parsers
    into the unified layout under ``out``: egolanes/ (TuSimple and CULane
    lane masks by write_unified_sample), bdd100k/ and mapillary/ (SceneSeg
    colour labels by write_unified_sample), depth/ (KITTI's projected and
    filled LiDAR, DrivingStereo's depth, by save_depth_sample). -> (what
    was written by layout: [(name, image as written, label as written)],
    host seconds a sample of each parser)."""
    import importlib

    import cv2

    dp = {m: importlib.import_module(f"{package}.data_parsing.{m}") for m in (
        "common", "tusimple", "culane", "bdd100k", "mapillary", "kitti_depth", "depth_datasets")}
    raw, out = pathlib.Path(raw), pathlib.Path(out)
    written = {k: [] for k in ("egolanes", "bdd100k", "mapillary", "depth")}
    secs = {}

    def unified(layout, name, img, label):
        dp["common"].write_unified_sample(out / layout, name, img, label)
        written[layout].append((name, img, label))

    t0 = time.perf_counter()
    recs = dp["tusimple"].tusimple_to_unified(str(raw / "tusimple" / "label_data.json"))
    secs["tusimple"] = (time.perf_counter() - t0) / len(recs)
    for i, rec in enumerate(recs):
        img = cv2.imread(str(raw / "tusimple" / rec["raw_file"]))
        unified("egolanes", f"tusimple_{i:05d}", img, (rec["masks"] * 255).astype(np.uint8))
    paths = sorted((raw / "culane").glob("*.lines.txt"))
    for p in paths:
        t0 = time.perf_counter()
        masks = dp["culane"].culane_to_unified(str(p))
        secs["culane"] = secs.get("culane", 0.0) + (time.perf_counter() - t0) / len(paths)
        img = cv2.imread(str(p.with_name(p.name.replace(".lines.txt", ".jpg"))))
        unified("egolanes", f"culane_{p.name[:5]}", img, (masks * 255).astype(np.uint8))
    for name in ("bdd100k", "mapillary"):
        paths = sorted((raw / name / "labels").glob("*.png"))
        for p in paths:
            ids = cv2.imread(str(p), cv2.IMREAD_UNCHANGED)
            t0 = time.perf_counter()
            if name == "bdd100k":
                rgb = dp["bdd100k"].bdd100k_drivable_to_sceneseg(ids)
            else:
                rgb, valid = dp["mapillary"].mapillary_ids_to_sceneseg(ids)
                if not valid:
                    raise AssertionError(f"{p}: the Mapillary sample is not a valid scene")
            secs[name] = secs.get(name, 0.0) + (time.perf_counter() - t0) / len(paths)
            unified(name, p.stem, cv2.imread(str(raw / name / "images" / f"{p.stem}.jpg")), rgb)
    depth = dp["depth_datasets"]
    kitti = sorted((raw / "kitti" / "velodyne").glob("*.bin"))
    for i, p in enumerate(kitti):
        t0 = time.perf_counter()
        cal = dp["kitti_depth"].parse_kitti_calib((raw / "kitti" / "calib" / f"{p.stem}.txt")
                                                  .read_text())
        sparse = dp["kitti_depth"].velodyne_to_depth(
            np.fromfile(p, np.float32).reshape(-1, 4), cal["P2"].reshape(3, 4),
            cal["R0_rect"].reshape(3, 3), cal["Tr_velo_to_cam"].reshape(3, 4), DATA_HW["kitti"],
            fill=False)
        img = cv2.imread(str(raw / "kitti" / "image_2" / f"{p.stem}.png"))
        sample = depth.make_depth_sample(img, sparse)
        secs["kitti"] = secs.get("kitti", 0.0) + (time.perf_counter() - t0) / len(kitti)
        depth.save_depth_sample(out / "depth", i, *sample)
        written["depth"].append((str(i), sample[0], sample[1:]))
    paths = sorted((raw / "drivingstereo" / "depth").glob("*.png"))
    for i, p in enumerate(paths, len(kitti)):
        d16 = cv2.imread(str(p), cv2.IMREAD_UNCHANGED)
        img = cv2.imread(str(raw / "drivingstereo" / "left" / f"{p.stem}.jpg"))
        t0 = time.perf_counter()
        sample = depth.drivingstereo_sample(img, d16)
        secs["drivingstereo"] = secs.get("drivingstereo", 0.0) + (time.perf_counter() - t0) / len(paths)
        depth.save_depth_sample(out / "depth", i, *sample)
        written["depth"].append((str(i), sample[0], sample[1:]))
    return written, secs


def unified_loaders(out):
    """The port's loaders over parse_raw_datasets' layout -> {layout:
    dataset}: SceneSegDataset (BDD100K with its ROI crop, Mapillary),
    DepthDataset, EgoLanesMaskDataset."""
    from autoware_vision_pilot_tpu_torch.train.datasets import (DepthDataset,
                                                                 EgoLanesMaskDataset,
                                                                 SceneSegDataset)
    out = pathlib.Path(out)
    return {"bdd100k": SceneSegDataset(out / "bdd100k" / "images", out / "bdd100k" / "labels",
                                       "BDD100K"),
            "mapillary": SceneSegDataset(out / "mapillary" / "images",
                                         out / "mapillary" / "labels", "Mapillary"),
            "depth": DepthDataset(out / "depth" / "image", out / "depth" / "depth"),
            "egolanes": EgoLanesMaskDataset(out / "egolanes" / "images",
                                            out / "egolanes" / "labels")}


def check_read_back(out, written, loaders):
    """Each sample the loaders read equals what the parser wrote: the
    SceneSeg ids decode_scene_seg_mask gave before the write (under
    BDD100K's ROI crop), the depth and validity bit for bit, the lane masks
    as the float {0, 1} masks, every image as RGB. Also check_dataset on
    the two SceneSeg layouts: no bad pairs, no mismatched names, no unknown
    colours. -> the loaders' host seconds a sample."""
    import cv2

    from autoware_vision_pilot_tpu_torch.train.datasets import ROI_CROPS, decode_scene_seg_mask
    from autoware_vision_pilot_tpu_torch.utils.check_data import check_dataset

    out = pathlib.Path(out)
    for layout in ("bdd100k", "mapillary"):
        r = check_dataset(out / layout)
        pixels = sum(img.shape[0] * img.shape[1] for _, img, _ in written[layout])
        if (r["bad_pairs"] or r["mismatched_names"] or r["unknown_colors"]
                or r["n_images"] != len(written[layout]) or r["class_pixels"].sum() != pixels):
            raise AssertionError(f"check_dataset on {layout}: {r}")
    secs, count = 0.0, 0
    for layout, ds in loaders.items():
        samples = sorted(written[layout], key=lambda s: (f"{s[0]}.png" if layout == "depth"
                                                         else s[0]))
        if ds.item_count() != (len(samples), 0):
            raise AssertionError(f"{layout}: item_count {ds.item_count()}")
        for k, (name, img, label) in enumerate(samples):
            t0 = time.perf_counter()
            got_img, got, w = ds.get_train(k)
            secs += time.perf_counter() - t0
            count += 1
            want_img = img[..., ::-1]
            if layout in ("bdd100k", "mapillary"):
                want = decode_scene_seg_mask(label)[0]
                crop = ROI_CROPS.get(ds.dataset)
                if crop:
                    l, t, r, b = crop
                    want, want_img = want[t:b, l:r], want_img[t:b, l:r]
            elif layout == "depth":
                want = label[0]
                validity = cv2.imread(str(out / "depth" / "validity" / f"{name}.png"),
                                      cv2.IMREAD_UNCHANGED)
                if not np.array_equal(validity, label[1] * 255):
                    raise AssertionError(f"depth {name}: the validity read back differs")
            else:
                want = (label > 127).astype(np.float32)
            if not (np.array_equal(got, want) and got.dtype == want.dtype
                    and np.array_equal(got_img, want_img)):
                raise AssertionError(f"{layout} {name}: the loader's sample differs from the "
                                     "parser's")
    return secs / count


def egolanes_batch(samples, hw=TRAIN_HW):
    """EgoLanesMaskDataset samples -> one EgoLanes batch: the images at
    ``hw`` (bilinear), the masks at the net's quarter-resolution output
    (nearest)."""
    import cv2
    imgs = [cv2.resize(img, (hw[1], hw[0]), interpolation=cv2.INTER_LINEAR) for img, _, _ in samples]
    masks = [cv2.resize(m, (hw[1] // 4, hw[0] // 4), interpolation=cv2.INTER_NEAREST)
             for _, m, _ in samples]
    return np.stack(imgs), np.stack(masks), np.stack([w for _, _, w in samples])


def legacy_steps(trainer, run):
    """``run(trainer, on_step)`` under bf16 autocast on the card, where
    ``on_step(loss)`` is called after each step (a host sync) -> (the steps'
    host seconds, those of their grad_step calls alone (synchronized), the
    losses, (the names of the parameters that moved, those with a nonzero
    gradient in the last step, the count of all), the forward's compute
    dtypes)."""
    from autoware_vision_pilot_tpu_torch.nn.layers import Conv2d

    inner, grad_times = trainer.grad_step, []

    def grad_step(*args):  # the step alone, without the loading around it
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = inner(*args)
        torch.cuda.synchronize()
        grad_times.append(time.perf_counter() - t)
        return loss

    trainer.grad_step = grad_step
    params = dict(trainer.model.named_parameters())
    before = {k: p.detach().clone() for k, p in params.items()}
    first = next(m for m in trainer.model.modules() if isinstance(m, Conv2d))
    dtypes = set()
    hook = first.register_forward_hook(lambda m, a, y: dtypes.add(y.dtype))
    times, losses = [], []
    torch.cuda.synchronize()
    last = [time.perf_counter()]

    def on_step(loss):
        losses.append(float(loss))
        now = time.perf_counter()
        times.append(now - last[0])
        last[0] = now

    try:
        with torch.autocast("cuda", dtype=torch.bfloat16):
            run(trainer, on_step)
    finally:
        hook.remove()
        del trainer.grad_step
    trained = [k for k, p in params.items() if p.grad is not None and p.grad.count_nonzero()]
    moved = [k for k, p in params.items() if not torch.equal(p, before[k])]
    return times, grad_times, losses, (moved, trained, len(params)), dtypes


def phase_data(card):
    """Phase 39: write_raw_datasets (DATA_SAMPLES of each format at its
    published size), parse_raw_datasets with the port's parsers into the
    unified layout, check_dataset on the SceneSeg layouts, the three
    loaders read back equal to what the parsers wrote (check_read_back),
    then DATA_SAMPLES * 2 / DATA_BATCH steps each of the legacy SceneSeg
    trainer (train() over the BDD100K and Mapillary sets), the Scene3D
    trainer (train() over KITTI and DrivingStereo) and the EgoLanes trainer
    (grad_step on TuSimple and CULane batches, the masks at the net's
    output size): full-width nets at 320x640, bf16 autocast, batch
    DATA_BATCH; each loss finite, every parameter with a gradient moved
    (Scene3D's pretrained backbone is frozen). No hand
    kernel is on this path: the launch counts are set to 0 before the steps
    and must be 0 after. -> the steps' p50 ms by trainer."""
    import tempfile

    from autoware_vision_pilot_tpu_torch.models import (EgoLanesNetwork, Scene3DNetwork,
                                                        SceneSegNetwork)
    from autoware_vision_pilot_tpu_torch.train.legacy_trainer import (LegacySegTrainer,
                                                                      LegacyTrainerConfig,
                                                                      make_egolanes_trainer,
                                                                      make_scene3d_trainer)

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        raw = write_raw_datasets(pathlib.Path(tmp) / "raw")
        t_raw = time.perf_counter() - t0
        out = pathlib.Path(tmp) / "unified"
        written, secs = parse_raw_datasets(raw, out)
        loaders = unified_loaders(out)
        load_s = check_read_back(out, written, loaders)
        t_data = time.perf_counter() - t0
        print(f"dataset parsers, host ({card}): seconds a sample at the published sizes "
              + ", ".join(f"{k} {DATA_HW[k][0]}x{DATA_HW[k][1]} {v!r}" for k, v in secs.items())
              + f"; the loaders {load_s!r} s a sample; check_dataset clean on bdd100k and "
              f"mapillary, every label read back equal; raw fixtures {t_raw:.1f} s, parse, "
              f"write and read back {t_data - t_raw:.1f} s")

        cfg = lambda d: LegacyTrainerConfig(  # noqa: E731
            num_epochs=1, hw=TRAIN_HW, batch_schedule=(DATA_BATCH,), val_every=0, log_every=1,
            ckpt_dir=str(pathlib.Path(tmp) / d))
        trainers = {
            "SceneSeg": (LegacySegTrainer(SceneSegNetwork(), [loaders["bdd100k"],
                                                              loaders["mapillary"]],
                                          cfg("seg"), seed=SEED, device="cuda"),
                         lambda tr, cb: tr.train(callbacks=lambda _, loss: cb(loss))),
            "Scene3D": (make_scene3d_trainer(Scene3DNetwork(), [loaders["depth"]], cfg("depth"),
                                             seed=SEED, device="cuda"),
                        lambda tr, cb: tr.train(callbacks=lambda _, loss: cb(loss)))}
        lanes = loaders["egolanes"]
        order = np.random.default_rng(SEED).permutation(lanes.item_count()[0])

        def lane_steps(tr, cb):
            for i in range(0, len(order), DATA_BATCH):
                batch = egolanes_batch([lanes.get_train(int(k)) for k in order[i:i + DATA_BATCH]])
                cb(tr.grad_step(*batch))

        trainers["EgoLanes"] = (make_egolanes_trainer(EgoLanesNetwork(), [lanes], cfg("lanes"),
                                                      seed=SEED, device="cuda"), lane_steps)
        reset_counts()
        results = {}
        for name, (trainer, run) in trainers.items():
            times, grad_times, losses, moved, dtypes = legacy_steps(trainer, run)
            if len(losses) != DATA_SAMPLES * 2 // DATA_BATCH:
                raise AssertionError(f"legacy {name} trainer: {len(losses)} steps")
            if not all(math.isfinite(v) for v in losses):
                raise AssertionError(f"legacy {name} trainer: losses {losses}")
            moved, trained, total = moved
            if not trained or set(trained) - set(moved) or dtypes != {torch.bfloat16}:
                raise AssertionError(f"legacy {name} trainer: {len(moved)} of {total} "
                                     f"parameters moved, {len(trained)} with a gradient, "
                                     f"forward dtypes {dtypes}")
            p50 = float(np.median(times[1:])) * 1e3
            grad_p50 = float(np.median(grad_times[1:])) * 1e3
            results[name] = p50
            print(f"legacy {name} trainer on the parsed layout, {card}: {len(losses)} steps of "
                  f"batch {DATA_BATCH} at {TRAIN_HW[0]}x{TRAIN_HW[1]}, bf16 autocast, full "
                  f"width: step p50 {p50!r} ms after the first (host clock, each step synced, "
                  f"loading and resizing included), of which grad_step p50 {grad_p50!r} ms; "
                  f"first {times[0] * 1e3!r} ms (grad_step {grad_times[0] * 1e3!r}), losses "
                  f"{[round(v, 4) for v in losses]}, {len(moved)} of {total} parameters "
                  f"moved, every one of the {len(trained)} with a gradient in the last step")
            del trainer
            torch.cuda.empty_cache()
        launches = {k: v for k, v in read_counts().items() if v}
        if launches:
            raise AssertionError(f"the data path launched hand kernels: {launches}")
    print(f"phase 39: {time.perf_counter() - t0:.1f} s")
    return results


# ---------- phase 41: the int8 path whole (strided convs, int8 exports) ----------

# min_channels -> (int8 convs, of them strided) of AutoSpeed "n" at 640x640
INT8_LON = {128: (28, 3), 32: (58, 5)}
INT8_CALIB_FRAMES = 4


def conv_by_conv(name, model, run, count, strided):
    """run() once; a hook on each Int8Conv2d of ``model`` holds its output
    against plain_of on the same input (torch.equal). There must be
    ``count`` of them, ``strided`` of them with a stride other than 1. ->
    the number held."""
    from autoware_vision_pilot_tpu_torch.nn.layers import Int8Conv2d

    checked, bad = [], []

    def hook(m, args, y):
        if m.input_scale is None:
            raise AssertionError(f"an int8 conv of {name} has no static scale")
        checked.append(m.stride)
        if not torch.equal(y, plain_of(m, args[0])):
            bad.append((len(checked) - 1, tuple(m.weight.shape), m.stride))

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, Int8Conv2d)]
    try:
        with torch.no_grad():
            run()
        torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    n_strided = sum(s != (1, 1) for s in checked)
    print(f"{name}, conv by conv: {len(checked)} int8 convs ({n_strided} strided) held against "
          f"their plain versions on the frame's own input, {len(checked) - len(bad)} bit-equal "
          "(torch.equal)" + (f"; differ: {bad[:8]}" if bad else ""))
    if bad or len(checked) != count or n_strided != strided:
        raise AssertionError(f"{name}: {len(checked)} int8 convs ({n_strided} strided), "
                             f"expected {count} ({strided}); {len(bad)} differ")
    return len(checked)


def as_launches(op_calls):
    """Operator calls by operator name -> the JSON line's launches by kernel:
    "wgmma" and "splitk" are one kernel (int8_conv_wgmma), "d2s" is
    int8_conv_transpose; calls of 0 left out."""
    names = {"int8_conv_splitk": "int8_conv_wgmma", "int8_conv_d2s": "int8_conv_transpose"}
    out = {}
    for k, v in op_calls.items():
        if v:
            out[names.get(k, k)] = out.get(names.get(k, k), 0) + v
    return out


def phase_int8_longitudinal(card):
    """Phase 41a (path a): build_longitudinal_step with AutoSpeed "n" at
    640x640, bf16, quantized at min_channels 128 (28 int8 convs, 3 of them
    stride 2) and 32 (58, 5), calibrated on INT8_CALIB_FRAMES letterboxed
    seeded 720p frames; WARM + TIMED distinct frames each, the launch
    counts set to 0 just before and read just after (every int8 conv on a
    hand kernel, the strided ones on the "strided" route), p50/p99 beside
    the bf16 step's in the same phase; every int8 conv of one frame
    bit-equal to its plain version. -> the launches of the two int8 runs."""
    from autoware_vision_pilot_tpu_torch.export.quantize import (
        calibrate_int8_activation_scales, int8_conv_count, quantize_for_int8_conv)
    from autoware_vision_pilot_tpu_torch.ops.kernels.preprocess_kernel import fused_letterbox
    from autoware_vision_pilot_tpu_torch.runtime.pipeline import build_longitudinal_pipeline

    n = WARM + TIMED
    pool = frames(n, FRAME_HW, SEED + 100).cuda()
    calib = frames(INT8_CALIB_FRAMES, FRAME_HW, SEED + 101).cuda()
    total = {}
    for mc in (None, *INT8_LON):
        t0 = time.perf_counter()
        pipe = build_longitudinal_pipeline("cuda", torch.bfloat16, SEED)
        if mc is not None:
            quantize_for_int8_conv(pipe.net, mc)
            with torch.no_grad():
                calibrate_int8_activation_scales(
                    pipe.net, [fused_letterbox(calib[i], LON_HW, torch.bfloat16)[0]
                               for i in range(INT8_CALIB_FRAMES)])
            convs, strided = INT8_LON[mc]
            got = int8_conv_count(pipe.net)
            if got != convs:
                raise AssertionError(f"AutoSpeed at min_channels {mc}: {got} int8 convs, "
                                     f"expected {convs}")
        torch.cuda.synchronize()
        label = "bf16" if mc is None else f"int8 at min_channels {mc}"
        build_s = time.perf_counter() - t0
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        latencies, tables = [], []
        reset_counts()  # count only this path's launches
        for i in range(n):
            start.record()
            tables.append(pipe(pool[i]))
            end.record()
            end.synchronize()
            latencies.append(start.elapsed_time(end))
        launches = read_counts()
        check_tables(tables)
        p50, p99 = percentiles(latencies[WARM:])
        LATENCY[f"longitudinal {label}"] = (p50, p99)
        routes = {k: launches[k] // n for k in ("int8_quantize", "int8_conv_wgmma",
                                                "int8_conv_splitk", "int8_conv_strided",
                                                "int8_conv_halo", "int8_conv_pointwise",
                                                "int8_conv_dot")}
        if mc is not None:
            expect_launches(launches, {"fused_letterbox": n, "nms_greedy": n,
                                       "int8_conv": convs * n,
                                       "int8_conv_strided": strided * n})
            conv_by_conv(f"int8 AutoSpeed at min_channels {mc}", pipe.net,
                         lambda: pipe(pool[0]), convs, strided)
            for k, v in launches.items():
                if k.startswith("int8") and v:
                    total[k] = total.get(k, 0) + v
        print(f"longitudinal step {label}, {FRAME_HW[0]}x{FRAME_HW[1]} -> letterbox "
              f"{LON_HW[0]}x{LON_HW[1]} -> AutoSpeed n -> NMS, {card}: build "
              f"{build_s:.1f} s; p50 {p50!r} ms, p99 {p99!r} ms over {TIMED} distinct frames "
              f"after {WARM} warm-up (CUDA events a frame)"
              + (f", beside the bf16 step's p50 {LATENCY['longitudinal bf16'][0]!r} ms, p99 "
                 f"{LATENCY['longitudinal bf16'][1]!r} ms; int8 launches a frame by route "
                 f"{routes}" if mc is not None else ""))
        del pipe, tables
        torch.cuda.empty_cache()
    return total


def phase_int8_qat_temporal(card):
    """Phase 41b (path b): AutoSteer-temporal (80x160 masks) on the card,
    two QAT steps (train/qat.py::make_qat_loss at min_channels 32, f32,
    AdamW 1e-4, batch 4 of seeded stacked masks, cross-entropy on both
    heads), the observers of one QAT forward in eval mode, then
    int8_variables_from_qat: 4 int8 convs, 3 of them stride 2, the same
    convs the QAT selected; one forward with the launch counts set to 0
    just before and read just after, and each int8 conv bit-equal to its
    plain version. -> the launches."""
    from autoware_vision_pilot_tpu_torch.models.auto_steer_temporal import AutoSteerTemporalNet
    from autoware_vision_pilot_tpu_torch.nn.layers import Int8Conv2d, init_seeded
    from autoware_vision_pilot_tpu_torch.train.qat import (
        collect_act_scales, int8_variables_from_qat, make_qat_loss, qat_apply, selected_convs)

    t0 = time.perf_counter()
    net = init_seeded(AutoSteerTemporalNet(), torch.Generator().manual_seed(SEED + 110)).cuda()
    rng = np.random.default_rng(SEED + 111)
    x = torch.from_numpy(rng.uniform(0, 1, (4, 6, 80, 160)).astype(np.float32)).cuda()
    x = x.contiguous(memory_format=CL)
    target = torch.from_numpy(rng.integers(0, 61, (2, 4))).cuda()

    def base(out, t):
        prev, curr = out
        return (torch.nn.functional.cross_entropy(prev, t[0])
                + torch.nn.functional.cross_entropy(curr, t[1]))

    loss_fn = make_qat_loss(net, base, min_channels=32)
    opt = torch.optim.AdamW(net.parameters(), lr=1e-4)
    for p in net.parameters():
        p.requires_grad_(True)
    losses = []
    for _ in range(2):
        opt.zero_grad()
        loss, _ = loss_fn(x, target)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    net.eval()
    observers = {}
    with torch.no_grad():
        qat_apply(net, x, min_channels=32, observers=observers)
    int8 = int8_variables_from_qat(net, collect_act_scales(observers), 32)
    selected = set(selected_convs(net, 32))
    quantized = {n for n, m in int8.named_modules() if isinstance(m, Int8Conv2d)}
    if selected != quantized or len(quantized) != 4:
        raise AssertionError(f"QAT selected {sorted(selected)}, the export quantized "
                             f"{sorted(quantized)}")
    torch.cuda.synchronize()
    reset_counts()  # count only this path's launches
    with torch.no_grad():
        out = int8(x)
    torch.cuda.synchronize()
    launches = read_counts()
    check_finite("QAT int8 AutoSteer-temporal", list(out))
    expect_launches(launches, {"int8_conv": 4, "int8_conv_strided": 3})
    conv_by_conv("QAT int8 AutoSteer-temporal", int8, lambda: int8(x), 4, 3)
    print(f"QAT export of AutoSteer-temporal, {card}: 2 QAT steps (losses "
          f"{[round(v, 4) for v in losses]}), int8_variables_from_qat at min_channels 32: "
          f"{sorted(quantized)} (the QAT's own selection), one forward's launches "
          f"{ {k: v for k, v in launches.items() if v} }; {time.perf_counter() - t0:.1f} s")
    del net, int8
    torch.cuda.empty_cache()
    return {k: v for k, v in launches.items() if k.startswith("int8") and v}


def phase_int8_exports(card):
    """Phase 41c (path c): the int8 main path (build_pipeline_fused, bf16,
    min_ch 256: 72 int8 convs) and its variant with the transposed convs
    quantized (83 int8 modules), each through export_stablehlo and
    load_stablehlo on the card: the graph calls the avp int8 operators,
    the loaded program's outputs on 3 frames are bit-equal to the eager
    int8 path's, and each int8 operator's calls a frame equal the eager
    frame's launches on its route. -> the operators' calls of the loaded
    programs."""
    from autoware_vision_pilot_tpu_torch.export.quantize import (
        calibrate_int8_activation_scales, quantize_for_int8_conv)
    from autoware_vision_pilot_tpu_torch.export.stablehlo_export import (export_stablehlo,
                                                                         load_stablehlo)
    from autoware_vision_pilot_tpu_torch.ops.kernels import torch_ops
    from autoware_vision_pilot_tpu_torch.pipeline import build_pipeline_fused, calibration_batches

    out = REPO / "build" / f"int8_exports_{os.getpid()}"
    pool = frames(3, FRAME_HW, SEED + 120).cuda()
    calls = {}
    for transposes in (False, True):
        t0 = time.perf_counter()
        if transposes:
            pipe = build_pipeline_fused("cuda", torch.bfloat16, SEED, CTX_HW, OUT_HW)
            for net in (pipe.stack, pipe.lanes):
                quantize_for_int8_conv(net, 256, quantize_transpose=True)
                calibrate_int8_activation_scales(
                    net, calibration_batches(OUT_HW, torch.bfloat16, "cuda"))
        else:
            pipe = build_pipeline_fused("cuda", torch.bfloat16, SEED, CTX_HW, OUT_HW,
                                        int8=True, min_ch=256)
        name = "int8 + transposes" if transposes else "int8"
        reset_counts()
        with torch.no_grad():
            ref = pipe(pool[0])
        torch.cuda.synchronize()
        eager = read_counts()
        path = export_stablehlo(pipe, (pool[0],), out / f"main_{int(transposes)}.pt2")
        seconds = time.perf_counter() - t0
        targets = {str(n.target) for n in torch.export.load(path).graph.nodes
                   if n.op == "call_function" and str(n.target).startswith("avp.")}
        prog = load_stablehlo(path)
        with torch.no_grad():  # the eager outputs first: they call the operators too
            refs = [ref] + [pipe(pool[i]) for i in range(1, len(pool))]
            torch.cuda.synchronize()
            before = torch_ops.calls()
            got = [prog(pool[i]) for i in range(len(pool))]
        torch.cuda.synchronize()
        made = {k: (torch_ops.calls()[k] - before[k]) / len(pool) for k in torch_ops.INT8_OPS}
        want = {"int8_quantize": eager["int8_quantize"],
                "int8_conv_wgmma": eager["int8_conv_wgmma"] - eager["int8_conv_splitk"],
                "int8_conv_splitk": eager["int8_conv_splitk"],
                "int8_conv_strided": eager["int8_conv_strided"],
                "int8_conv_halo": eager["int8_conv_halo"],
                "int8_conv_pointwise": eager["int8_conv_pointwise"],
                "int8_conv_dot": eager["int8_conv_dot"],
                "int8_conv_d2s": eager["int8_conv_transpose"]}
        equal = all(torch.equal(a, b) for g, r in zip(got, refs) for a, b in zip(g, r))
        print(f"export_stablehlo of the {name} main path ({FRAME_HW[0]}x{FRAME_HW[1]} uint8 "
              f"frame -> the three outputs) -> {path.name} ({path.stat().st_size >> 20} MiB) in "
              f"{seconds:.1f} s with the build, {card}: the graph calls {sorted(targets)}; the "
              f"loaded program on {len(pool)} frames bit-equal to the eager int8 path "
              f"{equal}; int8 operator calls a frame {made}, the eager frame's launches by "
              f"route {want}")
        if not equal or made != want:
            raise AssertionError(f"the exported {name} path differs from the eager one")
        for k, v in as_launches(made).items():
            calls[k] = calls.get(k, 0) + int(v * len(pool))
        del pipe, prog, got, refs
        torch.cuda.empty_cache()
    shutil.rmtree(out, ignore_errors=True)
    return calls


def export_int8_lateral(out, frame_hw):
    """Phase 41d's bundle, in a process of its own beside phase 40c's
    exports: the lateral step of tools/export_native_app.py (seed-0
    weights, f32) with EgoLanes quantized at min_channels 256 and
    calibrated on INT8_CALIB_FRAMES seeded frames' crops (the step's own
    preprocess), as the AOTInductor package "lateral_int8". -> its int8
    convs."""
    from autoware_vision_pilot_tpu_torch.export.native_app import export_native_app
    from autoware_vision_pilot_tpu_torch.export.quantize import (
        calibrate_int8_activation_scales, int8_conv_count, quantize_for_int8_conv)
    from autoware_vision_pilot_tpu_torch.inference.infer import load_weights
    from autoware_vision_pilot_tpu_torch.models.auto_steer_temporal import AutoSteerTemporalNet
    from autoware_vision_pilot_tpu_torch.models.ego_lanes import EgoLanesNetwork
    from autoware_vision_pilot_tpu_torch.ops.kernels.preprocess_kernel import fused_preprocess
    from autoware_vision_pilot_tpu_torch.runtime import Config
    from autoware_vision_pilot_tpu_torch.runtime.pipeline import (build_lateral_step,
                                                                  init_lateral_state)

    kw = dict(device="cuda", dtype=torch.float32)
    lanes = load_weights(EgoLanesNetwork(), **kw)
    steer = load_weights(AutoSteerTemporalNet(), **kw)
    quantize_for_int8_conv(lanes, 256)
    calib = frames(INT8_CALIB_FRAMES, frame_hw, SEED + 130).cuda()
    with torch.no_grad():
        calibrate_int8_activation_scales(
            lanes, [fused_preprocess(calib[i:i + 1, LATERAL_CROP:], OUT_HW, torch.float32)
                    for i in range(INT8_CALIB_FRAMES)])
    step = build_lateral_step(lanes, steer, Config(), frame_hw=frame_hw, dtype=torch.float32)
    export_native_app(step, init_lateral_state(0, device="cuda"), (*frame_hw, 3), out,
                      name="lateral_int8", device="cuda")
    return int8_conv_count(lanes)


def start_native_app_export(out):
    """Phase 40c's bundles: the port's tools/export_native_app.py
    --longitudinal (the lateral step and AutoSpeed "n", f32) as ``python
    -m`` into ``out``, its output to ``out``/export.log. -> (the process,
    its start time)."""
    out.mkdir(parents=True, exist_ok=True)
    log = open(out / "export.log", "w")
    proc = subprocess.Popen([sys.executable, "-m",
                             "autoware_vision_pilot_tpu_torch.tools.export_native_app", str(out),
                             "--longitudinal"], cwd=REPO, stdout=log, stderr=subprocess.STDOUT)
    log.close()
    return proc, time.perf_counter()


def start_int8_lateral_export(out):
    """export_int8_lateral in a spawned process (AOTInductor compiles for
    minutes, mostly g++). -> (the pool, the future of its int8 convs)."""
    from concurrent.futures import ProcessPoolExecutor

    pool = ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn"))
    return pool, pool.submit(export_int8_lateral, str(out), FRAME_HW)


# ---------- phase 42: the accuracy tools (autoware_vision_pilot_tpu_torch/tools/) ----------

ACC_SAMPLES = 16  # phase 42a's synthetic dataset: samples 0-15, one validation sample (9)
ACC_CLIP_FRAMES = 30  # phase 42f's 720p MJPG clip
ACC_BARS = {"miou": 0.90, "steer_acc_1deg": 0.90, "map50": 0.50, "agreement": 0.995,
            "miou_gap": 0.02}
ACC_CHILDREN = ("e2e_autosteer_demo", "e2e_autospeed_demo")
JAX_AGREEMENT = 0.99908  # the JAX package's recorded per-channel agreement (not a bar)


def accuracy_tool(name):
    """Phase 42c or 42d in a spawned process: the tool's ``run`` at the JAX
    tool's defaults on the card, the kernels' counts set to 0 just before
    and read just after -> (its JSON result, the counts, seconds)."""
    import importlib

    tool = importlib.import_module(f"autoware_vision_pilot_tpu_torch.tools.{name}")
    t0 = time.perf_counter()
    reset_counts()
    result = tool.run(device="cuda")
    torch.cuda.synchronize()
    return result, read_counts(), time.perf_counter() - t0


def start_accuracy_children():
    """Phase 42c and 42d, each in a spawned process beside the main
    process's tools (their scenes and masks are made on the host). -> (the
    pool, {name: future})."""
    from concurrent.futures import ProcessPoolExecutor

    pool = ProcessPoolExecutor(len(ACC_CHILDREN), mp_context=multiprocessing.get_context("spawn"))
    return pool, {name: pool.submit(accuracy_tool, name) for name in ACC_CHILDREN}


def stop_pool(pool):
    """Ends a pool's processes whether or not their work is done."""
    for proc in list(getattr(pool, "_processes", {}).values()):
        if proc.is_alive():
            proc.terminate()
    pool.shutdown(wait=True, cancel_futures=True)


def planned_int8(sms):
    """A global forward hook adding each Int8Conv2d call's planned launches
    (ops/kernels/int8_conv.py::int8_conv2d_launches) by route to the dict
    it returns with the hook's handle."""
    from autoware_vision_pilot_tpu_torch.nn.layers import Int8Conv2d
    from autoware_vision_pilot_tpu_torch.ops.kernels.int8_conv import (ROUTES,
                                                                       int8_conv2d_launches)
    want = dict.fromkeys(ROUTES + ("quantize",), 0)

    def hook(m, args, y):
        if isinstance(m, Int8Conv2d):
            if m.input_scale is None:
                raise AssertionError("an int8 conv of the QAT export has no static scale")
            for k, n in int8_conv2d_launches(tuple(args[0].shape), tuple(m.weight.shape),
                                             m.padding, m.stride, m.dilation, m.groups,
                                             sms).items():
                want[k] += n

    return want, torch.nn.modules.module.register_module_forward_hook(hook)


def qat_closure_on_card(out, card, **kw):
    """Phase 42e, one run: qat_closure.run on the card with the launches of
    every int8 conv planned by a global hook and counted by the wrappers ->
    (the result, the launches). Every int8 conv must launch the route its
    plan names, and each of its quantizes."""
    from autoware_vision_pilot_tpu_torch.ops.kernels.int8_conv import int8_conv
    from autoware_vision_pilot_tpu_torch.tools import qat_closure

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    want, handle = planned_int8(sms)
    torch.cuda.synchronize()
    reset_counts()
    try:
        result = qat_closure.run(out=str(out), device="cuda", **kw)
        torch.cuda.synchronize()
    finally:
        handle.remove()
    launches = read_counts()
    got = {**int8_conv.route_launches, "quantize": launches["int8_quantize"]}
    print(f"qat_closure (min_ch {result['min_ch']}, per_ch_act {result['per_ch_act']}), "
          f"{card}: int8 launches by route {got}, planned {want}")
    if got != want or sum(want.values()) <= 0:
        raise AssertionError(f"qat_closure: int8 launches {got}, planned {want}")
    return result, launches


def write_clip(path, n, hw, seed):
    """An MJPG clip of ``n`` seeded distinct frames (a noisy road-like
    gradient with a moving bright bar, so that no two frames are equal)."""
    import cv2
    rng = np.random.default_rng(seed)
    h, w = hw
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), 10.0, (w, h))
    base = np.linspace(40, 200, h, dtype=np.float32)[:, None, None]
    for i in range(n):
        img = base + rng.normal(0, 20, (h, w, 3)).astype(np.float32)
        x = (i * 37) % (w - 40)
        img[h // 2:, x:x + 40] = 255.0
        writer.write(np.clip(img, 0, 255).astype(np.uint8))
    writer.release()


def phase_accuracy_tools(card):
    """Phase 42: each port tool's ``run`` at the JAX tool's defaults, full
    width and depth, held to its bar. (c) e2e_autosteer_demo and (d)
    e2e_autospeed_demo run in two spawned processes meanwhile. (b)
    e2e_train_demo: mIoU >= 0.90 and above the untrained one, the last five
    losses' mean below the first five's, the checkpoint round trip
    identical. (e) qat_closure at its defaults and with --per-ch-act
    --min-ch 256: every int8 conv on its planned route (qat_closure_on_card);
    the per-channel run's int8-vs-bf16 agreement >= 0.995 and int8 mIoU
    within 0.02 of bf16. (a) gen_synthetic_dataset (16 samples at 320x640)
    and validate_checkpoint with (e)'s per-channel int8 export: every
    labelled pixel counted. (f) debug_autosteer over a 30-frame seeded 720p
    clip: every frame-to-frame diff of the raw logits nonzero, one
    preprocess launch a frame. (c): the +/-1 degree accuracy bar, MAE below
    the always-straight baseline's. (d): mAP@50 >= 0.50, the validation's
    NMS launches. -> {path: launches}."""
    import tempfile
    from autoware_vision_pilot_tpu_torch.tools import (debug_autosteer, e2e_train_demo,
                                                       gen_synthetic_dataset,
                                                       validate_checkpoint)

    walls, paths = {}, {}
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    pool, futures = start_accuracy_children()
    try:
        with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
            tmp = pathlib.Path(tmp)
            t0 = time.perf_counter()
            r = e2e_train_demo.run(out=str(tmp / "e2e_train_demo"), device="cuda")
            walls["42b"] = time.perf_counter() - t0
            first, last = np.mean(r["loss_first5"]), np.mean(r["loss_last5"])
            if not (r["miou_after"] >= ACC_BARS["miou"] and r["miou_after"] > r["miou_before"]
                    and last < first and r["checkpoint_roundtrip"] == "identical"):
                raise AssertionError(f"e2e_train_demo missed its bars: {r}")
            print(f"42b e2e_train_demo, {card}: mIoU {r['miou_before']} -> {r['miou_after']} "
                  f"(bar {ACC_BARS['miou']}), loss {first:.4f} -> {last:.4f} (means of the first "
                  f"and last five), {walls['42b']:.1f} s")

            results = {}
            for label, kw in (("per-tensor, min_ch 128", {}),
                              ("per-channel, min_ch 256", {"per_ch_act": True, "min_ch": 256})):
                t0 = time.perf_counter()
                out = tmp / f"qat_{len(results)}"
                results[label] = qat_closure_on_card(out, card, **kw)
                walls[f"42e {label}"] = time.perf_counter() - t0
            r, launches = results["per-channel, min_ch 256"]
            gap = abs(r["miou_int8"] - r["miou_bf16"])
            print(f"42e qat_closure, {card}: per-tensor at 128 agreement "
                  f"{results['per-tensor, min_ch 128'][0]['argmax_agreement_int8_vs_bf16']}; "
                  f"per-channel at 256 agreement {r['argmax_agreement_int8_vs_bf16']} (bar "
                  f"{ACC_BARS['agreement']}; the JAX package recorded {JAX_AGREEMENT}), int8 "
                  f"mIoU {r['miou_int8']} against bf16 {r['miou_bf16']} (gap {gap:.4f}, bar "
                  f"{ACC_BARS['miou_gap']}), control bf16 vs f32 "
                  f"{r['control_agreement_bf16_vs_f32']}")
            if r["argmax_agreement_int8_vs_bf16"] < ACC_BARS["agreement"] or \
                    gap > ACC_BARS["miou_gap"]:
                raise AssertionError(f"qat_closure (per-channel) missed its bars: {r}")
            for label, (_, counts) in results.items():
                paths[f"qat_closure {label}"] = {
                    k: counts[k] for k in ("int8_quantize", "int8_conv_wgmma",
                                           "int8_conv_pointwise", "int8_conv_dot",
                                           "int8_conv_halo", "int8_conv_strided")
                    if counts[k] > 0}

            t0 = time.perf_counter()
            data = tmp / "synthetic"
            gen_synthetic_dataset.run(str(data), ACC_SAMPLES, OUT_HW)
            torch.cuda.synchronize()
            reset_counts()
            cm, iou, miou, overall = validate_checkpoint.run(
                [f"{data}:SYNTHETIC"], str(tmp / "qat_1" / "scene_seg_qat_int8.msgpack"),
                device="cuda")
            counts = read_counts()
            walls["42a"] = time.perf_counter() - t0
            n_val = sum((i + 1) % 10 == 0 for i in range(ACC_SAMPLES))
            print(f"42a validate_checkpoint of the per-channel QAT export over {ACC_SAMPLES} "
                  f"synthetic samples, {card}: mIoU {miou:.4f}, overall {overall:.4f}, "
                  f"{int(cm.sum())} pixels counted of {n_val} x {OUT_HW[0]} x {OUT_HW[1]}; "
                  f"int8 launches {counts['int8_conv']}")
            if int(cm.sum()) != n_val * OUT_HW[0] * OUT_HW[1] or counts["int8_conv"] <= 0:
                raise AssertionError(f"validate_checkpoint counted {int(cm.sum())} pixels")

            t0 = time.perf_counter()
            clip = tmp / "clip.avi"
            write_clip(clip, ACC_CLIP_FRAMES, FRAME_HW, SEED + 142)
            torch.cuda.synchronize()
            reset_counts()
            d = debug_autosteer.run(str(clip), ACC_CLIP_FRAMES, device="cuda")
            counts = read_counts()
            walls["42f"] = time.perf_counter() - t0
            print(f"42f debug_autosteer over a {ACC_CLIP_FRAMES}-frame "
                  f"{FRAME_HW[0]}x{FRAME_HW[1]} clip, {card}: frame-to-frame diffs "
                  f"{min(d['diffs']):.5f}-{max(d['diffs']):.5f}, steering "
                  f"{min(d['angles']):+.1f}..{max(d['angles']):+.1f} deg, fused_preprocess "
                  f"launches {counts['fused_preprocess']}")
            if d["frames"] != ACC_CLIP_FRAMES or len(d["diffs"]) != ACC_CLIP_FRAMES - 1 or \
                    min(d["diffs"]) <= 0 or counts["fused_preprocess"] != ACC_CLIP_FRAMES:
                raise AssertionError(f"debug_autosteer: {d['frames']} frames, diffs {d['diffs']},"
                                     f" {counts['fused_preprocess']} preprocess launches")
            paths["debug_autosteer"] = {"fused_preprocess": counts["fused_preprocess"]}

            t0 = time.perf_counter()
            (steer, _, steer_s), (speed, speed_counts, speed_s) = (
                futures[name].result(timeout=600) for name in ACC_CHILDREN)
            walls["42c-d wait"] = time.perf_counter() - t0
    finally:
        stop_pool(pool)
    print(f"42c e2e_autosteer_demo, {card}: +/-1 deg accuracy {steer['val_curr_acc_1deg']} "
          f"(bar {ACC_BARS['steer_acc_1deg']}), MAE {steer['val_curr_mae_deg']} deg against "
          f"the always-straight {steer['baseline_straight_mae_deg']}, {steer_s:.1f} s in its "
          "process")
    if not (steer["bar_met"] and steer["val_curr_mae_deg"] < steer["baseline_straight_mae_deg"]):
        raise AssertionError(f"e2e_autosteer_demo missed its bars: {steer}")
    n_val_batches = 2 * math.ceil(32 / 8)  # EMA and live weights, 32 scenes in batches of 8
    print(f"42d e2e_autospeed_demo, {card}: mAP@50 {speed['map50']} (EMA {speed['map50_ema']}, "
          f"live {speed['map50_live']}; bar {ACC_BARS['map50']}), mAP@[.5:.95] "
          f"{speed['map50_95']}, NMS launches {speed_counts['nms_greedy']} (the validations' "
          f"{n_val_batches} batches), {speed_s:.1f} s in its process")
    if not speed["pass"] or speed_counts["nms_greedy"] != n_val_batches:
        raise AssertionError(f"e2e_autospeed_demo: {speed}, NMS {speed_counts['nms_greedy']}")
    paths["e2e_autospeed validation"] = {"nms_greedy": speed_counts["nms_greedy"]}
    print(f"wall time of phase 42 (s): { {k: round(v, 1) for k, v in walls.items()} }, "
          f"{time.perf_counter() - t_phase:.1f} s in all")
    return paths


# ---------- phase 43: the bench tools (autoware_vision_pilot_tpu_torch/tools/) ----------

# (label, tool, arguments): each run as ``python -m`` at the JAX tool's defaults
BENCH_RUNS = (("app loop bf16", "bench_app_loop", ()),
              ("app loop int8", "bench_app_loop", ("--int8",)),
              ("train", "bench_train", ()),
              ("train, microbatches 2", "bench_train", ("--microbatches", "2")),
              ("fleet bf16", "bench_fleet", ()),
              ("fleet int8", "bench_fleet", ("--int8",)),
              ("zoo", "bench_zoo", ()),
              ("stages", "profile_pipeline_stages", ()))
BENCH_KEYS = {  # the keys every JSON line of a tool must carry
    "bench_app_loop": ("config", "mode", "tracking", "depth", "int8", "fps", "ms_per_frame",
                       "frames", "host_p50_ms", "host_p99_ms", "p50_ms", "p99_ms", "card"),
    "bench_train": ("metric", "value", "unit", "batch", "step_ms", "final_loss", "microbatches",
                    "world", "warmup_s", "p50_ms", "p99_ms", "card"),
    "bench_fleet": ("metric", "value", "unit", "per_stream_fps", "p50_ms", "p99_ms", "card"),
    "bench_zoo": ("model", "shape", "ms_per_forward", "fps", "params_m", "p50_ms", "p99_ms",
                  "card"),
    "profile_pipeline_stages": ("stage", "ms", "p50_ms", "p99_ms", "card"),
}
BENCH_LINES = {"bench_app_loop": 8, "bench_train": 1, "bench_fleet": 4, "bench_zoo": 8,
               "profile_pipeline_stages": 7}
BENCH_GAP = 0.25  # a tool's figure this far off its phase's is flagged (PERF.md says why)


def bench_lines(label, tool, args, card):
    """One tool as ``python -m`` on the card -> (its JSON lines, seconds).
    Fails on a nonzero exit, an ``error`` line, a missing key, a number
    that is not finite and positive, another card, or a line count other
    than the tool's."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", f"autoware_vision_pilot_tpu_torch.tools.{tool}",
                           *args], cwd=REPO, capture_output=True, text=True, timeout=400)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"{label}: exit {proc.returncode}\n{proc.stdout[-3000:]}\n"
                             f"{proc.stderr[-3000:]}")
    lines = [json.loads(x) for x in proc.stdout.splitlines() if x.startswith("{")]
    if len(lines) != BENCH_LINES[tool]:
        raise AssertionError(f"{label}: {len(lines)} JSON lines, expected {BENCH_LINES[tool]}")
    for line in lines:
        if "error" in line:
            raise AssertionError(f"{label}: {line}")
        derived = line.get("stage") == "seg_decoder_derived"  # stack_full - backbone: no p50
        keys = ("stage", "ms", "card") if derived else BENCH_KEYS[tool]
        missing = [k for k in keys if k not in line]
        if missing:
            raise AssertionError(f"{label}: {line} lacks {missing}")
        for k, v in line.items():
            values = v if isinstance(v, list) else [v]
            if any(not isinstance(x, bool) and isinstance(x, (int, float)) and
                   not (math.isfinite(x) and x > 0) for x in values):
                raise AssertionError(f"{label}: {k} = {v} is not finite and positive")
        if line["card"] != card:
            raise AssertionError(f"{label}: card {line['card']!r}, expected {card!r}")
    return lines, wall


def bench_paths(card):
    """Phase 43's in-process runs of the tools' paths that launch hand
    kernels, at a few frames or ticks, each with the counts set to 0 just
    before it and read just after (an int8 path's launches by route also
    held to the routes its convs plan, planned_int8) -> {path: counts}.
    The networks are built once: the app loop's; the fleet shares its
    lateral networks (a copy for --int8 at 128, before the app loop's
    --int8 recipe quantizes them at 256); the stage profile its EgoLanes."""
    import copy
    from autoware_vision_pilot_tpu_torch.models.multitask import SharedPerceptionStack
    from autoware_vision_pilot_tpu_torch.nn.layers import init_seeded
    from autoware_vision_pilot_tpu_torch.ops.kernels.int8_conv import int8_conv
    from autoware_vision_pilot_tpu_torch.tools import (bench_app_loop, bench_fleet,
                                                       profile_pipeline_stages)

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lat, lon = bench_app_loop.build("cuda", torch.bfloat16)
    stack = init_seeded(SharedPerceptionStack(CTX_HW, with_domain=False),
                        torch.Generator().manual_seed(SEED))
    stack.to("cuda", torch.bfloat16, memory_format=CL).eval()
    lanes128 = bench_fleet.int8_lanes(copy.deepcopy(lat.lanes), "cuda", torch.bfloat16)
    one = (("preupload+tracking", "preuploaded", True, (1,)),)
    paths = {
        "stages": lambda: profile_pipeline_stages.run(
            models=(stack, lat.lanes, stack.Backbone), warmup=0, timed=2),
        "fleet bf16": lambda: bench_fleet.run((2,), 2, nets=(lat.lanes, lat.steer_net)),
        "fleet int8": lambda: bench_fleet.run((2,), 2, int8=True,
                                              nets=(lanes128, lat.steer_net)),
        "app loop bf16": lambda: bench_app_loop.run(2, nets=(lat, lon), configs=one,
                                                    warm_frames=2),
        "app loop int8": lambda: bench_app_loop.run(2, True, nets=(lat, lon), configs=one,
                                                    warm_frames=2),
    }
    # each path's launches: a fleet run is 3 warm-up + 3 windows of 2 ticks; an app
    # loop run warmup() + 2 warm-up frames + 2 timed; the profile 2 calls of each stage
    frames = {"stages": 4, "fleet bf16": 9, "fleet int8": 9, "app loop bf16": 5,
              "app loop int8": 5}
    kernels = {"stages": ("fused_preprocess",),
               "fleet bf16": ("fused_preprocess", "lane_filter_walk"),
               "app loop bf16": ("fused_preprocess", "lane_filter_walk", "fused_letterbox",
                                 "nms_greedy")}
    kernels["fleet int8"] = kernels["fleet bf16"]
    kernels["app loop int8"] = kernels["app loop bf16"]
    counts = {}
    for path, run in paths.items():
        if path == "app loop int8":
            bench_app_loop.int8_nets(lat.lanes, lon.net, "cuda", torch.bfloat16)
        int8 = path.endswith("int8")
        want, handle = planned_int8(sms) if int8 else (None, None)
        torch.cuda.synchronize()
        reset_counts()
        try:
            run()
            torch.cuda.synchronize()
        finally:
            if handle is not None:
                handle.remove()
        c = read_counts()
        expect_launches(c, {k: frames[path] for k in kernels[path]})
        if int8:
            got = {**int8_conv.route_launches, "quantize": c["int8_quantize"]}
            if got != want or c["int8_conv"] <= 0 or c["int8_quantize"] <= 0:
                raise AssertionError(f"{path}: int8 launches by route {got}, planned {want}")
        else:
            expect_launches(c, {"int8_quantize": 0, "int8_conv": 0})
        counts[path] = {k: n for k, n in c.items()
                        if n > 0 and k not in ("int8_conv", "int8_conv_splitk")}
        print(f"43 {path}, in process: launches {counts[path]}")
    del lat, lon, stack, lanes128
    torch.cuda.empty_cache()
    return counts


def beside(what, tool_ms, phase_ms):
    gap = tool_ms / phase_ms - 1
    flag = f" ({gap:+.0%}: more than {BENCH_GAP:.0%} off, PERF.md says why)" \
        if abs(gap) > BENCH_GAP else f" ({gap:+.0%})"
    return f"{what}: {tool_ms!r} against {phase_ms!r}{flag}"


def phase_bench_tools(card):
    """Phase 43: the five bench tools each as ``python -m`` on the card at the
    JAX tools' defaults (bench_lines: every JSON line checked), then one
    in-process run of each path that launches hand kernels (bench_paths),
    and the tools' figures beside the phases that time the same path in
    this call: the stage profile's fused_everything with phases 7-8, the
    train step with 36b, the fleet at N = 8 with 18, the app loop without
    tracking at depth 1 with 17. -> {path: launches}."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    out, walls = {}, {}
    for label, tool, args in BENCH_RUNS:
        out[label], walls[label] = bench_lines(label, tool, args, card)
        for line in out[label]:
            print(f"43 {label}: {json.dumps(line)}")
    paths = bench_paths(card)
    stages = {x["stage"]: x for x in out["stages"]}
    print(f"43 stage split, bf16, {FRAME_HW[0]}x{FRAME_HW[1]} -> {OUT_HW[0]}x{OUT_HW[1]}, "
          f"{card}: " + ", ".join(f"{k} {v['ms']!r} ms" for k, v in stages.items()))
    fused = stages["fused_everything"]["p50_ms"]
    print("43 beside the phases of this call, p50 ms, " + card + ": " + "; ".join([
        beside("stage profile fused_everything vs phase 7 (bf16 main path)", fused,
               LATENCY["bf16"][0]),
        f"vs phase 8 (int8 main path) {LATENCY['int8'][0]!r}",
        beside("bench_train step vs phase 36b", out["train"][0]["p50_ms"],
               LATENCY["train step"][0]),
        beside("bench_fleet tick at N = 8 (lateral only) vs phase 18 (FleetEngine, lateral "
               "and longitudinal, host between ticks)", out["fleet bf16"][-1]["p50_ms"],
               LATENCY["fleet"][0]),
        beside("bench_app_loop no-track depth 1, host loop vs phase 17 (build_engine, "
               "tracking, depth 1, host frames)",
               next(x for x in out["app loop bf16"] if not x["tracking"] and x["depth"] == 1)
               ["host_p50_ms"], LATENCY["engine"][0])]))
    print(f"wall time of phase 43 (s): { {k: round(v, 1) for k, v in walls.items()} }, "
          f"{time.perf_counter() - t_phase:.1f} s in all")
    return paths


# ---------- phase 40: the operators, the exported programs, the native app ----------

APP_FRAMES = 16  # the golden run: the probe, then 16 frames with the state carried
APP_TIMED_FRAMES = 150  # the publishing run, which also times the loop
APP_EGO_SPEED = 12.5


def start_app_build():
    """Phase 40c's C++ loop (export/native_app.py::build_app, g++ against
    libtorch, ~30 s), built on a thread while the earlier phases run. ->
    (the executor, the future of the binary's path)."""
    from concurrent.futures import ThreadPoolExecutor

    from autoware_vision_pilot_tpu_torch.export.native_app import build_app

    pool = ThreadPoolExecutor(1)
    return pool, pool.submit(build_app)


def op_inputs():
    """Each avp operator's arguments at the shapes of the exported steps: the
    lateral crop 720x1280[420:] -> 320x640 bf16, the letterbox 720x1280 ->
    640x640 bf16, the walk on 80x160 masks, NMS on the 256 candidates that
    nms_topk keeps for max_det 64. -> {name: (args, plain version's outputs)}."""
    from autoware_vision_pilot_tpu_torch.ops.kernels.nms_kernel import cluster_size
    from autoware_vision_pilot_tpu_torch.ops.kernels.preprocess_kernel import (
        _mean_inv_std, letterbox_pad_bits)
    from autoware_vision_pilot_tpu_torch.ops.postprocess import nms_greedy_plain, nms_topk
    from autoware_vision_pilot_tpu_torch.ops.preprocess import (device_taps, letterbox,
                                                                letterbox_geometry,
                                                                preprocess_imagenet)
    from autoware_vision_pilot_tpu_torch.perception.lane_filter import lane_filter_walk_plain

    dev = torch.device("cuda")
    frame = frames(1, FRAME_HW, SEED + 90)
    crop = frame[:, LATERAL_CROP:]
    h, w = crop.shape[1:3]
    _, (nh, nw), (pad_x, pad_y) = letterbox_geometry(LON_HW, FRAME_HW)
    masks = torch.from_numpy(lane_masks(LANE_HW, "dashed", SEED + 91))[None]
    top = nms_topk(*nms_candidates("random", SEED + 92), max_det=MAX_DET, conf_thresh=CONF)
    k = top[1].shape[-1]
    nms_kw = dict(max_det=MAX_DET, iou_thresh=IOU, conf_thresh=CONF, class_aware=True)
    bf16 = torch.bfloat16
    return {
        "fused_preprocess": (
            (frame.to(dev)[:, LATERAL_CROP:], *device_taps(h, OUT_HW[0], dev),
             *device_taps(w, OUT_HW[1], dev),
             *_mean_inv_std(dev), *OUT_HW, True),
            (preprocess_imagenet(crop, OUT_HW, bf16),)),
        "fused_letterbox": (
            (frame.to(dev), *device_taps(FRAME_HW[0], nh, dev), *device_taps(FRAME_HW[1], nw, dev),
             *LON_HW, pad_y, pad_x, letterbox_pad_bits(bf16), True),
            (letterbox(frame, LON_HW, FRAME_HW, dtype=bf16)[0],)),
        "lane_filter_walk": ((masks.to(dev),), lane_filter_walk_plain(masks)),
        "nms_greedy": (
            (*(t[None].to(dev) for t in top), MAX_DET, IOU, CONF, True, cluster_size(k)),
            tuple(t[None] for t in nms_greedy_plain(*top, **nms_kw))),
    }


def phase_ops(card):
    """Phase 40a: the operator library (csrc/torch_ops.cpp) built and loaded;
    torch.library.opcheck of each avp operator at the exported steps'
    shapes (schema, fake implementation, dispatch); each operator's outputs
    bit-equal to its plain version on the same inputs."""
    from autoware_vision_pilot_tpu_torch.kernels import build
    from autoware_vision_pilot_tpu_torch.ops.kernels import torch_ops

    t0 = time.perf_counter()
    torch_ops.load()
    print(f"operator library {build.OPS_LIBRARY.relative_to(REPO)} loaded in "
          f"{time.perf_counter() - t0:.2f} s: torch.ops.avp.{{{', '.join(torch_ops.OPS)}}}")
    for name, (args, plain) in op_inputs().items():
        op = getattr(torch.ops.avp, name).default
        torch.library.opcheck(op, args)
        out = op(*args)
        out = out if isinstance(out, tuple) else (out,)
        torch.cuda.synchronize()
        if not all(bits_equal(a.cpu(), b) for a, b in zip(out, plain)):
            raise AssertionError(f"avp::{name} differs from its plain version")
        print(f"avp::{name} on {tuple(args[0].shape)}, {card}: opcheck passed (schema, fake "
              "tensor, dispatch); outputs bit-equal to the plain version (max_abs_err 0)")


class SegFromFrame(torch.nn.Module):
    """uint8 720p frame -> fused_preprocess (the kernel) -> SceneSeg ->
    argmax_mask: the program of phase 40b's export_stablehlo."""

    def __init__(self, seg):
        super().__init__()
        self.seg = seg

    def forward(self, frame_u8):
        from autoware_vision_pilot_tpu_torch.ops.kernels.preprocess_kernel import fused_preprocess
        from autoware_vision_pilot_tpu_torch.ops.postprocess import argmax_mask

        x = fused_preprocess(frame_u8, OUT_HW, torch.bfloat16)
        return argmax_mask(self.seg(x).permute(0, 2, 3, 1))


def phase_exports(card):
    """Phase 40b: export/stablehlo_export.py::export_model in bf16 for the
    seven families at EXPORT_SHAPES (seed-0 weights), each saved, loaded
    (load_stablehlo) and run on a seeded input, held to the eager module
    (every output within 1e-2 * max|eager|, two bf16 ulps of the largest);
    then
    export_stablehlo of fused_preprocess -> SceneSeg -> argmax_mask from a
    720p uint8 frame: the graph holds torch.ops.avp.fused_preprocess, the
    loaded program launches the kernel (profiler) and its mask equals the
    eager module's. -> {"fused_preprocess": the program's calls}."""
    from autoware_vision_pilot_tpu_torch.export.stablehlo_export import (
        EXPORT_SHAPES, export_model, export_stablehlo, load_stablehlo)
    from autoware_vision_pilot_tpu_torch.inference.infer import load_weights
    from autoware_vision_pilot_tpu_torch.ops.kernels import torch_ops
    from autoware_vision_pilot_tpu_torch.tools.export_all import build as build_net

    out = REPO / "build" / f"exports_{os.getpid()}"
    rng = np.random.default_rng(SEED + 93)
    for name, shape in EXPORT_SHAPES.items():
        net, _, n_in = build_net(name)
        net = load_weights(net, device="cuda", dtype=torch.bfloat16)
        t0 = time.perf_counter()
        path = export_model(net, name, out, torch.bfloat16)
        seconds = time.perf_counter() - t0
        prog = load_stablehlo(path)
        x = tuple(torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                  .to("cuda", torch.bfloat16) for _ in range(n_in))
        with torch.no_grad():
            got, ref = prog(*x), net(*x)
        got = got if isinstance(got, (tuple, list)) else (got,)
        ref = ref if isinstance(ref, (tuple, list)) else (ref,)
        errs = [float((a.float() - b.float()).abs().max()) for a, b in zip(got, ref)]
        bars = [1e-2 * float(b.float().abs().max()) for b in ref]
        if len(got) != len(ref) or any(e > b for e, b in zip(errs, bars)) or \
                any(a.shape != b.shape or a.dtype != b.dtype for a, b in zip(got, ref)):
            raise AssertionError(f"exported {name}: max_abs_err {errs}, bars {bars}")
        print(f"export_model {name} {shape} bf16 -> {path.name} ({path.stat().st_size >> 20} "
              f"MiB) in {seconds:.1f} s, {card}: loaded program vs eager max_abs_err {errs} "
              f"(bar 1e-2 * max|eager|: {bars}; bit-equal "
              f"{all(torch.equal(a, b) for a, b in zip(got, ref))})")
        del net, prog
    seg = load_weights(build_net("SceneSeg")[0], device="cuda", dtype=torch.bfloat16)
    model = SegFromFrame(seg).eval()
    frame = frames(1, FRAME_HW, SEED + 94)[0].cuda()
    path = export_stablehlo(model, (frame,), out / "SceneSegFromFrame.pt2")
    targets = [n.target for n in torch.export.load(path).graph.nodes if n.op == "call_function"]
    if torch.ops.avp.fused_preprocess.default not in targets:
        raise AssertionError(f"the exported SceneSeg program holds no avp::fused_preprocess: "
                             f"{sorted(set(map(str, targets)))}")
    prog = load_stablehlo(path)
    before = torch_ops.calls()["fused_preprocess"]
    # late in the run a trace can drop device records (device_us): up to five
    # traces of three calls each, GUARDS sleeps on each side
    for traces in range(1, 6):
        with torch.no_grad(), torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(GUARDS):
                torch.cuda._sleep(100)
            for _ in range(3):
                mask = prog(frame)
            for _ in range(GUARDS):
                torch.cuda._sleep(100)
            torch.cuda.synchronize()
        kernels = sum(e.count for e in prof.key_averages() if "fused_preprocess_kernel" in e.key)
        if kernels > 0:
            break
    calls = torch_ops.calls()["fused_preprocess"] - before
    with torch.no_grad():
        ref = model(frame)
    if kernels <= 0 or calls != 3 * traces or not torch.equal(mask, ref):
        raise AssertionError(f"the loaded SceneSeg program: {kernels} preprocess kernels on the "
                             f"card in {traces} traces, {calls} operator calls, mask equal "
                             f"{torch.equal(mask, ref)}")
    print(f"export_stablehlo fused_preprocess -> SceneSeg -> argmax_mask from a 720p uint8 frame "
          f"-> {path.name}, {card}: the graph calls torch.ops.avp.fused_preprocess; the loaded "
          f"program's 3 calls launched fused_preprocess_kernel {kernels} time(s) (profiler, trace "
          f"{traces}), {calls} operator calls in all, mask {tuple(mask.shape)} equal to the eager "
          f"module's")
    shutil.rmtree(out, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"fused_preprocess": calls}


def app_line(stdout, what):
    for line in stdout.splitlines():
        if line.startswith(what):
            return line
    raise AssertionError(f"the loop printed no '{what}' line:\n{stdout}")


LOOP_OPS = ("fused_preprocess", "fused_letterbox", "lane_filter_walk", "nms_greedy")


def app_op_calls(stdout, names=LOOP_OPS):
    """The loop's "op calls:" line, the operators ``names`` (the four of the
    f32 packages by default)."""
    words = app_line(stdout, "op calls:").split()[2:]
    calls = {words[i]: int(words[i + 1]) for i in range(0, len(words), 2)}
    return {k: calls[k] for k in names}


def phase_native_app(card, app_build, out, int8_export, native_export):
    """Phase 40c: the port's tools/export_native_app.py --longitudinal on the
    card (the lateral step at 720x1280, crop 420, EgoLanes at 320x640, f32;
    AutoSpeed "n" at 640x640 with the letterbox and NMS), each torch.export
    + AOTInductor; the port's C++ loop (host/tools/visionpilot_app.cpp,
    built on a thread since phase 2) with --ops, --lon, --golden and --dump
    over APP_FRAMES seeded frames: the golden probe within 2e-3, the final
    scalars equal to a Python replay of the same package (flags exact, the
    rest within 1e-4), each of the four operators called at least once a
    frame inside the C++ process; then APP_TIMED_FRAMES frames publishing to
    a pid-named /dev/shm segment, republished by the port's
    StatePublisherBridge on an InProcTransport: advancing frame ids, the
    longitudinal fields (ego speed, planner, RSS) in the POD; the AOTI
    compile seconds and the loop's p50/p99. Then phase 41d (path d) with
    the "lateral_int8" package of ``int8_export`` (start_int8_lateral_export,
    exported meanwhile into ``out``): the C++ loop over it and the same
    longitudinal package, golden probe and trajectory against the Python
    replay, then APP_TIMED_FRAMES frames, its int8 operators' calls a frame
    and its p50/p99 beside the f32 loop's. -> the operator calls of the
    loop's runs, by name."""
    from autoware_vision_pilot_tpu_torch.export.native_app import replay_native_app
    from autoware_vision_pilot_tpu_torch.host.shm import SharedStateReader
    from autoware_vision_pilot_tpu_torch.kernels import build
    from autoware_vision_pilot_tpu_torch.middleware.transport import InProcTransport
    from autoware_vision_pilot_tpu_torch.runtime.pipeline import SCALAR_FIELDS
    from autoware_vision_pilot_tpu_torch.simulation import StatePublisherBridge

    proc, t0 = native_export
    t_wait = time.perf_counter()
    rc = proc.wait(timeout=900)
    log = (out / "export.log").read_text()
    if rc != 0:
        raise AssertionError(f"tools/export_native_app.py --longitudinal exited {rc}:\n{log}")
    for line in log.splitlines():  # each bundle's export and compile seconds
        if line.startswith("[native_app]"):
            print(line)
    print(f"the port's tools/export_native_app.py --longitudinal, {card}: "
          f"{time.perf_counter() - t0:.1f} s in all, {time.perf_counter() - t_wait:.1f} s of them "
          "waited for here (the two bundles in two processes; seed-0 weights, f32)")
    app = app_build[1].result()
    app_build[0].shutdown()
    stack = frames(APP_FRAMES, FRAME_HW, SEED + 95).numpy()
    np.save(out / "stack.npy", stack)
    dump = out / "final.npy"
    cmd = [str(app), str(out), "lateral", "--ops", str(build.OPS_LIBRARY), "--lon",
           "longitudinal", "--frames", str(out / "stack.npy")]
    r = subprocess.run(cmd + ["--golden", "--max-frames", str(APP_FRAMES), "--dump", str(dump),
                              "--state-shm", f"/avp_smoke_app_{os.getpid()}"],
                       capture_output=True, text=True, timeout=600)
    if r.returncode != 0 or "golden probe: max|diff|" not in r.stderr:
        raise AssertionError(f"the native loop failed ({r.returncode}):\n{r.stdout}\n{r.stderr}")
    golden = app_line(r.stderr, "golden probe")
    calls = app_op_calls(r.stdout)
    if min(calls.values()) < APP_FRAMES + 1:
        raise AssertionError(f"the C++ loop called the operators {calls} times over "
                             f"{APP_FRAMES + 1} frames")
    final_cpp = np.load(dump)
    final_py = replay_native_app(out, "lateral", list(stack))[-1]
    flags = [SCALAR_FIELDS.index("fused_valid"), SCALAR_FIELDS.index("path_valid")]
    if not (np.array_equal(final_cpp[flags], final_py[flags])
            and np.allclose(final_cpp, final_py, rtol=1e-4, atol=1e-4)):
        raise AssertionError(f"the C++ loop's final scalars {final_cpp} differ from the Python "
                             f"replay's {final_py}")
    print(f"native loop, lateral + longitudinal packages, {APP_FRAMES} state-carried frames after "
          f"the probe, {card}: {golden}; final scalars {final_cpp.tolist()} vs the Python replay "
          f"of the same package: max|diff| {float(np.abs(final_cpp - final_py).max())!r} (flags "
          f"exact, tol 1e-4); operator calls inside the C++ process {calls} "
          f"({APP_FRAMES + 1} frames)")
    # phase 41d's package: its export ran beside the two above; wait for it
    # here, so that the timed loops below run on a quiet host
    t0 = time.perf_counter()
    int8_convs = int8_export[1].result()
    int8_export[0].shutdown()
    print(f"the int8 lateral bundle (EgoLanes at min_channels 256: {int8_convs} int8 convs) "
          f"was exported beside them; waited {time.perf_counter() - t0:.1f} s more for it")
    int8_cmd = [str(app), str(out), "lateral_int8", "--ops", str(build.OPS_LIBRARY), "--lon",
                "longitudinal", "--frames", str(out / "stack.npy")]
    dump8 = out / "final_int8.npy"
    r8 = subprocess.run(int8_cmd + ["--golden", "--max-frames", str(APP_FRAMES), "--dump",
                                    str(dump8), "--state-shm", f"/avp_smoke_int8_{os.getpid()}"],
                        capture_output=True, text=True, timeout=600)
    if r8.returncode != 0 or "golden probe: max|diff|" not in r8.stderr:
        raise AssertionError(f"the int8 native loop failed ({r8.returncode}):\n{r8.stdout}\n"
                             f"{r8.stderr}")
    int8_names = LOOP_OPS + ("int8_quantize", "int8_conv_wgmma", "int8_conv_splitk",
                             "int8_conv_strided", "int8_conv_halo", "int8_conv_pointwise",
                             "int8_conv_dot", "int8_conv_d2s")

    def int8_loop_calls(stdout, n_frames):
        """The loop's calls: the four kernels at least once a frame, and
        the int8 convs of the lateral package exactly once each a frame."""
        got = app_op_calls(stdout, int8_names)
        convs = sum(v for k, v in got.items() if k.startswith("int8_conv"))
        if min(got[k] for k in LOOP_OPS) < n_frames or convs != int8_convs * n_frames:
            raise AssertionError(f"the int8 loop called the operators {got} times over "
                                 f"{n_frames} frames ({int8_convs} int8 convs a frame)")
        return {k: v for k, v in got.items() if v}

    calls8 = int8_loop_calls(r8.stdout, APP_FRAMES + 1)
    final8_cpp = np.load(dump8)
    final8_py = replay_native_app(out, "lateral_int8", list(stack))[-1]
    if not (np.array_equal(final8_cpp[flags], final8_py[flags])
            and np.allclose(final8_cpp, final8_py, rtol=1e-4, atol=1e-4)):
        raise AssertionError(f"the int8 C++ loop's final scalars {final8_cpp} differ from the "
                             f"Python replay's {final8_py}")
    print(f"native loop, int8 lateral + longitudinal packages, {APP_FRAMES} state-carried frames "
          f"after the probe, {card}: {app_line(r8.stderr, 'golden probe')}; final scalars "
          f"{final8_cpp.tolist()} vs the Python replay of the same package: max|diff| "
          f"{float(np.abs(final8_cpp - final8_py).max())!r} (flags exact, tol 1e-4); operator "
          f"calls inside the C++ process {calls8} ({APP_FRAMES + 1} frames); "
          f"{app_line(r8.stdout, 'int8 op calls a frame:')}")

    seg = f"/avp_smoke_pub_{os.getpid()}"
    proc = subprocess.Popen(cmd + ["--max-frames", str(APP_TIMED_FRAMES), "--ego-speed",
                                   str(APP_EGO_SPEED), "--state-shm", seg],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    transport, msgs = InProcTransport(), []
    transport.subscribe("/visionpilot/state", msgs.append)
    bridge = None
    try:
        deadline = time.time() + 300
        while bridge is None and proc.poll() is None and time.time() < deadline:
            try:
                bridge = StatePublisherBridge(transport, rate_hz=1000.0, shm_name=seg)
            except RuntimeError:  # not created yet
                time.sleep(0.02)
        if bridge is None:
            raise AssertionError("the loop's state segment never appeared")
        spinner = threading.Thread(target=bridge.spin, daemon=True)
        spinner.start()
        stdout, stderr = proc.communicate(timeout=600)
        bridge.stop()
        spinner.join(10)
        last = bridge.reader.read()  # the final state: the mapping outlives the unlink
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        if bridge is not None:
            bridge.close()
    if proc.returncode != 0:
        raise AssertionError(f"the publishing loop failed ({proc.returncode}):\n{stdout}\n{stderr}")
    ids = [m["frame"] for m in msgs]
    if len(ids) < 3 or ids != sorted(set(ids)):
        raise AssertionError(f"the bridge republished frame ids {ids}")
    if last.frame_number != APP_TIMED_FRAMES or abs(last.ego_speed_ms - APP_EGO_SPEED) > 1e-9 \
            or not last.ideal_speed_ms > 0 or not np.isfinite(last.control_effort_ms2) \
            or not last.safe_distance_m > 0:
        raise AssertionError(f"the last published state is wrong: frame {last.frame_number}, "
                             f"ego {last.ego_speed_ms}, ideal {last.ideal_speed_ms}, effort "
                             f"{last.control_effort_ms2}, RSS {last.safe_distance_m}")
    calls2 = app_op_calls(stdout)
    if min(calls2.values()) < APP_TIMED_FRAMES:
        raise AssertionError(f"the publishing loop called the operators {calls2} times over "
                             f"{APP_TIMED_FRAMES} frames")
    r8 = subprocess.run(int8_cmd + ["--max-frames", str(APP_TIMED_FRAMES), "--ego-speed",
                                    str(APP_EGO_SPEED), "--state-shm",
                                    f"/avp_smoke_int8_pub_{os.getpid()}"],
                        capture_output=True, text=True, timeout=600)
    if r8.returncode != 0:
        raise AssertionError(f"the timed int8 loop failed ({r8.returncode}):\n{r8.stdout}\n"
                             f"{r8.stderr}")
    calls8_timed = int8_loop_calls(r8.stdout, APP_TIMED_FRAMES)
    print(f"native loop over the int8 lateral package, {APP_TIMED_FRAMES} frames, {card}: "
          f"{app_line(r8.stdout, 'visionpilot_app:')}; "
          f"{app_line(r8.stdout, 'int8 op calls a frame:')}; beside the f32 loop's in this "
          f"call: {app_line(stdout, 'visionpilot_app:')}")
    print(f"native loop publishing to {seg}, {APP_TIMED_FRAMES} frames, {card}: "
          f"{app_line(stdout, 'visionpilot_app:')}; the port's StatePublisherBridge "
          f"republished {len(ids)} states on an InProcTransport, frame ids {ids[0]}..{ids[-1]} "
          f"advancing; the last POD: frame {last.frame_number}, ego {last.ego_speed_ms!r} m/s, "
          f"ideal speed {last.ideal_speed_ms!r} m/s, RSS distance {last.safe_distance_m!r} m, "
          f"effort {last.control_effort_ms2!r} m/s^2, CIPO {bool(last.cipo_exists)} (seed-0 "
          f"AutoSpeed makes no track: phase 17); operator calls {calls2}")
    shutil.rmtree(out, ignore_errors=True)
    torch.cuda.empty_cache()
    total = {k: calls[k] + calls2[k] for k in calls}
    for k, v in as_launches({k: calls8.get(k, 0) + calls8_timed.get(k, 0)
                             for k in {*calls8, *calls8_timed}}).items():
        total[k] = total.get(k, 0) + v
    return total


def phase_compare_precisions(card):
    """Phase 40d: export/benchmark_models.py::compare_precisions on SceneSeg
    (seed 0) at (1, 3, 320, 640): ms/iter (CUDA events) and agreement with
    f32 for f32, bf16 and int8 weight-only PTQ."""
    from autoware_vision_pilot_tpu_torch.export.benchmark_models import (build as build_net,
                                                                          compare_precisions)

    res = compare_precisions(build_net("SceneSeg"), (1, 3, *OUT_HW), runs=50, name="SceneSeg",
                             device="cuda")
    for precision in ("bf16", "int8"):
        if not 0.0 <= res[precision]["miou_vs_f32"] <= 1.0:
            raise AssertionError(f"{precision}: {res[precision]}")
    print(f"compare_precisions SceneSeg (1, 3, 320, 640), 20 warm-up + 50 timed, {card}: " +
          "; ".join(f"{k} {v['ms_per_iter']!r} ms/iter" +
                    (f", mIoU vs f32 {v['miou_vs_f32']!r}" if k != "f32" else "")
                    for k, v in res.items()))
    torch.cuda.empty_cache()


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
    walls = {}  # each phase's wall time, printed by groups

    def timed(phase, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        walls[phase] = round(time.perf_counter() - t0, 1)
        return out

    card = timed(1, phase_device)
    sys.path.insert(0, str(REPO))
    timed(2, phase_build)
    app_build = start_app_build()  # phase 40c's C++ loop, built meanwhile
    parent = parent_kernels(parent_root)
    timed("2 floor", launch_floor, card)
    preprocess, crop = timed(3, phase_kernel)
    records = {"fused_preprocess": preprocess, **timed(4, phase_int8_kernels, card)}
    if parent is not None:
        phase_pointwise_parent(card, parent)
        phase_d2s_halo_parent(card, parent)
        phase_strided_parent(card, parent)
    records["lane_filter_walk"] = timed(5, phase_lane_filter, card, parent)
    timed(6, phase_f32)
    bf16_pipe = timed(7, phase_bf16, card)
    # the selective-int8 main path
    launches = timed(8, phase_int8, card, bf16_pipe, parent_root)
    del bf16_pipe
    torch.cuda.empty_cache()
    timed(9, phase_lateral_f32)
    lateral = timed(10, phase_lateral, card)  # the lateral program
    launches["lane_filter_walk"] = lateral["lane_filter_walk"]
    records["fused_letterbox"] = timed(11, phase_letterbox, card)
    if parent is not None:
        phase_letterbox_parent(card, parent)
    heads = timed(12, phase_longitudinal_f32)
    records["nms_greedy"] = timed(13, phase_nms, card, heads, parent)
    longitudinal = timed(14, phase_longitudinal, card)  # the longitudinal program
    launches["fused_letterbox"] = longitudinal["fused_letterbox"]
    launches["nms_greedy"] = longitudinal["nms_greedy"]
    batched = timed(15, phase_batched, card)
    timed(16, phase_fleet_f32)
    engine = timed(17, phase_engine, card)  # the serving engine (app.py::build_engine)
    fleet = timed(18, phase_fleet, card)  # the N-stream fleet
    for name in ("fused_preprocess", "lane_filter_walk", "fused_letterbox", "nms_greedy"):
        if engine[name] <= 0 or fleet[name] <= 0:
            raise AssertionError(f"the engine or the fleet never launched {name}")
        launches[name] += engine[name] + fleet[name]
    print(f"wall time of phases 1-18 (s): {walls}, {time.perf_counter() - T0:.1f} s since the "
          "start")
    # the per-network wrappers (inference/infer.py), the backend and the clip
    walls.clear()
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
    # the int8 remainder (the transposed conv, weight-only PTQ) and the importers
    walls.clear()
    records["int8_conv_transpose"] = timed(29, phase_transpose_kernel, card)
    transposed = timed(30, phase_int8_transpose, card)
    paths["int8 + transposes"] = {k: transposed[k] for k in (
        "int8_quantize", "int8_conv_wgmma", "int8_conv_pointwise", "int8_conv_dot",
        "int8_conv_transpose")}
    timed(31, phase_quantized_inference, card)
    timed(32, phase_importers, card)
    print(f"wall time of phases 29-32 (s): {walls}, {sum(walls.values()):.1f} s in all")
    # the serving remainder: the host IPC, the node graph, the app's outputs
    walls.clear()
    timed(33, phase_host_ipc, card)
    paths["node graph"] = timed(34, phase_node_graph, card)
    paths["app outputs"] = timed(35, phase_app_outputs, card)
    print(f"wall time of phases 33-35 (s): {walls}, {sum(walls.values()):.1f} s in all")
    # training: the step on the card against the CPU, the full-width bf16
    # step, and QAT exported onto the int8 kernels
    walls.clear()
    timed("36a", phase_train_f32)
    timed("36b", phase_train_bench, card)
    paths["QAT export"] = timed("36c", phase_qat_export, card)
    print(f"wall time of phase 36 (s): {walls}, {sum(walls.values()):.1f} s in all")
    # the remaining trainers: detection on the card against the CPU, the
    # detection trainer at full width with its validation on the NMS kernel,
    # and a few steps of each other trainer
    walls.clear()
    timed("37a", phase_det_f32)
    paths["detection validation"], _ = timed("37b", phase_det_bench, card)
    timed("37c", phase_other_trainers, card)
    print(f"wall time of phase 37 (s): {walls}, {sum(walls.values()):.1f} s in all")
    # data parallelism and the mesh: the train step over an NCCL world of 1 and a
    # gloo world of 2 on the one card, the fleet over a mesh of the card twice,
    # the sharded clip and tensor parallelism
    walls.clear()
    timed("38a", phase_dp_world_one, card)
    world = timed("38b start", start_dp_world_two)  # 38d and 38c's checks run meanwhile
    paths["sharded clip"] = {"fused_preprocess": timed("38d", phase_sharded_infer_and_tp, card)}
    timed("38c checks", phase_fleet_mesh_f32)
    timed("38b", phase_dp_world_two, card, world)
    paths["fleet over a mesh"] = timed("38c engine", phase_fleet_mesh_engine, card)
    print(f"wall time of phase 38 (s): {walls}, {sum(walls.values()):.1f} s in all")
    # the data layer: raw annotations through the parsers into the unified
    # layout, the loaders, and the legacy trainers on what they read
    walls.clear()
    timed(39, phase_data, card)
    print(f"wall time of phase 39 (s): {walls}")
    # the int8 path whole: strided convs on AutoSpeed's longitudinal step and
    # in the QAT export of AutoSteer-temporal
    walls.clear()
    paths["int8 longitudinal"] = timed("41a", phase_int8_longitudinal, card)
    paths["QAT export of AutoSteer-temporal"] = timed("41b", phase_int8_qat_temporal, card)
    print(f"wall time of phases 41a-41b (s): {walls}, {sum(walls.values()):.1f} s in all")
    # the native app's three AOTInductor bundles (40c's two, 41d's int8
    # lateral) compile in spawned processes, for minutes, while the accuracy
    # tools (phase 42: bars, not times) and 40a, 40b and 41c run
    walls.clear()
    app_out = REPO / "build" / f"native_app_{os.getpid()}"
    int8_lateral = timed("41d start", start_int8_lateral_export, app_out)
    native = timed("40c start", start_native_app_export, app_out)
    # the accuracy tools: the e2e demos, the QAT closure, the dataset and
    # checkpoint validation, the AutoSteer debug harness, each to its bar
    t0 = time.perf_counter()
    paths.update(phase_accuracy_tools(card))
    phase42 = time.perf_counter() - t0
    # the operators, the exported programs (the int8 main path among them),
    # the native app and the precisions
    timed("40a", phase_ops, card)
    paths["exported programs"] = timed("40b", phase_exports, card)
    paths["int8 exported programs"] = timed("41c", phase_int8_exports, card)
    paths["native app"] = timed("40c", phase_native_app, card, app_build, app_out, int8_lateral,
                                native)
    timed("40d", phase_compare_precisions, card)
    print(f"wall time of phases 40 and 41c-41d (s): {walls}, {sum(walls.values()):.1f} s in all "
          f"(and phase 42's {phase42:.1f} s while the bundles compiled)")
    # the bench tools, each as python -m at the JAX tool's defaults, and each
    # path that launches hand kernels once in process; on an idle host
    paths.update(phase_bench_tools(card))
    for path, counts in paths.items():
        for name, n in counts.items():
            # the paths at min_channels 128 and above tally the halo route
            # too, and have no conv for it (a window > 1 with C < 128)
            if n <= 0 and not (name == "int8_conv_halo" and path != "QAT export"):
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
        "int8_conv_halo": (pkg + "int8_conv_halo.cu",
                           "autoware_vision_pilot_tpu/nn/layers.py:110"),
        "int8_conv_strided": (pkg + "int8_conv_strided.cu",
                              "autoware_vision_pilot_tpu/nn/layers.py:110"),
        "int8_conv_pointwise": (pkg + "int8_pointwise.cu",
                                "autoware_vision_pilot_tpu/nn/layers.py:81"),
        "int8_conv_dot": (pkg + "int8_pointwise.cu", "autoware_vision_pilot_tpu/nn/layers.py:81"),
        "int8_conv_transpose": (pkg + "int8_conv_sm90.cu",
                                "autoware_vision_pilot_tpu/nn/layers.py:187"),
        "lane_filter_walk": (pkg + "lane_filter.cu",
                             "autoware_vision_pilot_tpu/perception/lane_filter.py:113"),
        "fused_letterbox": (pkg + "letterbox.cu",
                            "autoware_vision_pilot_tpu/ops/preprocess.py:86"),
        "nms_greedy": (pkg + "nms.cu", "autoware_vision_pilot_tpu/ops/postprocess.py:88"),
    }
    # The halo kernel keeps the windows > 1 with C < 128: the QAT
    # export's path (phase 36c) launches it. Each path's own kernels: the
    # int8 path's counts above, the lateral and longitudinal programs' here.
    for name in sources:
        if launches[name] <= 0:
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
