"""The per-frame device programs and their host orchestration, the port of
autoware_vision_pilot_tpu/runtime/pipeline.py:

  lateral:      crop -> fused preprocess (kernel) -> EgoLanes -> temporal
                AutoSteer (2-frame ring, main.cpp:473-535) -> threshold ->
                LaneFilter (the walk kernel + a weighted fit) ->
                LaneTracker (BEV) -> PathFinder (Bayes) -> steering
                controller + moving-average filter
  longitudinal: letterbox (the letterbox kernel) ->
                AutoSpeed -> decode -> top-k -> greedy NMS (kernel) -> one
                packed (max_det, 7) table
  host:         PipelineEngine: capture -> upload -> {lateral,
                longitudinal} -> ObjectFinder tracking -> RSS speed
                planning -> longitudinal PID -> sink

One call of a step is one frame, on the device of the networks, with no
host synchronisation: everything stays on the card until the caller reads
the packed outputs. The JAX package runs each step as one XLA program; here
it is eager PyTorch around hand-written kernels. Each step also exists for a
batch of N independent streams (``build_batched_lateral_step``,
``build_batched_longitudinal_step``): one set of launches a tick for all N,
which runtime/fleet.py serves; the single-stream steps are those at N = 1,
through views. The host side (tracking, planning, PID) stays in numpy, as
in the JAX package.
"""
from __future__ import annotations

import dataclasses
import inspect
import math
import queue
import threading
import time
from collections import deque
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..control.pi_controller import PIController
from ..control.speed_planner import SpeedPlanner
from ..control.steering import SteeringState, steering_init, steering_step
from ..models.auto_speed import AutoSpeedNetwork
from ..models.auto_steer_temporal import AutoSteerTemporalNet, steering_from_logits
from ..models.ego_lanes import EgoLanesNetwork
from ..nn.layers import init_seeded
from ..ops.kernels.nms_kernel import nms_fixed
from ..ops.kernels.preprocess_kernel import fused_letterbox, fused_preprocess
from ..ops.postprocess import decode_yolo_to_original, threshold_channels
from ..perception.lane_filter import LaneFilterState, lane_filter_update
from ..perception.lane_tracker import (LaneTrackerState, bev_pixels_to_meters,
                                       lane_tracker_update)
from ..perception.path_finder import BayesState, path_finder_update
from ..perception.tracking import ObjectFinder
from .config import Config
from .timers import PerformanceMetrics


class ThreadSafeQueue:
    """Bounded queue with drop-oldest backpressure (main.cpp:86-143)."""

    def __init__(self, max_size: int = 2):
        self.q = queue.Queue(maxsize=max_size)

    def push(self, item):
        while True:
            try:
                self.q.put_nowait(item)
                return
            except queue.Full:
                try:
                    self.q.get_nowait()
                except queue.Empty:
                    pass

    def pop(self, timeout=0.1):
        try:
            return self.q.get(timeout=timeout)
        except queue.Empty:
            return None


class DoubleFrameBuffer:
    """Ping-pong latest-frame buffer with condvar (main.cpp:150-219)."""

    def __init__(self):
        self._lock = threading.Condition()
        self._frame = None
        self._frame_num = -1
        self._last_read = -1

    def write(self, frame, frame_num):
        with self._lock:
            self._frame = frame
            self._frame_num = frame_num
            self._lock.notify_all()

    def wait_for_new_frame(self, timeout=0.5):
        with self._lock:
            if self._frame_num <= self._last_read:
                self._lock.wait(timeout)
            if self._frame_num <= self._last_read:
                return None, -1
            self._last_read = self._frame_num
            return self._frame, self._frame_num


class LateralState(NamedTuple):
    prev_lane_raw: torch.Tensor     # (..., h, w, 3) f32 previous EgoLanes logits
    lane_filter: LaneFilterState
    lane_tracker: LaneTrackerState
    bayes: BayesState
    steering: SteeringState
    # PathFinder's process noise; it advances in place at each step (the JAX
    # state carries a key that the step splits). A batch of streams holds a
    # tuple of generators, one a stream (stream_generators).
    generator: object


# layout of the packed lateral scalar vector (fetched in one round-trip)
SCALAR_FIELDS = ("steering_filtered", "steering_raw", "autosteer_deg",
                 "cte", "yaw_error", "lane_width", "fused_valid",
                 "path_valid")


def _map_state(state: LateralState, fn, gen) -> LateralState:
    """``state`` with ``fn`` applied to every tensor and ``gen`` to the
    generator field."""
    def sub(t):
        return type(t)(*(fn(v) for v in t))
    return LateralState(fn(state.prev_lane_raw), sub(state.lane_filter),
                        sub(state.lane_tracker), sub(state.bayes), sub(state.steering),
                        gen(state.generator))


def build_batched_lateral_step(lanes: EgoLanesNetwork, steer_net: AutoSteerTemporalNet,
                               cfg: Config, frame_hw=(720, 1280), crop_y: int = 420,
                               dtype=torch.bfloat16, net_hw=(320, 640)):
    """The per-tick lateral step over N independent streams, on two
    eval-mode networks that hold their weights in ``dtype`` on one device:
    the JAX package's fleet step (``jax.vmap`` of its lateral step) with the
    stream axis written out. Each kernel of the tick is one launch for all N
    streams (the preprocess kernel reads the crop ``frames[:, crop_y:]`` in
    place), and each stream's state is its own.

    Returns step(frames_u8, state, noise=None) -> (outputs, new
    LateralState): frames_u8 (N, H, W, 3) uint8 BGR on that device, its
    frames each contiguous; state from init_lateral_states (every tensor
    with a leading N axis, a generator a stream); outputs {"scalars": (N, 8)
    f32 in SCALAR_FIELDS order, "coeffs": (N, 3, 6) f32 left/right/center,
    "lane_masks": (N, h/4, w/4, 3) f32}. ``noise`` (N, 14) replaces
    PathFinder's draws from the streams' generators (the tests pass in the
    JAX package's).
    """
    mask_hw = (net_hw[0] // 4, net_hw[1] // 4)
    image_hw = (frame_hw[0] - crop_y, frame_hw[1])
    s = cfg.steering
    K = (s.Kp, s.Ki, s.Kd, s.Ks)
    threshold = (cfg.models["egolanes"].threshold
                 if "egolanes" in cfg.models else 0.0)

    @torch.inference_mode()
    def step(frames_u8, state: LateralState, noise: Optional[torch.Tensor] = None):
        x = fused_preprocess(frames_u8[:, crop_y:], net_hw, dtype)   # (N, 3, h, w)
        # contiguous, as the walk kernel reads its masks: the card's channels_last
        # output already is; a trace's meta convs may give another layout
        lane_logits32 = lanes(x).permute(0, 2, 3, 1).float().contiguous()  # (N, h/4, w/4, 3)

        # temporal AutoSteer on [t-1, t] stacked logits
        stacked = torch.cat([state.prev_lane_raw, lane_logits32], -1)
        _, curr_logits = steer_net(stacked.to(dtype).permute(0, 3, 1, 2))
        autosteer_deg = steering_from_logits(curr_logits.float())     # (N,)
        autosteer_rad = autosteer_deg * (math.pi / 180.0)

        masks = threshold_channels(lane_logits32, threshold)
        lc, lv, rc, rv, lf_state, _, _ = lane_filter_update(masks, state.lane_filter)

        trk, lt_state = lane_tracker_update(
            lc, lv, rc, rv, state.lane_tracker, model_hw=mask_hw, image_hw=image_hw)

        left_m = bev_pixels_to_meters(trk.bev_left_pts)
        right_m = bev_pixels_to_meters(trk.bev_right_pts)
        pf_out, bayes = path_finder_update(
            state.bayes, left_m, trk.bev_left_mask, right_m, trk.bev_right_mask,
            autosteer_rad, generator=state.generator, noise=noise)

        # reference call site (main.cpp:580-589): steering computed only on
        # fused_valid frames, yaw_error in DEGREES, feed-forward = the fused
        # curvature channel (the Bayes-fused AutoSteer angle); the
        # moving-average ring advances only on bev-valid frames
        filtered, raw_angle, steer_state = steering_step(
            state.steering, pf_out.cte, pf_out.yaw_error * (180.0 / math.pi),
            pf_out.curvature, *K, fused_valid=pf_out.fused_valid,
            bev_valid=trk.path_valid)

        new_state = LateralState(lane_logits32, lf_state, lt_state, bayes,
                                 steer_state, state.generator)
        scalars = torch.stack([
            filtered, raw_angle, autosteer_deg,
            pf_out.cte, pf_out.yaw_error, pf_out.lane_width,
            pf_out.fused_valid.to(torch.float32),
            trk.path_valid.to(torch.float32),
        ], -1).to(torch.float32)
        coeffs = torch.stack([trk.left_coeffs, trk.right_coeffs,
                              trk.center_coeffs], -2).to(torch.float32)
        outputs = {"scalars": scalars, "coeffs": coeffs, "lane_masks": masks}
        return outputs, new_state

    return step


def build_lateral_step(lanes: EgoLanesNetwork, steer_net: AutoSteerTemporalNet,
                       cfg: Config, frame_hw=(720, 1280), crop_y: int = 420,
                       dtype=torch.bfloat16, net_hw=(320, 640)):
    """The per-frame lateral step of one stream: the batched step at N = 1,
    through views of the frame, the state and the outputs.

    Returns step(frame_u8, state, noise=None) -> (outputs, new LateralState):
    frame_u8 a contiguous (H, W, 3) uint8 BGR frame on the networks' device;
    outputs {"scalars": (8,) f32 in SCALAR_FIELDS order, "coeffs": (3, 6)
    f32 left/right/center, "lane_masks": (h/4, w/4, 3) f32}. ``noise`` (14,)
    replaces PathFinder's draw from ``state.generator`` (the tests pass in
    the JAX package's). net_hw is the EgoLanes input size; the state must
    then come from init_lateral_state(mask_hw=net_hw/4).
    """
    batched = build_batched_lateral_step(lanes, steer_net, cfg, frame_hw=frame_hw,
                                         crop_y=crop_y, dtype=dtype, net_hw=net_hw)

    def step(frame_u8, state: LateralState, noise: Optional[torch.Tensor] = None):
        out, new = batched(frame_u8[None], _map_state(state, lambda t: t[None], lambda g: (g,)),
                           None if noise is None else noise[None])
        return ({k: v[0] for k, v in out.items()},
                _map_state(new, lambda t: t[0], lambda g: g[0]))

    return step


STREAM_SEED_STEP = 0x9E3779B9  # odd: i -> seed + i * step is one-to-one mod 2**32


def stream_generators(n: int, seed: int = 0, device="cuda", first: int = 0) -> tuple:
    """PathFinder's generators of streams ``first`` to ``first + n - 1``:
    stream i's is seeded with ``(seed + i * 0x9E3779B9) mod 2**32`` (a seed
    of 32 bits, which the CPU generator keeps whole), so that the streams
    draw independent noise, stream 0 draws what a single-stream pipeline
    seeded with ``seed`` draws, and a stream keeps its seed on whichever
    shard of a fleet it lands. The counterpart of the JAX fleet's
    ``jax.random.split(key(seed), n)`` (the two give different numbers)."""
    if not 0 <= seed < 2 ** 32:
        raise ValueError(f"seed must be in [0, 2**32), got {seed}")
    return tuple(torch.Generator(device=device).manual_seed((seed + i * STREAM_SEED_STEP)
                                                            % 2 ** 32)
                 for i in range(first, first + n))


def init_lateral_state(seed: int = 0, mask_hw=(80, 160), device="cuda") -> LateralState:
    return LateralState(
        prev_lane_raw=torch.zeros((*mask_hw, 3), device=device),
        lane_filter=LaneFilterState.init(device),
        lane_tracker=LaneTrackerState.init(device),
        bayes=BayesState.init(device=device),
        steering=steering_init(device),
        generator=torch.Generator(device=device).manual_seed(seed),
    )


def init_lateral_states(n: int, seed: int = 0, mask_hw=(80, 160), device="cuda",
                        first: int = 0) -> LateralState:
    """The initial state of N streams, from stream ``first`` on: every
    tensor with a leading N axis, and ``stream_generators(n, seed,
    first=first)``."""
    streams = (n,)
    return LateralState(
        prev_lane_raw=torch.zeros((n, *mask_hw, 3), device=device),
        lane_filter=LaneFilterState.init(device, streams),
        lane_tracker=LaneTrackerState.init(device, streams),
        bayes=BayesState.init(device=device, streams=streams),
        steering=steering_init(device, streams),
        generator=stream_generators(n, seed, device, first),
    )


class LateralPipeline:
    """The lateral step over two networks, one frame per call, on their
    device."""

    def __init__(self, lanes: EgoLanesNetwork, steer_net: AutoSteerTemporalNet,
                 cfg: Config, frame_hw=(720, 1280), crop_y: int = 420,
                 dtype=torch.bfloat16, net_hw=(320, 640)):
        self.lanes = lanes
        self.steer_net = steer_net
        self.mask_hw = (net_hw[0] // 4, net_hw[1] // 4)
        self.device = next(lanes.parameters()).device
        self._step = build_lateral_step(lanes, steer_net, cfg, frame_hw=frame_hw,
                                        crop_y=crop_y, dtype=dtype, net_hw=net_hw)

    def init_state(self, seed: int = 0) -> LateralState:
        return init_lateral_state(seed, self.mask_hw, self.device)

    def __call__(self, frame_u8, state: LateralState, noise=None):
        return self._step(frame_u8, state, noise)


def build_lateral_pipeline(device="cuda", dtype=torch.bfloat16, seed: int = 0,
                           cfg: Optional[Config] = None,
                           frame_hw: Tuple[int, int] = (720, 1280), crop_y: int = 420,
                           net_hw: Tuple[int, int] = (320, 640),
                           backbone_stages=None) -> LateralPipeline:
    """EgoLanes (full depth unless ``backbone_stages`` says otherwise; its
    context at net_hw / 32) and AutoSteer (for net_hw / 4 masks) with
    weights drawn from ``seed`` on the CPU, as
    pipeline.py::build_pipeline_fused draws them (the same weights on every
    device), then moved to ``device`` in ``dtype`` and channels_last."""
    generator = torch.Generator().manual_seed(seed)
    kw = dict(device="cpu", dtype=torch.float32)
    ctx_hw = (net_hw[0] // 32, net_hw[1] // 32)
    lanes = EgoLanesNetwork(ctx_hw, backbone_stages, **kw)
    steer_net = AutoSteerTemporalNet((net_hw[0] // 4, net_hw[1] // 4), **kw)
    for m in (lanes, steer_net):
        init_seeded(m, generator)
        m.to(device=device, dtype=dtype, memory_format=torch.channels_last)
        m.eval()
    return LateralPipeline(lanes, steer_net, cfg or Config(), frame_hw=frame_hw,
                           crop_y=crop_y, dtype=dtype, net_hw=net_hw)


def build_batched_longitudinal_step(net: AutoSpeedNetwork, cfg: Config,
                                    frame_hw=(720, 1280), input_hw=(640, 640),
                                    dtype=torch.bfloat16, max_det: int = 64):
    """The per-tick AutoSpeed detection step over N streams, on an
    eval-mode network (its CTX maps built for ``input_hw``) that holds its
    weights in ``dtype`` on one device: letterbox -> net at batch N ->
    decode -> fixed-shape NMS -> one packed (N, max_det, 7) f32 table
    [x1, y1, x2, y2, score, class_id, valid], rows past each stream's kept
    boxes zero, on that device. The letterbox and NMS kernels each launch
    once for all N.

    Returns step(frames_u8), frames_u8 (N,) + ``frame_hw`` + (3,) uint8 BGR
    frames on that device, each contiguous.
    """
    conf_t = cfg.longitudinal.conf_thresh
    iou_t = cfg.longitudinal.iou_thresh

    @torch.inference_mode()
    def step(frames_u8):
        if frames_u8.dim() != 4 or tuple(frames_u8.shape[1:3]) != tuple(frame_hw):
            raise ValueError(f"frames {tuple(frames_u8.shape)}, the step is built for "
                             f"(N, {frame_hw[0]}, {frame_hw[1]}, 3)")
        x, scale, pad = fused_letterbox(frames_u8, input_hw, dtype)  # (N, 3, h, w)
        pred = net(x).float()                                         # (N, A, 4 + nc)
        boxes, scores, cls = decode_yolo_to_original(pred, scale, pad, frame_hw)
        b, s, c, v = nms_fixed(boxes, scores, cls, max_det=max_det, iou_thresh=iou_t,
                               conf_thresh=conf_t)
        return torch.cat([b, s[..., None], c[..., None].float(), v[..., None].float()], -1)

    return step


def build_longitudinal_step(net: AutoSpeedNetwork, cfg: Config, frame_hw=(720, 1280),
                            input_hw=(640, 640), dtype=torch.bfloat16, max_det: int = 64):
    """The per-frame AutoSpeed detection step of one stream: the batched
    step at N = 1, through views. Returns step(frame_u8) -> the (max_det, 7)
    table, frame_u8 a contiguous ``frame_hw`` + (3,) uint8 BGR frame on the
    network's device."""
    batched = build_batched_longitudinal_step(net, cfg, frame_hw=frame_hw, input_hw=input_hw,
                                              dtype=dtype, max_det=max_det)

    def step(frame_u8):
        if tuple(frame_u8.shape[:2]) != tuple(frame_hw):
            raise ValueError(f"frame {tuple(frame_u8.shape)}, the step is built for {frame_hw}")
        return batched(frame_u8[None])[0]

    return step


class LongitudinalPipeline:
    """AutoSpeed detection and NMS on the device, one frame per call; the
    host tracking, speed planning and PID that consume its table run in
    ``PipelineEngine._harvest``."""

    def __init__(self, net: AutoSpeedNetwork, cfg: Config, frame_hw=(720, 1280),
                 input_hw=(640, 640), dtype=torch.bfloat16, max_det: int = 64):
        self.net = net
        self.cfg = cfg
        self._step = build_longitudinal_step(net, cfg, frame_hw=frame_hw, input_hw=input_hw,
                                             dtype=dtype, max_det=max_det)

    def __call__(self, frame_u8):
        return self._step(frame_u8)


def build_longitudinal_pipeline(device="cuda", dtype=torch.bfloat16, seed: int = 0,
                                cfg: Optional[Config] = None,
                                frame_hw: Tuple[int, int] = (720, 1280),
                                input_hw: Tuple[int, int] = (640, 640),
                                max_det: int = 64) -> LongitudinalPipeline:
    """AutoSpeed "n" with 4 classes, its CTX maps built for ``input_hw``,
    with weights drawn from ``seed`` on the CPU (the same weights on every
    device), then moved to ``device`` in ``dtype`` and channels_last."""
    net = AutoSpeedNetwork("n", 4, *input_hw, device="cpu", dtype=torch.float32)
    init_seeded(net, torch.Generator().manual_seed(seed))
    net.to(device=device, dtype=dtype, memory_format=torch.channels_last)
    net.eval()
    return LongitudinalPipeline(net, cfg or Config(), frame_hw=frame_hw, input_hw=input_hw,
                                dtype=dtype, max_det=max_det)


# ---------- the host side: PipelineEngine ----------

def sink_wants_frame(sink) -> bool:
    """True if a result sink should receive the raw frame as a 4th
    POSITIONAL argument (display/video composition). Sinks may take
    (res, lat_out, tracking) or additionally the frame; *args sinks
    receive it, **kwargs-only extras do not count as a positional slot."""
    if sink is None:
        return False
    try:
        params = inspect.signature(sink).parameters.values()
    except (TypeError, ValueError):
        return False
    n_pos = sum(p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
                for p in params)
    return n_pos >= 4 or any(p.kind == p.VAR_POSITIONAL for p in params)


@dataclasses.dataclass
class FrameResult:
    frame_num: int
    steering_deg: float = 0.0
    cte: float = 0.0
    yaw_error: float = 0.0
    set_speed: float = 0.0
    accel_effort: float = 0.0
    safe_distance: float = 0.0
    cipo_distance: float = -1.0
    cipo_velocity: float = 0.0
    fcw: bool = False
    aeb: bool = False
    cut_in: bool = False
    kalman_reset: bool = False
    n_tracks: int = 0
    lane_departure: bool = False


def lane_departure(s) -> bool:
    """Drift beyond 50 % of the lane half-width (main.cpp unified-display
    warning contract), from the packed scalars as a {field: value} dict."""
    lane_w = abs(float(s["lane_width"]))
    return bool(s["fused_valid"] > 0.5 and lane_w > 0.1 and
                abs(float(s["cte"])) > 0.5 * (lane_w / 2.0))


def detections(table) -> list:
    """A packed (max_det, 7) host table -> [(x1, y1, x2, y2, score,
    class_id)] of its valid rows, as ObjectFinder takes them."""
    vv = table[:, 6] > 0.5
    return [(*table[i, :4], table[i, 4], int(table[i, 5])) for i in range(len(vv)) if vv[i]]


class DeviceStaging:
    """The copies between the host and the device of the engines' frames in
    flight: ``slots`` host buffers of each shape, used in turn, pinned on a
    CUDA device so that the copies are asynchronous, and a CUDA event per
    frame that marks its results on the host.

    A slot is rewritten ``slots`` frames after it was last used; the engines
    take ``pipeline_depth + 1`` slots and harvest frame i before they upload
    frame i + depth + 1, so a slot is never rewritten before its copy has
    run (that frame's event has completed) and been read. On the CPU the
    frames go in as they are and the results are copied at once."""

    def __init__(self, slots: int, device):
        self.n = slots
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self._bufs = {}

    def _slot(self, name, i, shape, dtype):
        key = (name, tuple(shape), dtype)
        if key not in self._bufs:
            self._bufs[key] = [torch.empty(shape, dtype=dtype, pin_memory=self.cuda)
                               for _ in range(self.n)]
        return self._bufs[key][i % self.n]

    def upload(self, frame: np.ndarray, i: int) -> torch.Tensor:
        """Host uint8 frame(s) -> a contiguous device copy, by slot i."""
        if not self.cuda:
            return torch.from_numpy(np.ascontiguousarray(frame)).to(self.device)
        slot = self._slot("frame", i, frame.shape, torch.uint8)
        slot.numpy()[...] = frame
        return slot.to(self.device, non_blocking=True)

    def download(self, i: int, *results: torch.Tensor):
        """Starts the copies of device results into host slot i -> (the
        host tensors, an event recorded after the copies, or None on the
        CPU). Read the host tensors only after ``done(event)``."""
        host = []
        for j, r in enumerate(results):
            slot = self._slot(f"result {j}", i, r.shape, r.dtype)
            slot.copy_(r, non_blocking=self.cuda)
            host.append(slot)
        event = None
        if self.cuda:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
        return host, event

    def mark(self):
        """A timing event recorded now on the current stream (None on the
        CPU): the engines record one before each frame's upload."""
        if not self.cuda:
            return None
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event


class PipelineEngine:
    """Host orchestration: capture -> {lateral, longitudinal} -> sink.

    frame_source: callable returning a uint8 BGR frame (H, W, 3) numpy
    array, a (host_frame, device_frame) pair, or None to end the run.
    sink: callable(FrameResult, lateral_outputs, tracking_result), or with a
    4th positional argument the host frame. With a sink, "scalars" and
    "lane_masks" (for a display composite) in its lateral outputs are host
    tensors, copied with the frame's other results at dispatch; the rest
    stay on the device. The host copies live in staging slots that frame +
    pipeline_depth + 1 reuses: a sink that keeps one past its call copies
    it.

    The frame goes up through a ring of pinned staging buffers, one per
    frame in flight, with ``non_blocking=True``; at dispatch the two
    per-frame results (the (8,) scalars and the (64, 7) table) start
    ``non_blocking`` copies into pinned host slots, and a CUDA event is
    recorded (with a sink, the lane masks' copy too); ``_harvest`` waits on
    that frame's event only. The dispatch side makes no host
    synchronisation (``run(sync_check=True)`` runs it under
    ``torch.cuda.set_sync_debug_mode("error")``). ``device_ms`` holds,
    per harvested frame, the device time from its upload to its results on
    the host (CUDA events; empty on the CPU).
    """

    def __init__(self, cfg: Config, lateral: LateralPipeline,
                 longitudinal: Optional[LongitudinalPipeline],
                 object_finder: Optional[ObjectFinder],
                 frame_source: Callable[[], Optional[np.ndarray]],
                 sink: Optional[Callable] = None):
        self.cfg = cfg
        self.lateral = lateral
        self.longitudinal = longitudinal
        self.object_finder = object_finder
        self.frame_source = frame_source
        self.sink = sink
        self._sink_wants_frame = sink_wants_frame(sink)
        self.buffer = DoubleFrameBuffer()
        self.metrics = PerformanceMetrics()
        self.speed_planner = SpeedPlanner(
            ego_speed=cfg.longitudinal.ego_speed_default_ms,
            is_cipo_present=False)
        self.pid = PIController(cfg.longitudinal.pid_Kp,
                                cfg.longitudinal.pid_Ki,
                                cfg.longitudinal.pid_Kd)
        self.device = lateral.device
        self.device_ms = []
        self._stop = threading.Event()

    def warmup(self, frame_hw=(720, 1280)):
        """Absorb first-dispatch latency (kernel builds, cuDNN's choices)
        before going live — the reference's warm-up inference contract
        (main.cpp:1641-1680)."""
        dummy = torch.zeros((*frame_hw, 3), dtype=torch.uint8, device=self.device)
        state = self.lateral.init_state(seed=999)
        self.lateral(dummy, state)
        if self.longitudinal is not None:
            self.longitudinal(dummy)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _harvest(self, frame_num, frame, lat_out, scalars, table=None, done=None,
                 started=None):
        """The host side of one frame: wait for its results (``done``, its
        event), then run the longitudinal state machines on its detection
        table and build its FrameResult (host work for frame N-1 overlaps
        frame N's device compute in run()). ``scalars`` and ``table`` are
        the host copies of the packed lateral scalar vector and the packed
        detection table (None without a longitudinal program)."""
        if done is not None:
            done.synchronize()
            if started is not None:
                self.device_ms.append(started.elapsed_time(done))
        res = FrameResult(frame_num=frame_num)
        tracking = None
        if table is not None:
            table = np.asarray(table)           # (max_det, 7)
            dets = detections(table)
            if self.object_finder is not None:
                tracking = self.object_finder.update_and_get_cipo(dets, frame)
                sp = self.speed_planner
                sp.set_ego_speed(self.cfg.longitudinal.ego_speed_default_ms)
                sp.set_is_cipo_present(tracking.cipo.exists)
                if tracking.cipo.exists:
                    sp.set_cipo_state(tracking.cipo.velocity_ms,
                                      tracking.cipo.distance_m)
                set_speed = sp.calc_ideal_driving_speed()
                if tracking.cut_in_detected or tracking.kalman_reset:
                    self.pid.reset()
                effort = self.pid.compute_effort(sp.ego_speed, set_speed)
                res.set_speed = set_speed
                res.accel_effort = effort
                res.safe_distance = sp.calc_safe_rss_distance()
                res.fcw = sp.get_fcw_state()
                res.aeb = sp.get_aeb_state()
                res.cut_in = tracking.cut_in_detected
                res.kalman_reset = tracking.kalman_reset
                res.n_tracks = len(tracking.tracked_objects)
                if tracking.cipo.exists:
                    res.cipo_distance = tracking.cipo.distance_m
                    res.cipo_velocity = tracking.cipo.velocity_ms

        s = dict(zip(SCALAR_FIELDS, np.asarray(scalars)))   # (8,)
        res.steering_deg = float(s["steering_filtered"])
        res.cte = float(s["cte"])
        res.yaw_error = float(s["yaw_error"])
        res.lane_departure = lane_departure(s)

        if self.sink is not None:
            if self._sink_wants_frame:
                self.sink(res, lat_out, tracking, frame)
            else:
                self.sink(res, lat_out, tracking)
        return res

    def run(self, max_frames: Optional[int] = None, warmup: bool = False,
            pipeline_depth: int = 1, sync_check: bool = False):
        """Dual-pipeline loop with k-frame software pipelining: frame N's
        device programs are dispatched (queued on the card) before frame
        N-k's results are harvested, hiding device latency behind host
        work — the same decoupling the reference gets from its
        capture/display threads (main.cpp DoubleFrameBuffer + result
        queues). Results stream with a `pipeline_depth`-frame delay, in
        order. The lateral state never leaves the device. ``sync_check``
        runs each dispatch under sync-debug "error": any host
        synchronisation there raises."""
        if warmup:
            self.warmup()
        depth = max(1, int(pipeline_depth))
        staging = DeviceStaging(depth + 1, self.device)
        target_dt = 1.0 / self.cfg.target_fps if self.cfg.target_fps else 0.0
        lat_state = self.lateral.init_state()
        frame_num = 0
        results = []
        pending = deque()
        while not self._stop.is_set():
            if max_frames is not None and frame_num >= max_frames:
                break
            t0 = time.perf_counter()
            frame = self.frame_source()
            if frame is None:
                break
            t_cap = time.perf_counter()
            # dispatch frame N (queued on the card) and start the copies of
            # its two per-frame results to the host
            with _sync_debug(sync_check):
                started = staging.mark()
                # frame_source may return (host_frame, device_frame) — e.g.
                # a prefetcher that uploads ahead (the DoubleFrameBuffer
                # role): the device frame feeds the programs, the host view
                # feeds the host-side tracking (ORB crops) without a fetch.
                if isinstance(frame, tuple):
                    frame, dev_frame = frame
                else:
                    dev_frame = staging.upload(frame, frame_num)
                lat_out, lat_state = self.lateral(dev_frame, lat_state)
                names = ("scalars", "lane_masks") if self.sink else ("scalars",)
                outs = [lat_out[k] for k in names]
                if self.longitudinal is not None:
                    outs.append(self.longitudinal(dev_frame))
                host, done = staging.download(frame_num, *outs)
            t_inf = time.perf_counter()

            # harvest frame N-depth while N..N-depth+1 execute
            lat_out = {**lat_out, **dict(zip(names, host))}
            pending.append((frame_num, frame, lat_out, host[0],
                            host[len(names)] if len(host) > len(names) else None, done,
                            started))
            if len(pending) > depth:
                results.append(self._harvest(*pending.popleft()))
            frame_num += 1
            t_end = time.perf_counter()
            self.metrics.add_frame(capture_s=t_cap - t0,
                                   inference_s=t_inf - t_cap,
                                   display_s=t_end - t_inf,
                                   e2e_s=t_end - t0)
            if target_dt:
                sleep = target_dt - (time.perf_counter() - t0)
                if sleep > 0:
                    time.sleep(sleep)
        while pending:
            results.append(self._harvest(*pending.popleft()))
        return results

    def stop(self):
        self._stop.set()


class _sync_debug:
    """Sync-debug "error" on the current CUDA device while ``on``."""

    def __init__(self, on: bool):
        self.on = on

    def __enter__(self):
        if self.on:
            self._was = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")

    def __exit__(self, *exc):
        if self.on:
            torch.cuda.set_sync_debug_mode(self._was)
