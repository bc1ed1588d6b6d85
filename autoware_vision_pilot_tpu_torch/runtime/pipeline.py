"""The per-frame device programs, the port of
autoware_vision_pilot_tpu/runtime/pipeline.py:

  lateral:      crop -> fused preprocess (kernel) -> EgoLanes -> temporal
                AutoSteer (2-frame ring, main.cpp:473-535) -> threshold ->
                LaneFilter (the walk kernel + a weighted fit) ->
                LaneTracker (BEV) -> PathFinder (Bayes) -> steering
                controller + moving-average filter
  longitudinal: letterbox (the preprocess kernel's letterbox mode) ->
                AutoSpeed -> decode -> top-k -> greedy NMS (kernel) -> one
                packed (max_det, 7) table

One call of a step is one frame, on the device of the networks, with no
host synchronisation: everything stays on the card until the caller reads
the packed outputs. The JAX package runs each step as one XLA program; here
it is eager PyTorch around hand-written kernels. The longitudinal program's
host side (tracking, speed planning, PID) is not ported yet.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

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
from .config import Config


class LateralState(NamedTuple):
    prev_lane_raw: torch.Tensor     # (h, w, 3) f32 previous EgoLanes logits
    lane_filter: LaneFilterState
    lane_tracker: LaneTrackerState
    bayes: BayesState
    steering: SteeringState
    # PathFinder's process noise; it advances in place at each step (the JAX
    # state carries a key that the step splits)
    generator: torch.Generator


# layout of the packed lateral scalar vector (fetched in one round-trip)
SCALAR_FIELDS = ("steering_filtered", "steering_raw", "autosteer_deg",
                 "cte", "yaw_error", "lane_width", "fused_valid",
                 "path_valid")


def build_lateral_step(lanes: EgoLanesNetwork, steer_net: AutoSteerTemporalNet,
                       cfg: Config, frame_hw=(720, 1280), crop_y: int = 420,
                       dtype=torch.bfloat16, net_hw=(320, 640)):
    """The per-frame lateral step over two eval-mode networks that hold
    their weights in ``dtype`` on one device.

    Returns step(frame_u8, state, noise=None) -> (outputs, new LateralState):
    frame_u8 a contiguous (H, W, 3) uint8 BGR frame on that device; outputs
    {"scalars": (8,) f32 in SCALAR_FIELDS order, "coeffs": (3, 6) f32
    left/right/center, "lane_masks": (h/4, w/4, 3) f32}. ``noise`` replaces
    PathFinder's draw from ``state.generator`` (the tests pass in the JAX
    package's). net_hw is the EgoLanes input size; the state must then come
    from init_lateral_state(mask_hw=net_hw/4).
    """
    mask_hw = (net_hw[0] // 4, net_hw[1] // 4)
    image_hw = (frame_hw[0] - crop_y, frame_hw[1])
    s = cfg.steering
    K = (s.Kp, s.Ki, s.Kd, s.Ks)
    threshold = (cfg.models["egolanes"].threshold
                 if "egolanes" in cfg.models else 0.0)

    @torch.inference_mode()
    def step(frame_u8, state: LateralState, noise: Optional[torch.Tensor] = None):
        x = fused_preprocess(frame_u8[crop_y:], net_hw, dtype)   # (1, 3, h, w)
        lane_logits32 = lanes(x).permute(0, 2, 3, 1)[0].float()  # (h/4, w/4, 3)

        # temporal AutoSteer on [t-1, t] stacked logits
        stacked = torch.cat([state.prev_lane_raw, lane_logits32], -1)[None]
        _, curr_logits = steer_net(stacked.to(dtype).permute(0, 3, 1, 2))
        autosteer_deg = steering_from_logits(curr_logits.float())[0]
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
        ]).to(torch.float32)
        coeffs = torch.stack([trk.left_coeffs, trk.right_coeffs,
                              trk.center_coeffs]).to(torch.float32)
        outputs = {"scalars": scalars, "coeffs": coeffs, "lane_masks": masks}
        return outputs, new_state

    return step


def init_lateral_state(seed: int = 0, mask_hw=(80, 160), device="cuda") -> LateralState:
    return LateralState(
        prev_lane_raw=torch.zeros((*mask_hw, 3), device=device),
        lane_filter=LaneFilterState.init(device),
        lane_tracker=LaneTrackerState.init(device),
        bayes=BayesState.init(device=device),
        steering=steering_init(device),
        generator=torch.Generator(device=device).manual_seed(seed),
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


def build_longitudinal_step(net: AutoSpeedNetwork, cfg: Config, frame_hw=(720, 1280),
                            input_hw=(640, 640), dtype=torch.bfloat16, max_det: int = 64):
    """The per-frame AutoSpeed detection step over an eval-mode network (its
    CTX maps built for ``input_hw``) that holds its weights in ``dtype`` on
    one device: letterbox -> net -> decode -> fixed-shape NMS -> one packed
    (max_det, 7) f32 table [x1, y1, x2, y2, score, class_id, valid], rows
    past the kept boxes zero, on that device.

    Returns step(frame_u8), frame_u8 a contiguous ``frame_hw`` + (3,) uint8
    BGR frame on that device.
    """
    conf_t = cfg.longitudinal.conf_thresh
    iou_t = cfg.longitudinal.iou_thresh

    @torch.inference_mode()
    def step(frame_u8):
        if tuple(frame_u8.shape[:2]) != tuple(frame_hw):
            raise ValueError(f"frame {tuple(frame_u8.shape)}, the step is built for {frame_hw}")
        x, scale, pad = fused_letterbox(frame_u8, input_hw, dtype)   # (1, 3, h, w)
        pred = net(x)[0].float()                                      # (A, 4 + nc)
        boxes, scores, cls = decode_yolo_to_original(pred, scale, pad, frame_hw)
        b, s, c, v = nms_fixed(boxes, scores, cls, max_det=max_det, iou_thresh=iou_t,
                               conf_thresh=conf_t)
        return torch.cat([b, s[:, None], c[:, None].float(), v[:, None].float()], 1)

    return step


class LongitudinalPipeline:
    """AutoSpeed detection and NMS on the device, one frame per call; the
    host tracking and planning that consume the table are not ported yet."""

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
