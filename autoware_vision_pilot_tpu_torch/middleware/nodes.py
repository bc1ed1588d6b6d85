"""Middleware nodes over pluggable transports, the port of
autoware_vision_pilot_tpu/middleware/nodes.py.

Node/topic contract mirrors the ROS2 recipe
(middleware_recipes/ROS2/models/src/run_model_node.cpp:25-190,
run_autospeed_node.cpp:16-110, video_publisher_node, visualize_masks_node;
launch wiring run_pipeline.launch.py:11-80):

  VideoPublisherNode   -> publishes frames on `image_topic`
  RunModelNode         -> subscribes image_topic, runs a backend, publishes
                          seg mask (uint8 ids) or depth (float32) on
                          `output_topic`
  RunAutoSpeedNode     -> publishes detections (N,6 array) on output_topic
  MasksVisualizationNode -> subscribes image+mask, publishes blended overlay

Messages are plain numpy arrays over InProcTransport; byte codecs wrap
them for network transports. The model nodes run on the card unless given
``device="cpu"``: RunModelNode through middleware/backend.py (the
preprocess kernel, and the int8 kernels where its params ask for int8),
RunAutoSpeedNode through inference/infer.py::AutoSpeedInfer (the letterbox
and NMS kernels), PathFinderNode's Bayes filter on tensors.
"""
from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import torch

from .backend import InferenceBackend
from .transport import Transport
from ..runtime.timers import FpsTimer


class RunModelNode:
    """Generic model node (segmentation / depth / egolanes)."""

    def __init__(self, transport: Transport, backend: InferenceBackend,
                 image_topic: str = "/image_raw",
                 output_topic: str = "/model/output",
                 model_type: str = "segmentation",
                 benchmark: bool = False):
        self.transport = transport
        self.backend = backend
        self.output_topic = output_topic
        self.model_type = model_type
        self.timer = FpsTimer(name=output_topic) if benchmark else None
        transport.subscribe(image_topic, self.on_image)

    def on_image(self, frame_bgr_u8: np.ndarray):
        if self.timer:
            self.timer.start_new_frame()
            self.timer.record_preprocess_end()
        out = self.backend.do_inference(frame_bgr_u8)
        if self.timer:
            self.timer.record_inference_end()
        if self.model_type == "depth":
            msg = out[..., 0].astype(np.float32)       # 32FC1 analog
        elif self.model_type == "egolanes":
            msg = (out > 0.0).astype(np.uint8)          # 3ch binary masks
        else:
            msg = np.argmax(out, -1).astype(np.uint8)   # MONO8 class ids
        self.transport.publish(self.output_topic, msg)
        if self.timer:
            self.timer.record_output_end()


class RunAutoSpeedNode:
    """Detection node: letterbox -> AutoSpeed -> NMS ->
    (N,6) [x1,y1,x2,y2,score,class] float array (the Detection2DArray
    analog), through AutoSpeedInfer's device step at the node's own
    thresholds.

    ``model``: the AutoSpeedNetwork for ``input_hw``, built on the CPU in
    f32 (default: "n" with 4 classes); its weights are ``variables`` (the
    JAX package's tree as numpy), else drawn from seed 0."""

    def __init__(self, transport: Transport, model=None, variables=None,
                 image_topic: str = "/image_raw",
                 output_topic: str = "/autospeed/detections",
                 frame_hw: Tuple[int, int] = (720, 1280),
                 input_hw: Tuple[int, int] = (640, 640),
                 conf_thresh: float = 0.5, iou_thresh: float = 0.5,
                 dtype: torch.dtype = torch.bfloat16, device="cuda"):
        from ..inference.infer import AutoSpeedInfer
        self.transport = transport
        self.output_topic = output_topic
        self.infer = AutoSpeedInfer(variables=variables, frame_hw=frame_hw,
                                    input_hw=input_hw, conf_thresh=conf_thresh,
                                    iou_thresh=iou_thresh, dtype=dtype,
                                    device=device, model=model)
        transport.subscribe(image_topic, self.on_image)

    def on_image(self, frame_bgr_u8: np.ndarray):
        self.transport.publish(self.output_topic, self.infer.inference(frame_bgr_u8))


class VideoPublisherNode:
    """Source node: video file / camera -> image topic at a target rate
    (video_publisher_node + GStreamerEngine role)."""

    def __init__(self, transport: Transport, capture,
                 image_topic: str = "/image_raw", fps: float = 0.0):
        self.transport = transport
        self.capture = capture
        self.image_topic = image_topic
        self.dt = 1.0 / fps if fps else 0.0

    def spin(self, max_frames: Optional[int] = None) -> int:
        n = 0
        while max_frames is None or n < max_frames:
            t0 = time.perf_counter()
            ok, frame = self.capture.read()
            if not ok:
                break
            self.transport.publish(self.image_topic, frame)
            n += 1
            if self.dt:
                sleep = self.dt - (time.perf_counter() - t0)
                if sleep > 0:
                    time.sleep(sleep)
        return n


class MasksVisualizationNode:
    """Colorize + 50/50 blend (masks_visualization_engine.cpp:11-58)."""

    PALETTES = {
        "scene": np.array([[0, 0, 0], [0, 0, 255], [0, 0, 0]], np.uint8),
        "domain": np.array([[0, 0, 0], [0, 165, 255]], np.uint8),
        "egolanes": np.array([[0, 0, 0], [255, 0, 0], [0, 0, 255],
                              [0, 255, 0]], np.uint8),
    }

    def __init__(self, transport: Transport,
                 image_topic: str = "/image_raw",
                 mask_topic: str = "/model/output",
                 output_topic: str = "/viz/overlay",
                 palette: str = "scene"):
        import cv2
        self.cv2 = cv2
        self.transport = transport
        self.output_topic = output_topic
        self.palette = self.PALETTES[palette]
        self._last_image = None
        transport.subscribe(image_topic, self._on_image)
        transport.subscribe(mask_topic, self._on_mask)

    def _on_image(self, frame):
        self._last_image = frame

    def _on_mask(self, mask):
        if self._last_image is None:
            return
        img = self._last_image
        if mask.ndim == 3:  # egolanes channels -> single id map
            ids = np.zeros(mask.shape[:2], np.uint8)
            for c in range(mask.shape[-1]):
                ids[mask[..., c] > 0] = c + 1
            mask = ids
        color = self.palette[np.clip(mask, 0, len(self.palette) - 1)]
        color = self.cv2.resize(color, (img.shape[1], img.shape[0]),
                                interpolation=self.cv2.INTER_NEAREST)
        overlay = self.cv2.addWeighted(img, 0.5, color, 0.5, 0)
        self.transport.publish(self.output_topic, overlay)


class DepthVisualizationNode:
    """Depth colormap + blend (visualize_depth_node.cpp role): subscribes
    image + float depth map, publishes the colorized overlay."""

    def __init__(self, transport: Transport,
                 image_topic: str = "/image_raw",
                 depth_topic: str = "/model/depth",
                 output_topic: str = "/viz/depth",
                 blend: float = 0.5):
        import cv2
        self.cv2 = cv2
        self.transport = transport
        self.output_topic = output_topic
        self.blend = blend
        self._last_image = None
        transport.subscribe(image_topic, self._on_image)
        transport.subscribe(depth_topic, self._on_depth)

    def _on_image(self, frame):
        self._last_image = frame

    def _on_depth(self, depth):
        from ..utils.visualization import depth_to_colormap
        d = np.asarray(depth, np.float32)
        lo, hi = float(d.min()), float(d.max())
        d01 = (d - lo) / (hi - lo + 1e-8)
        color = depth_to_colormap(d01)
        if self._last_image is not None:
            img = self._last_image
            color = self.cv2.resize(color, (img.shape[1], img.shape[0]))
            color = self.cv2.addWeighted(img, 1 - self.blend, color,
                                         self.blend, 0)
        self.transport.publish(self.output_topic, color)


class PathFinderNode:
    """Bayes-filter tracking node (middleware_recipes/ROS2/PATHFINDER/
    src/pathfinder_node.cpp:22-35): subscribes the three lane paths
    (arrays of (x, y) meters; y forward) and publishes `tracked_states`
    — the 14 fused state means, so consumers read cte at [3], yaw_error
    at [7], curvature at [11] exactly like the reference's
    Float32MultiArray contract.

    The filter's state stays on ``device``; each tick draws its process
    noise from ``generator``, a torch.Generator on that device seeded with
    ``seed`` (the JAX node splits a key instead: the draws differ)."""

    MAX_PTS = 32

    def __init__(self, transport: Transport,
                 left_topic: str = "/egoLaneL",
                 right_topic: str = "/egoLaneR",
                 path_topic: str = "/egoPath",
                 states_topic: str = "/pathfinder/tracked_states",
                 seed: int = 0, device="cuda"):
        from ..perception.path_finder import BayesState
        self.transport = transport
        self.states_topic = states_topic
        self.device = torch.device(device)
        self.state = BayesState.init(device=self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._steer = torch.zeros((), device=self.device)
        self._left = None
        self._right = None
        transport.subscribe(left_topic, self._on_left)
        transport.subscribe(right_topic, self._on_right)
        transport.subscribe(path_topic, self._on_path)

    def _pack(self, pts):
        arr = np.zeros((self.MAX_PTS, 2), np.float32)
        mask = np.zeros((self.MAX_PTS,), bool)
        if pts is not None and len(pts):
            n = min(len(pts), self.MAX_PTS)
            arr[:n] = np.asarray(pts, np.float32)[:n]
            mask[:n] = True
        return torch.from_numpy(arr).to(self.device), torch.from_numpy(mask).to(self.device)

    def _on_left(self, pts):
        self._left = pts

    def _on_right(self, pts):
        self._right = pts

    def _on_path(self, pts):
        # the path message drives the update tick (pathfinder_node.cpp
        # updates on the egoPath callback)
        from ..perception.path_finder import path_finder_update
        lp, lm = self._pack(self._left)
        rp, rm = self._pack(self._right)
        _, self.state = path_finder_update(self.state, lp, lm, rp, rm, self._steer,
                                           generator=self.generator)
        means = self.state.mean.cpu().numpy()
        self.transport.publish(self.states_topic, means)
        return means


class SteeringControllerNode:
    """steering_controller_node.cpp:6-36: consumes tracked_states
    ([3]=cte, [7]=yaw_error, [11]=curvature) + odometry forward velocity,
    publishes /vehicle/steering_cmd."""

    def __init__(self, transport: Transport, K_p=0.33, K_i=0.11,
                 K_d=-0.40, K_S=1.0,
                 states_topic: str = "/pathfinder/tracked_states",
                 odom_topic: str = "/hero/odom",
                 cmd_topic: str = "/vehicle/steering_cmd"):
        from ..control.steering import SteeringController
        self.transport = transport
        self.cmd_topic = cmd_topic
        self.sc = SteeringController(K_p, K_i, K_d, K_S)
        self.forward_velocity = 0.0
        transport.subscribe(odom_topic, self._on_odom)
        transport.subscribe(states_topic, self._on_states)

    def _on_odom(self, odom):
        self.forward_velocity = float(
            odom["twist"]["linear"]["x"] if isinstance(odom, dict)
            else odom)

    def _on_states(self, data):
        data = np.asarray(data, np.float32)
        if data.size < 13:
            return None
        angle = self.sc.compute_steering(
            float(data[3]), float(data[7]), float(data[11]))
        self.transport.publish(self.cmd_topic, float(angle))
        return angle


class LongitudinalControllerNode:
    """longitudinal_controller_node.cpp: curvature-capped target speed,
    log-model feed-forward throttle, PI brake on deceleration demand;
    publishes /vehicle/{throttle,brake}_cmd."""

    # vel_to_throttle fit constants (longitudinal_controller_node.cpp:68-69)
    A, B = 5.94694605, 2.37747535

    def __init__(self, transport: Transport, target_vel: float = 10.0,
                 acc_lat_max: float = 2.0,
                 states_topic: str = "/pathfinder/tracked_states",
                 odom_topic: str = "/hero/odom",
                 imu_topic: str = "/carla/hero/imu",
                 throttle_topic: str = "/vehicle/throttle_cmd",
                 brake_topic: str = "/vehicle/brake_cmd"):
        from ..control.pi_controller import PIController
        self.transport = transport
        self.target_vel = target_vel
        self.acc_lat_max = acc_lat_max
        self.throttle_topic = throttle_topic
        self.brake_topic = brake_topic
        self.pi_brake = PIController(0.3, 0.05, 0.0)
        self.target_vel_capped = target_vel
        self.longitudinal_accel = 0.0
        transport.subscribe(states_topic, self._on_states)
        transport.subscribe(imu_topic, self._on_imu)
        transport.subscribe(odom_topic, self._on_odom)

    @classmethod
    def vel_to_throttle(cls, v: float) -> float:
        """Inverse of the fitted throttle->speed log model (:60-82)."""
        if v < 0:
            raise ValueError("speed must be non-negative")
        return float(np.clip(np.log(v / cls.A + 1.0) / cls.B, 0.0, 1.0))

    def _on_states(self, data):
        data = np.asarray(data, np.float32)
        if data.size < 13:
            return
        curv = abs(float(data[11]))
        self.target_vel_capped = min(
            self.target_vel, np.sqrt(self.acc_lat_max / max(curv, 1e-6)))

    def _on_imu(self, imu):
        self.longitudinal_accel = float(
            imu["linear_acceleration"]["x"] if isinstance(imu, dict)
            else imu)

    def _on_odom(self, odom):
        v = float(odom["twist"]["linear"]["x"] if isinstance(odom, dict)
                  else odom)
        ff = 0.0 if v > self.target_vel_capped else self.vel_to_throttle(
            self.target_vel_capped)
        target_accel = (self.target_vel_capped - v) / 0.02
        brake = self.pi_brake.compute_effort(-self.longitudinal_accel,
                                             -target_accel)
        brake_cmd = float(np.clip(brake, 0.0, 1.0)) \
            if target_accel < -2.5 else 0.0
        throttle_cmd = float(np.clip(ff, 0.0, 1.0))
        self.transport.publish(self.throttle_topic, throttle_cmd)
        self.transport.publish(self.brake_topic, brake_cmd)
        return throttle_cmd, brake_cmd


def launch_pipeline(transport: Transport, params: dict,
                    make_backend=None, make_detector=None, device="cuda"):
    """Build the node graph from an autoseg.yaml-style parameter dict
    (ROS2/models/config/autoseg.yaml + run_pipeline.launch.py:11-80):
    each top-level key with `ros__parameters` becomes a RunModelNode, or
    a RunAutoSpeedNode when model_type == 'detection'; returns the nodes.

    make_backend(params_dict) -> InferenceBackend overrides the default
    backend factory (backend.backend_from_params on ``device``);
    make_detector(params_dict) -> (model, variables) supplies the
    detection net (defaults to AutoSpeed "n" with 4 classes at 640x640,
    weights from seed 0, as app.py::build_engine draws them). The nodes
    run on ``device``.
    """
    nodes = {}
    for name, cfg in params.items():
        p = cfg.get("ros__parameters", cfg)
        if p.get("model_type") == "detection":
            model, variables = make_detector(p) if make_detector is not None else (None, None)
            nodes[name] = RunAutoSpeedNode(
                transport, model, variables,
                image_topic=p.get("input_topic", "/image_raw"),
                output_topic=p.get("output_topic", f"/{name}/detections"),
                device=device)
        else:
            if make_backend is not None:
                backend = make_backend(p)
            else:
                from .backend import backend_from_params
                backend = backend_from_params(p, device=device)
            nodes[name] = RunModelNode(
                transport, backend,
                model_type=p.get("model_type", "segmentation"),
                image_topic=p.get("input_topic", "/image_raw"),
                output_topic=p.get("output_topic", f"/{name}/mask"))
    return nodes
