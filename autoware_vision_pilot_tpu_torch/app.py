"""VisionPilot standalone application on PyTorch: the port of
autoware_vision_pilot_tpu/app.py.

The main.cpp analog: loads the .conf, opens the frame source (video or
camera), builds the lateral and longitudinal device programs on the card,
and runs the loop with CSV flight recording, SHM seqlock publishing
(host/shm.py), Rerun telemetry, the display/video composite and CAN
polling. Graceful degradation everywhere (missing CAN / SHM / viz never
kill the pipeline — main.cpp:1832-1933 contract).

``AppOutputs`` is the loop's sink: a caller may run it on ``build_engine``
with a frame source of its own. The composite and Rerun read the lane masks
on the host; an engine with a sink copies them with the frame's other
results at dispatch, so the sink waits on no device work.

Run:  python -m autoware_vision_pilot_tpu_torch.app --config visionpilot.conf \\
          [--max-frames N] [--no-shm] [--device cuda|cpu]

The networks run in bf16 on the card and in f32 on the CPU.
"""
from __future__ import annotations

import argparse
import sys
import time
from collections import deque
from pathlib import Path

import numpy as np
import torch

from .convert.from_jax import variables_to_state_dict
from .drivers.can_interface import CanInterface
from .export.checkpoints import load_msgpack
from .models.auto_speed import AutoSpeedNetwork
from .models.auto_steer_temporal import AutoSteerTemporalNet
from .models.ego_lanes import EgoLanesNetwork
from .nn.layers import init_seeded
from .perception.tracking import ObjectFinder
from .runtime.config import Config, load_config
from .runtime.pipeline import SCALAR_FIELDS, LateralPipeline, LongitudinalPipeline, PipelineEngine
from .utils import visualization as viz
from .utils.csv_logger import CsvFlightRecorder


def _load_model_vars(cfg: Config, name: str, model: torch.nn.Module,
                     generator: torch.Generator) -> torch.nn.Module:
    """``model`` (on the CPU, f32) with weights drawn from ``generator``, as
    the build_*_pipeline functions draw them; then the msgpack weight file
    of ``cfg.models[name].path`` when it exists (the JAX package's
    save_msgpack format, read without JAX), else a random-init warning."""
    init_seeded(model, generator)
    mc = cfg.models.get(name)
    if mc and mc.path and Path(mc.path).exists():
        model.load_state_dict(variables_to_state_dict(load_msgpack(mc.path), model))
        return model
    print(f"[app] WARNING: no weights for {name} "
          f"({mc.path if mc else 'unconfigured'}) — random init")
    return model


def _on(model: torch.nn.Module, device, dtype) -> torch.nn.Module:
    model.to(device=device, dtype=dtype, memory_format=torch.channels_last)
    return model.eval()


def load_homography(cfg: Config) -> np.ndarray:
    """The image -> world homography of ``cfg.homography_yaml`` (its "H"
    node, a list or a {data: [...]} map, through
    calibration/homography.py::load_homography_yaml), or the identity."""
    if cfg.homography_yaml and Path(cfg.homography_yaml).exists():
        from .calibration import load_homography_yaml
        return load_homography_yaml(cfg.homography_yaml)
    return np.eye(3)


def build_engine(cfg: Config, frame_source, sink=None, frame_hw=(720, 1280),
                 dtype=torch.bfloat16, device="cuda") -> PipelineEngine:
    """EgoLanes at 320x640, temporal AutoSteer on 80x160 masks, AutoSpeed
    "n" with 4 classes at 640x640 (weights from ``cfg.models``, else drawn
    from seed 0: the weights of build_lateral_pipeline and
    build_longitudinal_pipeline), the homography of ``cfg.homography_yaml``
    and an ObjectFinder, on ``device`` in ``dtype``; ``sink`` goes to the
    PipelineEngine."""
    cpu = dict(device="cpu", dtype=torch.float32)
    lateral_gen = torch.Generator().manual_seed(0)
    lanes = _load_model_vars(cfg, "egolanes", EgoLanesNetwork((10, 20), **cpu), lateral_gen)
    steer = _load_model_vars(cfg, "autosteer", AutoSteerTemporalNet((80, 160), **cpu),
                             lateral_gen)
    speed = _load_model_vars(cfg, "autospeed", AutoSpeedNetwork("n", 4, 640, 640, **cpu),
                             torch.Generator().manual_seed(0))
    lateral = LateralPipeline(_on(lanes, device, dtype), _on(steer, device, dtype), cfg,
                              frame_hw=frame_hw, dtype=dtype)
    longitudinal = LongitudinalPipeline(_on(speed, device, dtype), cfg, frame_hw=frame_hw,
                                        dtype=dtype)
    finder = ObjectFinder(load_homography(cfg), frame_hw[1], frame_hw[0])
    return PipelineEngine(cfg, lateral, longitudinal, finder, frame_source, sink=sink)


def compose_display_frame(res, lat_out, tracking, frame, wheel,
                          fps: float = 0.0, crop_y: int = 420,
                          ego=None, wheel_gt=None):
    """Unified display composite in the reference's exact overlay order
    (unifiedDisplayThread, main.cpp:881-974): tracked boxes -> lane masks
    through the cropped-ROI work-res pipeline -> display resize +
    steering wheels (pred + CAN ground truth) -> LDW -> AEB/FCW -> CIPO
    HUD -> frame/sync labels. `frame` is the raw BGR capture; returns
    the annotated copy. The fps overlay is an addition over the
    reference (it prints FPS to stdout instead). ``lat_out["lane_masks"]``
    is on the host (numpy, or a CPU tensor)."""
    tracked, cipo_id = (), -1
    if tracking is not None:
        tracked = tracking.tracked_objects
        cipo_id = tracking.cipo.track_id if tracking.cipo.exists else -1
    gt_deg = None
    if ego is not None and getattr(ego, "valid", False) and \
            not np.isnan(getattr(ego, "steering_angle_deg", np.nan)):
        gt_deg = ego.steering_angle_deg
    out = viz.unified_display_frame(
        frame, np.asarray(lat_out["lane_masks"], np.float32),
        tracked_objects=tracked, cipo_track_id=cipo_id,
        steering_deg=res.steering_deg, gt_steering_deg=gt_deg,
        wheel_pred=wheel, wheel_gt=wheel_gt if wheel_gt is not None
        else wheel,
        lane_departure=res.lane_departure, fcw=res.fcw, aeb=res.aeb,
        cipo_exists=res.cipo_distance >= 0,
        ideal_speed_ms=res.set_speed, safe_distance_m=res.safe_distance,
        control_effort_ms2=res.accel_effort, frame_num=res.frame_num,
        crop_y=crop_y)
    if fps > 0:
        import cv2
        cv2.putText(out, f"{fps:.1f} FPS", (10, 110),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.7, (255, 255, 255), 2)
    return out


class AppOutputs:
    """The app loop's outputs for each FrameResult, as the JAX app's sink
    writes them: the CSV flight record, the SHM state (``shm``, a
    host/shm.py SharedStatePublisher, or None), Rerun telemetry
    (``rerun.enabled``; a no-op without the SDK), and the display composite
    for the MJPG video (``output.save_video``) and the window
    (``output.enable_viz``). ``can`` is a CanInterface or None.

    Pass ``sink`` to build_engine; ``close`` releases
    the CSV file, the video writer and the SHM segment."""

    def __init__(self, cfg: Config, shm=None, can=None):
        self.cfg = cfg
        self.shm = shm
        self.can = can
        self.csv_log = CsvFlightRecorder(cfg.output.csv_log_path) \
            if cfg.output.csv_log_path else None
        # Rerun telemetry (graceful: no SDK -> no-op), main.cpp:46-48 +
        # rerun.* config keys
        self.rerun_log = None
        if cfg.rerun.enabled:
            from .utils.rerun_logger import RerunLogger
            self.rerun_log = RerunLogger(spawn_viewer=cfg.rerun.spawn_viewer,
                                         save_path=cfg.rerun.save_path or None)
        self.writer = None
        if cfg.output.save_video:
            import cv2
            self.writer = cv2.VideoWriter(
                cfg.output.output_video_path,
                cv2.VideoWriter_fourcc(*"MJPG"),
                cfg.target_fps or 10.0, (1280, 720))
        self.rerun_on = self.rerun_log is not None and self.rerun_log.enabled
        self.composing = self.writer is not None or cfg.output.enable_viz or self.rerun_on
        self.wheel = viz.make_steering_wheel_image() if self.composing else None
        # instantaneous HUD FPS over a 30-frame window (a cumulative average
        # would be dominated by the first-frame warm-up for the whole run)
        self.frame_times = deque(maxlen=30)

    def compose(self, res, lat_out, tracking, frame, ego=None):
        now = time.perf_counter()
        self.frame_times.append(now)
        span = self.frame_times[-1] - self.frame_times[0]
        fps = (len(self.frame_times) - 1) / span if span > 0 else 0.0
        return compose_display_frame(res, lat_out, tracking, frame,
                                     self.wheel, fps=fps, ego=ego)

    def publish_state(self, res, ego=None):
        """The FrameResult (and the CAN state) into the SHM segment."""
        from .host.shm import VisionPilotStateStruct
        s = VisionPilotStateStruct()
        s.frame_number = res.frame_num
        s.steering_pid_deg = res.steering_deg
        s.cte_m = res.cte
        s.yaw_error_rad = res.yaw_error
        s.lane_departure_warning = res.lane_departure
        s.cipo_exists = res.cipo_distance >= 0
        s.cipo_distance_m = max(res.cipo_distance, 0.0)
        s.cipo_velocity_ms = res.cipo_velocity
        s.cut_in_detected = res.cut_in
        s.kalman_reset = res.kalman_reset
        s.ideal_speed_ms = res.set_speed
        s.fcw_active = res.fcw
        s.aeb_active = res.aeb
        s.control_effort_ms2 = res.accel_effort
        if ego is not None:
            s.ego_speed_ms = ego.speed_ms
            s.ego_steering_angle_deg = ego.steering_angle_deg
            s.can_valid = ego.valid
        else:
            s.ego_speed_ms = float("nan")
            s.can_valid = False
        self.shm.publish(s)

    def sink(self, res, lat_out, tracking, frame=None):
        cfg = self.cfg
        if self.can is not None:
            self.can.update()
            ego = self.can.get_state()
        else:
            ego = None
        if self.csv_log:
            self.csv_log.log(
                frame=res.frame_num,
                steering_deg=res.steering_deg,
                cte_m=res.cte, yaw_error_rad=res.yaw_error,
                set_speed_ms=res.set_speed,
                accel_effort_ms2=res.accel_effort,
                cipo_exists=res.cipo_distance >= 0,
                cipo_distance_m=res.cipo_distance,
                cipo_velocity_ms=res.cipo_velocity,
                fcw=res.fcw, aeb=res.aeb, cut_in=res.cut_in,
                kalman_reset=res.kalman_reset,
                ego_speed_ms=(ego.speed_ms if ego else float("nan")),
                can_valid=(ego.valid if ego else False),
            )
        if self.shm is not None:
            self.publish_state(res, ego)
        composite = None
        if frame is not None and self.composing:
            composite = self.compose(res, lat_out, tracking, frame, ego)
        if self.rerun_on:
            masks = np.asarray(lat_out["lane_masks"], np.float32)
            sc = dict(zip(SCALAR_FIELDS, np.asarray(lat_out["scalars"])))
            self.rerun_log.log_data(
                res.frame_num, frame_bgr=frame,
                ego_left=masks[..., 0], ego_right=masks[..., 1],
                other_lanes=masks[..., 2],
                stacked_view_bgr=composite,
                can_steering_deg=(ego.steering_angle_deg if ego else 0.0),
                can_speed_kmph=(ego.speed_ms * 3.6 if ego else 0.0),
                can_valid=(ego.valid if ego else False),
                pid_steering_raw_deg=float(sc["steering_raw"]),
                pid_steering_filtered_deg=res.steering_deg,
                autosteer_deg=float(sc["autosteer_deg"]),
                cte=res.cte, yaw_error=res.yaw_error,
                # AutoSteer angle substitutes curvature feed-forward
                # (path_finder.cpp:95-97): log the same fused signal
                curvature=float(sc["autosteer_deg"]) * np.pi / 180.0,
                fused_valid=bool(sc["fused_valid"] > 0.5))
        if composite is not None:
            if self.writer is not None:
                self.writer.write(composite)
            if cfg.output.enable_viz:
                try:
                    import cv2
                    cv2.imshow("VisionPilot-TPU", composite)
                    cv2.waitKey(1)
                except Exception:
                    pass

    def close(self):
        if self.csv_log:
            self.csv_log.close()
        if self.writer:
            self.writer.release()
        if self.shm:
            self.shm.close()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--no-shm", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = load_config(args.config)

    # frame source
    from .drivers import camera
    if camera.cv2 is None:
        raise RuntimeError(f"mode={cfg.mode} needs cv2 (OpenCV), which is not installed")
    if cfg.mode == "video":
        cap = camera.open_video(cfg.video_path)
    else:
        cap = camera.open_camera(cfg.camera_device_id
                                 if not cfg.camera_auto_select else None)

    def frame_source():
        ok, frame = cap.read()
        return frame if ok else None

    # CAN (graceful)
    can = CanInterface(cfg.can.interface_name) if cfg.can.enabled else None

    # SHM publisher (graceful)
    shm = None
    if not args.no_shm:
        try:
            from .host.shm import SharedStatePublisher
            shm = SharedStatePublisher()
        except Exception as e:
            print(f"[app] SHM publish disabled: {e}")

    outputs = AppOutputs(cfg, shm=shm, can=can)
    t_start = time.perf_counter()
    dtype = torch.bfloat16 if torch.device(args.device).type == "cuda" else torch.float32
    try:
        engine = build_engine(cfg, frame_source, sink=outputs.sink, dtype=dtype,
                              device=args.device)
        results = engine.run(max_frames=args.max_frames)
    finally:
        cap.release()
        outputs.close()
    dt = time.perf_counter() - t_start
    n = len(results)
    print(f"[app] processed {n} frames in {dt:.1f}s "
          f"({n / dt:.1f} FPS incl. warmup)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
