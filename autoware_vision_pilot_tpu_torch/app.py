"""VisionPilot standalone application on PyTorch: the port of
autoware_vision_pilot_tpu/app.py.

The main.cpp analog: loads the .conf, opens the frame source (video or
camera), builds the lateral and longitudinal device programs on the card,
and runs the loop with CSV flight recording and CAN polling. Missing CAN
never kills the pipeline (main.cpp:1832-1933 contract).

Not in the port yet (ROADMAP Queue 1 item 5): the SHM publisher
(host/shm.py, a native library), the Rerun logger and the display/video
composite (utils/visualization.py). A config that asks for video output,
the display or Rerun is refused with an error that says so; SHM prints the
JAX package's own "[app] SHM publish disabled: ..." line.

Run:  python -m autoware_vision_pilot_tpu_torch.app --config visionpilot.conf \\
          [--max-frames N] [--no-shm] [--device cuda|cpu]

The networks run in bf16 on the card and in f32 on the CPU.
"""
from __future__ import annotations

import argparse
import sys
import time
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
from .runtime.pipeline import LateralPipeline, LongitudinalPipeline, PipelineEngine
from .utils.csv_logger import CsvFlightRecorder

UNPORTED = "not ported yet (ROADMAP Queue 1 item 5: {})"


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
    and an ObjectFinder, on ``device`` in ``dtype``."""
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


def refuse_unported(cfg: Config):
    """Raises NotImplementedError if ``cfg`` asks for an output the port
    does not have yet."""
    asks = [(cfg.output.save_video, "output.save_video", "the video writer of "
             "utils/visualization.py"),
            (cfg.output.enable_viz, "output.enable_viz", "utils/visualization.py with "
             "compose_display_frame"),
            (cfg.rerun.enabled, "rerun.enabled", "utils/rerun_logger.py")]
    for on, key, what in asks:
        if on:
            raise NotImplementedError(f"{key}: {UNPORTED.format(what)}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--no-shm", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = load_config(args.config)
    refuse_unported(cfg)

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

    if not args.no_shm:
        print(f"[app] SHM publish disabled: host/shm.py is {UNPORTED.format('host/shm.py')}")

    csv_log = CsvFlightRecorder(cfg.output.csv_log_path) \
        if cfg.output.csv_log_path else None

    t_start = time.perf_counter()

    def sink(res, lat_out, tracking, frame=None):
        if can is not None:
            can.update()
            ego = can.get_state()
        else:
            ego = None
        if csv_log:
            csv_log.log(
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

    dtype = torch.bfloat16 if torch.device(args.device).type == "cuda" else torch.float32
    engine = build_engine(cfg, frame_source, sink=sink, dtype=dtype, device=args.device)
    try:
        results = engine.run(max_frames=args.max_frames)
    finally:
        cap.release()
        if csv_log:
            csv_log.close()
    dt = time.perf_counter() - t_start
    n = len(results)
    print(f"[app] processed {n} frames in {dt:.1f}s "
          f"({n / dt:.1f} FPS incl. warmup)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
