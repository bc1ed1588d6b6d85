"""Runtime configuration: key=value .conf parser with a typed schema.

The port's own copy of autoware_vision_pilot_tpu/runtime/config.py (pure
Python; the JAX package's ``runtime`` package imports JAX when it loads, so
the port keeps this copy). Same file format and key schema as the
reference runtime (production_release/src/config/config_reader.cpp,
visionpilot.conf / VisionPilot.conf.example), and the same defaults, so a
deployment config parses to the same values in both packages.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, Optional


@dataclasses.dataclass
class ModelConfig:
    path: str = ""
    provider: str = "tpu"          # was: cpu/tensorrt -> now: tpu/cpu
    precision: str = "bf16"        # was: fp16/fp32 -> bf16/f32
    device_id: int = 0
    cache_dir: str = "./xla_cache"  # analog of the TRT engine cache
    threshold: float = 0.0


@dataclasses.dataclass
class SteeringParams:
    Kp: float = 0.33
    Ki: float = 0.01
    Kd: float = -0.40
    Ks: float = -0.3


@dataclasses.dataclass
class LongitudinalConfig:
    conf_thresh: float = 0.5
    iou_thresh: float = 0.5
    ego_speed_default_ms: float = 10.0
    pid_Kp: float = 0.5
    pid_Ki: float = 0.1
    pid_Kd: float = 0.05


@dataclasses.dataclass
class OutputConfig:
    enable_viz: bool = False
    save_video: bool = False
    output_video_path: str = "output.avi"
    measure_latency: bool = True
    csv_log_path: str = "./curve_params_metrics.csv"


@dataclasses.dataclass
class RerunConfig:
    enabled: bool = False
    spawn_viewer: bool = True
    save_path: str = "visionpilot.rrd"


@dataclasses.dataclass
class CanConfig:
    enabled: bool = False
    interface_name: str = "can0"


@dataclasses.dataclass
class Config:
    mode: str = "video"                 # "camera" | "video"
    video_path: str = ""
    camera_auto_select: bool = True
    camera_device_id: Optional[int] = None
    target_fps: float = 10.0
    models: Dict[str, ModelConfig] = dataclasses.field(default_factory=dict)
    homography_yaml: str = ""
    steering: SteeringParams = dataclasses.field(default_factory=SteeringParams)
    longitudinal: LongitudinalConfig = dataclasses.field(
        default_factory=LongitudinalConfig)
    output: OutputConfig = dataclasses.field(default_factory=OutputConfig)
    rerun: RerunConfig = dataclasses.field(default_factory=RerunConfig)
    can: CanConfig = dataclasses.field(default_factory=CanConfig)


def _to_bool(v: str) -> bool:
    return v.strip().lower() in ("1", "true", "yes", "on")


def parse_conf(text: str) -> Dict[str, str]:
    out = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        if "=" not in line:
            continue
        k, v = line.split("=", 1)
        out[k.strip()] = v.split("#")[0].strip()
    return out


def load_config(path: str | Path) -> Config:
    kv = parse_conf(Path(path).read_text())
    cfg = Config()
    cfg.mode = kv.get("mode", cfg.mode)
    cfg.video_path = kv.get("source.video.path", "")
    cfg.camera_auto_select = _to_bool(kv.get("source.camera.auto_select", "true"))
    dev = kv.get("source.camera.device_id", "")
    cfg.camera_device_id = int(dev) if dev else None
    cfg.target_fps = float(kv.get("pipeline.target_fps", cfg.target_fps))
    cfg.homography_yaml = kv.get("models.homography_yaml.path", "")

    # collect model sections
    names = set()
    for k in kv:
        if k.startswith("models.") and k.count(".") >= 2:
            name = k.split(".")[1]
            if name != "homography_yaml":
                names.add(name)
    for name in names:
        m = ModelConfig()
        m.path = kv.get(f"models.{name}.path", "")
        m.provider = kv.get(f"models.{name}.provider", m.provider)
        m.precision = kv.get(f"models.{name}.precision", m.precision)
        m.device_id = int(kv.get(f"models.{name}.device_id", m.device_id))
        m.cache_dir = kv.get(f"models.{name}.cache_dir", m.cache_dir)
        m.threshold = float(kv.get(f"models.{name}.threshold", m.threshold))
        cfg.models[name] = m

    s = cfg.steering
    s.Kp = float(kv.get("steering_control.Kp", s.Kp))
    s.Ki = float(kv.get("steering_control.Ki", s.Ki))
    s.Kd = float(kv.get("steering_control.Kd", s.Kd))
    s.Ks = float(kv.get("steering_control.Ks", s.Ks))

    l = cfg.longitudinal
    l.conf_thresh = float(kv.get("longitudinal.autospeed.conf_thresh", l.conf_thresh))
    l.iou_thresh = float(kv.get("longitudinal.autospeed.iou_thresh", l.iou_thresh))
    l.ego_speed_default_ms = float(
        kv.get("longitudinal.ego_speed_default_ms", l.ego_speed_default_ms))
    l.pid_Kp = float(kv.get("longitudinal.pid.Kp", l.pid_Kp))
    l.pid_Ki = float(kv.get("longitudinal.pid.Ki", l.pid_Ki))
    l.pid_Kd = float(kv.get("longitudinal.pid.Kd", l.pid_Kd))

    o = cfg.output
    o.enable_viz = _to_bool(kv.get("output.enable_viz", "false"))
    o.save_video = _to_bool(kv.get("output.save_video", "false"))
    o.output_video_path = kv.get("output.output_video_path", o.output_video_path)
    o.measure_latency = _to_bool(kv.get("output.measure_latency", "true"))
    o.csv_log_path = kv.get("output.csv_log_path", o.csv_log_path)

    r = cfg.rerun
    r.enabled = _to_bool(kv.get("rerun.enabled", "false"))
    r.spawn_viewer = _to_bool(kv.get("rerun.spawn_viewer", "true"))
    r.save_path = kv.get("rerun.save_path", r.save_path)

    c = cfg.can
    c.enabled = _to_bool(kv.get("can_interface.enabled", "false"))
    c.interface_name = kv.get("can_interface.interface_name", c.interface_name)
    return cfg
