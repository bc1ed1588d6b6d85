"""Simulation bridges, the port of
autoware_vision_pilot_tpu/simulation/carla_bridge.py (N34:
VisionPilot/simulation/CARLA + SODA.Sim).

- CarlaBridge: attaches to a CARLA server, spawns an ego vehicle + RGB
  camera matching the pipeline's expected intrinsics, streams frames into
  the pipeline's frame-source interface, and applies steering/throttle
  commands back (the CARLA/ROS2 publisher-package role). Gated on the
  `carla` client package.
- StatePublisherBridge: SHM -> transport bridge (the C++
  visionpilot_publisher role: simulation/CARLA/ROS2/src/
  visionpilot_publisher): reads the seqlock segment and republishes the
  control state on a middleware transport at a fixed rate.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Optional

import numpy as np

try:
    import carla  # pragma: no cover
    _HAS_CARLA = True
except ImportError:
    carla = None
    _HAS_CARLA = False


class CarlaBridge:
    def __init__(self, host: str = "localhost", port: int = 2000,
                 image_hw=(720, 1280), fov: float = 90.0):
        if not _HAS_CARLA:
            raise RuntimeError("carla client package not installed")
        self.client = carla.Client(host, port)
        self.client.set_timeout(10.0)
        self.world = self.client.get_world()
        self._frames: "queue.Queue[np.ndarray]" = queue.Queue(maxsize=2)
        self.image_hw = image_hw

        bp = self.world.get_blueprint_library()
        vehicle_bp = bp.filter("vehicle.*model3*")[0]
        spawn = self.world.get_map().get_spawn_points()[0]
        self.vehicle = self.world.spawn_actor(vehicle_bp, spawn)

        cam_bp = bp.find("sensor.camera.rgb")
        cam_bp.set_attribute("image_size_x", str(image_hw[1]))
        cam_bp.set_attribute("image_size_y", str(image_hw[0]))
        cam_bp.set_attribute("fov", str(fov))
        cam_tf = carla.Transform(carla.Location(x=1.5, z=1.6))
        self.camera = self.world.spawn_actor(cam_bp, cam_tf,
                                             attach_to=self.vehicle)
        self.camera.listen(self._on_image)

    def _on_image(self, image):
        arr = np.frombuffer(image.raw_data, np.uint8).reshape(
            image.height, image.width, 4)[:, :, :3]  # BGRA -> BGR
        try:
            self._frames.put_nowait(arr.copy())
        except queue.Full:
            try:
                self._frames.get_nowait()
                self._frames.put_nowait(arr.copy())
            except queue.Empty:
                pass

    def frame_source(self, timeout: float = 2.0) -> Optional[np.ndarray]:
        try:
            return self._frames.get(timeout=timeout)
        except queue.Empty:
            return None

    def apply_control(self, steering_deg: float, accel_effort: float,
                      max_steer_deg: float = 30.0):
        ctrl = carla.VehicleControl()
        ctrl.steer = float(np.clip(steering_deg / max_steer_deg, -1, 1))
        if accel_effort >= 0:
            ctrl.throttle = float(np.clip(accel_effort / 3.0, 0, 1))
        else:
            ctrl.brake = float(np.clip(-accel_effort / 5.0, 0, 1))
        self.vehicle.apply_control(ctrl)

    def ego_speed_ms(self) -> float:
        v = self.vehicle.get_velocity()
        return float(np.sqrt(v.x ** 2 + v.y ** 2 + v.z ** 2))

    def close(self):
        for a in (self.camera, self.vehicle):
            try:
                a.destroy()
            except Exception:
                pass


class StatePublisherBridge:
    """Reads /visionpilot_state via the C++ shim and republishes each new
    frame's state dict on a transport topic."""

    def __init__(self, transport, topic: str = "/visionpilot/state",
                 rate_hz: float = 30.0, shm_name: str = "/visionpilot_state"):
        from ..host.shm import SharedStateReader
        self.reader = SharedStateReader(shm_name)
        self.transport = transport
        self.topic = topic
        self.dt = 1.0 / rate_hz
        self._stop = threading.Event()
        self._last_frame = -1

    def spin(self, max_messages: Optional[int] = None) -> int:
        n = 0
        while not self._stop.is_set():
            if max_messages is not None and n >= max_messages:
                break
            s = self.reader.read()
            if s.frame_number != self._last_frame:
                self._last_frame = s.frame_number
                self.transport.publish(self.topic, {
                    "frame": int(s.frame_number),
                    "steering_deg": float(s.steering_pid_deg),
                    "cte_m": float(s.cte_m),
                    "yaw_error_rad": float(s.yaw_error_rad),
                    "ideal_speed_ms": float(s.ideal_speed_ms),
                    "control_effort_ms2": float(s.control_effort_ms2),
                    "cipo_exists": bool(s.cipo_exists),
                    "cipo_distance_m": float(s.cipo_distance_m),
                    "fcw": bool(s.fcw_active),
                    "aeb": bool(s.aeb_active),
                })
                n += 1
            time.sleep(self.dt)
        return n

    def stop(self):
        self._stop.set()

    def close(self):
        self.reader.close()
