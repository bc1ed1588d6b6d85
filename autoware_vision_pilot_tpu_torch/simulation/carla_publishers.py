"""CARLA simulation publisher node family, the port of
autoware_vision_pilot_tpu/simulation/carla_publishers.py (N34 parity:
VisionPilot/simulation/CARLA/ROS2/src/{camera_publisher,odom_publisher,
waypoints_publisher,road_shape_publisher,carla_control_publisher}).

Each node is middleware-agnostic —
it publishes on the repo's `middleware.transport.Transport` interface
(InProcTransport for tests, Ros2Transport / ZenohTransport in
deployments) instead of binding to rclpy directly, and the CARLA client
is injected so the coordinate/geometry math is testable without a CARLA
server (the reference's nodes require a live simulator even to
unit-test a quaternion).

The load-bearing math kept exactly from the reference:
- CARLA's left-handed frame -> ROS right-handed (flip y, flip pitch/yaw)
  (pub_odom_node.py carla_transform_to_ros_pose)
- body-frame velocity via yaw rotation (pub_odom_node.py timer_callback)
- yaw -> quaternion, rpy -> rotation matrix
  (pub_waypoints_node.py:17-39)
- waypoint walk: 100 m lookahead at 2 m steps with constant
  10 m/s profile (pub_waypoints_node.py:13-15)
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Sequence

import numpy as np

from ..middleware.transport import Transport


# ------------------------------------------------------------------
# geometry (reference-exact)
# ------------------------------------------------------------------

def yaw_to_quaternion(yaw_deg: float) -> dict:
    """pub_waypoints_node.py:17-24."""
    yaw = math.radians(yaw_deg)
    return {"x": 0.0, "y": 0.0,
            "z": math.sin(yaw / 2.0), "w": math.cos(yaw / 2.0)}


def quaternion_from_euler(roll: float, pitch: float, yaw: float):
    """tf_transformations.quaternion_from_euler (sxyz), as used by the
    odom node."""
    cr, sr = math.cos(roll / 2), math.sin(roll / 2)
    cp, sp = math.cos(pitch / 2), math.sin(pitch / 2)
    cy, sy = math.cos(yaw / 2), math.sin(yaw / 2)
    return (sr * cp * cy - cr * sp * sy,
            cr * sp * cy + sr * cp * sy,
            cr * cp * sy - sr * sp * cy,
            cr * cp * cy + sr * sp * sy)


def rpy_to_matrix(roll: float, pitch: float, yaw: float) -> np.ndarray:
    """pub_waypoints_node.py:25-39."""
    cr, sr = math.cos(roll), math.sin(roll)
    cp, sp = math.cos(pitch), math.sin(pitch)
    cy, sy = math.cos(yaw), math.sin(yaw)
    return np.array([
        [cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
        [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
        [-sp, cp * sr, cp * cr]])


def carla_transform_to_pose(location, rotation) -> dict:
    """CARLA LH -> ROS RH: flip y, flip pitch/yaw signs
    (pub_odom_node.py carla_transform_to_ros_pose)."""
    q = quaternion_from_euler(math.radians(rotation.roll),
                              math.radians(-rotation.pitch),
                              math.radians(-rotation.yaw))
    return {"position": {"x": location.x, "y": -location.y,
                         "z": location.z},
            "orientation": {"x": q[0], "y": q[1], "z": q[2], "w": q[3]}}


def body_frame_velocity(velocity, yaw_deg: float) -> np.ndarray:
    """World velocity (LH, y flipped) rotated into the body frame
    (pub_odom_node.py timer_callback)."""
    yaw = math.radians(yaw_deg)
    c, s = math.cos(yaw), math.sin(yaw)
    R = np.array([[c, -s], [s, c]])
    return R @ np.array([velocity.x, -velocity.y])


# ------------------------------------------------------------------
# ego discovery
# ------------------------------------------------------------------

def find_ego_vehicle(world, role_name: str = "hero"):
    """pub_odom_node.py _find_ego_vehicle."""
    for actor in world.get_actors().filter("vehicle.*"):
        if actor.attributes.get("role_name") == role_name:
            return actor
    return None


# ------------------------------------------------------------------
# publisher nodes
# ------------------------------------------------------------------

class CarlaCameraPublisher:
    """camera_publisher: ego RGB camera frames -> `topic` as HxWx3 BGR
    uint8 arrays (the transport codec handles Image encoding on ROS2)."""

    def __init__(self, world, transport: Transport,
                 topic: str = "/sensing/camera/image_raw",
                 image_hw=(720, 1280), fov: float = 90.0,
                 role_name: str = "hero"):
        self.transport = transport
        self.topic = topic
        self.ego = find_ego_vehicle(world, role_name)
        if self.ego is None:
            raise RuntimeError("ego vehicle not found")
        bp = world.get_blueprint_library().find("sensor.camera.rgb")
        bp.set_attribute("image_size_x", str(image_hw[1]))
        bp.set_attribute("image_size_y", str(image_hw[0]))
        bp.set_attribute("fov", str(fov))
        import carla  # gated; only the node ctor needs the package
        cam_tf = carla.Transform(carla.Location(x=1.5, z=1.6))
        self.camera = world.spawn_actor(bp, cam_tf, attach_to=self.ego)
        self.camera.listen(self._on_image)

    def _on_image(self, image):
        arr = np.frombuffer(image.raw_data, np.uint8).reshape(
            image.height, image.width, 4)[:, :, :3]
        self.transport.publish(self.topic, arr.copy())


class CarlaOdomPublisher:
    """odom_publisher: ego transform + velocities -> '/hero/odom' dicts
    (nav_msgs/Odometry field layout)."""

    def __init__(self, world, transport: Transport,
                 topic: str = "/hero/odom", role_name: str = "hero"):
        self.world = world
        self.transport = transport
        self.topic = topic
        self.ego = find_ego_vehicle(world, role_name)

    def tick(self):
        if self.ego is None:
            self.ego = find_ego_vehicle(self.world)
            if self.ego is None:
                return None
        tf = self.ego.get_transform()
        vel = self.ego.get_velocity()
        ang = self.ego.get_angular_velocity()
        v_xy = body_frame_velocity(vel, tf.rotation.yaw)
        odom = {
            "header": {"frame_id": "odom"},
            "child_frame_id": "base_link",
            "pose": carla_transform_to_pose(tf.location, tf.rotation),
            "twist": {
                "linear": {"x": float(v_xy[0]), "y": float(v_xy[1]),
                           "z": vel.z},
                "angular": {"x": math.radians(ang.x),
                            "y": math.radians(-ang.y),
                            "z": math.radians(-ang.z)},
            },
        }
        self.transport.publish(self.topic, odom)
        return odom


@dataclasses.dataclass
class WaypointProfile:
    """pub_waypoints_node.py:13-15."""
    lookahead_m: float = 100.0
    step_m: float = 2.0
    speed_ms: float = 10.0


class CarlaWaypointsPublisher:
    """waypoints_publisher: walk the lane graph ahead of the ego and
    publish a constant-speed trajectory ('/planning/trajectory')."""

    def __init__(self, world, transport: Transport,
                 topic: str = "/planning/trajectory",
                 profile: WaypointProfile = WaypointProfile(),
                 role_name: str = "hero"):
        self.world = world
        self.map = world.get_map()
        self.transport = transport
        self.topic = topic
        self.profile = profile
        self.ego = find_ego_vehicle(world, role_name)

    def tick(self):
        if self.ego is None:
            return None
        wp = self.map.get_waypoint(self.ego.get_transform().location)
        points = []
        dist = 0.0
        while wp is not None and dist < self.profile.lookahead_m:
            tf = wp.transform
            q = yaw_to_quaternion(-tf.rotation.yaw)  # LH -> RH
            points.append({
                "pose": {"position": {"x": tf.location.x,
                                      "y": -tf.location.y,
                                      "z": tf.location.z},
                         "orientation": q},
                "longitudinal_velocity_mps": self.profile.speed_ms,
            })
            nxt = wp.next(self.profile.step_m)
            wp = nxt[0] if nxt else None
            dist += self.profile.step_m
        traj = {"header": {"frame_id": "map"}, "points": points}
        self.transport.publish(self.topic, traj)
        return traj


class CarlaRoadShapePublisher:
    """road_shape_publisher: lane-boundary polylines around the ego
    ('/perception/road_shape'), from lane width + waypoint transforms."""

    def __init__(self, world, transport: Transport,
                 topic: str = "/perception/road_shape",
                 lookahead_m: float = 60.0, step_m: float = 2.0,
                 role_name: str = "hero"):
        self.world = world
        self.map = world.get_map()
        self.transport = transport
        self.topic = topic
        self.lookahead_m = lookahead_m
        self.step_m = step_m
        self.ego = find_ego_vehicle(world, role_name)

    def tick(self):
        if self.ego is None:
            return None
        wp = self.map.get_waypoint(self.ego.get_transform().location)
        left, right = [], []
        dist = 0.0
        while wp is not None and dist < self.lookahead_m:
            tf = wp.transform
            half_w = wp.lane_width / 2.0
            yaw = math.radians(tf.rotation.yaw)
            # lateral unit vector in the RH frame (y flipped)
            nx, ny = -math.sin(yaw), -math.cos(yaw)
            cx, cy = tf.location.x, -tf.location.y
            left.append({"x": cx + nx * half_w, "y": cy + ny * half_w,
                         "z": tf.location.z})
            right.append({"x": cx - nx * half_w, "y": cy - ny * half_w,
                          "z": tf.location.z})
            nxt = wp.next(self.step_m)
            wp = nxt[0] if nxt else None
            dist += self.step_m
        shape = {"header": {"frame_id": "map"},
                 "left_boundary": left, "right_boundary": right}
        self.transport.publish(self.topic, shape)
        return shape


class CarlaControlSubscriber:
    """carla_control_publisher inverted to our transport: subscribes to
    the framework's control outputs and applies carla.VehicleControl —
    steering normalized by max wheel angle, accel effort split into
    throttle/brake (pub_carla_control_node.py)."""

    def __init__(self, world, transport: Transport,
                 steering_topic: str = "/control/steering_deg",
                 accel_topic: str = "/control/accel_effort",
                 max_steer_deg: float = 40.0, role_name: str = "hero"):
        self.ego = find_ego_vehicle(world, role_name)
        self.max_steer_deg = max_steer_deg
        self._steer = 0.0
        self._accel = 0.0
        transport.subscribe(steering_topic, self._on_steer)
        transport.subscribe(accel_topic, self._on_accel)

    def _on_steer(self, deg):
        self._steer = float(np.clip(float(deg) / self.max_steer_deg,
                                    -1.0, 1.0))
        self._apply()

    def _on_accel(self, effort):
        self._accel = float(effort)
        self._apply()

    def control_dict(self) -> dict:
        throttle = float(np.clip(self._accel / 3.0, 0.0, 1.0))
        brake = float(np.clip(-self._accel / 5.0, 0.0, 1.0))
        return {"steer": self._steer, "throttle": throttle, "brake": brake}

    def _apply(self):
        if self.ego is None:
            return
        import carla
        c = self.control_dict()
        self.ego.apply_control(carla.VehicleControl(
            throttle=c["throttle"], steer=c["steer"], brake=c["brake"]))
