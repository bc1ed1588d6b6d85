"""The simulation bridges of the port (simulation/*) against the JAX
package's: the cases of tests/test_carla_publishers.py and
tests/test_simulation_bridge.py, with the same fake CARLA world, and every
message equal to the one the JAX module publishes for the same world. The
state bridge reads the port's shared-memory segment (host/shm.py builds
libavp_host.so; its path is handed to the JAX bindings too)."""
from __future__ import annotations

import math
import os
import threading
import time
import types

import numpy as np
import pytest

from autoware_vision_pilot_tpu.host import shm as jshm
from autoware_vision_pilot_tpu.middleware import InProcTransport as JInProc
from autoware_vision_pilot_tpu.simulation import carla_publishers as jpub
from autoware_vision_pilot_tpu.simulation import soda_sim as jsoda
from autoware_vision_pilot_tpu.simulation import StatePublisherBridge as JBridge

from autoware_vision_pilot_tpu_torch.host import shm as tshm
from autoware_vision_pilot_tpu_torch.middleware.transport import InProcTransport
from autoware_vision_pilot_tpu_torch.simulation import carla_publishers as tpub
from autoware_vision_pilot_tpu_torch.simulation import soda_sim as tsoda
from autoware_vision_pilot_tpu_torch.simulation import StatePublisherBridge

from test_torch_train_step import one_thread  # noqa: F401 (an autouse fixture)


# ----------------------------------------------------------- fake carla

def V(x=0.0, y=0.0, z=0.0):
    return types.SimpleNamespace(x=x, y=y, z=z)


def R(roll=0.0, pitch=0.0, yaw=0.0):
    return types.SimpleNamespace(roll=roll, pitch=pitch, yaw=yaw)


class FakeActor:
    def __init__(self, role="hero", loc=None, rot=None):
        self.attributes = {"role_name": role}
        self._tf = types.SimpleNamespace(location=loc or V(10, 5, 0.2),
                                         rotation=rot or R(yaw=90.0))
        self.controls = []

    def get_transform(self):
        return self._tf

    def get_velocity(self):
        return V(3.0, 4.0, 0.0)

    def get_angular_velocity(self):
        return V(0.0, 0.0, 10.0)

    def apply_control(self, c):
        self.controls.append(c)


class FakeWaypoint:
    def __init__(self, x, step=2.0, lane_width=3.6, n_left=100):
        self.transform = types.SimpleNamespace(
            location=V(x, 0.0, 0.0), rotation=R(yaw=0.0))
        self.lane_width = lane_width
        self._step = step
        self._n_left = n_left

    def next(self, d):
        if self._n_left <= 0:
            return []
        return [FakeWaypoint(self.transform.location.x + d, self._step,
                             self.lane_width, self._n_left - 1)]


class FakeWorld:
    def __init__(self, actors):
        self._actors = actors

    def get_actors(self):
        actors = self._actors

        class _F:
            def filter(self, pat):
                return actors
        return _F()

    def get_map(self):
        class _M:
            def get_waypoint(self, loc):
                return FakeWaypoint(loc.x)
        return _M()


def both(node, topic, *args, **kw):
    """The port's node and the JAX package's, each on a transport of its own
    over a fresh fake world: -> (port's tick() result, port's messages,
    JAX's messages)."""
    out = []
    for mod, transport in ((tpub, InProcTransport()), (jpub, JInProc())):
        got = []
        transport.subscribe(topic, got.append)
        out.append((getattr(mod, node)(FakeWorld([FakeActor()]), transport, *args, **kw).tick(),
                    got))
    (result, got), (_, jgot) = out
    assert got == jgot and len(got) == 1
    return result, got


# ----------------------------------------------------------- geometry

def test_lh_to_rh_pose_conversion():
    pose = tpub.carla_transform_to_pose(V(1.0, 2.0, 3.0), R(0.0, 0.0, 90.0))
    assert pose == jpub.carla_transform_to_pose(V(1.0, 2.0, 3.0), R(0.0, 0.0, 90.0))
    assert pose["position"] == {"x": 1.0, "y": -2.0, "z": 3.0}
    # yaw +90deg LH -> -90deg RH: quaternion z = sin(-45deg)
    assert pose["orientation"]["z"] == pytest.approx(-math.sqrt(0.5))
    assert pose["orientation"]["w"] == pytest.approx(math.sqrt(0.5))


def test_yaw_quaternion_and_rpy_matrix():
    q = tpub.yaw_to_quaternion(180.0)
    assert q == jpub.yaw_to_quaternion(180.0)
    assert q["z"] == pytest.approx(1.0) and q["w"] == pytest.approx(0.0)
    Rm = tpub.rpy_to_matrix(0.0, 0.0, math.pi / 2)
    np.testing.assert_array_equal(Rm, jpub.rpy_to_matrix(0.0, 0.0, math.pi / 2))
    np.testing.assert_allclose(Rm @ np.array([1, 0, 0]), [0, 1, 0], atol=1e-12)
    q4 = tpub.quaternion_from_euler(0.3, -0.2, math.pi / 2)
    assert q4 == jpub.quaternion_from_euler(0.3, -0.2, math.pi / 2)
    qx, qy, qz, qw = tpub.quaternion_from_euler(0, 0, math.pi / 2)
    assert (qz, qw) == (pytest.approx(math.sin(math.pi / 4)),
                        pytest.approx(math.cos(math.pi / 4)))


def test_body_frame_velocity():
    v = tpub.body_frame_velocity(V(3.0, 4.0, 0.0), 90.0)
    np.testing.assert_array_equal(v, jpub.body_frame_velocity(V(3.0, 4.0, 0.0), 90.0))
    c, s = math.cos(math.radians(90)), math.sin(math.radians(90))
    np.testing.assert_allclose(v, np.array([[c, -s], [s, c]]) @ np.array([3.0, -4.0]))


# ----------------------------------------------------------- nodes

def test_odom_publisher_publishes_rh_odometry():
    odom, got = both("CarlaOdomPublisher", "/hero/odom")
    assert got[0] is odom
    assert odom["pose"]["position"]["y"] == -5.0
    assert odom["child_frame_id"] == "base_link"
    assert odom["twist"]["angular"]["z"] == pytest.approx(-math.radians(10.0))


def test_waypoints_publisher_walks_lookahead():
    traj, _ = both("CarlaWaypointsPublisher", "/planning/trajectory")
    assert len(traj["points"]) == 50  # 100 m lookahead at 2 m steps
    assert all(p["longitudinal_velocity_mps"] == 10.0 for p in traj["points"])
    xs = [p["pose"]["position"]["x"] for p in traj["points"]]
    assert xs == sorted(xs) and xs[1] - xs[0] == pytest.approx(2.0)


def test_road_shape_publisher_boundaries():
    shape, _ = both("CarlaRoadShapePublisher", "/perception/road_shape")
    assert len(shape["left_boundary"]) == len(shape["right_boundary"]) == 30
    ly = shape["left_boundary"][0]["y"]
    ry = shape["right_boundary"][0]["y"]
    assert abs(ly - ry) == pytest.approx(3.6)


def test_control_subscriber_maps_outputs():
    dicts = []
    for mod, transport in ((tpub, InProcTransport()), (jpub, JInProc())):
        sub = mod.CarlaControlSubscriber(FakeWorld([FakeActor()]), transport)
        sub.ego = None  # avoid the carla.VehicleControl import in _apply
        seen = []
        for topic, value in (("/control/steering_deg", 20.0), ("/control/accel_effort", 1.5),
                             ("/control/accel_effort", -5.0)):
            transport.publish(topic, value)
            seen.append(sub.control_dict())
        dicts.append(seen)
    assert dicts[0] == dicts[1]
    assert dicts[0][1]["steer"] == pytest.approx(0.5)      # 20/40
    assert dicts[0][1]["throttle"] == pytest.approx(0.5)   # 1.5/3
    assert dicts[0][1]["brake"] == 0.0
    assert dicts[0][2]["brake"] == pytest.approx(1.0)


def test_find_ego_requires_hero_role():
    npc, hero = FakeActor(role="npc"), FakeActor(role="hero")
    world = FakeWorld([npc, hero])
    assert tpub.find_ego_vehicle(world) is hero is jpub.find_ego_vehicle(world)
    assert tpub.find_ego_vehicle(FakeWorld([npc])) is None


# ----------------------------------------------------------- SODA.Sim

def test_sodasim_pipeline_strings_and_caps():
    for kw in (dict(mode="rtp", port=5700, bitrate=2000), dict(mode="v4l2", device="/dev/video10")):
        assert tsoda.build_pipeline_description(**kw) == jsoda.build_pipeline_description(**kw)
    rtp = tsoda.build_pipeline_description("rtp", port=5700, bitrate=2000)
    assert "appsrc name=ros_appsrc" in rtp and "udpsink" in rtp
    assert "port=5700" in rtp and "bitrate=2000" in rtp
    assert "v4l2sink device=/dev/video10" in tsoda.build_pipeline_description(
        "v4l2", device="/dev/video10")
    with pytest.raises(ValueError):
        tsoda.build_pipeline_description("bogus")
    assert tsoda.DEFAULT_PIPELINE == jsoda.DEFAULT_PIPELINE
    for fps in (29.7, 0.0, -1.0, 60.0):
        assert tsoda.fps_to_int(fps) == jsoda.fps_to_int(fps)
        assert tsoda.caps_string(1280, 720, fps) == jsoda.caps_string(1280, 720, fps)
    assert tsoda.caps_string(1280, 720, 30.0) == (
        "video/x-raw,format=BGR,width=1280,height=720,framerate=30/1")
    assert tsoda.caps_string(640, 320, 0.0).endswith("framerate=0/1")


# ----------------------------------------------------------- the state bridge

def test_state_publisher_bridge():
    """Both packages' bridges read the same segment while three states are
    published: the same three messages."""
    lib = tshm.build()
    if lib not in jshm._LIB_PATHS:
        jshm._LIB_PATHS.insert(0, lib)
    seg = f"/avp_torch_bridge_{os.getpid()}"
    got, jgot = [], []
    t, jt = InProcTransport(), JInProc()
    t.subscribe("/visionpilot/state", got.append)
    jt.subscribe("/visionpilot/state", jgot.append)
    with tshm.SharedStatePublisher(seg) as pub:
        bridges = [StatePublisherBridge(t, rate_hz=200, shm_name=seg),
                   JBridge(jt, rate_hz=200, shm_name=seg)]
        threads = [threading.Thread(target=b.spin, kwargs={"max_messages": 3}) for b in bridges]
        s = tshm.VisionPilotStateStruct()
        for i in range(1, 4):
            s.frame_number = i
            s.steering_pid_deg = i * 1.5
            s.fcw_active = i == 3
            pub.publish(s)
            if i == 1:  # the bridges start on frame 1, not on the empty segment's 0
                for th in threads:
                    th.start()
            time.sleep(0.05)
        for th in threads:
            th.join(timeout=5)
        for b in bridges:
            b.stop()
            b.close()
    assert got == jgot
    assert len(got) == 3
    assert got[0]["frame"] == 1 and got[0]["steering_deg"] == 1.5
    assert got[2]["fcw"] is True
