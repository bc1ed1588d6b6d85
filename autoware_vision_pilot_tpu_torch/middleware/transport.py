"""Pluggable pub/sub transports for the middleware nodes, the port of
autoware_vision_pilot_tpu/middleware/transport.py (host code; the
iceoryx2 transport rides the port's host/iox2.py).

The reference ships three recipes over one common inference layer: ROS2
DDS nodes (middleware_recipes/ROS2/), Zenoh pub/sub (Zenoh/models/
run_model.cpp), and iceoryx2 zero-copy services (IceOryx2/). Here the node
logic is transport-agnostic; each transport implements publish/subscribe
on string topics. ROS2 (rclpy) and Zenoh bind when their client libraries
are installed; InProcTransport is the dependency-free fallback used by
tests and single-process deployments.
"""
from __future__ import annotations

import ctypes
import threading
import time
from collections import defaultdict
from typing import Any, Callable, Dict, List, Optional


class Transport:
    def publish(self, topic: str, msg: Any) -> None:
        raise NotImplementedError

    def subscribe(self, topic: str, callback: Callable[[Any], None]) -> None:
        raise NotImplementedError

    def spin_once(self, timeout: float = 0.0) -> None:
        pass

    def close(self) -> None:
        pass


class InProcTransport(Transport):
    """Synchronous in-process pub/sub (zero-copy by reference)."""

    def __init__(self):
        self._subs: Dict[str, List[Callable]] = defaultdict(list)
        self._lock = threading.Lock()

    def publish(self, topic, msg):
        with self._lock:
            subs = list(self._subs.get(topic, ()))
        for cb in subs:
            cb(msg)

    def subscribe(self, topic, callback):
        with self._lock:
            self._subs[topic].append(callback)


class Ros2Transport(Transport):
    """rclpy-backed transport (requires a ROS2 installation, no cv_bridge).

    Topic contract matches middleware_recipes/ROS2
    (run_model_node.cpp:25-190, run_autospeed_node.cpp:16-110):
    sensor_msgs/Image in (bgr8), MONO8/8UC3 mask or 32FC1 depth out,
    vision_msgs/Detection2DArray for AutoSpeed. Node callbacks exchange
    plain numpy arrays; this transport converts at the DDS boundary via
    ros2_codec (a cv_bridge-free Image/Detection2DArray codec).

    `topic_types` maps topic -> "image" | "detections"; unmapped topics
    default to Image with the encoding inferred from the array
    (uint8 HxWx3 -> bgr8, uint8 HxW -> mono8, float32 -> 32FC1,
    uint8 lane channels published per-channel as mono8 would also work,
    but the reference keeps one 3-channel mask tensor, so we use 8UC3).
    """

    def __init__(self, node_name: str = "avp_tpu",
                 topic_types: Optional[Dict[str, str]] = None,
                 qos_depth: int = 10):
        import rclpy  # noqa: F401 — hard dependency by design
        from rclpy.node import Node
        if not rclpy.ok():
            rclpy.init()
        self._rclpy = rclpy
        self._node = Node(node_name)
        self._qos = qos_depth
        self._pubs: Dict[str, Any] = {}
        self._topic_types = dict(topic_types or {})

    # -- type plumbing -----------------------------------------------------
    def _kind(self, topic: str, payload=None) -> str:
        k = self._topic_types.get(topic)
        if k is not None:
            return k
        if payload is not None and getattr(payload, "ndim", 0) == 2 and \
                payload.shape[-1] == 6 and payload.dtype != "uint8":
            return "detections"
        return "image"

    def _msg_class(self, kind: str, payload=None):
        if kind == "detections":
            from vision_msgs.msg import Detection2DArray
            return Detection2DArray
        from sensor_msgs.msg import Image
        return Image

    # -- Transport API -----------------------------------------------------
    def publish(self, topic, msg):
        from . import ros2_codec as codec
        import numpy as _np
        arr = _np.asarray(msg)
        kind = self._kind(topic, arr)
        if topic not in self._pubs:
            self._pubs[topic] = self._node.create_publisher(
                self._msg_class(kind), topic, self._qos)
        if kind == "detections":
            wire = codec.dets_to_detection2d_array(arr)
        else:
            enc = None
            if arr.dtype == _np.uint8 and arr.ndim == 3 and \
                    arr.shape[-1] == 3:
                # 3-channel uint8: camera frames are bgr8, egolanes mask
                # stacks are 8UC3 — declared via topic_types={t: "mask3"}
                enc = "8UC3" if kind == "mask3" else "bgr8"
            wire = codec.np_to_image_msg(arr, enc)
        self._pubs[topic].publish(wire)

    def subscribe(self, topic, callback):
        from . import ros2_codec as codec
        kind = self._kind(topic)

        def on_msg(wire):
            if kind == "detections" or type(wire).__name__ == \
                    "Detection2DArray":
                callback(codec.detection2d_array_to_dets(wire))
            else:
                callback(codec.image_msg_to_np(wire))

        self._node.create_subscription(
            self._msg_class(kind), topic, on_msg, self._qos)

    def spin_once(self, timeout: float = 0.0):
        self._rclpy.spin_once(self._node, timeout_sec=timeout)

    def close(self):
        self._node.destroy_node()
        self._rclpy.shutdown()


class ZenohTransport(Transport):
    """zenoh-python-backed transport (requires `zenoh`). Frames/results are
    published as raw bytes on string key expressions — the same contract as
    Zenoh/models/run_model.cpp:40-120."""

    def __init__(self, config=None):
        import zenoh  # hard dependency by design
        self._session = zenoh.open(config or zenoh.Config())
        self._subs = []

    def publish(self, topic, msg: bytes):
        self._session.put(topic, msg)

    def subscribe(self, topic, callback):
        self._subs.append(self._session.declare_subscriber(
            topic, lambda sample: callback(bytes(sample.payload))))

    def close(self):
        self._session.close()


class Iox2Transport(Transport):
    """Zero-copy shared-memory transport with the iceoryx2 recipe's
    service contract (IceOryx2/README.md:6-12): topic "raw_frames" maps
    to service VisionPilot/RawFrames (numpy BGR frames), topic "cipo"
    to VisionPilot/CIPO (CIPOMessage dicts). Payloads ride the host
    shim's seqlock slot ring (host/src/iox2.cpp) — no serialization,
    interoperable with the native iox2_*_node binaries."""

    _TOPICS = {"raw_frames": "VisionPilot/RawFrames",
               "cipo": "VisionPilot/CIPO"}  # topic -> service name

    def __init__(self, publish_topics=(), n_slots: int = 4):
        from ..host import iox2 as hx
        self._hx = hx
        self._pubs = {}
        self._sub_svcs = {}
        self._callbacks = {}
        self._n_slots = n_slots
        self._frame_ids = {}
        for t in publish_topics:
            self._pubs[t.lstrip("/")] = hx.Iox2Service(
                self._service(t), self._struct(t), n_slots, create=True)

    def _service(self, topic: str) -> str:
        key = topic.lstrip("/")
        if key not in self._TOPICS:
            raise ValueError(f"iox2 transport has no service for {topic!r}")
        return self._TOPICS[key]

    def _struct(self, topic: str):
        key = topic.lstrip("/")
        return (self._hx.RawFrameStruct if key == "raw_frames"
                else self._hx.CIPOMessageStruct)

    def publish(self, topic, msg):
        # Key publishers by the normalized topic so "cipo" and "/cipo"
        # share one service instead of racing two creators on the segment.
        key = topic.lstrip("/")
        if key not in self._pubs:
            self._pubs[key] = self._hx.Iox2Service(
                self._service(topic), self._struct(topic), self._n_slots,
                create=True)
        svc = self._pubs[key]
        if key == "raw_frames":
            fid = self._frame_ids.get(key, 0)
            self._hx.publish_frame(svc, msg, fid)
            self._frame_ids[key] = fid + 1
        else:
            m = svc.loan()
            # Ring slots are reused: clear the loaned sample so fields the
            # msg dict omits don't carry stale bytes from a prior sample
            # (the C++ inference_node memsets its loaned CIPOMessage too).
            ctypes.memset(ctypes.byref(m), 0, ctypes.sizeof(m))
            for k, v in msg.items():
                setattr(m, k, v)
            m.publish_timestamp_ns = time.monotonic_ns()
            svc.publish()

    def subscribe(self, topic, callback):
        if topic not in self._sub_svcs:
            self._sub_svcs[topic] = self._hx.Iox2Service(
                self._service(topic), self._struct(topic), self._n_slots,
                create=False)
        self._callbacks.setdefault(topic, []).append(callback)

    def spin_once(self, timeout: float = 0.0):
        deadline = time.monotonic() + timeout
        delivered = False
        while True:
            for topic, svc in self._sub_svcs.items():
                key = topic.lstrip("/")
                if key == "raw_frames":
                    got = self._hx.receive_frame(svc)
                    if got is not None:
                        delivered = True
                        for cb in self._callbacks.get(topic, []):
                            cb(got[0])
                else:
                    m = svc.receive()
                    if m is not None:
                        delivered = True
                        d = {k: getattr(m, k) for k, _ in m._fields_}
                        for cb in self._callbacks.get(topic, []):
                            cb(d)
            if delivered or time.monotonic() >= deadline:
                return
            time.sleep(0.001)

    def close(self):
        for svc in list(self._pubs.values()) + list(self._sub_svcs.values()):
            svc.close()


def make_transport(kind: str = "inproc", **kw) -> Transport:
    if kind == "inproc":
        return InProcTransport()
    if kind == "ros2":
        return Ros2Transport(**kw)
    if kind == "zenoh":
        return ZenohTransport(**kw)
    if kind == "iox2":
        return Iox2Transport(**kw)
    raise ValueError(f"unknown transport {kind}")
