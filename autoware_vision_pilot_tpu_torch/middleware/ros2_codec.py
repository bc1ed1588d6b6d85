"""numpy <-> ROS2 message codecs, cv_bridge-free: the port's own copy of
autoware_vision_pilot_tpu/middleware/ros2_codec.py (pure numpy).

The reference ROS2 recipe converts via cv_bridge
(middleware_recipes/ROS2/models/src/run_model_node.cpp:68-75, :117), but
cv_bridge is only a thin header around the sensor_msgs/Image wire layout:
height/width/encoding/is_bigendian/step/data. We build the messages
directly so the transport runs on a bare rclpy install.

Wire contract (run_model_node.cpp:25-190, run_autospeed_node.cpp:16-110):
  camera in    sensor_msgs/Image  bgr8
  seg mask out sensor_msgs/Image  mono8  (class ids / 255-binary)
  lanes out    sensor_msgs/Image  8UC3   (3 binary lane channels)
  depth out    sensor_msgs/Image  32FC1
  detections   vision_msgs/Detection2DArray (center/size bbox +
               ObjectHypothesisWithPose{class_id, score})
"""
from __future__ import annotations

import numpy as np

_ENCODINGS = {
    "bgr8": (np.uint8, 3),
    "rgb8": (np.uint8, 3),
    "8UC3": (np.uint8, 3),
    "mono8": (np.uint8, 1),
    "8UC1": (np.uint8, 1),
    "32FC1": (np.float32, 1),
}


def encoding_for(arr: np.ndarray) -> str:
    """Pick the reference encoding for a numpy payload."""
    if arr.dtype == np.uint8:
        if arr.ndim == 3 and arr.shape[-1] == 3:
            return "bgr8"
        return "mono8"
    if arr.dtype == np.float32 and (arr.ndim == 2 or arr.shape[-1] == 1):
        return "32FC1"
    raise ValueError(f"no Image encoding for dtype={arr.dtype} "
                     f"shape={arr.shape}")


def np_to_image_msg(arr: np.ndarray, encoding: str | None = None,
                    frame_id: str = "", stamp=None):
    """numpy (H, W[, C]) -> sensor_msgs/Image."""
    from sensor_msgs.msg import Image

    if encoding is None:
        encoding = encoding_for(arr)
    dtype, ch = _ENCODINGS[encoding]
    arr = np.ascontiguousarray(arr, dtype=dtype)
    if arr.ndim == 2:
        h, w = arr.shape
        c = 1
    else:
        h, w, c = arr.shape
    if c != ch:
        raise ValueError(f"{encoding} expects {ch} channels, got {c}")
    msg = Image()
    msg.height = int(h)
    msg.width = int(w)
    msg.encoding = encoding
    msg.is_bigendian = False
    msg.step = int(w * ch * arr.itemsize)
    msg.data = arr.tobytes()
    if frame_id:
        msg.header.frame_id = frame_id
    if stamp is not None:
        msg.header.stamp = stamp
    return msg


def image_msg_to_np(msg) -> np.ndarray:
    """sensor_msgs/Image -> numpy (H, W[, C])."""
    if msg.encoding not in _ENCODINGS:
        raise ValueError(f"unsupported encoding {msg.encoding!r}")
    dtype, ch = _ENCODINGS[msg.encoding]
    flat = np.frombuffer(bytes(msg.data), dtype=dtype)
    if ch == 1:
        return flat.reshape(msg.height, msg.width).copy()
    return flat.reshape(msg.height, msg.width, ch).copy()


def dets_to_detection2d_array(dets: np.ndarray, frame_id: str = ""):
    """(N, 6) [x1, y1, x2, y2, score, class] -> Detection2DArray.

    Same fields the reference fills (run_autospeed_node.cpp:70-106):
    center/size bbox, hypothesis.class_id (stringified int), score.
    """
    from vision_msgs.msg import (
        Detection2D, Detection2DArray, ObjectHypothesisWithPose)

    out = Detection2DArray()
    if frame_id:
        out.header.frame_id = frame_id
    for row in np.asarray(dets, np.float32):
        x1, y1, x2, y2, score, cls = [float(v) for v in row[:6]]
        d = Detection2D()
        d.bbox.center.position.x = (x1 + x2) / 2.0
        d.bbox.center.position.y = (y1 + y2) / 2.0
        d.bbox.size_x = x2 - x1
        d.bbox.size_y = y2 - y1
        hyp = ObjectHypothesisWithPose()
        hyp.hypothesis.class_id = str(int(cls))
        hyp.hypothesis.score = score
        d.results.append(hyp)
        out.detections.append(d)
    return out


def detection2d_array_to_dets(msg) -> np.ndarray:
    """Detection2DArray -> (N, 6) [x1, y1, x2, y2, score, class]."""
    rows = []
    for d in msg.detections:
        cx = d.bbox.center.position.x
        cy = d.bbox.center.position.y
        sx, sy = d.bbox.size_x, d.bbox.size_y
        score = d.results[0].hypothesis.score if d.results else 0.0
        cls = float(d.results[0].hypothesis.class_id) if d.results else -1.0
        rows.append([cx - sx / 2, cy - sy / 2, cx + sx / 2, cy + sy / 2,
                     score, cls])
    return np.asarray(rows, np.float32).reshape(-1, 6)
