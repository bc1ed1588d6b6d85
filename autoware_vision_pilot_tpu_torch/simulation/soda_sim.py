"""SODA.Sim bridge, the port of autoware_vision_pilot_tpu/simulation/soda_sim.py
(N34 parity: VisionPilot/simulation/SODA.Sim).

The reference feeds SODA.Sim camera images into the pipeline through a
ROS2 image -> GStreamer appsrc rebroadcaster
(ros2_gstreamer/src/image_to_gstreamer_node.cpp:31-60) with either an
RTP/UDP sink or a v4l2loopback sink that the production app then opens
as a camera (visionpilot_sodasim.conf.example). The equivalent here: a
transport subscriber that pushes frames into a GStreamer appsrc pipeline
built from the same description strings, gated on GStreamer availability;
the pipeline-string construction and the caps/fps logic are testable
without GStreamer.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..middleware.transport import Transport

DEFAULT_PIPELINE = (
    "appsrc name=ros_appsrc is-live=true format=time do-timestamp=true ! "
    "videoconvert ! x264enc tune=zerolatency bitrate=4000 "
    "speed-preset=veryfast ! rtph264pay config-interval=1 pt=96 ! "
    "udpsink host=127.0.0.1 port=5600 sync=false")


def fps_to_int(fps_value: float) -> int:
    """image_to_gstreamer_node.cpp fpsToInt (:22-28)."""
    if fps_value <= 0.0:
        return 0
    return int(round(fps_value))


def build_pipeline_description(mode: str = "rtp",
                               device: str = "/dev/video10",
                               host: str = "127.0.0.1", port: int = 5600,
                               bitrate: int = 4000,
                               appsrc_name: str = "ros_appsrc") -> str:
    """The two launch modes of image_to_gstreamer.launch.py: 'rtp'
    (UDP H.264) and 'v4l2' (v4l2loopback device the production app opens
    as a camera, visionpilot_sodasim.conf.example)."""
    src = (f"appsrc name={appsrc_name} is-live=true format=time "
           f"do-timestamp=true ! videoconvert")
    if mode == "v4l2":
        return f"{src} ! video/x-raw,format=YUY2 ! v4l2sink device={device}"
    if mode == "rtp":
        return (f"{src} ! x264enc tune=zerolatency bitrate={bitrate} "
                f"speed-preset=veryfast ! rtph264pay config-interval=1 "
                f"pt=96 ! udpsink host={host} port={port} sync=false")
    raise ValueError(f"unknown mode {mode!r}")


def caps_string(width: int, height: int, fps: float,
                fmt: str = "BGR") -> str:
    """Caps set on first frame (image_to_gstreamer_node.cpp
    configureCaps): raw video at the incoming geometry; fps 0 means
    variable rate."""
    f = fps_to_int(fps)
    rate = f"{f}/1" if f > 0 else "0/1"
    return (f"video/x-raw,format={fmt},width={width},height={height},"
            f"framerate={rate}")


class ImageToGStreamerBridge:
    """Subscribe to `input_topic` (HxWx3 BGR uint8 frames on any
    Transport) and push each frame into a GStreamer appsrc pipeline.
    Requires PyGObject GStreamer bindings; constructing without them
    raises, mirroring the node's hard failure."""

    def __init__(self, transport: Transport,
                 input_topic: str = "/vehicle/camera",
                 pipeline_description: str = DEFAULT_PIPELINE,
                 appsrc_name: str = "ros_appsrc",
                 target_fps: float = 30.0):
        import gi
        gi.require_version("Gst", "1.0")
        from gi.repository import Gst
        Gst.init(None)
        self.Gst = Gst
        self.target_fps = target_fps
        self.appsrc_name = appsrc_name
        self._caps_configured = False
        self.pipeline = Gst.parse_launch(pipeline_description)
        self.appsrc = self.pipeline.get_by_name(appsrc_name)
        if self.appsrc is None:
            raise RuntimeError(
                f"pipeline has no appsrc named {appsrc_name!r}")
        self.pipeline.set_state(Gst.State.PLAYING)
        transport.subscribe(input_topic, self.on_frame)

    def on_frame(self, frame: np.ndarray):
        Gst = self.Gst
        h, w = frame.shape[:2]
        if not self._caps_configured:
            caps = Gst.Caps.from_string(
                caps_string(w, h, self.target_fps))
            self.appsrc.set_property("caps", caps)
            self._caps_configured = True
        data = np.ascontiguousarray(frame).tobytes()
        buf = Gst.Buffer.new_allocate(None, len(data), None)
        buf.fill(0, data)
        self.appsrc.emit("push-buffer", buf)

    def close(self):
        self.pipeline.set_state(self.Gst.State.NULL)
