"""GStreamer source abstraction (N29; middleware_recipes/common/sensors/
gstreamer_engine.cpp:22-56), the port's own copy of
autoware_vision_pilot_tpu/drivers/gstreamer.py: build appsink BGR
pipeline strings for
rtsp / v4l2 / file sources, realtime-sync or as-fast-as-possible, and open
them through cv2's GStreamer backend (falls back to plain VideoCapture
when GStreamer support is absent)."""
from __future__ import annotations

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


def build_pipeline(source: str, realtime: bool = True) -> str:
    sync = "true" if realtime else "false"
    sink = f"appsink sync={sync} max-buffers=2 drop=true"
    convert = "videoconvert ! video/x-raw,format=BGR"
    if source.startswith("rtsp://"):
        return (f"rtspsrc location={source} latency=100 ! decodebin ! "
                f"{convert} ! {sink}")
    if source.startswith("/dev/video"):
        return f"v4l2src device={source} ! {convert} ! {sink}"
    return (f"filesrc location={source} ! decodebin ! {convert} ! {sink}")


def open_source(source: str, realtime: bool = True):
    """cv2.VideoCapture over GStreamer when available, else direct."""
    if cv2.getBuildInformation().find("GStreamer") >= 0 and \
            "YES" in cv2.getBuildInformation().split("GStreamer")[1][:40]:
        cap = cv2.VideoCapture(build_pipeline(source, realtime),
                               cv2.CAP_GSTREAMER)
        if cap.isOpened():
            return cap
    # fallback
    src = source if not source.startswith("/dev/video") else \
        int(source.replace("/dev/video", ""))
    return cv2.VideoCapture(src)
