"""ctypes binding for the iceoryx2-model zero-copy services.

Exposes the two services of the reference's IceOryx2 middleware recipe
(VisionPilot/middleware_recipes/IceOryx2/README.md:6-12):

- ``VisionPilot/RawFrames`` carrying :class:`RawFrameStruct`
- ``VisionPilot/CIPO``      carrying :class:`CIPOMessageStruct`

over the host shim's iox2 service core (host/src/iox2.cpp: per-service
POSIX shm segment, per-slot seqlock, single writer / many readers).
The Python pipeline attaches as either side: publish frames for native
subscribers (iox2_inference_node, iox2_viz_node) or subscribe to frames
and publish CIPO results from the detector on the GPU. The port of
autoware_vision_pilot_tpu/host/iox2.py over the library that host/shm.py
builds.
"""
from __future__ import annotations

import ctypes
import time
from typing import Optional, Tuple

import numpy as np

from .shm import _load_lib

MAX_W, MAX_H = 1920, 1280

RAW_FRAMES_SERVICE = "VisionPilot/RawFrames"
CIPO_SERVICE = "VisionPilot/CIPO"


class RawFrameStruct(ctypes.Structure):
    """ABI mirror of avp::iox2msg::RawFrame (reference
    transmission_data.hpp RawFrame: field order/types are the wire
    contract)."""
    _fields_ = [
        ("frame_id", ctypes.c_uint64),
        ("capture_timestamp_ns", ctypes.c_uint64),
        ("publish_timestamp_ns", ctypes.c_uint64),
        ("width", ctypes.c_uint32),
        ("height", ctypes.c_uint32),
        ("channels", ctypes.c_uint32),
        ("step", ctypes.c_uint32),
        ("data", ctypes.c_uint8 * (MAX_W * MAX_H * 3)),
        ("is_valid", ctypes.c_bool),
        ("source_id", ctypes.c_uint8),
    ]


class CIPOMessageStruct(ctypes.Structure):
    """ABI mirror of avp::iox2msg::CIPOMessage."""
    _fields_ = [
        ("frame_id", ctypes.c_uint64),
        ("timestamp_ns", ctypes.c_uint64),
        ("publish_timestamp_ns", ctypes.c_uint64),
        ("exists", ctypes.c_bool),
        ("track_id", ctypes.c_int32),
        ("class_id", ctypes.c_int32),
        ("distance_m", ctypes.c_float),
        ("velocity_ms", ctypes.c_float),
        ("bbox_x1", ctypes.c_float),
        ("bbox_y1", ctypes.c_float),
        ("bbox_x2", ctypes.c_float),
        ("bbox_y2", ctypes.c_float),
        ("confidence", ctypes.c_float),
        ("cut_in_detected", ctypes.c_bool),
        ("kalman_reset", ctypes.c_bool),
        ("num_tracked_objects", ctypes.c_uint8),
        ("inference_latency_ms", ctypes.c_float),
        ("tracking_latency_ms", ctypes.c_float),
        ("ipc_latency_us", ctypes.c_float),
    ]


def _bind(lib):
    lib.avp_iox2_open.restype = ctypes.c_void_p
    lib.avp_iox2_open.argtypes = [ctypes.c_char_p, ctypes.c_ulonglong,
                                  ctypes.c_uint, ctypes.c_int,
                                  ctypes.c_int]
    lib.avp_iox2_close.argtypes = [ctypes.c_void_p]
    lib.avp_iox2_close.restype = None
    lib.avp_iox2_loan.restype = ctypes.c_void_p
    lib.avp_iox2_loan.argtypes = [ctypes.c_void_p]
    lib.avp_iox2_publish.restype = ctypes.c_ulonglong
    lib.avp_iox2_publish.argtypes = [ctypes.c_void_p]
    lib.avp_iox2_receive.restype = ctypes.c_int
    lib.avp_iox2_receive.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_ulonglong),
        ctypes.POINTER(ctypes.c_ulonglong)]
    lib.avp_iox2_latest.restype = ctypes.c_ulonglong
    lib.avp_iox2_latest.argtypes = [ctypes.c_void_p]
    return lib


class Iox2Service:
    """One side of a named zero-copy service carrying a ctypes POD.

    ``create=True`` is the publisher side (single writer); ``False``
    subscribes, waiting up to ``timeout_ms`` for the publisher.
    """

    def __init__(self, name: str, struct, n_slots: int = 4,
                 create: bool = False, timeout_ms: int = 5000):
        self._lib = _bind(_load_lib())
        self._struct = struct
        self._h = self._lib.avp_iox2_open(
            name.encode(), ctypes.sizeof(struct), n_slots,
            1 if create else 0, timeout_ms)
        if not self._h:
            raise RuntimeError(f"iox2 service {name!r} unavailable")
        self._last_seen = ctypes.c_ulonglong(0)
        self._lost_total = 0
        self.name = name

    # -- publisher --------------------------------------------------------
    def loan(self):
        """Loan the next sample: a struct view aliasing shared memory.

        Fill it in place (zero-copy), then call :meth:`publish`.
        """
        p = self._lib.avp_iox2_loan(self._h)
        return ctypes.cast(p, ctypes.POINTER(self._struct)).contents

    def publish(self) -> int:
        return int(self._lib.avp_iox2_publish(self._h))

    # -- subscriber -------------------------------------------------------
    def receive(self, out=None):
        """Copy out the oldest unseen sample, or None."""
        if out is None:
            out = self._struct()
        lost = ctypes.c_ulonglong(0)
        got = self._lib.avp_iox2_receive(self._h, ctypes.byref(out),
                                         ctypes.byref(self._last_seen),
                                         ctypes.byref(lost))
        self._lost_total += int(lost.value)
        return out if got else None

    @property
    def samples_lost(self) -> int:
        return self._lost_total

    def latest_seq(self) -> int:
        return int(self._lib.avp_iox2_latest(self._h))

    def close(self):
        if self._h:
            self._lib.avp_iox2_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# -- convenience frame publish/receive (numpy <-> RawFrame) ----------------

def publish_frame(svc: Iox2Service, bgr: np.ndarray, frame_id: int,
                  source_id: int = 0) -> int:
    h, w, c = bgr.shape
    f = svc.loan()
    now = time.monotonic_ns()
    f.frame_id = frame_id
    f.capture_timestamp_ns = now
    f.width, f.height, f.channels, f.step = w, h, c, w * c
    f.is_valid = True
    f.source_id = source_id
    flat = np.ascontiguousarray(bgr, dtype=np.uint8).reshape(-1)
    ctypes.memmove(f.data, flat.ctypes.data, flat.size)
    f.publish_timestamp_ns = time.monotonic_ns()
    return svc.publish()


def receive_frame(svc: Iox2Service,
                  buf: Optional[RawFrameStruct] = None
                  ) -> Optional[Tuple[np.ndarray, RawFrameStruct]]:
    f = svc.receive(buf)
    if f is None or not f.is_valid:
        return None
    n = f.height * f.step
    img = np.frombuffer(f.data, dtype=np.uint8, count=n).reshape(
        f.height, f.width, f.channels).copy()
    return img, f
