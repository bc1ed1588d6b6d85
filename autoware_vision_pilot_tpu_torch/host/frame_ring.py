"""ctypes binding for the zero-copy shared-memory frame ring (the
iceoryx2 VisionPilot/RawFrames service analog), the port of
autoware_vision_pilot_tpu/host/frame_ring.py over the library that
host/shm.py builds.

A reader sees frame numbers above 0 only: the ring's ``latest`` is 0 until
the first publish (host/src/frame_ring.cpp)."""
from __future__ import annotations

import ctypes
import time
from typing import Optional, Tuple

import numpy as np

from .shm import _load_lib


class FrameHeaderStruct(ctypes.Structure):
    _fields_ = [
        ("seq", ctypes.c_uint64),
        ("frame_number", ctypes.c_uint64),
        ("height", ctypes.c_uint32),
        ("width", ctypes.c_uint32),
        ("channels", ctypes.c_uint32),
        ("timestamp_ns", ctypes.c_uint64),
    ]


def _bind(lib):
    lib.avp_ring_create.restype = ctypes.c_void_p
    lib.avp_ring_create.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                    ctypes.c_uint, ctypes.c_uint]
    lib.avp_ring_destroy.argtypes = [ctypes.c_void_p]
    lib.avp_ring_destroy.restype = None
    lib.avp_ring_publish.restype = ctypes.c_int
    lib.avp_ring_publish.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_ubyte), ctypes.c_uint,
        ctypes.c_uint, ctypes.c_uint, ctypes.c_ulonglong,
        ctypes.c_ulonglong]
    lib.avp_ring_read_latest.restype = ctypes.c_int
    lib.avp_ring_read_latest.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_ubyte), ctypes.c_uint,
        ctypes.POINTER(FrameHeaderStruct), ctypes.c_ulonglong]
    return lib


class FrameRing:
    def __init__(self, name: str = "/visionpilot_frames",
                 owner: bool = False, n_slots: int = 4,
                 slot_bytes: int = 1280 * 720 * 3):
        self._lib = _bind(_load_lib())
        self._h = self._lib.avp_ring_create(name.encode(),
                                            1 if owner else 0,
                                            n_slots, slot_bytes)
        if not self._h:
            raise RuntimeError(f"cannot open frame ring {name}")
        self.slot_bytes = slot_bytes

    def publish(self, frame: np.ndarray, frame_number: int,
                timestamp_ns: Optional[int] = None) -> bool:
        f = np.ascontiguousarray(frame, np.uint8)
        h, w = f.shape[:2]
        c = f.shape[2] if f.ndim == 3 else 1
        ts = timestamp_ns if timestamp_ns is not None else time.time_ns()
        ptr = f.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte))
        return bool(self._lib.avp_ring_publish(self._h, ptr, h, w, c,
                                               frame_number, ts))

    def read_latest(self, last_seen: int = 0
                    ) -> Optional[Tuple[np.ndarray, FrameHeaderStruct]]:
        buf = np.empty(self.slot_bytes, np.uint8)
        hdr = FrameHeaderStruct()
        ok = self._lib.avp_ring_read_latest(
            self._h, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
            self.slot_bytes, ctypes.byref(hdr), last_seen)
        if not ok:
            return None
        n = hdr.height * hdr.width * hdr.channels
        frame = buf[:n].reshape(hdr.height, hdr.width, hdr.channels)
        return frame.copy(), hdr

    def close(self):
        if getattr(self, "_h", None):
            self._lib.avp_ring_destroy(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
