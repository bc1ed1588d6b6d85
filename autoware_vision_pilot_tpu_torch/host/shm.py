"""Python ctypes binding to the C++ host shim (libavp_host.so), the port of
autoware_vision_pilot_tpu/host/shm.py.

The pipeline publishes its per-frame outputs into the /visionpilot_state
POSIX shm segment with the same POD layout as the reference runtime
(visionpilot_shared_state.hpp:34-85), so external consumers are unchanged.

The library is built from the repository's own sources
(``host/src/{shared_state,frame_ring,iox2,capi}.cpp``, the flags of
host/CMakeLists.txt) with ``g++`` into ``build/torch_kernels/libavp_host.so``
at first use. A hash of the sources, the headers and the flags, stored
beside the library, decides whether a later process rebuilds it; a failed
build raises with g++'s stderr. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
HOST = ROOT / "host"
SOURCES = tuple(HOST / "src" / f"{name}.cpp"
                for name in ("shared_state", "frame_ring", "iox2", "capi"))
BUILD_DIR = ROOT / "build" / "torch_kernels"
LIBRARY = BUILD_DIR / "libavp_host.so"
CXX_FLAGS = ("-std=c++20", "-O2", "-fPIC", "-shared")


class VisionPilotStateStruct(ctypes.Structure):
    """ctypes mirror of avp::host::VisionPilotState (natural alignment)."""
    _fields_ = [
        ("seq", ctypes.c_uint64),
        ("frame_number", ctypes.c_uint64),
        ("steering_pid_deg", ctypes.c_double),
        ("steering_pid_raw_deg", ctypes.c_double),
        ("steering_autosteer_deg", ctypes.c_double),
        ("autosteer_valid", ctypes.c_bool),
        ("cte_m", ctypes.c_double),
        ("yaw_error_rad", ctypes.c_double),
        ("curvature_inv_m", ctypes.c_double),
        ("path_valid", ctypes.c_bool),
        ("lane_departure_warning", ctypes.c_bool),
        ("cipo_exists", ctypes.c_bool),
        ("cipo_track_id", ctypes.c_int),
        ("cipo_class_id", ctypes.c_int),
        ("cipo_distance_m", ctypes.c_double),
        ("cipo_velocity_ms", ctypes.c_double),
        ("cut_in_detected", ctypes.c_bool),
        ("kalman_reset", ctypes.c_bool),
        ("ideal_speed_ms", ctypes.c_double),
        ("safe_distance_m", ctypes.c_double),
        ("fcw_active", ctypes.c_bool),
        ("aeb_active", ctypes.c_bool),
        ("control_effort_ms2", ctypes.c_double),
        ("ego_speed_ms", ctypes.c_double),
        ("ego_steering_angle_deg", ctypes.c_double),
        ("can_valid", ctypes.c_bool),
    ]


def _digest() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    headers = sorted((HOST / "include").rglob("*.hpp"))
    for path in (*SOURCES, *headers):
        h.update(str(path.relative_to(HOST)).encode())
        h.update(path.read_bytes())
    return h.hexdigest()


def build() -> Path:
    """Compile the library unless one built from the same sources exists."""
    digest = _digest()
    stamp = LIBRARY.with_suffix(".sha256")
    if LIBRARY.exists() and stamp.exists() and stamp.read_text() == digest:
        return LIBRARY
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: it builds libavp_host.so from host/src")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = LIBRARY.with_name(f"{LIBRARY.stem}.{os.getpid()}.so")
    cmd = [cxx, *CXX_FLAGS, "-I", str(HOST / "include"), *map(str, SOURCES),
           "-o", str(tmp), "-lrt"]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed with exit code {proc.returncode}: "
                           f"{' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, LIBRARY)
    stamp.write_text(digest)
    return LIBRARY


@functools.cache
def _load_lib() -> ctypes.CDLL:
    """Build if needed, load once per process, declare the SHM signatures
    (frame_ring.py and iox2.py declare theirs)."""
    lib = ctypes.CDLL(str(build()))
    lib.avp_shm_create.restype = ctypes.c_void_p
    lib.avp_shm_create.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.avp_shm_destroy.argtypes = [ctypes.c_void_p]
    lib.avp_shm_destroy.restype = None
    lib.avp_shm_publish.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(VisionPilotStateStruct)]
    lib.avp_shm_publish.restype = None
    lib.avp_shm_read.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(VisionPilotStateStruct)]
    lib.avp_shm_read.restype = None
    lib.avp_shm_state_size.argtypes = []
    lib.avp_shm_state_size.restype = ctypes.c_ulonglong
    return lib


class _Base:
    def __init__(self, name: str, owner: bool):
        self._lib = _load_lib()
        native = int(self._lib.avp_shm_state_size())
        ours = ctypes.sizeof(VisionPilotStateStruct)
        if native != ours:
            raise RuntimeError(
                f"ABI mismatch: C++ struct {native} bytes vs ctypes {ours}")
        self._h = self._lib.avp_shm_create(name.encode(), 1 if owner else 0)
        if not self._h:
            raise RuntimeError(f"cannot open shm segment {name}")

    def close(self):
        if getattr(self, "_h", None):
            self._lib.avp_shm_destroy(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class SharedStatePublisher(_Base):
    def __init__(self, name: str = "/visionpilot_state"):
        super().__init__(name, owner=True)

    def publish(self, state: VisionPilotStateStruct):
        self._lib.avp_shm_publish(self._h, ctypes.byref(state))


class SharedStateReader(_Base):
    def __init__(self, name: str = "/visionpilot_state"):
        super().__init__(name, owner=False)

    def read(self) -> VisionPilotStateStruct:
        out = VisionPilotStateStruct()
        self._lib.avp_shm_read(self._h, ctypes.byref(out))
        return out
