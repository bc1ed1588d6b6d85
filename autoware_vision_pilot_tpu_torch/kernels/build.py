"""Builds the port's CUDA kernels and loads them with ctypes.

All of ``autoware_vision_pilot_tpu_torch/csrc/*.cu`` is compiled by ``nvcc``
for ``sm_90a`` into one shared library with a plain C interface,
``build/torch_kernels/libavp_kernels.so`` at the repository root, at first
use. A hash of the sources and flags, stored beside the library, decides
whether a later process rebuilds it. A failed compile raises with nvcc's
stderr. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE = Path(__file__).resolve().parents[1]
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE.parent / "build" / "torch_kernels"
LIBRARY = BUILD_DIR / "libavp_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry point -> argtypes; every function returns a cudaError_t as int.
SIGNATURES = {
    # frame, out, y0, y1, fy, x0, x1, fx, mean, std,
    # B, H, W, h, w, out_bf16, stream
    "avp_fused_preprocess": (_P,) * 10 + (_I,) * 6 + (_P,),
}


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    return str(Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
               / "bin" / "nvcc")


def build() -> Path:
    """Compile the library unless one built from the same sources exists."""
    digest = _digest()
    stamp = LIBRARY.with_suffix(".sha256")
    if LIBRARY.exists() and stamp.exists() and stamp.read_text() == digest:
        return LIBRARY
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = LIBRARY.with_name(f"{LIBRARY.stem}.{os.getpid()}.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed with exit code {proc.returncode}: "
                           f"{' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, LIBRARY)
    stamp.write_text(digest)
    return LIBRARY


@functools.cache
def load() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare the C
    signatures (pointers and the stream as c_void_p, ints as c_int)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
