"""Builds the port's CUDA kernels and loads them with ctypes.

Each ``autoware_vision_pilot_tpu_torch/csrc/*.cu`` is compiled by its own
``nvcc`` for ``sm_90a``, all of them at once, and the objects are linked
into one shared library with a plain C interface,
``build/torch_kernels/libavp_kernels.so`` at the repository root, at first
use. A hash of the sources, the headers they include (``csrc/*.cuh``) and
the flags, stored beside the library, decides whether a later process
rebuilds it. A failed compile raises with nvcc's stderr. Nothing here runs
at import time.
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
              "-O3", "-Xcompiler", "-fPIC")

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
# C entry point -> argtypes; every function returns a cudaError_t as int.
SIGNATURES = {
    # frame, out, y0, y1, fy, x0, x1, fx, mean, inv_std,
    # B, H, W, h, w, nh, nw, pad_y, pad_x, pad, out_bf16, stream
    "avp_fused_preprocess": (_P,) * 10 + (_I,) * 11 + (_P,),
    # x, xq, scale, per_channel, pixels, C, in_bf16, stream
    "avp_int8_quantize": (_P, _P, _P, _I, _L, _I, _I, _P),
    # xq, w, w_scale, x_scale, bias, out, B, H, W, C, N, KH, KW, pad,
    # out_kind, bm, grid_x, grid_y, stream
    "avp_int8_conv_mma": (_P,) * 6 + (_I,) * 12 + (_P,),
    # w, N, KH, KW, C, map_out
    "avp_int8_weight_map": (_P,) + (_I,) * 4 + (_P,),
    # xq, w_map, w_scale, x_scale, bias, out, ws, B, H, W, C, N, KH, KW,
    # pad, out_kind, th, tw, m_tiles, n_tiles, splits, per_split, blocks,
    # stream
    "avp_int8_conv_wgmma": (_P,) * 7 + (_I,) * 16 + (_P,),
    # x, in_kind, scale, rcp, per_channel, w, w_scale, bias, out, M, C, N,
    # out_kind, bm, m_tiles, n_tiles, cs, k_per_rank, stream
    "avp_int8_conv_pointwise": (_P, _I, _P, _P, _I) + (_P,) * 4 + (_I,) * 9 + (_P,),
    # x, in_kind, scale, rcp, per_channel, w, w_scale, bias, out, M, C, N,
    # out_kind, stream
    "avp_int8_conv_dot": (_P, _I, _P, _P, _I) + (_P,) * 4 + (_I,) * 4 + (_P,),
    # blocks, threads, cluster, stream
    "avp_launch_floor": (_I, _I, _I, _P),
    # masks, weights, starts, H, W, stamps, stream
    "avp_lane_filter_walk": (_P, _P, _P, _I, _I, _P, _P),
    # boxes, scores, classes, out_boxes, out_scores, out_classes, out_valid,
    # k, max_det, iou_thresh, conf_thresh, class_aware, cs, stamps, stream
    "avp_nms_greedy": (_P,) * 7 + (_I, _I, _F, _F, _I, _I, _P, _P),
}


def sources(csrc: Path = CSRC) -> list[Path]:
    return sorted(csrc.glob("*.cu"))


def _digest(csrc: Path = CSRC) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted([*csrc.glob("*.cu"), *csrc.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    return str(Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
               / "bin" / "nvcc")


def _run_all(cmds: list[list[str]]) -> None:
    """Start every command, wait for all, raise on the first failure."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for c in cmds]
    failures = []
    for cmd, proc in zip(cmds, procs):
        _, err = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed with exit code {proc.returncode}: "
                            f"{' '.join(cmd)}\n{err}")
    if failures:
        raise RuntimeError("\n".join(failures))


def build() -> Path:
    """Compile the library unless one built from the same sources exists."""
    digest = _digest()
    stamp = LIBRARY.with_suffix(".sha256")
    if LIBRARY.exists() and stamp.exists() and stamp.read_text() == digest:
        return LIBRARY
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, pid = _nvcc(), os.getpid()
    objects = [BUILD_DIR / f"{src.stem}.{pid}.o" for src in sources()]
    _run_all([[nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(obj), str(src)]
              for src, obj in zip(sources(), objects)])
    tmp = LIBRARY.with_name(f"{LIBRARY.stem}.{pid}.so")
    _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objects)]])
    for obj in objects:
        obj.unlink()
    os.replace(tmp, LIBRARY)
    stamp.write_text(digest)
    return LIBRARY


@functools.cache
def load() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare the C
    signatures (pointers and the stream as c_void_p, ints as c_int or
    c_int64, floats as c_float)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
