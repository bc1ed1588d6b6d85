"""Builds the port's CUDA kernels, loads them with ctypes, and builds their
PyTorch operators.

Each ``autoware_vision_pilot_tpu_torch/csrc/*.cu`` is compiled by its own
``nvcc`` for ``sm_90a``, and ``csrc/torch_ops.cpp`` by ``g++`` against
PyTorch's headers, all of them at once, at first use. The kernels' objects
are linked into one shared library with a plain C interface,
``build/torch_kernels/libavp_kernels.so`` at the repository root, and
torch_ops.cpp into ``libavp_torch_ops.so`` beside it, linked to that library
and to libtorch: the dispatcher operators ``torch.ops.avp.*`` through which
the wrappers, exported programs and the C++ loop call the kernels
(ops/kernels/torch_ops.py loads it). A hash of the sources, the headers
they include (``csrc/*.cuh``, ``csrc/*.hpp``) and the compile commands,
stored beside the libraries, decides whether a later process rebuilds
them. A failed compile raises with the compiler's stderr.
Nothing here runs at import time.
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
OPS_SOURCE = CSRC / "torch_ops.cpp"
OPS_LIBRARY = BUILD_DIR / "libavp_torch_ops.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry point -> argtypes; every function returns a cudaError_t as int. The
# kernels themselves (preprocess, letterbox, lane-filter walk, NMS, the int8
# quantize and convs) are called through their operators
# (csrc/torch_ops.cpp), not from here: these are the stamp buffers of
# chip_smoke.py's stamped builds and the launch floor.
SIGNATURES = {
    # stamps (a build with -DAVP_LB_STAMPS; else cudaErrorNotSupported)
    "avp_letterbox_set_stamps": (_P,),
    # stamps (a build with -DAVP_PW_STAMPS; else cudaErrorNotSupported)
    "avp_int8_pointwise_set_stamps": (_P,),
    # stamps (builds with -DAVP_HALO_STAMPS, -DAVP_D2S_STAMPS,
    # -DAVP_STRIDED_STAMPS; else cudaErrorNotSupported)
    "avp_int8_halo_set_stamps": (_P,),
    "avp_int8_d2s_set_stamps": (_P,),
    "avp_int8_strided_set_stamps": (_P,),
    # blocks, threads, cluster, stream
    "avp_launch_floor": (_I, _I, _I, _P),
}


def sources(csrc: Path = CSRC) -> list[Path]:
    return sorted(csrc.glob("*.cu"))


def _digest(csrc: Path = CSRC, ops_cmd: tuple = ()) -> str:
    h = hashlib.sha256(" ".join((*NVCC_FLAGS, *ops_cmd)).encode())
    for src in sorted([*csrc.glob("*.cu"), *csrc.glob("*.cuh"), *csrc.glob("*.hpp"),
                       *csrc.glob("*.cpp")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    return str(Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
               / "bin" / "nvcc")


def ops_flags() -> list[str]:
    """g++'s flags for code that includes PyTorch's and CUDA's headers and
    links to libtorch (csrc/torch_ops.cpp, the C++ app loop): the headers
    and libraries of the torch installed, its C++ ABI, and the CUDA
    toolkit's headers."""
    import torch
    from torch.utils import cpp_extension

    cuda_home = Path(os.environ.get("CUDA_HOME") or Path(_nvcc()).parents[1])
    libs = cpp_extension.library_paths()
    return ["-std=c++17", "-O2", "-fPIC",
            f"-D_GLIBCXX_USE_CXX11_ABI={int(torch._C._GLIBCXX_USE_CXX11_ABI)}",
            *(f"-I{p}" for p in [*cpp_extension.include_paths(), cuda_home / "include"]),
            *(f"-L{p}" for p in libs), *(f"-Wl,-rpath,{p}" for p in libs)]


def _run_all(cmds: list[list[str]]) -> None:
    """Start every command, wait for all, raise on the first failure."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for c in cmds]
    failures = []
    for cmd, proc in zip(cmds, procs):
        _, err = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{Path(cmd[0]).name} failed with exit code {proc.returncode}: "
                            f"{' '.join(cmd)}\n{err}")
    if failures:
        raise RuntimeError("\n".join(failures))


def build() -> Path:
    """Compile both libraries unless ones built from the same sources and
    commands exist. -> the kernels' library."""
    ops_cmd = ("g++", *ops_flags())
    digest = _digest(ops_cmd=ops_cmd)
    stamp = LIBRARY.with_suffix(".sha256")
    if LIBRARY.exists() and OPS_LIBRARY.exists() and stamp.exists() and \
            stamp.read_text() == digest:
        return LIBRARY
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, pid = _nvcc(), os.getpid()
    objects = [BUILD_DIR / f"{src.stem}.{pid}.o" for src in sources()]
    ops_object = BUILD_DIR / f"torch_ops.{pid}.o"
    _run_all([[nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(obj), str(src)]
              for src, obj in zip(sources(), objects)]
             + [[*ops_cmd, "-c", "-o", str(ops_object), str(OPS_SOURCE)]])
    tmp = LIBRARY.with_name(f"{LIBRARY.stem}.{pid}.so")
    _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objects)]])
    for obj in objects:
        obj.unlink()
    os.replace(tmp, LIBRARY)
    ops_tmp = OPS_LIBRARY.with_name(f"{OPS_LIBRARY.stem}.{pid}.so")
    _run_all([[*ops_cmd, "-shared", "-o", str(ops_tmp), str(ops_object), f"-L{BUILD_DIR}",
               f"-Wl,-rpath,{BUILD_DIR}", "-Wl,--no-as-needed", "-lavp_kernels", "-lc10",
               "-lc10_cuda", "-ltorch_cpu", "-ltorch_cuda", "-ltorch"]])
    ops_object.unlink()
    os.replace(ops_tmp, OPS_LIBRARY)
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
