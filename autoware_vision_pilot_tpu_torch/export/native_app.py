"""Export a stateful per-frame step as a native-app bundle, the port of
autoware_vision_pilot_tpu/export/native_app.py.

The reference's deployable unit is a Python-free native binary
(VisionPilot/production_release/main.cpp:1543-1959: capture -> engines ->
SHM publisher). Here the per-frame step, ``step(frame_u8, state, noise=)
-> (outputs, new_state)`` (runtime/pipeline.py::build_lateral_step), is
exported once with ``torch.export``, compiled by AOTInductor into a package
and run in a loop by ``autoware_vision_pilot_tpu_torch/host/tools/
visionpilot_app.cpp`` with no Python in the deployed process: the loop
feeds each iteration's state outputs back into the next iteration's state
inputs, on the device. On the card the package calls the hand kernels as
the operators ``torch.ops.avp.*`` (csrc/torch_ops.cpp), whose library the
loop loads before the package. ``autoware_vision_pilot_tpu_torch/tools/
export_native_app.py`` exports the lateral bundle and, with
``--longitudinal``, the AutoSpeed detection bundle.

Bundle (all files in one directory):

- ``<name>.pt2``: the AOTInductor package. Inputs: ``frame`` (uint8), then,
  for a state that holds a generator, ``u`` (the generator's
  ``torch.rand(noise_dim)`` draw for the frame, which the program turns into
  PathFinder's process noise), then ``state_0..state_{n-1}`` (f32); outputs
  ``out_0..out_{m-1}`` then ``state_out_0..state_out_{n-1}``.
- ``<name>_state_<i>.npy``: the initial state tensors (f32 wire format).
- ``<name>_rng.npy``: the generator's ``get_state()`` bytes (uint8), where
  the state holds one: a generator cannot be an input of a graph (it
  advances in place), so the loop keeps it, restored to this state, and
  draws each frame's ``u`` from it; a trajectory continues the Python one.
- ``<name>_probe_frame.npy``, ``<name>_probe_scalars.npy``: a seeded frame
  and ``out_0`` of the compiled package on it from the initial state, run
  in full f32 (TF32 off), as the loop runs the packages.
- ``<name>_manifest.txt``: ``package <file>``, ``device <cpu|cuda>``,
  ``frame <H> <W> <C>``, ``noise <dim>`` (0: no generator), ``n_state
  <n>``, ``n_out <m>``, ``out <i> <rank> <dims...>``.

State wire format: every leaf crosses the boundary as float32: f32 leaves
pass through, bool casts (exact), 4-byte ints are bitcast, 8-byte ints
become two f32 words on a trailing axis (bitcast); the wrapper restores the
exact tree and dtypes in the graph.
"""
from __future__ import annotations

import contextlib
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
from typing import Sequence

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..perception.path_finder import STATE_DIM, noise_from_uniform
from .stablehlo_export import _Fn

REPO = pathlib.Path(__file__).resolve().parents[2]
APP_SOURCE = REPO / "autoware_vision_pilot_tpu_torch" / "host" / "tools" / "visionpilot_app.cpp"
HOST_SOURCES = tuple(REPO / "host" / "src" / f"{n}.cpp"
                     for n in ("shared_state", "frame_ring", "can_reader", "longitudinal"))
APP = REPO / "build" / "torch_kernels" / "visionpilot_app"


def _to_wire(leaf: torch.Tensor) -> torch.Tensor:
    """Encode one state leaf as an f32 tensor (see the module docstring)."""
    if leaf.dtype == torch.bool:
        return leaf.to(torch.float32)
    if leaf.dtype in (torch.int32, torch.uint32):
        return leaf.view(torch.float32)
    if leaf.dtype in (torch.int64, torch.uint64):
        return leaf[..., None].view(torch.float32)
    return leaf.to(torch.float32)


def _from_wire(wire: torch.Tensor, proto: torch.Tensor) -> torch.Tensor:
    """Decode an f32 wire tensor back to ``proto``'s dtype."""
    if proto.dtype == torch.bool:
        return wire > 0.5
    if proto.dtype in (torch.int32, torch.uint32):
        return wire.view(proto.dtype)
    if proto.dtype in (torch.int64, torch.uint64):
        return wire.view(proto.dtype)[..., 0]
    return wire.to(proto.dtype)


def _state_parts(state):
    """-> (leaves, tree spec, tensor leaves, the generator or None)."""
    leaves, spec = pytree.tree_flatten(state)
    gens = [leaf for leaf in leaves if isinstance(leaf, torch.Generator)]
    other = [type(leaf) for leaf in leaves
             if not isinstance(leaf, (torch.Tensor, torch.Generator))]
    if len(gens) > 1 or other:
        raise TypeError(f"a state holds tensors and at most one generator, got "
                        f"{len(gens)} generators and {other}")
    return leaves, spec, [leaf for leaf in leaves if isinstance(leaf, torch.Tensor)], \
        (gens[0] if gens else None)


@contextlib.contextmanager
def _full_f32():
    """TF32 off for cuDNN and cuBLAS while a package runs, as the C++ loop
    runs it: the packages' convolutions and matrix products read these
    flags when they run, and the lateral fits turn the last bits of the
    lane logits into visible steering."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _generator(device: torch.device, state_bytes: torch.Tensor) -> torch.Generator:
    g = torch.Generator(device=device)
    g.set_state(state_bytes)
    return g


def _openmp_cxx() -> str:
    """The C++ compiler for AOTInductor's wrapper, which it builds with
    -fopenmp: the first of $CXX, g++, c++ whose own libgomp.spec exists (a
    gcc built without libgomp refuses -fopenmp)."""
    for name in (os.environ.get("CXX"), "g++", "/usr/bin/g++", "c++"):
        cxx = name and shutil.which(name)
        if not cxx:
            continue
        spec = subprocess.run([cxx, "-print-file-name=libgomp.spec"], capture_output=True,
                              text=True).stdout.strip()
        if os.path.isabs(spec) and os.path.exists(spec):
            return cxx
    raise RuntimeError("no C++ compiler with OpenMP (libgomp.spec) for AOTInductor")


def wire_step(step, init_state, frame_shape: Sequence[int], outputs_from, device):
    """The step as the bundle's program: ``fn(frame_u8, [u,] *wire_state) ->
    (*outputs, *new_wire_state)``, every output f32, with the state in the
    wire format and, for a state that holds a generator, ``u`` its
    ``torch.rand(STATE_DIM)`` draw, from which the program computes the
    process noise that the step takes as ``noise=``. The per-device table
    caches are filled by one eager call before it returns (a trace that
    filled one would keep a fake tensor there). -> (fn, example inputs,
    n_out, the generator's initial get_state() bytes or None)."""
    device = torch.device(device)
    leaves, spec, protos, generator = _state_parts(init_state)
    wire0 = [_to_wire(p).to(device) for p in protos]
    rng0 = None if generator is None else generator.get_state()

    def fn(frame_u8, *inputs):
        u, wire = (inputs[0], inputs[1:]) if generator is not None else (None, inputs)
        it = iter(_from_wire(w, p) for w, p in zip(wire, protos))
        state = pytree.tree_unflatten(
            [leaf if isinstance(leaf, torch.Generator) else next(it) for leaf in leaves], spec)
        if generator is None:
            out, new_state = step(frame_u8, state)
        else:
            out, new_state = step(frame_u8, state, noise=noise_from_uniform(u))
        new = [leaf for leaf in pytree.tree_leaves(new_state) if isinstance(leaf, torch.Tensor)]
        outs = [a.to(torch.float32) for a in outputs_from(out)] + [_to_wire(n) for n in new]
        # an output that is an input (a state leaf the step leaves as it is)
        # gets a buffer of its own: the loop feeds it back as the next input
        return tuple(o.clone() if any(o is i for i in (frame_u8, *inputs)) else o
                     for o in outs)

    frame0 = torch.zeros(tuple(frame_shape), dtype=torch.uint8, device=device)
    noise_in = () if generator is None else (
        torch.rand(STATE_DIM, generator=_generator(device, rng0), device=device),)
    example = (frame0, *noise_in, *wire0)
    with torch.no_grad():
        warm = fn(*example)
    n_out = len(warm) - len(wire0)
    for w, o in zip(wire0, warm[n_out:]):
        if w.shape != o.shape:
            raise ValueError(f"the step returns a state leaf of shape {tuple(o.shape)} for "
                             f"one of {tuple(w.shape)}: the loop could not feed it back")
    return fn, example, n_out, rng0


def export_native_app(step, init_state, frame_shape: Sequence[int], out_dir,
                      name: str = "lateral",
                      outputs_from=lambda out: [out["scalars"], out["coeffs"]],
                      device="cuda") -> pathlib.Path:
    """Export ``step(frame_u8, state[, noise=]) -> (outputs, new_state)`` on
    ``device`` for the C++ loop (host/tools/visionpilot_app.cpp of this
    package). ``init_state`` is a tree of tensors on ``device`` and at most
    one generator; with a generator the step is called with ``noise=`` (the
    process noise of path_finder.py, from the generator's draw, an input).

    ``outputs_from`` selects which per-frame tensors the host receives (the
    order defines out_0..out_{m-1}; out_0 must be the packed scalar vector
    the loop publishes). The golden probe runs through the compiled
    package.

    Returns the manifest path.
    """
    device = torch.device(device)
    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    fn, example, n_out, rng0 = wire_step(step, init_state, frame_shape, outputs_from, device)
    inputs = example[1:]
    n_state = len(inputs) - (rng0 is not None)
    t0 = time.perf_counter()
    exported = torch.export.export(_Fn(fn), example)
    t1 = time.perf_counter()
    with torch._inductor.config.patch({"cpp.cxx": (_openmp_cxx(),)}):
        package = torch._inductor.aoti_compile_and_package(
            exported, package_path=str(out_dir / f"{name}.pt2"))
    print(f"[native_app] {name}: torch.export {t1 - t0:.1f} s, AOTInductor compile "
          f"{time.perf_counter() - t1:.1f} s", flush=True)

    # golden probe: one seeded frame through the compiled package from the
    # initial state, so the C++ loop's first iteration is checked against
    # the program it runs, not against eager PyTorch
    rng = np.random.default_rng(7)
    probe = rng.integers(0, 256, tuple(frame_shape), dtype=np.uint8)
    compiled = torch._inductor.aoti_load_package(package)
    with _full_f32():
        probe_out = compiled(torch.from_numpy(probe).to(device), *inputs)

    for i, w in enumerate(inputs[len(inputs) - n_state:]):
        np.save(out_dir / f"{name}_state_{i}.npy", w.cpu().numpy().astype(np.float32))
    if rng0 is not None:
        np.save(out_dir / f"{name}_rng.npy", rng0.numpy())
    np.save(out_dir / f"{name}_probe_frame.npy", probe)
    np.save(out_dir / f"{name}_probe_scalars.npy",
            probe_out[0].cpu().numpy().astype(np.float32))
    lines = [f"package {name}.pt2", f"device {device.type}",
             "frame " + " ".join(str(d) for d in frame_shape),
             f"noise {0 if rng0 is None else STATE_DIM}",
             f"n_state {n_state}", f"n_out {n_out}"]
    for j in range(n_out):
        o = probe_out[j]
        lines.append(f"out {j} {o.dim()} " + " ".join(str(d) for d in o.shape))
    man = out_dir / f"{name}_manifest.txt"
    man.write_text("\n".join(lines) + "\n")
    return man


def _manifest(out_dir: pathlib.Path, name: str) -> dict:
    fields = {}
    for line in (out_dir / f"{name}_manifest.txt").read_text().splitlines():
        key, *rest = line.split()
        if key != "out":
            fields[key] = rest
    return fields


def replay_native_app(out_dir, name: str, frames: Sequence[np.ndarray],
                      golden: bool = True) -> list:
    """The C++ loop's iterations in Python on the same compiled package:
    the probe frame first (``golden``), then ``frames`` (uint8 (H, W, C)
    each), the state fed back and ``u`` drawn from the bundle's generator.
    -> out_0 of each iteration, as numpy f32."""
    out_dir = pathlib.Path(out_dir)
    man = _manifest(out_dir, name)
    device = torch.device(man["device"][0])
    n_state, n_noise = int(man["n_state"][0]), int(man["noise"][0])
    if device.type == "cuda":  # the package calls the avp operators
        from ..ops.kernels import torch_ops
        torch_ops.load()
    compiled = torch._inductor.aoti_load_package(str(out_dir / man["package"][0]))
    state = [torch.from_numpy(np.load(out_dir / f"{name}_state_{i}.npy")).to(device)
             for i in range(n_state)]
    gen = None if n_noise == 0 else _generator(
        device, torch.from_numpy(np.load(out_dir / f"{name}_rng.npy")))
    if golden:
        frames = [np.load(out_dir / f"{name}_probe_frame.npy"), *frames]
    scalars = []
    with _full_f32():
        for f in frames:
            noise = () if gen is None else (torch.rand(n_noise, generator=gen, device=device),)
            outs = compiled(torch.from_numpy(np.ascontiguousarray(f)).to(device), *noise, *state)
            state = list(outs[len(outs) - n_state:])
            scalars.append(outs[0].cpu().numpy().astype(np.float32))
    return scalars


def _app_digest(cmd: list) -> str:
    h = hashlib.sha256(" ".join(cmd).encode())
    headers = sorted((REPO / "host" / "include").rglob("*.hpp"))
    for path in (APP_SOURCE, *HOST_SOURCES, *headers):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()


def build_app() -> pathlib.Path:
    """Build the C++ loop (host/tools/visionpilot_app.cpp of this package,
    with the root host/src's shared state, frame ring, CAN reader and
    longitudinal stack) with g++ against the installed libtorch into
    build/torch_kernels/visionpilot_app, unless one built from the same
    sources and command exists. A failed build raises with g++'s stderr."""
    from ..kernels.build import ops_flags

    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: it builds the native app loop")
    libdir = pathlib.Path(torch.__file__).parent / "lib"
    cuda_libs = ["-ltorch_cuda", "-lc10_cuda"] if (libdir / "libtorch_cuda.so").exists() else []
    # C++20 for host/src (std::atomic_ref), as host/shm.py builds it
    cmd = [cxx, *ops_flags(), "-std=c++20", "-I", str(REPO / "host" / "include"), "-o", "{out}",
           str(APP_SOURCE), *map(str, HOST_SOURCES), "-Wl,--no-as-needed", *cuda_libs,
           "-ltorch", "-ltorch_cpu", "-lc10", "-Wl,--as-needed", "-ldl", "-lrt", "-lpthread"]
    digest = _app_digest(cmd)
    stamp = APP.with_suffix(".sha256")
    if APP.exists() and stamp.exists() and stamp.read_text() == digest:
        return APP
    APP.parent.mkdir(parents=True, exist_ok=True)
    tmp = APP.with_name(f"{APP.name}.{os.getpid()}")
    proc = subprocess.run([str(tmp) if c == "{out}" else c for c in cmd],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed with exit code {proc.returncode}: {' '.join(cmd)}\n"
                           f"{proc.stderr}")
    os.replace(tmp, APP)
    stamp.write_text(digest)
    return APP
