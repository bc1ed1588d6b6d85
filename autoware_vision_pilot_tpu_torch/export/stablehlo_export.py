"""Deployment export: serialized torch.export programs, the port of
autoware_vision_pilot_tpu/export/stablehlo_export.py.

The reference's deployment contract is the ONNX file
(Models/exports/convert_pytorch_to_onnx.py, shapes :90-97). The JAX package
serializes its jitted forward to StableHLO; the port's artifact is a
``torch.export`` program (an ``ExportedProgram`` saved as a ``.pt2``, not
StableHLO), which ``load_stablehlo`` loads and runs without the module's
Python code, and which AOTInductor can compile to a package that a C++
process runs (export/native_app.py). The names stay the JAX package's. A
program exported on the card calls the hand kernels as the dispatcher
operators ``torch.ops.avp.*`` (csrc/torch_ops.cpp), the int8 convs and
transposed convs among them; one exported on the CPU holds their plain
versions.
"""
from __future__ import annotations

import pathlib
from typing import Callable, Sequence

import torch

# The reference's export shapes (convert_pytorch_to_onnx.py:90-97) in the
# port's NCHW layout: the JAX package's (1, H, W, 3) as (1, 3, H, W).
EXPORT_SHAPES = {
    "SceneSeg": (1, 3, 320, 640),
    "Scene3D": (1, 3, 320, 640),
    "DomainSeg": (1, 3, 320, 640),
    "EgoLanes": (1, 3, 320, 640),
    "AutoSpeed": (1, 3, 512, 1024),
    "AutoSteer": (1, 3, 512, 1024),
    "AutoDrive": (1, 3, 512, 1024),
}


class _Fn(torch.nn.Module):
    """A module whose forward is ``fn``: what torch.export takes."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def export_stablehlo(fn: Callable, example_args: Sequence,
                     path: str | pathlib.Path) -> pathlib.Path:
    """``torch.export`` of ``fn`` (a module, or any callable, wrapped in
    one) at the example arguments' shapes, saved to ``path`` (a ``.pt2``
    zip). Tensors that ``fn`` holds (a module's weights, a kernel's tables)
    are saved with the program. The caches of per-device tables that the
    port keeps must be filled before a trace, by one eager call on the same
    device, or the trace would keep fake tensors in them: this runs that
    call first."""
    module = fn if isinstance(fn, torch.nn.Module) else _Fn(fn)
    example_args = tuple(example_args)
    with torch.no_grad():
        module(*example_args)
    exported = torch.export.export(module, example_args)
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.export.save(exported, path)
    return path


def load_stablehlo(path: str | pathlib.Path):
    """Load a saved program; returns a callable (the program's module). A
    program that calls the ``avp`` operators needs their library, which is
    built and loaded first where a card is present."""
    if torch.cuda.is_available():
        from ..ops.kernels import torch_ops
        torch_ops.load()
    return torch.export.load(pathlib.Path(path)).module()


def export_model(model: torch.nn.Module, name: str,
                 out_dir: str | pathlib.Path = "exports",
                 dtype=torch.bfloat16) -> pathlib.Path:
    """Export ``model(x)`` at the reference shape for ``name`` to
    ``<out_dir>/<name>.pt2``, the input in ``dtype`` on the model's device.
    The module holds its weights, so there is no ``variables`` argument:
    they are saved with the program as the JAX package bakes them in as
    constants. AutoDrive takes two frames."""
    shape = EXPORT_SHAPES[name]
    device = next(model.parameters()).device
    n_in = 2 if name == "AutoDrive" else 1
    example = tuple(torch.zeros(shape, dtype=dtype, device=device) for _ in range(n_in))
    return export_stablehlo(model.eval(), example, pathlib.Path(out_dir) / f"{name}.pt2")
