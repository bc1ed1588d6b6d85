"""Device meshes, the port of autoware_vision_pilot_tpu/core/mesh.py.

A ``Mesh`` is an array of ``torch.device``s with axis names, as
``jax.sharding.Mesh`` is an array of JAX devices. It is one of two kinds:

- a local mesh: devices of this process (``cuda:0``, ``cuda:1``, ... or the
  CPU, a device may repeat). The fleet (runtime/fleet.py), the batch-sharded
  inference (parallel/multichip_inference.py) and tensor parallelism
  (parallel/tensor_parallel.py) run one process over such a mesh, a replica
  of the networks on each device, with no collective.
- a world mesh: the ranks of a ``torch.distributed`` world, one process and
  one device a rank (``group`` set; ``devices[r]`` is rank r's device). The
  data-parallel train step runs on such a mesh (train/train_step.py), with
  its collectives over the group.

``make_mesh()`` with no arguments is the data mesh over the world's ranks
inside an initialized world (parallel/distributed.py), and over the local
cards outside one; pass ``devices="cpu"`` for the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"

# This process's device in its torch.distributed world, as
# parallel/distributed.py::init_world was given it (the world itself is
# process-wide state of torch.distributed).
_WORLD_DEVICE: Optional[torch.device] = None


def _object_array(devices, shape) -> np.ndarray:
    arr = np.empty(len(devices), dtype=object)
    arr[:] = list(devices)
    return arr.reshape(shape)


class Mesh:
    """``devices``: an object array of ``torch.device`` whose axes are named
    ``axis_names``. ``group``: the process group whose ranks the devices
    are, in rank order (a world mesh), or None (a local mesh)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str], group=None):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim} mesh axes but names {tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.group = group

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def rank(self) -> int:
        """This process's rank in the mesh's group (0 on a local mesh)."""
        return 0 if self.group is None else dist.get_rank(self.group)

    @property
    def local_devices(self) -> list:
        """The devices this process drives: all of a local mesh's, one of a
        world mesh's (its rank's)."""
        flat = list(self.devices.flat)
        return flat if self.group is None else [flat[self.rank]]

    def __repr__(self):
        kind = "world" if self.group is not None else "local"
        return f"Mesh({kind}, {self.shape}, {[str(d) for d in self.devices.flat]})"


def _rank_device(kind: Optional[str]) -> torch.device:
    if kind is None and _WORLD_DEVICE is not None:
        return _WORLD_DEVICE
    if kind in (None, "cuda"):
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(kind)


def make_mesh(axis_sizes: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = (DATA_AXIS,),
              devices: Union[None, str, Sequence] = None) -> Mesh:
    """A mesh over ``devices``: a sequence of devices (a local mesh), or
    None or a device type ("cuda", "cpu"). Inside an initialized
    torch.distributed world, None or a type gives the world mesh over its
    ranks (this rank's device: the one the world was initialized with, or
    the current card, or the CPU); outside one, the local cards, or the
    CPU. With no ``axis_sizes``: a 1-D data mesh over all of them."""
    group = None
    if devices is None or isinstance(devices, str):
        if dist.is_available() and dist.is_initialized():
            mine = str(_rank_device(devices))
            gathered = [None] * dist.get_world_size()
            dist.all_gather_object(gathered, mine)
            devices = [torch.device(d) for d in gathered]
            group = dist.group.WORLD
        elif devices in (None, "cuda"):
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        else:
            devices = [torch.device(devices)]
    devices = [torch.device(d) for d in devices]
    if axis_sizes is None:
        axis_sizes = (len(devices),)
    n = int(np.prod(axis_sizes))
    if n > len(devices) or (group is not None and n != len(devices)):
        raise ValueError(f"mesh needs {n} devices, have {len(devices)}"
                         + (" ranks" if group is not None else ""))
    return Mesh(_object_array(devices[:n], tuple(axis_sizes)), axis_names, group)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """How a tensor lies over a mesh, as a ``NamedSharding``: ``spec``
    names, for each dimension, the mesh axis it is split over, or None
    (replicated along it); ``()`` replicates the whole tensor."""
    mesh: Mesh
    spec: tuple

    def pieces(self, x: torch.Tensor) -> list:
        """``x``'s pieces for this process's devices, each on its device.
        Replicated: a copy on each local device. Split over the data axis:
        on a local mesh one piece a data index, on the first device along
        the other axes (``data_devices``); on a world mesh the rows of this
        rank, split over all the ranks. A dimension that does not divide
        raises."""
        axes = [a for a in self.spec if a is not None]
        if not axes:
            return [x.to(d) for d in self.mesh.local_devices]
        if axes != [DATA_AXIS]:
            raise ValueError(f"only the data axis places rows, not {self.spec}")
        dim = self.spec.index(DATA_AXIS)
        world = self.mesh.group is not None
        devices = self.mesh.local_devices if world else data_devices(self.mesh)
        n = self.mesh.size if world else len(devices)
        if x.shape[dim] % n:
            raise ValueError(f"dimension {dim} ({x.shape[dim]}) does not divide over {n} "
                             f"{'ranks' if world else 'devices'}")
        chunks = x.chunk(n, dim)
        if world:
            return [chunks[self.mesh.rank].to(devices[0])]
        return [c.to(d) for c, d in zip(chunks, devices)]


def data_devices(mesh: Mesh) -> list:
    """The device of each index of a local mesh's data axis: the first
    along its other axes (all of a 1-D mesh's devices)."""
    arr = np.moveaxis(mesh.devices, mesh.axis_names.index(DATA_AXIS), 0)
    return list(arr.reshape(arr.shape[0], -1)[:, 0])


def data_sharding(mesh: Mesh, ndim: int, axis: int = 0) -> Sharding:
    """Dimension ``axis`` of an ndim-tensor split over the data axis."""
    spec = [None] * ndim
    spec[axis] = DATA_AXIS
    return Sharding(mesh, tuple(spec))


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())
