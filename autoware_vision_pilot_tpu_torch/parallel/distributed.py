"""torch.distributed worlds, the port of
autoware_vision_pilot_tpu/parallel/distributed.py (the reference's
``init_process_group('nccl', init_method='env://')``,
auto_speed_trainer.py:280-298).

A world is one process a device. ``initialize_distributed`` joins one from
arguments or the environment that JAX's reads (COORDINATOR_ADDRESS,
NUM_PROCESSES or WORLD_SIZE, PROCESS_ID or RANK) or that ``torchrun`` sets
(MASTER_ADDR and MASTER_PORT, LOCAL_RANK, LOCAL_WORLD_SIZE). The backend is
NCCL on the cards and gloo only where the caller asks for the CPU or names
it; nothing falls back from one to the other. Every process group has a
timeout, so a collective that hangs raises. ``run_world`` spawns a world on
this host, for the tests and for chip_smoke.py.
"""
from __future__ import annotations

import datetime
import io
import os
import queue
import tempfile
import time
import traceback
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..core import mesh as mesh_mod
from ..core.mesh import Mesh, make_mesh

DEFAULT_TIMEOUT_S = 300.0


def backend_for(device: torch.device, backend: Optional[str] = None) -> str:
    """The backend a rank on ``device`` joins with: ``backend`` when named,
    else NCCL for a card and gloo for the CPU."""
    return backend or ("nccl" if device.type == "cuda" else "gloo")


def init_world(world_size: int, rank: int, init_method: str = "env://", *, device="cuda",
               backend: Optional[str] = None, timeout: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join a world of ``world_size`` processes as ``rank`` on ``device``
    ("cuda" is the card of the rank's LOCAL_RANK, or of its rank modulo the
    cards). The backend is NCCL for a card and gloo for the CPU unless
    ``backend`` names one (gloo can reduce tensors on a card: several ranks
    on one card, which NCCL refuses). Collectives raise after ``timeout``
    seconds. -> the rank's device."""
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            local = os.environ.get("LOCAL_RANK")
            device = torch.device("cuda", int(local) if local is not None
                                  else rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    dist.init_process_group(backend_for(device, backend), init_method=init_method, world_size=world_size,
                            rank=rank, timeout=datetime.timedelta(seconds=timeout))
    mesh_mod._WORLD_DEVICE = device
    return device


def destroy_world() -> None:
    """Leave the world this process joined, if any."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    mesh_mod._WORLD_DEVICE = None


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, *, device="cuda",
                           backend: Optional[str] = None,
                           timeout: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join the world from the arguments or the env:// convention. Returns
    True when several processes run, False for one process (the
    reference's WORLD_SIZE == 1 path). Safe to call twice.
    ``coordinator`` is "host:port" (or a URL); without one the world meets
    at MASTER_ADDR:MASTER_PORT."""
    coordinator = coordinator or os.environ.get("COORDINATOR_ADDRESS")
    num_processes = num_processes or int(
        os.environ.get("NUM_PROCESSES", os.environ.get("WORLD_SIZE", 1)))
    process_id = process_id if process_id is not None else int(
        os.environ.get("PROCESS_ID", os.environ.get("RANK", 0)))
    if num_processes <= 1:
        return False
    if dist.is_initialized():
        return True
    init_method = ("env://" if not coordinator else
                   coordinator if "://" in coordinator else f"tcp://{coordinator}")
    init_world(num_processes, process_id, init_method, device=device, backend=backend,
               timeout=timeout)
    return True


def make_hybrid_mesh(ici_axes: Sequence[int] = (), axis_names: Sequence[str] = ("data",),
                     devices=None) -> Mesh:
    """A mesh whose leading axis ``dcn_data`` spans hosts and whose
    trailing axes span each host's devices. In a world the hosts are
    WORLD_SIZE / LOCAL_WORLD_SIZE (torchrun's variables; one host when
    LOCAL_WORLD_SIZE is unset); with one host this degrades to a flat mesh,
    so the same code runs everywhere."""
    flat = make_mesh(devices=devices)
    in_world = flat.group is not None
    n_hosts = 1
    if in_world:
        n_hosts = max(1, flat.size // int(os.environ.get("LOCAL_WORLD_SIZE", flat.size)))
    per_host = flat.size // n_hosts
    ici_axes = tuple(ici_axes) or (per_host,)
    shape = (n_hosts, *ici_axes) if n_hosts > 1 else ici_axes
    names = ("dcn_data", *axis_names) if n_hosts > 1 else tuple(axis_names)
    return Mesh(flat.devices.reshape(shape), names, flat.group)


def _rank_main(fn, rank, world_size, init_method, device, backend, timeout, args, results):
    try:
        init_world(world_size, rank, init_method, device=device, backend=backend,
                   timeout=timeout)
        buf = io.BytesIO()
        torch.save(fn(*args), buf)
        results.put((rank, True, buf.getvalue()))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        destroy_world()


def run_world(fn: Callable, world_size: int, *args, device="cuda", backend: Optional[str] = None,
              timeout: float = DEFAULT_TIMEOUT_S) -> list:
    """``fn(*args)`` in each rank of a new world of ``world_size`` spawned
    processes on this host (``fn`` importable by name; the processes start
    from a fresh import), each rank on ``device`` (see ``init_world``). -> the ranks' return values, in
    rank order, loaded on the CPU. Raises if a rank raises or dies, or if
    the world has not finished within ``timeout`` seconds; every process
    has ended when it returns."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        init_method = f"file://{os.path.join(tmp, 'store')}"
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, world_size, init_method, device, backend, timeout,
                                   args, results))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        got = {}
        deadline = time.monotonic() + timeout
        try:
            while len(got) < world_size:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"the world of {world_size} did not finish in "
                                       f"{timeout} s")
                try:
                    rank, ok, value = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [(r, p.exitcode) for r, p in enumerate(procs)
                            if p.exitcode is not None and r not in got]
                    if dead:
                        raise RuntimeError(f"rank {dead[0][0]} exited with {dead[0][1]} "
                                           "and no result")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} of {world_size} failed:\n{value}")
                got[rank] = torch.load(io.BytesIO(value), map_location="cpu",
                                       weights_only=False)
            for p in procs:
                p.join(max(deadline - time.monotonic(), 1.0))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join(10)
            results.close()
            results.join_thread()
    return [got[r] for r in range(world_size)]
