"""Fleet serving: N independent camera streams on one card, the port of
autoware_vision_pilot_tpu/runtime/fleet.py.

The reference runtime serves exactly one camera (production_release/
main.cpp:366-448 — a single capture thread). The JAX package vmaps its
lateral and longitudinal steps over a leading stream axis; here that axis is
written out: ``build_batched_lateral_step`` and
``build_batched_longitudinal_step`` (runtime/pipeline.py) run one set of
launches a tick for all N streams. The networks run at batch N, and the
preprocess, lane-filter walk and NMS kernels each launch once for the whole
batch, a block row or a thread-block cluster a stream. Every stream carries
its own full device-resident state (EgoLanes temporal ring, LaneFilter
history, LaneTracker width cache, Bayes filter, steering ring, and its own
PathFinder generator), so a stream's results do not depend on the others.

Over a local mesh (core/mesh.py; the JAX package's ``mesh``, streams
sharded over chips) the stream axis is split in equal shards over the
mesh's data devices, one process driving them all: a replica of the
networks on each device, a batched step a shard (each launches its own
preprocess, walk, letterbox and NMS kernels), no collective. Stream i keeps
its seed, and its results come back in stream order, on the first device.
"""
from __future__ import annotations

from collections import deque
from typing import Optional

import numpy as np
import torch

from ..control.pi_controller import PIController
from ..control.speed_planner import SpeedPlanner
from ..core.mesh import data_devices
from ..parallel.multichip_inference import concat_outputs, local_mesh, module_device, replicas_on
from .config import Config
from .pipeline import (SCALAR_FIELDS, DeviceStaging, FrameResult, _sync_debug,
                       build_batched_lateral_step, build_batched_longitudinal_step,
                       detections, init_lateral_states, lane_departure)

__all__ = ["FleetLateralPipeline", "FleetLongitudinalPipeline",
           "FleetEngine", "unpack_fleet_scalars", "SCALAR_FIELDS"]


def mesh_shards(mesh, n: int) -> list:
    """The data devices of a local ``mesh`` over which ``n`` streams split
    in equal shards."""
    devices = data_devices(local_mesh(mesh, "the fleet"))
    if n % len(devices):
        raise ValueError(f"{n} streams do not split over the mesh's {len(devices)} devices")
    return devices


class FleetLateralPipeline:
    """The lateral step over ``n_streams`` independent cameras, one tick a
    call, on the networks' device.

    __call__(frames_u8 (N, H, W, 3), states, noise=None) -> (outputs,
    states), where every output of the single-stream step gains a leading
    stream axis (scalars (N, 8), coeffs (N, 3, 6), lane_masks (N, h/4, w/4,
    3)).
    """

    def __init__(self, lanes, steer_net, cfg: Config, n_streams: int,
                 frame_hw=(720, 1280), crop_y: int = 420, dtype=torch.bfloat16,
                 mesh=None, pad_to: int = 0, net_hw=(320, 640)):
        """pad_to > n_streams runs the step at a larger physical batch:
        padding streams carry zero frames and their own state, and outputs
        are sliced back to n_streams. Each stream's results do not depend
        on the others, padding included (tests/test_torch_fleet.py). Over a
        ``mesh`` the pad_to streams (padding included) split in equal
        shards over its data devices."""
        self.n_streams = n_streams
        self.pad_to = max(pad_to, n_streams) if pad_to else n_streams
        self.mask_hw = (net_hw[0] // 4, net_hw[1] // 4)

        def step_on(lanes, steer_net):
            return build_batched_lateral_step(lanes, steer_net, cfg, frame_hw=frame_hw,
                                              crop_y=crop_y, dtype=dtype, net_hw=net_hw)

        if mesh is None:
            self.device = module_device(lanes)
            self._step, self._shards = step_on(lanes, steer_net), None
        else:
            devices = mesh_shards(mesh, self.pad_to)
            lanes_on, steer_on = replicas_on(lanes, devices), replicas_on(steer_net, devices)
            steps = {d: step_on(lanes_on[d], steer_on[d]) for d in lanes_on}
            self.device = devices[0]
            self._shards = [(d, steps[d]) for d in devices]

    def init_states(self, seed: int = 0):
        if self._shards is None:
            return init_lateral_states(self.pad_to, seed, self.mask_hw, self.device)
        per = self.pad_to // len(self._shards)
        return tuple(init_lateral_states(per, seed, self.mask_hw, d, first=k * per)
                     for k, (d, _) in enumerate(self._shards))

    def __call__(self, frames_u8, states, noise=None):
        n_pad = self.pad_to - self.n_streams
        if n_pad:
            frames_u8 = torch.cat([frames_u8, frames_u8.new_zeros((n_pad, *frames_u8.shape[1:]))])
            if noise is not None:
                noise = torch.cat([noise, noise.new_zeros((n_pad, *noise.shape[1:]))])
        if self._shards is None:
            out, states = self._step(frames_u8, states, noise)
        else:
            per = self.pad_to // len(self._shards)
            outs, new = [], []
            for k, ((d, step), state) in enumerate(zip(self._shards, states)):
                rows = slice(k * per, (k + 1) * per)
                o, st = step(frames_u8[rows].to(d, non_blocking=True), state,
                             None if noise is None else noise[rows].to(d, non_blocking=True))
                outs.append(o)
                new.append(st)
            out, states = concat_outputs(outs, self.device), tuple(new)
        if n_pad:
            out = {k: v[:self.n_streams] for k, v in out.items()}
        return out, states


class FleetLongitudinalPipeline:
    """AutoSpeed detection over ``n_streams`` cameras, one tick a call.

    The single-stream device step is stateless (tracking lives on the
    host), so the fleet step is the batched step: (N, H, W, 3) -> (N,
    max_det, 7) packed detection tables. Over a ``mesh`` the streams split
    in equal shards over its data devices, a replica of the network on
    each, and the tables come back in stream order on the first device.
    """

    def __init__(self, net, cfg: Config, n_streams: int, frame_hw=(720, 1280),
                 input_hw=(640, 640), dtype=torch.bfloat16, max_det: int = 64, mesh=None):
        self.n_streams = n_streams

        def step_on(net):
            return build_batched_longitudinal_step(net, cfg, frame_hw=frame_hw,
                                                   input_hw=input_hw, dtype=dtype,
                                                   max_det=max_det)

        if mesh is None:
            self._step, self._shards = step_on(net), None
        else:
            devices = mesh_shards(mesh, n_streams)
            steps = {d: step_on(m) for d, m in replicas_on(net, devices).items()}
            self._shards = [(d, steps[d]) for d in devices]

    def __call__(self, frames_u8):
        if self._shards is None:
            return self._step(frames_u8)
        per = self.n_streams // len(self._shards)
        return concat_outputs([step(frames_u8[k * per:(k + 1) * per].to(d, non_blocking=True))
                               for k, (d, step) in enumerate(self._shards)],
                              self._shards[0][0])


def unpack_fleet_scalars(scalars) -> list[dict]:
    """(N, 8) host array or tensor -> list of per-stream {field: float}
    dicts."""
    arr = np.asarray(scalars)
    return [dict(zip(SCALAR_FIELDS, map(float, row))) for row in arr]


class FleetEngine:
    """Host orchestration for N streams: one device tick per frame-set.

    The fleet analog of `PipelineEngine`, with its staging: each tick
    uploads the (N, H, W, 3) frames through a pinned ring, dispatches the
    lateral (and optional longitudinal) steps on all N streams, starts the
    copies of the (N, 8) scalars and (N, 64, 7) tables into pinned host
    slots and records an event; tick T-depth is harvested, waiting on its
    event only, while T executes. Host-side per-stream state machines
    (ObjectFinder tracking, RSS speed planning, longitudinal PID; one of
    each a stream) run on the harvested detections.

    frame_source: callable -> (N, H, W, 3) uint8 ndarray | None (None ends
    the run). sink: optional callable(tick_index, list[FrameResult]).
    ``device_ms`` holds each harvested tick's device time from its upload
    to its results on the host (CUDA events; empty on the CPU).
    """

    def __init__(self, cfg: Config, lateral: FleetLateralPipeline,
                 longitudinal: Optional[FleetLongitudinalPipeline],
                 object_finders: Optional[list] = None,
                 frame_source=None, sink=None):
        self.cfg = cfg
        self.lateral = lateral
        self.longitudinal = longitudinal
        self.n = lateral.n_streams
        self.object_finders = object_finders
        self.frame_source = frame_source
        self.sink = sink
        self.device = lateral.device
        self.device_ms = []
        lon = cfg.longitudinal
        self.speed_planners = [
            SpeedPlanner(ego_speed=lon.ego_speed_default_ms,
                         is_cipo_present=False) for _ in range(self.n)]
        self.pids = [PIController(lon.pid_Kp, lon.pid_Ki, lon.pid_Kd)
                     for _ in range(self.n)]

    def _harvest(self, tick, frames, lat_out, scalars, tables=None, done=None, started=None):
        """``scalars`` (N, 8) and ``tables`` (N, max_det, 7): the host copies
        of the tick's results, readable once ``done`` has completed."""
        if done is not None:
            done.synchronize()
            if started is not None:
                self.device_ms.append(started.elapsed_time(done))
        results = []
        tables = np.asarray(tables) if tables is not None else None
        per_stream = unpack_fleet_scalars(scalars)
        for i in range(self.n):
            res = FrameResult(frame_num=tick)
            s = per_stream[i]
            res.steering_deg = s["steering_filtered"]
            res.cte = s["cte"]
            res.yaw_error = s["yaw_error"]
            # lane departure from the fetched scalars — same contract as
            # PipelineEngine._harvest (main.cpp unified-display warning)
            res.lane_departure = lane_departure(s)
            if tables is not None and self.object_finders is not None:
                trk = self.object_finders[i].update_and_get_cipo(
                    detections(tables[i]), frames[i])
                sp = self.speed_planners[i]
                sp.set_ego_speed(self.cfg.longitudinal.ego_speed_default_ms)
                sp.set_is_cipo_present(trk.cipo.exists)
                if trk.cipo.exists:
                    sp.set_cipo_state(trk.cipo.velocity_ms,
                                      trk.cipo.distance_m)
                    res.cipo_distance = trk.cipo.distance_m
                    res.cipo_velocity = trk.cipo.velocity_ms
                res.set_speed = sp.calc_ideal_driving_speed()
                if trk.cut_in_detected or trk.kalman_reset:
                    self.pids[i].reset()
                res.accel_effort = self.pids[i].compute_effort(
                    sp.ego_speed, res.set_speed)
                res.fcw = sp.get_fcw_state()
                res.aeb = sp.get_aeb_state()
                res.cut_in = trk.cut_in_detected
                res.kalman_reset = trk.kalman_reset
                res.n_tracks = len(trk.tracked_objects)
            results.append(res)
        if self.sink is not None:
            self.sink(tick, results)
        return results

    def run(self, max_ticks: Optional[int] = None, pipeline_depth: int = 1,
            sync_check: bool = False):
        """``sync_check`` runs each tick's dispatch under sync-debug
        "error", as PipelineEngine.run does."""
        states = self.lateral.init_states()
        depth = max(1, int(pipeline_depth))
        staging = DeviceStaging(depth + 1, self.device)
        pending = deque()
        all_results = []
        tick = 0
        while max_ticks is None or tick < max_ticks:
            frames = self.frame_source()
            if frames is None:
                break
            with _sync_debug(sync_check):
                started = staging.mark()
                dev = staging.upload(frames, tick)
                lat_out, states = self.lateral(dev, states)
                outs = [lat_out["scalars"]]
                if self.longitudinal is not None:
                    outs.append(self.longitudinal(dev))
                host, done = staging.download(tick, *outs)
            pending.append((tick, frames, lat_out, host[0],
                            host[1] if len(host) > 1 else None, done, started))
            if len(pending) > depth:
                all_results.append(self._harvest(*pending.popleft()))
            tick += 1
        while pending:
            all_results.append(self._harvest(*pending.popleft()))
        return all_results
