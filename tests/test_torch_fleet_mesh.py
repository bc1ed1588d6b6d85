"""The port's fleet over a local mesh (autoware_vision_pilot_tpu_torch/
runtime/fleet.py with ``mesh``: the stream axis split over the mesh's
devices, a replica of the networks and a batched step a shard) against
the port's unsharded fleet, on the CPU at the geometry of
tests/test_torch_fleet.py (EgoLanes at dryrun depth on 96x192 from
120x200 frames, crop 20; AutoSpeed at 128x128), N = 4 streams over a mesh
of two CPU devices.

EgoLanes' logits are forced (a forward hook hands out each stream's
synthetic lanes of tests/test_torch_lateral.py in stream order, whichever
shard asks), so that the lane filter, tracker, PathFinder and the
steering see lanes; PathFinder draws from the streams' own generators.
The sharded fleet is held to the unsharded one bit for bit over 2 ticks,
the states carried (the fleet's own bar for a batch that changes size,
tests/test_torch_fleet.py::test_streams_are_independent_and_padding_
changes_nothing), and so are its detection tables and FleetEngine's
results. Its streams keep their seeds by global index, as the JAX fleet's
streams keep their keys over a mesh (tests/test_fleet.py::
test_fleet_sharded_over_mesh).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from autoware_vision_pilot_tpu.core.mesh import make_mesh as jax_mesh
from autoware_vision_pilot_tpu.runtime import config as jconfig
from autoware_vision_pilot_tpu.runtime import fleet as jfleet
from autoware_vision_pilot_tpu_torch.core.mesh import make_mesh
from autoware_vision_pilot_tpu_torch.models.efficientnet import B0_DRYRUN_STAGES
from autoware_vision_pilot_tpu_torch.perception.tracking import ObjectFinder
from autoware_vision_pilot_tpu_torch.runtime import fleet as tfleet
from autoware_vision_pilot_tpu_torch.runtime.config import Config
from autoware_vision_pilot_tpu_torch.runtime.pipeline import (build_lateral_pipeline,
                                                              build_longitudinal_pipeline,
                                                              stream_generators)

from test_torch_lateral import CROP_Y, FRAME_HW, NET_HW, SYNTHETIC, lane_logits
from test_torch_train_step import one_thread  # noqa: F401

N, TICKS, SEED = 4, 2, 7
LON_INPUT_HW = (128, 128)
KW = dict(frame_hw=FRAME_HW, crop_y=CROP_Y, dtype=torch.float32, net_hw=NET_HW)


@pytest.fixture(scope="module")
def nets():
    lat = build_lateral_pipeline("cpu", torch.float32, frame_hw=FRAME_HW, crop_y=CROP_Y,
                                 net_hw=NET_HW, backbone_stages=B0_DRYRUN_STAGES)
    lon = build_longitudinal_pipeline("cpu", torch.float32, frame_hw=FRAME_HW,
                                      input_hw=LON_INPUT_HW)
    return lat, lon


def two_devices():
    return make_mesh(devices=["cpu", "cpu"])


class LanesInOrder:
    """A forward hook for EgoLanes: each call gets the next rows of the
    synthetic logits (stream s at tick t: SYNTHETIC[(t + s) % 5] shifted 2 s
    columns), so a tick's shards take their streams in order."""

    def __init__(self, n):
        self.rows = [lane_logits(*[None if f is None else (lambda y, f=f, s=s: f(y) + 2 * s)
                                   for f in SYNTHETIC[(t + s) % len(SYNTHETIC)]])[0]
                     for t in range(TICKS) for s in range(n)]
        self.k = 0

    def __call__(self, module, args, y):
        n = y.shape[0]
        rows = np.stack(self.rows[self.k:self.k + n])
        self.k += n
        return torch.from_numpy(rows).permute(0, 3, 1, 2).to(y.device)


def frames(n, seed):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, 256, (TICKS, n, *FRAME_HW, 3), np.uint8))


def run_lateral(nets, mesh, n=N, pad_to=0):
    lat, _ = nets
    fleet = tfleet.FleetLateralPipeline(lat.lanes, lat.steer_net, Config(), n, mesh=mesh,
                                        pad_to=pad_to, **KW)
    handle = lat.lanes.register_forward_hook(LanesInOrder(fleet.pad_to))
    states, outs = fleet.init_states(SEED), []
    try:
        for tick in frames(n, 3):
            out, states = fleet(tick, states)
            outs.append(out)
    finally:
        handle.remove()
    return outs, states


def assert_equal_outputs(got, want):
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(torch.nan_to_num(a[k], 7.0), torch.nan_to_num(b[k], 7.0)), k


def test_fleet_over_two_devices_equals_the_unsharded_fleet(nets):
    want, want_states = run_lateral(nets, None)
    got, states = run_lateral(nets, two_devices())
    assert isinstance(states, tuple) and len(states) == 2
    assert [tuple(s.prev_lane_raw.shape) for s in states] == [(2, 24, 48, 3)] * 2
    assert_equal_outputs(got, want)
    # the lanes were seen: fused fits and valid paths on the last tick
    assert bool(torch.isfinite(want[-1]["coeffs"]).any())
    assert torch.equal(torch.cat([s.prev_lane_raw for s in states]), want_states.prev_lane_raw)


def test_padding_comes_before_the_split(nets):
    """3 streams padded to 4 split 2 + 2 (a one-device mesh is held to no
    mesh in tests/test_torch_runtime.py::test_fleet_refuses_a_mesh)."""
    want, _ = run_lateral(nets, None, n=3, pad_to=4)
    got, states = run_lateral(nets, two_devices(), n=3, pad_to=4)
    assert_equal_outputs(got, want)
    assert all(o["scalars"].shape == (3, 8) for o in got)
    with pytest.raises(ValueError, match="do not split"):
        tfleet.FleetLateralPipeline(nets[0].lanes, nets[0].steer_net, Config(), 3,
                                    mesh=two_devices(), **KW)


def test_stream_seeds_by_global_index_as_jax(nets):
    lat, _ = nets
    fleet = tfleet.FleetLateralPipeline(lat.lanes, lat.steer_net, Config(), N,
                                        mesh=two_devices(), **KW)
    seeds = [g.initial_seed() for shard in fleet.init_states(SEED) for g in shard.generator]
    assert seeds == [g.initial_seed() for g in stream_generators(N, SEED, "cpu")]
    assert len(set(seeds)) == N
    jmesh = jax_mesh((2,), devices=jax.devices()[:2])
    jf = jfleet.FleetLateralPipeline(None, None, jconfig.Config(), N, frame_hw=FRAME_HW,
                                     crop_y=CROP_Y, net_hw=NET_HW, mesh=jmesh, lanes_net=object())
    keys = jf.init_states(SEED).key
    assert len(keys.sharding.device_set) == 2
    np.testing.assert_array_equal(jax.random.key_data(keys), jax.random.key_data(
        jax.random.split(jax.random.key(SEED), N)))


def test_longitudinal_fleet_and_engine_over_two_devices(nets):
    lat, lon = nets
    fs = frames(N, 4)

    def engine(mesh):
        lat_fleet = tfleet.FleetLateralPipeline(lat.lanes, lat.steer_net, Config(), N,
                                                mesh=mesh, **KW)
        lon_fleet = tfleet.FleetLongitudinalPipeline(lon.net, Config(), N, frame_hw=FRAME_HW,
                                                     input_hw=LON_INPUT_HW,
                                                     dtype=torch.float32, mesh=mesh)
        clocks = [iter(np.arange(100) * 0.1) for _ in range(N)]
        finders = [ObjectFinder(np.eye(3), FRAME_HW[1], FRAME_HW[0],
                                clock=lambda c=c: float(next(c))) for c in clocks]
        it = iter(fs.numpy())
        results = tfleet.FleetEngine(Config(), lat_fleet, lon_fleet, finders,
                                     frame_source=lambda: next(it, None)).run(pipeline_depth=2)
        return lon_fleet(fs[0]), results

    want_tables, want = engine(None)
    got_tables, got = engine(two_devices())
    assert got_tables.shape == (N, 64, 7) and torch.equal(got_tables, want_tables)
    assert len(got) == TICKS and all(len(r) == N for r in got)
    assert [[dataclasses.asdict(x) for x in r] for r in got] == \
        [[dataclasses.asdict(x) for x in r] for r in want]
