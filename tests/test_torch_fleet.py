"""The port's fleet serving (runtime/fleet.py and the batched steps of
runtime/pipeline.py) against the JAX package's fleet (jax.vmap of its
steps), and against the port's own single-stream steps, on the CPU in f32
at the geometry of tests/test_fleet_fast.py (120x200 frames, crop 20,
EgoLanes at dryrun depth on 96x192, 24x48 masks; AutoSpeed at 128x128 on
180x320 frames).

The networks' outputs are forced on both sides, so that the rest of each
step gets the same input: in the JAX fleet a stand-in network returns, for
each stream and tick, the logits (or pred) that a uniform patch in the
corner of that stream's frame names (the stand-in reads the patch back from
its input; under ``jax.vmap`` it cannot see the stream otherwise); in the
port forward hooks return the same arrays, and PathFinder takes the JAX
streams' noise. Tolerances, and why:
- against JAX's fleet: the lateral step as tests/test_torch_lateral.py
  holds the single-stream step (``assert_step_matches``): flags, AutoSteer's
  angle and the masks exactly, lane fits at FIT_TOL, PathFinder's and the
  controller's scalars within twice JAX's own spread (its jitted fleet
  against its single-stream step run op by op from the same per-stream
  states) plus STEP_TOL; the longitudinal tables as the single-stream test
  holds them against JAX's jitted step: boxes within 2 ulps (XLA multiplies
  by 1 / scale where the port divides), the rest equal;
- stream independence (the streams permuted), padding, and the plain
  batched walk and NMS against per-stream calls: bit for bit;
- the batched step against the port's single-stream step: as against JAX's
  fleet (the fits' small matrix products take another summation order at
  another batch size; test_batched_lateral_step_matches_jax_fleet).
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from autoware_vision_pilot_tpu.models.auto_steer_temporal import AutoSteerTemporalNet as JSteer
from autoware_vision_pilot_tpu.runtime import config as jconfig
from autoware_vision_pilot_tpu.runtime import fleet as jfleet
from autoware_vision_pilot_tpu.runtime import pipeline as jpipe

from autoware_vision_pilot_tpu_torch.models.auto_steer_temporal import AutoSteerTemporalNet
from autoware_vision_pilot_tpu_torch.models.efficientnet import B0_DRYRUN_STAGES
from autoware_vision_pilot_tpu_torch.ops.postprocess import nms_greedy_plain, nms_topk
from autoware_vision_pilot_tpu_torch.perception.lane_filter import lane_filter_walk_plain
from autoware_vision_pilot_tpu_torch.perception.tracking import ObjectFinder
from autoware_vision_pilot_tpu_torch.runtime import fleet as tfleet
from autoware_vision_pilot_tpu_torch.runtime.config import Config
from autoware_vision_pilot_tpu_torch.runtime.pipeline import (
    SCALAR_FIELDS, build_lateral_pipeline, build_longitudinal_pipeline, stream_generators)

from test_torch_lateral import (CROP_Y, FRAME_HW, MASK_HW, NET_HW, SYNTHETIC, GivenLogits,
                                assert_step_matches, jax_noise, lane_logits, n, random_masks, t)
from test_torch_layers import port_with, seeded_variables
from test_torch_train_step import one_thread  # noqa: F401 (an autouse fixture)

N, TICKS = 3, 3
PATCH = 20  # the corner patch that names the stream and tick
LON_FRAME_HW, LON_INPUT_HW, MAX_DET = (180, 320), (128, 128), 64


def patched_frames(hw, first_row, seed):
    """(TICKS, N, H, W, 3) uint8 random frames whose PATCH x PATCH corner
    at ``first_row`` is uniform 10 * (N * tick + stream) + 5."""
    f = np.random.default_rng(seed).integers(0, 256, (TICKS, N, *hw, 3), np.uint8)
    for tick in range(TICKS):
        for s in range(N):
            f[tick, s, first_row:first_row + PATCH, :PATCH] = 10 * (N * tick + s) + 5
    return f


class LogitsByPatch:
    """A stand-in for EgoLanes in the JAX step: the lane logits that the
    corner patch of its (ImageNet-normalised) input names."""

    def apply(self, logits, x):
        v = jnp.round((x[0, 2, 2, 0] * 0.229 + 0.485) * 255.0)
        return logits[(v / 10).astype(jnp.int32)]


class PredByPatch:
    """A stand-in for AutoSpeed in the JAX step: the pred that the corner
    patch of its letterboxed input ([0, 1], pad_y 28) names."""

    def __init__(self, **kwargs):
        pass

    def apply(self, preds, x):
        v = jnp.round(x[0, 30, 2, 0] * 255.0)
        return preds[(v / 10).astype(jnp.int32)]


def synthetic_logits():
    """(TICKS * N, 1, 24, 48, 3): stream s at tick t takes the synthetic
    lanes SYNTHETIC[(t + 2 s) % 5], shifted 2 s columns."""
    out = []
    for tick in range(TICKS):
        for s in range(N):
            left, right = SYNTHETIC[(tick + 2 * s) % len(SYNTHETIC)]
            shift = lambda f, s=s: None if f is None else (lambda y: f(y) + 2 * s)  # noqa: E731
            out.append(lane_logits(shift(left), shift(right)))
    return np.stack(out)


@pytest.fixture(scope="module")
def steer():
    jnet = JSteer(precision=lax.Precision.HIGHEST)
    v = seeded_variables(jnet, jax.ShapeDtypeStruct((1, *MASK_HW, 6), jnp.float32), seed=30)
    return jnet, v, port_with(AutoSteerTemporalNet(MASK_HW), v)


@pytest.fixture(scope="module")
def port_lateral(steer):
    pipe = build_lateral_pipeline("cpu", torch.float32, frame_hw=FRAME_HW, crop_y=CROP_Y,
                                  net_hw=NET_HW, backbone_stages=B0_DRYRUN_STAGES)
    pipe.steer_net.load_state_dict(steer[2].state_dict())
    return pipe


@pytest.fixture(scope="module")
def jax_fleet_run(steer):
    """The JAX fleet (FleetLateralPipeline, jitted) over TICKS ticks of N
    streams with LogitsByPatch, and per stream JAX's single-stream step run
    op by op from the same initial state with the same logits. -> frames,
    the logits, [(JAX fleet outputs, (its previous logits, its streams' keys)
    before the tick, its states after, the op-by-op outputs (N of them))] a
    tick."""
    _, sv, _ = steer
    logits = synthetic_logits()
    frames = patched_frames(FRAME_HW, CROP_Y, seed=50)
    cfg = jconfig.Config()
    kw = dict(frame_hw=FRAME_HW, crop_y=CROP_Y, dtype=jnp.float32, net_hw=NET_HW)
    fleet = jfleet.FleetLateralPipeline(jnp.asarray(logits), sv, cfg, N,
                                        lanes_net=LogitsByPatch(), **kw)
    states = fleet.init_states(seed=0)
    own = [jax.tree.map(lambda x, i=i: x[i], states) for i in range(N)]
    ticks = []
    for tick in range(TICKS):
        # the fleet donates its states: keep what the port needs of them
        before = (np.asarray(states.prev_lane_raw), [states.key[s] for s in range(N)])
        out, new = fleet(jnp.asarray(frames[tick]), states)
        eager = []
        for s in range(N):
            step = jpipe.build_lateral_step(jnp.asarray(logits[N * tick + s]), sv, cfg,
                                            lanes_net=GivenLogits(), **kw)
            o, own[s] = step(jnp.asarray(frames[tick, s]), own[s])
            eager.append(o)
        kept = jax.tree.map(lambda x: None if jnp.issubdtype(x.dtype, jax.dtypes.prng_key)
                            else np.asarray(x), new)
        ticks.append((out, before, kept, eager))
        states = new
    return frames, logits, ticks


def hooked(pipe_nets, forced):
    lanes, steer_net = pipe_nets
    return [lanes.register_forward_hook(lambda m, a, y: forced["lanes"]),
            steer_net.register_forward_hook(lambda m, a, y: forced["steer"])]


def jax_inputs(steer, logits, ticks, tick):
    """The tick's logits (N, 24, 48, 3), JAX's AutoSteer outputs on them
    and the streams' noise (N, 14)."""
    jsteer_net, sv, _ = steer
    _, (prev_raw, keys), _, _ = ticks[tick]
    cur = logits[N * tick:N * tick + N, 0]
    stacked = np.concatenate([prev_raw, cur], -1)
    prev, curr = jsteer_net.apply(sv, jnp.asarray(stacked))
    noise = np.stack([jax_noise(k)[1] for k in keys])
    return cur, (t(np.asarray(prev)), t(np.asarray(curr))), noise


def _spread_from(eager, jitted, ref):
    """Outputs whose scalars sit as far from ``ref``'s as JAX's op-by-op
    step's sit from its jitted fleet's: assert_step_matches, given them as
    its op-by-op run, then allows the port's batched step twice JAX's own
    spread around the single-stream step's scalars."""
    spread = np.abs(np.asarray(eager["scalars"], np.float64) -
                    np.asarray(jitted["scalars"], np.float64))
    return {"scalars": n(ref["scalars"]).astype(np.float64) + spread}


def test_batched_lateral_step_matches_jax_fleet(jax_fleet_run, steer, port_lateral):
    """FleetLateralPipeline at N = 3 against the JAX package's, 3 ticks,
    the states carried on both sides; and each stream of it against the
    port's single-stream step on that stream alone, its state carried too.
    Against the single-stream step, not bit for bit: the masks, flags and
    AutoSteer's angle are equal, but the normal equations' small matrix
    products (the lane filter's, the tracker's and PathFinder's fits) go to
    the CPU's batched GEMM, whose summation order depends on the batch, so
    the fits are held at FIT_TOL and PathFinder's scalars to the bar of
    assert_step_matches, built from JAX's own spread."""
    frames, logits, ticks = jax_fleet_run
    fleet = tfleet.FleetLateralPipeline(port_lateral.lanes, port_lateral.steer_net, Config(),
                                        N, frame_hw=FRAME_HW, crop_y=CROP_Y,
                                        dtype=torch.float32, net_hw=NET_HW)
    forced = {}
    hooks = hooked((port_lateral.lanes, port_lateral.steer_net), forced)
    states = fleet.init_states(0)
    singles = [port_lateral.init_state(0) for _ in range(N)]
    try:
        for tick in range(TICKS):
            cur, (prev, curr), noise = jax_inputs(steer, logits, ticks, tick)
            forced["lanes"] = t(cur).permute(0, 3, 1, 2)
            forced["steer"] = (prev, curr)
            out, states = fleet(t(frames[tick]), states, noise=t(noise))
            jout, _, jnew, eager = ticks[tick]
            assert out["scalars"].shape == (N, 8) and out["coeffs"].shape == (N, 3, 6)
            assert out["lane_masks"].shape == (N, *MASK_HW, 3)
            for s in range(N):
                pick = lambda tree, s=s: jax.tree.map(lambda x: x[s], tree)  # noqa: E731
                port_s = {k: v[s] for k, v in out.items()}
                port_state = jax.tree.map(lambda x, s=s: x[s] if isinstance(x, torch.Tensor)
                                          else x, states)
                assert_step_matches([(port_s, pick(jout), eager[s], port_state, pick(jnew))])
                # the port's single-stream step on this stream alone
                forced["lanes"] = t(cur[s:s + 1]).permute(0, 3, 1, 2)
                forced["steer"] = (prev[s:s + 1], curr[s:s + 1])
                one, singles[s] = port_lateral(t(frames[tick, s]), singles[s],
                                               noise=t(noise[s]))
                assert_step_matches([(port_s, one, _spread_from(eager[s], pick(jout), one),
                                      port_state, singles[s])])
    finally:
        for h in hooks:
            h.remove()


def test_streams_are_independent_and_padding_changes_nothing(port_lateral):
    """The real networks (no hooks), 3 ticks: permuting the streams' frames
    and states permutes every output and nothing else, and a fleet padded
    to 5 streams gives the unpadded fleet's outputs, bit for bit; every
    stream's PathFinder generator is its own (stream_generators)."""
    frames = np.random.default_rng(51).integers(0, 256, (TICKS, N, *FRAME_HW, 3), np.uint8)
    perm = [2, 0, 1]
    kw = dict(frame_hw=FRAME_HW, crop_y=CROP_Y, dtype=torch.float32, net_hw=NET_HW)
    nets = (port_lateral.lanes, port_lateral.steer_net)
    plain = tfleet.FleetLateralPipeline(*nets, Config(), N, **kw)
    padded = tfleet.FleetLateralPipeline(*nets, Config(), N, pad_to=5, **kw)
    sa, sp = plain.init_states(7), padded.init_states(7)
    sb = plain.init_states(7)
    gens = stream_generators(N, 7, "cpu")
    sb = sb._replace(generator=tuple(gens[i] for i in perm),
                     **{f: jax.tree.map(lambda x: x[perm], getattr(sb, f))
                        for f in sb._fields if f != "generator"})
    for tick in range(TICKS):
        oa, sa = plain(t(frames[tick]), sa)
        ob, sb = plain(t(frames[tick][perm]), sb)
        op, sp = padded(t(frames[tick]), sp)
        for k in oa:
            assert torch.equal(ob[k], oa[k][perm]), (tick, k)
            assert op[k].shape == oa[k].shape and torch.equal(op[k], oa[k]), (tick, k)
        assert torch.isfinite(oa["scalars"][:, [2, 6, 7]]).all()
    assert len(sp.generator) == 5 and sp.prev_lane_raw.shape[0] == 5
    draws = [torch.rand(4, generator=g) for g in stream_generators(N, 7, "cpu")]
    assert not torch.equal(draws[0], draws[1])
    assert torch.equal(torch.rand(4, generator=stream_generators(1, 7, "cpu")[0]), draws[0])


def synthetic_preds(seed):
    """(TICKS * N, 1, A, 8) AutoSpeed outputs at 128x128 (A = 336 anchors):
    xywh in letterbox pixels, 4 class scores with ties and saturation."""
    rng = np.random.default_rng(seed)
    A = 16 * 16 + 8 * 8 + 4 * 4
    xy = rng.uniform(0, 128, (TICKS * N, 1, A, 2))
    wh = rng.uniform(2, 60, (TICKS * N, 1, A, 2))
    scores = rng.choice([0.2, 0.55, 0.7, 0.9, 1.0], (TICKS * N, 1, A, 4))
    scores = np.where(rng.random(scores.shape) < 0.5, rng.uniform(0, 1, scores.shape), scores)
    return np.concatenate([xy, wh, scores], -1).astype(np.float32)


def test_batched_longitudinal_step_matches_jax_fleet(monkeypatch):
    """FleetLongitudinalPipeline at N = 3 against the JAX package's (jitted),
    the networks' preds forced, 3 ticks; each stream's table also equals
    the port's single-stream step on it alone."""
    preds = synthetic_preds(52)
    frames = patched_frames(LON_FRAME_HW, 0, seed=53)
    monkeypatch.setattr(jpipe, "AutoSpeedNetwork", PredByPatch)
    jf = jfleet.FleetLongitudinalPipeline(jnp.asarray(preds), jconfig.Config(), N,
                                          frame_hw=LON_FRAME_HW, input_hw=LON_INPUT_HW,
                                          dtype=jnp.float32, max_det=MAX_DET)
    pipe = build_longitudinal_pipeline("cpu", torch.float32, frame_hw=LON_FRAME_HW,
                                       input_hw=LON_INPUT_HW, max_det=MAX_DET)
    fleet = tfleet.FleetLongitudinalPipeline(pipe.net, Config(), N, frame_hw=LON_FRAME_HW,
                                             input_hw=LON_INPUT_HW, dtype=torch.float32,
                                             max_det=MAX_DET)
    forced = {}
    hook = pipe.net.register_forward_hook(lambda m, a, y: forced["pred"])
    kept = []
    try:
        for tick in range(TICKS):
            ref = np.asarray(jf(jnp.asarray(frames[tick])))
            forced["pred"] = t(preds[N * tick:N * tick + N, 0])
            out = fleet(t(frames[tick])).numpy()
            assert out.shape == (N, MAX_DET, 7)
            np.testing.assert_array_equal(out[..., 4:], ref[..., 4:])
            np.testing.assert_allclose(out[..., :4], ref[..., :4], rtol=2.4e-7, atol=0)
            for s in range(N):
                forced["pred"] = t(preds[N * tick + s])
                np.testing.assert_array_equal(pipe(t(frames[tick, s])).numpy(), out[s])
            kept += [int(v) for v in out[..., 6].sum(-1)]
    finally:
        hook.remove()
    assert all(k > 0 for k in kept), kept


def test_plain_batched_walk_and_nms_equal_per_stream_calls():
    """The plain versions of the walk and NMS kernels on a batch of 5
    streams against 5 calls of one stream, bit for bit."""
    masks = np.stack([random_masks((80, 160), d, 60 + i)
                      for i, d in enumerate((0.03, 0.1, 0.3, 0.0, 0.6))])
    weights, starts = lane_filter_walk_plain(t(masks))
    for s in range(5):
        w1, s1 = lane_filter_walk_plain(t(masks[s]))
        assert torch.equal(weights[s], w1) and torch.equal(starts[s], s1), s
    assert weights[1].any() and not weights[3].any()
    rng = np.random.default_rng(61)
    boxes = rng.uniform(0, 600, (5, 900, 4)).astype(np.float32)
    boxes[..., 2:] += boxes[..., :2] * rng.uniform(0, 0.3, (5, 900, 2)).astype(np.float32)
    boxes[2, ::7] = np.nan
    scores = rng.uniform(0, 1, (5, 900)).astype(np.float32)
    scores[3] = np.round(scores[3] * 4) / 4  # ties
    cls = rng.integers(0, 4, (5, 900)).astype(np.int32)
    for aware in (True, False):
        top = nms_topk(t(boxes), t(scores), t(cls), max_det=MAX_DET, conf_thresh=0.5)
        out = nms_greedy_plain(*top, max_det=MAX_DET, iou_thresh=0.5, conf_thresh=0.5,
                               class_aware=aware)
        for s in range(5):
            one = nms_greedy_plain(*nms_topk(t(boxes[s]), t(scores[s]), t(cls[s]),
                                             max_det=MAX_DET, conf_thresh=0.5),
                                   max_det=MAX_DET, iou_thresh=0.5, conf_thresh=0.5,
                                   class_aware=aware)
            for a, b in zip(out, one):
                assert a.dtype == b.dtype and torch.equal(a[s].view(torch.uint8),
                                                          b.view(torch.uint8)), (aware, s)


def test_fleet_engine_runs_3_ticks(port_lateral):
    """FleetEngine over 3 ticks of 2 streams, depth 1 and 2: in-order ticks
    of 2 FrameResults each, equal between the depths, each stream with its
    own tracker, planner and PID."""
    pipe = build_longitudinal_pipeline("cpu", torch.float32, frame_hw=FRAME_HW,
                                       input_hw=LON_INPUT_HW, max_det=MAX_DET)
    frames = np.random.default_rng(54).integers(0, 256, (TICKS, 2, *FRAME_HW, 3), np.uint8)
    kw = dict(frame_hw=FRAME_HW, crop_y=CROP_Y, dtype=torch.float32, net_hw=NET_HW)
    runs = {}
    for depth in (1, 2):
        lat = tfleet.FleetLateralPipeline(port_lateral.lanes, port_lateral.steer_net,
                                          Config(), 2, **kw)
        lon = tfleet.FleetLongitudinalPipeline(pipe.net, Config(), 2, frame_hw=FRAME_HW,
                                               input_hw=LON_INPUT_HW, dtype=torch.float32)
        clocks = [iter(np.arange(100) * 0.1) for _ in range(2)]
        finders = [ObjectFinder(np.eye(3), FRAME_HW[1], FRAME_HW[0],
                                clock=lambda c=c: float(next(c))) for c in clocks]
        it = iter(frames)
        ticks = []
        eng = tfleet.FleetEngine(Config(), lat, lon, finders, frame_source=lambda: next(it, None),
                                 sink=lambda tick, res: ticks.append(tick))
        runs[depth] = eng.run(max_ticks=5, pipeline_depth=depth)
        assert ticks == [0, 1, 2] and len(runs[depth]) == TICKS
        assert all(len(r) == 2 and all(x.frame_num == i for x in r)
                   for i, r in enumerate(runs[depth]))
    for a, b in zip(runs[1], runs[2]):
        assert [dataclasses.asdict(x) for x in a] == [dataclasses.asdict(x) for x in b]


def test_fleet_harvest_matches_jax():
    """FleetEngine._harvest of both packages on the same (N, 8) scalars and
    (N, 64, 7) tables, 6 ticks of 2 streams: every FrameResult field."""
    from test_torch_tracking import HOMOGRAPHY, W, H, clock, images, packed_tables
    rng = np.random.default_rng(55)
    tabs = [packed_tables("cut-in", 8), packed_tables("crowd", 9)]
    imgs = images(16, 8)
    stub = types.SimpleNamespace(n_streams=2, device=torch.device("cpu"))
    jeng = jfleet.FleetEngine(jconfig.Config(), stub, None,
                              [jpipe.ObjectFinder(HOMOGRAPHY, W, H, clock=clock())
                               for _ in range(2)])
    teng = tfleet.FleetEngine(Config(), stub, None,
                              [ObjectFinder(HOMOGRAPHY, W, H, clock=clock()) for _ in range(2)])
    for tick in range(6):
        sc = rng.normal(0, 2, (2, 8)).astype(np.float32)
        sc[:, 6:] = rng.random((2, 2)) < 0.8
        tables = np.stack([tabs[0][tick], tabs[1][tick]])
        frames = np.stack([imgs[tick], imgs[tick + 1]])
        ref = jeng._harvest(tick, frames, {"scalars": sc}, tables)
        out = teng._harvest(tick, frames, {"scalars": t(sc)}, t(sc), t(tables))
        assert [dataclasses.asdict(x) for x in out] == [dataclasses.asdict(x) for x in ref]
    assert tfleet.unpack_fleet_scalars(t(sc)) == jfleet.unpack_fleet_scalars(sc)
    assert tfleet.SCALAR_FIELDS == jfleet.SCALAR_FIELDS == SCALAR_FIELDS
