"""The port's native-app export (export/native_app.py) and its C++ loop
(autoware_vision_pilot_tpu_torch/host/tools/visionpilot_app.cpp) on the
CPU: the state's wire format, a tiny stateful step (a port of
tests/test_native_app.py's, with a torch.Generator in place of the key)
through torch.export and AOTInductor, its golden probe and a state-carried
trajectory against the eager step, the loop built against the CPU libtorch
on that bundle, and the lateral step at the test geometry through
torch.export. The lateral and longitudinal bundles at full width, with the
avp operators inside, run on the card (chip_smoke.py phase 40c)."""
from __future__ import annotations

import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from autoware_vision_pilot_tpu_torch.export import native_app as na
from autoware_vision_pilot_tpu_torch.export.stablehlo_export import _Fn
from autoware_vision_pilot_tpu_torch.models.efficientnet import B0_DRYRUN_STAGES
from autoware_vision_pilot_tpu_torch.ops import preprocess as tpre
from autoware_vision_pilot_tpu_torch.perception import lane_tracker, path_finder
from autoware_vision_pilot_tpu_torch.perception.path_finder import STATE_DIM, noise_from_uniform
from autoware_vision_pilot_tpu_torch.runtime.pipeline import (build_lateral_pipeline,
                                                               init_lateral_state)

from test_torch_train_step import one_thread  # noqa: F401 (an autouse fixture)

FRAME_SHAPE = (8, 16, 3)
N_FRAMES = 4


def test_wire_round_trip_is_bit_exact():
    """Every leaf type a state holds crosses the f32 wire and back bit for
    bit: f32 (NaN payloads, -0, inf), bool, int32 and uint32 whose bits are
    f32 NaNs and denormals, int64 as two words."""
    f32 = torch.tensor([0.0, -0.0, 1.5, float("inf"), float("nan")])
    f32 = torch.cat([f32, torch.tensor([0x7FC00001, 0x7F800001, 1], dtype=torch.int32)
                     .view(torch.float32)])
    ints = torch.tensor([0, 1, -1, 2 ** 31 - 1, -2 ** 31, 0x7FC00001, 0x7F800001, 5],
                        dtype=torch.int32)
    leaves = [f32, f32.reshape(2, 4), torch.tensor(True), torch.tensor([True, False, True]),
              ints, ints[3], ints.view(torch.uint32),
              torch.tensor([0, -1, 2 ** 63 - 1, -2 ** 63, 0x7FC0000100000001], dtype=torch.int64),
              torch.zeros(())]
    state = init_lateral_state(device="cpu")
    leaves += [state.prev_lane_raw, *state.lane_filter, *state.lane_tracker, *state.bayes,
               *state.steering]
    for leaf in leaves:
        wire = na._to_wire(leaf)
        assert wire.dtype == torch.float32
        back = na._from_wire(wire, leaf)
        assert back.dtype == leaf.dtype and back.shape == leaf.shape
        if leaf.dtype == torch.float32:
            assert torch.equal(back.view(torch.int32), leaf.view(torch.int32))
        else:
            assert torch.equal(back, leaf)
    assert na._to_wire(torch.zeros((3, 2), dtype=torch.int64)).shape == (3, 2, 2)
    assert {t.dtype for t in leaves} >= {torch.float32, torch.bool, torch.int32,
                                          torch.uint32, torch.int64}


def tiny_step():
    """tests/test_native_app.py::_tiny_step in PyTorch: the state holds an
    f32 vector, an int32 counter, a bool flag and a generator, whose draw
    (the step's ``noise``) lands in the last scalar."""
    def step(frame_u8, state, noise=None):
        m = frame_u8.to(torch.float32).mean() / 255.0
        feat = frame_u8.to(torch.float32).mean((0, 1)) / 255.0
        ema = 0.9 * state["ema"] + 0.1 * torch.cat([feat, m[None]])
        count = state["count"] + 1
        valid = ema[0] > 0.05
        scalars = torch.cat([ema, count.to(torch.float32)[None], valid.to(torch.float32)[None],
                             m[None], noise[:1] * 1e5])
        coeffs = ema[:3, None] * torch.arange(6, dtype=torch.float32)[None]
        return {"scalars": scalars, "coeffs": coeffs}, {
            "ema": ema, "count": count, "valid": valid, "key": state["key"]}

    init = {"ema": torch.zeros(4), "count": torch.zeros((), dtype=torch.int32),
            "valid": torch.zeros((), dtype=torch.bool), "key": torch.Generator().manual_seed(7)}
    return step, init


def eager_trajectory(frames):
    """The tiny step eagerly over ``frames``, each frame's noise drawn from
    the generator as PathFinder draws it. -> out_0 of each frame."""
    step, state = tiny_step()
    gen, out = state["key"], []
    for f in frames:
        o, state = step(torch.from_numpy(f), state,
                        noise=noise_from_uniform(torch.rand(STATE_DIM, generator=gen)))
        out.append(o["scalars"].numpy())
    return out


def tiny_detector():
    """tests/test_native_app.py::_tiny_detector in PyTorch: a stateless step
    whose one class-1 box moves with the frame's mean, in the NMS table's
    (max_det, 7) layout [x1, y1, x2, y2, score, class, valid]."""
    def step(frame_u8, state):
        m = frame_u8.to(torch.float32).mean() / 255.0
        x1, y1 = 2.0 + 4.0 * m, 1.0 + 3.0 * m
        row = torch.stack([x1, y1, x1 + 6.0, y1 + 4.0, *torch.tensor([0.9, 1.0, 1.0])])
        return {"dets": torch.cat([row[None], torch.zeros((3, 7))])}, state

    return step


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    out = tmp_path_factory.mktemp("bundle")
    step, init = tiny_step()
    man = na.export_native_app(step, init, FRAME_SHAPE, out, name="tiny", device="cpu")
    na.export_native_app(tiny_detector(), (), FRAME_SHAPE, out, name="tinylon", device="cpu",
                         outputs_from=lambda o: [o["dets"]])
    stack = np.random.default_rng(3).integers(0, 256, (N_FRAMES, *FRAME_SHAPE), dtype=np.uint8)
    np.save(out / "stack.npy", stack)
    return out, man, stack


def test_manifest_and_state_files(bundle):
    out, man, _ = bundle
    assert man.read_text().splitlines() == [
        "package tiny.pt2", "device cpu", "frame 8 16 3", f"noise {STATE_DIM}", "n_state 3",
        "n_out 2", "out 0 1 8", "out 1 2 3 6"]
    # the state as the wire holds it: ema, count (bitcast), valid; the
    # generator's bytes beside it
    assert [np.load(out / f"tiny_state_{i}.npy").shape for i in range(3)] == [(4,), (), ()]
    assert np.load(out / "tiny_rng.npy").dtype == np.uint8
    assert "noise 0" in (out / "tinylon_manifest.txt").read_text()
    assert not (out / "tinylon_rng.npy").exists()


def test_golden_probe_and_trajectory_equal_eager(bundle):
    """The package's golden probe and a state-carried trajectory (probe,
    then N_FRAMES frames, the generator drawn once a frame) against the
    eager step: the count exact, the rest within 1e-5 (the compiled
    reductions may add in another order)."""
    out, _, stack = bundle
    probe = np.load(out / "tiny_probe_frame.npy")
    ref = eager_trajectory([probe, *stack])
    np.testing.assert_allclose(np.load(out / "tiny_probe_scalars.npy"), ref[0], rtol=1e-5,
                               atol=1e-6)
    got = na.replay_native_app(out, "tiny", list(stack))
    assert len(got) == N_FRAMES + 1
    assert [g[4] for g in got] == [r[4] for r in ref] == list(range(1, N_FRAMES + 2))
    np.testing.assert_allclose(np.stack(got), np.stack(ref), rtol=1e-5, atol=1e-6)


@pytest.mark.skipif(shutil.which("g++") is None, reason="g++ builds the C++ loop")
def test_cpp_loop_on_the_tiny_bundle(bundle, tmp_path):
    """The port's C++ loop, built against the CPU libtorch, runs the golden
    probe and N_FRAMES state-carried frames, the detector bundle beside it
    (--lon: its table through the native ObjectFinder, RSS and PI): its
    final scalars equal the Python replay of the same package (the count
    exact, as tests/test_native_app.py holds the JAX loop)."""
    out, _, stack = bundle
    app = na.build_app()
    dump = tmp_path / "final.npy"
    r = subprocess.run([str(app), str(out), "tiny", "--frames", str(out / "stack.npy"),
                        "--golden", "--max-frames", str(N_FRAMES), "--lon", "tinylon",
                        "--ego-speed", "12.5", "--state-shm",
                        f"/avp_torch_nativeapp_{os.getpid()}", "--dump", str(dump)],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, f"stdout={r.stdout}\nstderr={r.stderr}"
    assert "golden probe: max|diff|=" in r.stderr  # within 2e-3, or the loop exits 1
    assert f"{N_FRAMES + 1} frames" in r.stdout and "+longitudinal" in r.stderr
    final_cpp = np.load(dump)
    final_py = na.replay_native_app(out, "tiny", list(stack))[-1]
    assert final_cpp[4] == N_FRAMES + 1
    np.testing.assert_allclose(final_cpp, final_py, rtol=1e-4, atol=1e-4)


def clear_table_caches():
    for cached in (tpre.device_taps, tpre.device_mean_std, lane_tracker._on,
                   lane_tracker.homographies, path_finder._meas_var):
        cached.cache_clear()


@pytest.fixture(scope="module")
def lateral():
    """The lateral step at the test geometry, its table caches emptied, then
    wired (na.wire_step, which fills them by one eager call) and exported
    with torch.export. -> (wired step, exported program, example inputs,
    the eager outputs before the export)."""
    pipe = build_lateral_pipeline("cpu", torch.float32, frame_hw=(120, 200), crop_y=20,
                                  net_hw=(96, 192), backbone_stages=B0_DRYRUN_STAGES)
    fn, example, _, _ = na.wire_step(pipe._step, pipe.init_state(0), (120, 200, 3),
                                     lambda out: [out["scalars"], out["coeffs"]], "cpu")
    with torch.no_grad():
        before = fn(*example)
    clear_table_caches()
    fn, example, _, _ = na.wire_step(pipe._step, pipe.init_state(0), (120, 200, 3),
                                     lambda out: [out["scalars"], out["coeffs"]], "cpu")
    return fn, torch.export.export(_Fn(fn), example), example, before


def test_lateral_step_export_is_bit_equal_to_eager(lateral):
    """The exported lateral step's module against the eager step over three
    seeded frames with the state fed back and the same draws: every output
    bit-equal."""
    fn, ep, example, _ = lateral
    prog = ep.module()
    n_state = len(example) - 2
    gen = torch.Generator().manual_seed(11)
    state = list(example[2:])
    rng = np.random.default_rng(12)
    for _ in range(3):
        frame = torch.from_numpy(rng.integers(0, 256, (120, 200, 3), dtype=np.uint8))
        u = torch.rand(STATE_DIM, generator=gen)
        with torch.no_grad():
            got, ref = prog(frame, u, *state), fn(frame, u, *state)
        assert len(got) == len(ref) == 2 + n_state
        for a, b in zip(got, ref):
            assert a.dtype == b.dtype and torch.equal(a, b)
        state = list(ref[2:])


def test_export_leaves_the_table_caches_real(lateral):
    """The per-device table caches that the trace read were filled by an
    eager call first: they hold real tensors, and an eager step after the
    export gives what it gave before."""
    fn, _, example, before = lateral
    for t in (*tpre.device_taps(100, 96, torch.device("cpu")),
              *tpre.device_mean_std(torch.device("cpu")),
              *lane_tracker.homographies(torch.device("cpu")),
              path_finder._meas_var(torch.device("cpu"))):
        assert type(t) is torch.Tensor
    with torch.no_grad():
        after = fn(*example)
    assert all(torch.equal(a, b) for a, b in zip(after, before))
