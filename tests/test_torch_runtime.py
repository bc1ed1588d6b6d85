"""The port's serving runtime on the CPU: runtime/pipeline.py::PipelineEngine
(software pipelining, staging, the sinks), runtime/timers.py, the queues,
app.py (build_engine and main) and the rule that the port imports no JAX.

The engine runs at the geometry of tests/test_torch_lateral.py (120x200
frames, crop 20, EgoLanes at dryrun depth on 96x192) with AutoSpeed "n" at
a 128x128 input, weights from seeds, f32. Results are compared exactly:
the same frames through the same engine at another pipeline depth must
give the same FrameResults, since every host state machine runs on a fixed
clock and the lateral state restarts from the same seed. The JAX package's
own engine test at this size (tests/test_runtime.py::test_engine_smoke) is
marked slow; the parity of the pieces (the lateral and longitudinal steps,
tracking, planning, _harvest) is held by the other tests/test_torch_*.py.
"""
import csv
import dataclasses
import itertools
import os
import subprocess
import sys
import textwrap
import threading
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from autoware_vision_pilot_tpu import runtime as jrt
from autoware_vision_pilot_tpu.runtime import pipeline as jpipe

from autoware_vision_pilot_tpu_torch import runtime as trt
from autoware_vision_pilot_tpu_torch.models.efficientnet import B0_DRYRUN_STAGES
from autoware_vision_pilot_tpu_torch.perception.tracking import ObjectFinder
from autoware_vision_pilot_tpu_torch.runtime.config import Config
from autoware_vision_pilot_tpu_torch.runtime.pipeline import (
    PipelineEngine, build_lateral_pipeline, build_longitudinal_pipeline, sink_wants_frame)

from test_torch_train_step import one_thread  # noqa: F401 (an autouse fixture)

REPO = Path(__file__).resolve().parents[1]
FRAME_HW, CROP_Y, NET_HW, LON_HW = (120, 200), 20, (96, 192), (128, 128)


def fixed_clock():
    ticks = itertools.count()
    return lambda: 0.1 * next(ticks)


@pytest.fixture(scope="module")
def programs():
    cfg = Config()
    cfg.target_fps = 0.0  # unpaced
    lat = build_lateral_pipeline("cpu", torch.float32, seed=3, cfg=cfg, frame_hw=FRAME_HW,
                                 crop_y=CROP_Y, net_hw=NET_HW, backbone_stages=B0_DRYRUN_STAGES)
    lon = build_longitudinal_pipeline("cpu", torch.float32, seed=4, cfg=cfg, frame_hw=FRAME_HW,
                                      input_hw=LON_HW)
    return cfg, lat, lon


def engine(programs, frames, **kw):
    cfg, lat, lon = programs
    it = iter(frames)
    finder = ObjectFinder(np.eye(3), FRAME_HW[1], FRAME_HW[0], clock=fixed_clock())
    return PipelineEngine(cfg, lat, lon, finder, frame_source=lambda: next(it, None), **kw)


def distinct_frames(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (*FRAME_HW, 3), dtype=np.uint8) for _ in range(n)]


def test_engine_runs_in_order_at_every_depth(programs):
    """4 frames at pipeline depth 1 and 3: 4 results in frame order, finite,
    and equal field by field between the depths."""
    frames = distinct_frames(4, seed=10)
    runs = {}
    for depth in (1, 3):
        eng = engine(programs, frames)
        runs[depth] = eng.run(max_frames=4, pipeline_depth=depth)
        assert [r.frame_num for r in runs[depth]] == [0, 1, 2, 3]
        assert eng.metrics.frames == 4 and eng.device_ms == []  # no CUDA events on the CPU
    for a, b in zip(runs[1], runs[3]):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    for r in runs[1]:
        assert all(np.isfinite([r.steering_deg, r.cte, r.yaw_error, r.set_speed,
                                r.accel_effort, r.safe_distance]))


def test_engine_matches_the_steps_it_drives(programs):
    """Each FrameResult's lateral fields are the packed scalars of the
    lateral step run by hand on the same frames, state carried; the frame
    source may hand (host, device) pairs; max_frames stops the run."""
    _, lat, _ = programs
    frames = distinct_frames(3, seed=11)
    eng = engine(programs, [(f, torch.from_numpy(f)) for f in frames])
    results = eng.run(max_frames=2, pipeline_depth=2)
    assert len(results) == 2
    state = lat.init_state()
    for f, r in zip(frames, results):
        out, state = lat(torch.from_numpy(f), state)
        sc = out["scalars"].numpy()
        assert (r.steering_deg, r.cte, r.yaw_error) == (float(sc[0]), float(sc[3]),
                                                        float(sc[4]))


def test_engine_sinks(programs):
    """A 4-argument sink also receives the host frame, as the JAX engine's
    does (tests/test_runtime.py::test_engine_smoke); a 3-argument sink the
    FrameResult, the lateral outputs and the tracking result."""
    frames = distinct_frames(2, seed=12)
    seen4, seen3 = [], []
    engine(programs, frames, sink=lambda res, lat_out, trk, frame: seen4.append(frame)).run(
        max_frames=1)
    assert len(seen4) == 1 and seen4[0] is frames[0]
    engine(programs, frames, sink=lambda res, lat_out, trk: seen3.append((res, lat_out, trk))) \
        .run()
    assert [r.frame_num for r, _, _ in seen3] == [0, 1]
    res, lat_out, trk = seen3[-1]
    assert lat_out["scalars"].shape == (8,) and lat_out["lane_masks"].shape == (24, 48, 3)
    assert trk is not None and res.n_tracks == len(trk.tracked_objects)


def test_engine_hands_host_outputs_to_the_sink(programs):
    """A sink's lateral outputs hold the frame's lane masks and scalars as
    the staged host copies, equal to the lateral step's outputs run by hand
    with the state carried."""
    _, lat, _ = programs
    frames = distinct_frames(3, seed=15)
    seen = []
    engine(programs, frames, sink=lambda res, lat_out, trk: seen.append(
        {k: lat_out[k].clone() for k in ("scalars", "lane_masks", "coeffs")})) \
        .run(pipeline_depth=2)
    state = lat.init_state()
    assert len(seen) == 3
    for f, got in zip(frames, seen):
        out, state = lat(torch.from_numpy(f), state)
        for k in got:
            torch.testing.assert_close(got[k], out[k], rtol=0, atol=0, equal_nan=True, msg=k)


def test_sink_wants_frame_matches_jax():
    sinks = [None, lambda r, lo, trk: None, lambda r, lo, trk, frame: None,
             lambda r, lo, trk, frame=None: None, lambda r, lo, trk, **kw: None,
             lambda *args: None, print]
    assert [sink_wants_frame(s) for s in sinks] == [jpipe.sink_wants_frame(s) for s in sinks]


def test_queues_and_timers_match_jax(capsys):
    for mod in (jrt, trt):
        q = mod.ThreadSafeQueue(max_size=2)
        for i in range(5):
            q.push(i)
        assert (q.pop(), q.pop(), q.pop(timeout=0.01)) == (3, 4, None)
        buf = mod.DoubleFrameBuffer()
        got = []
        t = threading.Thread(target=lambda: got.append(buf.wait_for_new_frame(timeout=2.0)))
        t.start()
        time.sleep(0.05)
        buf.write("frame1", 1)
        t.join()
        assert got == [("frame1", 1)] and buf.wait_for_new_frame(timeout=0.01) == (None, -1)
        timer = mod.FpsTimer(report_every=2, name="t")
        for _ in range(2):
            timer.start_new_frame()
            timer.record_preprocess_end()
            timer.record_inference_end()
            timer.record_output_end()
        m = mod.PerformanceMetrics(report_every=2)
        m.add_frame(0.001, 0.002, 0.003, 0.006)
        m.add_frame(0.001, 0.002, 0.003, 0.006)
        assert (m.frames, m.capture_us, m.e2e_us) == (2, 2000.0, 12000.0)
    out = capsys.readouterr().out
    assert out.count("frames=2") == 4


def test_fleet_refuses_a_mesh(programs):
    """A mesh of one device serves the fleet as mesh=None does, bit for bit
    (one tick of 2 streams, both programs)."""
    from autoware_vision_pilot_tpu_torch.core.mesh import make_mesh

    _, lat, lon = programs
    frames = torch.from_numpy(np.stack(distinct_frames(2, 60)))
    kw = dict(frame_hw=FRAME_HW, crop_y=CROP_Y, dtype=torch.float32, net_hw=NET_HW)
    runs = []
    for mesh in (None, make_mesh(devices=["cpu"])):
        fleet = trt.FleetLateralPipeline(lat.lanes, lat.steer_net, Config(), 2, mesh=mesh, **kw)
        out, _ = fleet(frames, fleet.init_states(3))
        runs.append((out, trt.FleetLongitudinalPipeline(
            lon.net, Config(), 2, frame_hw=FRAME_HW, input_hw=LON_HW, dtype=torch.float32,
            mesh=mesh)(frames)))
    (out, tables), (got, got_tables) = runs
    assert torch.equal(got_tables, tables)
    for k in out:
        assert torch.equal(torch.nan_to_num(got[k]), torch.nan_to_num(out[k])), k


def write_video(path, n, seed):
    import cv2
    rng = np.random.default_rng(seed)
    w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), 10.0, (1280, 720))
    assert w.isOpened()
    for _ in range(n):
        w.write(rng.integers(0, 256, (720, 1280, 3), dtype=np.uint8))
    w.release()


def recording_publisher(read):
    """host/shm.py's SharedStatePublisher class made to open a segment of
    this test's own (the pid in its name) and, at close, to read the state
    it holds back through a SharedStateReader into ``read`` before the
    owner unlinks it."""
    from autoware_vision_pilot_tpu_torch.host import shm
    name = f"/avp_torch_app_{os.getpid()}"

    class Publisher(shm.SharedStatePublisher):
        def __init__(self, _name=None):
            super().__init__(name)

        def close(self):
            if getattr(self, "_h", None):
                with shm.SharedStateReader(name) as rd:
                    read.append(rd.read())
            super().close()

    return Publisher


def write_conf(tmp_path, video, *lines):
    conf = tmp_path / "vp.conf"
    conf.write_text("\n".join(["mode=video", f"source.video.path={video}",
                               "pipeline.target_fps=0", *lines]) + "\n")
    return conf


def test_app_main_on_cpu(tmp_path, capsys, monkeypatch):
    """app.py's main over 2 frames of a 720p video written with cv2: the
    full-width networks from seeds (build_engine, f32 on the CPU), a CSV
    row a frame with the engine's fields, and the SHM state of the last
    frame read back with those fields, as the JAX app publishes them."""
    pytest.importorskip("cv2")
    from autoware_vision_pilot_tpu_torch.host import shm
    video, csv_path = tmp_path / "clip.avi", tmp_path / "out" / "log.csv"
    write_video(video, 3, seed=13)
    conf = write_conf(tmp_path, video, f"output.csv_log_path={csv_path}")
    read = []
    monkeypatch.setattr(shm, "SharedStatePublisher", recording_publisher(read))
    from autoware_vision_pilot_tpu_torch.app import main
    assert main(["--config", str(conf), "--max-frames", "2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "SHM publish disabled" not in out and "not ported" not in out
    assert "[app] processed 2 frames" in out
    rows = list(csv.DictReader(csv_path.open()))
    assert [r["frame"] for r in rows] == ["0", "1"]
    for r in rows:
        assert np.isfinite(float(r["steering_deg"])) and np.isfinite(float(r["set_speed_ms"]))
        assert r["cipo_exists"] in ("True", "False") and r["can_valid"] == "False"
        assert r["ego_speed_ms"] == "nan"
    (state,) = read
    last = rows[-1]
    assert state.seq == 4 and state.frame_number == 1
    assert (state.steering_pid_deg, state.cte_m, state.yaw_error_rad, state.ideal_speed_ms,
            state.control_effort_ms2, state.cipo_velocity_ms) == tuple(
        float(last[k]) for k in ("steering_deg", "cte_m", "yaw_error_rad", "set_speed_ms",
                                 "accel_effort_ms2", "cipo_velocity_ms"))
    assert state.cipo_distance_m == max(float(last["cipo_distance_m"]), 0.0)
    assert [state.cipo_exists, state.fcw_active, state.aeb_active, state.cut_in_detected,
            state.kalman_reset] == [last[k] == "True" for k in ("cipo_exists", "fcw", "aeb",
                                                                "cut_in", "kalman_reset")]
    assert np.isnan(state.ego_speed_ms) and not state.can_valid
    # --no-shm: no publisher at all
    assert main(["--config", str(conf), "--max-frames", "1", "--device", "cpu",
                 "--no-shm"]) == 0
    assert len(read) == 1


def read_clip(path):
    import cv2
    cap = cv2.VideoCapture(str(path))
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            cap.release()
            return frames
        frames.append(f)


@pytest.mark.parametrize("key", ["output.save_video", "output.enable_viz", "rerun.enabled"])
def test_app_outputs(tmp_path, monkeypatch, key):
    """Each output the JAX app has, through app.py's main over 2 frames
    (f32 on the CPU, --no-shm): the video's frames are the composite's
    (both written through the same MJPG writer and read back); the
    display shows each composite, its headless cv2 failure swallowed as
    the JAX app swallows it; Rerun (a fake SDK) gets each frame with the
    lane masks the engine copied to the host and the composite."""
    cv2 = pytest.importorskip("cv2")
    from autoware_vision_pilot_tpu_torch import app
    from autoware_vision_pilot_tpu_torch.utils import rerun_logger
    video, out_video = tmp_path / "clip.avi", tmp_path / "out.avi"
    write_video(video, 3, seed=14)
    lines = {"output.save_video": ["output.save_video=true",
                                   f"output.output_video_path={out_video}"],
             "output.enable_viz": ["output.enable_viz=true"],
             "rerun.enabled": ["rerun.enabled=true", "rerun.spawn_viewer=false",
                               f"rerun.save_path={tmp_path / 'run.rrd'}"]}[key]
    conf = write_conf(tmp_path, video, f"output.csv_log_path={tmp_path / 'log.csv'}", *lines)
    composites, shown, calls, masks = [], [], [], []
    compose = app.compose_display_frame

    def recording_compose(res, lat_out, *a, **k):
        masks.append(lat_out["lane_masks"])
        composites.append(compose(res, lat_out, *a, **k))
        return composites[-1]

    def headless_imshow(name, img):
        shown.append(img)
        raise cv2.error("The function is not implemented (headless)")

    monkeypatch.setattr(app, "compose_display_frame", recording_compose)
    monkeypatch.setattr(cv2, "imshow", headless_imshow)
    monkeypatch.setattr(rerun_logger, "rr", types.SimpleNamespace(
        init=lambda app_id: calls.append(("init", app_id)),
        save=lambda p: calls.append(("save", p)),
        spawn=lambda: calls.append(("spawn",)),
        set_time_sequence=lambda n, v: calls.append(("seq", n, v)),
        log=lambda path, obj: calls.append(("log", path, obj)),
        Image=lambda a: np.array(a), Scalar=float))
    monkeypatch.setattr(rerun_logger, "_HAS_RERUN", True)
    assert app.main(["--config", str(conf), "--max-frames", "2", "--device", "cpu",
                     "--no-shm"]) == 0
    assert len(composites) == 2
    for c, m in zip(composites, masks):
        assert c.shape == (720, 1280, 3) and c.dtype == np.uint8
        assert isinstance(m, torch.Tensor) and m.device.type == "cpu" and m.shape == (80, 160, 3)
    if key == "output.save_video":
        ref = tmp_path / "ref.avi"
        w = cv2.VideoWriter(str(ref), cv2.VideoWriter_fourcc(*"MJPG"), 10.0, (1280, 720))
        for c in composites:
            w.write(c)
        w.release()
        got, want = read_clip(out_video), read_clip(ref)
        assert len(got) == len(want) == 2
        for a, b in zip(got, want):
            assert a.shape == (720, 1280, 3) and np.array_equal(a, b)
    elif key == "output.enable_viz":
        assert len(shown) == 2 and all(a is b for a, b in zip(shown, composites))
    else:
        assert calls[:2] == [("init", "visionpilot_tpu"), ("save", str(tmp_path / "run.rrd"))]
        assert [c[2] for c in calls if c[0] == "seq"] == [0, 1]
        logged = [c for c in calls if c[0] == "log"]
        lanes = {c[1]: c[2] for c in logged if c[1].startswith("lanes/")}
        assert set(lanes) == {"lanes/ego_left", "lanes/ego_right", "lanes/other"}
        np.testing.assert_array_equal(lanes["lanes/ego_left"],
                                      (masks[-1][..., 0].numpy() * 255).astype(np.uint8))
        views = [c[2] for c in logged if c[1] == "visualization/stacked_view"]
        assert len(views) == 2 and np.array_equal(views[-1], composites[-1][..., ::-1])
        assert sum(c[1] == "control/autosteer_angle_deg" for c in logged) == 2


def test_build_engine_on_cpu():
    """build_engine at full width on the CPU: EgoLanes 320x640, AutoSteer on
    80x160 masks, AutoSpeed "n" at 640x640, the same weights as
    build_lateral_pipeline and build_longitudinal_pipeline from one seed;
    two 720p frames through it."""
    from autoware_vision_pilot_tpu_torch.app import build_engine
    cfg = Config()
    cfg.target_fps = 0.0
    frames = iter([np.random.default_rng(i).integers(0, 256, (720, 1280, 3), dtype=np.uint8)
                   for i in range(2)])
    eng = build_engine(cfg, lambda: next(frames, None), dtype=torch.float32, device="cpu")
    lat = build_lateral_pipeline("cpu", torch.float32, seed=0)
    for a, b in zip(eng.lateral.lanes.state_dict().values(), lat.lanes.state_dict().values()):
        assert torch.equal(a, b)
    lon = build_longitudinal_pipeline("cpu", torch.float32, seed=0)
    for a, b in zip(eng.longitudinal.net.state_dict().values(), lon.net.state_dict().values()):
        assert torch.equal(a, b)
    results = eng.run()
    assert [r.frame_num for r in results] == [0, 1]


NO_JAX = """
import builtins, importlib, sys
real = builtins.__import__
def guarded(name, *a, **k):
    if name.split(".")[0] in ("jax", "jaxlib", "flax", "msgpack", "autoware_vision_pilot_tpu"):
        raise ImportError(f"{name} is hidden")
    return real(name, *a, **k)
builtins.__import__ = guarded
for m in ("app", "runtime", "runtime.fleet", "runtime.pipeline", "perception.tracking",
          "export.checkpoints", "control.speed_planner", "control.pi_controller",
          "utils.csv_logger", "drivers.can_interface", "drivers.camera", "calibration",
          "convert", "convert.torch_import", "convert.onnx_import", "export.quantize",
          "export.eval_lite", "host", "host.shm", "host.frame_ring", "host.iox2",
          "middleware", "middleware.transport", "middleware.ros2_codec", "middleware.nodes",
          "utils", "utils.visualization", "utils.video_viz", "utils.rerun_logger",
          "drivers.gstreamer", "train", "train.losses", "train.metrics", "train.datasets",
          "train.train_step", "train.legacy_trainer", "train.qat", "train.optim",
          "train.detection_loss", "train.yolo_data", "train.detection_trainer",
          "train.autosteer_trainer", "train.autosteer_temporal_trainer",
          "train.autodrive_trainer", "train.lite_trainer", "train.augment", "train.teachers",
          "core", "core.mesh", "core.dtypes", "parallel", "parallel.distributed",
          "parallel.sharding", "parallel.multichip_inference", "parallel.tensor_parallel"):
    importlib.import_module("autoware_vision_pilot_tpu_torch." + m)
from autoware_vision_pilot_tpu_torch.export.checkpoints import load_msgpack
tree = load_msgpack(sys.argv[1])
assert tree["params"]["w"].shape == (2, 3), tree
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "msgpack"))
assert not leaked, leaked
print("ok")
"""


def test_port_imports_no_jax(tmp_path):
    """In a subprocess where importing jax, flax, msgpack or the JAX package
    raises, the serving modules of the port (the host IPC bindings, the
    middleware and its nodes, the visualization and telemetry too), its
    calibration, importers, quantization, training, meshes and parallelism
    import and read a weight file."""
    from autoware_vision_pilot_tpu.export.checkpoints import save_msgpack
    path = tmp_path / "w.msgpack"
    save_msgpack(path, {"params": {"w": np.ones((2, 3), np.float32)}})
    out = subprocess.run([sys.executable, "-c", NO_JAX, str(path)], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
