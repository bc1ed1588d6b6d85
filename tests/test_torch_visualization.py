"""The port's host visualization and telemetry (utils/visualization.py,
utils/video_viz.py, utils/rerun_logger.py, drivers/gstreamer.py and
app.py::compose_display_frame) against the JAX package's, on the CPU.

Both packages draw with the same cv2 on the host, so every image is held
byte for byte (np.array_equal) on seeded frames, masks, tracks and HUD
values; the Rerun logger's calls to a fake SDK are held call by call, in
order. visualize_video runs each model's branch on a short clip written
here, with each package's inference wrappers replaced by one stand-in
that returns the same seeded outputs (as JAX's test_mass_visualize_videos
stands in for visualize_video): what is held is the composite and the
MJPG writer, frame by frame; the wrappers themselves are held by
tests/test_torch_infer.py and test_torch_backend.py.
"""
import types

import numpy as np
import pytest

from test_torch_train_step import one_thread  # noqa: F401 (an autouse fixture)

cv2 = pytest.importorskip("cv2")

from autoware_vision_pilot_tpu import app as japp
from autoware_vision_pilot_tpu import inference as jinference
from autoware_vision_pilot_tpu.drivers import gstreamer as jgst
from autoware_vision_pilot_tpu.perception import tracking as jtracking
from autoware_vision_pilot_tpu.runtime import pipeline as jpipe
from autoware_vision_pilot_tpu.utils import rerun_logger as jrl
from autoware_vision_pilot_tpu.utils import video_viz as jvv
from autoware_vision_pilot_tpu.utils import visualization as jviz

from autoware_vision_pilot_tpu_torch import app as tapp
from autoware_vision_pilot_tpu_torch import inference as tinference
from autoware_vision_pilot_tpu_torch import utils as tutils
from autoware_vision_pilot_tpu_torch.drivers import gstreamer as tgst
from autoware_vision_pilot_tpu_torch.perception import tracking as ttracking
from autoware_vision_pilot_tpu_torch.runtime import pipeline as tpipe
from autoware_vision_pilot_tpu_torch.utils import rerun_logger as trl
from autoware_vision_pilot_tpu_torch.utils import video_viz as tvv
from autoware_vision_pilot_tpu_torch.utils import visualization as tviz

RNG = np.random.default_rng(80)
FRAME = RNG.integers(0, 256, (720, 1280, 3), dtype=np.uint8)
MASKS = (RNG.random((80, 160, 3)) > 0.8).astype(np.float32)
WHEEL = tviz.make_steering_wheel_image()


def tracks(mod, n=4, seed=81):
    rng = np.random.default_rng(seed)
    return [mod.TrackedObject(track_id=i, class_id=int(rng.integers(1, 4)),
                              bbox=tuple(int(v) for v in (*rng.integers(0, 1100, 2),
                                                          *rng.integers(20, 200, 2))),
                              confidence=0.9, distance_m=float(rng.uniform(3, 80)),
                              velocity_ms=float(rng.normal(0, 3))) for i in range(n)]


def same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


# (function, arguments): each argument list is built once per package so
# that functions that draw in place get a frame of their own
CALLS = {
    "blend": lambda v, m: (FRAME, FRAME[::-1].copy(), 0.3),
    "draw_lane_masks": lambda v, m: (FRAME, MASKS, 420),
    "draw_polyfit_lanes": lambda v, m: (FRAME.copy(), [0, 1e-3, -0.2, 80, 10, 75], (0, 200, 255),
                                        420),
    "draw_detections": lambda v, m: (FRAME.copy(), tracks(m), 2),
    "draw_hud": lambda v, m: (FRAME.copy(), -7.25, 11.5, 29.97, True, False, True, True),
    "draw_lane_masks_roi": lambda v, m: (FRAME, MASKS, 420),
    "draw_safety_alerts": lambda v, m: (FRAME.copy(), True, True),
    "draw_cipo_hud": lambda v, m: (FRAME.copy(), 12.3, 18.0, -1.2),
    "draw_frame_sync_label": lambda v, m: (FRAME.copy(), 42),
    "depth_to_colormap": lambda v, m: (np.linspace(-0.1, 1.1, 80 * 160).reshape(80, 160),),
    "make_steering_wheel_image": lambda v, m: (96,),
    "rotate_steering_wheel": lambda v, m: (WHEEL, 33.3),
    "overlay_alpha": lambda v, m: (FRAME.copy(), WHEEL, 40, 50),
    "visualize_steering": lambda v, m: (FRAME.copy(), 4.5, v.rotate_steering_wheel(WHEEL, 4.5),
                                        -3.0, v.rotate_steering_wheel(WHEEL, -3.0)),
    "show_lane_departure_warning": lambda v, m: (FRAME.copy(),),
    "gen_bev_points": lambda v, m: ([0, 2e-4, 0.1, 300, 100, 600],),
    "draw_bev_vis": lambda v, m: (FRAME, np.array([[0.5, 0.1, -50], [0.02, 0.9, -200],
                                                   [0, 2e-4, 1]]),
                                  [0, 1e-4, 0.0, 250, 0, 640], [0, -1e-4, 0.0, 390, 0, 640],
                                  [0, 0.0, 0.0, 320, 0, 640], True, 140.0),
    "make_stacked_view": lambda v, m: (FRAME[:360], FRAME[360:], FRAME[:640, :640]),
}


@pytest.mark.parametrize("fn", list(CALLS))
def test_visualization_function_matches_jax(fn):
    got = getattr(tviz, fn)(*CALLS[fn](tviz, ttracking))
    want = getattr(jviz, fn)(*CALLS[fn](jviz, jtracking))
    same(np.asarray(got), np.asarray(want))


def test_visualization_edge_cases_match_jax():
    """Calls that return early or take other branches: an empty sprite, a
    sprite past the frame, a 3-channel sprite, an empty fit window, short
    BEV coefficients, the BEV view still waiting, the FCW banner alone."""
    for sprite, x, y in [(np.zeros((0, 0, 4), np.uint8), 0, 0), (WHEEL, 1250, 10),
                         (WHEEL[..., :3].copy(), 5, 5)]:
        same(tviz.overlay_alpha(FRAME.copy(), sprite, x, y),
             jviz.overlay_alpha(FRAME.copy(), sprite, x, y))
    same(tviz.rotate_steering_wheel(None, 3.0), jviz.rotate_steering_wheel(None, 3.0))
    same(tviz.draw_polyfit_lanes(FRAME.copy(), [0, 0, 0, 0, 5, 5]),
         jviz.draw_polyfit_lanes(FRAME.copy(), [0, 0, 0, 0, 5, 5]))
    same(tviz.gen_bev_points([1, 2]), jviz.gen_bev_points([1, 2]))
    same(tviz.draw_bev_vis(FRAME, np.eye(3), valid=False),
         jviz.draw_bev_vis(FRAME, np.eye(3), valid=False))
    same(tviz.draw_hud(FRAME.copy(), fcw=True), jviz.draw_hud(FRAME.copy(), fcw=True))
    same(tviz.draw_safety_alerts(FRAME.copy(), True, False),
         jviz.draw_safety_alerts(FRAME.copy(), True, False))
    assert tviz.SCENE_SEG_PALETTE.tobytes() == jviz.SCENE_SEG_PALETTE.tobytes()
    assert (tviz.EGO_LANES_COLORS, tviz.DOMAIN_COLOR) == (jviz.EGO_LANES_COLORS,
                                                          jviz.DOMAIN_COLOR)
    assert tutils.blend is tviz.blend and tutils.CsvFlightRecorder is not None


@pytest.mark.parametrize("case", ["plain", "hud"])
def test_unified_display_frame_matches_jax(case):
    kw = dict(steering_deg=5.0, frame_num=7)
    if case == "hud":
        kw.update(gt_steering_deg=-20.0, lane_departure=True, fcw=True, aeb=False,
                  cipo_exists=True, ideal_speed_ms=12.3, safe_distance_m=18.0,
                  control_effort_ms2=-1.2, display_wh=(1280, 720))
    for masks in (MASKS, None):
        got = tviz.unified_display_frame(FRAME, masks, tracks(ttracking), 2, wheel_pred=WHEEL,
                                         wheel_gt=WHEEL, **kw)
        want = jviz.unified_display_frame(FRAME, masks, tracks(jtracking), 2,
                                          wheel_pred=WHEEL, wheel_gt=WHEEL, **kw)
        same(got, want)
    assert (FRAME == np.random.default_rng(80).integers(0, 256, (720, 1280, 3),
                                                        dtype=np.uint8)).all()


def tracking_result(mod, cipo):
    return mod.TrackingResult(tracked_objects=tracks(mod),
                              cipo=mod.CIPOInfo(exists=cipo, track_id=1, class_id=1,
                                                distance_m=22.0, velocity_ms=-2.0))


@pytest.mark.parametrize("case", ["bare", "tracked", "can"])
def test_compose_display_frame_matches_jax(case):
    """app.py's composite on the same FrameResult, lane masks (a CPU tensor
    on the port's side, as the engine hands them), tracking and CAN state."""
    import torch
    fields = dict(frame_num=3, steering_deg=-12.5, set_speed=8.0, fcw=True,
                  lane_departure=True, cipo_distance=22.0, safe_distance=14.0,
                  accel_effort=0.7)
    ego = types.SimpleNamespace(valid=True, steering_angle_deg=6.5) if case == "can" else None
    got = tapp.compose_display_frame(
        tpipe.FrameResult(**fields), {"lane_masks": torch.from_numpy(MASKS)},
        tracking_result(ttracking, True) if case != "bare" else None, FRAME, WHEEL, fps=42.0,
        ego=ego)
    want = japp.compose_display_frame(
        jpipe.FrameResult(**fields), {"lane_masks": MASKS},
        tracking_result(jtracking, True) if case != "bare" else None, FRAME, WHEEL, fps=42.0,
        ego=ego)
    same(got, want)


def test_frame_sync_buffer_matches_jax():
    """The same pushes into both buffers: the same synced pairs and the same
    evictions (max_lag 3)."""
    bufs = [tviz.FrameSyncBuffer(max_lag=3), jviz.FrameSyncBuffer(max_lag=3)]
    rng = np.random.default_rng(82)
    synced = 0
    for step in range(40):
        n = int(rng.integers(0, 12))
        side = "push_lateral" if rng.random() < 0.5 else "push_longitudinal"
        outs = []
        for b in bufs:
            getattr(b, side)(n, f"{side}{n}")
            outs.append((b.pop_synced() if step % 3 == 0 else [], dict(b._lat),
                         dict(b._lon)))
        assert outs[0] == outs[1], step
        synced += len(outs[0][0])
    assert synced > 0


class StandIn:
    """One stand-in for every wrapper of both packages: seeded outputs of
    each wrapper's type and shape, drawn from the frame's bytes."""

    def __init__(self, name):
        self.name = name

    def inference(self, frame):
        rng = np.random.default_rng(int(frame[::97, ::89].sum()))
        h, w = 320, 640
        if self.name == "SceneSeg":
            return rng.integers(0, 3, (h, w)).astype(np.int32)
        if self.name == "Scene3D":
            return rng.random((h, w), dtype=np.float32)
        if self.name == "DomainSeg":
            return rng.random((h, w)) > 0.7
        if self.name == "EgoLanes":
            return (rng.random((h // 4, w // 4, 3)) > 0.8).astype(np.float32)
        boxes = np.sort(rng.uniform(0, 600, (5, 4)), axis=1).astype(np.float32)
        return np.concatenate([boxes, rng.uniform(0.5, 1, (5, 1)),
                               rng.integers(0, 4, (5, 1))], 1).astype(np.float32)


def write_clip(path, n, hw, seed):
    rng = np.random.default_rng(seed)
    w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), 10.0, (hw[1], hw[0]))
    for _ in range(n):
        w.write(rng.integers(0, 256, (*hw, 3), dtype=np.uint8))
    w.release()


def read_clip(path):
    cap = cv2.VideoCapture(str(path))
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            return frames
        frames.append(f)


@pytest.mark.parametrize("model", ["SceneSeg", "Scene3D", "DomainSeg", "EgoLanes", "AutoSpeed"])
def test_visualize_video_matches_jax(model, tmp_path, monkeypatch):
    """visualize_video of both packages on a 4-frame 360x640 clip with
    max_frames 3: the same frame count, and the written clips decode to
    the same frames; the port builds its wrapper on ``device``."""
    clip = tmp_path / "clip.avi"
    write_clip(clip, 4, (360, 640), seed=83)
    calls = []
    monkeypatch.setattr(jinference, f"{model}Infer", lambda **kw: StandIn(model))
    monkeypatch.setattr(tinference, f"{model}Infer",
                        lambda **kw: calls.append(kw) or StandIn(model))
    n_t = tvv.visualize_video(model, str(clip), str(tmp_path / "t.avi"), max_frames=3,
                              device="cpu")
    n_j = jvv.visualize_video(model, str(clip), str(tmp_path / "j.avi"), max_frames=3)
    assert n_t == n_j == 3 and calls and calls[0]["device"] == "cpu"
    if model == "AutoSpeed":
        assert calls[0]["frame_hw"] == (360, 640)
    got, want = read_clip(tmp_path / "t.avi"), read_clip(tmp_path / "j.avi")
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        same(a, b)
    with pytest.raises(ValueError, match="unknown model"):
        tvv.visualize_video("Nope", str(clip), str(tmp_path / "x.avi"), device="cpu")
    with pytest.raises(RuntimeError, match="cannot open"):
        tvv.visualize_video(model, str(tmp_path / "missing.avi"), str(tmp_path / "x.avi"))


def test_mass_visualize_videos_matches_jax(tmp_path, monkeypatch):
    """The directory sweep of both packages over the same directory, with
    visualize_video stood in as JAX's own test does: the same (name, out,
    frames) list; the port passes its device on."""
    (tmp_path / "vids").mkdir()
    for name in ("b.mp4", "a.mp4", "skip.txt"):
        (tmp_path / "vids" / name).write_bytes(b"x")
    done, calls = {}, []
    for mod in (jvv, tvv):
        def fake(model, path, out, checkpoint="", max_frames=None, device=None, mod=mod):
            calls.append((mod, device))
            return 3
        monkeypatch.setattr(mod, "visualize_video", fake)
        kw = {"device": "cpu"} if mod is tvv else {}
        done[mod] = mod.mass_visualize_videos("EgoLanes", str(tmp_path / "vids"),
                                              str(tmp_path / mod.__name__.split(".")[0]), **kw)
    names = [[(n, out.rsplit("/", 1)[-1], k) for n, out, k in done[m]] for m in (tvv, jvv)]
    assert names[0] == names[1] == [("a.mp4", "a.avi", 3), ("b.mp4", "b.avi", 3)]
    assert (tvv, "cpu") in calls and (jvv, None) in calls


def test_steering_graph_matches_jax(tmp_path):
    pytest.importorskip("matplotlib")
    gt = np.sin(np.linspace(0, 3, 50)) * 10
    pred = gt + np.random.default_rng(84).normal(0, 0.5, 50)
    for mod, name in ((tvv, "t.png"), (jvv, "j.png")):
        mod.visualize_steering_graph(gt, pred, str(tmp_path / name))
    assert (tmp_path / "t.png").stat().st_size > 1000
    same(cv2.imread(str(tmp_path / "t.png")), cv2.imread(str(tmp_path / "j.png")))


def fake_sdk(calls):
    return types.SimpleNamespace(
        init=lambda app_id: calls.append(("init", app_id)),
        spawn=lambda: calls.append(("spawn",)),
        save=lambda p: calls.append(("save", p)),
        set_time_sequence=lambda n, v: calls.append(("seq", n, v)),
        log=lambda path, obj: calls.append(("log", path, obj)),
        Image=lambda a: ("img", np.asarray(a).shape, np.ascontiguousarray(a).tobytes()),
        Scalar=lambda v: ("scalar", float(v)),
    )


@pytest.mark.parametrize("kind", ["viewer", "saved", "gated"])
def test_rerun_logger_calls_match_jax(kind, monkeypatch, capsys):
    """Both loggers against a fake SDK: the same calls in the same order,
    image bytes included; the gating (invalid CAN logs 0.0, an invalid
    PathFinder fuse drops its channels, no sink -> never initialised)."""
    rng = np.random.default_rng(85)
    data = dict(frame_bgr=FRAME[:320, :640], ego_left=MASKS[..., 0], ego_right=MASKS[..., 1],
                other_lanes=MASKS[..., 2], stacked_view_bgr=FRAME, can_steering_deg=4.5,
                can_speed_kmph=88.0, can_valid=kind != "gated", pid_steering_raw_deg=3.5,
                pid_steering_filtered_deg=3.0, autosteer_deg=float(rng.normal()),
                cte=0.1, yaw_error=0.05, curvature=0.01, fused_valid=kind != "gated",
                inference_us=5000.0)
    calls = {}
    for mod in (jrl, trl):
        calls[mod] = []
        monkeypatch.setattr(mod, "rr", fake_sdk(calls[mod]))
        monkeypatch.setattr(mod, "_HAS_RERUN", True)
        logger = mod.RerunLogger(spawn_viewer=kind == "viewer",
                                 save_path="/tmp/x.rrd" if kind != "viewer" else None)
        assert logger.enabled
        for n in (7, 8):
            logger.log_data(n, **data)
        assert not mod.RerunLogger().enabled
    assert calls[trl] == calls[jrl]
    assert sum(c[0] == "log" for c in calls[trl]) == 2 * (14 if kind != "gated" else 11)
    out = capsys.readouterr().out
    assert out.count("[rerun] not initialized (no viewer or save path)") == 2


def test_rerun_logger_without_the_sdk(monkeypatch, capsys):
    """Without the SDK the port's logger is JAX's no-op, with its message."""
    for mod in (jrl, trl):
        monkeypatch.setattr(mod, "rr", None)
        monkeypatch.setattr(mod, "_HAS_RERUN", False)
        logger = mod.RerunLogger(save_path="/tmp/x.rrd")
        assert not logger.enabled
        logger.log_data(0, frame_bgr=FRAME, autosteer_deg=1.0)
    out = capsys.readouterr().out
    assert out.count("[rerun] SDK not installed — telemetry disabled") == 2


@pytest.mark.parametrize("source", ["rtsp://cam/stream", "/dev/video2", "clip.mp4"])
@pytest.mark.parametrize("realtime", [True, False])
def test_gstreamer_pipeline_strings_match_jax(source, realtime):
    assert tgst.build_pipeline(source, realtime) == jgst.build_pipeline(source, realtime)


def test_gstreamer_open_source_reads_a_file(tmp_path):
    """open_source on a written clip (GStreamer, else plain VideoCapture, as
    in JAX): the same frames as JAX's."""
    clip = tmp_path / "c.avi"
    write_clip(clip, 2, (48, 64), seed=86)
    frames = {}
    for mod in (tgst, jgst):
        cap = mod.open_source(str(clip), realtime=False)
        frames[mod] = [cap.read()[1] for _ in range(2)]
        cap.release()
    for a, b in zip(frames[tgst], frames[jgst]):
        same(a, b)
