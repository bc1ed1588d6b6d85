"""The port's host-side longitudinal state machines against the JAX package:
perception/tracking.py (ObjectFinder, KalmanFilter1D, the association
score, the ORB gate), control/speed_planner.py, control/pi_controller.py,
and runtime/pipeline.py::PipelineEngine._harvest, which drives them.

This is float64 host code (numpy and Python floats) in both packages, so
every comparison is exact: the same inputs, from numpy seeds, must give the
same bits. The detection sequences are scripted scenes in a 1280x720
frame, jittered from a seed: tracks appear, a track drops after 3
unmatched frames, the closest in-path object (CIPO) changes, and a cut-in
resets the Kalman filter and the PID. A fixed clock (0.1 s a frame) takes
the place of time.monotonic on both sides.
"""
import dataclasses
import itertools
import types

import numpy as np
import pytest
import torch

from autoware_vision_pilot_tpu.control import pi_controller as jpi
from autoware_vision_pilot_tpu.control import speed_planner as jsp
from autoware_vision_pilot_tpu.perception import tracking as jtr
from autoware_vision_pilot_tpu.runtime import config as jconfig
from autoware_vision_pilot_tpu.runtime import pipeline as jpipe

from autoware_vision_pilot_tpu_torch.control import pi_controller as tpi
from autoware_vision_pilot_tpu_torch.control import speed_planner as tsp
from autoware_vision_pilot_tpu_torch.perception import tracking as ttr
from autoware_vision_pilot_tpu_torch.runtime import config as tconfig
from autoware_vision_pilot_tpu_torch.runtime import pipeline as tpipe

from test_torch_train_step import one_thread  # noqa: F401 (an autouse fixture)

W, H = 1280, 720
# image -> ground plane: x across (m), y ahead (m); the bottom row is 0 m ahead
HOMOGRAPHY = np.array([[0.02, 0.0, -12.8], [0.0, -0.12, 86.4], [0.0, 0.0, 1.0]])


def clock():
    ticks = itertools.count()
    return lambda: 0.1 * next(ticks)


def box(cx, bottom, w, h, score, cls):
    return (cx - w / 2, bottom - h, cx + w / 2, bottom, score, cls)


def scene(kind, n_frames=16, seed=0):
    """Detection lists (x1, y1, x2, y2, score, class_id) a frame, float32
    values as the packed table holds them. "cut-in": a lead car (class 1)
    that leaves after frame 5 (its track is kept 3 more frames, then
    dropped), a farther car (class 2) that becomes the CIPO, a third car
    that cuts in closer at frame 11, and a pedestrian (class 0, not
    tracked). "crowd": up to 6 cars of both classes that come and go at
    random, with class flips."""
    rng = np.random.default_rng(seed)
    frames = []
    for t in range(n_frames):
        dets = []
        if kind == "cut-in":
            if t <= 5:
                dets.append(box(640 + 3 * t, 600 - 2 * t, 220, 160, 0.9, 1))
            dets.append(box(700 - t, 470 + t, 90, 70, 0.8, 2))
            if t >= 11:
                dets.append(box(500 + 20 * (t - 11), 640, 260, 190, 0.7, 1))
            dets.append(box(200, 500, 40, 90, 0.6, 0))
        else:
            for car in range(6):
                if rng.random() < 0.7:
                    cls = 1 + (car % 2) if rng.random() < 0.9 else 2 - (car % 2)
                    dets.append(box(150 + 180 * car, 450 + 30 * (car % 3), 120, 90,
                                    rng.uniform(0.5, 1.0), cls))
        jitter = rng.normal(0, 2.0, (len(dets), 4))
        frames.append([tuple(np.float32(v) for v in (*np.add(d[:4], j), d[4])) + (d[5],)
                       for d, j in zip(dets, jitter)])
    return frames


def images(n_frames, seed=0):
    """Distinct uint8 BGR frames for the ORB crops, mostly smooth texture."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (H // 8, W // 8, 3), np.uint8)
    out = []
    for t in range(n_frames):
        img = np.kron(np.roll(base, 3 * t, axis=1), np.ones((8, 8, 1), np.uint8))
        out.append(np.clip(img.astype(np.int16) + rng.integers(-20, 21, img.shape), 0, 255)
                   .astype(np.uint8))
    return out


def assert_tracking_equal(port, ref, what):
    assert dataclasses.asdict(port.cipo) == dataclasses.asdict(ref.cipo), what
    assert (port.cut_in_detected, port.kalman_reset) == (ref.cut_in_detected, ref.kalman_reset)
    assert len(port.tracked_objects) == len(ref.tracked_objects), what
    for a, b in zip(port.tracked_objects, ref.tracked_objects):
        for f in ("track_id", "class_id", "bbox", "confidence", "distance_m", "velocity_ms",
                  "frames_tracked", "frames_unmatched", "last_update_time"):
            assert getattr(a, f) == getattr(b, f), f"{what}: {f}"
        np.testing.assert_array_equal(a.kalman.x, b.kalman.x)
        np.testing.assert_array_equal(a.kalman.P, b.kalman.P)


@pytest.mark.parametrize("kind,seed", [("cut-in", 0), ("cut-in", 1), ("crowd", 2), ("crowd", 3)])
@pytest.mark.parametrize("with_cv2", [True, False])
def test_object_finder_matches_jax(kind, seed, with_cv2, monkeypatch):
    """Frame by frame: every track's fields and Kalman state, the CIPO, and
    the cut-in and reset flags, bit for bit. Without cv2 the ORB gate says
    False on both sides (a CIPO change is then a cut-in)."""
    if with_cv2 and not (jtr._HAS_CV2 and ttr._HAS_CV2):
        pytest.skip("cv2 is not installed")
    if not with_cv2:
        monkeypatch.setattr(jtr, "_HAS_CV2", False)
        monkeypatch.setattr(ttr, "_HAS_CV2", False)
    dets, imgs = scene(kind, seed=seed), images(16, seed)
    jf = jtr.ObjectFinder(HOMOGRAPHY, W, H, clock=clock())
    tf = ttr.ObjectFinder(HOMOGRAPHY, W, H, clock=clock())
    seen = {"cut_in": 0, "cipo_ids": set(), "dropped": False}
    for t, (d, img) in enumerate(zip(dets, imgs)):
        ref = jf.update_and_get_cipo(d, img)
        out = tf.update_and_get_cipo(d, img)
        assert_tracking_equal(out, ref, f"{kind} frame {t}")
        seen["cut_in"] += ref.cut_in_detected
        seen["cipo_ids"].add(ref.cipo.track_id)
        seen["dropped"] |= any(o.frames_unmatched == 3 for o in ref.tracked_objects)
    if kind == "cut-in":
        # the lead car's track is kept 3 unmatched frames, then dropped; the
        # CIPO moves to the far car, then to the car that cuts in
        assert seen["dropped"] and len(seen["cipo_ids"]) >= 3
        assert seen["cut_in"] >= 1


def test_kalman_filter_and_scores_match_jax():
    rng = np.random.default_rng(4)
    jk, tk = jtr.KalmanFilter1D(0.5, 2.0, 1.5), ttr.KalmanFilter1D(0.5, 2.0, 1.5)
    for step in range(20):
        z, dt = rng.uniform(5, 60), rng.uniform(0.05, 0.2)
        for k in (jk, tk):
            k.predict(dt)
            k.update(z)
        np.testing.assert_array_equal(tk.x, jk.x)
        np.testing.assert_array_equal(tk.P, jk.P)
        if step == 10:
            jk, tk = jk.copy(), tk.copy()
            jk.reset(), tk.reset()
    for _ in range(50):
        a = tuple(int(v) for v in rng.integers(-50, 700, 4))
        b = tuple(int(v) for v in rng.integers(-50, 700, 4))
        assert ttr.iou(a, b) == jtr.iou(a, b)
        assert ttr.matching_score(a, b, W, H) == jtr.matching_score(a, b, W, H)
    img = images(1)[0]
    for bbox in [(-20, -20, 100, 100), (1200, 700, 200, 200), (10, 10, 0, 5), (5, 6, 30, 40)]:
        a, b = ttr.extract_safe_crop(img, bbox), jtr.extract_safe_crop(img, bbox)
        assert (a is None) == (b is None) and (a is None or np.array_equal(a, b))


def test_speed_planner_and_pid_match_jax():
    """Seeded sequences of ego speed, CIPO presence, relative speed and
    distance through every band of the RSS policy (accelerate, hold, brake,
    FCW, AEB), and a PID reset on cut-in, value for value."""
    rng = np.random.default_rng(5)
    jp, tp = jsp.SpeedPlanner(ego_speed=10.0), tsp.SpeedPlanner(ego_speed=10.0)
    jc, tc = jpi.PIController(0.5, 0.1, 0.05), tpi.PIController(0.5, 0.1, 0.05)
    bands = set()
    for step in range(200):
        ego, present = rng.uniform(0, 35), bool(rng.random() < 0.8)
        rel, dist = rng.uniform(-10, 5), rng.uniform(0, 120)
        for p in (jp, tp):
            p.set_ego_speed(ego)
            p.set_is_cipo_present(present)
            if present:
                p.set_cipo_state(rel, dist)
        ref = (jp.calc_ideal_driving_speed(), jp.calc_safe_rss_distance(), jp.get_fcw_state(),
               jp.get_aeb_state())
        out = (tp.calc_ideal_driving_speed(), tp.calc_safe_rss_distance(), tp.get_fcw_state(),
               tp.get_aeb_state())
        assert out == ref, step
        bands.add((round(ref[0] - ego, 6), ref[2], ref[3]))
        if step % 37 == 36:
            jc.reset(), tc.reset()
        assert tc.compute_effort(ego, ref[0]) == jc.compute_effort(ego, ref[0])
        assert (tc.integral_error, tc.prev_error) == (jc.integral_error, jc.prev_error)
    assert {b[1:] for b in bands} >= {(False, False), (True, False), (True, True)}
    assert tsp.RSSConstants() == tsp.RSSConstants(**dataclasses.asdict(jsp.RSSConstants()))


def packed_tables(kind, seed, max_det=64):
    """scene() as the longitudinal step's packed (max_det, 7) f32 tables."""
    out = []
    for dets in scene(kind, seed=seed):
        t = np.zeros((max_det, 7), np.float32)
        for i, d in enumerate(dets[:max_det]):
            t[i] = [*d[:5], d[5], 1.0]
        out.append(t)
    return out


@pytest.mark.parametrize("kind,seed", [("cut-in", 6), ("crowd", 7)])
def test_harvest_matches_jax(kind, seed):
    """PipelineEngine._harvest of both packages on the same packed lateral
    scalars and detection tables, frame by frame: every FrameResult field,
    and the 4-argument sink gets the frame. The scalars are drawn so that
    some frames depart the lane."""
    rng = np.random.default_rng(seed)
    jcfg, tcfg = jconfig.Config(), tconfig.Config()
    seen = {"jax": [], "port": []}
    jeng = jpipe.PipelineEngine(
        jcfg, None, None, jtr.ObjectFinder(HOMOGRAPHY, W, H, clock=clock()), lambda: None,
        sink=lambda res, lat_out, trk, frame: seen["jax"].append(frame))
    teng = tpipe.PipelineEngine(
        tcfg, types.SimpleNamespace(device=torch.device("cpu")), None,
        ttr.ObjectFinder(HOMOGRAPHY, W, H, clock=clock()), lambda: None,
        sink=lambda res, lat_out, trk, frame: seen["port"].append(frame))
    imgs = images(16, seed)
    departures = 0
    for t, table in enumerate(packed_tables(kind, seed)):
        sc = np.array([rng.normal(0, 5), rng.normal(0, 5), rng.integers(-30, 31),
                       rng.normal(0, 1.5), rng.normal(0, 0.1), rng.uniform(0, 5),
                       float(rng.random() < 0.8), float(rng.random() < 0.8)], np.float32)
        ref = jeng._harvest(t, imgs[t], {"scalars": sc}, table)
        out = teng._harvest(t, imgs[t], {"scalars": torch.from_numpy(sc)},
                            torch.from_numpy(sc), torch.from_numpy(table))
        assert dataclasses.asdict(out) == dataclasses.asdict(ref), f"frame {t}"
        departures += ref.lane_departure
    assert 0 < departures < 16
    assert len(seen["port"]) == 16 and all(a is b for a, b in zip(seen["port"], seen["jax"]))
    # without a table (no longitudinal program), only the lateral fields
    ref = jeng._harvest(99, None, {"scalars": sc}, None)
    out = teng._harvest(99, None, {"scalars": sc}, torch.from_numpy(sc), None)
    assert dataclasses.asdict(out) == dataclasses.asdict(ref)
