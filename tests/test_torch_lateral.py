"""The port's lateral program (runtime/pipeline.py::build_lateral_step and
the modules under it) against the JAX package, on the CPU in f32.

Inputs, weights and the PathFinder noise are drawn with numpy / jax from
seeds and handed to both sides. Tolerances, and why:
- exact: ``solve3x3``, the lane-filter weight images and start points, every
  validity flag, the lane masks, ``H_BEV_TO_ORIG``'s bits, the config;
- the networks: atol 2e-4, rtol 1e-3 (tests/test_models_parity.py's bar);
- the lane-filter fit: coefficients within FIT_TOL * max|ref|. The fit
  solves f32 normal equations (condition ~1e4 on the normalized design)
  summed over up to 2,048 points, and the sums' order is the compiler's:
  the JAX function against itself, jitted and op by op, differs by up to
  1.3e-3 * max|ref| on these masks, so 1e-4 is out of reach of any other
  summation order (on a measured mask the port's fit and JAX's were about
  equally far from a float64 fit);
- PathFinder: PF_TOL. ``fit_quad_poly`` solves unnormalized f32 normal
  equations (y up to 30 m; condition up to ~2e6 on these points), whose
  sums XLA and PyTorch take in other orders: up to 6.7e-4 apart;
- the lane tracker: its coefficient vectors within COEFF_TOL * max|ref|;
  its metrics (offset, yaw and curvature of the fitted quadratics at the
  vehicle row, an extrapolation in BEV) within TRK_TOL * max(|ref|, 1):
  they differentiate and extrapolate f32 refits of a few points (up to
  0.8 % apart on the offset at the test geometry; the 24x48 center fit is
  so ill-conditioned that JAX and the port agree bit for bit and are both
  far from a float64 solve);
- the whole step: flags, AutoSteer's angle and masks exactly, the lane
  fits at FIT_TOL, and PathFinder's and the controller's scalars within
  twice the distance between JAX's own jitted and op-by-op runs plus
  STEP_TOL * max(|ref|, 1): at the test geometry PathFinder's f32 fit has
  a condition number of ~5e11 and JAX's two runs part by >100 m in cte
  (``assert_step_matches``).
"""
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from autoware_vision_pilot_tpu.control import steering as jst
from autoware_vision_pilot_tpu.convert.torch_import import flatten_params, import_state_dict
from autoware_vision_pilot_tpu.models.auto_steer_temporal import AutoSteerTemporalNet as JSteer
from autoware_vision_pilot_tpu.models.auto_steer_temporal import steering_from_logits as j_sfl
from autoware_vision_pilot_tpu.models.efficientnet import B0_DRYRUN_STAGES as J_DRYRUN
from autoware_vision_pilot_tpu.models.ego_lanes import EgoLanesNetwork as JLanes
from autoware_vision_pilot_tpu.ops.preprocess import preprocess_imagenet as j_preprocess
from autoware_vision_pilot_tpu.ops.smallsolve import solve3x3 as j_solve3x3
from autoware_vision_pilot_tpu.perception import lane_filter as jlf
from autoware_vision_pilot_tpu.perception import lane_tracker as jlt
from autoware_vision_pilot_tpu.perception import path_finder as jpf
from autoware_vision_pilot_tpu.runtime import config as jconfig
from autoware_vision_pilot_tpu.runtime import pipeline as jpipe

from autoware_vision_pilot_tpu_torch.control import steering as tst
from autoware_vision_pilot_tpu_torch.models.auto_steer_temporal import (
    AutoSteerTemporalNet, steering_from_logits)
from autoware_vision_pilot_tpu_torch.models.efficientnet import B0_DRYRUN_STAGES
from autoware_vision_pilot_tpu_torch.ops.kernels import lane_filter_kernel
from autoware_vision_pilot_tpu_torch.ops.kernels.lane_filter_kernel import lane_filter_walk
from autoware_vision_pilot_tpu_torch.ops.preprocess import preprocess_imagenet
from autoware_vision_pilot_tpu_torch.ops.smallsolve import solve3x3
from autoware_vision_pilot_tpu_torch.perception import lane_filter as tlf
from autoware_vision_pilot_tpu_torch.perception import lane_tracker as tlt
from autoware_vision_pilot_tpu_torch.perception import path_finder as tpf
from autoware_vision_pilot_tpu_torch.runtime import config as tconfig
from autoware_vision_pilot_tpu_torch.runtime.pipeline import (
    SCALAR_FIELDS, build_lateral_pipeline)

from test_lane_filter import make_lane_masks
from test_torch_layers import ATOL, RTOL, port_with, seeded_variables

REPO = Path(__file__).resolve().parents[1]
FIT_TOL = 5e-3
COEFF_TOL = 1e-4
PF_TOL = 2e-3
TRK_TOL = 2e-2
STEP_TOL = 2e-2
# tests/test_fleet_fast.py's geometry
NET_HW, FRAME_HW, CROP_Y, MASK_HW = (96, 192), (120, 200), 20, (24, 48)
CPU = torch.device("cpu")


def t(a):
    return torch.from_numpy(np.array(a))


def n(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


# ---------- small solve, steering, PathFinder ----------

def test_solve3x3_is_bit_equal_to_jax():
    rng = np.random.default_rng(0)
    A = rng.standard_normal((64, 3, 3)).astype(np.float32) + 3 * np.eye(3, dtype=np.float32)
    b = rng.standard_normal((64, 3)).astype(np.float32)
    ref = np.stack([np.asarray(j_solve3x3(jnp.asarray(A[i]), jnp.asarray(b[i])))
                    for i in range(len(A))])
    out = solve3x3(t(A), t(b)).numpy()
    np.testing.assert_array_equal(out, ref)
    sing = np.zeros((3, 3), np.float32)
    assert not np.isfinite(solve3x3(t(sing), t(b[0])).numpy()).any()


def test_steering_step_matches_jax():
    """A sequence with the valid flags toggled: angle, filtered mean and the
    ring state, tick by tick."""
    rng = np.random.default_rng(1)
    K = (0.33, 0.01, -0.40, -0.3)
    js, ts = jst.steering_init(), tst.steering_init(CPU)
    for i in range(16):
        cte, yaw, ff = rng.standard_normal(3).astype(np.float32) * [1.0, 5.0, 0.1]
        fused, bev = bool(i % 3 != 1), bool(i % 5 != 3)
        jf, ja, js = jst.steering_step(js, jnp.float32(cte), jnp.float32(yaw), jnp.float32(ff),
                                       *K, fused_valid=jnp.bool_(fused),
                                       bev_valid=jnp.bool_(bev))
        tf, ta, ts = tst.steering_step(ts, t(np.float32(cte)), t(np.float32(yaw)),
                                       t(np.float32(ff)), *K, fused_valid=t(fused),
                                       bev_valid=t(bev))
        np.testing.assert_allclose([n(tf), n(ta)], [np.asarray(jf), np.asarray(ja)],
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(n(ts.ring), np.asarray(js.ring), rtol=1e-6, atol=1e-6)
        assert int(ts.ring_len) == int(js.ring_len)
        assert float(ts.prev_yaw_error) == float(js.prev_yaw_error)
    assert int(ts.ring_len) == 10


def test_host_steering_classes_match_jax():
    jc, tc = jst.SteeringController(0.33, 0.01, -0.4, -0.3), tst.SteeringController(0.33, 0.01, -0.4, -0.3)
    jfl, tfl = jst.SteeringFilter(), tst.SteeringFilter()
    for v in np.linspace(-3, 3, 13):
        a = jc.compute_steering(v, 2 * v, 0.1)
        assert tc.compute_steering(v, 2 * v, 0.1) == a
        assert tfl.filter(a) == jfl.filter(a)


def bayes_pair(seed):
    rng = np.random.default_rng(seed)
    mean = rng.standard_normal(jpf.STATE_DIM).astype(np.float32)
    var = rng.uniform(0.01, 4.0, jpf.STATE_DIM).astype(np.float32)
    var[4] = 0.0  # a non-positive variance drops out of its fusion group
    meas = rng.standard_normal(jpf.STATE_DIM).astype(np.float32)
    meas[[0, 3, 8, 13]] = np.nan
    mvar = rng.uniform(0.001, 1.0, jpf.STATE_DIM).astype(np.float32)
    return mean, var, meas, mvar


def test_bayes_update_matches_jax():
    mean, var, meas, mvar = bayes_pair(2)
    ref = jpf.bayes_update(jpf.BayesState(jnp.asarray(mean), jnp.asarray(var)),
                           jnp.asarray(meas), jnp.asarray(mvar))
    out = tpf.bayes_update(tpf.BayesState(t(mean), t(var)), t(meas), t(mvar))
    for a, b in zip(out, ref):
        np.testing.assert_allclose(n(a), np.asarray(b), rtol=1e-6, atol=0)
    init = tpf.BayesState.init(device=CPU)
    for a, b in zip(init, jpf.BayesState.init()):
        np.testing.assert_array_equal(n(a), np.asarray(b))


def bev_points(seed, n_valid):
    rng = np.random.default_rng(seed)
    y = np.linspace(0.5, 30.0, tlt.MAX_PTS).astype(np.float32)
    x = (0.002 * y * y - 0.05 * y + 1.7 + 0.01 * rng.standard_normal(y.shape)).astype(np.float32)
    mask = np.zeros(tlt.MAX_PTS, bool)
    mask[:n_valid] = True
    return np.stack([x, y], -1), mask


@pytest.mark.parametrize("n_valid", [0, 2, 3, 40, 256])
def test_fit_quad_poly_matches_jax(n_valid):
    """Fewer than 3 points -> NaN on both sides, kept as NaN."""
    pts, mask = bev_points(3, n_valid)
    ref = np.asarray(jpf.fit_quad_poly(jnp.asarray(pts), jnp.asarray(mask)))
    out = tpf.fit_quad_poly(t(pts), t(mask)).numpy()
    np.testing.assert_array_equal(np.isnan(out), np.isnan(ref))
    assert np.isnan(out).all() == (n_valid < 3)
    assert_coeffs_close(out, ref, PF_TOL)


def jax_noise(key):
    """The JAX lateral step's PathFinder key and its draw from it, split
    from the state's key as the step splits it (runtime/pipeline.py:155,
    path_finder.py:115), and the next state's key."""
    _, k2, k3 = jax.random.split(key, 3)
    noise = jax.random.uniform(k2, (jpf.STATE_DIM,), minval=-1e-5, maxval=1e-5)
    return k2, np.asarray(noise), k3


def _same_nonfinite(a, b, msg):
    """NaN and inf in the same places with the same values; -> finite mask."""
    np.testing.assert_array_equal(np.where(np.isfinite(b), 0.0, a),
                                  np.where(np.isfinite(b), 0.0, b), err_msg=msg)
    return np.isfinite(b)


def assert_close_scaled(a, b, tol, msg=""):
    """|a - b| <= tol * max(|b|, 1) elementwise, non-finite values equal."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    ok = _same_nonfinite(a, b, msg)
    err = np.abs(a[ok] - b[ok]) / np.maximum(np.abs(b[ok]), 1.0)
    assert err.size == 0 or err.max() <= tol, f"{msg}: {err.max()!r} > {tol}"


def assert_coeffs_close(a, b, tol, msg=""):
    """Coefficient vectors within tol * max|ref| (finite entries of the last
    axis), non-finite values equal."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    ok = _same_nonfinite(a, b, msg)
    scale = np.max(np.where(ok, np.abs(b), 0.0), axis=-1, keepdims=True)
    err = np.abs(np.where(ok, a, 0.0) - np.where(ok, b, 0.0)) / np.maximum(scale, 1e-30)
    assert err.max() <= tol, f"{msg}: {err.max()!r} > {tol} * max|ref|"


def assert_fields_close(port, ref, tol, coeff_tol, what=""):
    """NamedTuples field by field: booleans exactly, coefficient vectors at
    ``coeff_tol`` * max|ref|, the rest at ``tol`` * max(|ref|, 1)."""
    for name, a, b in zip(ref._fields, port, ref):
        a, b = n(a), np.asarray(b)
        msg = f"{what}{name}"
        if b.dtype == bool:
            np.testing.assert_array_equal(a, b, err_msg=msg)
        elif "coeff" in name:
            assert_coeffs_close(a, b, coeff_tol, msg)
        else:
            assert_close_scaled(a, b, tol, msg)


@pytest.mark.parametrize("lanes", ["both", "left only", "none"])
def test_path_finder_update_matches_jax(lanes):
    """Three updates with the state carried and JAX's noise passed in."""
    lp, lm = bev_points(4, 60 if lanes != "none" else 0)
    rp, rm = bev_points(5, 60 if lanes == "both" else 1)
    rp[:, 0] += 3.5
    key = jax.random.key(6)
    js, ts = jpf.BayesState.init(), tpf.BayesState.init(device=CPU)
    for step in range(3):
        k2, noise, key = jax_noise(key)
        jo, js = jpf.path_finder_update(js, jnp.asarray(lp), jnp.asarray(lm), jnp.asarray(rp),
                                        jnp.asarray(rm), jnp.float32(0.05), k2)
        to, ts = tpf.path_finder_update(ts, t(lp), t(lm), t(rp), t(rm), t(np.float32(0.05)),
                                        noise=t(noise))
        assert_fields_close(to, jo, PF_TOL, PF_TOL, what=f"step {step}: ")
        assert_fields_close(ts, js, PF_TOL, PF_TOL, what=f"step {step} state: ")
    assert bool(to.left_valid) == (lanes != "none")
    assert bool(to.right_valid) == (lanes == "both")
    assert bool(to.fused_valid)
    with pytest.raises(ValueError):
        tpf.path_finder_update(ts, t(lp), t(lm), t(rp), t(rm), t(np.float32(0.05)))


# ---------- lane tracker ----------

def quad6(a, b, c, ymin, ymax):
    return np.asarray([0.0, a, b, c, ymin, ymax], np.float32)


def test_h_bev_to_orig_is_jax_bit_for_bit():
    np.testing.assert_array_equal(tlt.H_BEV_TO_ORIG.numpy().view(np.int32),
                                  np.asarray(jlt.H_BEV_TO_ORIG).view(np.int32))
    np.testing.assert_array_equal(tlt.H_ORIG_TO_BEV.numpy(), np.asarray(jlt.H_ORIG_TO_BEV))


# (left valid, right valid) per frame, the state carried: both lanes (the
# width history starts), recovery of each side, none
TRACKER_SEQUENCES = {
    "both": [(True, True), (True, True)],
    "recover left": [(True, True), (False, True)],
    "recover right": [(True, True), (True, False)],
    "none": [(False, False), (True, True), (False, False)],
}


@pytest.mark.parametrize("seq", list(TRACKER_SEQUENCES))
@pytest.mark.parametrize("model_hw,image_hw", [((80, 160), (640, 1280)),
                                               ((80, 160), (300, 1280)), (MASK_HW, (100, 200))])
def test_lane_tracker_update_matches_jax(seq, model_hw, image_hw):
    mh = model_hw[0]
    # tests/test_perception_control.py's lanes, scaled to the mask's width
    left = quad6(0.0, -0.1, model_hw[1] * 0.3125, mh / 2, mh - 1)
    right = quad6(0.0, 0.15, model_hw[1] * 0.625, mh / 2, mh - 1)
    js, ts = jlt.LaneTrackerState.init(), tlt.LaneTrackerState.init(CPU)
    for i, (lv, rv) in enumerate(TRACKER_SEQUENCES[seq]):
        jo, js = jlt.lane_tracker_update(jnp.asarray(left), jnp.bool_(lv), jnp.asarray(right),
                                         jnp.bool_(rv), js, model_hw=model_hw,
                                         image_hw=image_hw)
        to, ts = tlt.lane_tracker_update(t(left), t(lv), t(right), t(rv), ts,
                                         model_hw=model_hw, image_hw=image_hw)
        assert_fields_close(to, jo, TRK_TOL, COEFF_TOL, what=f"frame {i}: ")
        assert_fields_close(ts, js, TRK_TOL, COEFF_TOL, what=f"frame {i} state: ")
        pts = np.asarray(jo.bev_left_pts)
        np.testing.assert_array_equal(n(tlt.bev_pixels_to_meters(t(pts))),
                                      np.asarray(jlt.bev_pixels_to_meters(jnp.asarray(pts))))
        left[3] += 0.5
    assert bool(to.path_valid) == (seq != "none")


# ---------- lane filter ----------

def straight_left(y):
    return 50 - 0.1 * y


def straight_right(y):
    return 100 + 0.15 * y


def synthetic_masks(kind):
    """tests/test_lane_filter.py's synthetic lanes (80x160), stacked
    (H, W, 3) [ego_left, ego_right, other]."""
    if kind == "curved":
        el, er, ot = make_lane_masks(lambda y: 30 + 0.002 * (y - 40) ** 2,
                                     lambda y: 120 - 0.003 * (y - 40) ** 2, noise=10)
    elif kind == "noise":
        el, er, ot = make_lane_masks(straight_left, straight_right, noise=300)
    else:
        el, er, ot = make_lane_masks(straight_left, straight_right)
    if kind == "gaps":  # dashed lanes: 4 rows on, 4 off
        el[np.arange(80) % 8 < 4] = 0
        er[np.arange(80) % 8 >= 4] = 0
    elif kind == "other-lane fallback":  # the left lane only in the other mask above row 60
        ot[:60] = np.maximum(ot[:60], el[:60])
        el[:60] = 0
    elif kind == "one-sided":
        er[:] = 0
    elif kind == "empty":
        el[:], er[:], ot[:] = 0, 0, 0
    return np.stack([el, er, ot], -1)


def random_masks(hw, density, seed):
    return (np.random.default_rng(seed).random((*hw, 3)) < density).astype(np.float32)


LANE_FILTER_CASES = {
    **{k: lambda k=k: synthetic_masks(k) for k in
       ("straight", "curved", "gaps", "other-lane fallback", "noise", "one-sided", "empty")},
    **{f"random {d} {hw[0]}x{hw[1]}": (lambda d=d, hw=hw: random_masks(hw, d, int(d * 100) + hw[0]))
       for d in (0.03, 0.3, 0.6) for hw in ((80, 160), MASK_HW)},
}


def jax_lane_filter(masks, state):
    return jlf.lane_filter_update(jnp.asarray(masks[..., 0]), jnp.asarray(masks[..., 1]),
                                  jnp.asarray(masks[..., 2]), state, jax.random.key(0))


def port_state(state):
    return tlf.LaneFilterState(*(t(np.asarray(v)) for v in state))


@pytest.mark.parametrize("case", list(LANE_FILTER_CASES))
def test_lane_filter_update_matches_jax(case):
    """Two frames, the state carried (the second frame's lanes move): the
    weight images, start points and flags exactly, the fits at FIT_TOL."""
    masks = LANE_FILTER_CASES[case]()
    js = jlf.LaneFilterState.init()
    for frame in range(2):
        ts = port_state(js)
        ref = jax_lane_filter(masks, js)
        out = tlf.lane_filter_update(t(masks), ts)
        for i in (5, 6):  # weight images
            np.testing.assert_array_equal(n(out[i]), np.asarray(ref[i]))
        for i in (1, 3):  # validity
            assert bool(out[i]) == bool(ref[i])
        assert_coeffs_close(np.stack([n(out[0]), n(out[2])]),
                            np.stack([np.asarray(ref[0]), np.asarray(ref[2])]), FIT_TOL, case)
        for a, b in zip(out[4], ref[4]):
            if np.asarray(b).dtype == bool:
                assert bool(a) == bool(b)
            else:
                assert_coeffs_close(n(a), np.asarray(b), FIT_TOL, case)
        weights, starts = lane_filter_walk(t(masks))
        for side in (0, 1):
            jx, jy, jfound = jlf._find_start(jnp.asarray(masks[..., side]), side == 0,
                                             masks.shape[1])
            assert n(starts[side]).tolist() == [int(jx), int(jy), int(jfound)]
        js = ref[4]
        masks = np.roll(masks, 2, axis=1)
    if case in ("straight", "curved", "gaps", "other-lane fallback", "noise"):
        assert bool(out[1]) and bool(out[3])
    if case == "one-sided":
        assert bool(out[1]) and not bool(out[3])
    if case == "empty":
        assert not bool(out[1]) and not bool(out[3]) and not n(out[5]).any()


def test_lane_filter_walk_checks_its_input():
    masks = t(random_masks((16, 32), 0.3, 0))
    with pytest.raises(TypeError):
        lane_filter_walk(masks.double())
    with pytest.raises(ValueError):
        lane_filter_walk(masks[..., :2])
    with pytest.raises(ValueError):
        lane_filter_walk(masks.transpose(0, 1))
    weights, starts = lane_filter_walk(masks)
    assert (weights.shape, weights.dtype) == ((2, 16, 32), torch.int32)
    assert (starts.shape, starts.dtype) == ((2, 3), torch.int32)


@pytest.mark.parametrize("hw", [(320, 320), (4096, 25), (1, 320 * 320), (80, 160)])
def test_lane_filter_walk_limits_fit_the_kernel(hw):
    """The wrapper's limits on the card against the walk kernel's shared
    memory (csrc/lane_filter.cu): each of the 8 blocks stages its eighth of
    the masks (12 bytes a pixel, or its two 16-bit weight images, and 16
    bytes of skew), the two bitmasks with a word to spare, and the four
    walks' logs (12 bytes a step, a step per 4 rows) fit the 227 KB a block
    may have, less 1 KB."""
    H, W = hw
    assert H * W <= lane_filter_kernel.MAX_PIXELS and H <= lane_filter_kernel.MAX_ROWS
    nwr = -(-H * W // 32)
    pix = 32 * -(-nwr // 8)
    region = max(12 * pix + 16, 4 * (-(-pix // 2) * 2)) // 16 * 16 + 16
    assert region + 8 * (nwr + 1) + 48 * (H // 4) <= 227 * 1024 - 1024


# ---------- the networks, the weight bridge, the config ----------

@pytest.fixture(scope="module")
def steer_pair():
    """(JAX AutoSteer, its seeded variables, the port's with the same
    weights) for the test geometry's 24x48 masks."""
    jnet = JSteer(precision=lax.Precision.HIGHEST)
    v = seeded_variables(jnet, jax.ShapeDtypeStruct((1, *MASK_HW, 6), jnp.float32), seed=30)
    return jnet, v, port_with(AutoSteerTemporalNet(MASK_HW), v)


@pytest.mark.parametrize("mask_hw", [MASK_HW, (80, 160)])
def test_autosteer_matches_jax(mask_hw):
    jnet = JSteer(precision=lax.Precision.HIGHEST)
    v = seeded_variables(jnet, jax.ShapeDtypeStruct((1, *mask_hw, 6), jnp.float32), seed=31)
    port = port_with(AutoSteerTemporalNet(mask_hw), v)
    x = np.random.default_rng(32).standard_normal((2, *mask_hw, 6)).astype(np.float32)
    jprev, jcurr = jnet.apply(v, jnp.asarray(x))
    prev, curr = port(t(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(prev.detach().numpy(), np.asarray(jprev), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(curr.detach().numpy(), np.asarray(jcurr), atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(steering_from_logits(curr).numpy(), np.asarray(j_sfl(jcurr)))


def test_autosteer_weight_bridge_round_trip(steer_pair):
    """JAX variables -> from_jax -> the port's state_dict() -> the JAX
    package's own torch importer (strict) -> the same bits; fc's rows stay
    in the (h, w, c) order of the JAX flatten."""
    _, v, port = steer_pair
    sd = {k: t.numpy() for k, t in port.state_dict().items()}
    assert set(sd) == {f"{m}.{p}" for m in ("c1", "c2", "c3", "c4", "c5", "fc",
                                            "head_prev", "head_curr")
                       for p in ("weight", "bias")}
    back = import_state_dict(v, sd, strict=True)
    a, b = flatten_params(v["params"]), flatten_params(back["params"])
    assert a.keys() == b.keys()
    for k in a:
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k


@pytest.fixture(scope="module")
def lanes_pair():
    """(JAX EgoLanes at dryrun depth, its seeded variables, the port's with
    the same weights) for the test geometry's 96x192 input."""
    jnet = JLanes(ctx_hw=(3, 6), backbone_stages=J_DRYRUN, precision=lax.Precision.HIGHEST)
    v = seeded_variables(jnet, jax.ShapeDtypeStruct((1, *NET_HW, 3), jnp.float32), seed=33)
    from autoware_vision_pilot_tpu_torch.models.ego_lanes import EgoLanesNetwork
    return jnet, v, port_with(EgoLanesNetwork((3, 6), B0_DRYRUN_STAGES), v)


RANDOM_FRAMES = np.random.default_rng(36).integers(0, 256, (5, *FRAME_HW, 3), np.uint8)


@pytest.fixture(scope="module")
def jax_lane_logits(lanes_pair):
    """JAX's EgoLanes logits of RANDOM_FRAMES, (5, 24, 48, 3), computed as
    the JAX lateral step computes them (crop, preprocess_imagenet, apply)."""
    jnet, v, _ = lanes_pair
    logits = jax.jit(lambda v, f: jnet.apply(v, j_preprocess(f[:, CROP_Y:], NET_HW)))
    return np.asarray(logits(v, jnp.asarray(RANDOM_FRAMES)))


def test_ego_lanes_on_the_lateral_input_matches_jax(lanes_pair, jax_lane_logits):
    """EgoLanes at the test size on the cropped frames, each side through
    its own preprocess (the resize gap is 4.9e-5 here, below)."""
    port = lanes_pair[2]
    x = preprocess_imagenet(t(RANDOM_FRAMES[:, CROP_Y:]), NET_HW)
    out = port(x.permute(0, 3, 1, 2)).detach().permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(out, jax_lane_logits, atol=ATOL, rtol=RTOL)


# The lateral step's resize: the JAX step calls preprocess_imagenet
# (jax.image.resize, weights derived in f32), the port the preprocess
# kernel, whose taps follow the Pallas kernel's float64 arithmetic. Measured
# after normalisation: at the production crop 300x1280 -> 320x640 (an
# upsample in rows, whose first source coordinate is negative and clamps)
# the two agree exactly; at the test geometry 100x200 -> 96x192 they differ
# by up to 4.9e-5 (and by 3.2e-4 at 375x1242 -> 320x640). The bars: exact,
# and twice the measured gap.
PREPROCESS_GAP = {((300, 1280), (320, 640)): 0.0, ((100, 200), (96, 192)): 1e-4}


@pytest.mark.parametrize("src,dst", list(PREPROCESS_GAP))
def test_lateral_resize_gap_to_jax(src, dst):
    frame = np.random.default_rng(35).integers(0, 256, (*src, 3), np.uint8)
    ref = np.asarray(j_preprocess(jnp.asarray(frame)[None], dst))
    out = preprocess_imagenet(t(frame)[None], dst).numpy()
    gap = np.abs(out - ref).max()
    assert gap <= PREPROCESS_GAP[(src, dst)], gap


def test_config_matches_jax(tmp_path):
    path = REPO / "configs" / "visionpilot.conf.example"
    assert dataclasses.asdict(tconfig.load_config(path)) == \
        dataclasses.asdict(jconfig.load_config(path))
    assert dataclasses.asdict(tconfig.Config()) == dataclasses.asdict(jconfig.Config())
    text = ("# c\nmodels.egolanes.threshold = 0.25 # thr\nmodels.egolanes.precision=f32\n"
            "steering_control.Kd=-1.5\nbad line\noutput.enable_viz=yes\n")
    assert tconfig.parse_conf(text) == jconfig.parse_conf(text)
    conf = tmp_path / "x.conf"
    conf.write_text(text)
    assert dataclasses.asdict(tconfig.load_config(conf)) == \
        dataclasses.asdict(jconfig.load_config(conf))


# ---------- the whole step ----------

class GivenLogits:
    """A stand-in for EgoLanes in the JAX step: ``apply`` returns the lane
    logits passed as its variables."""

    def apply(self, logits, x):
        return logits


def lane_logits(left, right):
    """Synthetic EgoLanes logits at 24x48, +1 on 3-pixel-wide lanes x = f(y)
    (rows 3..23) and -1 elsewhere; a lane given as None is absent."""
    out = -np.ones((*MASK_HW, 3), np.float32)
    for c, fn in ((0, left), (1, right)):
        if fn is None:
            continue
        for y in range(3, MASK_HW[0]):
            x = int(round(fn(y)))
            out[y, max(0, x - 1):x + 2, c] = 1.0
    return out[None]


# frames of the synthetic sequence: both lanes (valid fits, the width
# history starts), each side missing in turn (recovery), both again
SYNTHETIC = [(lambda y: 15 - 0.1 * y, lambda y: 33 + 0.12 * y),
             (lambda y: 16 - 0.1 * y, lambda y: 34 + 0.12 * y),
             (None, lambda y: 34 + 0.12 * y),
             (lambda y: 15 - 0.1 * y, None),
             (lambda y: 15 - 0.12 * y, lambda y: 33 + 0.1 * y)]


@pytest.fixture(scope="module")
def jax_steps(steer_pair):
    """The JAX lateral step at the test geometry with given lane logits in
    place of its EgoLanes: jitted, as the JAX pipelines run it, and called
    without jit, so that its ops run one by one (``lane_filter_update`` is
    jitted by its own decorator either way)."""
    _, sv, _ = steer_pair
    kw = dict(frame_hw=FRAME_HW, crop_y=CROP_Y, dtype=jnp.float32, net_hw=NET_HW)

    def given_step(frame, state, logits):
        return jpipe.build_lateral_step(logits, sv, jconfig.Config(), lanes_net=GivenLogits(),
                                        **kw)(frame, state)

    return jax.jit(given_step), given_step


def run_hooked(jax_steps, port_pipe, steer_vars, frames, given):
    """The JAX step, with ``given`` lane logits, and the port's over
    ``frames``, their states carried; the port's EgoLanes and AutoSteer
    return JAX's logits (forward hooks) and its PathFinder takes JAX's
    noise. JAX's step also runs op by op, carrying its own state. ->
    [(port outputs, JAX outputs, JAX op-by-op outputs, port state, JAX
    state)] per frame."""
    given_step, op_by_op = jax_steps
    jsteer = JSteer()
    js = es = jpipe.init_lateral_state(seed=0, mask_hw=MASK_HW)
    ps = port_pipe.init_state(seed=0)
    forced = {}
    hooks = [port_pipe.lanes.register_forward_hook(lambda m, a, y: forced["lanes"]),
             port_pipe.steer_net.register_forward_hook(lambda m, a, y: forced["steer"])]
    results = []
    try:
        for i, frame in enumerate(frames):
            f, logits = jnp.asarray(frame), jnp.asarray(given[i][None])
            jout, jnew = given_step(f, js, logits)
            eout, es = op_by_op(f, es, logits)
            stacked = np.concatenate([np.asarray(js.prev_lane_raw), given[i]], -1)[None]
            prev, curr = jsteer.apply(steer_vars, jnp.asarray(stacked))
            forced["lanes"] = t(given[i])[None].permute(0, 3, 1, 2)
            forced["steer"] = (t(np.asarray(prev)), t(np.asarray(curr)))
            _, noise, _ = jax_noise(js.key)
            pout, ps = port_pipe(t(frame), ps, noise=t(noise))
            results.append((pout, jout, eout, ps, jnew))
            js = jnew
    finally:
        for h in hooks:
            h.remove()
    return results


def assert_step_matches(results):
    """Flags, AutoSteer's angle and the lane masks exactly; the (3, 6) lane
    fits at FIT_TOL * max|ref|; the other scalars (PathFinder's and the
    controller's) within twice the distance of JAX's op-by-op sequence from
    its jitted one, plus STEP_TOL * max(|ref|, 1). At this geometry PathFinder
    fits a few BEV points ~15 m behind the vehicle, a 1 m span, in f32
    without normalising y (condition ~4e11), and JAX's two runs of the
    same step can part by more than 100 m in cte."""
    flags = [SCALAR_FIELDS.index(f) for f in ("autosteer_deg", "fused_valid", "path_valid")]
    for i, (pout, jout, eout, ps, js) in enumerate(results):
        got, ref = n(pout["scalars"]).astype(np.float64), np.asarray(jout["scalars"], np.float64)
        spread = np.abs(np.asarray(eout["scalars"], np.float64) - ref)
        np.testing.assert_array_equal(got[flags], ref[flags], err_msg=f"frame {i}")
        np.testing.assert_array_equal(np.isnan(got), np.isnan(ref), err_msg=f"frame {i}")
        bar = 2 * spread + STEP_TOL * np.maximum(np.abs(ref), 1.0)
        bad = np.abs(got - ref) > bar
        assert not bad.any(), (f"frame {i}: {[SCALAR_FIELDS[k] for k in np.nonzero(bad)[0]]}"
                               f" port {got} JAX {ref} op by op {np.asarray(eout['scalars'])}")
        assert_coeffs_close(n(pout["coeffs"]), np.asarray(jout["coeffs"]), FIT_TOL,
                            f"frame {i} coeffs")
        np.testing.assert_array_equal(n(pout["lane_masks"]), np.asarray(jout["lane_masks"]))
        assert bool(ps.lane_filter.prev_left_valid) == bool(js.lane_filter.prev_left_valid)
        assert bool(ps.lane_filter.prev_right_valid) == bool(js.lane_filter.prev_right_valid)
        assert bool(ps.lane_tracker.has_width_history) == bool(js.lane_tracker.has_width_history)
        assert int(ps.steering.ring_len) == int(js.steering.ring_len)


@pytest.fixture(scope="module")
def port_pipe(lanes_pair, steer_pair):
    pipe = build_lateral_pipeline("cpu", torch.float32, frame_hw=FRAME_HW, crop_y=CROP_Y,
                                  net_hw=NET_HW, backbone_stages=B0_DRYRUN_STAGES)
    pipe.lanes.load_state_dict(lanes_pair[2].state_dict())
    pipe.steer_net.load_state_dict(steer_pair[2].state_dict())
    return pipe


def test_lateral_step_matches_jax(jax_steps, port_pipe, steer_pair, jax_lane_logits):
    """Five random frames; the lane logits are JAX's EgoLanes' on them."""
    results = run_hooked(jax_steps, port_pipe, steer_pair[1], RANDOM_FRAMES, jax_lane_logits)
    assert_step_matches(results)
    for pout, *_ in results:
        assert pout["scalars"].shape == (8,) and pout["coeffs"].shape == (3, 6)
        assert pout["lane_masks"].shape == (*MASK_HW, 3)


def test_lateral_step_on_synthetic_lanes_matches_jax(jax_steps, port_pipe, steer_pair):
    """Synthetic lane logits: valid fits, tracker recovery on each side,
    Bayes fusion and the steering ring are all reached."""
    frames = np.random.default_rng(37).integers(0, 256, (5, *FRAME_HW, 3), np.uint8)
    given = [lane_logits(*lanes)[0] for lanes in SYNTHETIC]
    results = run_hooked(jax_steps, port_pipe, steer_pair[1], frames, given)
    assert_step_matches(results)
    sc = np.stack([np.asarray(r[1]["scalars"]) for r in results])
    fused, path = SCALAR_FIELDS.index("fused_valid"), SCALAR_FIELDS.index("path_valid")
    assert (sc[:, path] == 1).all()  # frames 2 and 3 by recovery
    assert (sc[:, fused] == 1).all()
    states = [r[4] for r in results]
    # a side whose start point is missing drops its history
    assert [bool(s.lane_filter.prev_left_valid) for s in states] == [1, 1, 0, 1, 1]
    assert [bool(s.lane_filter.prev_right_valid) for s in states] == [1, 1, 1, 0, 1]
    assert bool(states[0].lane_tracker.has_width_history)
    assert int(states[-1].steering.ring_len) == 5
