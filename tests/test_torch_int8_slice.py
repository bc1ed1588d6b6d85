"""The selective-int8 slice as a whole, bench.py::build_pipeline_fused(
int8=True, min_ch=256) at full width and depth, against the JAX chain of
bench.py:129-135 with int8 variables, in f32 on the CPU (the port's int8
convs run the kernels' plain versions). A 72x128 frame -> out_hw (32, 64),
ctx_hw (1, 2); JAX quantizes and calibrates (2 noise batches), the bridge
carries the variables over.

Why two comparisons. The float layers between the int8 convs (BatchNorm,
SiLU, depthwise and float convs) agree with XLA's to ~3e-7 of their range,
not bit for bit. Sooner or later such a difference carries one activation
across a rounding boundary, one int8 value moves by one step, and every
int8 conv after it re-quantizes a slightly different map: the flips
multiply (measured here: 1 flip of 24,576 values at EgopathNeck.
decode_layer_2, 8,391 of 32,768 at EgoLanesHead.decode_layer_7), and the
free-running logits part by ~1-3 % of max|ref|. JAX itself moves its depth
logits by 1.6 % of max|ref| when its input is perturbed by 1e-7 relative.
So:

- ``test_int8_slice_matches_jax_chain`` runs the port's slice with each
  int8 conv fed the input JAX's conv saw (forward pre-hooks): every one of
  the 72 int8 convs must give JAX's output bit for bit, and the logits must
  agree within 5e-3 * max|ref|, the class and lane masks on >= 99.9 % of
  decided values.
- ``test_int8_slice_free_run_parts_only_at_rounding_boundaries`` runs it
  free: every int8 conv before the first flip sees an input within 1e-6 of
  its range of JAX's, the first flips are a handful (<= 1e-3 of the map),
  and it reports how far the outputs then part.

JAX runs op by op (eager apply), as nn/layers.py:81-121 is written: under
jit XLA:CPU contracts the dequant multiply and the bias add into one FMA
and lands one f32 ulp away (test_torch_int8.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoware_vision_pilot_tpu.export.quantize import (
    calibrate_int8_activation_scales as jax_calibrate,
    quantize_variables_for_int8_conv as jax_quantize)
from autoware_vision_pilot_tpu.models.ego_lanes import EgoLanesNetwork as JEgoLanes
from autoware_vision_pilot_tpu.models.multitask import SharedPerceptionStack as JStack
from autoware_vision_pilot_tpu.ops import argmax_mask, preprocess_imagenet
from autoware_vision_pilot_tpu_torch.convert.from_jax import (
    _merge_digits, variables_to_state_dict)
from autoware_vision_pilot_tpu_torch.export.quantize import (
    int8_conv_count, quantize_for_int8_conv)
from autoware_vision_pilot_tpu_torch.nn import layers as tl
from autoware_vision_pilot_tpu_torch.pipeline import build_pipeline_fused

from test_torch_layers import jax_int8_calls, port_int8_calls, seeded_variables
from test_torch_train_step import one_thread  # noqa: F401 (an autouse fixture)

OUT_HW, CTX_HW, MIN_CH = (32, 64), (1, 2), 256
TIE = 1e-4        # logits closer than this are undecided
DRIFT = 1e-6      # float drift of an int8 conv's input, relative to its range


@pytest.fixture(scope="module")
def int8_slice():
    """JAX and port int8 networks with the same quantized, calibrated
    variables; the JAX chain's logits and int8 conv calls on one frame; the
    port's, run free and run with JAX's int8 conv inputs."""
    x = jax.ShapeDtypeStruct((1, *OUT_HW, 3), jnp.float32)
    rng = np.random.default_rng(7)
    cal = [jnp.asarray(rng.normal(0.0, 1.0, x.shape), jnp.float32) for _ in range(2)]
    pipe = build_pipeline_fused("cpu", torch.float32, seed=0, ctx_hw=CTX_HW,
                                out_hw=OUT_HW)
    jmods = (JStack(ctx_hw=CTX_HW, with_domain=False), JEgoLanes(ctx_hw=CTX_HW))
    qvs = []
    for jmod, module, seed in zip(jmods, (pipe.stack, pipe.lanes), (40, 41)):
        qv = jax_calibrate(jmod, jax_quantize(seeded_variables(jmod, x, seed=seed),
                                              MIN_CH), cal)
        quantize_for_int8_conv(module, MIN_CH)
        for m in module.modules():  # static scales, ready for the tree's x_scale
            if isinstance(m, tl.Int8Conv2d):
                m.input_scale = torch.zeros(())
        module.load_state_dict(variables_to_state_dict(qv, module), strict=True)
        qvs.append(qv)

    frame = np.random.default_rng(42).integers(0, 256, (72, 128, 3), np.uint8)
    xj = preprocess_imagenet(jnp.asarray(frame)[None], OUT_HW, dtype=jnp.float32)
    (seg, depth, _), stack_calls = jax_int8_calls(jmods[0], qvs[0], xj)
    lanes, lanes_calls = jax_int8_calls(jmods[1], qvs[1], xj)
    ref = [np.asarray(a) for a in (seg, depth, lanes)]
    jax_calls = stack_calls + lanes_calls

    def run(forced):
        calls, remove = port_int8_calls(
            (pipe.stack, pipe.lanes), None if forced is None else [c[1] for c in forced])
        try:
            return [t.numpy() for t in pipe.logits(torch.from_numpy(frame))], calls
        finally:
            remove()

    return dict(pipe=pipe, qvs=qvs, ref=ref, jax_calls=jax_calls,
                free=run(None), forced=run(jax_calls))


def test_int8_conv_count_is_72(int8_slice):
    jax_counts = [sum(leaf.dtype == jnp.int8 for path, leaf in
                      jax.tree_util.tree_leaves_with_path(qv["params"])
                      if path[-1].key == "w") for qv in int8_slice["qvs"]]
    pipe = int8_slice["pipe"]
    port_counts = [int8_conv_count(pipe.stack), int8_conv_count(pipe.lanes)]
    assert jax_counts == port_counts == [41, 31]
    # and each network ran every one of them once, in JAX's order
    for calls in (int8_slice["jax_calls"], int8_slice["free"][1]):
        assert len(calls) == 72
    assert [_merge_digits(c[0]) for c in int8_slice["free"][1]] == \
        [c[0] for c in int8_slice["jax_calls"]]


def agreement(got, ref):
    """-> (share of decided class pixels, share of decided lane values)
    where the port picks what JAX picks, and the count that changed."""
    top = np.sort(ref[0], axis=-1)
    decided = top[..., -1] - top[..., -2] > TIE
    same = got[0].argmax(-1) == np.asarray(argmax_mask(jnp.asarray(ref[0])))
    lane_decided = np.abs(ref[2]) > TIE
    lanes_same = (got[2] > 0) == (ref[2] > 0)
    print(f"class mask: {int((~same & decided).sum())} of {int(decided.sum())} "
          f"decided pixels changed; lane masks: "
          f"{int((~lanes_same & lane_decided).sum())} of {int(lane_decided.sum())}")
    return same[decided].mean(), lanes_same[lane_decided].mean()


def test_int8_slice_matches_jax_chain(int8_slice):
    ref = int8_slice["ref"]
    got, calls = int8_slice["forced"]
    assert len(calls) == 72
    for (name, _, y, _), (path, _, want) in zip(calls, int8_slice["jax_calls"]):
        np.testing.assert_array_equal(y, want, err_msg=f"{name} ({path})")
    for name, a, b in zip(("seg", "depth", "lanes"), got, ref):
        assert a.shape == b.shape, name
        err = np.abs(a - b).max()
        print(f"{name}: max_abs_err {err}, {err / np.abs(b).max()} of max|ref|")
        assert err <= 5e-3 * np.abs(b).max(), name
    classes, lanes = agreement(got, ref)
    assert classes >= 0.999 and lanes >= 0.999


def test_int8_slice_free_run_parts_only_at_rounding_boundaries(int8_slice):
    got, calls = int8_slice["free"]
    flipped = False
    for (name, x, _, m), (_, xj, _) in zip(calls, int8_slice["jax_calls"]):
        sx = m.input_scale.numpy()
        flips = int((np.clip(np.round(x / sx), -127, 127)
                     != np.clip(np.round(xj / sx), -127, 127)).sum())
        drift = float(np.abs(x - xj).max() / np.abs(xj).max())
        print(f"{name} {x.shape}: input drift {drift:.2e} of its range, "
              f"{flips} of {x.size} int8 values changed")
        if not flipped:
            assert drift <= DRIFT, name
            assert flips <= 1e-3 * x.size, name
        flipped = flipped or flips > 0
    for name, a, b in zip(("seg", "depth", "lanes"), got, int8_slice["ref"]):
        assert a.shape == b.shape and np.isfinite(a).all(), name
        print(f"free run {name}: max_abs_err {np.abs(a - b).max()}, "
              f"{np.abs(a - b).max() / np.abs(b).max()} of max|ref|")
    agreement(got, int8_slice["ref"])
