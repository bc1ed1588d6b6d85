"""The port's main path as a whole against the JAX chain it ports
(bench.py::build_pipeline_fused's body), the weight bridge, and the rule
that the port never imports JAX.

A 144x256 uint8 frame -> out_hw (64, 128), ctx_hw (2, 4), full-width and
full-depth networks, f32 on the CPU. Logits agree at atol 2e-4, rtol 1e-3;
masks are equal except where the decision is within 1e-4 of a tie.
"""
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from autoware_vision_pilot_tpu.convert.torch_import import flatten_params, import_state_dict
from autoware_vision_pilot_tpu.models.ego_lanes import EgoLanesNetwork as JEgoLanes
from autoware_vision_pilot_tpu.models.multitask import SharedPerceptionStack as JStack
from autoware_vision_pilot_tpu.ops import (argmax_mask, depth_minmax_scale,
                                           preprocess_imagenet, threshold_channels)
from autoware_vision_pilot_tpu_torch.convert.from_jax import variables_to_state_dict
from autoware_vision_pilot_tpu_torch.pipeline import build_pipeline_fused

from test_torch_layers import ATOL, RTOL, seeded_variables

REPO = Path(__file__).resolve().parents[1]
OUT_HW, CTX_HW = (64, 128), (2, 4)
TIE = 1e-4


@pytest.fixture(scope="module")
def jax_nets():
    """(stack, stack variables, lanes, lanes variables), seeded."""
    x = jax.ShapeDtypeStruct((1, *OUT_HW, 3), jnp.float32)
    stack = JStack(ctx_hw=CTX_HW, with_domain=False,
                   precision=lax.Precision.HIGHEST)
    lanes = JEgoLanes(ctx_hw=CTX_HW, precision=lax.Precision.HIGHEST)
    return (stack, seeded_variables(stack, x, seed=20),
            lanes, seeded_variables(lanes, x, seed=21))


@pytest.fixture(scope="module")
def pipe():
    """The port's main path on the CPU in f32, at the test size."""
    return build_pipeline_fused("cpu", torch.float32, seed=0, ctx_hw=CTX_HW,
                                out_hw=OUT_HW)


def test_main_path_matches_jax_chain(jax_nets, pipe):
    stack, sv, lanes, lv = jax_nets
    frame = np.random.default_rng(22).integers(0, 256, (144, 256, 3), np.uint8)

    @jax.jit
    def jax_chain(sv, lv, frame_u8):  # bench.py:129-135 in f32
        x = preprocess_imagenet(frame_u8[None], OUT_HW, dtype=jnp.float32)
        seg, depth, _ = stack.apply(sv, x)
        lane_logits = lanes.apply(lv, x)
        return (seg, depth, lane_logits, argmax_mask(seg),
                depth_minmax_scale(depth), threshold_channels(lane_logits))

    ref = [np.asarray(a) for a in jax_chain(sv, lv, jnp.asarray(frame))]

    pipe.stack.load_state_dict(variables_to_state_dict(sv, pipe.stack))
    pipe.lanes.load_state_dict(variables_to_state_dict(lv, pipe.lanes))
    f = torch.from_numpy(frame)
    logits = [t.numpy() for t in pipe.logits(f)]
    mask, depth01, lane_masks = pipe(f)

    for got, want in zip(logits, ref[:3]):
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    assert (mask.shape, mask.dtype) == ((1, *OUT_HW), torch.int32)
    assert (depth01.shape, depth01.dtype) == ((1, *OUT_HW, 1), torch.float32)
    assert (lane_masks.shape, lane_masks.dtype) == ((1, 16, 32, 3), torch.float32)

    seg = np.sort(ref[0], axis=-1)
    decided = seg[..., -1] - seg[..., -2] > TIE
    np.testing.assert_array_equal(mask.numpy()[decided], ref[3][decided])
    assert decided.mean() > 0.99
    lane_decided = np.abs(ref[2]) > TIE
    np.testing.assert_array_equal(lane_masks.numpy()[lane_decided],
                                  ref[5][lane_decided])
    # min-max scaling divides the logits' error by the depth's range
    span = ref[1].max() - ref[1].min()
    np.testing.assert_allclose(depth01.numpy(), ref[4],
                               atol=2 * (ATOL + RTOL * np.abs(ref[1]).max()) / span)
    assert depth01.min() == 0 and depth01.max() == 1


def test_weight_bridge_round_trip_is_bit_exact(jax_nets, pipe):
    """JAX variables -> from_jax -> the port's state_dict() -> the JAX
    package's own torch importer (strict) -> the same bits: the port's keys
    are the reference torch layout that importer reads."""
    stack, sv, lanes, lv = jax_nets
    for module, v in ((pipe.stack, sv), (pipe.lanes, lv)):
        module.load_state_dict(variables_to_state_dict(v, module), strict=True)
        sd = {k: t.numpy() for k, t in module.state_dict().items()}
        back = import_state_dict(v, sd, strict=True)
        for col in ("params", "batch_stats"):
            a, b = flatten_params(v[col]), flatten_params(back[col])
            assert a.keys() == b.keys()
            for k in a:
                assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k


def test_bridge_rejects_a_tree_that_does_not_fit(jax_nets, pipe):
    stack, sv, _, lv = jax_nets
    with pytest.raises(KeyError):  # EgoLanes leaves have no place in the stack
        variables_to_state_dict(lv, pipe.stack)
    partial = {"params": dict(sv["params"]), "batch_stats": sv["batch_stats"]}
    del partial["params"]["SceneSegHead"]
    with pytest.raises(KeyError, match="no flax leaf"):
        variables_to_state_dict(partial, pipe.stack)


def test_seeded_pipeline_is_deterministic():
    kw = dict(ctx_hw=CTX_HW, out_hw=OUT_HW)
    a = build_pipeline_fused("cpu", torch.float32, seed=3, **kw)
    b = build_pipeline_fused("cpu", torch.float32, seed=3, **kw)
    c = build_pipeline_fused("cpu", torch.float32, seed=4, **kw)
    sa, sb, sc = (p.stack.state_dict() for p in (a, b, c))
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["SceneNeck.decode_layer_0.weight"],
                           sc["SceneNeck.decode_layer_0.weight"])
    w = a.lanes.state_dict()["BEVBackbone.encoder.0.0.weight"]
    assert w.is_contiguous(memory_format=torch.channels_last)


def test_port_never_imports_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import autoware_vision_pilot_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'autoware_vision_pilot_tpu')]\n"
        "assert not bad, bad\n"
        "assert len(names) >= 15, names\n"
        "print(len(names))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
