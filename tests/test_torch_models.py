"""The port's networks and decoder components against the JAX package's
(models/efficientnet.py, components.py, multitask.py, ego_lanes.py), on the
CPU in f32 at 64x128 with ctx_hw=(2, 4). Tolerance: atol 2e-4, rtol 1e-3
(see test_torch_layers.py)."""
import jax
import numpy as np
import pytest
import torch

from autoware_vision_pilot_tpu.models import components as jc
from autoware_vision_pilot_tpu.models import efficientnet as je
from autoware_vision_pilot_tpu.models.ego_lanes import EgoLanesNetwork as JEgoLanes
from autoware_vision_pilot_tpu.models.multitask import (
    SharedPerceptionStack as JStack)
from autoware_vision_pilot_tpu_torch.models import components as tc
from autoware_vision_pilot_tpu_torch.models import efficientnet as te
from autoware_vision_pilot_tpu_torch.models.ego_lanes import EgoLanesNetwork
from autoware_vision_pilot_tpu_torch.models.multitask import SharedPerceptionStack

from test_torch_layers import (P, assert_close, normal_input, port_with,
                               seeded_variables, to_port)

IMAGE = (1, 64, 128, 3)
IMAGE_SPEC = jax.ShapeDtypeStruct(IMAGE, np.float32)
# B0 pyramid of a 64x128 image: strides 2/4/8/16/32
PYRAMID = [(1, 32, 64, 32), (1, 16, 32, 24), (1, 8, 16, 40), (1, 4, 8, 80),
           (1, 2, 4, 1280)]


def pyramid(seed):
    return [normal_input(s, seed=seed + i) for i, s in enumerate(PYRAMID)]


def run_both(jmod, port, *inputs, seed=0):
    """Seed JAX variables for ``jmod``, load them into ``port``, apply both
    to the same numpy inputs -> (port output, JAX output)."""
    v = seeded_variables(jmod, *inputs, seed=seed)
    port_with(port, v)
    with torch.no_grad():
        y = port(*[[to_port(a) for a in x] if isinstance(x, list) else to_port(x)
                   for x in inputs])
    return y, jax.jit(jmod.apply)(v, *inputs)


def assert_all_close(ys, refs):
    assert len(ys) == len(refs)
    for y, r in zip(ys, refs):
        assert y.shape == tuple(np.asarray(r).shape[i] for i in (0, 3, 1, 2))
        assert_close(y, r)


@pytest.mark.parametrize("stages", ["dryrun", "full"])
def test_efficientnet_b0_features(stages):
    st = {"dryrun": (je.B0_DRYRUN_STAGES, te.B0_DRYRUN_STAGES),
          "full": (je.B0_STAGES, te.B0_STAGES)}[stages]
    assert st[0] == st[1]
    x = normal_input(IMAGE, seed=1)
    feats, ref = run_both(je.EfficientNetB0Features(stages=st[0], precision=P),
                          te.EfficientNetB0Features(st[1]), x, seed=2)
    assert [f.shape[1] for f in feats] == [32, 24, 40, 80, 1280]
    assert_all_close(feats, ref)


def test_context_block():
    x = normal_input((2, 2, 4, 96), seed=3)
    y, ref = run_both(jc.ContextBlock(96, 2, 4, precision=P),
                      tc.ContextBlock(96, 2, 4), x, seed=4)
    assert_close(y, ref)


def test_uneck():
    f = pyramid(5)
    ctx = normal_input((1, 2, 4, 96), seed=6)
    y, ref = run_both(jc.UNeck(96, precision=P), tc.UNeck(96), ctx, f, seed=7)
    assert y.shape == (1, 256, 16, 32)
    assert_close(y, ref)


@pytest.mark.parametrize("head", ["seg3", "domain1", "depth"])
def test_heads(head):
    f = pyramid(8)
    neck = normal_input((1, 16, 32, 256), seed=9)
    jmod, port = {
        "seg3": (jc.SegHead(3, precision=P), tc.SegHead(3)),
        "domain1": (jc.SegHead(1, precision=P), tc.SegHead(1)),
        "depth": (jc.DepthHead(precision=P), tc.DepthHead()),
    }[head]
    y, ref = run_both(jmod, port, neck, f, seed=10)
    assert y.shape[2:] == (64, 128)
    assert_close(y, ref)


def test_backbone_feature_fusion():
    f = pyramid(11)
    y, ref = run_both(jc.BackboneFeatureFusion(), tc.BackboneFeatureFusion(), f)
    assert y.shape == (1, 1456, 2, 4)
    assert_close(y, ref, atol=0, rtol=0)


def test_ego_lanes_head():
    neck = normal_input((1, 16, 32, 256), seed=12)
    y, ref = run_both(jc.EgoLanesHead(precision=P), tc.EgoLanesHead(), neck,
                      seed=13)
    assert_close(y, ref)


@pytest.mark.parametrize("stages", ["dryrun", "full"])
def test_ego_lanes_network(stages):
    st = je.B0_DRYRUN_STAGES if stages == "dryrun" else None
    x = normal_input(IMAGE, seed=14)
    y, ref = run_both(JEgoLanes(ctx_hw=(2, 4), backbone_stages=st, precision=P),
                      EgoLanesNetwork((2, 4), st), x, seed=15)
    assert y.shape == (1, 3, 16, 32)
    assert_close(y, ref)


@pytest.fixture(scope="module")
def stack_variables():
    """Seeded variables of the stack with the domain head; without it, the
    same tree less ``DomainSegHead``."""
    return seeded_variables(JStack(ctx_hw=(2, 4), with_domain=True), IMAGE_SPEC,
                            seed=17)


@pytest.mark.parametrize("with_domain", [False, True])
def test_shared_perception_stack(with_domain, stack_variables):
    v = stack_variables
    if not with_domain:
        v = dict(v, params={k: t for k, t in v["params"].items()
                            if k != "DomainSegHead"})
    x = normal_input(IMAGE, seed=16)
    refs = jax.jit(JStack(ctx_hw=(2, 4), with_domain=with_domain,
                          precision=P).apply)(v, x)
    port = port_with(SharedPerceptionStack((2, 4), with_domain), v)
    with torch.no_grad():
        ys = port(to_port(x))
    assert (ys[2] is None) == (not with_domain) == (refs[2] is None)
    assert [tuple(y.shape) for y in ys if y is not None] == (
        [(1, 3, 64, 128), (1, 1, 64, 128)] + [(1, 1, 64, 128)] * with_domain)
    assert_all_close([y for y in ys if y is not None],
                     [r for r in refs if r is not None])
