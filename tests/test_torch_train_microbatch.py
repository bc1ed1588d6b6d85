"""The port's train step with ``microbatches=2`` and stochastic depth
against the JAX package's, on the CPU in f32 at atol 2e-4, rtol 1e-3, with
the same masks on both sides (tests/test_torch_train_step.py has the
method).

SceneSeg at dryrun depth (B0_DRYRUN_STAGES, ctx_hw (2, 4)) on 64x128,
batch 2 in two microbatches, against JAX's scan. The dryrun trunk has no
residual block, so stochastic depth is held on a B0 trunk with two.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoware_vision_pilot_tpu.models import efficientnet as je
from autoware_vision_pilot_tpu_torch.models import efficientnet as te
from autoware_vision_pilot_tpu_torch.nn import layers as tl

from test_torch_layers import ATOL, RTOL, port_with, seeded_variables, to_port
from test_torch_train_step import (Masks, close, jax_tree, one_thread,  # noqa: F401
                                   run_both, state_dict_of)


@pytest.fixture(scope="module")
def scene_seg_mb2():
    with pytest.MonkeyPatch.context() as mp:
        return run_both(mp, "SceneSeg", 2, 1, False)


def test_microbatches_scan(scene_seg_mb2):
    """microbatches=2: each half through the net in order (the BN running
    statistics carried), the gradients averaged, one update."""
    model, jout, tout = scene_seg_mb2
    (jloss, jlogits, js), t = jout[0], tout[0]
    assert len(jlogits) == len(t["logits"]) == 2
    # JAX's callbacks from the unrolled scan come in no set order
    jlogits = sorted(jlogits, key=lambda a: -abs(np.asarray(a)
                                                 - t["logits"][0].permute(0, 2, 3, 1)
                                                 .numpy()).max())
    for a, b in zip(t["logits"], jlogits[::-1]):
        close("logits", a.permute(0, 2, 3, 1), b)
    assert np.isclose(t["loss"], jloss, atol=ATOL, rtol=RTOL)
    want = state_dict_of(js.params, js.batch_stats, model)
    for k, tensor in t["state"].items():
        close(k, tensor, want[k])
    grads = state_dict_of(jax.tree.map(lambda m: m / 0.1, js.opt_state[0].mu),
                          js.batch_stats, model)
    for name, g in t["grads"].items():
        close(f"grad {name}", g, grads[name])


# stages with residual blocks (the dryrun trunk has none): stochastic depth
# at rates 0.2 * 1/6 and 0.2 * 3/6
SD_STAGES = ((1, 16, 2, 1, 3), (6, 24, 2, 2, 3), (6, 40, 1, 2, 3), (6, 80, 1, 2, 3))


def test_stochastic_depth_trunk(monkeypatch):
    """The B0 trunk in train mode with residual blocks: features, input
    gradient and BN statistics against JAX with the same row masks."""
    x = np.random.default_rng(6).normal(0, 1, (4, 32, 64, 3)).astype(np.float32)
    jmod = je.EfficientNetB0Features(stages=SD_STAGES)
    v = seeded_variables(jmod, jnp.zeros((1, 32, 64, 3)), seed=7)
    masks = Masks(8)
    monkeypatch.setattr(jax.random, "bernoulli", masks.jax)
    monkeypatch.setattr(tl, "keep_mask", masks.port)

    def fwd(vv, xx):
        feats, mut = jmod.apply(vv, xx, train=True, mutable=["batch_stats"],
                                rngs={"dropout": jax.random.key(0)})
        return sum(jnp.sum(f * f) for f in feats), (feats, mut["batch_stats"])

    (_, (feats, bs)), gx = jax.jit(jax.value_and_grad(fwd, argnums=1, has_aux=True))(
        v, jnp.asarray(x))
    assert [m[:2] for m in masks.masks] == [((4, 1, 1, 1), 1 - 0.2 / 6),
                                            ((4, 1, 1, 1), 1 - 0.2 * 3 / 6)]
    masks.frozen, masks.k = True, 0
    port = port_with(te.EfficientNetB0Features(SD_STAGES), v).train()
    xt = to_port(x).requires_grad_(True)
    with tl.dropout_generator(torch.Generator()):
        out = port(xt)
    sum((f * f).sum() for f in out).backward()
    for a, b in zip(out, feats):
        close("features", a.permute(0, 2, 3, 1), b)
    close("input grad", xt.grad.permute(0, 2, 3, 1), gx)
    want = state_dict_of(v["params"], jax_tree(bs), port)
    for k, t in port.state_dict().items():
        close(k, t, want[k])
