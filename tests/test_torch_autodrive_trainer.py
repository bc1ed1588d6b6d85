"""The port's AutoDrive trainer and AutoDrive's train mode
(autoware_vision_pilot_tpu_torch/train/autodrive_trainer.py,
models/auto_drive.py) against the JAX package's, on the CPU in f32 at atol
2e-4, rtol 1e-3.

AutoDrive at 64x128, batch 2, two fit_steps from the same numpy-seeded
weights, its two dropout layers fed the same masks (tests/
test_torch_train_step.py::Masks): plainly, and with ``qat`` (int8
fake-quant of every parameter, straight-through) and ``freeze_backbone``
(optax's set_to_zero: the backbone neither moves nor decays) together;
the losses, every weight and BatchNorm statistic after the steps and the
head's first Adam moments. lr is 1e-4, the trainer's default. Then
warm_start_from_autospeed, fake_quant_int8 and its gradient, and the loss.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from autoware_vision_pilot_tpu.models import auto_drive as jad
from autoware_vision_pilot_tpu.models import auto_speed as jas
from autoware_vision_pilot_tpu.train import autodrive_trainer as jdt
from autoware_vision_pilot_tpu_torch.convert.from_jax import variables_to_state_dict
from autoware_vision_pilot_tpu_torch.models import auto_speed as tas
from autoware_vision_pilot_tpu_torch.nn import layers as tl
from autoware_vision_pilot_tpu_torch.train import autodrive_trainer as tdt

from test_torch_layers import ATOL, RTOL, seeded_variables
from test_torch_train_step import Masks, close, one_thread  # noqa: F401

HW, BATCH = (64, 128), 2


def batches():
    rng = np.random.default_rng(51)
    return [(rng.integers(0, 256, (BATCH, *HW, 3), dtype=np.uint8),
             rng.integers(0, 256, (BATCH, *HW, 3), dtype=np.uint8),
             rng.random(BATCH).astype(np.float32), rng.uniform(-1, 1, BATCH).astype(np.float32),
             (rng.random(BATCH) > 0.5).astype(np.float32)) for _ in range(2)]


@pytest.mark.parametrize("qat_frozen", [False, True])
def test_two_steps_match_jax(monkeypatch, qat_frozen):
    v = seeded_variables(jad.AutoDriveNetwork(*HW), jnp.zeros((1, *HW, 3)),
                         jnp.zeros((1, *HW, 3)), seed=52)
    monkeypatch.setattr(jad.AutoDriveNetwork, "init", lambda self, *a, **k: v)
    masks = Masks(53)
    monkeypatch.setattr(jax.random, "bernoulli", masks.jax)
    monkeypatch.setattr(tl, "keep_mask", masks.port)
    cfg = dict(input_hw=HW, qat=qat_frozen, freeze_backbone=qat_frozen)
    jtr = jdt.AutoDriveTrainer(jdt.AutoDriveTrainerConfig(**cfg))
    data = batches()
    jl = [jtr.fit_step(*b) for b in data]
    masks.frozen, masks.k = True, 0
    assert len(masks.masks) == 2  # the head's two dropouts
    ttr = tdt.AutoDriveTrainer(tdt.AutoDriveTrainerConfig(**cfg), variables=v, device="cpu")
    tl_ = [float(ttr.fit_step(*b)) for b in data]
    np.testing.assert_allclose(tl_, jl, atol=ATOL, rtol=RTOL)
    want = variables_to_state_dict({"params": jtr.params, "batch_stats": jtr.batch_stats},
                                   ttr.model)
    start = variables_to_state_dict(v, ttr.model)
    for k, t in ttr.model.state_dict().items():
        close(k, t, want[k])
        if qat_frozen and k.startswith("backbone.") and "running" not in k:
            assert torch.equal(t, start[k]), f"{k} moved: the backbone is frozen"
    adam = jtr.opt_state.inner_states["train"].inner_state[0] if qat_frozen \
        else jtr.opt_state[0]
    trained = {id(p) for g in ttr.state.optimizer.param_groups for p in g["params"]}
    # the frozen leaves are optax.MaskedNode in the state: fill them from the
    # weights to look the tree up by the port's names
    mu = variables_to_state_dict({"params": jax.tree.map(
        lambda m, w: w if isinstance(m, optax.MaskedNode) else np.asarray(m), adam.mu,
        jtr.params, is_leaf=lambda m: isinstance(m, optax.MaskedNode)),
        "batch_stats": jtr.batch_stats}, ttr.model)
    for n, p in ttr.model.named_parameters():
        if id(p) in trained:
            close(f"mu {n}", ttr.state.optimizer.state[p]["exp_avg"], mu[n])
    assert (len(trained) < len(list(ttr.model.parameters()))) == qat_frozen


def test_warm_start_from_autospeed_matches_jax(monkeypatch):
    v = seeded_variables(jad.AutoDriveNetwork(*HW), jnp.zeros((1, *HW, 3)),
                         jnp.zeros((1, *HW, 3)), seed=54)
    monkeypatch.setattr(jad.AutoDriveNetwork, "init", lambda self, *a, **k: v)
    src = seeded_variables(jas.AutoSpeedNetwork("n", 4, *HW), jnp.zeros((1, *HW, 3)), seed=55)
    jtr = jdt.AutoDriveTrainer(jdt.AutoDriveTrainerConfig(input_hw=HW))
    ttr = tdt.AutoDriveTrainer(tdt.AutoDriveTrainerConfig(input_hw=HW), variables=v,
                               device="cpu")
    net = tas.AutoSpeedNetwork("n", 4, *HW)
    net.load_state_dict(variables_to_state_dict(src, net))
    n = ttr.warm_start_from_autospeed(net.state_dict())
    assert n == jtr.warm_start_from_autospeed(src["params"]) and n > 0
    want = variables_to_state_dict({"params": jtr.params, "batch_stats": jtr.batch_stats},
                                   ttr.model)
    for k, t in ttr.model.state_dict().items():
        assert torch.equal(t, want[k]), k


def test_fake_quant_and_loss_match_jax():
    rng = np.random.default_rng(56)
    w = rng.normal(0, 0.3, (5, 7)).astype(np.float32)
    g = rng.normal(0, 1, (5, 7)).astype(np.float32)
    want, vjp = jax.vjp(jdt.fake_quant_int8, jnp.asarray(w))
    p = torch.from_numpy(w).requires_grad_(True)
    got = tdt.fake_quant_int8(p)
    got.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_array_equal(p.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]))
    outs = [rng.normal(0, 1, (4, 1)).astype(np.float32) for _ in range(3)]
    tg = [rng.random(4).astype(np.float32) for _ in range(3)]
    want, wparts = jdt.autodrive_loss(*(jnp.asarray(a) for a in outs + tg))
    got, parts = tdt.autodrive_loss(*(torch.from_numpy(a) for a in outs + tg))
    np.testing.assert_allclose(float(got), float(want), atol=ATOL, rtol=RTOL)
    for k in wparts:
        np.testing.assert_allclose(float(parts[k]), float(wparts[k]), atol=ATOL, rtol=RTOL)
