"""The port's AutoSteer 2.0 and AutoSteer-temporal trainers
(autoware_vision_pilot_tpu_torch/train/autosteer_trainer.py,
autosteer_temporal_trainer.py) against the JAX package's, on the CPU in f32
at atol 2e-4, rtol 1e-3.

Both sides start from the same numpy-seeded weights (JAX's init returns
them, the port loads them) and take two fit_steps on the same batches:
the losses, the weights and BatchNorm statistics after them, the first
Adam moments, and AutoSteer's EMA; AutoSteer's validate and validate_map
on the same batch. AutoSteer runs at 64x1024 (its height branch needs
the full 1024 columns), batch 2; the temporal net at its 80x160 masks.
The temporal trainer's lr is 1e-5 so that Adam's sign on gradients that
are 0 but for rounding moves no weight past the bar.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from autoware_vision_pilot_tpu.models import auto_steer as jast
from autoware_vision_pilot_tpu.models import auto_steer_temporal as jtmp
from autoware_vision_pilot_tpu.train import autosteer_temporal_trainer as jtt
from autoware_vision_pilot_tpu.train import autosteer_trainer as jst
from autoware_vision_pilot_tpu_torch.convert.from_jax import variables_to_state_dict
from autoware_vision_pilot_tpu_torch.train import autosteer_temporal_trainer as ttt
from autoware_vision_pilot_tpu_torch.train import autosteer_trainer as tst

from test_torch_layers import ATOL, RTOL, seeded_variables
from test_torch_train_step import close, one_thread  # noqa: F401

STEER_HW, BATCH = (64, 1024), 2


def steer_batch(seed):
    rng = np.random.default_rng(seed)
    rows = STEER_HW[0] // 8
    images = rng.integers(0, 256, (BATCH, *STEER_HW, 3), dtype=np.uint8)
    t_h = (rng.random((BATCH, rows, 1, 1)) > 0.3).astype(np.float32)
    return images, (rng.random((BATCH, rows, 1, 1)) * t_h).astype(np.float32), t_h


def moments(jstate, tstate, model, batch_stats):
    want = variables_to_state_dict({"params": jax.tree.map(np.asarray, jstate.mu),
                                    "batch_stats": batch_stats}, model)
    for n, p in model.named_parameters():
        close(f"mu {n}", tstate.optimizer.state[p]["exp_avg"], want[n])


@pytest.fixture(scope="module")
def steer(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("steer")
    v = seeded_variables(jast.AutoSteerNetwork("n", *STEER_HW), jnp.zeros((1, *STEER_HW, 3)),
                         seed=31)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jast.AutoSteerNetwork, "init", lambda self, *a, **k: v)
        jtr = jst.AutoSteerTrainer(jst.AutoSteerTrainerConfig(input_hw=STEER_HW,
                                                              ckpt_dir=str(tmp / "j")))
    ttr = tst.AutoSteerTrainer(tst.AutoSteerTrainerConfig(input_hw=STEER_HW,
                                                          ckpt_dir=str(tmp / "t")),
                               variables=v, device="cpu")
    batches = [steer_batch(s) for s in (32, 33)]
    losses = [(jtr.fit_step(*b), float(ttr.fit_step(*b))) for b in batches]
    return jtr, ttr, batches, losses


def test_autosteer_two_steps_match_jax(steer):
    jtr, ttr, _, losses = steer
    np.testing.assert_allclose([t for _, t in losses], [j for j, _ in losses], atol=ATOL,
                               rtol=RTOL)
    want = variables_to_state_dict({"params": jtr.params, "batch_stats": jtr.batch_stats},
                                   ttr.model)
    for k, t in ttr.model.state_dict().items():
        close(k, t, want[k])
    moments(jtr.opt_state[0], ttr.state, ttr.model, jtr.batch_stats)
    ema = variables_to_state_dict({"params": jtr.ema_params, "batch_stats": jtr.batch_stats},
                                  ttr.model)
    for n, e in ttr.state.ema.items():
        close(f"ema {n}", e, ema[n])
    # the second update ran at the warm-up's schedule(1), in float32 as optax's
    want_lr = float(optax.warmup_cosine_decay_schedule(0.0, 1e-3, 500, 10000, 1e-5)(1))
    assert ttr.state.optimizer.param_groups[0]["lr"] == pytest.approx(want_lr, rel=1e-6)


def test_autosteer_validation_matches_jax(steer):
    jtr, ttr, batches, _ = steer
    val = [batches[0]]
    got, want = ttr.validate(iter(val)), jtr.validate(iter(val))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, err_msg=k)
    got, want = ttr.validate_map(iter(val)), jtr.validate_map(iter(val))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, err_msg=k)


def test_autosteer_loss_matches_jax():
    rng = np.random.default_rng(34)
    args = [rng.normal(0, 1, (2, 8, 1, 1)).astype(np.float32) for _ in range(3)]
    args.append((rng.random((2, 8, 1, 1)) > 0.5).astype(np.float32))
    want, wparts = jst.autosteer_loss(*(jnp.asarray(a) for a in args))
    got, parts = tst.autosteer_loss(*(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(float(got), float(want), atol=ATOL, rtol=RTOL)
    for k in wparts:
        np.testing.assert_allclose(float(parts[k]), float(wparts[k]), atol=ATOL, rtol=RTOL)


def test_autosteer_mesh_raises():
    """A mesh of one device trains and validates as mesh=None does, bit for
    bit (one step from seed 0)."""
    from autoware_vision_pilot_tpu_torch.core.mesh import make_mesh

    batch = steer_batch(37)
    runs = []
    for mesh in (None, make_mesh(devices=["cpu"])):
        tr = tst.AutoSteerTrainer(tst.AutoSteerTrainerConfig(input_hw=STEER_HW), mesh=mesh,
                                  device="cpu")
        runs.append((tr.fit_step(*batch), tr.model.state_dict(), tr.validate([batch])))
    (loss, want, metrics), (got_loss, got, got_metrics) = runs
    assert torch.equal(got_loss, loss)
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert got_metrics == metrics


def test_temporal_trainer_matches_jax(tmp_path, monkeypatch):
    v = seeded_variables(jtmp.AutoSteerTemporalNet(), jnp.zeros((1, 80, 160, 6)), seed=35)
    monkeypatch.setattr(jtmp.AutoSteerTemporalNet, "init", lambda self, *a, **k: v)
    cfg = dict(lr=1e-5, max_steps=10)
    jtr = jtt.AutoSteerTemporalTrainer(jtt.AutoSteerTemporalTrainerConfig(**cfg))
    ttr = ttt.AutoSteerTemporalTrainer(
        ttt.AutoSteerTemporalTrainerConfig(**cfg, ckpt_dir=str(tmp_path)), variables=v,
        device="cpu")
    rng = np.random.default_rng(36)
    for _ in range(2):
        masks = (rng.random((BATCH, 80, 160, 6)) > 0.8).astype(np.float32)
        prev, curr = rng.uniform(-35, 35, BATCH), rng.uniform(-35, 35, BATCH)
        np.testing.assert_allclose(float(ttr.fit_step(masks, prev, curr)),
                                   jtr.fit_step(masks, prev, curr), atol=ATOL, rtol=RTOL)
    want = variables_to_state_dict({"params": jtr.params}, ttr.model)
    for k, t in ttr.model.state_dict().items():
        close(k, t, want[k])
    moments(jtr.opt_state[0], ttr.state, ttr.model, {})
    assert ttr.state.optimizer.param_groups[0]["lr"] == ttr.schedule(1)
    ttr.save()
    assert (tmp_path / "last.msgpack").exists()


def test_angle_classes_and_smoothed_ce_match_jax():
    a = np.array([-40.0, -30.0, -0.5, 0.5, 1.5, 2.5, 29.6, 45.0], np.float32)
    np.testing.assert_array_equal(ttt.angle_to_class(torch.from_numpy(a)).numpy(),
                                  np.asarray(jtt.angle_to_class(jnp.asarray(a))))
    logits = np.random.default_rng(37).normal(0, 3, (4, 61)).astype(np.float32)
    ids = np.array([0, 17, 30, 60])
    np.testing.assert_allclose(
        float(ttt.smoothed_ce(torch.from_numpy(logits), torch.from_numpy(ids))),
        float(jtt.smoothed_ce(jnp.asarray(logits), jnp.asarray(ids))), atol=ATOL, rtol=RTOL)
