"""The port's optax pieces (autoware_vision_pilot_tpu_torch/train/optim.py)
against optax, on the CPU: every schedule at several counts (float32
arithmetic in both, held to 1e-6 relative: the cos and pow of two
libraries), clip_by_global_norm, adamw with a warm-up schedule, sgd with
add_decayed_weights and momentum, and multi_transform with set_to_zero on
a small tree, each over three updates at atol 2e-6 (single-precision
rounding of the same updates in another order)."""
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from autoware_vision_pilot_tpu_torch.train import optim
from autoware_vision_pilot_tpu_torch.train.train_step import optimizer_step

from test_torch_train_step import one_thread  # noqa: F401 (an autouse fixture)

COUNTS = (0, 1, 2, 7, 99, 100, 101, 250, 999, 1000, 5000)
SCHEDULES = {
    "warmup_cosine": (lambda m: m.warmup_cosine_decay_schedule(0.0, 1e-3, 100, 1000,
                                                               end_value=1e-5)),
    "cosine": lambda m: m.cosine_decay_schedule(1e-3, 1000),
    "cosine_alpha": lambda m: m.cosine_decay_schedule(1e-4, 160000, alpha=1e-6 / 1e-4),
    "step": lambda m: m.exponential_decay(1e-4, transition_steps=30, decay_rate=0.1,
                                          staircase=True),
    "exponential": lambda m: m.exponential_decay(1e-3, 100, 0.5, transition_begin=10),
    "exponential_end": lambda m: m.exponential_decay(1e-3, 100, 0.5, end_value=2e-4),
    "poly": lambda m: m.polynomial_schedule(1e-4, 1e-6, power=0.9, transition_steps=1000),
    "linear": lambda m: m.linear_schedule(0.0, 1e-3, 100),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_optax(name):
    got, want = SCHEDULES[name](optim), SCHEDULES[name](optax)
    for n in COUNTS:
        assert got(n) == pytest.approx(float(want(jnp.int32(n))), rel=1e-6, abs=1e-12), n


def tree(seed):
    rng = np.random.default_rng(seed)
    return {"backbone.w": rng.normal(0, 1, (4, 3)).astype(np.float32),
            "backbone.b": rng.normal(0, 1, (3,)).astype(np.float32),
            "head.w": rng.normal(0, 1, (3, 2)).astype(np.float32)}


def run_both(tx, make, scale=1.0, steps=3):
    """Three updates of optax's ``tx`` and the port's optimizer from
    ``make`` on the same params and gradients -> (optax params, port params)."""
    params = {k: jnp.asarray(v) for k, v in tree(0).items()}
    state = tx.init(params)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in tree(0).items()}
    opt = make(list(tparams.items()))
    for s in range(steps):
        grads = {k: v * scale for k, v in tree(10 + s).items()}
        upd, state = tx.update({k: jnp.asarray(g) for k, g in grads.items()}, state, params)
        params = optax.apply_updates(params, upd)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(grads[k].copy())
        optimizer_step(opt)
    return params, {k: p.detach().numpy() for k, p in tparams.items()}


def assert_trees(a, b, atol=2e-6):
    for k in a:
        np.testing.assert_allclose(b[k], np.asarray(a[k]), atol=atol, rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("scale", [0.1, 10.0])
def test_clip_by_global_norm_matches_optax(scale):
    grads = {k: v * scale for k, v in tree(3).items()}
    want, _ = optax.clip_by_global_norm(2.0).update(
        {k: jnp.asarray(v) for k, v in grads.items()}, optax.EmptyState())
    got = {k: torch.from_numpy(v.copy()) for k, v in grads.items()}
    norm = optim.clip_by_global_norm(got.values(), 2.0)
    assert (float(norm) < 2.0) == (scale == 0.1)
    assert_trees(want, {k: v.numpy() for k, v in got.items()}, atol=1e-7)


def test_clipped_adamw_with_warmup_matches_optax():
    sched = optax.warmup_cosine_decay_schedule(0.0, 0.1, 2, 10, end_value=1e-3)
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(sched, weight_decay=5e-4))
    want, got = run_both(tx, optim.adamw(optim.warmup_cosine_decay_schedule(
        0.0, 0.1, 2, 10, end_value=1e-3), weight_decay=5e-4, clip_norm=1.0), scale=3.0)
    assert_trees(want, got)
    first, _ = run_both(tx, optim.adamw(optim.warmup_cosine_decay_schedule(
        0.0, 0.1, 2, 10, end_value=1e-3), weight_decay=5e-4, clip_norm=1.0), steps=1)
    assert_trees(first, tree(0), atol=0)  # the first update runs at schedule(0) = 0


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgd_with_decayed_weights_matches_optax(momentum):
    sched = optax.exponential_decay(0.05, 2, 0.5, staircase=True)
    tx = optax.chain(optax.add_decayed_weights(0.01), optax.sgd(sched, momentum=momentum))
    want, got = run_both(tx, optim.sgd(optim.exponential_decay(0.05, 2, 0.5, staircase=True),
                                       momentum=momentum, weight_decay=0.01))
    assert_trees(want, got)


def test_multi_transform_set_to_zero_matches_optax():
    """Frozen leaves get no update at all: no weight decay either."""
    labels = {k: "frozen" if k.startswith("backbone") else "train" for k in tree(0)}
    tx = optax.multi_transform({"train": optax.adamw(0.01, weight_decay=0.1),
                                "frozen": optax.set_to_zero()}, labels)
    want, got = run_both(tx, optim.multi_transform(
        {"train": optim.adamw(0.01, weight_decay=0.1), "frozen": optim.set_to_zero()}, labels))
    assert_trees(want, got)
    for k in ("backbone.w", "backbone.b"):
        np.testing.assert_array_equal(got[k], tree(0)[k])


def test_optimizer_count_survives_its_state_dict():
    p = torch.nn.Parameter(torch.ones(3))
    make = optim.adamw(optim.linear_schedule(0.0, 1.0, 10))
    opt = make([("p", p)])
    for _ in range(3):
        p.grad = torch.ones(3)
        opt.step()
    other = make([("p", torch.nn.Parameter(torch.ones(3)))])
    other.load_state_dict(opt.state_dict())
    assert other.param_groups[0]["count"] == 3
