"""The port's augmentations (autoware_vision_pilot_tpu_torch/train/augment.py)
against the JAX package's, on the CPU in f32 at atol 2e-4, rtol 1e-3.

torch and JAX draw different numbers, so both sides get the same draws:
JAX's ``jax.random.bernoulli``, ``uniform`` and ``normal`` and the port's
``augment.bernoulli``, ``uniform`` and ``normal`` are replaced (within
each test) by one numpy source. JAX's op runs first and records each draw
(its kind, shape and values); the port's then replays them in order, and
a draw of another kind or shape fails the test. The grid shuffle's
permutations are drawn under ``jax.vmap``, one call for the batch, so
both sides get one fixed permutation for every sample. Every op is held
with its gate forced on (prob 1.0) and at its defaults; each profile and
augment_batch as a whole. The HSV round trip is deterministic and held
directly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoware_vision_pilot_tpu.train import augment as ja
from autoware_vision_pilot_tpu_torch.train import augment as ta

from test_torch_layers import ATOL, RTOL
from test_torch_train_step import one_thread  # noqa: F401 (an autouse fixture)

B, H, W = 2, 16, 32


class Draws:
    """One source of random numbers for both packages (see the module
    docstring)."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        self.log, self.k = [], 0

    def record(self, kind, shape, values):
        self.log.append((kind, tuple(int(s) for s in shape), values))
        return values

    def replay(self, kind, shape):
        assert self.k < len(self.log), "the port draws more than JAX"
        want_kind, want_shape, values = self.log[self.k]
        assert (kind, tuple(int(s) for s in shape)) == (want_kind, want_shape), \
            f"draw {self.k}: the port draws {kind} {shape}, JAX drew {want_kind} {want_shape}"
        self.k += 1
        return values

    # JAX's side
    def jax_bernoulli(self, key, p=0.5, shape=None):
        u = self.record(("bernoulli", float(p)), shape, self.rng.random(shape))
        return jnp.asarray(u < p)

    def jax_uniform(self, key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        u = self.rng.random(shape).astype(np.float32)
        v = (np.float32(minval) + u * (np.float32(maxval) - np.float32(minval))).astype(np.float32)
        return jnp.asarray(self.record("uniform", shape, v))

    def jax_normal(self, key, shape=(), dtype=jnp.float32):
        return jnp.asarray(self.record("normal", shape,
                                       self.rng.standard_normal(shape).astype(np.float32)))

    # the port's side
    def port_bernoulli(self, gen, p, shape, device):
        return torch.from_numpy(self.replay(("bernoulli", float(p)), shape) < p).to(device)

    def port_uniform(self, gen, shape, lo, hi, device):
        return torch.from_numpy(self.replay("uniform", shape)).to(device)

    def port_normal(self, gen, shape, device):
        return torch.from_numpy(self.replay("normal", shape)).to(device)


def run_both(monkeypatch, jfn, tfn, img, label=None, seed=0, perm=None):
    """jfn(key, img[, label]) and tfn(generator, img[, label]) on the same
    draws -> (JAX outputs, port outputs) as numpy tuples."""
    d = Draws(seed)
    monkeypatch.setattr(jax.random, "bernoulli", d.jax_bernoulli)
    monkeypatch.setattr(jax.random, "uniform", d.jax_uniform)
    monkeypatch.setattr(jax.random, "normal", d.jax_normal)
    monkeypatch.setattr(ta, "bernoulli", d.port_bernoulli)
    monkeypatch.setattr(ta, "uniform", d.port_uniform)
    monkeypatch.setattr(ta, "normal", d.port_normal)
    if perm is not None:
        monkeypatch.setattr(jax.random, "permutation", lambda key, n: jnp.asarray(perm))
        monkeypatch.setattr(ta, "permutations", lambda gen, b, n, device: torch.tensor(
            perm).repeat(b, 1).to(device))
    jargs = (jnp.asarray(img),) + (() if label is None else (jnp.asarray(label),))
    targs = (torch.from_numpy(img),) + (() if label is None else (torch.from_numpy(label),))
    want = jfn(jax.random.key(0), *jargs)
    got = tfn(torch.Generator().manual_seed(0), *targs)
    assert d.k == len(d.log), f"the port drew {d.k} of JAX's {len(d.log)} draws"
    as_tuple = lambda o: o if isinstance(o, tuple) else (o,)  # noqa: E731
    return (tuple(None if o is None else np.asarray(o) for o in as_tuple(want)),
            tuple(None if o is None else o.numpy() for o in as_tuple(got)))


def image(seed=1):
    return np.random.default_rng(seed).random((B, H, W, 3)).astype(np.float32)


def assert_same(want, got):
    for w, g in zip(want, got):
        if w is None:
            assert g is None
            continue
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL)


OPS = {
    "gaussian_noise": {}, "color_jitter": {}, "to_gray": {}, "multiplicative_noise": {},
    "pixel_dropout": {}, "iso_noise": {}, "random_fog": {}, "random_shadow": {},
    "random_rain": {"streaks": 0.05}, "spatter": {}, "random_gravel": {},
    "hue_saturation_value": {}, "brightness_contrast": {},
}


@pytest.mark.parametrize("gate", ["on", "default"])
@pytest.mark.parametrize("op", sorted(OPS))
def test_op_matches_jax_on_the_same_draws(monkeypatch, op, gate):
    kw = dict(OPS[op], **({"prob": 1.0} if gate == "on" else {}))
    want, got = run_both(monkeypatch, lambda k, x: getattr(ja, op)(k, x, **kw),
                         lambda g, x: getattr(ta, op)(g, x, **kw), image())
    assert_same(want, got)
    if gate == "on" and op != "random_gravel":
        assert not np.allclose(got[0], image()), "the op left the image as it was"


@pytest.mark.parametrize("labels", ["ids", "masks"])
def test_flip_and_crop_carry_the_labels(monkeypatch, labels):
    rng = np.random.default_rng(2)
    lab = (rng.integers(0, 5, (B, H, W)).astype(np.int32) if labels == "ids"
           else rng.random((B, H, W, 3)).astype(np.float32))
    assert_same(*run_both(monkeypatch, lambda k, x, y: ja.random_hflip(k, x, y, 0.5),
                          lambda g, x, y: ta.random_hflip(g, x, y, 0.5), image(), lab, seed=3))
    assert_same(*run_both(monkeypatch, lambda k, x, y: ja.random_crop_resize(k, x, y, (8, 12)),
                          lambda g, x, y: ta.random_crop_resize(g, x, y, (8, 12)), image(), lab))


@pytest.mark.parametrize("grid,perm", [((1, 2), [1, 0]), ((2, 2), [2, 0, 3, 1]),
                                       ((3, 5), list(range(14, -1, -1)))])
def test_grid_shuffle_matches_jax(monkeypatch, grid, perm):
    lab = np.random.default_rng(4).integers(0, 5, (B, H, W)).astype(np.int32)
    want, got = run_both(monkeypatch,
                         lambda k, x, y: ja.random_grid_shuffle(k, x, y, grid, 0.7),
                         lambda g, x, y: ta.random_grid_shuffle(g, x, y, grid, 0.7),
                         image(), lab, perm=perm)
    assert_same(want, got)
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("profile", ["moderate", "noise", "roadwork", "autosteer"])
def test_profile_matches_jax(monkeypatch, profile):
    fn = f"profile_{profile}"
    assert_same(*run_both(monkeypatch, getattr(ja, fn), getattr(ta, fn), image(5), seed=6))


@pytest.mark.parametrize("profile,grid_shuffle", [("moderate", True), ("heavy", False),
                                                  ("none", True)])
def test_augment_batch_matches_jax(monkeypatch, profile, grid_shuffle):
    lab = np.random.default_rng(7).integers(0, 5, (B, H, W)).astype(np.int32)
    kw = dict(noise_profile=profile, grid_shuffle=grid_shuffle, grid_prob=1.0)
    want, got = run_both(monkeypatch, lambda k, x, y: ja.augment_batch(k, x, y, **kw),
                         lambda g, x, y: ta.augment_batch(g, x, y, **kw), image(8), lab,
                         perm=[1, 0])
    assert_same(want, got)


def test_hsv_round_trip_matches_jax():
    img = image(9)
    img[0, :4] = img[0, :4, :, :1]  # grey pixels: equal channels
    want = ja._rgb_to_hsv_vec(jnp.asarray(img))
    got = ta._rgb_to_hsv_vec(torch.from_numpy(img))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    back = ta._hsv_to_rgb_vec(got)
    np.testing.assert_allclose(back.numpy(), np.asarray(ja._hsv_to_rgb_vec(want)), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(back.numpy(), img, atol=1e-5)


def test_port_draws_on_its_generator():
    """The real draws: seeded generators repeat, and the ops keep shapes."""
    x = torch.from_numpy(image())
    a = ta.augment_batch(torch.Generator().manual_seed(3), x, None, noise_profile="noise")[0]
    b = ta.augment_batch(torch.Generator().manual_seed(3), x, None, noise_profile="noise")[0]
    assert torch.equal(a, b) and a.shape == x.shape
    perms = ta.permutations(torch.Generator().manual_seed(0), 4, 6, "cpu")
    assert all(sorted(r.tolist()) == list(range(6)) for r in perms)
