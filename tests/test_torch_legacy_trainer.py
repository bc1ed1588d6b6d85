"""The port's legacy trainer and checkpoints (autoware_vision_pilot_tpu_torch/
train/legacy_trainer.py, export/checkpoints.py) against the JAX package's,
on the CPU in f32 at atol 2e-4, rtol 1e-3.

LegacySegTrainer on two SyntheticSegDatasets, batch_schedule (2, 2), two
epochs (four steps) at 64x128, on a small seg net with a BatchNorm and a
dropout (the trainer does not depend on the net; SceneSeg's train step is
tests/test_torch_train_step.py's): both trainers start from the same
weights (JAX's init is replaced by numpy-seeded variables; the port loads
them) and see the same dropout masks (tests/test_torch_train_step.py::
Masks); the interleave order is identical, the loss history and the final
params within the bar.
A file the port's validate_and_save wrote is read by JAX's load_msgpack and
JAX's forward on it agrees with the port's. The three make_*_trainer
losses, the msgpack writer (bytes equal to flax's) and the training
checkpoints' round trip are tested too.
"""
import copy
import pathlib

import flax.linen as fnn
import flax.serialization as fser
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoware_vision_pilot_tpu.export.checkpoints import load_msgpack as jax_load_msgpack
from autoware_vision_pilot_tpu.nn import layers as jl
from autoware_vision_pilot_tpu.train import datasets as jds
from autoware_vision_pilot_tpu.train import legacy_trainer as jlt
from autoware_vision_pilot_tpu_torch.convert.from_jax import (state_dict_to_variables,
                                                               variables_to_state_dict)
from autoware_vision_pilot_tpu_torch.export import checkpoints as tck
from autoware_vision_pilot_tpu_torch.models import efficientnet as te
from autoware_vision_pilot_tpu_torch.nn import layers as tl
from autoware_vision_pilot_tpu_torch.train import datasets as tds
from autoware_vision_pilot_tpu_torch.train import legacy_trainer as tlt
from autoware_vision_pilot_tpu_torch.train import train_step as tts

from test_torch_layers import ATOL, RTOL, from_port, seeded_variables, to_port
from test_torch_train_step import Masks, close, one_thread  # noqa: F401

HW = (64, 128)


class JSmallSeg(fnn.Module):
    """conv -> BatchNorm -> SiLU -> a channel gate from the pooled map with
    dropout, as the context blocks have it -> conv: 3 class logits."""

    @fnn.compact
    def __call__(self, x, train: bool = False):
        h = jl.Conv2d(16, 3, 1, 1, use_bias=False, name="c1")(x)
        h = fnn.BatchNorm(use_running_average=not train, momentum=0.9, epsilon=1e-5,
                          name="bn")(h)
        h = jax.nn.silu(h)
        g = fnn.Dropout(0.25, deterministic=not train)(jnp.mean(h, axis=(1, 2)))
        return jl.Conv2d(3, 3, 1, 1, name="c2")(h * jax.nn.sigmoid(g)[:, None, None, :])


class SmallSeg(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.c1 = tl.Conv2d(3, 16, 3, 1, 1, bias=False)
        self.bn = tl.BatchNorm2d(16)
        self.drop = tl.Dropout(0.25)
        self.c2 = tl.Conv2d(16, 3, 3, 1, 1)

    def forward(self, x):
        h = tl.silu(self.bn(self.c1(x)))
        g = self.drop(h.mean((2, 3)))
        return self.c2(h * g.sigmoid()[:, :, None, None])


def recording(datasets, log):
    """Each dataset's get_train logs (dataset index, sample index)."""
    for i, ds in enumerate(datasets):
        get = ds.get_train
        ds.get_train = lambda k, i=i, get=get: (log.append((i, k)), get(k))[1]
    return datasets


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    jmod = JSmallSeg()
    v = seeded_variables(jmod, jnp.zeros((1, *HW, 3)), seed=41)
    cfg = dict(num_epochs=2, hw=HW, batch_schedule=(2, 2), log_every=1, val_every=0)
    jorder, torder = [], []
    with pytest.MonkeyPatch.context() as mp:
        masks = Masks(42)
        mp.setattr(jax.random, "bernoulli", masks.jax)
        mp.setattr(tl, "keep_mask", masks.port)
        # JAX's trainer runs model.init op by op; hand it the seeded variables
        mp.setattr(JSmallSeg, "init", lambda self, *a, **k: v)
        jtr = jlt.LegacySegTrainer(
            jmod, recording([jds.SyntheticSegDataset(2, 2, HW, seed=s) for s in (43, 44)],
                            jorder),
            jlt.LegacyTrainerConfig(**cfg, ckpt_dir=str(tmp_path_factory.mktemp("jax"))),
            seed=5)
        jtr.train()
        masks.frozen, masks.k = True, 0
        ttr = tlt.LegacySegTrainer(
            SmallSeg(),
            recording([tds.SyntheticSegDataset(2, 2, HW, seed=s) for s in (43, 44)], torder),
            tlt.LegacyTrainerConfig(**cfg, ckpt_dir=str(tmp_path_factory.mktemp("port"))),
            seed=5, device="cpu")
        ttr.model.load_state_dict(variables_to_state_dict(v, ttr.model))
        ttr.train()
    return jmod, jtr, ttr, jorder, torder


def test_interleave_history_and_params(trained):
    jmod, jtr, ttr, jorder, torder = trained
    assert torder == jorder and len(torder) == 8  # 2 epochs x 4 samples
    assert [n for n, _ in ttr.history] == [n for n, _ in jtr.history] == [2, 4, 6, 8]
    np.testing.assert_allclose([l for _, l in ttr.history], [l for _, l in jtr.history],
                               atol=ATOL, rtol=RTOL)
    want = variables_to_state_dict({"params": jtr.params, "batch_stats": jtr.batch_stats},
                                   ttr.model)
    for k, t in ttr.model.state_dict().items():
        close(k, t, want[k])
    assert ttr.state.step == 4


def test_validate_and_save_read_by_jax(trained):
    """The port's msgpack file (flax's bytes for its tree) -> JAX's
    load_msgpack -> JAX's forward within the bar of the port's; mIoU of both
    trainers' validation (the same weights to the bar, so within 1e-3: one
    pixel whose argmax flips moves it by ~1e-4)."""
    jmod, jtr, ttr, _, _ = trained
    got = ttr.validate_and_save(1)
    files = list(pathlib.Path(ttr.cfg.ckpt_dir).glob("*"))
    assert [f.name for f in files] == ["iter_8_epoch_1.msgpack"]
    tree = state_dict_to_variables(ttr.model)
    assert files[0].read_bytes() == fser.to_bytes(copy.deepcopy(tree))
    restored = jax_load_msgpack(files[0], {"params": jtr.params,
                                           "batch_stats": jtr.batch_stats})
    x = np.random.default_rng(45).normal(0, 1, (1, *HW, 3)).astype(np.float32)
    want = jax.jit(jmod.apply)(restored, jnp.asarray(x))
    with torch.no_grad():
        out = ttr.model.eval()(to_port(x))
    np.testing.assert_allclose(from_port(out), np.asarray(want), atol=ATOL, rtol=RTOL)
    ref = jtr.validate_and_save(1)
    assert np.isfinite(got[0]) and abs(got[0] - ref[0]) < 1e-3 and abs(got[1] - ref[1]) < 1e-3


class JOne(fnn.Module):
    @fnn.compact
    def __call__(self, x, train: bool = False):
        return jl.Conv2d(3, 1, name="c")(x)


def test_make_trainer_losses(monkeypatch):
    """The three make_*_trainer loss functions (the trainers built around a
    one-conv net) against JAX's, on the same logits and targets."""
    rng = np.random.default_rng(46)
    monkeypatch.setattr(JOne, "init", lambda self, *a, **k: {"params": {}})
    B, h, w = 2, 16, 32
    logits = rng.normal(0, 2, (B, h, w, 3)).astype(np.float32)
    depth = np.abs(rng.normal(1, 0.5, (B, h, w))).astype(np.float32)
    masks = (rng.random((B, h, w, 3)) > 0.8).astype(np.float32)
    weights = np.ones(3, np.float32)
    K = 9
    names = ("path", "ego_left", "ego_right")
    gy = np.linspace(0.1, 0.9, K).astype(np.float32)
    bev = {n: np.stack([rng.normal(0.5, 0.1, K).astype(np.float32), gy]) for n in names}
    pred = {n: rng.normal(0.5, 0.1, K).astype(np.float32) for n in names}
    rep = {n: rng.normal(0.5, 0.1, (2, K)).astype(np.float32) for n in names}
    hom = np.array([[1.1, 0.05, 12.0], [0.02, 0.9, 30.0], [1e-4, 2e-4, 1.0]], np.float32)
    port_net = tl.Conv2d(3, 3, 1)
    jdict = {"masks": jnp.asarray(masks), "bev_gt": bev, "bev_pred": pred, "reproj_gt": rep}
    tdict = {"masks": to_port(masks), "bev_gt": {k: torch.from_numpy(a) for k, a in bev.items()},
             "bev_pred": {k: torch.from_numpy(a) for k, a in pred.items()},
             "reproj_gt": {k: torch.from_numpy(a) for k, a in rep.items()}}
    cases = [
        ("scene3d", {}, logits[..., :1], depth, torch.from_numpy(depth)),
        ("scene3d", {"edge_scale": 0.5}, logits[..., :1], depth, torch.from_numpy(depth)),
        ("domainseg", {}, logits[..., :1], masks[..., 0], torch.from_numpy(masks[..., 0])),
        ("egolanes", {}, logits, masks, to_port(masks)),
        ("egolanes", {"channel_weights": False}, logits, masks, to_port(masks)),
        ("egolanes", {"bev_loss_weight": 0.5, "bev_homography": hom}, logits, jdict, tdict),
    ]
    for kind, kw, lg, jt, tt in cases:
        jtr = getattr(jlt, f"make_{kind}_trainer")(JOne(), [], **kw)
        ttr = getattr(tlt, f"make_{kind}_trainer")(port_net, [], device="cpu", **kw)
        want = jax.jit(jtr.loss_fn)(jnp.asarray(lg),
                                    jt if isinstance(jt, dict) else jnp.asarray(jt), weights)
        got = ttr.loss_fn(to_port(lg), tt, torch.from_numpy(weights))
        assert np.isclose(got.item(), float(want), atol=ATOL, rtol=RTOL), (kind, kw)


def test_datasets_and_interleave_match_jax():
    """The port's datasets module (its own copy): the same samples, masks,
    weights and interleave order from one seed."""
    a = [jds.SyntheticSegDataset(5, 1, (8, 12), seed=s) for s in (1, 2, 3)]
    b = [tds.SyntheticSegDataset(5, 1, (8, 12), seed=s) for s in (1, 2, 3)]
    for x, y in zip(a, b):
        for k in range(5):
            for u, w in zip(x.get_train(k), y.get_train(k)):
                assert np.array_equal(u, w)
    a[1]._train = a[1]._train[:2]
    b[1]._train = b[1]._train[:2]
    assert list(jds.round_robin_interleave(a, np.random.default_rng(7))) == \
        list(tds.round_robin_interleave(b, np.random.default_rng(7)))
    label = np.random.default_rng(8).choice(
        np.array(list(jds.SCENESEG_COLOURS.values()), np.uint8), (20, 30))
    for u, w in zip(jds.decode_scene_seg_mask(label), tds.decode_scene_seg_mask(label)):
        assert np.array_equal(u, w) and u.dtype == w.dtype
    batches = list(tds.batched_loader(b[0], range(5), 2, (8, 12)))
    want = list(jds.batched_loader(a[0], range(5), 2, (8, 12)))
    assert len(batches) == len(want) == 3
    for u, w in zip(batches, want):
        for p, q in zip(u, w):
            assert np.array_equal(p, q)


def test_qat_trainer_step_runs_qat_apply(monkeypatch):
    """cfg.qat routes the step through qat_apply at cfg.qat_min_channels."""
    from autoware_vision_pilot_tpu_torch.train import qat as tqat
    seen = []
    real = tqat.qat_apply
    monkeypatch.setattr(tqat, "qat_apply",
                        lambda m, x, **k: (seen.append(k), real(m, x, **k))[1])
    tr = tlt.LegacySegTrainer(SmallSeg(), [tds.SyntheticSegDataset(2, 0, HW, seed=9)],
                              tlt.LegacyTrainerConfig(num_epochs=1, hw=HW, batch_schedule=(2,),
                                                      val_every=0, qat=True,
                                                      qat_min_channels=16),
                              device="cpu")
    before = {k: t.clone() for k, t in tr.model.state_dict().items()}
    tr.train()
    assert seen == [{"min_channels": 16}]
    assert any(not torch.equal(before[k], t) for k, t in tr.model.state_dict().items())


def test_msgpack_writer_matches_flax(tmp_path, monkeypatch):
    """save_msgpack gives flax's to_bytes for the same tree: f32, int8 and
    bf16 leaves, a numpy scalar, long keys, and leaves chunked past
    MAX_CHUNK_SIZE (lowered in both packages for the test); load_msgpack
    reads it back."""
    rng = np.random.default_rng(47)
    tree = {"params": {"a": {"w": rng.normal(0, 1, (3, 3, 4, 5)).astype(np.float32),
                             "b": np.zeros(5, np.float32)},
                       "q": np.arange(-100, 100, dtype=np.int8), "s": np.float32(2.5),
                       "x" * 40: np.ones((300,), np.float64)},
            "batch_stats": {"bn": {"mean": rng.normal(0, 1, 7).astype(np.float32)}}}
    jtree = copy.deepcopy(tree)
    jtree["params"]["h"] = jnp.asarray(rng.normal(0, 1, 9), jnp.bfloat16)
    tree["params"]["h"] = torch.from_numpy(np.asarray(jtree["params"]["h"].astype(
        jnp.float32))).bfloat16()
    for limit in (None, 40):
        if limit:
            monkeypatch.setattr(fser, "MAX_CHUNK_SIZE", limit)
            monkeypatch.setattr(tck, "MAX_CHUNK_SIZE", limit)
        path = tmp_path / f"w{limit}.msgpack"
        tck.save_msgpack(path, tree)
        assert path.read_bytes() == fser.to_bytes(copy.deepcopy(jtree))
        back = tck.load_msgpack(path)
        assert np.array_equal(back["params"]["a"]["w"], tree["params"]["a"]["w"])
        assert torch.equal(back["params"]["h"], tree["params"]["h"])


def test_training_checkpoint_round_trip(tmp_path):
    """save_checkpoint / load_checkpoint: module, optimizer state, step and
    EMA restored bit for bit, so a resumed run repeats the original's next
    step exactly; path/step_N, the newest keep steps kept."""
    class Trunk(torch.nn.Module):  # the B0 trunk's last map as the "logits"
        def __init__(self):
            super().__init__()
            self.trunk = te.EfficientNetB0Features(te.B0_DRYRUN_STAGES[:4])

        def forward(self, x):
            return self.trunk(x)[-1]

    def fresh():
        net = tl.init_seeded(Trunk(), torch.Generator().manual_seed(0))
        return tts.create_seg_train_state(net, tts.adamw(1e-3), ema=True)

    def loss(out, target):
        return (out ** 2).mean() + 0 * target.sum()

    step = tts.make_seg_train_step(loss, ema_decay=0.9)
    x = torch.randn(2, 3, 32, 64, generator=torch.Generator().manual_seed(1))
    y = torch.zeros(2)
    state = fresh()
    for i in range(4):
        state, _ = step(state, x, y, torch.Generator().manual_seed(i))
        tck.save_checkpoint(tmp_path, state, keep=3)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_2", "step_3", "step_4"]
    state, _ = step(state, x, y, torch.Generator().manual_seed(9))
    ref = {k: t.clone() for k, t in state.model.state_dict().items()}
    resumed = tck.load_checkpoint(tmp_path, fresh())
    assert resumed.step == 4
    resumed, _ = step(resumed, x, y, torch.Generator().manual_seed(9))
    for k, t in resumed.model.state_dict().items():
        assert torch.equal(t, ref[k]), k
    for k, e in resumed.ema.items():
        assert torch.equal(e, state.ema[k]), k
    a, b = resumed.optimizer.state_dict(), state.optimizer.state_dict()
    for pid, s in b["state"].items():
        for key, t in s.items():
            assert torch.equal(a["state"][pid][key], t), (pid, key)
    older = tck.load_checkpoint(tmp_path, fresh(), step=2)
    assert older.step == 2
    with pytest.raises(FileNotFoundError):
        tck.load_checkpoint(tmp_path, fresh(), step=1)
    with pytest.raises(FileNotFoundError):
        tck.load_checkpoint(tmp_path / "none", fresh())
