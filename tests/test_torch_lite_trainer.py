"""The port's Lite trainer, DeepLabV3+'s train mode, the depth teacher and
``eval_lite --checkpoint`` (autoware_vision_pilot_tpu_torch/train/
lite_trainer.py, models/lite/deeplabv3plus.py, train/teachers.py,
export/eval_lite.py) against the JAX package's, on the CPU in f32 at atol
2e-4, rtol 1e-3.

The trainer on the small seg net of tests/test_torch_legacy_trainer.py (a
BatchNorm and a dropout; the trainer does not depend on the net), from
the same numpy-seeded weights and with the same dropout masks
(tests/test_torch_train_step.py::Masks), at 64x128, batch 2, with
SceneSegLite.yaml's schema: cross-entropy with ignore_index 255 and class
weights, two microbatches a step, the warm-up cosine schedule and AdamW.
Two steps of fit, then a port trainer resumed from the first one's
checkpoint and JAX's trainer both go on to step 3 (each fit starts the
batch iterator anew); the losses logged to
metrics.jsonl, the weights, validate's mIoU and its best_mIoU.msgpack
(read by JAX's load_msgpack). The three loss types on the same logits,
every schedule and both optimizers of the config, the pseudo_labeler
route with the DepthAnythingTeacher on an injected stand-in (against
JAX's teacher), DeepLabV3+'s train-mode forward (the ASPP dropout), and
eval_lite on the trainer's checkpoint against the same weights as msgpack.
"""
import copy
import json
import pathlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from autoware_vision_pilot_tpu.export.checkpoints import load_msgpack as jax_load_msgpack
from autoware_vision_pilot_tpu.models.lite import deeplabv3plus as jdl
from autoware_vision_pilot_tpu.train import losses as jlo
from autoware_vision_pilot_tpu.train import lite_trainer as jlt
from autoware_vision_pilot_tpu.train import teachers as jte
from autoware_vision_pilot_tpu_torch.convert.from_jax import variables_to_state_dict
from autoware_vision_pilot_tpu_torch.export import eval_lite as teval
from autoware_vision_pilot_tpu_torch.models.lite import build_lite_model
from autoware_vision_pilot_tpu_torch.models.lite import deeplabv3plus as tdl
from autoware_vision_pilot_tpu_torch.nn import layers as tl
from autoware_vision_pilot_tpu_torch.train import lite_trainer as tlt
from autoware_vision_pilot_tpu_torch.train import teachers as tte

from test_torch_layers import ATOL, RTOL, from_port, seeded_variables, to_port
from test_torch_legacy_trainer import JSmallSeg, SmallSeg
from test_torch_train_step import Masks, close, one_thread  # noqa: F401

CONFIGS = pathlib.Path(__file__).resolve().parents[1] / "configs"
HW, BATCH = (64, 128), 2


def config(out_dir, **changes):
    cfg = tlt.load_experiment_config(CONFIGS / "SceneSegLite.yaml")
    cfg["experiment"]["output_dir"] = str(out_dir)
    cfg["training"].update(max_steps=2, grad_accum_steps=2, logging={"log_every_steps": 1},
                           validation={"every_n_steps": 0})
    cfg["loss"].update(num_classes=3, apply_weights={"enabled": True,
                                                     "values": [1.0, 2.0, 0.5]})
    cfg["scheduler"]["warmup_steps"] = 1
    for k, v in changes.items():
        cfg[k].update(v)
    return cfg


def data(seed, n=3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        labels = rng.integers(0, 3, (BATCH, *HW)).astype(np.int32)
        labels[rng.random((BATCH, *HW)) < 0.1] = 255  # ignored pixels
        out.append((rng.integers(0, 256, (BATCH, *HW, 3), dtype=np.uint8), labels))
    return out


def cycling(batches):
    def it():
        while True:
            yield from batches
    return it


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lite")
    v = seeded_variables(JSmallSeg(), jnp.zeros((1, *HW, 3)), seed=61)
    batches, val = data(62), data(63, 2)
    with pytest.MonkeyPatch.context() as mp:
        masks = Masks(64)
        mp.setattr(jax.random, "bernoulli", masks.jax)
        mp.setattr(tl, "keep_mask", masks.port)
        mp.setattr(JSmallSeg, "init", lambda self, *a, **k: v)
        jtr = jlt.LiteTrainer(JSmallSeg(), config(tmp / "jax"), cycling(batches),
                              val_iter=lambda: iter(val), input_hw=HW)
        jtr.fit()
        j2 = jax.tree.map(np.asarray, (jtr.state.params, jtr.state.batch_stats))
        jtr.fit(3)
        masks.frozen, masks.k = True, 0
        ttr = tlt.LiteTrainer(SmallSeg(), config(tmp / "port"), cycling(batches),
                              val_iter=lambda: iter(val), input_hw=HW, variables=v,
                              device="cpu")
        ttr.fit()
        t2 = copy.deepcopy(ttr.model.state_dict())
        resumed = tlt.LiteTrainer(
            SmallSeg(), config(tmp / "resumed", checkpoint={"load_from": str(
                tmp / "port" / "checkpoints")}), cycling(batches),
            val_iter=lambda: iter(val), input_hw=HW, variables=v, device="cpu")
        resumed.fit(3)
    return jtr, ttr, resumed, j2, t2, v, val, tmp


def test_two_steps_then_resume_match_jax(trained):
    jtr, ttr, resumed, j2, t2, v, _, tmp = trained
    want = variables_to_state_dict({"params": j2[0], "batch_stats": j2[1]}, ttr.model)
    for k, t in t2.items():
        close(k, t, want[k])
    assert ttr.state.step == 2 and resumed.state.step == 3
    want = variables_to_state_dict({"params": jtr.state.params,
                                    "batch_stats": jtr.state.batch_stats}, ttr.model)
    for k, t in resumed.model.state_dict().items():
        close(f"resumed {k}", t, want[k])
    assert resumed.state.optimizer.param_groups[0]["count"] == 3
    logs = [json.loads(l) for l in (tmp / "port" / "metrics.jsonl").read_text().splitlines()]
    jlogs = [json.loads(l) for l in (tmp / "jax" / "metrics.jsonl").read_text().splitlines()]
    assert [l["step"] for l in logs] == [1, 2]
    np.testing.assert_allclose([l["train/loss"] for l in logs],
                               [l["train/loss"] for l in jlogs[:2]], atol=ATOL, rtol=RTOL)
    assert sorted(p.name for p in (tmp / "port" / "checkpoints").iterdir()) == ["step_2"]
    restored = jax_load_msgpack(tmp / "port" / "last.msgpack", {"params": j2[0],
                                                               "batch_stats": j2[1]})
    got = variables_to_state_dict(jax.tree.map(np.asarray, restored), ttr.model)
    for k, t in t2.items():
        assert torch.equal(got[k], t), k


def test_validate_matches_jax(trained):
    jtr, _, resumed, *_, tmp = trained
    got, want = resumed.validate(3), jtr.validate(3)
    assert np.isfinite(got) and abs(got - want) < 1e-3
    assert (tmp / "resumed" / "best_mIoU.msgpack").exists()
    resumed.close()


def jax_ce(logits_nhwc, targets, nc, ignore, weights):
    """JAX's LiteTrainer ce_loss (lite_trainer.py:128-138)."""
    valid = targets != ignore
    onehot = jax.nn.one_hot(jnp.where(valid, targets, 0), nc) * valid[..., None]
    return jlo.segmentation_ce_loss(logits_nhwc, onehot, weights)


@pytest.mark.parametrize("loss_type", ["cross_entropy", "cross_entropy_plain", "depth_ssi",
                                       "lanes_bce"])
def test_loss_types_match_jax(tmp_path, loss_type):
    rng = np.random.default_rng(65)
    C = 3 if loss_type.startswith("cross") else (1 if loss_type == "depth_ssi" else 3)
    logits = rng.normal(0, 2, (BATCH, *HW, C)).astype(np.float32)
    loss_cfg = {"type": loss_type.replace("_plain", "")}
    if loss_type == "cross_entropy_plain":
        loss_cfg.update(ignore_index=None, apply_weights={"enabled": False})
    trainer = tlt.LiteTrainer(SmallSeg(), config(tmp_path, loss=loss_cfg),
                              cycling(data(66)), input_hw=HW, device="cpu")
    if loss_type == "cross_entropy":
        labels = data(67)[0][1]
        want = jax_ce(jnp.asarray(logits), jnp.asarray(labels), 3, 255,
                      jnp.asarray([1.0, 2.0, 0.5]))
    elif loss_type == "cross_entropy_plain":
        labels = rng.integers(0, 3, (BATCH, *HW)).astype(np.int32)
        want = jlo.segmentation_ce_loss(jnp.asarray(logits), jnp.asarray(labels))
    elif loss_type == "depth_ssi":
        labels = rng.random((BATCH, *HW)).astype(np.float32)
        want = jlo.ssi_mae_depth_loss(jnp.asarray(logits), jnp.asarray(labels)[..., None])[0]
    else:
        labels = (rng.random((BATCH, *HW, 3)) > 0.8).astype(np.float32)
        want = jlo.lanes_bce_edge_loss(jnp.asarray(logits), jnp.asarray(labels))[0]
    got = trainer._loss_fn(trainer.cfg["loss"])(to_port(logits), trainer.targets(labels))
    np.testing.assert_allclose(float(got), float(want), atol=ATOL, rtol=RTOL)
    trainer.close()


SCHEDULERS = [{"type": "none"}, {"type": "step", "step_size": 3, "gamma": 0.5},
              {"type": "cosine", "min_lr": 1e-6}, {"type": "warmup_cosine", "warmup_steps": 4},
              {"type": "poly", "min_lr": 1e-6}]


@pytest.mark.parametrize("sched", SCHEDULERS, ids=[s["type"] for s in SCHEDULERS])
def test_build_schedule_matches_jax(sched):
    cfg = {"optimizer": {"lr": 1e-3}, "scheduler": sched, "training": {"max_steps": 20}}
    got, want = tlt.build_schedule(cfg), jlt.build_schedule(cfg)
    for n in (0, 1, 3, 4, 7, 19, 20, 25):
        g = got(n) if callable(got) else got
        w = float(want(jnp.int32(n))) if callable(want) else want
        assert g == pytest.approx(w, rel=1e-6, abs=1e-12), n
    with pytest.raises(ValueError):
        tlt.build_schedule({"scheduler": {"type": "bogus"}})


@pytest.mark.parametrize("opt", [{"type": "adamw", "betas": [0.8, 0.99], "weight_decay": 0.05},
                                 {"type": "sgd", "momentum": 0.7, "weight_decay": 0.01}])
def test_build_optimizer(opt):
    p = torch.nn.Parameter(torch.ones(3))
    o = tlt.build_optimizer({"optimizer": opt}, 0.1)([("p", p)])
    group = o.param_groups[0]
    assert group["weight_decay"] == opt["weight_decay"] and group["lr"] == 0.1
    if opt["type"] == "adamw":
        assert isinstance(o, torch.optim.AdamW) and group["betas"] == (0.8, 0.99)
    else:
        assert isinstance(o, torch.optim.SGD) and group["momentum"] == 0.7
    with pytest.raises(ValueError):
        tlt.build_optimizer({"optimizer": {"type": "lamb"}}, 0.1)


def fake_teacher(module, device=None):
    """The teacher on a stand-in model and processor (tests/test_training.py:
    510): 'depth' is the image mean at half resolution, times 3."""
    def processor(images, return_tensors):
        x = torch.stack([torch.from_numpy(np.asarray(im)).float() for im in images])
        return {"pixel_values": x.permute(0, 3, 1, 2)}

    class FakeModel(torch.nn.Module):
        def forward(self, pixel_values):
            depth = torch.nn.functional.avg_pool2d(pixel_values, 2).mean(1) * 3.0
            return types.SimpleNamespace(predicted_depth=depth)

    kw = {} if device is None else {"device": device}
    return module.DepthAnythingTeacher("vitl", model=FakeModel(), processor=processor, **kw)


def test_teacher_and_pseudo_labels(tmp_path):
    imgs = np.random.default_rng(68).integers(0, 256, (BATCH, *HW, 3), dtype=np.uint8)
    teacher = fake_teacher(tte, "cpu")
    got = teacher(imgs)
    np.testing.assert_allclose(got, fake_teacher(jte)(imgs), atol=1e-6)
    assert got.shape == (BATCH, *HW) and got.dtype == np.float32
    with pytest.raises(ValueError):
        tte.DepthAnythingTeacher("vitg2")
    with pytest.raises(ValueError):
        teacher(imgs[0])
    calls = []

    def labeler(images):
        calls.append(len(images))
        return teacher(images)

    depth_net = torch.nn.Sequential(tl.Conv2d(3, 1, 3, 1, 1))
    trainer = tlt.LiteTrainer(depth_net, config(tmp_path, loss={"type": "depth_ssi"}),
                              cycling([(imgs, None)]), input_hw=HW, pseudo_labeler=labeler,
                              device="cpu")
    trainer.fit(1)
    assert calls == [BATCH] and trainer.state.step == 1
    trainer.close()
    nolabel = tlt.LiteTrainer(SmallSeg(), config(tmp_path / "b"), cycling([(imgs, None)]),
                              input_hw=HW, device="cpu")
    with pytest.raises(ValueError, match="pseudo_labeler"):
        nolabel.fit(1)
    nolabel.close()


def test_deeplab_train_mode_matches_jax(monkeypatch):
    jnet = jdl.DeepLabV3Plus(output_channels=3, precision=lax.Precision.HIGHEST)
    v = seeded_variables(jnet, jnp.zeros((1, *HW, 3)), seed=69)
    x = np.random.default_rng(70).normal(0, 1, (BATCH, *HW, 3)).astype(np.float32)
    masks = Masks(71)
    monkeypatch.setattr(jax.random, "bernoulli", masks.jax)
    monkeypatch.setattr(tl, "keep_mask", masks.port)
    want, mut = jax.jit(lambda v, x: jnet.apply(v, x, train=True, mutable=["batch_stats"],
                                                rngs={"dropout": jax.random.key(0)}))(v, x)
    masks.frozen, masks.k = True, 0
    assert any(p == 0.5 for _, p, _ in masks.masks), "the ASPP dropout drew no mask"
    net = tdl.DeepLabV3Plus(output_channels=3)
    net.load_state_dict(variables_to_state_dict(v, net))
    with tl.dropout_generator(torch.Generator()):
        got = net.train()(to_port(x))
    np.testing.assert_allclose(from_port(got.detach()), np.asarray(want), atol=ATOL, rtol=RTOL)
    stats = variables_to_state_dict({"params": v["params"], "batch_stats": mut["batch_stats"]},
                                    net)
    for k, t in net.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            close(k, t, stats[k])
    with torch.no_grad():
        a, b = net.eval()(to_port(x)), net(to_port(x))
    assert torch.equal(a, b)  # eval mode: the dropout is the identity


def test_eval_lite_reads_the_trainers_checkpoint(tmp_path):
    cfg = config(tmp_path / "run", training={"grad_accum_steps": 1})
    trainer = tlt.LiteTrainer(build_lite_model(cfg), cfg, cycling(data(72)), input_hw=HW,
                              device="cpu")
    trainer.fit(1)
    trainer.close()
    path = tmp_path / "cfg.yaml"
    path.write_text(json.dumps(cfg))  # JSON is YAML
    base = ["--config", str(path), "--synthetic", "2", "--height", str(HW[0]), "--width",
            str(HW[1]), "--device", "cpu"]
    got = teval.main(base + ["--checkpoint", str(tmp_path / "run" / "checkpoints")])
    want = teval.main(base + ["--msgpack", str(tmp_path / "run" / "last.msgpack")])
    assert got == want and got["samples"] == 2
