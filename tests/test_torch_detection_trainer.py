"""The port's detection trainer (autoware_vision_pilot_tpu_torch/train/
detection_trainer.py) against the JAX package's, on the CPU in f32 at atol
2e-4, rtol 1e-3.

AutoSpeed "n" at 64x128, batch 2, 8 boxes an image from the port's
YoloBatcher (mosaic, mixup, perspective, HSV) over synthetic samples; both
trainers start from the same numpy-seeded weights (JAX's init returns
them; the port loads them) and take two fit_steps: the losses, the
learning rate at steps 0 and 1 (the warm-up gives 0, then lr / 500), the
first Adam moment after the first step (0.1 times the gradient clipped by
its global norm, which the seeded net's gradients exceed), the BatchNorm
statistics, the weights and the EMA with its ramp after the second. Then
validate's mAP@50 and mAP@[.5:.95] on the same batches (ground truth made
from the port's own detections, so that both are above 0; the NMS on the
CPU is the kernel's plain version), and save read back by JAX's
load_msgpack.
"""
import pathlib

import flax.serialization as fser
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax import lax

from autoware_vision_pilot_tpu.export.checkpoints import load_msgpack as jax_load_msgpack
from autoware_vision_pilot_tpu.models import auto_speed as jas
from autoware_vision_pilot_tpu.train import detection_trainer as jdt
from autoware_vision_pilot_tpu_torch.convert.from_jax import variables_to_state_dict
from autoware_vision_pilot_tpu_torch.models import auto_speed as tas
from autoware_vision_pilot_tpu_torch.train import detection_trainer as tdt
from autoware_vision_pilot_tpu_torch.train import yolo_data as tyd

from test_torch_layers import ATOL, RTOL, seeded_variables
from test_torch_train_step import close, one_thread  # noqa: F401

HW, BATCH, MAX_BOXES = (64, 128), 2, 8


def synthetic_dataset(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        img = rng.integers(0, 256, (48, 96, 3), dtype=np.uint8)
        xy = rng.uniform(0, 60, (3, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(8, 30, (3, 2))], -1)
        out.append(tyd.DetSample(img, boxes, rng.integers(0, 4, 3)))
    return out


def config(tmp, name):
    return dict(input_hw=HW, max_boxes=MAX_BOXES, ckpt_dir=str(tmp / name))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("det")
    jnet = jas.AutoSpeedNetwork("n", 4, *HW, precision=lax.Precision.HIGHEST)
    v = seeded_variables(jnet, jnp.zeros((1, *HW, 3)), seed=21)
    batcher = iter(tyd.YoloBatcher(synthetic_dataset(6, 22), input_hw=HW, batch_size=BATCH,
                                   max_boxes=MAX_BOXES, seed=23))
    batches = [next(batcher) for _ in range(2)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jas.AutoSpeedNetwork, "init", lambda self, *a, **k: v)
        jtr = jdt.DetectionTrainer(jnet, jdt.DetectionTrainerConfig(**config(tmp, "jax")))
    ttr = tdt.DetectionTrainer(tas.AutoSpeedNetwork("n", 4, *HW),
                               tdt.DetectionTrainerConfig(**config(tmp, "port")),
                               variables=v, device="cpu")
    jmu, tmu, jl, tl_ = [], [], [], []
    for b in batches:
        jl.append(jtr.fit_step(*b))
        tl_.append(float(ttr.fit_step(*b)))
        jmu.append(jax.tree.map(np.asarray, jtr.opt_state[1][0].mu))
        tmu.append({n: ttr.state.optimizer.state[p]["exp_avg"].clone()
                    for n, p in ttr.model.named_parameters()})
    return jtr, ttr, batches, jl, tl_, jmu, tmu


def test_two_steps_match_jax(trained):
    jtr, ttr, _, jl, tl_, jmu, tmu = trained
    np.testing.assert_allclose(tl_, jl, atol=ATOL, rtol=RTOL)
    assert ttr.step == 2
    # the first moment after step 1: 0.1 times the clipped gradient
    want = variables_to_state_dict({"params": jmu[0], "batch_stats": jtr.batch_stats},
                                   ttr.model)
    for n, m in tmu[0].items():
        close(n, m, want[n])
    want = variables_to_state_dict({"params": jtr.params, "batch_stats": jtr.batch_stats},
                                   ttr.model)
    for k, t in ttr.model.state_dict().items():
        close(k, t, want[k])
    ema = variables_to_state_dict({"params": jtr.ema_params, "batch_stats": jtr.batch_stats},
                                  ttr.model)
    for n, e in ttr.state.ema.items():
        close(f"ema {n}", e, ema[n])


def test_clipping_is_active(trained):
    """The seeded net's gradient norm is above 10, so the moments were clipped."""
    _, ttr, _, _, _, _, tmu = trained
    norm = float(torch.sqrt(sum((m / 0.1).pow(2).sum() for m in tmu[0].values())))
    assert abs(norm - 10.0) < 1e-3


def test_schedule_and_ema_ramp(trained):
    _, ttr, _, _, _, _, _ = trained
    cfg = ttr.cfg
    want = optax.warmup_cosine_decay_schedule(0.0, cfg.lr, cfg.warmup_steps, cfg.max_steps,
                                              end_value=cfg.lr * cfg.min_lr_ratio)
    for n in (0, 1):
        assert ttr.schedule(n) == pytest.approx(float(want(n)), rel=1e-6, abs=0)
    assert ttr.schedule(0) == 0.0
    assert ttr.state.optimizer.param_groups[0]["lr"] == ttr.schedule(1)
    d = cfg.ema_decay * (1.0 - jnp.exp(-jnp.float32(2) / cfg.ema_tau))
    assert float(ttr.ema_decay(2)) == float(d)


def test_mesh_raises(tmp_path):
    """A mesh of one device trains as mesh=None does, bit for bit (one
    step from seed 0); a local mesh of two devices is refused (a step over
    several cards runs a process a card)."""
    from autoware_vision_pilot_tpu_torch.core.mesh import make_mesh

    batch = next(iter(tyd.YoloBatcher(synthetic_dataset(2, 24), input_hw=HW, batch_size=BATCH,
                                      max_boxes=MAX_BOXES, seed=25)))
    runs = []
    for mesh in (None, make_mesh(devices=["cpu"])):
        tr = tdt.DetectionTrainer(tas.AutoSpeedNetwork("n", 4, *HW),
                                  tdt.DetectionTrainerConfig(**config(tmp_path, "m")),
                                  mesh=mesh, device="cpu")
        runs.append((tr.fit_step(*batch), tr.model.state_dict()))
    (loss, want), (got_loss, got) = runs
    assert torch.equal(got_loss, loss)
    assert all(torch.equal(got[k], want[k]) for k in want)
    with pytest.raises(ValueError, match="one process a device"):
        tdt.DetectionTrainer(tas.AutoSpeedNetwork("n", 4, *HW), tdt.DetectionTrainerConfig(),
                             mesh=make_mesh(devices=["cpu", "cpu"]), device="cpu")


def test_validate_matches_jax(trained):
    jtr, ttr, batches, *_ = trained
    val = []
    for images, _, _, _ in batches:
        bb, ss, cc, vv = (t.numpy() for t in ttr.predictions(images))
        gts, gcs = [], []
        for b in range(len(images)):
            keep = np.flatnonzero(vv[b])[::3][:6]  # some of its own detections as ground truth
            gts.append(bb[b][keep] + np.float32(1.5))
            gcs.append(cc[b][keep])
        val.append((images, gts, gcs))
    got = ttr.validate(iter(val))
    want = jtr.validate(iter(val))
    assert got[0] > 0 and got[1] > 0
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    got_live = ttr.validate(iter(val), use_ema=False)
    np.testing.assert_allclose(got_live, jtr.validate(iter(val), use_ema=False), atol=1e-6)


def test_save_read_by_jax(trained):
    jtr, ttr, *_ = trained
    ttr.save("last")
    path = pathlib.Path(ttr.cfg.ckpt_dir) / "last.msgpack"
    target = {"params": jtr.ema_params, "batch_stats": jtr.batch_stats}
    restored = jax_load_msgpack(path, target)
    assert jax.tree.structure(restored) == jax.tree.structure(target)
    want = variables_to_state_dict(jax.tree.map(np.asarray, restored), ttr.model)
    for n, e in ttr.state.ema.items():
        assert torch.equal(want[n], e), n
    assert path.read_bytes() == fser.to_bytes(ttr.variables())
