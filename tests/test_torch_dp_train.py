"""Data parallelism of the port's train step and Lite trainer
(autoware_vision_pilot_tpu_torch/train/train_step.py over a world mesh,
parallel/sharding.py, the synced BatchNorm and the sharded dropout of
nn/layers.py) against the JAX package's step on a two-device mesh and
against the port's own step on one process, on the CPU.

A world of two ranks (gloo, spawned once for the file by
parallel/distributed.py::run_world, under a time limit; the ranks import
no JAX: tests/torch_world_cases.py) runs one step of JAX's TinySeg of
tests/test_training.py::test_mesh_dp_train_step_matches_single_device
(conv, BatchNorm, ReLU, conv; microbatches 2, sgd(0.1), batch 8) with a
dropout before the last conv, from the same numpy-seeded weights and with
the dropout mask that JAX's traced step draws (the port's draws replay
it). It is held to JAX's two-device step and to the port's world of one
at that test's bars, atol 2e-5, rtol 1e-4, on the weights and the
BatchNorm statistics; the two ranks' weights are bit-equal. The same
step with each rank's rows taken contiguous (rank r: rows r B / W up to
the next rank's, then split into microbatches) must miss those bars: the
check sees the row order. One LiteTrainer step (class weights, two
microbatches) and its validation (a batch of 5 rows, split 3 / 2) on the
world are held to the world of one, and so are one DetectionTrainer step
(AutoSpeed "n" at 64x128, batch 4: its loss's normalizer over the whole
batch, the clipped gradients) and its validation (3 images split 2 / 1,
the detections gathered).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import flax.linen as fnn

from autoware_vision_pilot_tpu.core.mesh import make_mesh as jax_mesh
from autoware_vision_pilot_tpu.nn import layers as jl
from autoware_vision_pilot_tpu.train import losses as jlo
from autoware_vision_pilot_tpu.train import train_step as jts
from autoware_vision_pilot_tpu_torch.convert.from_jax import variables_to_state_dict
from autoware_vision_pilot_tpu_torch.core.mesh import make_mesh
from autoware_vision_pilot_tpu_torch.parallel.distributed import run_world

import torch_world_cases as cases
from test_torch_detection_trainer import synthetic_dataset
from test_torch_layers import seeded_variables
from test_torch_train_step import one_thread  # noqa: F401

HW, BATCH, MB, WORLD = (8, 16), 8, 2, 2
BARS = dict(atol=2e-5, rtol=1e-4)  # tests/test_training.py's DP bars


class JTinySeg(fnn.Module):
    @fnn.compact
    def __call__(self, x, train: bool = False):
        x = jl.Conv2d(8, 3, 1, 1, name="c1")(x)
        x = fnn.BatchNorm(use_running_average=not train, name="bn")(x)
        x = fnn.Dropout(0.3, deterministic=not train)(jax.nn.relu(x))
        return jl.Conv2d(3, 1, name="c2")(x)


def lite_case(state, masks, out_dir):
    rng = np.random.default_rng(11)
    cfg = {"experiment": {"output_dir": str(out_dir), "seed": 3},
           "training": {"max_steps": 1, "grad_accum_steps": MB, "save_last": False,
                        "logging": {"log_every_steps": 10 ** 9}},
           "optimizer": {"type": "sgd", "lr": 0.1},
           "scheduler": {"type": "none"},
           "loss": {"num_classes": 3, "apply_weights": {"enabled": True,
                                                        "values": [1.0, 2.0, 0.5]}}}
    return {"state": state, "masks": masks, "cfg": cfg, "hw": HW,
            "images": rng.integers(0, 256, (BATCH, *HW, 3), dtype=np.uint8),
            "labels": rng.integers(0, 3, (BATCH, *HW)).astype(np.int64),
            "val_images": rng.integers(0, 256, (5, *HW, 3), dtype=np.uint8),
            "val_labels": rng.integers(0, 3, (5, *HW)).astype(np.int64)}


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The inputs, and JAX's step on a two-device mesh: its loss, params,
    batch statistics and the mask it drew."""
    jmod = JTinySeg()
    v = seeded_variables(jmod, jnp.zeros((1, *HW, 3)), seed=3)
    rng = np.random.default_rng(7)
    images = rng.normal(size=(BATCH, *HW, 3)).astype(np.float32)
    targets = rng.integers(0, 3, size=(BATCH, *HW)).astype(np.int64)
    masks, mask_rng = [], np.random.default_rng(5)

    def bernoulli(key, p=0.5, shape=None):
        masks.append(mask_rng.random(tuple(shape)) < float(p))
        return jnp.asarray(masks[-1])

    tx = optax.sgd(0.1)
    params = jax.tree.map(jnp.asarray, v["params"])
    state = jts.TrainState(params, jax.tree.map(jnp.asarray, v["batch_stats"]),
                           tx.init(params), jnp.zeros((), jnp.int32), None)
    run, _ = jts.make_seg_train_step(jmod, tx, loss_fn=jlo.segmentation_ce_loss,
                                     mesh=jax_mesh((WORLD,), devices=jax.devices()[:WORLD]),
                                     microbatches=MB, donate=False)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "bernoulli", bernoulli)
        new, loss = run(state, jnp.asarray(images), jnp.asarray(targets.astype(np.int32)),
                        jax.random.key(3))
    assert len(masks) == 1 and masks[0].shape == (BATCH // MB, *HW, 8)
    sd = variables_to_state_dict(v, cases.TinySeg())
    jax_after = variables_to_state_dict(
        {"params": jax.tree.map(np.asarray, new.params),
         "batch_stats": jax.tree.map(np.asarray, new.batch_stats)}, cases.TinySeg())
    return {"state": sd, "images": images, "targets": targets, "masks": masks,
            "lite": lite_case(sd, masks, tmp_path_factory.mktemp("lite")),
            "det": det_case(), "jax": (float(loss), jax_after)}


def det_case():
    """A YoloBatcher batch of 4 for the detection trainer's step, and a
    validation batch of 3 images (split 2 / 1 over the world) whose ground
    truth is a few boxes of its own."""
    from autoware_vision_pilot_tpu_torch.train.yolo_data import YoloBatcher

    batch = next(iter(YoloBatcher(synthetic_dataset(4, 26), input_hw=(64, 128),
                                  batch_size=4, max_boxes=8, seed=27)))
    rng = np.random.default_rng(28)
    images = rng.integers(0, 256, (3, 64, 128, 3), dtype=np.uint8)
    boxes = [np.array([[4.0, 6.0, 40.0, 30.0], [60.0, 10.0, 90.0, 50.0]], np.float32)] * 3
    return {"batch": batch, "val": [(images, boxes, [np.array([1, 2])] * 3)]}


@pytest.fixture(scope="module")
def world(case):
    return run_world(cases.dp_world, WORLD, {k: v for k, v in case.items() if k != "jax"},
                     device="cpu", timeout=180)


@pytest.fixture(scope="module")
def world1(case, tmp_path_factory):
    lite = dict(case["lite"], cfg=dict(case["lite"]["cfg"], experiment={
        "output_dir": str(tmp_path_factory.mktemp("lite1")), "seed": 3}))
    return {"step": cases.sgd_step(case["state"], case["images"], case["targets"],
                                   case["masks"], None),
            "lite": cases.lite_run(lite, None), "det": cases.det_run(case["det"], None)}


def held(got, want, **bars):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]), err_msg=k,
                                   **(bars or BARS))


def test_world_2_step_matches_jax_mesh_and_world_1(case, world, world1):
    jloss, jstate = case["jax"]
    loss, state = world[0]["step"]
    assert world[0]["world"] == WORLD and world[1]["rank"] == 1
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    np.testing.assert_allclose(loss, world1["step"][0], rtol=1e-5)
    held(state, jstate)
    held(state, world1["step"][1])
    # the step moved the running statistics and the weights
    assert not np.allclose(state["bn.running_mean"], case["state"]["bn.running_mean"])
    assert not np.allclose(state["c1.weight"], case["state"]["c1.weight"])


def test_ranks_hold_bit_equal_weights(world):
    for key in ("step", "contiguous"):
        a, b = world[0][key], world[1][key]
        assert a[0] == b[0]
        assert all(torch.equal(a[1][k], b[1][k]) for k in a[1]), key
    a, b = world[0]["lite"][0], world[1]["lite"][0]
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_a_contiguous_split_misses_the_bars(world, world1):
    """Rows taken contiguous per rank make other microbatches: other
    BatchNorm statistics and other dropout rows. The bars see it."""
    with pytest.raises(AssertionError):
        held(world[0]["contiguous"][1], world1["step"][1])


def test_lite_trainer_world_2_matches_world_1(world, world1):
    state, miou = world[0]["lite"]
    held(state, world1["lite"][0])
    assert miou == world[1]["lite"][1]
    np.testing.assert_allclose(miou, world1["lite"][1], rtol=1e-6)


def test_detection_trainer_world_2_matches_world_1(world, world1):
    """The detection loss's normalizer is the whole batch's: the loss, the
    first moments (0.1 times the averaged, clipped gradients; the warm-up's
    first learning rate is 0), the BatchNorm statistics and the gathered
    validation's mAPs of world 2 equal world 1's."""
    loss, moments, state, maps = world[0]["det"]
    want_loss, want_moments, want_state, want_maps = world1["det"]
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    held(moments, want_moments)
    held(state, want_state)
    np.testing.assert_allclose(maps, want_maps, rtol=1e-6)
    assert world[1]["det"][3] == maps
    assert all(torch.equal(state[k], world[1]["det"][2][k]) for k in state)


def test_one_device_mesh_is_bit_equal_to_none(case, world1):
    loss, state = cases.sgd_step(case["state"], case["images"], case["targets"],
                                 case["masks"], make_mesh(devices=["cpu"]))
    assert loss == world1["step"][0]
    assert all(torch.equal(state[k], world1["step"][1][k]) for k in state)


def test_local_mesh_of_several_devices_is_refused():
    from autoware_vision_pilot_tpu_torch.train.losses import segmentation_ce_loss
    from autoware_vision_pilot_tpu_torch.train.train_step import make_seg_train_step

    with pytest.raises(ValueError, match="one process a device"):
        make_seg_train_step(segmentation_ce_loss, mesh=make_mesh(devices=["cpu", "cpu"]))
