"""The port's meshes, collectives, batch-wide losses, batch-sharded
inference and tensor parallelism (autoware_vision_pilot_tpu_torch/core/
mesh.py, parallel/{distributed,sharding,multichip_inference,
tensor_parallel}.py, and the losses' batch-wide parts) against the JAX
package's, on the CPU.

A world of two ranks (gloo, spawned once for the file under a time limit;
tests/torch_world_cases.py::loss_world, no JAX in the ranks) checks the
world mesh and the hybrid mesh over it, all_reduce_mean, shard_batch, the
gradient of cross_replica_psum, the evaluation rows, and each rank's
share of the detection loss, robust_mae, the SSI depth loss and the
class-weighted CE on its rows of a batch of 4: the ranks' losses average
to the port's loss of the whole batch in one process (rtol 1e-6), and
their gradients over the world size are its gradients (atol 2e-5, rtol
1e-4); both are held to JAX's on the whole batch at atol 2e-4, rtol 1e-3.
Then, in this process: the mesh shapes against JAX's on the 8 virtual
CPU devices, make_sharded_infer against JAX's over 8 devices (atol 1e-6),
tensor parallelism over (data=2, model=4) against the unsharded forward
and JAX's (atol 1e-5, rtol 1e-5), the backend each device gets, and a
world whose rank fails.
"""
import time

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoware_vision_pilot_tpu.core.mesh import make_mesh as jax_mesh
from autoware_vision_pilot_tpu.nn import layers as jl
from autoware_vision_pilot_tpu.parallel import distributed as jdist
from autoware_vision_pilot_tpu.parallel.multichip_inference import make_sharded_infer as jinfer
from autoware_vision_pilot_tpu.parallel.sharding import all_reduce_mean as jmean
from autoware_vision_pilot_tpu.parallel.tensor_parallel import (make_tp_infer as jtp_infer,
                                                                shard_variables_tp as jtp_vars)
from autoware_vision_pilot_tpu.train import detection_loss as jdl
from autoware_vision_pilot_tpu.train import losses as jlo
from autoware_vision_pilot_tpu_torch.core.mesh import make_mesh
from autoware_vision_pilot_tpu_torch.nn import layers as tl
from autoware_vision_pilot_tpu_torch.parallel import distributed as tdist
from autoware_vision_pilot_tpu_torch.parallel.multichip_inference import make_sharded_infer
from autoware_vision_pilot_tpu_torch.parallel.sharding import all_reduce_mean
from autoware_vision_pilot_tpu_torch.parallel.tensor_parallel import (ChannelSplit,
                                                                      make_tp_infer,
                                                                      shard_variables_tp)
from autoware_vision_pilot_tpu_torch.train import losses as tlo
from autoware_vision_pilot_tpu_torch.train.detection_loss import detection_loss

import torch_world_cases as cases
from test_torch_detection import targets
from test_torch_layers import ATOL, RTOL, to_port
from test_torch_train_step import one_thread  # noqa: F401

WORLD, BATCH = 2, 4
BARS = dict(atol=2e-5, rtol=1e-4)
WEIGHTS = [1.0, 2.0, 0.5]


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(21)
    maps = [rng.normal(0, 2, (BATCH, h, w, 68)).astype(np.float32)
            for h, w in ((8, 16), (4, 8), (2, 4))]  # AutoSpeed's levels at 64x128, nc 4
    return {"values": [[1.0, 2.0, 3.0], [5.0, 7.0, 9.0]], "maps": maps,
            "targets": targets(4, batch=BATCH),
            "pred": rng.uniform(0, 2, (BATCH, 1, 16, 32)).astype(np.float32),
            "gt": rng.uniform(0, 2, (BATCH, 1, 16, 32)).astype(np.float32),
            "logits": rng.normal(0, 1, (BATCH, 3, 8, 16)).astype(np.float32),
            "ids": rng.integers(0, 3, (BATCH, 8, 16)).astype(np.int64),
            "class_weights": WEIGHTS}


@pytest.fixture(scope="module")
def world(case):
    return run_timed(cases.loss_world, case)


def run_timed(fn, arg):
    t0 = time.monotonic()
    out = tdist.run_world(fn, WORLD, arg, device="cpu", timeout=120)
    assert time.monotonic() - t0 < 120
    return out


def whole_batch(case):
    """The port's losses and gradients of the whole batch in one process,
    and JAX's."""
    maps = [torch.from_numpy(m).requires_grad_(True) for m in case["maps"]]
    pred = torch.from_numpy(case["pred"]).requires_grad_(True)
    logits = torch.from_numpy(case["logits"]).requires_grad_(True)
    tgt = [torch.from_numpy(a) for a in case["targets"]]
    gt, ids = torch.from_numpy(case["gt"]), torch.from_numpy(case["ids"])
    det, parts = detection_loss(maps, *tgt)
    port = {"det": det, "robust_mae": tlo.robust_mae(pred, gt),
            "ssi": tlo.ssi_mae_depth_loss(pred, gt)[0],
            "ce": tlo.segmentation_ce_loss(logits, ids, WEIGHTS), **parts}
    grads = {"det": torch.autograd.grad(det, maps),
             "robust_mae": torch.autograd.grad(port["robust_mae"], pred)[0],
             "ssi": torch.autograd.grad(port["ssi"], pred)[0],
             "ce": torch.autograd.grad(port["ce"], logits)[0]}

    jt = [jnp.asarray(a) for a in case["targets"]]
    nhwc = lambda a: jnp.asarray(a.transpose(0, 2, 3, 1))  # noqa: E731
    jax_fns = {
        "det": (lambda m: jdl.detection_loss(m, *jt)[0], [jnp.asarray(m) for m in case["maps"]]),
        "robust_mae": (lambda p: jlo.robust_mae(p, jnp.asarray(case["gt"])),
                       jnp.asarray(case["pred"])),
        "ssi": (lambda p: jlo.ssi_mae_depth_loss(p, nhwc(case["gt"]))[0], nhwc(case["pred"])),
        "ce": (lambda lg: jlo.segmentation_ce_loss(lg, jnp.asarray(case["ids"]),
                                                   jnp.asarray(WEIGHTS)), nhwc(case["logits"])),
    }
    jax_out = {k: jax.jit(jax.value_and_grad(f))(x) for k, (f, x) in jax_fns.items()}
    return {k: float(v.detach()) for k, v in port.items()}, grads, jax_out


def test_world_mesh_and_hybrid_mesh(world):
    for r, out in enumerate(world):
        assert out["rank"] == r and out["shape"] == {"data": WORLD}
        assert out["devices"] == ["cpu"] * WORLD
        assert out["hybrid one host"] == {"data": WORLD}
        assert out["hybrid two hosts"] == {"dcn_data": WORLD, "data": 1}


def test_all_reduce_mean_shard_batch_psum_and_gather(world, case):
    want = np.mean([np.mean(v) for v in case["values"]])
    for r, out in enumerate(world):
        assert out["mean"].shape == (1,) and float(out["mean"][0]) == want
        (shard,) = out["shard"]
        assert torch.equal(shard["rows"], torch.arange(4.0) + 4 * r)
        assert torch.equal(shard["odd"], torch.arange(5.0))  # 5 rows do not divide: replicated
        assert float(out["psum grad"][0]) == 3.0  # d/dx of (1 + 2) * (x_0 + x_1)
        assert out["gathered"] == [0, 1, 2, 3, 4]


def test_batch_wide_losses_world_2_match_world_1_and_jax(world, case):
    port, grads, jax_out = whole_batch(case)
    for name, value in port.items():
        shares = [out["losses"][name] for out in world]
        np.testing.assert_allclose(np.mean(shares), value, rtol=1e-6, err_msg=name)
        if name in jax_out:
            np.testing.assert_allclose(np.mean(shares), float(jax_out[name][0]), atol=ATOL,
                                       rtol=RTOL, err_msg=name)
    for name, want in grads.items():
        jgrad = jax_out[name][1]
        if name == "det":
            for level, (w, jg) in enumerate(zip(want, jgrad)):
                got = torch.cat([out["grads"]["det"][level] for out in world]) / WORLD
                np.testing.assert_allclose(got.numpy(), w.numpy(), err_msg=f"det {level}",
                                           **BARS)
                np.testing.assert_allclose(got.numpy(), np.asarray(jg), atol=ATOL, rtol=RTOL)
            continue
        got = torch.cat([out["grads"][name] for out in world]) / WORLD
        np.testing.assert_allclose(got.numpy(), want.numpy(), err_msg=name, **BARS)
        jg = np.asarray(jgrad)
        if name in ("ssi", "ce"):
            jg = jg.transpose(0, 3, 1, 2)
        np.testing.assert_allclose(got.numpy(), jg, atol=ATOL, rtol=RTOL, err_msg=name)
        assert np.abs(jg).max() > 0


def test_mesh_shapes_match_jax():
    assert tdist.initialize_distributed(num_processes=1) is False
    assert jdist.initialize_distributed(num_processes=1) is False
    cpus = ["cpu"] * 8
    for axes, names in (((8,), ("data",)), ((2, 4), ("data", "model"))):
        got = tdist.make_hybrid_mesh(ici_axes=axes, axis_names=names, devices=cpus)
        assert got.shape == jdist.make_hybrid_mesh(ici_axes=axes, axis_names=names).shape
        assert got.group is None and got.devices.size == 8
    assert make_mesh(devices=cpus).shape == jax_mesh().shape == {"data": 8}
    assert make_mesh((2, 4), ("data", "model"), cpus).shape == {"data": 2, "model": 4}
    with pytest.raises(ValueError, match="needs 9 devices"):
        make_mesh((9,), devices=cpus)
    x = np.arange(16.0, dtype=np.float32) ** 2
    np.testing.assert_allclose(all_reduce_mean(make_mesh(devices=cpus), torch.from_numpy(x)),
                               np.asarray(jmean(jax_mesh(), jnp.asarray(x))), rtol=1e-6)


def test_backend_follows_the_device():
    assert tdist.backend_for(torch.device("cuda", 0)) == "nccl"
    assert tdist.backend_for(torch.device("cpu")) == "gloo"
    assert tdist.backend_for(torch.device("cuda", 0), "gloo") == "gloo"


def test_a_failing_rank_fails_the_world_and_ends_it():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        tdist.run_world(cases.failing_world, WORLD, None, device="cpu", timeout=60)
    assert time.monotonic() - t0 < 60


class JConv(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        return jl.Conv2d(4, 3, 1, 1, name="c")(x)


def test_sharded_infer_matches_jax():
    """tests/test_training.py::test_multichip_batch_inference: a batch of
    16 over the 8-device mesh, the same numerics as one device."""
    m = JConv()
    x = np.random.default_rng(0).normal(size=(16, 8, 8, 3)).astype(np.float32)
    v = m.init(jax.random.key(0), jnp.zeros((1, 8, 8, 3)))
    want = np.asarray(jinfer(lambda v, x: m.apply(v, x), v, jax_mesh())(jnp.asarray(x)))
    conv = tl.Conv2d(3, 4, 3, 1, 1)
    conv.weight.data = torch.from_numpy(np.asarray(v["params"]["c"]["w"]).transpose(3, 2, 0, 1)
                                        .copy())
    conv.bias.data = torch.from_numpy(np.asarray(v["params"]["c"]["b"]).copy())
    calls = []
    conv.register_forward_hook(lambda mod, a, y: calls.append(a[0].shape[0]))
    got = make_sharded_infer(conv, make_mesh(devices=["cpu"] * 8))(to_port(x))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=1e-6)
    assert calls == [2] * 8  # a replica call a device, 2 rows each
    with pytest.raises(ValueError, match="does not divide"):
        make_sharded_infer(conv, make_mesh(devices=["cpu"] * 3))(to_port(x))


class JNet(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        h = jax.nn.relu(jl.Conv2d(64, 3, padding=1, name="c1")(x))
        h = jl.Conv2d(32, 3, padding=1, name="c2")(h)
        return jl.Linear(16, name="fc")(jnp.mean(h, axis=(1, 2)))


class Net(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.c1 = tl.Conv2d(3, 64, 3, 1, 1)
        self.c2 = tl.Conv2d(64, 32, 3, 1, 1)
        self.fc = tl.Linear(32, 16)

    def forward(self, x):
        return self.fc(self.c2(torch.relu(self.c1(x))).mean((2, 3)))


def test_tensor_parallel_matches_unsharded_and_jax():
    """tests/test_training.py::test_tensor_parallel_inference_matches_
    single_device over (data=2, model=4): the weights split on their
    output channels, outputs at 1e-5."""
    jnet = JNet()
    x = np.random.default_rng(0).normal(0, 1, (4, 16, 32, 3)).astype(np.float32)
    v = jnet.init(jax.random.key(0), jnp.asarray(x))
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("data", "model"))
    want = np.asarray(jtp_infer(jnet.apply, jtp_vars(v, jmesh), jmesh)(jnp.asarray(x)))
    net = Net()
    p = jax.tree.map(lambda a: np.array(a), v["params"])
    with torch.no_grad():
        for name in ("c1", "c2"):
            getattr(net, name).weight.copy_(torch.from_numpy(p[name]["w"].transpose(3, 2, 0, 1)))
            getattr(net, name).bias.copy_(torch.from_numpy(p[name]["b"]))
        net.fc.weight.copy_(torch.from_numpy(p["fc"]["wl"].T))
        net.fc.bias.copy_(torch.from_numpy(p["fc"]["b"]))
    mesh = make_mesh((2, 4), ("data", "model"), ["cpu"] * 8)
    replicas = shard_variables_tp(net, mesh)
    assert len(replicas) == 2 and isinstance(replicas[0].c1, ChannelSplit)
    assert [tuple(q.weight.shape) for q in replicas[0].c1.parts] == [(16, 3, 3, 3)] * 4
    assert [tuple(q.weight.shape) for q in replicas[1].fc.parts] == [(4, 32)] * 4
    assert isinstance(net.c1, tl.Conv2d)  # the model itself is not changed
    got = make_tp_infer(replicas, mesh)(to_port(x))
    with torch.no_grad():
        ref = net(to_port(x))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_tensor_parallel_splits_grouped_convs_by_their_groups():
    dw = tl.init_seeded(tl.Conv2d(8, 8, 3, 1, 1, groups=8), torch.Generator().manual_seed(1))
    x = torch.randn(2, 8, 6, 6)
    (replica,) = shard_variables_tp(torch.nn.Sequential(dw), make_mesh(
        (1, 2), ("data", "model"), ["cpu"] * 2))
    assert replica[0].parts[0].groups == 4
    with torch.no_grad():
        assert torch.equal(replica(x), dw(x))


def test_dtype_policies_match_jax():
    from autoware_vision_pilot_tpu.core import dtypes as jdt
    from autoware_vision_pilot_tpu_torch.core import dtypes as tdt

    names = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
    for j, t in ((jdt.PARITY, tdt.PARITY), (jdt.FAST, tdt.FAST)):
        assert names[j.param_dtype] == t.param_dtype
        assert names[j.compute_dtype] == t.compute_dtype
    assert tdt.default_policy() is tdt.PARITY and tdt.PARITY.precision == "highest"
    tree = {"x": torch.ones(2), "ids": torch.arange(3), "n": [torch.zeros(1, dtype=torch.float64)]}
    cast = tdt.FAST.cast(tree)
    assert cast["x"].dtype == cast["n"][0].dtype == torch.bfloat16
    assert cast["ids"].dtype == torch.int64
    jcast = jdt.FAST.cast({"x": jnp.ones(2), "ids": jnp.arange(3)})
    assert jcast["x"].dtype == jnp.bfloat16 and jcast["ids"].dtype == jnp.int32
    assert tdt.FAST.cast_params(tl.Linear(2, 3)).weight.dtype == torch.bfloat16
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    with tdt.PARITY.matmul_precision():
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
    assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == flags
