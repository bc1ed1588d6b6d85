"""The port's train step (autoware_vision_pilot_tpu_torch/train/
train_step.py) and the nets' train mode against the JAX package's
make_seg_train_step, on the CPU in f32 at atol 2e-4, rtol 1e-3.

SceneSeg at dryrun depth (B0_DRYRUN_STAGES, ctx_hw (2, 4)) on 64x128
inputs, batch 2, JAX's weights seeded with numpy and loaded into the port:
the train-mode logits, the loss, the gradients (AdamW's first moment after
one step is 0.1 g on both sides), the BatchNorm running statistics, the
params and both moments after two AdamW steps at lr 1e-4, and the EMA;
``microbatches=2`` and stochastic depth are in
tests/test_torch_train_microbatch.py, EgoLanes in
tests/test_torch_train_egolanes.py.

Dropout and stochastic depth see the same masks on both sides: the test
replaces ``jax.random.bernoulli`` (monkeypatch, within the test) and the
port's ``nn.layers.keep_mask`` by one source that hands out the k-th mask
of a forward, drawn with numpy. JAX's jitted step traces its forward once
(the scan body once), so its masks repeat every forward and microbatch;
the port's source cycles through the same list. The port's own drop rate
and 1 / (1 - p) scale are tested on their own.
"""
import numpy as np
import optax
import pytest
import torch
import jax
import jax.numpy as jnp

from autoware_vision_pilot_tpu.core.mesh import make_mesh
from autoware_vision_pilot_tpu.models import efficientnet as je
from autoware_vision_pilot_tpu.models.ego_lanes import EgoLanesNetwork as JEgoLanes
from autoware_vision_pilot_tpu.models.scene_seg import SceneSegNetwork as JSceneSeg
from autoware_vision_pilot_tpu.train import losses as jlo
from autoware_vision_pilot_tpu.train import train_step as jts
from autoware_vision_pilot_tpu_torch.convert.from_jax import variables_to_state_dict
from autoware_vision_pilot_tpu_torch.models import efficientnet as te
from autoware_vision_pilot_tpu_torch.models.ego_lanes import EgoLanesNetwork
from autoware_vision_pilot_tpu_torch.models.scene_seg import SceneSegNetwork
from autoware_vision_pilot_tpu_torch.nn import layers as tl
from autoware_vision_pilot_tpu_torch.train import losses as tlo
from autoware_vision_pilot_tpu_torch.train import train_step as tts

from test_torch_layers import ATOL, RTOL, port_with, seeded_variables, to_port

CTX, HW, BATCH, LR, EMA = (2, 4), (64, 128), 2, 1e-4, 0.9


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread for these tests' modules: the suite runs six
    workers on the machine's cores, and eight threads a worker spin
    against each other (a 0.7 s test took 35 s beside five others)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class Masks:
    """One source of Bernoulli masks for both packages: the k-th draw of a
    forward gets masks[k], drawn with numpy at first use; once ``frozen``
    (JAX has traced its forward) the draws cycle through the list."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        self.masks, self.k, self.frozen = [], 0, False

    def next(self, shape, p):
        shape, p = tuple(int(s) for s in shape), float(p)
        if self.frozen:
            self.k %= len(self.masks)
        if self.k == len(self.masks):
            self.masks.append((shape, p, self.rng.random(shape) < p))
        want_shape, want_p, m = self.masks[self.k]
        assert (shape, p) == (want_shape, want_p), "the two packages draw in another order"
        self.k += 1
        return m

    def jax(self, key, p=0.5, shape=None):
        return jnp.asarray(self.next(shape, p))

    def port(self, shape, keep_prob, device):
        return torch.from_numpy(self.next(shape, keep_prob)).to(device)


def jax_tree(tree):
    return jax.tree.map(np.asarray, tree)


def state_dict_of(params, batch_stats, model):
    """A JAX params tree (or a tree of the same shape: grads, moments) with
    its batch_stats -> the port's names."""
    return variables_to_state_dict({"params": params, "batch_stats": batch_stats}, model)


def run_both(monkeypatch, kind, microbatches, steps, ema):
    """JAX's make_seg_train_step and the port's on the same weights, inputs
    and masks -> per step the JAX (loss, logits, state) and the port's
    (loss, logits, grads, state dicts)."""
    if kind == "SceneSeg":
        jmod, port = JSceneSeg(ctx_hw=CTX, backbone_stages=je.B0_DRYRUN_STAGES), \
            SceneSegNetwork(CTX, te.B0_DRYRUN_STAGES)
        tgt = np.random.default_rng(3).integers(0, 3, (BATCH, *HW)).astype(np.int32)
        jloss_fn, tloss_fn = jlo.segmentation_ce_loss, tlo.segmentation_ce_loss
        ttgt = torch.from_numpy(tgt)
    else:
        jmod, port = JEgoLanes(ctx_hw=CTX, backbone_stages=je.B0_DRYRUN_STAGES), \
            EgoLanesNetwork(CTX, te.B0_DRYRUN_STAGES)
        tgt = (np.random.default_rng(3).random((BATCH, HW[0] // 4, HW[1] // 4, 3))
               > 0.8).astype(np.float32)
        jloss_fn = lambda lg, t: jlo.weighted_egolanes_loss(lg, t)[0]  # noqa: E731
        tloss_fn = lambda lg, t: tlo.weighted_egolanes_loss(lg, t)[0]  # noqa: E731
        ttgt = to_port(tgt)
    x = np.random.default_rng(2).normal(0, 1, (BATCH, *HW, 3)).astype(np.float32)
    v = seeded_variables(jmod, jnp.zeros((1, *HW, 3)), seed=1)
    masks = Masks(4)
    monkeypatch.setattr(jax.random, "bernoulli", masks.jax)
    monkeypatch.setattr(tl, "keep_mask", masks.port)

    logits = []

    def jloss(out, t):
        jax.debug.callback(lambda a: logits.append(np.asarray(a)), out)
        return jloss_fn(out, t)

    tx = optax.adamw(LR)
    params = jax.tree.map(jnp.asarray, v["params"])
    state = jts.TrainState(params, jax.tree.map(jnp.asarray, v["batch_stats"]),
                           tx.init(params), jnp.zeros((), jnp.int32),
                           jax.tree.map(jnp.copy, params) if ema else None)
    _, jit_step = jts.make_seg_train_step(jmod, tx, jloss, mesh=make_mesh(),
                                         microbatches=microbatches,
                                         ema_decay=EMA if ema else None, donate=False,
                                         scan_unroll=microbatches)
    jout = []
    for _ in range(steps):
        logits.clear()
        state, loss = jit_step(state, jnp.asarray(x), jnp.asarray(tgt), jax.random.key(5))
        jout.append((float(loss), list(logits), jax_tree(state)))
    masks.frozen, masks.k = True, 0

    model = port_with(port, v)
    tstate = tts.create_seg_train_state(model, tts.adamw(LR), ema=ema)
    step = tts.make_seg_train_step(tloss_fn, microbatches=microbatches,
                                   ema_decay=EMA if ema else None)
    seen = []
    model.register_forward_hook(lambda m, a, y: seen.append(y.detach().clone()))
    tout = []
    for _ in range(steps):
        seen.clear()
        tstate, loss = step(tstate, to_port(x), ttgt, torch.Generator().manual_seed(0))
        opt = tstate.optimizer
        tout.append({
            "loss": float(loss), "logits": list(seen),
            "grads": {n: p.grad.clone() for n, p in model.named_parameters()},
            "state": {k: t.clone() for k, t in model.state_dict().items()},
            "mu": {n: opt.state[p]["exp_avg"].clone() for n, p in model.named_parameters()},
            "nu": {n: opt.state[p]["exp_avg_sq"].clone() for n, p in model.named_parameters()},
            "ema": None if tstate.ema is None else {k: t.clone() for k, t in tstate.ema.items()},
        })
    assert masks.masks, "no mask was drawn"
    return model, jout, tout


def close(name, got, want, atol=ATOL, rtol=RTOL):
    """assert_allclose, checked first in one torch pass (the nets hold ~40 M
    parameters; numpy's assert alone takes seconds over them)."""
    got, w = got.detach(), torch.as_tensor(np.asarray(want))
    if not bool(((got - w).abs() <= atol + rtol * w.abs()).all()):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol, rtol=rtol,
                                   err_msg=name)


@pytest.fixture(scope="module")
def scene_seg():
    with pytest.MonkeyPatch.context() as mp:
        return run_both(mp, "SceneSeg", 1, 2, True)


def test_train_forward_and_loss(scene_seg):
    check_forward_and_loss(*scene_seg)


def check_forward_and_loss(model, jout, tout):
    for (jloss, jlogits, _), t in zip(jout, tout):
        assert len(jlogits) == len(t["logits"]) == 1
        close("logits", t["logits"][0].permute(0, 2, 3, 1), jlogits[0])
        assert np.isclose(t["loss"], jloss, atol=ATOL, rtol=RTOL)


def test_gradients_bn_stats_and_moments(scene_seg):
    check_grads_stats_moments(*scene_seg)


def check_grads_stats_moments(model, jout, tout):
    """Step 1's gradients (JAX: mu / 0.1), and after each step the
    BatchNorm running statistics, the params and AdamW's two moments."""
    grads = state_dict_of(jax.tree.map(lambda m: m / 0.1, jout[0][2].opt_state[0].mu),
                          jout[0][2].batch_stats, model)
    for name, g in tout[0]["grads"].items():
        close(f"grad {name}", g, grads[name])
    for (_, _, js), t in zip(jout, tout):
        want = state_dict_of(js.params, js.batch_stats, model)
        for k, tensor in t["state"].items():
            close(k, tensor, want[k])
        for moment in ("mu", "nu"):
            want = state_dict_of(getattr(js.opt_state[0], moment), js.batch_stats, model)
            for name, tensor in t[moment].items():
                # nu holds g^2: its bar is the square of the gradients'
                close(f"{moment} {name}", tensor, want[name],
                      atol=ATOL if moment == "mu" else ATOL ** 2, rtol=2 * RTOL)
    # the BN statistics moved, and the params moved by about lr a step
    bn = [k for k in tout[0]["state"] if k.endswith("running_var")]
    assert bn and any(not torch.equal(tout[0]["state"][k], tout[1]["state"][k]) for k in bn)


def test_ema(scene_seg):
    model, jout, tout = scene_seg
    for (_, _, js), t in zip(jout, tout):
        want = state_dict_of(js.ema_params, js.batch_stats, model)
        for name, e in t["ema"].items():
            close(f"ema {name}", e, want[name])


def test_adamw_matches_optax():
    """The optimizer alone at a large lr, where weight decay and eps show:
    params over three steps, a parameter with no gradient (a frozen
    subtree) decayed as optax decays every leaf. atol 1e-5: optax takes its
    bias corrections in f32 (1 - 0.999 lands 1.3e-5 off, relative), torch
    in double, which moves a step of 0.1 by ~1e-6; torch's weight decay
    default (1e-2 for optax's 1e-4) would move it by 1e-3."""
    rng = np.random.default_rng(9)
    p0 = {"a": rng.normal(0, 1, (5, 3)).astype(np.float32),
          "b": rng.normal(0, 1, (4,)).astype(np.float32)}
    grads = [{"a": rng.normal(0, 1e-3, (5, 3)).astype(np.float32),
              "b": np.zeros(4, np.float32)} for _ in range(3)]
    tx = optax.adamw(0.1)
    jp = jax.tree.map(jnp.asarray, p0)
    js = tx.init(jp)
    params = {k: torch.nn.Parameter(torch.from_numpy(a.copy())) for k, a in p0.items()}
    opt = tts.adamw(0.1)(list(params.values()))
    for g in grads:
        upd, js = tx.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, upd)
        opt.zero_grad(set_to_none=True)
        params["a"].grad = torch.from_numpy(g["a"].copy())  # "b" gets none
        tts.optimizer_step(opt)
        for k in p0:
            close(k, params[k], jp[k], atol=1e-5, rtol=0)
    assert not np.allclose(np.asarray(jp["b"]), p0["b"])  # decayed with a zero gradient


def test_port_drop_rate_and_scale():
    """The port's own masks: a drop rate within 4 sigma of p and kept
    values scaled by 1 / (1 - p), from the generator given."""
    n, p = 200_000, 0.25
    drop = tl.Dropout(p)
    x = torch.ones(n)
    with tl.dropout_generator(torch.Generator().manual_seed(0)):
        y = drop(x)
        y2 = drop(x)
    kept = y != 0
    assert abs(1 - kept.float().mean().item() - p) < 4 * (p * (1 - p) / n) ** 0.5
    assert torch.equal(y[kept], torch.full_like(y[kept], 1 / (1 - p)))
    assert not torch.equal(y, y2)
    with tl.dropout_generator(torch.Generator().manual_seed(0)):
        assert torch.equal(drop(x), y)  # the generator alone decides
    h = torch.ones(4000, 2, 3, 3)
    with tl.dropout_generator(torch.Generator().manual_seed(1)):
        r = tl.drop_rows(h, 0.1, True)
    rows = r[:, 0, 0, 0]
    assert torch.equal(r, rows.reshape(-1, 1, 1, 1).expand_as(r))
    assert set(rows.tolist()) <= {0.0, torch.tensor(1 / 0.9).item()}
    assert abs((rows == 0).float().mean().item() - 0.1) < 4 * (0.09 / 4000) ** 0.5
    assert drop.eval()(x) is x and tl.drop_rows(h, 0.1, False) is h
    with pytest.raises(RuntimeError, match="dropout_generator"):
        drop.train()(x)


def test_eval_forward_unchanged_by_train_mode_code():
    """Train mode then eval again: the eval forward is the one before, bit
    for bit (the running statistics restored), and a train-mode forward
    moves the running statistics with the biased batch variance."""
    net = tl.init_seeded(SceneSegNetwork(CTX, te.B0_DRYRUN_STAGES),
                         torch.Generator().manual_seed(0)).eval()
    x = torch.randn(2, 3, *HW, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        before = net(x)
        saved = {k: t.clone() for k, t in net.state_dict().items()}
        bn = net.Backbone.encoder["0"][1]
        stem = net.Backbone.encoder["0"][0](x)
        with tl.dropout_generator(torch.Generator()):
            net.train()(x)
        want = 0.9 * saved["Backbone.encoder.0.1.running_var"] + 0.1 * stem.var(
            (0, 2, 3), unbiased=False)
        torch.testing.assert_close(bn.running_var, want, atol=1e-6, rtol=1e-5)
        net.load_state_dict(saved)
        assert torch.equal(net.eval()(x), before)


@pytest.mark.parametrize("momentum,eps", [(0.9, 1e-5), (0.97, 1e-3), (0.99, 1e-5)])
def test_batchnorm_train_mode_matches_flax(momentum, eps):
    """flax's BatchNorm in train mode at the three settings of the JAX nets
    (the B0 trunks; the YOLO family; the Lite ConvBNReLU, flax's default):
    output, input gradient and the running statistics (the biased batch
    variance); the port's nets build their BatchNorms with 1 - momentum."""
    import flax.linen as fnn
    from autoware_vision_pilot_tpu.models import yolo_layers as jyolo
    from autoware_vision_pilot_tpu_torch.models import yolo_layers as tyolo
    from autoware_vision_pilot_tpu_torch.models.lite.deeplabv3plus import ConvBNReLU

    rng = np.random.default_rng(10)
    x = rng.normal(0.5, 2.0, (4, 6, 10, 8)).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=momentum, epsilon=eps)
    v = {"params": {"scale": rng.normal(1, 0.2, 8).astype(np.float32),
                    "bias": rng.normal(0, 0.2, 8).astype(np.float32)},
         "batch_stats": {"mean": rng.normal(0, 0.5, 8).astype(np.float32),
                         "var": rng.uniform(0.5, 1.5, 8).astype(np.float32)}}

    def fwd(xx):
        y, mut = bn.apply(v, xx, mutable=["batch_stats"])
        return jnp.sum(y * y), (y, mut["batch_stats"])

    (_, (y, stats)), gx = jax.value_and_grad(fwd, has_aux=True)(jnp.asarray(x))
    port = tl.BatchNorm2d(8, eps=eps, momentum=1 - momentum)
    port.load_state_dict(variables_to_state_dict(v, port))
    xt = to_port(x).requires_grad_(True)
    with tl.dropout_generator(torch.Generator()):
        out = port.train()(xt)
    (out * out).sum().backward()
    close("output", out.permute(0, 2, 3, 1), y)
    close("input grad", xt.grad.permute(0, 2, 3, 1), gx)
    close("running_mean", port.running_mean, stats["mean"])
    close("running_var", port.running_var, stats["var"])
    nets = {0.9: te.ConvBN(4, 8, 3)[1].momentum,
            0.97: tyolo.YoloConv(4, 8).norm.momentum,
            0.99: ConvBNReLU(4, 8, 3).bn.momentum}
    assert np.isclose(nets[momentum], 1 - momentum)
    assert jyolo.BN_MOMENTUM_FLAX == 0.97


def test_step_refuses_a_mesh():
    """A mesh of one device runs the step as mesh=None does, bit for bit:
    one step of a conv, BatchNorm, dropout and conv net, microbatches 2."""
    from autoware_vision_pilot_tpu_torch.core.mesh import make_mesh

    rng = np.random.default_rng(40)
    x = torch.from_numpy(rng.normal(0, 1, (4, 3, 8, 16)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, 3, (4, 8, 16)))
    runs = []
    for mesh in (None, make_mesh(devices=["cpu"])):
        net = tl.init_seeded(torch.nn.Sequential(tl.Conv2d(3, 8, 3, 1, 1), tl.BatchNorm2d(8),
                                                 tl.Dropout(0.2), tl.Conv2d(8, 3, 1)),
                             torch.Generator().manual_seed(41))
        state = tts.create_seg_train_state(net, tts.adamw(1e-3))
        step = tts.make_seg_train_step(tlo.segmentation_ce_loss, mesh=mesh, microbatches=2)
        state, loss = step(state, x, ids, torch.Generator().manual_seed(42))
        runs.append((loss, net.state_dict()))
    (loss, want), (got_loss, got) = runs
    assert torch.equal(got_loss, loss)
    assert all(torch.equal(got[k], want[k]) for k in want)
