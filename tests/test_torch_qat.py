"""The port's QAT (autoware_vision_pilot_tpu_torch/train/qat.py) against the
JAX package's train/qat.py, on the CPU in f32: on JAX's tiny QAT model
(tests/test_qat.py) and on SceneSeg at dryrun depth (B0_DRYRUN_STAGES,
ctx_hw (2, 4), 64x128).

Fake-quant rounds to a grid, so a last-bit difference in a float
activation can move a value to the next int8 step. Where activations are
fake-quanted, each port conv is therefore fed the input JAX's conv saw
(captured with an outer flax interceptor, before JAX's fake-quant; a
forward pre-hook registered before the QAT hooks): the observers are then
bit-equal, and outputs within atol 2e-4, rtol 1e-3. The STE and the
selection are bit-equal.
"""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from autoware_vision_pilot_tpu.models import efficientnet as je
from autoware_vision_pilot_tpu.models.scene_seg import SceneSegNetwork as JSceneSeg
from autoware_vision_pilot_tpu.nn import layers as jl
from autoware_vision_pilot_tpu.train import qat as jqat
from autoware_vision_pilot_tpu_torch.convert.from_jax import (_merge_digits,
                                                               variables_to_state_dict)
from autoware_vision_pilot_tpu_torch.models import efficientnet as te
from autoware_vision_pilot_tpu_torch.models.scene_seg import SceneSegNetwork
from autoware_vision_pilot_tpu_torch.nn import layers as tl
from autoware_vision_pilot_tpu_torch.train import qat as tqat

from test_torch_layers import ATOL, RTOL, from_port, port_with, seeded_variables, to_port
from test_torch_train_step import one_thread  # noqa: F401 (an autouse fixture)

CTX, HW = (2, 4), (64, 128)


class JTiny(fnn.Module):
    """tests/test_qat.py's tiny model."""

    @fnn.compact
    def __call__(self, x, train: bool = False):
        h = jl.Conv2d(64, 3, padding=1, name="c1")(x)
        h = jax.nn.relu(h)
        h = jl.Conv2d(64, 3, padding=1, name="c2")(h)
        return jl.Conv2d(3, 1, name="head")(h)


class Tiny(nn.Module):
    def __init__(self):
        super().__init__()
        self.c1 = tl.Conv2d(3, 64, 3, 1, 1)
        self.c2 = tl.Conv2d(64, 64, 3, 1, 1)
        self.head = tl.Conv2d(64, 3, 1)

    def forward(self, x):
        return self.head(self.c2(torch.relu(self.c1(x))))


def name_map(port):
    """JAX module path tuple -> the port's named_modules() name."""
    return {tuple(_merge_digits(n).split(".")): n for n, _ in port.named_modules() if n}


def rnd(shape, seed):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


def capture_conv_inputs():
    """An outer flax interceptor sowing every Conv2d's input (before the
    QAT interceptor) as ``intermediates/x_in``."""
    def intercept(next_fun, args, kwargs, context):
        m = context.module
        if isinstance(m, jl.Conv2d) and context.method_name == "__call__":
            m.sow("intermediates", "x_in", args[0])
        return next_fun(*args, **kwargs)
    return fnn.intercept_methods(intercept)


def sown(tree, key):
    """{path tuple: [values]} of every ``key`` leaf of a sown tree."""
    out = {}

    def walk(node, path):
        for k, v in node.items():
            if k == key:
                out[tuple(path)] = [np.asarray(x) for x in v]
            elif isinstance(v, dict):
                walk(v, path + [k])
    walk(tree, [])
    return out


def jax_qat(jmod, v, x, **kw):
    """JAX's qat_apply, jitted, with every conv's input and observer ->
    (output, {path: input}, {path: scale}, {path: amax})."""
    @jax.jit  # the variables are arguments: as constants XLA would fold the fake-quant
    def run(vv, xx):
        with capture_conv_inputs():
            return jqat.qat_apply(jmod, vv, xx, mutable=["intermediates"], **kw)
    out, mut = run(v, jnp.asarray(x))
    inter = jax.tree.map(np.asarray, mut["intermediates"])
    inputs = {p: vals[0] for p, vals in sown(inter, "x_in").items()}
    amax = {p: vals[0] for p, vals in sown(inter, "qat_act_amax").items()}
    return np.asarray(out), inputs, jqat.collect_act_scales(inter), amax


def forcing(port, inputs):
    """Forward pre-hooks feeding each port Conv2d the JAX input of its path
    (register before qat_apply, so they run before its hooks)."""
    names = {n: p for p, n in name_map(port).items()}
    handles = [m.register_forward_pre_hook(
        lambda m, a, p=names[n]: (to_port(inputs[p]),) + tuple(a[1:]))
        for n, m in port.named_modules() if isinstance(m, tl.Conv2d) and names[n] in inputs]
    return lambda: [h.remove() for h in handles]


def test_fake_quant_ste_values_and_gradients():
    w = rnd((3, 3, 48, 16), 0)  # HWIO
    for j_axis, t_axis in ((None, None), ((0, 1, 2), (1, 2, 3))):
        want = np.asarray(jqat.fake_quant_ste(jnp.asarray(w), axis=j_axis))
        wt = torch.from_numpy(w.transpose(3, 2, 0, 1).copy()).requires_grad_(True)
        got = tqat.fake_quant_ste(wt, axis=t_axis)
        np.testing.assert_array_equal(got.detach().numpy().transpose(2, 3, 1, 0), want)
        got.sum().backward()
        assert torch.equal(wt.grad, torch.ones_like(wt))
    x = rnd((2, 8, 8, 24), 1)
    for scale in (0.0123, np.random.default_rng(2).uniform(0.005, 0.03, 24).astype(np.float32)):
        want = np.asarray(jqat.fake_quant_ste_static(jnp.asarray(x), scale))
        xt = to_port(x).requires_grad_(True)
        got = tqat.fake_quant_ste_static(xt, scale)
        np.testing.assert_array_equal(from_port(got), want)
        got.sum().backward()
        assert torch.equal(xt.grad, torch.ones_like(xt))


@pytest.fixture(scope="module")
def scene_seg():
    jmod = JSceneSeg(ctx_hw=CTX, backbone_stages=je.B0_DRYRUN_STAGES)
    v = seeded_variables(jmod, jnp.zeros((1, *HW, 3)), seed=11)
    return jmod, v, rnd((2, *HW, 3), 12)


@pytest.mark.parametrize("min_channels", [32, 128])
def test_selection_matches_jax(scene_seg, min_channels):
    jmod, v, _ = scene_seg
    fq = jax.jit(lambda p: jqat.fake_quant_params(p, min_channels))(v["params"])
    picked = set()

    def walk(a, b, path):  # a fake-quanted leaf moves to the int8 grid
        for k in a:
            if isinstance(a[k], dict):
                walk(a[k], b[k], path + (k,))
            elif not np.array_equal(np.asarray(a[k]), np.asarray(b[k])):
                picked.add(path)
    walk(v["params"], fq, ())
    port = port_with(SceneSegNetwork(CTX, te.B0_DRYRUN_STAGES), v)
    names = name_map(port)
    assert {names[p] for p in picked} == set(tqat.selected_convs(port, min_channels))
    assert set(tqat.fake_quant_params(port, min_channels)) == \
        {f"{names[p]}.weight" for p in picked}
    assert len(picked) == (30 if min_channels == 32 else 20)


@pytest.mark.parametrize("per_channel", [False, True])
def test_qat_apply_and_observers_tiny(per_channel):
    jmod = JTiny()
    v = seeded_variables(jmod, jnp.zeros((1, 16, 32, 3)), seed=13)
    x = rnd((2, 16, 32, 3), 14)
    want, inputs, jscales, jamax = jax_qat(jmod, v, x, per_channel_act=per_channel)
    port = port_with(Tiny(), v)
    remove = forcing(port, inputs)
    observers = {}
    try:
        got = tqat.qat_apply(port, to_port(x), per_channel_act=per_channel,
                             observers=observers)
    finally:
        remove()
    np.testing.assert_allclose(from_port(got), want, atol=ATOL, rtol=RTOL)
    assert set(observers) == {"c2", "head"} == {p[0] for p in jamax}
    for name, amax in observers.items():
        np.testing.assert_array_equal(amax[0].numpy(), jamax[(name,)])
    scales = tqat.collect_act_scales(observers)
    assert scales.keys() == {p[0] for p in jscales}
    for name, s in scales.items():
        np.testing.assert_array_equal(np.asarray(s), np.asarray(jscales[(name,)]))
        assert isinstance(s, float) != per_channel


def test_qat_weight_gradients_tiny():
    """Weights fake-quanted, activations float: the loss and every
    gradient (straight through the weight fake-quant) against JAX's."""
    jmod = JTiny()
    v = seeded_variables(jmod, jnp.zeros((1, 16, 32, 3)), seed=15)
    x = rnd((2, 16, 32, 3), 16)

    def jloss(params):
        out = jqat.qat_apply(jmod, {"params": params}, jnp.asarray(x), quant_acts=False)
        return jnp.mean(out ** 2)

    jl_, jg = jax.value_and_grad(jloss)(v["params"])
    port = port_with(Tiny(), v)
    for p in port.parameters():
        p.requires_grad_(True)
    loss = (tqat.qat_apply(port, to_port(x), quant_acts=False) ** 2).mean()
    loss.backward()
    assert np.isclose(loss.item(), float(jl_), atol=ATOL, rtol=RTOL)
    for name in ("c1", "c2", "head"):
        m = port.get_submodule(name)
        np.testing.assert_allclose(m.weight.grad.numpy().transpose(2, 3, 1, 0),
                                   np.asarray(jg[name]["w"]), atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(m.bias.grad.numpy(), np.asarray(jg[name]["b"]),
                                   atol=ATOL, rtol=RTOL)


def test_frozen_observers_tiny():
    """static_scales: the deployed scale's fake-quant; a conv without one
    passes its input as it is."""
    jmod = JTiny()
    v = seeded_variables(jmod, jnp.zeros((1, 16, 32, 3)), seed=17)
    x = rnd((2, 16, 32, 3), 18)
    frozen = {"c2": 0.021}  # head has none
    want, inputs, _, _ = jax_qat(jmod, v, x, static_scales={("c2",): 0.021})
    port = port_with(Tiny(), v)
    remove = forcing(port, inputs)
    try:
        got = tqat.qat_apply(port, to_port(x), static_scales=frozen)
    finally:
        remove()
    np.testing.assert_allclose(from_port(got), want, atol=ATOL, rtol=RTOL)


def test_qat_loss_train_and_freeze_bn(scene_seg):
    """make_qat_loss on SceneSeg: in train mode the BatchNorm statistics
    move as JAX's do (fed JAX's conv inputs); with freeze_bn the forward
    is eval-mode (no update, JAX's value) and the model keeps its mode."""
    jmod, v, x = scene_seg
    tgt = np.random.default_rng(19).integers(0, 3, (2, *HW)).astype(np.int32)
    from autoware_vision_pilot_tpu.train.losses import segmentation_ce_loss as jce
    from autoware_vision_pilot_tpu_torch.train.losses import segmentation_ce_loss as tce

    for freeze in (False, True):
        jfn = jqat.make_qat_loss(jmod, jce, freeze_bn=freeze)

        @jax.jit
        def run(params, batch_stats, xx):
            with capture_conv_inputs():
                return jfn(params, batch_stats, xx, jnp.asarray(tgt),
                           rngs={"dropout": jax.random.key(0)})
        jloss, mut = run(v["params"], v["batch_stats"], jnp.asarray(x))
        inputs = {p: a[0] for p, a in sown(jax.tree.map(np.asarray, mut["intermediates"]),
                                          "x_in").items()}
        port = port_with(SceneSegNetwork(CTX, te.B0_DRYRUN_STAGES), v)
        port.train()
        before = {k: t.clone() for k, t in port.state_dict().items()}
        remove = forcing(port, inputs)
        try:
            if freeze:
                loss, obs = tqat.make_qat_loss(port, tce, freeze_bn=True)(
                    to_port(x), torch.from_numpy(tgt))
            else:
                # the masks differ (the context block's dropout; every conv
                # after it is fed JAX's input): compare the BN statistics
                with tl.dropout_generator(torch.Generator()):
                    tqat.qat_apply(port, to_port(x))
        finally:
            remove()
        assert port.training
        if freeze:
            assert np.isclose(loss.item(), float(jloss), atol=ATOL, rtol=RTOL)
            assert all(torch.equal(before[k], t) for k, t in port.state_dict().items())
            assert len(obs) == len(sown(jax.tree.map(np.asarray, mut["intermediates"]),
                                        "qat_act_amax"))
        else:
            want = variables_to_state_dict(
                {"params": v["params"], "batch_stats": jax.tree.map(np.asarray,
                                                                   mut["batch_stats"])}, port)
            stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
            for k in stats:
                np.testing.assert_allclose(port.state_dict()[k].numpy(), want[k].numpy(),
                                           atol=ATOL, rtol=RTOL, err_msg=k)
            assert stats and not all(torch.equal(before[k], want[k]) for k in stats)
