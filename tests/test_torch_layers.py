"""The PyTorch port's layers against the JAX package's (nn/layers.py), on
the CPU in f32, plus the helpers the other test_torch_* files share.

Inputs and JAX parameters are drawn with numpy from a seed; the port's
modules get the same parameters through the weight bridge
(autoware_vision_pilot_tpu_torch/convert/from_jax.py). Tolerance: atol
2e-4, rtol 1e-3 in f32, the bar of tests/test_models_parity.py; it covers
summation order and the JAX ConvTranspose's CPU einsum lowering (~1 ulp).
"""
import flax.linen as fnn
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax import lax

from autoware_vision_pilot_tpu.nn import layers as jl
from autoware_vision_pilot_tpu_torch.convert.from_jax import variables_to_state_dict
from autoware_vision_pilot_tpu_torch.nn import layers as tl

P = lax.Precision.HIGHEST
ATOL, RTOL = 2e-4, 1e-3


def seeded_variables(model, *inputs, seed=0):
    """JAX variables for ``model`` without running init: shapes from
    ``jax.eval_shape``, values from numpy. Weights are normal with std
    1/sqrt(fan_in) (fan_in = the inputs summed into one output), biases
    and BatchNorm statistics non-trivial, as in ``randomize_bn_stats``."""
    shapes = jax.eval_shape(model.init, jax.random.key(0), *inputs)
    rng = np.random.default_rng(seed)

    def normal(shape, mean, std):
        return (rng.standard_normal(shape, dtype=np.float32) * std
                + mean).astype(np.float32)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name in ("w", "wl"):
            return normal(shape, 0.0, np.prod(shape[:-1]) ** -0.5)
        if name == "wt":  # (kh, kw, O, I): each output sums I inputs
            return normal(shape, 0.0, shape[-1] ** -0.5)
        if name == "w1":  # Conv1d (3, I, O) on a length-1 sequence: its centre tap sums I
            return normal(shape, 0.0, shape[1] ** -0.5)
        if name == "b":
            return normal(shape, 0.0, 0.1)
        if name == "scale":
            return normal(shape, 1.0, 0.2)
        if name == "bias":
            return normal(shape, 0.0, 0.2)
        if name == "mean":
            return normal(shape, 0.0, 0.5)
        if name == "var":
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        raise KeyError(f"no seeded value for leaf {name}")

    return jax.tree_util.tree_map_with_path(fill, shapes)


def port_with(module, variables):
    """Load JAX ``variables`` into the port's ``module`` (strict) -> eval."""
    module.load_state_dict(variables_to_state_dict(variables, module),
                           strict=True)
    return module.eval()


def to_port(x_nhwc):
    """numpy NHWC -> torch NCHW (channels_last view of the same buffer)."""
    return torch.from_numpy(np.ascontiguousarray(x_nhwc)).permute(0, 3, 1, 2)


def from_port(y_nchw):
    return y_nchw.detach().permute(0, 2, 3, 1).numpy()


def assert_close(port_nchw, ref_nhwc, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(from_port(port_nchw), np.asarray(ref_nhwc),
                               atol=atol, rtol=rtol)


def normal_input(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def jax_int8_calls(jmod, variables, x):
    """Eager apply of ``jmod`` -> (outputs, [(path, input, output)] of every
    int8 conv in call order), as numpy."""
    calls = []

    def intercept(next_fun, args, kwargs, context):
        y = next_fun(*args, **kwargs)
        m = context.module
        if (isinstance(m, jl.Conv2d) and context.method_name == "__call__"
                and m.has_variable("params", "w_scale")):
            calls.append((".".join(m.path), np.array(args[0]), np.array(y)))
        return y

    with fnn.intercept_methods(intercept):
        out = jmod.apply(variables, x)
    return out, calls


def port_int8_calls(nets, forced=None):
    """Hooks on every Int8Conv2d of ``nets``: record (name, NHWC input,
    NHWC output, module) in call order; with ``forced``, a list of NHWC
    arrays in that order, replace each conv's input by the next one.
    -> (calls, remove)."""
    calls = []
    names = {m: n for net in nets for n, m in net.named_modules()}

    def pre(m, args):
        if forced is not None:
            return (to_port(forced[len(calls)]).contiguous(
                memory_format=torch.channels_last),)

    def post(m, args, y):
        calls.append((names[m], from_port(args[0]), from_port(y), m))

    handles = [h for m in names if isinstance(m, tl.Int8Conv2d)
               for h in (m.register_forward_pre_hook(pre), m.register_forward_hook(post))]
    return calls, lambda: [h.remove() for h in handles]


def test_gelu_f32_is_exact_erf():
    x = normal_input((4096,)) * 3
    ref = np.asarray(jl.gelu(jnp.asarray(x)))
    out = tl.gelu(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=1e-6)
    tanh = torch.nn.functional.gelu(torch.from_numpy(x), approximate="tanh")
    assert not torch.equal(torch.from_numpy(out), tanh)


def test_gelu_bf16_is_tanh_approximation():
    x = normal_input((4096,), seed=1) * 3
    xb = torch.from_numpy(x).bfloat16()
    out = tl.gelu(xb)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, torch.nn.functional.gelu(xb, approximate="tanh"))
    ref = np.asarray(jl.gelu(jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    # bf16 resolution: one ulp relative, 2^-6 absolute where values cancel
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=2 ** -7,
                               atol=2 ** -6)


def test_silu():
    x = normal_input((1000,), seed=2)
    np.testing.assert_allclose(tl.silu(torch.from_numpy(x)).numpy(),
                               np.asarray(jl.silu(jnp.asarray(x))),
                               atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("k,stride,pad,groups,dilation,bias", [
    (3, 1, 1, 1, 1, True),     # plain 3x3
    (3, 2, 1, 1, 1, False),    # strided, no bias (the B0 stem)
    (5, 2, 2, 16, 1, False),   # depthwise
    (3, 1, 2, 16, 2, False),   # depthwise dilated
    (3, 1, 2, 1, 2, True),     # dilated
    (1, 1, 0, 1, 1, True),     # 1x1 skip link
])
def test_conv2d(k, stride, pad, groups, dilation, bias):
    x = normal_input((2, 12, 20, 16), seed=k + stride + groups)
    cout = 16 if groups > 1 else 24
    jmod = jl.Conv2d(cout, k, stride, pad, groups=groups, use_bias=bias,
                     dilation=dilation, precision=P)
    v = seeded_variables(jmod, x, seed=3)
    port = port_with(tl.Conv2d(16, cout, k, stride, pad, groups, bias,
                               dilation), v)
    assert_close(port(to_port(x)), jmod.apply(v, x))


def test_conv_transpose2d_k2_s2():
    x = normal_input((2, 5, 7, 24), seed=4)
    jmod = jl.ConvTranspose2d(12, 2, 2, precision=P)
    v = seeded_variables(jmod, x, seed=5)
    port = port_with(tl.ConvTranspose2d(24, 12, 2), v)
    y = port(to_port(x))
    assert y.shape == (2, 12, 10, 14)
    assert_close(y, jmod.apply(v, x))


def test_linear():
    x = normal_input((3, 40), seed=6)
    jmod = jl.Linear(17, precision=P)
    v = seeded_variables(jmod, x, seed=7)
    port = port_with(tl.Linear(40, 17), v)
    np.testing.assert_allclose(port(torch.from_numpy(x)).numpy(),
                               np.asarray(jmod.apply(v, x)),
                               atol=ATOL, rtol=RTOL)


def test_batchnorm_eval():
    x = normal_input((2, 6, 8, 10), seed=8)
    jmod = jl.BatchNorm2d()
    v = seeded_variables(jmod, x, seed=9)  # nn/layers wraps flax BN as '.bn'
    port = port_with(tl.BatchNorm2d(10), v)
    assert_close(port(to_port(x)), jmod.apply(v, x), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("kernel,stride,pad", [(2, 2, 0), (3, 2, 1), (3, 1, 0)])
def test_max_pool2d(kernel, stride, pad):
    x = normal_input((2, 9, 13, 5), seed=10)
    ref = jl.max_pool2d(jnp.asarray(x), kernel, stride, pad)
    out = tl.max_pool2d(to_port(x), kernel, stride, pad)
    np.testing.assert_array_equal(from_port(out), np.asarray(ref))


def test_init_seeded_is_deterministic_and_device_free():
    def make(dtype):
        m = torch.nn.Sequential(tl.Conv2d(8, 16, 3, 1, 1, dtype=dtype),
                                tl.BatchNorm2d(16, dtype=dtype),
                                tl.ConvTranspose2d(16, 4, dtype=dtype),
                                tl.Linear(4, 3, dtype=dtype))
        return tl.init_seeded(m, torch.Generator().manual_seed(11))

    a, b, c = make(torch.float32), make(torch.float32), make(torch.bfloat16)
    for (k, ta), tb, tc in zip(a.state_dict().items(), b.state_dict().values(),
                               c.state_dict().values()):
        assert torch.isfinite(ta).all(), k
        assert torch.equal(ta, tb), k
        assert torch.equal(ta.bfloat16(), tc), k
    bn = a[1]
    assert bn.running_var.min() >= 0.5 and bn.running_mean.abs().max() > 0
    assert a[0].weight.std().item() == pytest.approx((2 / 72) ** 0.5, rel=0.2)
