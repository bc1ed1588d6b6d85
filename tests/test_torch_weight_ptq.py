"""The port's weight-only PTQ (export/quantize.py: quantize_weights_int8,
dequantize_weights, weight_quant_error, QuantizedInference) against the JAX
package's (export/quantize.py:23-92), on the CPU in f32: the B0 trunk at
dryrun depth (the first four of B0_DRYRUN_STAGES' stages and the
1280-wide head conv, 32x64: convs, depthwise convs, SE, BatchNorm), a conv and a transposed conv, and AutoSpeed's CTX block (its
Conv1d, rank 3, per tensor).

The int8 values and scales are bit-equal (rtol 0, atol 0): both sides take
amax over the same axes (a rank-4 leaf per slice of the JAX axis 3, i.e.
per output channel of a conv and per input channel of a transposed conv;
the port's OIHW and IOHW dim 0), divide in f32 and round half to even.
The dequantized weights and the round-trip error are bit-equal too. JAX
runs op by op: jitted, XLA rewrites the division by 127 as a product with
its reciprocal and some scales land an ulp away.

QuantizedInference's outputs meet the f32 bar (atol 2e-4, rtol 1e-3)
against JAX's QuantizedInference run op by op (``jax.disable_jit``): both
round each dequantized weight to bf16 (``q.astype(bf16) * bf16(scale)``)
and compute in f32 for an f32 input. Jitted, XLA:CPU does not keep that
rounding (it may drop a bf16 round trip: excess precision): SceneSeg's
logits at dryrun depth moved by 2.4e-3 of 0.57 between JAX's jitted and
op-by-op runs, outside the bar.
"""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from autoware_vision_pilot_tpu.export import quantize as jq
from autoware_vision_pilot_tpu.models import yolo_layers as jyl
from autoware_vision_pilot_tpu.models.efficientnet import B0_DRYRUN_STAGES as J_DRYRUN
from autoware_vision_pilot_tpu.models.efficientnet import EfficientNetB0Features as JB0
from autoware_vision_pilot_tpu.nn import layers as jl
from autoware_vision_pilot_tpu_torch.convert.from_jax import variables_to_state_dict
from autoware_vision_pilot_tpu_torch.export import quantize as tq
from autoware_vision_pilot_tpu_torch.models import yolo_layers as tyl
from autoware_vision_pilot_tpu_torch.models.efficientnet import (B0_DRYRUN_STAGES,
                                                                  EfficientNetB0Features)
from autoware_vision_pilot_tpu_torch.nn import layers as tl

from test_torch_layers import (ATOL, P, RTOL, from_port, normal_input, port_with,
                               seeded_variables, to_port)
from test_torch_train_step import one_thread  # noqa: F401 (an autouse fixture)

class JUp(fnn.Module):
    """A 3x3 conv and a 2x2 transposed conv (per-input-channel scales)."""

    @fnn.compact
    def __call__(self, x):
        return jl.ConvTranspose2d(24, 2, 2, name="up")(jl.Conv2d(32, 3, padding=1, name="c")(x))


class PortUp(nn.Module):
    def __init__(self):
        super().__init__()
        self.c = tl.Conv2d(16, 32, 3, 1, 1)
        self.up = tl.ConvTranspose2d(32, 24, 2)

    def forward(self, x):
        return self.up(self.c(x))


# (JAX module, port module, input): the B0 trunk at dryrun depth (convs,
# depthwise convs, SE, BatchNorm), a transposed conv, and AutoSpeed's CTX
# block (its Conv1d: rank 3)
NETS = {
    "b0_dryrun": (lambda: JB0(stages=J_DRYRUN[:4], precision=P),
                  lambda: EfficientNetB0Features(B0_DRYRUN_STAGES[:4]), (1, 32, 64, 3)),
    "up": (JUp, PortUp, (2, 5, 7, 16)),
    "ctx": (lambda: jyl.CTX(16, 32, r=2, h=6, w=10, precision=P),
            lambda: tyl.CTX(16, 32, 2, 6, 10), (2, 6, 10, 16)),
}


@pytest.fixture(scope="module", params=list(NETS))
def nets(request):
    jmake, tmake, shape = NETS[request.param]
    jmod = jmake()
    x = normal_input(shape, seed=60)
    v = seeded_variables(jmod, jnp.asarray(x), seed=61)
    port = port_with(tmake(), v)
    return jmod, v, port, x


def listed(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def in_port_layout(tree, port, batch_stats):
    """A JAX params-shaped tree of f32 leaves -> the port's tensors by name."""
    return variables_to_state_dict({"params": tree, "batch_stats": batch_stats}, port)


def test_int8_values_and_scales_match_jax(nets):
    jmod, v, port, _ = nets
    jqv, jscales = jq.quantize_weights_int8(v["params"])
    q, scales = tq.quantize_weights_int8(port)
    stats = v.get("batch_stats", {})
    want_q = in_port_layout(jax.tree.map(lambda a: np.asarray(a, np.float32), jqv), port, stats)
    # each scale spread over its leaf's shape, so that it takes the leaf's layout
    want_s = in_port_layout(jax.tree.map(
        lambda a, s: np.broadcast_to(np.asarray(s, np.float32), a.shape), v["params"],
        jscales), port, stats)
    assert set(q) == set(dict(port.named_parameters()))
    ranks = {}
    for name, qv in q.items():
        assert qv.dtype == torch.int8, name
        np.testing.assert_array_equal(qv.float().numpy(), want_q[name].numpy(), err_msg=name)
        np.testing.assert_array_equal(scales[name].expand(qv.shape).numpy(),
                                      want_s[name].numpy(), err_msg=name)
        ranks[qv.dim()] = ranks.get(qv.dim(), 0) + 1
        per_channel = scales[name].dim() == 4
        assert per_channel == (qv.dim() == 4), name
    print(f"parameters by rank: {ranks}")

    dq = tq.dequantize_weights(q, scales)
    want_dq = in_port_layout(jq.dequantize_weights(jqv, jscales), port, stats)
    for name, a in dq.items():
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), want_dq[name].numpy(), err_msg=name)
    err = tq.weight_quant_error(port)
    assert err == jq.weight_quant_error(v["params"]) and 0 < err < 1 / 127


def test_quantized_inference_matches_jax(nets):
    jmod, v, port, x = nets
    jqi = jq.QuantizedInference(jmod, v, x.shape, compute_dtype=jnp.bfloat16)
    with jax.disable_jit():
        ref = listed(jqi(jnp.asarray(x)))
    qi = tq.QuantizedInference(port, compute_dtype=torch.bfloat16)
    xt = to_port(x).contiguous(memory_format=torch.channels_last)
    got = listed(qi(xt))
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(from_port(a), np.asarray(b), atol=ATOL, rtol=RTOL)
    # the weights it ran are the int8 ones dequantized in bf16, then f32
    w = qi.weights(torch.float32)
    for name, p in port.named_parameters():
        assert torch.equal(w[name], w[name].bfloat16().float()), name
        assert not torch.equal(w[name], p) or p.abs().max() == 0, name
    # the same module with those weights loaded computes the same outputs
    with torch.no_grad():
        plain = port_with(NETS_BY_PORT[type(port)](), v)
        for name, p in plain.named_parameters():
            p.copy_(w[name])
        again = listed(plain(xt))
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert qi.nbytes == sum(p.numel() for p in port.parameters()) + sum(
        s.numel() * 4 for s in qi.scales.values())


NETS_BY_PORT = {type(tmake()): tmake for _, tmake, _ in NETS.values()}


def test_quantized_inference_refuses_a_model_on_two_devices():
    port = tyl.CTX(16, 32, 2, 6, 10)
    port.exp0.weight = torch.nn.Parameter(port.exp0.weight.detach().to("meta"))
    with pytest.raises(ValueError, match="one device"):
        tq.QuantizedInference(port)
