"""The int8 1x1 convs' routes ("pointwise" and "dot", csrc/int8_pointwise.cu)
on the CPU: their plans, a replay of the pointwise route's cluster split-K,
and int8_conv2d at the main path's 1x1 shapes against the int8 branch of the
JAX package's Conv2d (nn/layers.py:81-113).

The kernels run only on the card (tests/test_torch_cuda.py holds them to
the plain versions there). What surrounds them is plain Python and is held
here: each 1x1 conv of the main path takes the route meant for it, the
blocks of a cluster take contiguous K ranges that cover every channel once,
and the leader's sum of the ranks' int32 partial tiles is the plain
version's accumulators exactly. Integer sums, so every comparison is exact;
the f32 layer is bit-equal to JAX's eager apply, bf16 within one bf16 ulp
(tests/test_torch_int8.py gives the reasons).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoware_vision_pilot_tpu.export.quantize import (
    quantize_variables_for_int8_conv as jax_quantize)
from autoware_vision_pilot_tpu.nn import layers as jl
from autoware_vision_pilot_tpu_torch.convert.from_jax import variables_to_state_dict
from autoware_vision_pilot_tpu_torch.nn import layers as tl
from autoware_vision_pilot_tpu_torch.ops.kernels.int8_conv import (
    DOT_MAX_M, MAX_CLUSTER, PW_BK, SMS, int8_conv2d, int8_conv_plain, int8_conv_plan)

from test_torch_int8 import bf16_ulps, scale_for
from test_torch_layers import from_port, normal_input, seeded_variables, to_port

CL = torch.channels_last
# (cin, cout, h, w, convs per frame): the main path's 1x1 int8 convs, the
# last three the SE squeezes on 1x1 maps (tests/test_torch_int8_plan.py)
POINTWISE = ((320, 1280, 10, 20, 2), (1152, 320, 10, 20, 2), (672, 112, 20, 40, 4),
             (1152, 192, 10, 20, 6), (480, 112, 20, 40, 2), (480, 80, 20, 40, 4),
             (672, 192, 10, 20, 2))
SE = ((1152, 48, 1, 1, 8), (672, 28, 1, 1, 6), (480, 20, 1, 1, 6))
IDS = [f"{ci}-{co}-{h}x{w}" for ci, co, h, w, _ in POINTWISE]


def k_ranges(plan, C):
    """The channel range [lo, hi) of each rank of a pointwise cluster."""
    step = plan.per_split * plan.bk
    return [(z * step, min(C, (z + 1) * step)) for z in range(plan.splits)]


def test_main_path_counts():
    assert sum(n for *_, n in POINTWISE) == 22 and sum(n for *_, n in SE) == 20


@pytest.mark.parametrize("cin,cout,h,w,per_frame", POINTWISE, ids=IDS)
def test_cluster_k_ranges_cover_every_channel_once(cin, cout, h, w, per_frame):
    plan = int8_conv_plan(1, h, w, cin, cout, 1, 1, 0)
    assert plan.route == "pointwise" and 1 <= plan.splits <= MAX_CLUSTER
    seen = torch.zeros(cin, dtype=torch.int32)
    ranges = k_ranges(plan, cin)
    for lo, hi in ranges:
        assert lo < hi and lo % PW_BK == 0  # no rank without channels
        seen[lo:hi] += 1
    assert bool((seen == 1).all())
    # every range but the last holds at least two mma steps of 32 channels
    assert all(hi - lo >= 2 * PW_BK for lo, hi in ranges[:-1])
    # the clusters' blocks come close to one per SM
    assert plan.blocks == math.prod(plan.grid) and abs(plan.blocks - SMS) <= 0.1 * SMS


def cluster_replay(xq, w, plan):
    """The pointwise route in int64 torch on the CPU: rank z sums its K
    range of the (M, C) x (C, N) product, then the leader adds the others'
    partial tiles to its own. -> the (B, N, H, W) accumulators."""
    B, C, H, W = xq.shape
    N = w.shape[0]
    a = xq.permute(0, 2, 3, 1).reshape(-1, C).long()
    b = w.reshape(N, C).long()
    partials = [a[:, lo:hi] @ b[:, lo:hi].T for lo, hi in k_ranges(plan, C)]
    leader = partials[0].clone()
    for p in partials[1:]:
        leader += p
    return leader.reshape(B, H, W, N).permute(0, 3, 1, 2)


@pytest.mark.parametrize("cin,cout,h,w,per_frame", POINTWISE, ids=IDS)
def test_cluster_split_k_replay_matches_plain_accumulators(cin, cout, h, w, per_frame):
    g = torch.Generator().manual_seed(cin + cout)
    xq = torch.randint(-127, 128, (1, cin, h, w), generator=g,
                       dtype=torch.int8).contiguous(memory_format=CL)
    wq = torch.randint(-127, 128, (cout, cin, 1, 1), generator=g,
                       dtype=torch.int8).contiguous(memory_format=CL)
    plan = int8_conv_plan(1, h, w, cin, cout, 1, 1, 0)
    assert (plan.splits > 1) == (cout != 1280)  # 140 tiles of 320 -> 1280 fill the SMs
    want = int8_conv_plain(xq, wq, torch.ones(cout), torch.tensor(1.0), None, 0, torch.int32)
    assert torch.equal(cluster_replay(xq, wq, plan).to(torch.int32), want)


@pytest.mark.parametrize("cin,cout,h,w,per_frame", SE, ids=[f"{c}-{n}" for c, n, *_ in SE])
@pytest.mark.parametrize("batch", [1, DOT_MAX_M, DOT_MAX_M + 1])
def test_se_convs_take_the_dot_route(cin, cout, h, w, per_frame, batch):
    """M = batch pixels: the dot route up to DOT_MAX_M rows, then pointwise."""
    plan = int8_conv_plan(batch, h, w, cin, cout, 1, 1, 0)
    assert plan.route == ("dot" if batch <= DOT_MAX_M else "pointwise")
    if plan.route == "dot":
        assert plan.bm == batch and plan.grid[1] * plan.bn >= cout


@pytest.mark.parametrize("shape", [(1, 10, 20, 320, 64, 1, 1, 1), (1, 1, 1, 480, 20, 1, 1, 2)])
def test_padded_1x1_window_takes_the_mma_route(shape):
    assert int8_conv_plan(*shape).route == "mma"


@pytest.mark.parametrize("scale", ["scalar", "vector"])
@pytest.mark.parametrize("cin,cout,hw", [
    (320, 1280, (2, 4)), (1152, 320, (2, 4)), (672, 112, (4, 8)),
    (1152, 48, (1, 1)), (672, 28, (1, 1)), (480, 20, (1, 1))])
def test_int8_conv2d_1x1_matches_jax(cin, cout, hw, scale):
    """int8_conv2d itself (the function both 1x1 routes compute on the
    card) at the main path's 1x1 widths on small maps, with the layer's
    own weights: f32 bit-equal to JAX, bf16 within one ulp."""
    seed = cin + cout + hw[0]
    x = normal_input((1, *hw, cin), seed=seed) * np.linspace(0.5, 2.0, cin, dtype=np.float32)
    jmod = jl.Conv2d(cout, 1, 1, 0)
    sx = scale_for(scale, x)
    qv = jax_quantize(seeded_variables(jmod, x, seed=seed + 1), 256, act_scales={(): sx})
    for dtype in (torch.float32, torch.bfloat16):
        m = tl.Int8Conv2d(cin, cout, 1, 0, dtype=dtype, input_scale_shape=sx.shape)
        m.load_state_dict(variables_to_state_dict(qv, m), strict=True)
        xj = x if dtype == torch.float32 else np.asarray(
            jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
        xt = to_port(xj).to(dtype)
        got = int8_conv2d(xt, m.weight, m.weight_scale, m.input_scale, m.bias, 0)
        assert got.dtype == dtype and got.is_contiguous(memory_format=CL)
        if dtype == torch.float32:
            np.testing.assert_array_equal(from_port(got), np.asarray(jmod.apply(qv, x)))
        else:
            ref = np.asarray(jmod.apply(qv, jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
            assert bf16_ulps(from_port(got.float()), ref) <= 1.0


def test_reciprocal_quantize_equals_the_division():
    """The arithmetic of csrc/int8_common.cuh::quantize_rcp (and of the
    preprocess kernel's division by std): RN32(RN64(v * RN64(1/s))) is
    RN32(v / s) for f32 v and s, so the 1x1 routes' quantize gives the
    quantize kernel's values bit for bit. 4M pairs over 60 octaves, half of
    them one ulp either side of (k + 1/2) * s, where a wrong rounding of
    the quotient would change the int8 value."""
    g = torch.Generator().manual_seed(7)
    n = 2_000_000
    s = torch.rand(n, generator=g) * 0.05 + 1e-6
    v = torch.randn(n, generator=g) * torch.exp2(torch.randint(-30, 30, (n,), generator=g).float())
    k = torch.randint(-130, 130, (n,), generator=g).double() + 0.5
    mid = (k * s.double()).float()
    near = torch.where(torch.rand(n, generator=g) < 0.5, torch.nextafter(mid, mid + 1),
                       torch.nextafter(mid, mid - 1))
    for x in (v, near):
        want = x / s
        got = (x.double() * torch.reciprocal(s.double())).float()
        assert torch.equal(got, want)
        assert torch.equal(torch.clamp(torch.round(got), -127, 127),
                           torch.clamp(torch.round(want), -127, 127))
