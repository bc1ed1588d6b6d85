"""The int8 1x1 convs' routes ("pointwise" and "dot", csrc/int8_pointwise.cu)
on the CPU: their plans, a replay of the pointwise route's tiles, K steps
and cluster split-K and of the dot route's lane split, and int8_conv2d at
the main path's 1x1 shapes against the int8 branch of the JAX package's
Conv2d (nn/layers.py:81-113).

The kernels run only on the card (tests/test_torch_cuda.py holds them to
the plain versions there). What surrounds them is plain Python and is held
here: each 1x1 conv takes the route meant for it; the pointwise tiles
cover every output once and the blocks of a cluster take contiguous K
ranges that cover every channel once, each walked in K steps of PW_STEP
channels whose values past the range read as zeros; the dot's lanes take
every 16-channel chunk once; and the sums over the ranks' (lanes') int32
partial tiles are the plain version's accumulators exactly, at the main
path's, the min_channels-128 and the Lite nets' 1x1 shapes. Integer sums
(float64 products of int8 values are exact), so every comparison is exact;
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
    DOT_CHUNK, DOT_MAX_M, MAX_CLUSTER, PW_BK, PW_MIN_RANGE, PW_STEP, PW_WIDTHS, SMS, int8_conv2d,
    int8_conv_plain, int8_conv_plan)

from test_torch_int8 import bf16_ulps, scale_for
from test_torch_layers import from_port, normal_input, seeded_variables, to_port
from test_torch_train_step import one_thread  # noqa: F401 (an autouse fixture)

CL = torch.channels_last
# (cin, cout, h, w, convs per frame): the main path's 1x1 int8 convs, the
# last three the SE squeezes on 1x1 maps (tests/test_torch_int8_plan.py)
POINTWISE = ((320, 1280, 10, 20, 2), (1152, 320, 10, 20, 2), (672, 112, 20, 40, 4),
             (1152, 192, 10, 20, 6), (480, 112, 20, 40, 2), (480, 80, 20, 40, 4),
             (672, 192, 10, 20, 2))
SE = ((1152, 48, 1, 1, 8), (672, 28, 1, 1, 6), (480, 20, 1, 1, 6))
IDS = [f"{ci}-{co}-{h}x{w}" for ci, co, h, w, _ in POINTWISE]
# (cin, cout, h, w): the 1x1 convs that int8_min_channels 128 adds (the
# wrappers; tests/test_torch_int8_plan.py::MIN128_INT8) and those of the
# Lite nets at 320x640 (chip_smoke.py::LITE_INT8_SHAPES), pointwise then dot
MORE_1X1 = ((144, 24, 80, 160), (144, 40, 40, 80), (240, 40, 40, 80), (240, 80, 20, 40),
            (192, 1152, 10, 20), (304, 256, 80, 160), (1280, 256, 20, 40), (320, 256, 20, 40),
            (320, 64, 20, 40), (192, 1152, 20, 40), (672, 192, 20, 40), (1152, 192, 20, 40),
            (1152, 320, 20, 40))
MORE_SE = ((144, 6), (240, 10), (320, 256), (320, 64))


def k_ranges(plan, C):
    """The channel range [lo, hi) of each rank of a pointwise cluster."""
    step = plan.per_split * plan.bk
    return [(z * step, min(C, (z + 1) * step)) for z in range(plan.splits)]


def k_steps(lo, hi, C):
    """A rank's K steps as the kernel walks them (csrc/int8_pointwise.cu,
    the producer's loop): (k0, the channels TMA lands from k0, the channels
    inside the range)."""
    return [(k0, min(C, k0 + PW_STEP) - k0, min(hi, k0 + PW_STEP) - k0)
            for k0 in range(lo, hi, PW_STEP)]


def operands(cin, cout, M, seed):
    g = torch.Generator().manual_seed(seed)
    a = torch.randint(-127, 128, (M, cin), generator=g, dtype=torch.int8)
    b = torch.randint(-127, 128, (cout, cin), generator=g, dtype=torch.int8)
    return a, b


def plain_acc(a, b):
    """int8_conv_plain's int32 accumulators of the (M, C) x (N, C) product."""
    M, C = a.shape
    xq = a.reshape(1, 1, M, C).permute(0, 3, 1, 2).contiguous(memory_format=CL)
    wq = b.reshape(*b.shape, 1, 1).contiguous(memory_format=CL)
    acc = int8_conv_plain(xq, wq, torch.ones(b.shape[0]), torch.tensor(1.0), None, 0, torch.int32)
    return acc.permute(0, 2, 3, 1).reshape(M, -1)


def pointwise_replay(a, b, plan):
    """The pointwise route in float64 torch on the CPU (exact: int8
    products, |sums| < 2^53): every (M tile, N tile) once; rank z of its
    cluster sums the K steps of its range, the values at or past the
    range's end as zeros; the ranks' partial tiles added. -> the (M, N)
    int32 accumulators."""
    M, C = a.shape
    N = b.shape[0]
    m_tiles, n_tiles, splits = plan.grid
    covered = torch.zeros(M, N, dtype=torch.int32)
    total = torch.zeros(M, N, dtype=torch.float64)
    a, b = a.double(), b.double()
    for mt in range(m_tiles):
        for nt in range(n_tiles):
            rows = slice(mt * plan.bm, min(M, (mt + 1) * plan.bm))
            cols = slice(nt * plan.bn, min(N, (nt + 1) * plan.bn))
            covered[rows, cols] += 1
            for lo, hi in k_ranges(plan, C):
                for k0, landed, live in k_steps(lo, hi, C):
                    assert live % 16 == 0 and 0 < live <= landed  # whole 16-channel groups
                    av = a[rows, k0:k0 + landed].clone()
                    av[:, live:] = 0  # past the range: zeros, not the next rank's values
                    total[rows, cols] += av @ b[cols, k0:k0 + landed].T
    assert bool((covered == 1).all())
    return total.to(torch.int32)


def dot_replay(a, b, plan):
    """The dot route in float64 torch: lane z of a channel's lanes sums the
    16-channel chunks z, z + lanes, ...; the xor shuffles add the lanes of
    each warp (every lane of it ends with the sum), and the first warp of
    a channel adds the others' sums. -> the (M, N) int32 accumulators."""
    C = a.shape[1]
    lanes = plan.grid[2]
    a, b = a.double(), b.double()
    taken = [list(range(z, plan.iters, lanes)) for z in range(lanes)]
    assert sorted(k for t in taken for k in t) == list(range(C // DOT_CHUNK))
    assert max(len(t) for t in taken) == plan.per_split
    p = [sum((a[:, k * 16:k * 16 + 16] @ b[:, k * 16:k * 16 + 16].T for k in t),
             torch.zeros(a.shape[0], b.shape[0], dtype=torch.float64)) for t in taken]
    span = min(lanes, 32)
    off = span // 2
    while off:
        p = [p[i] + p[i ^ off] for i in range(lanes)]
        off //= 2
    warps = [p[w * span:(w + 1) * span] for w in range(lanes // span)]
    assert all(torch.equal(q, w[0]) for w in warps for q in w)
    return sum(w[0] for w in warps).to(torch.int32)


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
        # K steps of PW_STEP channels from lo; the last ends at hi
        steps = k_steps(lo, hi, cin)
        assert steps[0][0] == lo and steps[-1][0] + steps[-1][2] == hi
    assert bool((seen == 1).all())
    # every range but the last holds at least PW_MIN_RANGE channels
    assert all(hi - lo >= PW_MIN_RANGE for lo, hi in ranges[:-1])
    # the clusters' blocks fit on the SMs at once
    assert plan.blocks == math.prod(plan.grid) <= SMS


def cluster_replay(xq, w, plan):
    """pointwise_replay on NCHW operands. -> the (B, N, H, W) accumulators."""
    B, C, H, W = xq.shape
    N = w.shape[0]
    acc = pointwise_replay(xq.permute(0, 2, 3, 1).reshape(-1, C), w.reshape(N, C), plan)
    return acc.reshape(B, H, W, N).permute(0, 3, 1, 2)


@pytest.mark.parametrize("cin,cout,h,w,per_frame", POINTWISE, ids=IDS)
def test_cluster_split_k_replay_matches_plain_accumulators(cin, cout, h, w, per_frame):
    g = torch.Generator().manual_seed(cin + cout)
    xq = torch.randint(-127, 128, (1, cin, h, w), generator=g,
                       dtype=torch.int8).contiguous(memory_format=CL)
    wq = torch.randint(-127, 128, (cout, cin, 1, 1), generator=g,
                       dtype=torch.int8).contiguous(memory_format=CL)
    plan = int8_conv_plan(1, h, w, cin, cout, 1, 1, 0)
    # K splits wherever the tiles leave half the SMs idle (not 320 -> 1280's 80)
    assert (plan.splits > 1) == (SMS // (plan.grid[0] * plan.grid[1]) >= 2)
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


@pytest.mark.parametrize("cin,cout,h,w", MORE_1X1,
                         ids=[f"{c}-{n}-{h}x{w}" for c, n, h, w in MORE_1X1])
def test_pointwise_replay_at_min128_and_lite_shapes(cin, cout, h, w):
    """The wrappers' min_channels-128 and the Lite nets' 1x1 convs: the
    plan's tiles, K ranges and steps give the plain accumulators."""
    plan = int8_conv_plan(1, h, w, cin, cout, 1, 1, 0)
    assert plan.route == "pointwise"
    a, b = operands(cin, cout, h * w, cin + cout + h)
    assert torch.equal(pointwise_replay(a, b, plan), plain_acc(a, b))


@pytest.mark.parametrize("bn", PW_WIDTHS)
@pytest.mark.parametrize("bm", [64, 128])
@pytest.mark.parametrize("cs", range(1, MAX_CLUSTER + 1))
def test_pointwise_replay_of_every_tile_and_cluster(bn, bm, cs):
    """Every N width, both M tiles and every cluster size, as the card
    tests force them on a ragged shape (M = 117, N = 100, C = 1152): the
    replay gives the plain accumulators."""
    M, C, N = 117, 1152, 100
    per_split = math.ceil(C / PW_BK / cs)
    plan = int8_conv_plan(1, 9, 13, C, N, 1, 1, 0)._replace(
        bm=bm, bn=bn, grid=(math.ceil(M / bm), math.ceil(N / bn), math.ceil(C / PW_BK / per_split)),
        per_split=per_split)
    a, b = operands(C, N, M, bn + bm + cs)
    assert torch.equal(pointwise_replay(a, b, plan), plain_acc(a, b))


@pytest.mark.parametrize("cin,cout", [(c, n) for c, n, *_ in SE] + list(MORE_SE),
                         ids=[f"{c}-{n}" for c, n, *_ in SE] + [f"{c}-{n}" for c, n in MORE_SE])
@pytest.mark.parametrize("batch", [1, 2, 5, DOT_MAX_M])
def test_dot_lane_split_replay(cin, cout, batch):
    """The dot route's K split at the SE squeezes of the main path, the
    wrappers and the Lite nets' pooled ASPP branch, M = 1-8: each lane's
    chunks, the xor shuffles, the warps' sums, the plain accumulators."""
    plan = int8_conv_plan(batch, 1, 1, cin, cout, 1, 1, 0)
    assert plan.route == "dot"
    a, b = operands(cin, cout, batch, cin + cout + batch)
    assert torch.equal(dot_replay(a, b, plan), plain_acc(a, b))


@pytest.mark.parametrize("shape", [(1, 10, 20, 320, 64, 1, 1, 1), (1, 1, 1, 480, 20, 1, 1, 2)])
def test_padded_1x1_window_takes_the_mma_route(shape):
    assert int8_conv_plan(*shape).route == "halo"


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


def test_reciprocal_of_an_inference_tensor():
    """A scale made under torch.inference_mode (the per-channel scale that
    _conv pads to 16 channels there) has no version counter: its reciprocal
    is computed each call and not kept; an ordinary scale's is kept."""
    from autoware_vision_pilot_tpu_torch.ops.kernels.int8_conv import _reciprocal

    with torch.inference_mode():
        s = torch.nn.functional.pad(torch.full((40,), 0.02), (0, 8), value=1.0)
        r = _reciprocal(s)
        assert s.is_inference() and not hasattr(s, "_rcp")
        assert torch.equal(r, torch.reciprocal(s.double()))
    t = torch.full((48,), 0.02)
    assert _reciprocal(t) is _reciprocal(t) and hasattr(t, "_rcp")


def quantize_fast_replay(v, s):
    """csrc/int8_common.cuh::quantize4_fast_path on the CPU, op for op
    (each product and sum rounded alone). -> (its int8 values, the mask of
    the values it keeps; the others take quantize_rcp)."""
    magic = 12582912.0  # 1.5 * 2^23
    r32 = torch.reciprocal(s.double()).float()
    y = v * r32
    m = y + magic
    fr = y - (m - magic)
    kept = fr.abs() < 0.5 - y.abs() * 2.0 ** -21  # the product exact: an FMA's value
    return (m.view(torch.int32) - 0x4B400000).clamp(-127, 127), kept


@pytest.mark.parametrize("seed", [11, 12])
def test_fast_quantize_equals_the_division_where_it_decides(seed):
    """The fast path of the 1x1 routes' quantize: where it keeps a value,
    its int8 value is clamp(round_half_even(v / s)) exactly; near a
    half-integer (v one ulp either side of (k + 1/2) * s, and exact ties)
    it hands the value to the float64 path, and it keeps nearly all of the
    others below 1000 * s (and none from 2^20 * s). 4M pairs over 60
    octaves of v and s's calibrated range."""
    g = torch.Generator().manual_seed(seed)
    n = 2_000_000
    s = torch.rand(n, generator=g) * 0.05 + 1e-6
    v = torch.randn(n, generator=g) * torch.exp2(torch.randint(-30, 30, (n,), generator=g).float())
    k = torch.randint(-130, 130, (n,), generator=g).double() + 0.5
    mid = (k * s.double()).float()
    near = torch.where(torch.rand(n, generator=g) < 0.5, torch.nextafter(mid, mid + 1),
                       torch.nextafter(mid, mid - 1))
    for x, least in ((v, 0.999), (near, 0.0), (mid, 0.0)):
        want = torch.clamp(torch.round(x / s), -127, 127).to(torch.int32)
        got, kept = quantize_fast_replay(x, s)
        assert torch.equal(got[kept], want[kept])
        inside = (x / s).abs() < 1000  # where calibrated activations lie
        assert kept[inside].double().mean().item() >= least
        assert not kept[(x / s).abs() >= 2.0 ** 20].any()
    # ties (v / s exactly k + 1/2 in f32) never take the fast path
    tie = (torch.arange(-127, 127).double() + 0.5).float()
    assert not quantize_fast_replay(tie, torch.ones_like(tie))[1].any()
