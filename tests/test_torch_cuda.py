"""Tests of the port that need an NVIDIA GPU: the fused-preprocess (both
modes), int8, lane-filter and NMS CUDA kernels against their plain PyTorch
versions, one stream and a batch of them, the main path, bf16 and int8, the
lateral and longitudinal steps on the card against the CPU, the fleet and
the engines on the card, and the train step on the card against the CPU
and the QAT export's int8 calls. They skip where there is no CUDA device.

This file imports no JAX, so it also runs on a machine that has none:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import copy
import math

import numpy as np
import pytest
import torch

from autoware_vision_pilot_tpu_torch.models.efficientnet import B0_DRYRUN_STAGES
from autoware_vision_pilot_tpu_torch.nn.layers import Int8Conv2d
from autoware_vision_pilot_tpu_torch.ops.kernels.int8_conv import (
    PW_BK, PW_WIDTHS, _halo_plan, _launch, int8_conv, int8_conv2d, int8_conv_plain,
    int8_conv_plan, int8_quantize, int8_quantize_plain, padded_channels)
from autoware_vision_pilot_tpu_torch.ops.kernels import (lane_filter_kernel, nms_kernel,
                                                        preprocess_kernel)
from autoware_vision_pilot_tpu_torch.ops.kernels.lane_filter_kernel import lane_filter_walk
from autoware_vision_pilot_tpu_torch.ops.kernels.nms_kernel import nms_greedy
from autoware_vision_pilot_tpu_torch.ops.kernels.preprocess_kernel import (fused_letterbox,
                                                                           fused_preprocess)
from autoware_vision_pilot_tpu_torch.ops.postprocess import nms_greedy_plain, nms_topk
from autoware_vision_pilot_tpu_torch.ops.preprocess import (letterbox, letterbox_geometry,
                                                            preprocess_imagenet)
from autoware_vision_pilot_tpu_torch.perception.lane_filter import lane_filter_walk_plain
from autoware_vision_pilot_tpu_torch.pipeline import build_pipeline_fused
from autoware_vision_pilot_tpu_torch.runtime.pipeline import (SCALAR_FIELDS,
                                                              build_lateral_pipeline,
                                                              build_longitudinal_pipeline)

pytestmark = pytest.mark.cuda
CL = torch.channels_last


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernels)")
    return torch.device("cuda")


def frames(hw, batch, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 256, (batch, *hw, 3), np.uint8))


def bf16_ulps(a, b):
    """max |a - b| in units of the bf16 spacing at b."""
    a, b = a.float(), b.float()
    ulp = torch.exp2(torch.floor(torch.log2(b.abs())) - 7)
    return ((a - b).abs() / ulp.clamp_min(2.0 ** -133)).max().item()


@pytest.mark.parametrize("src,batch", [((720, 1280), 1), ((375, 1242), 2),
                                       ((200, 300), 3)])
def test_kernel_matches_plain_version(cuda, src, batch):
    f = frames(src, batch, seed=src[0]).to(cuda)
    before = fused_preprocess.launches
    for out_dtype in (torch.float32, torch.bfloat16):
        out = fused_preprocess(f, (320, 640), out_dtype)
        torch.cuda.synchronize()
        ref = preprocess_imagenet(f, (320, 640), out_dtype).permute(0, 3, 1, 2)
        assert out.shape == ref.shape and out.dtype == out_dtype
        assert out.is_contiguous(memory_format=torch.channels_last)
        if out_dtype == torch.float32:
            torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
        else:
            assert bf16_ulps(out, ref) <= 1.0
    assert fused_preprocess.launches == before + 2


@pytest.mark.parametrize("src,out_hw,batch", [((360, 640), (180, 321), 2),
                                               ((375, 1242), (37, 75), 1)])
def test_kernel_ragged_width_matches_plain_version(cuda, src, out_hw, batch):
    """Output rows whose width is not a multiple of 8 pixels (a short last
    group) and which start off 16 bytes, in a batch; bit-equal in f32, as
    the plain version."""
    f = frames(src, batch, seed=src[1]).to(cuda)
    for out_dtype in (torch.float32, torch.bfloat16):
        out = fused_preprocess(f, out_hw, out_dtype)
        torch.cuda.synchronize()
        ref = preprocess_imagenet(f, out_hw, out_dtype).permute(0, 3, 1, 2)
        assert out.shape == ref.shape and out.is_contiguous(memory_format=torch.channels_last)
        assert torch.equal(out, ref) if out_dtype == torch.float32 else bf16_ulps(out, ref) <= 1.0


def test_kernel_rejects_bad_frames_on_the_card(cuda):
    f = frames((16, 24), 1, seed=0).to(cuda)
    with pytest.raises(TypeError):
        fused_preprocess(f.float(), (8, 8))
    with pytest.raises(ValueError):
        fused_preprocess(f[0].transpose(0, 1), (8, 8))


def test_main_path_on_card_matches_cpu(cuda):
    """Small main path in f32 with TF32 off, card against CPU."""
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        frame = frames((144, 256), 1, seed=1)[0]
        kw = dict(seed=0, ctx_hw=(2, 4), out_hw=(64, 128))
        ref = build_pipeline_fused("cpu", torch.float32, **kw).logits(frame)
        before = fused_preprocess.launches
        out = build_pipeline_fused(cuda, torch.float32, **kw).logits(frame.to(cuda))
        assert fused_preprocess.launches == before + 1
        for a, b in zip(out, ref):
            torch.testing.assert_close(a.cpu(), b, rtol=0,
                                       atol=1e-3 * b.abs().max().item())
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32


@pytest.mark.parametrize("k,cin,cout,hw", [
    (3, 1456, 20, (5, 9)),    # K = 13104, not a multiple of the 64-byte K tile
    (1, 672, 28, (1, 1)),     # an SE squeeze: M = 1, N = 28
    (3, 1456, 768, (1, 2)),   # M = 2, N a multiple of the tile
    (3, 288, 20, (7, 9)),     # N = 20, M = 63: ragged in M, N and K
    (3, 20, 36, (5, 5)),      # C = 20: the wrapper pads channels to 16s
])
def test_int8_kernels_match_plain_versions(cuda, k, cin, cout, hw):
    """Quantized values, int32 accumulators and outputs bit-equal, f32 and
    bf16, scalar and per-input-channel scales."""
    g = torch.Generator().manual_seed(cin + cout)
    x = torch.randn(1, cin, *hw, generator=g) * torch.linspace(0.5, 2.0, cin).reshape(1, -1, 1, 1)
    w = torch.randint(-127, 128, (cout, cin, k, k), generator=g,
                      dtype=torch.int8).contiguous(memory_format=CL).to(cuda)
    w_scale = (torch.rand(cout, generator=g) * 1e-3 + 1e-4).to(cuda)
    scales = [torch.tensor(float(x.abs().max()) * 0.9 / 127.0),  # some values clip
              (x.double().abs().amax(dim=(0, 2, 3)) / 127.0).float()]
    before = int8_quantize.launches, int8_conv.launches
    for dtype in (torch.float32, torch.bfloat16):
        xd = x.to(dtype).contiguous(memory_format=CL).to(cuda)
        bias = (torch.randn(cout, generator=g) * 0.1).to(dtype).to(cuda)
        for sx in scales:
            sx = sx.to(cuda)
            xq = int8_quantize(xd, sx)
            assert torch.equal(xq, int8_quantize_plain(xd, sx))
            acc = int8_conv(xq, w, w_scale, sx, None, k // 2, torch.int32)
            assert torch.equal(acc, int8_conv_plain(xq, w, w_scale, sx, None, k // 2,
                                                    torch.int32))
            y = int8_conv(xq, w, w_scale, sx, bias, k // 2, dtype)
            torch.cuda.synchronize()
            assert y.dtype == dtype and y.is_contiguous(memory_format=CL)
            assert torch.equal(y, int8_conv_plain(xq, w, w_scale, sx, bias, k // 2, dtype))
    assert (int8_quantize.launches, int8_conv.launches) == (before[0] + 4, before[1] + 8)


def sm_count():
    return torch.cuda.get_device_properties(0).multi_processor_count


def one_split(plan):
    """The wgmma route's plan of a shape whose own plan splits K: the same
    kernel, one split, a persistent block per tile up to one per SM."""
    tiles = plan.grid[0] * plan.grid[1]
    return plan._replace(route="wgmma", grid=(*plan.grid[:2], 1), per_split=plan.iters,
                         blocks=min(tiles, sm_count()))


@pytest.mark.parametrize("route,k,cin,cout,hw,batch", [
    ("wgmma", 3, 128, 256, (48, 96), 1),    # 72 tiles, C one 128-channel chunk
    ("wgmma", 3, 256, 200, (24, 40), 2),    # two images, ragged N; one split forced
    ("wgmma", 3, 480, 136, (17, 23), 1),    # channel tail, ragged rectangles; one split
    ("splitk", 3, 1456, 768, (5, 9), 1),    # K = 13104 in 108 steps
    ("splitk", 3, 672, 100, (9, 13), 1),    # one output tile, channel tail, ragged N
    ("halo", 3, 64, 96, (20, 40), 1),       # a 3x3 window with C < 128
    ("halo", 1, 1152, 48, (1, 1), 1),       # an SE squeeze (M = 1) forced onto the halo kernel
])
def test_int8_conv_routes_match_plain_version(cuda, route, k, cin, cout, hw, batch):
    """Each route of int8_conv_plan against the plain version: int32
    accumulators and f32/bf16 outputs bit-equal, scalar and
    per-input-channel scales. A shape whose own plan splits K also runs
    on the wgmma route through a one-split plan, and a 1x1 conv on the
    halo route through its halo plan."""
    g = torch.Generator().manual_seed(cin + cout + k)
    x = torch.randn(batch, cin, *hw, generator=g)
    w = torch.randint(-127, 128, (cout, cin, k, k), generator=g,
                      dtype=torch.int8).contiguous(memory_format=CL).to(cuda)
    w_scale = (torch.rand(cout, generator=g) * 1e-3 + 1e-4).to(cuda)
    scales = [torch.tensor(float(x.abs().max()) / 127.0),
              (x.double().abs().amax(dim=(0, 2, 3)) / 127.0).float()]
    plan = int8_conv_plan(batch, *hw, cin, cout, k, k, k // 2, sm_count())
    if route == "wgmma" and plan.route == "splitk":
        plan = one_split(plan)
    if route == "halo" and k == 1:
        plan = _halo_plan(batch, *hw, cin, cout, 1, 1, 0, sm_count())
    assert plan.route == route

    def conv(xq, sx, bias, dtype):
        return _launch(plan, xq, w, w_scale, sx, bias, k // 2, dtype)

    before = int8_conv.route_launches[route]
    for dtype in (torch.float32, torch.bfloat16):
        xd = x.to(dtype).contiguous(memory_format=CL).to(cuda)
        bias = (torch.randn(cout, generator=g) * 0.1).to(dtype).to(cuda)
        for sx in scales:
            sx = sx.to(cuda)
            xq = int8_quantize(xd, sx)
            acc = conv(xq, sx, None, torch.int32)
            assert torch.equal(acc, int8_conv_plain(xq, w, w_scale, sx, None, k // 2,
                                                    torch.int32))
            y = conv(xq, sx, bias, dtype)
            torch.cuda.synchronize()
            assert y.dtype == dtype and y.is_contiguous(memory_format=CL)
            assert torch.equal(y, int8_conv_plain(xq, w, w_scale, sx, bias, k // 2, dtype))
    assert int8_conv.route_launches[route] == before + 8


# (B, H, W, C, N, window, pad) on the halo route: the QAT export's head (64
# -> 3 3x3 at 320x640), C = 16, 48 and 112 (K tails), N = 1, 8, 9, 64 and 65
# (one or two N tiles), a 1x1 window with padding, 5x5, a batch of two, and
# maps smaller than a tile
HALO_CARD = [(1, 320, 640, 64, 3, 3, 1), (1, 9, 13, 16, 8, 3, 1), (1, 9, 13, 48, 9, 3, 1),
             (1, 9, 13, 112, 64, 3, 1), (1, 7, 11, 32, 1, 3, 1), (1, 7, 11, 32, 65, 3, 1),
             (1, 10, 20, 320, 64, 1, 1), (1, 1, 1, 480, 20, 1, 2), (2, 13, 17, 48, 65, 5, 2),
             (2, 6, 9, 64, 3, 3, 1), (1, 3, 5, 16, 3, 3, 1)]


@pytest.mark.parametrize("B,H,W,C,N,k,pad", HALO_CARD, ids=["-".join(map(str, s)) for s in HALO_CARD])
def test_int8_halo_route_matches_plain_version(cuda, B, H, W, C, N, k, pad):
    """The halo kernel against the plain version: f32 and bf16 inputs;
    f32, bf16 and int32 outputs; a static scalar scale, the dynamic one
    (dynamic_input_scale) and per-input-channel scales; bit for bit."""
    from autoware_vision_pilot_tpu_torch.ops.kernels.int8_conv import dynamic_input_scale
    assert int8_conv_plan(B, H, W, C, N, k, k, pad, sm_count()).route == "halo"
    g = torch.Generator().manual_seed(B + H + C + N + k + pad)
    x = torch.randn(B, C, H, W, generator=g) * torch.linspace(0.5, 2.0, C).reshape(1, -1, 1, 1)
    wq = torch.randint(-127, 128, (N, C, k, k), generator=g,
                       dtype=torch.int8).contiguous(memory_format=CL).to(cuda)
    w_scale = (torch.rand(N, generator=g) * 1e-3 + 1e-4).to(cuda)
    before = int8_conv.route_launches["halo"]
    calls = 0
    for dtype in (torch.float32, torch.bfloat16):
        xd = x.to(dtype).contiguous(memory_format=CL).to(cuda)
        scales = [torch.tensor(0.0123, device=cuda), dynamic_input_scale(xd)[0],
                  (x.double().abs().amax(dim=(0, 2, 3)) / 127.0).float().to(cuda)]
        for sx in scales:
            xq = int8_quantize(xd, sx)
            for out in (torch.float32, torch.bfloat16, torch.int32):
                bias = None if out == torch.int32 else (
                    torch.randn(N, generator=g) * 0.1).to(out).to(cuda)
                y = int8_conv(xq, wq, w_scale, sx, bias, pad, out)
                torch.cuda.synchronize()
                calls += 1
                assert y.dtype == out and y.is_contiguous(memory_format=CL)
                assert torch.equal(y, int8_conv_plain(xq, wq, w_scale, sx, bias, pad, out))
    assert int8_conv.route_launches["halo"] == before + calls


def test_int8_halo_refuses_and_never_falls_back(cuda, monkeypatch):
    """On the card the halo route launches its kernel or raises: a window
    whose halo no TMA box holds raises, and the plain versions never run
    on a CUDA tensor (they do on a CPU one)."""
    from autoware_vision_pilot_tpu_torch.ops.kernels import int8_conv as k8
    g = torch.Generator().manual_seed(9)
    x = torch.randn(1, 16, 4, 300, generator=g).contiguous(memory_format=CL).to(cuda)
    sx = torch.tensor(0.02, device=cuda)
    wide = torch.randint(-127, 128, (8, 16, 1, 300), generator=g,
                         dtype=torch.int8).contiguous(memory_format=CL).to(cuda)
    with pytest.raises(ValueError, match="TMA box"):
        k8.int8_conv2d(x, wide, torch.ones(8, device=cuda), sx, None, (0, 0))
    w = torch.randint(-127, 128, (3, 16, 3, 3), generator=g,
                      dtype=torch.int8).contiguous(memory_format=CL).to(cuda)

    def boom(*args, **kwargs):
        raise AssertionError("a plain version ran on the card")

    monkeypatch.setattr(k8, "int8_conv_plain", boom)
    monkeypatch.setattr(k8, "int8_quantize_plain", boom)
    before = k8.int8_conv.route_launches["halo"]
    k8.int8_conv2d(x, w, torch.ones(3, device=cuda), sx, None, 1)
    torch.cuda.synchronize()
    assert k8.int8_conv.route_launches["halo"] == before + 1
    with pytest.raises(AssertionError):
        k8.int8_conv2d(x.cpu(), w.cpu(), torch.ones(3), sx.cpu(), None, 1)


# (cin, cout, h, w, batch): the main path's ten 1x1 int8 convs, then a
# ragged N and a batch of two on each route
ONE_BY_ONE = ((320, 1280, 10, 20, 1), (1152, 320, 10, 20, 1), (672, 112, 20, 40, 1),
              (1152, 192, 10, 20, 1), (480, 112, 20, 40, 1), (480, 80, 20, 40, 1),
              (672, 192, 10, 20, 1), (1152, 48, 1, 1, 1), (672, 28, 1, 1, 1),
              (480, 20, 1, 1, 1), (672, 100, 9, 13, 1), (480, 112, 20, 40, 2),
              (1152, 48, 1, 1, 2), (480, 21, 1, 1, 3))


@pytest.mark.parametrize("cin,cout,h,w,batch", ONE_BY_ONE,
                         ids=[f"{c}-{n}-{h}x{w}-b{b}" for c, n, h, w, b in ONE_BY_ONE])
def test_int8_1x1_routes_match_plain_versions(cuda, cin, cout, h, w, batch):
    """The pointwise and dot routes against int8_quantize_plain +
    int8_conv_plain: the float input through int8_conv2d (one launch, the
    quantize fused into the load, no quantize launch) and the int8 input
    through int8_conv; int32 accumulators and bf16/f32 outputs bit-equal,
    scalar and per-input-channel scales."""
    plan = int8_conv_plan(batch, h, w, cin, cout, 1, 1, 0, sm_count())
    route = "dot" if batch * h * w <= 8 else "pointwise"
    assert plan.route == route
    g = torch.Generator().manual_seed(cin + cout + batch)
    x = torch.randn(batch, cin, h, w, generator=g) * torch.linspace(0.5, 2.0, cin).reshape(1, -1, 1, 1)
    wq = torch.randint(-127, 128, (cout, cin, 1, 1), generator=g,
                       dtype=torch.int8).contiguous(memory_format=CL).to(cuda)
    w_scale = (torch.rand(cout, generator=g) * 1e-3 + 1e-4).to(cuda)
    scales = [torch.tensor(float(x.abs().max()) * 0.9 / 127.0),  # some values clip
              (x.double().abs().amax(dim=(0, 2, 3)) / 127.0).float()]
    before = int8_quantize.launches, int8_conv.route_launches[route]
    for dtype in (torch.float32, torch.bfloat16):
        xd = x.to(dtype).contiguous(memory_format=CL).to(cuda)
        bias = (torch.randn(cout, generator=g) * 0.1).to(dtype).to(cuda)
        for sx in scales:
            sx = sx.to(cuda)
            xq = int8_quantize_plain(xd, sx)
            want = int8_conv_plain(xq, wq, w_scale, sx, bias, 0, dtype)
            y = int8_conv2d(xd, wq, w_scale, sx, bias, 0)
            acc = int8_conv(xq, wq, w_scale, sx, None, 0, torch.int32)
            y_q = int8_conv(xq, wq, w_scale, sx, bias, 0, dtype)
            torch.cuda.synchronize()
            assert y.dtype == dtype and y.is_contiguous(memory_format=CL)
            assert torch.equal(acc, int8_conv_plain(xq, wq, w_scale, sx, None, 0, torch.int32))
            assert torch.equal(y, want) and torch.equal(y_q, want)
    assert int8_quantize.launches == before[0]
    assert int8_conv.route_launches[route] == before[1] + 12


# (bm, bn, cluster size) forced on the pointwise route: every N tile, both
# M tiles and every cluster size (chip_smoke.py::PW_VARIANTS)
PW_VARIANTS = [(bm, bn, cs) for bn in PW_WIDTHS for bm in (64, 128) for cs in (1, 8)] + [
    (64, 128, cs) for cs in range(2, 8)]


def hold_1x1_plan(cuda, plan, batch, cin, cout, h, w):
    """``plan`` of a 1x1 conv through _launch on int8, bf16 and f32 inputs,
    scalar and per-channel scales: int32 accumulators and the outputs (in
    the input's type, bf16 for int8) bit-equal to the plain versions."""
    g = torch.Generator().manual_seed(plan.bm + plan.bn + math.prod(plan.grid) + batch)
    x = torch.randn(batch, cin, h, w, generator=g)
    x = x * torch.linspace(0.5, 2.0, cin).reshape(1, -1, 1, 1)
    wq = torch.randint(-127, 128, (cout, cin, 1, 1), generator=g,
                       dtype=torch.int8).contiguous(memory_format=CL).to(cuda)
    w_scale = (torch.rand(cout, generator=g) * 1e-3 + 1e-4).to(cuda)
    before = int8_conv.route_launches[plan.route]
    for scale in (torch.tensor(float(x.abs().max()) * 0.9 / 127.0),
                  (x.double().abs().amax(dim=(0, 2, 3)) / 127.0).float()):
        sx = scale.to(cuda)
        for dtype in (torch.int8, torch.bfloat16, torch.float32):
            xf = x.to(torch.float32 if dtype == torch.int8 else dtype).contiguous(
                memory_format=CL).to(cuda)
            xq = int8_quantize_plain(xf, sx)
            xin = xq if dtype == torch.int8 else xf
            out = torch.bfloat16 if dtype == torch.int8 else dtype
            bias = (torch.randn(cout, generator=g) * 0.1).to(out).to(cuda)
            acc = _launch(plan, xin, wq, w_scale, sx, None, 0, torch.int32)
            y = _launch(plan, xin, wq, w_scale, sx, bias, 0, out)
            torch.cuda.synchronize()
            assert torch.equal(acc, int8_conv_plain(xq, wq, w_scale, sx, None, 0, torch.int32))
            assert torch.equal(y, int8_conv_plain(xq, wq, w_scale, sx, bias, 0, out))
    assert int8_conv.route_launches[plan.route] == before + 12


@pytest.mark.parametrize("bm,bn,cs", PW_VARIANTS,
                         ids=[f"bm{bm}-bn{bn}-cs{cs}" for bm, bn, cs in PW_VARIANTS])
def test_int8_pointwise_every_tile_and_cluster(cuda, bm, bn, cs):
    """A ragged 117 x 1152 -> 100 conv (9x13 pixels) on each forced plan."""
    per = math.ceil(1152 / PW_BK / cs)
    grid = (math.ceil(117 / bm), math.ceil(100 / bn), math.ceil(1152 / PW_BK / per))
    plan = int8_conv_plan(1, 9, 13, 1152, 100, 1, 1, 0, sm_count())._replace(
        bm=bm, bn=bn, grid=grid, per_split=per, blocks=math.prod(grid))
    hold_1x1_plan(cuda, plan, 1, 1152, 100, 9, 13)


@pytest.mark.parametrize("batch", range(1, 9))
def test_int8_dot_every_batch(cuda, batch):
    """The dot route at M = 1-8 (1152 -> 21: a ragged N, three warps a
    channel)."""
    plan = int8_conv_plan(batch, 1, 1, 1152, 21, 1, 1, 0, sm_count())
    assert plan.route == "dot" and plan.grid[2] == 96
    hold_1x1_plan(cuda, plan, batch, 1152, 21, 1, 1)


@pytest.mark.parametrize("route,blocks", [("wgmma", 5), ("splitk", 7)])
def test_int8_conv_persistent_blocks_match_plain_version(cuda, route, blocks):
    """Fewer blocks than units of work (32 tiles; 128 tile-and-K-range units
    split over K): each block carries several units through one ring of
    stages. Accumulators and bf16 outputs bit-equal to the plain version,
    and the same on every run, whatever order the splits arrive in."""
    g = torch.Generator().manual_seed(blocks)
    x = torch.randn(2, 480, 24, 40, generator=g).to(torch.bfloat16)
    w = torch.randint(-127, 128, (200, 480, 3, 3), generator=g,
                      dtype=torch.int8).contiguous(memory_format=CL).to(cuda)
    w_scale = (torch.rand(200, generator=g) * 1e-3 + 1e-4).to(cuda)
    bias = (torch.randn(200, generator=g) * 0.1).to(torch.bfloat16).to(cuda)
    sx = torch.tensor(float(x.float().abs().max()) / 127.0).to(cuda)
    xq = int8_quantize(x.contiguous(memory_format=CL).to(cuda), sx)
    plan = int8_conv_plan(2, 24, 40, 480, 200, 3, 3, 1, sm_count())
    assert plan.route == "splitk" and plan.grid == (16, 2, 4)
    plan = (one_split(plan) if route == "wgmma" else plan)._replace(blocks=blocks)
    for dtype in (torch.int32, torch.bfloat16):
        want = int8_conv_plain(xq, w, w_scale, sx, bias, 1, dtype)
        for _ in range(3):
            y = _launch(plan, xq, w, w_scale, sx, bias, 1, dtype)
            torch.cuda.synchronize()
            assert torch.equal(y, want)


def test_int8_weight_map_is_kept_on_the_weight(cuda):
    """The weights' TMA map is encoded at the first wgmma launch and kept
    by the kernels' library (csrc/sm90.cuh::weight_map), and encoded again
    for a copy of the weight at another address."""
    import ctypes

    from autoware_vision_pilot_tpu_torch.kernels import build

    lib = ctypes.CDLL(str(build.build()))
    lib.avp_int8_weight_map_encodes.restype = ctypes.c_longlong
    g = torch.Generator().manual_seed(9)
    w = torch.randint(-127, 128, (256, 256, 3, 3), generator=g,
                      dtype=torch.int8).contiguous(memory_format=CL).to(cuda)
    w_scale = torch.full((256,), 1e-3, device=cuda)
    sx = torch.tensor(0.02, device=cuda)
    xq = torch.randint(-127, 128, (1, 256, 40, 80), generator=g,
                       dtype=torch.int8).contiguous(memory_format=CL).to(cuda)
    before = lib.avp_int8_weight_map_encodes()
    y = int8_conv(xq, w, w_scale, sx, None, 1, torch.int32)
    assert lib.avp_int8_weight_map_encodes() == before + 1
    assert torch.equal(int8_conv(xq, w, w_scale, sx, None, 1, torch.int32), y)
    assert lib.avp_int8_weight_map_encodes() == before + 1
    w2 = copy.deepcopy(w)
    assert torch.equal(int8_conv(xq, w2, w_scale, sx, None, 1, torch.int32), y)
    assert lib.avp_int8_weight_map_encodes() == before + 2
    assert torch.equal(int8_conv(xq, w, w_scale, sx, None, 1, torch.int32), y)
    assert lib.avp_int8_weight_map_encodes() == before + 2


def test_int8_wrappers_raise_on_the_card(cuda):
    x = torch.randn(1, 32, 4, 5, device=cuda).contiguous(memory_format=CL)
    s = torch.tensor(0.02, device=cuda)
    w = torch.zeros(8, 32, 3, 3, dtype=torch.int8, device=cuda).contiguous(memory_format=CL)
    w_scale = torch.ones(8, device=cuda)
    xq = int8_quantize(x, s)
    with pytest.raises(ValueError, match="groups"):  # 32 channels, not 2 groups of 32
        int8_conv(xq, w, w_scale, s, None, 1, groups=2)
    with pytest.raises(ValueError, match="strides"):  # any stride >= 1 is taken
        int8_conv(xq, w, w_scale, s, None, 1, stride=0)
    with pytest.raises(ValueError, match="channels_last"):
        int8_conv(xq.contiguous(), w, w_scale, s, None, 1)
    with pytest.raises(ValueError, match="channels_last"):
        int8_quantize(x.contiguous(), s)
    with pytest.raises(TypeError, match="x_scale"):
        int8_quantize(x, s.cpu())
    # no route takes K = 133,152 channels (int32 could overflow), in either entry point
    big = torch.zeros(1, 133_152, 1, 1, device=cuda).contiguous(memory_format=CL)
    w_big = torch.zeros(8, 133_152, 1, 1, dtype=torch.int8, device=cuda).contiguous(memory_format=CL)
    with pytest.raises(ValueError, match="overflow"):
        int8_conv2d(big, w_big, w_scale, s)
    with pytest.raises(ValueError, match="overflow"):
        int8_conv(big.to(torch.int8), w_big, w_scale, s)
    with pytest.raises(TypeError, match="int8 input"):  # a float input on an int8-only route
        _launch(int8_conv_plan(1, 4, 5, 32, 8, 3, 3, 1), x, w, w_scale, s, None, 1, torch.float32)


def int8_calls(pipe, forced=None):
    """Hooks on every Int8Conv2d of the pipeline: record (input, output) in
    call order; with ``forced``, feed each conv the next of those inputs
    instead of its own. -> (calls, remove)."""
    calls = []

    def pre(m, args):
        if forced is not None:
            return (forced[len(calls)].to(args[0].device),)

    def post(m, args, y):
        calls.append((args[0], y))

    handles = [h for net in (pipe.stack, pipe.lanes) for m in net.modules()
               if isinstance(m, Int8Conv2d)
               for h in (m.register_forward_pre_hook(pre), m.register_forward_hook(post))]
    return calls, lambda: [h.remove() for h in handles]


def test_int8_main_path_on_card_matches_cpu(cuda):
    """Small int8 main path in f32 with TF32 off: the pipeline quantized and
    calibrated on the CPU, copied to the card with its scales. Each of the
    72 int8 convs on the card gets the CPU conv's input and must give its
    output bit for bit; the logits agree within 1e-3 * max|CPU|. (Left to
    run free, a 1e-7 float difference between cuDNN and the CPU can move an
    int8 value across a rounding boundary, and the flips multiply through
    the later int8 convs: tests/test_torch_int8_slice.py.)"""
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        frame = frames((144, 256), 1, seed=2)[0]
        cpu = build_pipeline_fused("cpu", torch.float32, seed=0, ctx_hw=(2, 4),
                                   out_hw=(64, 128), int8=True)
        card = copy.deepcopy(cpu)
        for net in (card.stack, card.lanes):
            net.to(cuda)
        calls, remove = int8_calls(cpu)
        ref = cpu.logits(frame)
        remove()
        before = int8_conv.launches
        card_calls, remove = int8_calls(card, [x for x, _ in calls])
        out = card.logits(frame.to(cuda))
        remove()
        assert len(calls) == len(card_calls) == 72
        assert int8_conv.launches == before + 72
        for i, ((_, want), (_, got)) in enumerate(zip(calls, card_calls)):
            assert torch.equal(got.cpu(), want), i
        for a, b in zip(out, ref):
            torch.testing.assert_close(a.cpu(), b, rtol=0,
                                       atol=1e-3 * b.abs().max().item())
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32


def test_kernel_on_the_lateral_crop_matches_plain_version(cuda):
    """frame[420:] of a contiguous 720p frame (1,612,800 bytes in) ->
    320x640, bit-equal in f32 and bf16."""
    f = frames((720, 1280), 1, seed=420)[0].to(cuda)
    crop = f[420:]
    assert crop.is_contiguous() and crop.data_ptr() - f.data_ptr() == 1_612_800
    for out_dtype in (torch.float32, torch.bfloat16):
        out = fused_preprocess(crop, (320, 640), out_dtype)
        torch.cuda.synchronize()
        ref = preprocess_imagenet(crop[None], (320, 640), out_dtype).permute(0, 3, 1, 2)
        assert torch.equal(out, ref)


def lane_masks(hw, kind, seed):
    """(H, W, 3) f32 masks [ego_left, ego_right, other]: 3-pixel-wide lanes
    from row H/8 down, dashed, one-sided, empty, or random."""
    h, w = hw
    rng = np.random.default_rng(seed)
    if kind == "random":
        return torch.from_numpy((rng.random((h, w, 3)) < rng.uniform(0.02, 0.7)).astype(np.float32))
    m = np.zeros((h, w, 3), np.float32)
    if kind == "empty":
        return torch.from_numpy(m)
    slope = rng.uniform(-0.2, 0.2, 2)
    for y in range(h // 8, h):
        for c, x0 in ((0, 0.3 * w), (1, 0.65 * w)):
            if kind == "one-sided" and c == 1 or kind == "dashed" and (y // 4) % 2 == c:
                continue
            x = int(round(x0 + slope[c] * (y - h)))
            m[y, max(0, x - 1):max(0, x + 2), c] = 1.0
    m[rng.integers(h // 2, h, 20), rng.integers(0, w, 20), 2] = 1.0
    return torch.from_numpy(m)


# widths that are not a multiple of 32; 33 * 65 * 3 is not a multiple of 4
@pytest.mark.parametrize("hw", [(80, 160), (24, 48), (37, 91), (33, 65), (80, 150)])
@pytest.mark.parametrize("kind", ["lanes", "dashed", "one-sided", "empty", "random"])
def test_lane_filter_kernel_matches_plain_version(cuda, hw, kind):
    """Weight images and start points bit-equal, for 4 seeds each."""
    before = lane_filter_walk.launches
    for seed in range(4):
        masks = lane_masks(hw, kind, seed).to(cuda)
        weights, starts = lane_filter_walk(masks)
        torch.cuda.synchronize()
        ref_w, ref_s = lane_filter_walk_plain(masks)
        assert weights.dtype == torch.int32 and weights.shape == (2, *hw)
        assert torch.equal(starts, ref_s.to(torch.int32)), (seed, starts, ref_s)
        assert torch.equal(weights, ref_w), seed
    assert lane_filter_walk.launches == before + 4


def test_lane_filter_kernel_rejects_bad_masks_on_the_card(cuda):
    masks = lane_masks((24, 48), "random", 0).to(cuda)
    with pytest.raises(ValueError):
        lane_filter_walk(masks.transpose(0, 1))
    with pytest.raises(TypeError):
        lane_filter_walk(masks.half())
    with pytest.raises(ValueError):
        lane_filter_walk(torch.zeros((600, 600, 3), device=cuda))


def edge_lane_masks(hw, near):
    """Lanes down columns ``near`` and W - 1 - ``near`` (windows at the left
    and right edges), the other mask's bottom row and top third set
    (windows at the bottom and top)."""
    h, w = hw
    m = np.zeros((h, w, 3), np.float32)
    m[:, near, 0] = m[:, min(near + 1, w - 1), 0] = 1.0
    m[:, w - 1 - near, 1] = m[:, max(w - 2 - near, 0), 1] = 1.0
    m[h - 1, :, 2] = 1.0
    m[:h // 3, :, 2] = 1.0
    return torch.from_numpy(m)


def assert_walk_equal(masks):
    weights, starts = lane_filter_walk(masks)
    torch.cuda.synchronize()
    ref_w, ref_s = lane_filter_walk_plain(masks)
    assert torch.equal(starts, ref_s.to(torch.int32)), (starts, ref_s)
    assert torch.equal(weights, ref_w)


# 320x320 is the most pixels the wrapper admits, 4096x25 the most rows
@pytest.mark.parametrize("hw", [(320, 320), (4096, 25), (1, 1), (3, 1000)])
def test_lane_filter_kernel_edge_sizes(cuda, hw):
    for kind, seed in (("random", 5), ("lanes", 6), ("dashed", 7)):
        assert_walk_equal(lane_masks(hw, kind, seed).to(cuda))


@pytest.mark.parametrize("hw", [(80, 160), (33, 65)])
def test_lane_filter_kernel_windows_at_the_edges(cuda, hw):
    for near in (0, 1, 2):
        masks = edge_lane_masks(hw, near).to(cuda)
        assert_walk_equal(masks)
        buf = torch.zeros(masks.numel() + 4, device=cuda)  # 4 bytes off 16
        buf[1:1 + masks.numel()] = masks.flatten()
        assert_walk_equal(buf[1:1 + masks.numel()].view(masks.shape))


def test_lane_filter_kernel_limits_on_the_card(cuda):
    with pytest.raises(ValueError):  # one pixel too many
        lane_filter_walk(torch.zeros((321, 320, 3), device=cuda))
    with pytest.raises(ValueError):  # one row too many
        lane_filter_walk(torch.zeros((lane_filter_kernel.MAX_ROWS + 1, 1, 3), device=cuda))


def nms_edge_candidates(k, kind, seed, device):
    """Sorted top-k candidates: live random boxes, all below the threshold,
    all live on degenerate clamped boxes with tied scores (as seeded
    AutoSpeed gives), or NaN coordinates."""
    rng = np.random.default_rng(seed)
    xy, wh = rng.uniform(0, 1200, (k, 2)), rng.uniform(0, 200, (k, 2))
    boxes = np.concatenate([xy, xy + wh], 1)
    scores = np.sort(rng.uniform(0.5, 1.0, k))[::-1].copy()
    if kind == "dead":
        scores[:] = -1.0
    if kind == "degenerate":
        boxes, scores[:] = np.clip(np.round(boxes / 400) * 400, 0, 1280), 1.0
    if kind == "nan":
        boxes[rng.random((k, 4)) < 0.1] = np.nan
    return (torch.from_numpy(boxes.astype(np.float32)).to(device),
            torch.from_numpy(scores.astype(np.float32)).to(device),
            torch.from_numpy(rng.integers(0, 4, k).astype(np.int32)).to(device))


def bits_equal(a, b):
    """Equal dtype, shape and bits, NaN payloads included."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


@pytest.mark.parametrize("k", [1, 31, 32, 33, 255, 256, 257, 1024, 1025, 1200,
                               nms_kernel.MAX_K])
@pytest.mark.parametrize("kind", ["live", "dead", "degenerate", "nan"])
def test_nms_kernel_every_cluster_size(cuda, k, kind):
    """Every output bit-equal to the plain version at clusters of 1-8
    blocks, the wrapper's own choice among them."""
    top = nms_edge_candidates(k, kind, k, cuda)
    kw = dict(max_det=64, iou_thresh=0.5, conf_thresh=0.5, class_aware=True)
    ref = nms_greedy_plain(*top, **kw)
    before = nms_greedy.launches
    out = nms_greedy(*top, **kw)
    torch.cuda.synchronize()
    assert nms_greedy.launches == before + 1
    assert all(bits_equal(a, b) for a, b in zip(out, ref))
    for cs in range(1, 9):
        out = nms_kernel._launch(*top, 64, 0.5, 0.5, True, cs)
        torch.cuda.synchronize()
        assert all(bits_equal(a, b) for a, b in zip(out, ref)), cs


def test_nms_kernel_refuses_a_bad_cluster(cuda):
    top = nms_edge_candidates(64, "live", 0, cuda)
    for cs in (0, 9):  # the C entry point takes 1-8 blocks
        with pytest.raises(RuntimeError):
            nms_kernel._launch(*top, 64, 0.5, 0.5, True, cs)


LATERAL = dict(frame_hw=(120, 200), crop_y=20, net_hw=(96, 192),
               backbone_stages=B0_DRYRUN_STAGES)


def coeffs_err(a, b):
    """max |a - b| / max|b| per row over the finite entries of b; a lane
    without points has NaN or inf coefficients, which must match exactly."""
    fin = torch.isfinite(b)
    torch.testing.assert_close(torch.where(fin, 0.0, a), torch.where(fin, 0.0, b), rtol=0,
                               atol=0, equal_nan=True)
    a, b = torch.where(fin, a, 0.0), torch.where(fin, b, 0.0)
    scale = b.abs().amax(-1, keepdim=True).clamp_min(1e-30)
    return ((a - b).abs() / scale).max().item()


def test_lateral_step_on_card_matches_cpu(cuda):
    """The lateral step at a small size in f32, TF32 off, card against CPU
    over 3 frames with the states carried: the lane logits within
    1e-3 * max|CPU|; then, the card's networks returning the CPU's logits,
    the lane masks, AutoSteer's angle and the flags exactly and the lane
    fits within 5e-3 * max|CPU| (f32 normal equations summed in another
    order). PathFinder's outputs are not compared: at this geometry its
    f32 fit has a condition number of ~5e11 (PERF.md, ROADMAP Queue 3)."""
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cpu = build_lateral_pipeline("cpu", torch.float32, **LATERAL)
        card = build_lateral_pipeline(cuda, torch.float32, **LATERAL)
        fs = frames((120, 200), 3, seed=5)
        cs, gs = cpu.init_state(), card.init_state()
        noise = torch.zeros(14)
        forced = {}
        hooks = [card.lanes.register_forward_hook(lambda m, a, y: forced.get("lanes", y)),
                 card.steer_net.register_forward_hook(lambda m, a, y: forced.get("steer", y))]
        try:
            for i in range(3):
                cpu_logits = []
                h1 = cpu.lanes.register_forward_hook(lambda m, a, y: cpu_logits.append(y))
                h2 = cpu.steer_net.register_forward_hook(lambda m, a, y: cpu_logits.append(y))
                cout, cs = cpu(fs[i], cs, noise=noise)
                h1.remove(), h2.remove()
                if i == 0:  # the card's own EgoLanes on the same frame
                    x = fused_preprocess(fs[i][20:].to(cuda), (96, 192), torch.float32)
                    torch.testing.assert_close(card.lanes(x).cpu(), cpu_logits[0], rtol=0,
                                               atol=1e-3 * cpu_logits[0].abs().max().item())
                forced["lanes"] = cpu_logits[0].to(cuda)
                forced["steer"] = tuple(v.to(cuda) for v in cpu_logits[1])
                gout, gs = card(fs[i].to(cuda), gs, noise=noise.to(cuda))
                assert torch.equal(gout["lane_masks"].cpu(), cout["lane_masks"])
                flags = [SCALAR_FIELDS.index(f) for f in ("autosteer_deg", "fused_valid",
                                                          "path_valid")]
                assert torch.equal(gout["scalars"].cpu()[flags], cout["scalars"][flags])
                assert coeffs_err(gout["coeffs"].cpu(), cout["coeffs"]) <= 5e-3
                assert torch.isfinite(gout["scalars"]).all()
        finally:
            for h in hooks:
                h.remove()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32


def test_lateral_step_makes_no_host_sync(cuda):
    """Three bf16 frames under sync-debug "error": any host synchronisation
    inside the step raises. One preprocess and one lane-filter launch each."""
    pipe = build_lateral_pipeline(cuda, torch.bfloat16, **LATERAL)
    state = pipe.init_state(seed=1)
    fs = frames((120, 200), 3, seed=6).to(cuda)
    torch.cuda.synchronize()
    before = fused_preprocess.launches, lane_filter_walk.launches
    outs = []
    torch.cuda.set_sync_debug_mode("error")
    try:
        for i in range(3):
            out, state = pipe(fs[i], state)
            outs.append(out)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert (fused_preprocess.launches, lane_filter_walk.launches) == (before[0] + 3, before[1] + 3)
    for out in outs:
        assert out["scalars"].shape == (8,) and out["coeffs"].shape == (3, 6)
        assert torch.isfinite(out["scalars"]).all()
        assert ((out["lane_masks"] == 0) | (out["lane_masks"] == 1)).all()


# ---------- the longitudinal program ----------

@pytest.mark.parametrize("src,out_hw,batch", [((720, 1280), (640, 640), 1),
                                               ((375, 1242), (640, 640), 2),
                                               ((1280, 720), (640, 640), 1),
                                               ((360, 640), (181, 333), 2)])
def test_letterbox_kernel_matches_plain_version(cuda, src, out_hw, batch):
    """The letterbox mode, bit-equal in f32 and bf16: pad rows (landscape),
    pad columns (portrait), an odd pad and a width that is not a multiple
    of 8, in a batch. One fused_letterbox launch a call, none counted as
    fused_preprocess."""
    f = frames(src, batch, seed=src[1] + 1).to(cuda)
    before = fused_letterbox.launches, fused_preprocess.launches
    for out_dtype in (torch.float32, torch.bfloat16):
        out, scale, pad = fused_letterbox(f, out_hw, out_dtype)
        torch.cuda.synchronize()
        ref, rscale, rpad = letterbox(f, out_hw, src, dtype=out_dtype)
        assert out.shape == (batch, 3, *out_hw) and out.dtype == out_dtype
        assert out.is_contiguous(memory_format=torch.channels_last)
        assert (scale, pad) == (rscale, rpad)
        assert torch.equal(out.permute(0, 2, 3, 1), ref)
    assert (fused_letterbox.launches, fused_preprocess.launches) == (before[0] + 2, before[1])


def test_preprocess_mode_is_unchanged_beside_letterbox(cuda):
    """The ImageNet mode after a letterbox launch: bit-equal to its plain
    version at 720p and the KITTI size, one fused_preprocess launch each."""
    fused_letterbox(frames((720, 1280), 1, seed=7)[0].to(cuda), (640, 640))
    for src in ((720, 1280), (375, 1242)):
        f = frames(src, 1, seed=8).to(cuda)
        before = fused_preprocess.launches
        out = fused_preprocess(f, (320, 640), torch.float32)
        ref = preprocess_imagenet(f, (320, 640)).permute(0, 3, 1, 2)
        assert torch.equal(out, ref)
        assert fused_preprocess.launches == before + 1


def nms_candidates(kind, seed, A=2000):
    """(boxes (A, 4) f32 xyxy, scores (A,) f32, classes (A,) int32) of a
    ``kind`` of scene in a 1280x720 frame: random boxes (some inverted, of
    zero area), dense same-class clusters, all below 0.5, a grid of
    disjoint boxes (more survivors than max_det), or scores with many
    ties. numpy arrays."""
    rng = np.random.default_rng(seed)
    if kind == "grid":
        gx, gy = np.meshgrid(np.arange(50) * 25.0, np.arange(40) * 18.0)
        xy = np.stack([gx.ravel(), gy.ravel()], 1)[:A]
        boxes = np.concatenate([xy, xy + 20.0], 1)
        return (boxes.astype(np.float32), rng.uniform(0.5, 1.0, len(xy)).astype(np.float32),
                rng.integers(0, 4, len(xy)).astype(np.int32))
    if kind == "dense":
        c = rng.uniform(100, 600, (5, 2))[rng.integers(0, 5, A)] + rng.normal(0, 8, (A, 2))
        wh = rng.uniform(60, 90, (A, 2))
        boxes = np.concatenate([c - wh / 2, c + wh / 2], 1)
        cls = np.zeros(A, np.int32)
    else:
        xy = rng.uniform(0, 1100, (A, 2))
        wh = rng.uniform(-10, 300, (A, 2))  # a few inverted: zero area
        boxes = np.concatenate([xy, xy + wh], 1)
        cls = rng.integers(0, 4, A).astype(np.int32)
    scores = rng.uniform(0, 1, A)
    if kind == "below":
        scores = scores * 0.4999
    if kind == "ties":
        scores = rng.choice([0.3, 0.5, 0.6, 0.75, 1.0], A)
    return boxes.astype(np.float32), scores.astype(np.float32), cls


# (kind, seed, A, class_aware, max_det): k = min(4 * max_det, A) is 256,
# 100 and 40 (not multiples of 32), 1 and 1024 (shared memory above 48 KB)
NMS_CARD_CASES = [("random", 1, 8400, True, 64), ("random", 2, 2000, False, 64),
                  ("dense", 3, 2000, True, 64), ("dense", 4, 2000, False, 64),
                  ("below", 5, 2000, True, 64), ("grid", 6, 2000, True, 64),
                  ("ties", 7, 2000, True, 64), ("ties", 8, 2000, False, 64),
                  ("random", 9, 100, True, 64), ("dense", 10, 40, True, 64),
                  ("dense", 11, 2000, True, 256), ("random", 12, 1, True, 64)]


@pytest.mark.parametrize("kind,seed,A,class_aware,max_det", NMS_CARD_CASES)
def test_nms_kernel_matches_plain_version(cuda, kind, seed, A, class_aware, max_det):
    boxes, scores, cls = (torch.from_numpy(a).to(cuda) for a in nms_candidates(kind, seed, A))
    top = nms_topk(boxes, scores, cls, max_det=max_det, conf_thresh=0.5)
    kw = dict(max_det=max_det, iou_thresh=0.5, conf_thresh=0.5, class_aware=class_aware)
    before = nms_greedy.launches
    out = nms_greedy(*top, **kw)
    torch.cuda.synchronize()
    assert nms_greedy.launches == before + 1
    ref = nms_greedy_plain(*top, **kw)
    for a, b in zip(out, ref):
        assert a.dtype == b.dtype and a.shape == b.shape and a.device == b.device
        assert torch.equal(a, b), kind


def test_nms_kernel_rejects_bad_candidates_on_the_card(cuda):
    boxes, scores, cls = (torch.from_numpy(a).to(cuda) for a in nms_candidates("random", 13))
    k = nms_kernel.MAX_K + 1  # one candidate past what the kernel takes
    with pytest.raises(ValueError):
        nms_greedy(boxes[:k], scores[:k], cls[:k], max_det=300)
    with pytest.raises(ValueError):
        nms_greedy(boxes[:256], scores[:256], cls[:256].cpu())
    with pytest.raises(ValueError):
        nms_greedy(boxes[:256].t().contiguous().t(), scores[:256], cls[:256])
    with pytest.raises(RuntimeError):  # boxes off 16 bytes
        nms_greedy(boxes.flatten()[1:1025].view(256, 4), scores[:256], cls[:256])


def test_cuda_tensors_never_reach_a_plain_version(cuda, monkeypatch):
    """With the plain versions replaced by functions that raise, the kernels
    still run on CUDA tensors: no wrapper falls back."""
    def boom(*args, **kwargs):
        raise AssertionError("a plain version ran on the card")

    monkeypatch.setattr(nms_kernel, "nms_greedy_plain", boom)
    monkeypatch.setattr(preprocess_kernel, "letterbox", boom)
    monkeypatch.setattr(preprocess_kernel, "preprocess_imagenet", boom)
    f = frames((720, 1280), 1, seed=9)[0].to(cuda)
    fused_letterbox(f, (640, 640))
    fused_preprocess(f, (320, 640))
    boxes, scores, cls = (torch.from_numpy(a).to(cuda) for a in nms_candidates("dense", 14))
    nms_kernel.nms_fixed(boxes, scores, cls)
    torch.cuda.synchronize()
    with pytest.raises(AssertionError):
        nms_kernel.nms_fixed(boxes.cpu(), scores.cpu(), cls.cpu())


LONGITUDINAL = dict(frame_hw=(180, 320), input_hw=(128, 128))


def test_longitudinal_step_on_card_matches_cpu(cuda):
    """The longitudinal step at a small size in f32, TF32 off, card against
    CPU over 3 frames: pred within 1e-3 * max|CPU|; the card's network then
    returning the CPU's pred, the packed table equal."""
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cpu = build_longitudinal_pipeline("cpu", torch.float32, **LONGITUDINAL)
        card = build_longitudinal_pipeline(cuda, torch.float32, **LONGITUDINAL)
        fs = frames((180, 320), 3, seed=10)
        seen, forced = {}, {}
        h_cpu = cpu.net.register_forward_hook(lambda m, a, y: seen.__setitem__("cpu", y))

        def force(m, a, y):
            seen["card"] = y
            return forced["pred"]

        h_card = card.net.register_forward_hook(force)
        try:
            for i in range(3):
                ref = cpu(fs[i])
                forced["pred"] = seen["cpu"].to(cuda)
                out = card(fs[i].to(cuda))
                assert out.shape == (64, 7) and out.dtype == torch.float32 and out.is_cuda
                torch.testing.assert_close(seen["card"].cpu(), seen["cpu"], rtol=0,
                                           atol=1e-3 * seen["cpu"].abs().max().item())
                assert torch.equal(out.cpu(), ref)
                assert ref[:, 6].sum() >= 1
        finally:
            h_cpu.remove(), h_card.remove()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32


def test_longitudinal_step_makes_no_host_sync(cuda):
    """Three bf16 frames under sync-debug "error": any host synchronisation
    inside the step raises. One letterbox and one NMS launch each."""
    pipe = build_longitudinal_pipeline(cuda, torch.bfloat16, seed=1, **LONGITUDINAL)
    fs = frames((180, 320), 3, seed=11).to(cuda)
    torch.cuda.synchronize()
    before = fused_letterbox.launches, nms_greedy.launches
    outs = []
    torch.cuda.set_sync_debug_mode("error")
    try:
        for i in range(3):
            outs.append(pipe(fs[i]))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert (fused_letterbox.launches, nms_greedy.launches) == (before[0] + 3, before[1] + 3)
    for out in outs:
        assert out.shape == (64, 7) and out.dtype == torch.float32 and out.is_cuda
        assert torch.isfinite(out).all()
        assert ((out[:, 6] == 0) | (out[:, 6] == 1)).all()


# ---------- the stream axis: batched kernels, the fleet, the engines ----------

def bits_equal_all(a, b):
    return all(bits_equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("n", [1, 3, 8])
@pytest.mark.parametrize("src,y0", [((720, 1280), 420), ((121, 203), 7), ((64, 88), 0)])
def test_preprocess_kernel_on_a_cropped_batch(cuda, n, src, y0):
    """frames[:, y0:] of an (N, H, W, 3) batch, its frames not contiguous
    with one another (and 121 * 203 * 3 bytes apart, not a multiple of 16),
    read in place: every frame's image bit-equal to the plain version and
    to a launch on that frame alone, in f32 and bf16; one launch a call."""
    batch = frames(src, n, seed=n + src[0]).to(cuda)
    crop = batch[:, y0:]
    for out_dtype in (torch.float32, torch.bfloat16):
        before = fused_preprocess.launches
        out = fused_preprocess(crop, (64, 96), out_dtype)
        assert fused_preprocess.launches == before + 1
        ref = preprocess_imagenet(crop, (64, 96), out_dtype).permute(0, 3, 1, 2)
        assert torch.equal(out, ref)
        for i in range(n):
            assert torch.equal(fused_preprocess(crop[i], (64, 96), out_dtype)[0], out[i])


def test_preprocess_kernel_rejects_a_frame_whose_rows_are_apart(cuda):
    batch = frames((40, 64), 2, seed=3).to(cuda)
    with pytest.raises(ValueError):
        fused_preprocess(batch[:, :, :32], (16, 16))  # rows not contiguous
    with pytest.raises(ValueError):
        fused_preprocess(batch[..., [2, 1, 0]].transpose(1, 2), (16, 16))


@pytest.mark.parametrize("n", [1, 3, 8])
def test_letterbox_kernel_on_a_batch(cuda, n):
    batch = frames((720, 1280), n, seed=20 + n).to(cuda)
    out, scale, pad = fused_letterbox(batch, (640, 640))
    ref, _, _ = letterbox(batch, (640, 640), (720, 1280), dtype=torch.bfloat16)
    assert torch.equal(out, ref.permute(0, 3, 1, 2))
    for i in range(n):
        assert torch.equal(fused_letterbox(batch[i], (640, 640))[0][0], out[i])


def offset_frames(hw, n, offset, gap, seed, device):
    """n (H, W, 3) frames that start ``offset`` bytes past a 16-byte
    boundary, ``gap`` bytes of other data between them (frame_stride = H W
    3 + gap), the batch a view of one buffer."""
    H, W = hw
    stride = H * W * 3 + gap
    rng = np.random.default_rng(seed)
    buf = torch.from_numpy(rng.integers(0, 256, n * stride + offset + 16, np.uint8)).to(device)
    base = (16 - buf.data_ptr() % 16) % 16 + offset
    view = torch.as_strided(buf, (n, H, W, 3), (stride, 3 * W, 3, 1), base)
    assert view.data_ptr() % 16 == offset
    return view


@pytest.mark.parametrize("offset", [1, 5, 15])
@pytest.mark.parametrize("src,out_hw", [((720, 1280), (640, 640)), ((375, 1242), (640, 640)),
                                        ((360, 640), (181, 333))])
def test_letterbox_kernel_on_frames_off_16_bytes(cuda, src, out_hw, offset):
    """Frames that start 1, 5 or 15 bytes past 16 (row words and the
    image's first and last bytes read apart), one and a batch of three
    frame_stride bytes apart, f32 and bf16: bit-equal to the plain version
    and, per frame, to a launch on that frame alone. At 181x333 the output
    rows are 1,998 (bf16) and 3,996 (f32) bytes: ragged ends."""
    for n, gap in ((1, 0), (3, 7)):
        f = offset_frames(src, n, offset, gap, seed=offset + n, device=cuda)
        for out_dtype in (torch.float32, torch.bfloat16):
            out, _, _ = fused_letterbox(f, out_hw, out_dtype)
            ref, _, _ = letterbox(f, out_hw, src, dtype=out_dtype)
            assert bits_equal(out.permute(0, 2, 3, 1), ref)
            for i in range(n):
                assert bits_equal(fused_letterbox(f[i], out_hw, out_dtype)[0][0], out[i])


@pytest.mark.parametrize("n", [1, 3, 8])
@pytest.mark.parametrize("src", [(720, 1280), (375, 1242)])
def test_letterbox_kernel_on_a_strided_batch(cuda, n, src):
    """N = 1, 3 and 8 frames frame_stride bytes apart (H W 3 + 37: every
    frame at another offset from 16), one launch: bit-equal per stream."""
    f = offset_frames(src, n, 0, 37, seed=30 + n, device=cuda)
    before = fused_letterbox.launches
    out, _, _ = fused_letterbox(f, (640, 640))
    assert fused_letterbox.launches == before + 1
    ref, _, _ = letterbox(f, (640, 640), src, dtype=torch.bfloat16)
    assert torch.equal(out.permute(0, 2, 3, 1), ref)


@pytest.mark.parametrize("src,out_hw", [((2, 1000), (640, 640)), ((1, 7), (24, 7)),
                                        ((333, 517), (601, 700))])
def test_letterbox_kernel_edge_sizes(cuda, src, out_hw):
    """nh = 1 (a 2 x 1000 frame, and a 1 x 7 one whose rows are 21 bytes:
    no whole 16-byte word inside the image), and 601 x 700 output rows: a
    short last chunk of columns (700 = 10 x 64 + 60), a last block that
    the units do not fill, and pad runs that the warps do not divide
    evenly; f32 and bf16, batches of 1 and 5."""
    _, (nh, nw), _ = letterbox_geometry(out_hw, src)
    if src[0] <= 2:
        assert nh == 1
    for n in (1, 5):
        f = offset_frames(src, n, 3, 1, seed=n, device=cuda)
        plan = preprocess_kernel.letterbox_plan(n, *src, out_hw)
        if src == (333, 517):
            assert nw % preprocess_kernel.LB_CHUNK and plan.units % preprocess_kernel.LB_WARPS
        for out_dtype in (torch.float32, torch.bfloat16):
            out, _, _ = fused_letterbox(f, out_hw, out_dtype)
            ref, _, _ = letterbox(f, out_hw, src, dtype=out_dtype)
            assert bits_equal(out.permute(0, 2, 3, 1), ref)


def test_letterbox_kernel_refuses_rows_past_shared_memory(cuda):
    """A 200 x 6400 frame into 64 x 64: a warp's copy of a source row (100
    source pixels an output column) would take 307 KB of shared memory a
    block; the launch is refused, and the wrapper raises."""
    f = frames((200, 6400), 1, seed=4).to(cuda)
    with pytest.raises(ValueError):
        preprocess_kernel.letterbox_plan(1, 200, 6400, (64, 64))
    with pytest.raises(RuntimeError):
        fused_letterbox(f, (64, 64))


@pytest.mark.parametrize("n", [1, 3, 8])
@pytest.mark.parametrize("hw", [(80, 160), (33, 65)])
def test_lane_filter_kernel_on_a_batch(cuda, n, hw):
    """N streams in one launch (a cluster each): every stream's weight
    images and start points bit-equal to the plain version and to a launch
    on that stream alone."""
    kinds = ("lanes", "dashed", "one-sided", "empty", "random")
    masks = torch.stack([lane_masks(hw, kinds[i % 5], 30 + i) for i in range(n)]).to(cuda)
    before = lane_filter_walk.launches
    weights, starts = lane_filter_walk(masks)
    assert lane_filter_walk.launches == before + 1
    assert weights.shape == (n, 2, *hw) and starts.shape == (n, 2, 3)
    ref_w, ref_s = lane_filter_walk_plain(masks)
    assert torch.equal(weights, ref_w) and torch.equal(starts, ref_s)
    for i in range(n):
        w1, s1 = lane_filter_walk(masks[i])
        assert torch.equal(w1, weights[i]) and torch.equal(s1, starts[i])


@pytest.mark.parametrize("n", [1, 3, 8])
@pytest.mark.parametrize("k", [33, 256, 1024, 1025, 1200, nms_kernel.MAX_K])
def test_nms_kernel_on_a_batch(cuda, n, k):
    """N candidate sets in one launch (a cluster each): every stream's
    outputs bit-equal (NaN payloads included) to the plain version and to
    a launch on that stream alone."""
    kinds = ("live", "dead", "degenerate", "nan")
    tops = [nms_edge_candidates(k, kinds[i % 4], 40 + i, cuda) for i in range(n)]
    top = tuple(torch.stack(parts) for parts in zip(*tops))
    kw = dict(max_det=64, iou_thresh=0.5, conf_thresh=0.5)
    before = nms_greedy.launches
    out = nms_greedy(*top, **kw)
    assert nms_greedy.launches == before + 1
    assert bits_equal_all(out, nms_greedy_plain(*top, **kw))
    for i in range(n):
        assert bits_equal_all([o[i] for o in out], nms_greedy(*tops[i], **kw))


def lat_cfg():
    from autoware_vision_pilot_tpu_torch.runtime.config import Config
    return Config()


def test_fleet_on_card_makes_no_host_sync(cuda):
    """The batched lateral and longitudinal steps at N = 3 in bf16, each
    tick under sync-debug "error": one preprocess, walk, letterbox and NMS
    launch a tick for the 3 streams, and well-formed outputs."""
    from autoware_vision_pilot_tpu_torch.runtime.fleet import (FleetLateralPipeline,
                                                               FleetLongitudinalPipeline)
    lat = build_lateral_pipeline(cuda, torch.bfloat16, **LATERAL)
    lon = build_longitudinal_pipeline(cuda, torch.bfloat16, seed=1, frame_hw=(120, 200),
                                      input_hw=(128, 128))
    fl = FleetLateralPipeline(lat.lanes, lat.steer_net, lat_cfg(), 3, frame_hw=(120, 200),
                              crop_y=20, dtype=torch.bfloat16, net_hw=(96, 192))
    fo = FleetLongitudinalPipeline(lon.net, lat_cfg(), 3, frame_hw=(120, 200),
                                   input_hw=(128, 128))
    fs = frames((120, 200), 3, seed=12).to(cuda)
    states = fl.init_states(0)
    torch.cuda.synchronize()
    before = (fused_preprocess.launches, lane_filter_walk.launches, fused_letterbox.launches,
              nms_greedy.launches)
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            out, states = fl(fs, states)
            tables = fo(fs)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert (fused_preprocess.launches, lane_filter_walk.launches, fused_letterbox.launches,
            nms_greedy.launches) == tuple(b + 2 for b in before)
    assert out["scalars"].shape == (3, 8) and tables.shape == (3, 64, 7)
    assert torch.isfinite(tables).all()
    assert ((out["lane_masks"] == 0) | (out["lane_masks"] == 1)).all()


def test_engines_on_card(cuda):
    """PipelineEngine and FleetEngine on the card at the small geometry, the
    dispatch under sync-debug "error" (run(sync_check=True)): in-order
    results, finite, device times from their CUDA events."""
    from autoware_vision_pilot_tpu_torch.perception.tracking import ObjectFinder
    from autoware_vision_pilot_tpu_torch.runtime.fleet import (FleetEngine,
                                                               FleetLateralPipeline,
                                                               FleetLongitudinalPipeline)
    from autoware_vision_pilot_tpu_torch.runtime.pipeline import PipelineEngine
    cfg = lat_cfg()
    cfg.target_fps = 0.0
    lat = build_lateral_pipeline(cuda, torch.bfloat16, **LATERAL)
    lon = build_longitudinal_pipeline(cuda, torch.bfloat16, seed=1, frame_hw=(120, 200),
                                      input_hw=(128, 128))
    host = frames((120, 200), 6, seed=13).numpy()
    it = iter(host)
    eng = PipelineEngine(cfg, lat, lon, ObjectFinder(np.eye(3), 200, 120),
                         frame_source=lambda: next(it, None))
    res = eng.run(pipeline_depth=2, sync_check=True)
    assert [r.frame_num for r in res] == list(range(6)) and len(eng.device_ms) == 6
    assert all(np.isfinite([r.steering_deg, r.set_speed]).all() for r in res)
    fl = FleetLateralPipeline(lat.lanes, lat.steer_net, cfg, 3, frame_hw=(120, 200), crop_y=20,
                              dtype=torch.bfloat16, net_hw=(96, 192))
    fo = FleetLongitudinalPipeline(lon.net, cfg, 3, frame_hw=(120, 200), input_hw=(128, 128))
    ticks = iter(host.reshape(2, 3, 120, 200, 3))
    feng = FleetEngine(cfg, fl, fo, [ObjectFinder(np.eye(3), 200, 120) for _ in range(3)],
                       frame_source=lambda: next(ticks, None))
    out = feng.run(pipeline_depth=1, sync_check=True)
    assert len(out) == 2 and all(len(r) == 3 for r in out) and len(feng.device_ms) == 2


# ---------- the per-network wrappers, the backend, min_channels 128 ----------

# (window, cin, cout, h, w): the int8 conv shapes that the wrappers'
# min_channels 128 brings (tests/test_torch_int8_plan.py::MIN128_INT8), the
# 320x640 ones at 160x320 (400 tiles: still the wgmma route)
MIN128_CARD = ((3, 128, 1, 160, 320), (3, 128, 3, 80, 160), (3, 128, 64, 160, 320),
               (3, 128, 128, 160, 320), (3, 128, 256, 10, 20), (1, 144, 24, 80, 160),
               (1, 144, 40, 40, 80), (1, 240, 40, 40, 80), (1, 240, 80, 20, 40),
               (1, 192, 1152, 10, 20), (1, 144, 6, 1, 1), (1, 240, 10, 1, 1))


@pytest.mark.parametrize("k,cin,cout,h,w", MIN128_CARD,
                         ids=[f"{k}x{k}-{c}-{n}-{h}x{w}" for k, c, n, h, w in MIN128_CARD])
def test_int8_min128_shapes_match_plain_version(cuda, k, cin, cout, h, w):
    """N = 1, 3 and 64 on the wgmma route's 128-wide tiles (odd N: the
    epilogue's scalar stores; a channels_last output of 1 or 3 channels),
    the split-K 128 -> 256 at 10x20, and the 1x1 and SE convs with 144 and
    240 input channels (a K range ending on half a 32-channel step): int32
    accumulators and bf16/f32 outputs bit-equal, through int8_conv and
    int8_conv2d, scalar and per-input-channel scales."""
    route = int8_conv_plan(1, h, w, cin, cout, k, k, k // 2, sm_count()).route
    assert route == ("dot" if h * w == 1 else "pointwise" if k == 1
                     else "splitk" if h * w == 200 else "wgmma")
    hold_int8_shape(cuda, k, cin, cout, h, w, route)


def hold_int8_shape(cuda, k, cin, cout, h, w, route):
    """int32 accumulators and bf16/f32 outputs of one int8 conv shape
    bit-equal to the plain versions, through int8_conv and int8_conv2d,
    scalar and per-input-channel scales, all on ``route``."""
    g = torch.Generator().manual_seed(cin * cout + k)
    x = torch.randn(1, cin, h, w, generator=g) * torch.linspace(0.5, 2.0, cin).reshape(1, -1, 1, 1)
    wq = torch.randint(-127, 128, (cout, cin, k, k), generator=g,
                       dtype=torch.int8).contiguous(memory_format=CL).to(cuda)
    w_scale = (torch.rand(cout, generator=g) * 1e-3 + 1e-4).to(cuda)
    scales = [torch.tensor(float(x.abs().max()) * 0.9 / 127.0),
              (x.double().abs().amax(dim=(0, 2, 3)) / 127.0).float()]
    before = int8_conv.route_launches[route]
    for dtype in (torch.float32, torch.bfloat16):
        xd = x.to(dtype).contiguous(memory_format=CL).to(cuda)
        bias = (torch.randn(cout, generator=g) * 0.1).to(dtype).to(cuda)
        for sx in scales:
            sx = sx.to(cuda)
            xq = int8_quantize(xd, sx)
            assert torch.equal(xq, int8_quantize_plain(xd, sx))
            acc = int8_conv(xq, wq, w_scale, sx, None, k // 2, torch.int32)
            want = int8_conv_plain(xq, wq, w_scale, sx, bias, k // 2, dtype)
            y = int8_conv(xq, wq, w_scale, sx, bias, k // 2, dtype)
            y2d = int8_conv2d(xd, wq, w_scale, sx, bias, k // 2)
            torch.cuda.synchronize()
            assert torch.equal(acc, int8_conv_plain(xq, wq, w_scale, sx, None, k // 2,
                                                    torch.int32))
            assert y.is_contiguous(memory_format=CL) and tuple(y.shape) == (1, cout, h, w)
            assert torch.equal(y, want) and torch.equal(y2d, want)
    assert int8_conv.route_launches[route] == before + 12


# (cin, cout) of UNet++'s 3x3 int8 convs whose C is not a multiple of 128
# (chip_smoke.py::LITE_SHAPES): the last 128-channel K step is partial, and
# 136, 152, 216 and 344 are padded to a multiple of 16 by int8_conv
LITE_3X3 = ((136, 64), (152, 64), (216, 128), (344, 128), (416, 256), (432, 32),
            (672, 256), (928, 256))
LITE_CARD = [(cin, cout, 10, 20) for cin, cout in LITE_3X3] + [
    (216, 128, 80, 160), (344, 128, 80, 160)]  # their own shape, on the wgmma route


@pytest.mark.parametrize("cin,cout,h,w", LITE_CARD,
                         ids=[f"3x3-{c}-{n}-{h}x{w}" for c, n, h, w in LITE_CARD])
def test_int8_lite_3x3_shapes_match_plain_version(cuda, cin, cout, h, w):
    """UNet++'s 3x3 convs with C % 128 != 0 at a small M (10x20: split-K)
    and 216/344 -> 128 at 80x160 (wgmma)."""
    route = int8_conv_plan(1, h, w, padded_channels(cin), cout, 3, 3, 1, sm_count()).route
    assert route == ("splitk" if h * w == 200 else "wgmma")
    hold_int8_shape(cuda, 3, cin, cout, h, w, route)


SMALL = dict(input_hw=(64, 128))


def small_wrappers():
    from autoware_vision_pilot_tpu_torch import inference as tinfer
    from autoware_vision_pilot_tpu_torch.models import (DomainSegNetwork, EgoLanesNetwork,
                                                        Scene3DNetwork, SceneSegNetwork)
    return {"scene_seg": (tinfer.SceneSegInfer, lambda: SceneSegNetwork((2, 4), B0_DRYRUN_STAGES)),
            "scene_3d": (tinfer.Scene3DInfer, lambda: Scene3DNetwork((2, 4))),
            "domain_seg": (tinfer.DomainSegInfer, lambda: DomainSegNetwork((2, 4))),
            "ego_lanes": (tinfer.EgoLanesInfer,
                          lambda: EgoLanesNetwork((2, 4), B0_DRYRUN_STAGES))}


@pytest.mark.parametrize("name", ["scene_seg", "scene_3d", "domain_seg", "ego_lanes"])
def test_wrappers_on_card_match_cpu(cuda, name):
    """The seg wrappers at 64x128 in f32, TF32 off: the raw forward on the
    card within 1e-3 * max|CPU| of the same wrapper on the CPU, one
    preprocess launch a frame."""
    cls, net = small_wrappers()[name]
    frame = frames((128, 256), 1, seed=5)[0]
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        ref = cls(model=net(), device="cpu", **SMALL).logits(frame)
        w = cls(model=net(), **SMALL)
        assert w.device.type == "cuda" and w.dtype == torch.float32
        before = fused_preprocess.launches
        out = w.logits(frame.to(cuda))
        assert fused_preprocess.launches == before + 1
        torch.testing.assert_close(out.cpu(), ref, rtol=0, atol=1e-3 * ref.abs().max().item())
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32


def test_int8_wrapper_on_card_conv_by_conv(cuda):
    """EgoLanes at 64x128 with precision="int8" (min_channels 128; its head's
    3x3 128 -> 3 conv on a 128-wide tile), quantized and calibrated on the
    CPU, copied to the card: each int8 conv fed the CPU conv's input gives
    its output bit for bit."""
    cls, net = small_wrappers()["ego_lanes"]
    frame = frames((128, 256), 1, seed=6)[0]
    cpu = cls(model=net(), device="cpu", precision="int8", **SMALL)
    card = copy.deepcopy(cpu)
    card.model.to(cuda)
    card.device = cuda
    mods = {n: [m for m in w.model.modules() if isinstance(m, Int8Conv2d)] for n, w in
            (("cpu", cpu), ("card", card))}
    assert len(mods["cpu"]) == len(mods["card"]) == 19
    calls = {"cpu": [], "card": []}
    forced = []

    def hooks(key):
        def pre(m, args):
            if key == "card":
                return (forced[len(calls[key])].to(cuda),)

        def post(m, args, y):
            calls[key].append(y)
            if key == "cpu":
                forced.append(args[0])
        return [h for m in mods[key] for h in (m.register_forward_pre_hook(pre),
                                               m.register_forward_hook(post))]

    handles = hooks("cpu")
    cpu.logits(frame)
    handles += hooks("card")
    card.logits(frame.to(cuda))
    for h in handles:
        h.remove()
    assert len(calls["card"]) == 19
    for i, (a, b) in enumerate(zip(calls["card"], calls["cpu"])):
        assert torch.equal(a.cpu(), b), i


def test_backend_on_card_matches_wrapper(cuda):
    """backend_from_params (bf16, seeded weights, by file stem) on the card:
    do_inference equals the EgoLanes wrapper's raw forward bit for bit."""
    from autoware_vision_pilot_tpu_torch.inference import EgoLanesInfer
    from autoware_vision_pilot_tpu_torch.middleware import backend_from_params

    b = backend_from_params({"model_path": "/no/such/dir/ego_lanes.msgpack"})
    assert b.device.type == "cuda" and b.dtype == torch.bfloat16
    frame = frames((720, 1280), 1, seed=7)[0]
    got = b.do_inference(frame.numpy())
    want = EgoLanesInfer(dtype=torch.bfloat16).logits(frame.to(cuda))[0].float().cpu().numpy()
    assert got.shape == (80, 160, 3) and np.array_equal(got, want)


# (C, O, k, h, w, batch): the int8 transposed conv (k == s) on the card: the
# main path's widths at small maps, a K not a multiple of 128 (1456, with
# the 1456-wide O no N tile divides), O = 3 and O = 12 (stored value by
# value), C = 40 (padded to 48), a batch of two, K split over 3 blocks (one
# output tile, C = 1456), and O = 20 at C = 200 (value by value, C padded)
TRANSPOSE_CARD = [(256, 256, 2, 20, 40, 1), (1456, 1456, 2, 10, 20, 1), (512, 512, 2, 8, 10, 2),
                  (64, 3, 2, 5, 7, 1), (48, 12, 3, 6, 9, 2), (40, 64, 2, 3, 5, 1),
                  (1456, 64, 2, 4, 4, 1), (200, 20, 2, 13, 7, 1)]


def transpose_inputs(C, O, k, h, w, batch, dtype, seed, device):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(batch, C, h, w, generator=g) * 2).to(device=device, dtype=dtype)
    weight = torch.randint(-127, 128, (k, k, O, C), generator=g, dtype=torch.int8)
    return (x.contiguous(memory_format=CL), weight.to(device).permute(3, 2, 0, 1),
            (torch.rand(O, generator=g) * 0.02 + 1e-3).to(device),
            (torch.randn(O, generator=g) * 0.1).to(device=device, dtype=dtype))


@pytest.mark.parametrize("static", [True, False], ids=["static", "dynamic"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("C,O,k,h,w,batch", TRANSPOSE_CARD)
def test_int8_conv_transpose_matches_plain_version(cuda, C, O, k, h, w, batch, dtype, static):
    """The kernel (the wgmma kernel's d2s variant after the quantize) against
    its plain version on the same card inputs, bit for bit: the outputs in
    f32 and bf16 and the int32 accumulators."""
    from autoware_vision_pilot_tpu_torch.ops.kernels.int8_conv import (
        dynamic_input_scale, int8_conv_transpose)
    x, weight, ws, bias = transpose_inputs(C, O, k, h, w, batch, dtype, C + O + k, cuda)
    sx = torch.tensor(0.0213, device=cuda) if static else dynamic_input_scale(x)[0]
    before = int8_conv_transpose.launches, int8_quantize.launches
    got = int8_conv_transpose(x, weight, ws, sx, bias)
    other = torch.bfloat16 if dtype == torch.float32 else torch.float32
    got_other = int8_conv_transpose(x, weight, ws, sx, bias.to(other), other)
    acc = int8_conv_transpose(x, weight, ws, sx, None, torch.int32)
    assert (int8_conv_transpose.launches, int8_quantize.launches) == (before[0] + 3,
                                                                      before[1] + 3)
    want = int8_conv_transpose(x, weight, ws, sx, bias, plain=True)
    assert got.shape == (batch, O, h * k, w * k) and got.dtype == dtype
    assert got.is_contiguous(memory_format=CL)
    assert torch.equal(got, want)
    assert torch.equal(got_other, int8_conv_transpose(x, weight, ws, sx, bias.to(other), other,
                                                      plain=True))
    assert torch.equal(acc, int8_conv_transpose(x, weight, ws, sx, None, torch.int32,
                                                plain=True))


def test_int8_conv_transpose_refuses_and_never_falls_back(cuda, monkeypatch):
    from autoware_vision_pilot_tpu_torch.ops.kernels import int8_conv as k
    x, weight, ws, bias = transpose_inputs(64, 16, 2, 4, 6, 1, torch.bfloat16, 3, cuda)
    sx = torch.tensor(0.03, device=cuda)
    with pytest.raises(ValueError, match="channels_last"):
        k.int8_conv_transpose(x, weight.contiguous(memory_format=CL), ws, sx, bias)
    with pytest.raises(ValueError, match="scalar"):
        k.int8_conv_transpose(x, weight, ws, torch.full((64,), 0.03, device=cuda), bias)

    def boom(*args, **kwargs):
        raise AssertionError("a plain version ran on the card")

    monkeypatch.setattr(k, "int8_conv_transpose_plain", boom)
    monkeypatch.setattr(k, "int8_quantize_plain", boom)
    k.int8_conv_transpose(x, weight, ws, sx, bias)
    torch.cuda.synchronize()
    with pytest.raises(AssertionError):
        k.int8_conv_transpose(x.cpu(), weight.cpu(), ws.cpu(), sx.cpu(), bias.cpu())


def test_int8_transpose_main_path_on_card_matches_cpu(cuda):
    """The small int8 main path with quantize_transpose=True, quantized and
    calibrated on the CPU, copied to the card: each of the 83 int8 modules
    (72 convs, 11 transposed convs) gets the CPU module's input and gives
    its output bit for bit."""
    from autoware_vision_pilot_tpu_torch.export.quantize import (
        calibrate_int8_activation_scales, quantize_for_int8_conv)
    from autoware_vision_pilot_tpu_torch.nn.layers import Int8ConvTranspose2d
    from autoware_vision_pilot_tpu_torch.ops.kernels.int8_conv import int8_conv_transpose
    from autoware_vision_pilot_tpu_torch.pipeline import calibration_batches
    frame = frames((144, 256), 1, seed=4)[0]
    cpu = build_pipeline_fused("cpu", torch.float32, seed=0, ctx_hw=(2, 4), out_hw=(64, 128))
    for net in (cpu.stack, cpu.lanes):
        quantize_for_int8_conv(net, 256, quantize_transpose=True)
        calibrate_int8_activation_scales(net, calibration_batches((64, 128), torch.float32,
                                                                  "cpu"))
    card = copy.deepcopy(cpu)
    for net in (card.stack, card.lanes):
        net.to(cuda)
    kinds = (Int8Conv2d, Int8ConvTranspose2d)

    def hooks(pipe, forced=None):
        calls = []

        def pre(m, args):
            if forced is not None:
                return (forced[len(calls)].to(args[0].device),)

        def post(m, args, y):
            calls.append((args[0], y))

        handles = [h for net in (pipe.stack, pipe.lanes) for m in net.modules()
                   if isinstance(m, kinds)
                   for h in (m.register_forward_pre_hook(pre), m.register_forward_hook(post))]
        return calls, lambda: [h.remove() for h in handles]

    calls, remove = hooks(cpu)
    cpu.logits(frame)
    remove()
    before = int8_conv_transpose.launches
    card_calls, remove = hooks(card, [x for x, _ in calls])
    card.logits(frame.to(cuda))
    remove()
    assert len(calls) == len(card_calls) == 83
    assert int8_conv_transpose.launches == before + 11
    for i, ((_, want), (_, got)) in enumerate(zip(calls, card_calls)):
        assert torch.equal(got.cpu(), want), i


def plain_kernels(monkeypatch, modules=()):
    """Routes inference/infer.py's preprocess and letterbox kernels, the NMS
    kernel and the int8 convs of ``modules`` through their plain versions,
    on CUDA tensors, for a reference run."""
    from autoware_vision_pilot_tpu_torch.inference import infer

    def preprocess(frame, out_hw, out_dtype):
        f = frame if frame.dim() == 4 else frame[None]
        return preprocess_imagenet(f, out_hw, out_dtype).permute(0, 3, 1, 2)

    def letterbox_plain(frame, out_hw, out_dtype):
        f = frame if frame.dim() == 4 else frame[None]
        x, scale, pad = letterbox(f, out_hw, tuple(f.shape[1:3]), dtype=out_dtype)
        return x.permute(0, 3, 1, 2), scale, pad

    monkeypatch.setattr(infer, "fused_preprocess", preprocess)
    monkeypatch.setattr(infer, "fused_letterbox", letterbox_plain)
    monkeypatch.setattr(nms_kernel, "nms_greedy", nms_greedy_plain)
    for model in modules:
        for m in model.modules():
            if isinstance(m, Int8Conv2d):
                m.plain = True


def test_nodes_on_card_match_plain_kernels(cuda, monkeypatch):
    """RunModelNode over SceneSeg (bf16, backend_from_params) and over
    EgoLanes with its int8 convs (precision="int8", min_channels 128), and
    RunAutoSpeedNode (AutoSpeed "n" 640x640, bf16, 0.5/0.5), on one image
    topic, two 720p frames on the card: one preprocess launch a frame for
    each model node, the int8 node's int8 convs, one letterbox and one NMS
    launch a frame; then the same nodes through the plain versions (no
    launch): equal masks and equal detection tables."""
    from autoware_vision_pilot_tpu_torch.inference import EgoLanesInfer
    from autoware_vision_pilot_tpu_torch.middleware import (
        InProcTransport, RunAutoSpeedNode, RunModelNode, TorchInferenceBackend,
        backend_from_params)

    t = InProcTransport()
    lanes = EgoLanesInfer(dtype=torch.bfloat16, precision="int8")
    RunModelNode(t, backend_from_params({"model_type": "segmentation"}), output_topic="/seg")
    RunModelNode(t, TorchInferenceBackend(lanes.model, model_type="egolanes"),
                 output_topic="/lanes", model_type="egolanes")
    RunAutoSpeedNode(t)
    msgs = {k: [] for k in ("/seg", "/lanes", "/autospeed/detections")}
    for k, v in msgs.items():
        t.subscribe(k, v.append)
    pair = frames((720, 1280), 2, seed=31)
    counters = (fused_preprocess, fused_letterbox, nms_greedy, int8_conv)

    def launches():
        return [c.launches for c in counters]

    before = launches()
    for f in pair:
        t.publish("/image_raw", f.numpy())
    torch.cuda.synchronize()
    made = [a - b for a, b in zip(launches(), before)]
    assert made[:3] == [4, 2, 2] and made[3] > 0, made
    plain_kernels(monkeypatch, [lanes.model])
    before = launches()
    for f in pair:
        t.publish("/image_raw", f.numpy())
    assert launches() == before
    assert msgs["/seg"][0].shape == (320, 640) and msgs["/lanes"][0].shape == (80, 160, 3)
    for k, got in msgs.items():
        assert len(got) == 4
        for i in range(2):
            assert got[i].dtype == got[i + 2].dtype and np.array_equal(got[i], got[i + 2]), k
    assert 0 < len(msgs["/autospeed/detections"][0]) <= 64


def train_once(net, x, ids, **kw):
    from autoware_vision_pilot_tpu_torch.train import (create_seg_train_state,
                                                       make_seg_train_step,
                                                       segmentation_ce_loss)
    from autoware_vision_pilot_tpu_torch.train.train_step import adamw
    state = create_seg_train_state(net, adamw(1e-4), ema="ema_decay" in kw)
    step = make_seg_train_step(segmentation_ce_loss, **kw)
    state, loss = step(state, x, ids, torch.Generator().manual_seed(3))
    return state, loss, {n: p.grad.detach().cpu() for n, p in net.named_parameters()}


def test_train_step_on_card_matches_cpu(cuda):
    """One f32 train step of SceneSeg at dryrun depth (64x128, batch 2) on
    the card with TF32 off against the CPU, the same weights and the same
    masks (a CPU generator on both sides): the loss, the gradients (one
    bar, 1e-3 x the largest CPU gradient: some are 0 but for rounding) and
    the BatchNorm statistics within 1e-3 x max|CPU|. Then bf16 autocast,
    microbatches 2 and EMA on the card: finite, and the weights moved."""
    from autoware_vision_pilot_tpu_torch.models import SceneSegNetwork
    from autoware_vision_pilot_tpu_torch.nn.layers import init_seeded
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cpu = init_seeded(SceneSegNetwork((2, 4), B0_DRYRUN_STAGES), torch.Generator())
        card = copy.deepcopy(cpu).to(cuda, memory_format=CL)
        g = torch.Generator().manual_seed(4)
        x = torch.randn(2, 3, 64, 128, generator=g)
        ids = torch.randint(0, 3, (2, 64, 128), generator=g)
        _, lc, gc = train_once(cpu, x, ids)
        _, lg, gg = train_once(card, x.to(cuda), ids.to(cuda))
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    assert abs(lg.item() - lc.item()) <= 1e-3 * abs(lc.item())
    gmax = max(t.abs().max().item() for t in gc.values())
    assert max((gg[k] - t).abs().max().item() for k, t in gc.items()) <= 1e-3 * gmax
    for k, t in cpu.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            got = card.state_dict()[k].cpu()
            assert (got - t).abs().max().item() <= 1e-3 * t.abs().max().item(), k
    before = {k: t.clone() for k, t in card.state_dict().items()}
    state, loss, _ = train_once(card, torch.cat([x, x]).to(cuda).contiguous(memory_format=CL),
                                torch.cat([ids, ids]).to(cuda), microbatches=2,
                                ema_decay=0.99, compute_dtype=torch.bfloat16)
    assert math.isfinite(loss.item()) and state.step == 1
    assert all(torch.isfinite(e).all() for e in state.ema.values())
    assert any(not torch.equal(before[k], t) for k, t in card.state_dict().items())


def test_qat_export_int8_calls_match_plain(cuda):
    """QAT on the card (one observer forward of SceneSeg at dryrun depth,
    64x128, f32), int8_variables_from_qat at min_channels 32: every int8
    conv of a frame equal to its plain version on its own input, and the
    halo route among the launches (the head's 64 -> 3 3x3 conv)."""
    from autoware_vision_pilot_tpu_torch.models import SceneSegNetwork
    from autoware_vision_pilot_tpu_torch.nn.layers import init_seeded
    from autoware_vision_pilot_tpu_torch.train.qat import (collect_act_scales,
                                                           int8_variables_from_qat, qat_apply)
    net = init_seeded(SceneSegNetwork((2, 4), B0_DRYRUN_STAGES), torch.Generator())
    net.to(cuda, memory_format=CL).eval()
    x = torch.randn(1, 3, 64, 128, generator=torch.Generator().manual_seed(5)).to(cuda)
    x = x.contiguous(memory_format=CL)
    observers = {}
    with torch.no_grad():
        qat_apply(net, x, observers=observers)
    int8 = int8_variables_from_qat(net, collect_act_scales(observers), 32)
    calls = []

    def check(m, args, y):
        ref = int8_conv2d(args[0].contiguous(memory_format=CL), m.weight, m.weight_scale,
                          m.input_scale, m.bias, m.padding, plain=True)
        calls.append(torch.equal(y, ref))

    handles = [m.register_forward_hook(check) for m in int8.modules()
               if isinstance(m, Int8Conv2d)]
    before = dict(int8_conv.route_launches)
    with torch.no_grad():
        int8(x)
    torch.cuda.synchronize()
    for h in handles:
        h.remove()
    made = {k: int8_conv.route_launches[k] - before[k] for k in before}
    assert len(calls) == 30 and all(calls)
    assert sum(made.values()) == 30 and made["halo"] >= 1, made


def test_detection_validation_nms_on_card(cuda, monkeypatch):
    """DetectionTrainer.validate's NMS at max_det 300, conf 0.001, iou 0.65
    on AutoSpeed "n" at 512x1024 (k = min(4 * 300, A) = 1,200 a stream):
    one kernel launch for the batch, bit-equal to the plain version on the
    same candidates, and validate's mAP the same with the plain version in
    the kernel's place."""
    from autoware_vision_pilot_tpu_torch.models.auto_speed import AutoSpeedNetwork
    from autoware_vision_pilot_tpu_torch.train import detection_trainer as dt

    tr = dt.DetectionTrainer(AutoSpeedNetwork("n", 4, 512, 1024), dt.DetectionTrainerConfig(),
                             device=cuda)
    images = frames((512, 1024), 2, seed=80).numpy()
    top = tr.candidates(images, 0.001, 300)
    assert tuple(top[1].shape) == (2, 1200)
    kw = dict(max_det=300, iou_thresh=0.65, conf_thresh=0.001)
    before = nms_greedy.launches
    out = tr.predictions(images, 0.001, 0.65, 300)
    torch.cuda.synchronize()
    assert nms_greedy.launches == before + 1
    assert bits_equal_all(out, nms_greedy_plain(*top, **kw))
    val = []
    for b in range(2):
        keep = out[3][b].nonzero()[:, 0][::3][:6].cpu()
        val.append((out[0][b].cpu()[keep].numpy() + 1.5, out[2][b].cpu()[keep].numpy()))
    batches = [(images, [v[0] for v in val], [v[1] for v in val])]
    before = nms_greedy.launches
    got = tr.validate(iter(batches))
    assert nms_greedy.launches == before + 1
    monkeypatch.setattr(dt, "nms_greedy", nms_greedy_plain)
    assert tr.validate(iter(batches)) == got
    assert nms_greedy.launches == before + 1


# ---------- data parallelism and the mesh ----------

class Replay:
    """A forward hook: records each call's output, or (``ref`` set) returns
    the next rows of the recorded outputs call by call, so that a tick's
    shards get their streams' rows in order."""

    def __init__(self):
        self.calls, self.ref, self.row = [], None, 0

    def __call__(self, module, args, y):
        if self.ref is None:
            self.calls.append(y)
            return None
        n, full = args[0].shape[0], self.ref[0]
        rows = lambda t: t[self.row:self.row + n]  # noqa: E731
        out = tuple(map(rows, full)) if isinstance(full, tuple) else rows(full)
        self.row += n
        if self.row == (full[0] if isinstance(full, tuple) else full).shape[0]:
            self.ref, self.row = self.ref[1:], 0
        return out


def test_fleet_over_a_mesh_of_the_card_twice(cuda):
    """The fleet at N = 4, f32 with TF32 off at the small geometry, over
    [cuda:0] (bit-equal to no mesh) and over [cuda:0, cuda:0] (two shards
    of 2, a replica of the networks shared on the one card) against no
    mesh, 2 ticks, the networks fed the unsharded run's outputs: masks,
    flags, AutoSteer's angle and the detection tables equal, lane fits
    within 5e-3 * max|ref|; each kernel launches once a shard a tick."""
    from autoware_vision_pilot_tpu_torch.core.mesh import make_mesh
    from autoware_vision_pilot_tpu_torch.runtime.fleet import (FleetLateralPipeline,
                                                               FleetLongitudinalPipeline)
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    lat = build_lateral_pipeline(cuda, torch.float32, **LATERAL)
    lon = build_longitudinal_pipeline(cuda, torch.float32, seed=1, frame_hw=(120, 200),
                                      input_hw=(128, 128))
    fs = frames((120, 200), 8, seed=14).to(cuda).view(2, 4, 120, 200, 3)
    hooks = [Replay(), Replay(), Replay()]
    handles = [m.register_forward_hook(h) for m, h in zip((lat.lanes, lat.steer_net, lon.net),
                                                         hooks)]

    def run(mesh):
        fl = FleetLateralPipeline(lat.lanes, lat.steer_net, lat_cfg(), 4, frame_hw=(120, 200),
                                  crop_y=20, dtype=torch.float32, net_hw=(96, 192), mesh=mesh)
        fo = FleetLongitudinalPipeline(lon.net, lat_cfg(), 4, frame_hw=(120, 200),
                                       input_hw=(128, 128), dtype=torch.float32, mesh=mesh)
        states, outs = fl.init_states(0), []
        for tick in fs:
            out, states = fl(tick, states)
            outs.append((out, fo(tick)))
        return outs

    try:
        want = run(None)
        got = run(make_mesh(devices=[cuda]))
        for (a, ta), (b, tb) in zip(got, want):
            assert torch.equal(ta, tb)
            assert all(torch.equal(torch.nan_to_num(a[k]), torch.nan_to_num(b[k])) for k in a)
        for h in hooks:
            h.ref = list(h.calls)
        before = (fused_preprocess.launches, lane_filter_walk.launches, fused_letterbox.launches,
                  nms_greedy.launches)
        got = run(make_mesh(devices=[cuda, cuda]))
        assert (fused_preprocess.launches, lane_filter_walk.launches, fused_letterbox.launches,
                nms_greedy.launches) == tuple(b + 4 for b in before)
    finally:
        for h in handles:
            h.remove()
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    flags = [SCALAR_FIELDS.index(f) for f in ("autosteer_deg", "fused_valid", "path_valid")]
    for (a, ta), (b, tb) in zip(got, want):
        assert torch.equal(ta, tb) and torch.equal(a["lane_masks"], b["lane_masks"])
        assert torch.equal(a["scalars"][:, flags], b["scalars"][:, flags])
        assert torch.equal(torch.isnan(a["coeffs"]), torch.isnan(b["coeffs"]))
        fin = torch.isfinite(b["coeffs"])
        scale = torch.where(fin, b["coeffs"], 0.0).abs().amax().clamp_min(1e-30)
        assert (torch.where(fin, a["coeffs"] - b["coeffs"], 0.0).abs() <= 5e-3 * scale).all()


def test_synced_batchnorm_world_of_one(cuda, tmp_path):
    """An NCCL world of one process: the train step over its world mesh is
    bit-equal to the step without a mesh (at one rank BatchNorm keeps its
    local path: nothing to sync); and the synced BatchNorm's own arithmetic,
    run over that world, is held to the local one at 1e-5 (output, running
    statistics, input and weight gradients)."""
    import torch.distributed as dist
    from autoware_vision_pilot_tpu_torch.core.mesh import make_mesh
    from autoware_vision_pilot_tpu_torch.nn import layers as tl
    from autoware_vision_pilot_tpu_torch.parallel.distributed import destroy_world, init_world
    from autoware_vision_pilot_tpu_torch.parallel.sharding import BatchShard
    from autoware_vision_pilot_tpu_torch.train import (create_seg_train_state,
                                                       make_seg_train_step,
                                                       segmentation_ce_loss)
    from autoware_vision_pilot_tpu_torch.train.train_step import adamw

    g = torch.Generator().manual_seed(5)
    x = torch.randn(4, 3, 16, 32, generator=g).to(cuda)
    ids = torch.randint(0, 3, (4, 16, 32), generator=g).to(cuda)
    init_world(1, 0, f"file://{tmp_path / 'store'}", device=cuda)
    try:
        mesh = make_mesh()
        assert mesh.size == 1 and mesh.group is not None and dist.get_backend() == "nccl"
        runs = []
        for m in (None, mesh):
            net = tl.init_seeded(torch.nn.Sequential(
                tl.Conv2d(3, 8, 3, 1, 1), tl.BatchNorm2d(8), tl.Dropout(0.2),
                tl.Conv2d(8, 3, 1)), torch.Generator().manual_seed(6)).to(cuda)
            state = create_seg_train_state(net, adamw(1e-3))
            step = make_seg_train_step(segmentation_ce_loss, mesh=m, microbatches=2)
            state, loss = step(state, x, ids, torch.Generator().manual_seed(7))
            runs.append((loss, net.state_dict()))
        assert torch.equal(runs[0][0], runs[1][0])
        assert all(torch.equal(runs[0][1][k], runs[1][1][k]) for k in runs[0][1])
        bn = tl.init_seeded(tl.BatchNorm2d(8), torch.Generator().manual_seed(8)).to(cuda)
        h = torch.randn(4, 8, 16, 32, generator=g).to(cuda).requires_grad_(True)
        w = bn.weight.detach().clone().requires_grad_(True)
        y, mean, var = tl._SyncedBatchNorm.apply(h, w, bn.bias, bn.eps,
                                                 BatchShard(mesh.group, 1, 0))
        (y * y).sum().backward()
        h2 = h.detach().clone().requires_grad_(True)
        w2 = bn.weight.detach().clone().requires_grad_(True)
        y2, mean2, invstd = torch.native_batch_norm(h2, w2, bn.bias, None, None, True, 0.0,
                                                    bn.eps)
        (y2 * y2).sum().backward()
    finally:
        destroy_world()
    for a, b in ((y, y2), (mean.float(), mean2), (var.float(), invstd.double().pow(-2).sub(
            bn.eps).float()), (h.grad, h2.grad), (w.grad, w2.grad)):
        assert (a - b).abs().max().item() <= 1e-5 * max(b.abs().max().item(), 1.0)


def test_data_path_parse_load_and_a_legacy_step_on_card(cuda, tmp_path):
    """chip_smoke.py phase 39's data path on the card: one sample of each raw
    format at its published size through the port's parsers into the
    unified layout, the three loaders read back what the parsers wrote,
    then one step of the legacy SceneSeg trainer (full width, 320x640,
    batch 2, bf16 autocast) on what SceneSegDataset reads from the BDD100K
    and Mapillary layouts: a finite loss, every parameter with a gradient
    moved, the forward in bf16."""
    import pathlib
    import sys
    repo = str(pathlib.Path(__file__).resolve().parents[1])
    if repo not in sys.path:
        sys.path.insert(0, repo)
    import chip_smoke
    from autoware_vision_pilot_tpu_torch.models import SceneSegNetwork
    from autoware_vision_pilot_tpu_torch.train.legacy_trainer import (LegacySegTrainer,
                                                                      LegacyTrainerConfig)

    raw = chip_smoke.write_raw_datasets(tmp_path / "raw", n=1, seed=5)
    written, _ = chip_smoke.parse_raw_datasets(raw, tmp_path / "unified")
    loaders = chip_smoke.unified_loaders(tmp_path / "unified")
    chip_smoke.check_read_back(tmp_path / "unified", written, loaders)
    cfg = LegacyTrainerConfig(num_epochs=1, hw=(320, 640), batch_schedule=(2,), val_every=0,
                              log_every=1, ckpt_dir=str(tmp_path / "ckpt"))
    trainer = LegacySegTrainer(SceneSegNetwork(), [loaders["bdd100k"], loaders["mapillary"]],
                               cfg, seed=5, device=cuda)
    _, _, losses, (moved, trained, _), dtypes = chip_smoke.legacy_steps(
        trainer, lambda tr, on_step: tr.train(callbacks=lambda _, loss: on_step(loss)))
    assert len(losses) == 1 and math.isfinite(losses[0])
    assert trained and not set(trained) - set(moved) and dtypes == {torch.bfloat16}


def avp_op_cases(cuda):
    """Each avp operator's arguments at the exported steps' shapes: the
    lateral crop 720x1280[420:] -> 320x640 bf16, the letterbox 720x1280 ->
    640x640 bf16, the walk on 80x160 masks, NMS on nms_topk's 256."""
    from autoware_vision_pilot_tpu_torch.ops.kernels.preprocess_kernel import (
        _mean_inv_std, letterbox_pad_bits)
    from autoware_vision_pilot_tpu_torch.ops.preprocess import device_taps

    frame = frames((720, 1280), 1, 40).to(cuda)
    _, (nh, nw), (pad_x, pad_y) = letterbox_geometry((640, 640), (720, 1280))
    masks = (torch.rand((1, 80, 160, 3), generator=torch.Generator().manual_seed(41)) > 0.8)
    boxes, scores, cls = (torch.from_numpy(a).to(cuda) for a in nms_candidates("random", 42))
    top = nms_topk(boxes, scores, cls, max_det=64, conf_thresh=0.5)
    bf16 = torch.bfloat16
    return {
        "fused_preprocess": (frame[:, 420:], *device_taps(300, 320, cuda),
                             *device_taps(1280, 640, cuda), *_mean_inv_std(cuda), 320, 640, True),
        "fused_letterbox": (frame, *device_taps(720, nh, cuda), *device_taps(1280, nw, cuda),
                            640, 640, pad_y, pad_x, letterbox_pad_bits(bf16), True),
        "lane_filter_walk": (masks.float().to(cuda),),
        "nms_greedy": (*(t[None] for t in top), 64, 0.5, 0.5, True,
                       nms_kernel.cluster_size(top[1].shape[-1])),
    }


# (B, C, N, kernel, stride, padding, dilation, groups, hw): the strided
# convs of the YOLO-family nets at their map sizes (AutoSpeed "n" at
# 640x640: p3_0, p4_0, p5_0, fpn.h3, fpn.h5; AutoSteer's 2x1 (2, 1) head
# convs at 512x1024 and 256x512; AutoSteer-temporal's c2-c4), a dilated, a
# grouped, a padding a dimension, strides above TMA's traversal limit (one
# output a tile), an 11x11 window whose phase groups take two units of a
# one-stage ring, and a dilation whose phase halo does not fit (a box a tap)
STRIDED_CARD = (
    (1, 64, 64, 3, 2, 1, 1, 1, (160, 160)), (1, 128, 128, 3, 2, 1, 1, 1, (80, 80)),
    (1, 128, 256, 3, 2, 1, 1, 1, (40, 40)), (1, 64, 64, 3, 2, 1, 1, 1, (80, 80)),
    (1, 128, 128, 3, 2, 1, 1, 1, (40, 40)), (1, 64, 32, (2, 1), (2, 1), 0, 1, 1, (128, 256)),
    (2, 32, 64, 3, 2, 1, 1, 1, (40, 80)), (2, 64, 128, 3, 2, 1, 1, 1, (20, 40)),
    (2, 128, 128, 3, 2, 1, 1, 1, (10, 20)), (1, 256, 200, 3, 1, 2, 2, 1, (30, 50)),
    (2, 128, 64, 3, 2, 1, 1, 4, (19, 23)), (1, 48, 24, 3, (1, 2), (1, 0), 1, 1, (17, 30)),
    (1, 32, 16, 3, 12, 1, 1, 1, (40, 60)), (1, 16, 24, 1, (9, 3), 0, 1, 1, (300, 300)),
    (1, 64, 32, (2, 1), (2, 1), 0, 1, 1, (64, 128)), (1, 32, 64, 11, 2, 5, 1, 1, (48, 48)),
    (1, 16, 8, (1, 3), 1, 0, (1, 70), 1, (20, 150)),
)


@pytest.mark.parametrize("B,C,N,k,stride,pad,dil,groups,hw", STRIDED_CARD,
                         ids=[str(s) for s in STRIDED_CARD])
def test_int8_strided_and_grouped_routes_match_plain_version(cuda, B, C, N, k, stride, pad, dil,
                                                            groups, hw):
    """The "strided" route (and one launch a group) on the card against the
    plain version, bit for bit: int32 accumulators, bf16 and f32 outputs,
    scalar and per-channel scales; each launch counted on its route."""
    g = torch.Generator().manual_seed(B + C + N + hw[0])
    kh, kw = (k, k) if isinstance(k, int) else k
    x = torch.randn(B, C, *hw, generator=g).contiguous(memory_format=CL).to(cuda)
    w = torch.randint(-127, 128, (N, C // groups, kh, kw), generator=g,
                      dtype=torch.int8).contiguous(memory_format=CL).to(cuda)
    w_scale = (torch.rand(N, generator=g) * 1e-3 + 1e-4).to(cuda)
    kw_ = dict(stride=stride, dilation=dil, groups=groups)
    scales = [torch.tensor(0.021, device=cuda)]
    if groups == 1:
        scales.append((torch.rand(C, generator=g) * 0.02 + 0.01).to(cuda))
    for sx in scales:
        xq = int8_quantize(x, sx)
        assert torch.equal(xq, int8_quantize_plain(x.cpu(), sx.cpu()).to(cuda))
        for dtype in (torch.int32, torch.bfloat16, torch.float32):
            bias = None if dtype == torch.int32 else torch.randn(N, generator=g).to(cuda, dtype)
            before = int8_conv.route_launches["strided"]
            y = int8_conv(xq, w, w_scale, sx, bias, pad, dtype, **kw_)
            torch.cuda.synchronize()
            want = int8_conv_plain(xq.cpu(), w.cpu(), w_scale.cpu(), sx.cpu(),
                                   None if bias is None else bias.cpu(), pad, dtype, stride, dil,
                                   groups)
            assert y.shape == want.shape and y.is_contiguous(memory_format=CL)
            assert torch.equal(y.cpu(), want)
            assert int8_conv.route_launches["strided"] == before + groups
        y = int8_conv2d(x, w, w_scale, sx, None, pad, **kw_)
        assert torch.equal(y.cpu(), int8_conv_plain(
            xq.cpu(), w.cpu(), w_scale.cpu(), sx.cpu(), None, pad, x.dtype, stride, dil, groups))


@pytest.mark.parametrize("shape", [(64, 64, 160), (128, 128, 80), (64, 32, None)],
                         ids=["p3_0", "p4_0", "2x1 (2, 1)"])
def test_int8_strided_conv_is_one_launch_after_its_quantize(cuda, shape):
    """A strided int8 conv on the card is its quantize and one kernel launch:
    no memset, no workspace, no other kernel (torch.profiler's device
    records of int8_conv2d: the quantize kernel and the strided kernel,
    once each)."""
    from torch.profiler import ProfilerActivity, profile

    cin, cout, hw = shape
    k, stride, pad, size = ((3, 2, 1, (hw, hw)) if hw else ((2, 1), (2, 1), 0, (128, 256)))
    kh, kw = (k, k) if isinstance(k, int) else k
    g = torch.Generator().manual_seed(cin + cout)
    x = torch.randn(1, cin, *size, generator=g).to(cuda, torch.bfloat16).contiguous(
        memory_format=CL)
    w = torch.randint(-127, 128, (cout, cin, kh, kw), generator=g,
                      dtype=torch.int8).contiguous(memory_format=CL).to(cuda)
    ws = (torch.rand(cout, generator=g) * 1e-3).to(cuda)
    sx = torch.tensor(0.02, device=cuda)
    int8_conv2d(x, w, ws, sx, None, pad, stride=stride)  # the weights' map, the build
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        y = int8_conv2d(x, w, ws, sx, None, pad, stride=stride)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(names) == 2, names
    assert sum("int8_conv_strided_kernel" in n for n in names) == 1, names
    assert sum("quantize" in n for n in names) == 1, names
    assert not any("emset" in n for n in names), names
    assert torch.equal(y.cpu(), int8_conv_plain(int8_quantize_plain(x.cpu(), sx.cpu()), w.cpu(),
                                                ws.cpu(), sx.cpu(), None, pad, x.dtype, stride))


def test_exported_int8_autospeed_matches_eager(cuda, tmp_path):
    """int8 AutoSpeed "n" (min_channels 32: its five strided convs on the
    strided route) exported with export_stablehlo on the card: the loaded
    program equals the eager net bit for bit, and calls the strided operator
    as often as eager launches the route."""
    from autoware_vision_pilot_tpu_torch.export.quantize import quantize_for_int8_conv
    from autoware_vision_pilot_tpu_torch.export.stablehlo_export import (export_stablehlo,
                                                                         load_stablehlo)
    from autoware_vision_pilot_tpu_torch.models.auto_speed import AutoSpeedNetwork
    from autoware_vision_pilot_tpu_torch.nn.layers import init_seeded
    from autoware_vision_pilot_tpu_torch.ops.kernels import torch_ops

    net = init_seeded(AutoSpeedNetwork("n", 4, 640, 640), torch.Generator().manual_seed(3))
    net = net.to(cuda, torch.bfloat16).eval()
    quantize_for_int8_conv(net, 32)
    x = torch.rand(1, 3, 640, 640, generator=torch.Generator().manual_seed(4)).to(
        cuda, torch.bfloat16).contiguous(memory_format=CL)
    with torch.no_grad():
        before = int8_conv.route_launches["strided"]
        want = net(x)
        eager = int8_conv.route_launches["strided"] - before
    assert eager == 5
    path = export_stablehlo(net, (x,), tmp_path / "autospeed_int8.pt2")
    prog = load_stablehlo(path)
    calls = torch_ops.calls()["int8_conv_strided"]
    with torch.no_grad():
        got = prog(x)
        torch.cuda.synchronize()
    assert torch_ops.calls()["int8_conv_strided"] - calls == eager
    for a, b in zip(torch.utils._pytree.tree_leaves(got), torch.utils._pytree.tree_leaves(want)):
        assert torch.equal(a, b)


def int8_op_cases(cuda):
    """Each int8 operator's arguments on every route: the plan of a shape
    that takes it, the wrapper's own arguments -> {name: (args, the plain
    version)}."""
    from autoware_vision_pilot_tpu_torch.ops.kernels.int8_conv import (
        _reciprocal, _sm_count, geometry, int8_conv_transpose_plain, int8_conv_transpose_plan)

    g = torch.Generator().manual_seed(77)
    sms = _sm_count(cuda.index or 0)

    def conv_case(route, B, C, N, k, H, W, pad, stride=1, float_in=False):
        x = torch.randn(B, C, H, W, generator=g).contiguous(memory_format=CL).to(cuda)
        sx = torch.tensor(0.02, device=cuda)
        xq = int8_quantize(x, sx)
        w = torch.randint(-127, 128, (N, C, k, k), generator=g,
                          dtype=torch.int8).contiguous(memory_format=CL).to(cuda)
        ws = (torch.rand(N, generator=g) * 1e-3).to(cuda)
        bias = torch.randn(N, generator=g).to(cuda, torch.bfloat16)
        plan = int8_conv_plan(B, H, W, C, N, k, k, pad, sms, stride)
        assert plan.route == route
        m_tiles, n_tiles, splits = plan.grid
        geo = list(geometry(pad, stride))
        inp = x if float_in else xq
        if route in ("wgmma", "splitk"):
            args = (xq, w, ws, sx, bias, geo, [plan.th, plan.tw, m_tiles, n_tiles, splits,
                                               plan.per_split, plan.blocks], 1)
        elif route == "strided":
            phase_h, phase_w, gu = plan.phases
            args = (xq, w, ws, sx, bias, geo, [plan.th, plan.tw, plan.bn, m_tiles, n_tiles,
                                               splits, plan.per_split, plan.stages,
                                               int(phase_h), int(phase_w), gu], 1)
        elif route == "halo":
            args = (xq, w, ws, sx, bias, pad, [plan.th, plan.tw, plan.bn, m_tiles, n_tiles,
                                               plan.blocks, plan.stages, int(plan.resident)], 1)
        elif route == "pointwise":
            args = (inp, w, ws, sx, _reciprocal(sx) if float_in else None, bias,
                    [plan.bm, plan.bn, m_tiles, n_tiles, splits, plan.per_split * plan.bk], 1)
        else:
            args = (inp, w, ws, sx, _reciprocal(sx) if float_in else None, bias, splits, 1)
        want = int8_conv_plain(xq.cpu(), w.cpu(), ws.cpu(), sx.cpu(), bias.cpu(), pad,
                               torch.bfloat16, stride)
        return args, want

    cases = {
        "int8_conv_wgmma": conv_case("wgmma", 1, 256, 256, 3, 80, 160, 1),
        "int8_conv_splitk": conv_case("splitk", 1, 1456, 768, 3, 20, 40, 1),
        "int8_conv_strided": conv_case("strided", 1, 128, 128, 3, 160, 160, 1, 2),
        "int8_conv_halo": conv_case("halo", 1, 64, 96, 3, 20, 40, 1),
        "int8_conv_pointwise": conv_case("pointwise", 1, 672, 112, 1, 20, 40, 0, float_in=True),
        "int8_conv_dot": conv_case("dot", 1, 1152, 48, 1, 1, 1, 0, float_in=True),
    }
    x = torch.randn(1, 256, 20, 40, generator=g).contiguous(memory_format=CL).to(cuda)
    sx = torch.tensor(0.02, device=cuda)
    cases["int8_quantize"] = ((x, sx), int8_quantize_plain(x.cpu(), sx.cpu()))
    xq = int8_quantize(x, sx)
    wt = torch.randint(-127, 128, (2, 2, 128, 256), generator=g,
                       dtype=torch.int8).to(cuda).permute(3, 2, 0, 1)
    ws = (torch.rand(128, generator=g) * 1e-3).to(cuda)
    bias = torch.randn(128, generator=g).to(cuda, torch.bfloat16)
    plan = int8_conv_transpose_plan(1, 20, 40, 256, 128, 2, 2, sms)
    m_tiles, n_tiles, splits = plan.grid
    cases["int8_conv_d2s"] = (
        (xq, wt, ws, sx, bias, [plan.th, plan.tw, m_tiles, n_tiles, splits, plan.per_split,
                                plan.blocks], True, 1),
        int8_conv_transpose_plain(xq.cpu(), wt.cpu(), ws.cpu(), sx.cpu(), bias.cpu(),
                                  torch.bfloat16))
    return cases


@pytest.mark.parametrize("name", ["int8_quantize", "int8_conv_wgmma", "int8_conv_splitk",
                                  "int8_conv_strided", "int8_conv_halo", "int8_conv_pointwise",
                                  "int8_conv_dot", "int8_conv_d2s"])
def test_int8_avp_operator_matches_plain_version(cuda, name):
    """Each int8 dispatcher operator (csrc/torch_ops.cpp) on the route it
    names: torch.library.opcheck (schema, fake implementation and its
    channels_last strides, dispatch), its output bit-equal to the plain
    version, every call counted by the library's own counter."""
    from autoware_vision_pilot_tpu_torch.ops.kernels import torch_ops

    torch_ops.load()
    args, want = int8_op_cases(cuda)[name]
    op = getattr(torch.ops.avp, name).default
    before = torch_ops.calls()[name]
    torch.library.opcheck(op, args)
    got = op(*args)
    torch.cuda.synchronize()
    assert torch_ops.calls()[name] > before
    assert got.stride() == want.stride() or got.is_contiguous(memory_format=CL)
    assert torch.equal(got.cpu(), want)


def test_exported_int8_convs_match_eager(cuda, tmp_path):
    """export_stablehlo of Int8Conv2d modules on the card (a 3x3 wgmma
    conv, a strided conv, a 1x1 conv that quantizes as it loads, with
    static and dynamic scales): the graph calls the avp operators, and the
    loaded program's outputs equal the eager modules', each operator
    called once a call of the program."""
    from autoware_vision_pilot_tpu_torch.export.stablehlo_export import (export_stablehlo,
                                                                         load_stablehlo)
    from autoware_vision_pilot_tpu_torch.ops.kernels import torch_ops

    kw = dict(device=cuda, dtype=torch.bfloat16)

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.a = Int8Conv2d(128, 128, 3, 1, **kw)
            self.b = Int8Conv2d(128, 256, 3, 1, stride=2, **kw)
            self.c = Int8Conv2d(256, 96, 1, 0, **kw)

        def forward(self, x):
            return self.c(torch.relu(self.b(torch.relu(self.a(x)))))

    g = torch.Generator().manual_seed(5)
    net = Net().eval()
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, Int8Conv2d):
                m.weight.copy_(torch.randint(-127, 128, m.weight.shape, generator=g))
                m.weight_scale.copy_(torch.rand(m.weight_scale.shape, generator=g) * 1e-3)
                m.bias.copy_(torch.randn(m.bias.shape, generator=g))
    net.a.input_scale = torch.tensor(0.02, device=cuda)  # b and c quantize dynamically
    # 100 output tiles at 80x160: the wgmma route, no split
    x = torch.randn(1, 128, 80, 160, generator=g).to(cuda, torch.bfloat16).contiguous(
        memory_format=CL)
    path = export_stablehlo(net, (x,), tmp_path / "int8.pt2")
    nodes = {str(n.target) for n in torch.export.load(path).graph.nodes
             if n.op == "call_function"}
    assert {"avp.int8_quantize.default", "avp.int8_conv_wgmma.default",
            "avp.int8_conv_strided.default", "avp.int8_conv_pointwise.default"} <= nodes
    prog = load_stablehlo(path)
    before = torch_ops.calls()
    with torch.no_grad():
        got = prog(x)
        torch.cuda.synchronize()
        made = {k: torch_ops.calls()[k] - v for k, v in before.items()}
        assert torch.equal(got, net(x))
    assert made["int8_conv_wgmma"] == made["int8_conv_strided"] == 1
    assert made["int8_conv_pointwise"] == 1


@pytest.mark.parametrize("name", ["fused_preprocess", "fused_letterbox", "lane_filter_walk",
                                  "nms_greedy"])
def test_avp_operator_opcheck(cuda, name):
    """torch.library.opcheck of each dispatcher operator of the kernels
    (csrc/torch_ops.cpp): its schema, fake implementation and dispatch;
    every call counted by the library's own counter."""
    from autoware_vision_pilot_tpu_torch.ops.kernels import torch_ops

    torch_ops.load()
    args = avp_op_cases(cuda)[name]
    before = torch_ops.calls()[name]
    torch.library.opcheck(getattr(torch.ops.avp, name).default, args)
    torch.cuda.synchronize()
    assert torch_ops.calls()[name] > before


def test_exported_scene_seg_launches_fused_preprocess(cuda, tmp_path):
    """export_stablehlo of fused_preprocess -> SceneSeg (dryrun depth) on
    the card: the graph calls torch.ops.avp.fused_preprocess, and the
    loaded program launches the kernel and gives the eager module's
    logits."""
    from autoware_vision_pilot_tpu_torch.export.stablehlo_export import (export_stablehlo,
                                                                         load_stablehlo)
    from autoware_vision_pilot_tpu_torch.models.scene_seg import SceneSegNetwork
    from autoware_vision_pilot_tpu_torch.nn.layers import init_seeded
    from autoware_vision_pilot_tpu_torch.ops.kernels import torch_ops

    class SegFromFrame(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.seg = init_seeded(SceneSegNetwork((10, 20), B0_DRYRUN_STAGES),
                                   torch.Generator().manual_seed(0))

        def forward(self, frame_u8):
            return self.seg(fused_preprocess(frame_u8, (320, 640), torch.float32))

    model = SegFromFrame().to(cuda).eval()
    frame = frames((720, 1280), 1, 43)[0].to(cuda)
    path = export_stablehlo(model, (frame,), tmp_path / "seg.pt2")
    nodes = [n.target for n in torch.export.load(path).graph.nodes if n.op == "call_function"]
    assert torch.ops.avp.fused_preprocess.default in nodes
    prog = load_stablehlo(path)
    before, launches = torch_ops.calls()["fused_preprocess"], fused_preprocess.launches
    with torch.no_grad():
        got = prog(frame)
        torch.cuda.synchronize()
        assert torch_ops.calls()["fused_preprocess"] == before + 1
        assert fused_preprocess.launches == launches  # the program calls the operator itself
        assert torch.equal(got, model(frame))


# ---------------------------------------------------------------- the accuracy tools

def test_detection_chain_overfits_to_perfect_map(cuda):
    """The port of tests/test_detection_trainer.py::
    test_detection_chain_overfits_to_perfect_map: 4 synthetic boxed scenes
    at 128x256, 120 steps of DetectionTrainer on the card (the ramped EMA
    in step), then the deployment decode on the live weights with batch
    statistics (every BatchNorm in train mode, the head in eval mode) and
    the NMS kernel, one launch for the 4 scenes: mAP@50 = 1.0."""
    from autoware_vision_pilot_tpu_torch.models.auto_speed import AutoSpeedNetwork
    from autoware_vision_pilot_tpu_torch.nn.layers import BatchNorm2d
    from autoware_vision_pilot_tpu_torch.tools.e2e_autospeed_demo import make_boxed_scene
    from autoware_vision_pilot_tpu_torch.train.detection_trainer import (
        DetectionTrainer, DetectionTrainerConfig)
    from autoware_vision_pilot_tpu_torch.train.metrics import detection_map
    from autoware_vision_pilot_tpu_torch.train.train_step import to_device_images
    from autoware_vision_pilot_tpu_torch.train.yolo_data import pad_targets

    hw = (128, 256)
    cfg = DetectionTrainerConfig(num_classes=4, input_hw=hw, max_boxes=8, lr=2e-3,
                                 warmup_steps=10, max_steps=120, ema_decay=0.999)
    trainer = DetectionTrainer(AutoSpeedNetwork("n", 4, *hw), cfg, seed=0, device=cuda)
    rng = np.random.default_rng(0)
    scenes = [make_boxed_scene(rng, hw) for _ in range(4)]
    imgs = np.stack([s[0] for s in scenes])
    bs, ls, ms = (np.stack(t) for t in zip(*[pad_targets(s[1], s[2], hw, 8) for s in scenes]))
    for _ in range(120):
        loss = trainer.fit_step(imgs, bs, ls, ms)
    assert math.isfinite(float(loss))

    model = trainer.model.eval()
    for m in model.modules():
        if isinstance(m, BatchNorm2d):
            m.train()
    with torch.no_grad():
        out = model(to_device_images(imgs, cuda))
    model.eval()
    xywh, scores = out[..., :4], out[..., 4:]
    boxes = torch.cat([xywh[..., :2] - xywh[..., 2:] / 2, xywh[..., :2] + xywh[..., 2:] / 2], -1)
    nms_greedy.launches = 0
    bb, ss, cc, vv = (t.cpu().numpy() for t in nms_kernel.nms_fixed(
        boxes.contiguous(), scores.amax(-1).contiguous(),
        scores.argmax(-1).to(torch.int32).contiguous(), max_det=50, iou_thresh=0.65,
        conf_thresh=0.1))
    assert nms_greedy.launches == 1
    preds = [(bb[b][vv[b]], ss[b][vv[b]], cc[b][vv[b]]) for b in range(4)]
    m50, _ = detection_map(preds, [(s[1], s[2]) for s in scenes], 4)
    assert m50 == 1.0, m50


def test_int8_1x1_per_channel_scale_under_inference_mode(cuda):
    """A 1x1 int8 conv with a per-channel scale on 40 channels (padded to
    48 inside, the padded scale then an inference tensor) called under
    torch.inference_mode on the card, as qat_closure's int8 program calls
    it: bit-equal to its plain version."""
    g = torch.Generator(device="cpu").manual_seed(41)
    x = torch.randn(16, 40, 8, 16, generator=g).to(cuda, torch.bfloat16).contiguous(
        memory_format=CL)
    w = torch.randint(-127, 128, (24, 40, 1, 1), generator=g, dtype=torch.int8).to(
        cuda).contiguous(memory_format=CL)
    ws = (torch.rand(24, generator=g) * 0.01 + 1e-3).to(cuda)
    sx = (torch.rand(40, generator=g) * 0.05 + 0.01).to(cuda)
    bias = torch.randn(24, generator=g).to(cuda, torch.bfloat16)
    with torch.inference_mode():
        got = int8_conv2d(x, w, ws, sx, bias)
    ref = int8_conv2d(x, w, ws, sx, bias, plain=True)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


def test_qat_closure_runs_every_int8_conv_on_its_route(cuda, monkeypatch, tmp_path):
    """tools/qat_closure.py's run on the card at dryrun depth (64x128,
    min_channels 32, per-channel scales): the int8 program's convs launch
    the routes int8_conv_plan names for their inputs (counted through a
    global forward hook, against int8_conv.route_launches), and no plain
    version runs."""
    from autoware_vision_pilot_tpu_torch.models.scene_seg import SceneSegNetwork
    from autoware_vision_pilot_tpu_torch.ops.kernels import int8_conv as ic
    from autoware_vision_pilot_tpu_torch.tools import qat_closure

    def boom(*args, **kwargs):
        raise AssertionError("a plain version ran on the card")

    monkeypatch.setattr(ic, "int8_conv_plain", boom)
    monkeypatch.setattr(ic, "int8_quantize_plain", boom)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    want = dict.fromkeys(ic.ROUTES + ("quantize",), 0)

    def hook(m, args, y):
        if isinstance(m, Int8Conv2d):
            assert m.input_scale is not None and m.input_scale.dim() == 1
            for k, n in ic.int8_conv2d_launches(tuple(args[0].shape), tuple(m.weight.shape),
                                                m.padding, m.stride, m.dilation, m.groups,
                                                sms).items():
                want[k] += n

    ic.int8_conv.route_launches = dict.fromkeys(ic.ROUTES, 0)
    ic.int8_quantize.launches = 0
    handle = torch.nn.modules.module.register_module_forward_hook(hook)
    try:
        result = qat_closure.run(2, 4, None, 0.0, 5e-5, 32, True, 2, str(tmp_path), "cuda",
                                 make_model=lambda: SceneSegNetwork((2, 4), B0_DRYRUN_STAGES),
                                 hw=(64, 128))
    finally:
        handle.remove()
    torch.cuda.synchronize()
    got = {**ic.int8_conv.route_launches, "quantize": ic.int8_quantize.launches}
    assert got == want and sum(want[r] for r in ic.ROUTES) == 30, (got, want)
    assert sum(1 for r in ic.ROUTES if want[r]) >= 3  # several routes on one net
    assert result["n_quantized_convs"] > 0 and result["argmax_agreement_int8_vs_bf16"] > 0.5
