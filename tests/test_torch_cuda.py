"""Tests of the port that need an NVIDIA GPU: the fused-preprocess (both
modes), int8, lane-filter and NMS CUDA kernels against their plain PyTorch
versions, one stream and a batch of them, the main path, bf16 and int8, the
lateral and longitudinal steps on the card against the CPU, and the fleet
and the engines on the card. They skip where there is no CUDA device.

This file imports no JAX, so it also runs on a machine that has none:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import copy

import numpy as np
import pytest
import torch

from autoware_vision_pilot_tpu_torch.models.efficientnet import B0_DRYRUN_STAGES
from autoware_vision_pilot_tpu_torch.nn.layers import Int8Conv2d
from autoware_vision_pilot_tpu_torch.ops.kernels.int8_conv import (
    _launch, _mma_plan, int8_conv, int8_conv2d, int8_conv_plain, int8_conv_plan, int8_quantize,
    int8_quantize_plain, padded_channels)
from autoware_vision_pilot_tpu_torch.ops.kernels import (lane_filter_kernel, nms_kernel,
                                                        preprocess_kernel)
from autoware_vision_pilot_tpu_torch.ops.kernels.lane_filter_kernel import lane_filter_walk
from autoware_vision_pilot_tpu_torch.ops.kernels.nms_kernel import nms_greedy
from autoware_vision_pilot_tpu_torch.ops.kernels.preprocess_kernel import (fused_letterbox,
                                                                           fused_preprocess)
from autoware_vision_pilot_tpu_torch.ops.postprocess import nms_greedy_plain, nms_topk
from autoware_vision_pilot_tpu_torch.ops.preprocess import letterbox, preprocess_imagenet
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
    ("mma", 3, 64, 96, (20, 40), 1),        # a 3x3 window with C < 128
    ("mma", 1, 1152, 48, (1, 1), 1),        # an SE squeeze (M = 1) on PR 2's kernel
])
def test_int8_conv_routes_match_plain_version(cuda, route, k, cin, cout, hw, batch):
    """Each route of int8_conv_plan against the plain version: int32
    accumulators and f32/bf16 outputs bit-equal, scalar and
    per-input-channel scales. A shape whose own plan splits K also runs
    on the wgmma route through a one-split plan, and a 1x1 conv on the
    mma.sync route through its mma plan."""
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
    if route == "mma" and k == 1:
        plan = _mma_plan(batch * hw[0] * hw[1], cout, cin, sm_count())
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
    """The weights' TMA map is encoded at the first wgmma launch, kept on
    the weight, and encoded again for a copy at another address."""
    g = torch.Generator().manual_seed(9)
    w = torch.randint(-127, 128, (256, 256, 3, 3), generator=g,
                      dtype=torch.int8).contiguous(memory_format=CL).to(cuda)
    w_scale = torch.full((256,), 1e-3, device=cuda)
    sx = torch.tensor(0.02, device=cuda)
    xq = torch.randint(-127, 128, (1, 256, 40, 80), generator=g,
                       dtype=torch.int8).contiguous(memory_format=CL).to(cuda)
    y = int8_conv(xq, w, w_scale, sx, None, 1, torch.int32)
    key, first = w._tma_map
    assert key[0] == w.data_ptr() and len(first) == 128
    assert torch.equal(int8_conv(xq, w, w_scale, sx, None, 1, torch.int32), y)
    assert w._tma_map[1] is first
    w2 = copy.deepcopy(w)
    assert torch.equal(int8_conv(xq, w2, w_scale, sx, None, 1, torch.int32), y)
    assert w2._tma_map[0][0] == w2.data_ptr() != w.data_ptr()


def test_int8_wrappers_raise_on_the_card(cuda):
    x = torch.randn(1, 32, 4, 5, device=cuda).contiguous(memory_format=CL)
    s = torch.tensor(0.02, device=cuda)
    w = torch.zeros(8, 32, 3, 3, dtype=torch.int8, device=cuda).contiguous(memory_format=CL)
    w_scale = torch.ones(8, device=cuda)
    xq = int8_quantize(x, s)
    with pytest.raises(ValueError, match="groups"):
        int8_conv(xq, w, w_scale, s, None, 1, groups=2)
    with pytest.raises(ValueError, match="stride"):
        int8_conv(xq, w, w_scale, s, None, 1, stride=2)
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


@pytest.mark.parametrize("k", [1, 31, 32, 33, 255, 256, 257, 1024])
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
    with pytest.raises(ValueError):  # k = 1200 > 1024
        nms_greedy(boxes[:1200], scores[:1200], cls[:1200], max_det=300)
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
@pytest.mark.parametrize("k", [33, 256, 1024])
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
