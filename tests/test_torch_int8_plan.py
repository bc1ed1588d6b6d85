"""The int8 conv's dispatch plan (ops/kernels/int8_conv.py::int8_conv_plan)
and the K decomposition its wgmma routes run, on the CPU.

The kernels run only on the card; what surrounds them is plain Python and is
held here: every main-path conv gets a route whose tiles cover M and N,
the K steps (tap r, tap s, 128-channel chunk) cover every (r, s, c) once
(the 1x1 routes' K ranges: tests/test_torch_int8_pointwise.py),
a torch replay of split-K over those steps sums to the plain version's
int32 accumulators exactly in any order of arrival, shapes that no
route takes raise, and the weights' TMA map is kept on the weight. Integer
sums, so every comparison is exact.
"""
import copy
import ctypes
import itertools
import math

import pytest
import torch
import torch.nn.functional as F

from autoware_vision_pilot_tpu_torch.ops.kernels import int8_conv as int8_mod
from autoware_vision_pilot_tpu_torch.ops.kernels.int8_conv import (
    DOT_MAX_M, DOT_WARPS, MAX_CLUSTER, MAX_K, PW_BN, ROUTES, SMS, TILE, int8_conv_plain,
    int8_conv_plan)

CL = torch.channels_last
# (window, cin, cout, h, w, convs per frame): the 24 distinct int8 convs of
# the selective-int8 main path at 320x640 (72 convs, 669.7 GOP)
MAIN_INT8 = (
    (3, 512, 512, 80, 160, 3), (3, 256, 256, 160, 320, 2), (3, 512, 256, 80, 160, 3),
    (3, 256, 128, 160, 320, 2), (3, 768, 512, 40, 80, 3), (3, 1456, 768, 20, 40, 1),
    (3, 512, 512, 40, 80, 3), (3, 256, 256, 80, 160, 1), (3, 1280, 768, 20, 40, 2),
    (3, 768, 768, 20, 40, 3), (3, 256, 128, 80, 160, 1), (3, 512, 1456, 10, 20, 1),
    (3, 512, 1280, 10, 20, 2), (3, 256, 512, 10, 20, 3), (1, 320, 1280, 10, 20, 2),
    (1, 1152, 320, 10, 20, 2), (1, 672, 112, 20, 40, 4), (1, 1152, 192, 10, 20, 6),
    (1, 480, 112, 20, 40, 2), (1, 480, 80, 20, 40, 4), (1, 672, 192, 10, 20, 2),
    (1, 1152, 48, 1, 1, 8), (1, 672, 28, 1, 1, 6), (1, 480, 20, 1, 1, 6),
)


def k_steps(KH, KW, C, bk=TILE):
    """The wgmma routes' K steps in the kernel's order
    (csrc/int8_conv_sm90.cu, the producer's loop): step i is tap
    (r, s) = divmod(i // nc, KW) and channels c0 = (i % nc) * bk .. c0 + bk,
    nc = ceil(C / bk); channels from C on read as zeros."""
    nc = math.ceil(C / bk)
    return [(*divmod(i // nc, KW), (i % nc) * bk) for i in range(KH * KW * nc)]


def test_main_path_table():
    assert sum(n for *_, n in MAIN_INT8) == 72
    gop = sum(2 * h * w * cin * cout * k * k * n for k, cin, cout, h, w, n in MAIN_INT8)
    assert round(gop / 1e9, 1) == 669.7


@pytest.mark.parametrize("k,cin,cout,h,w,per_frame", MAIN_INT8,
                         ids=[f"{k}x{k}-{ci}-{co}-{h}x{w}" for k, ci, co, h, w, _ in MAIN_INT8])
def test_plan_covers_main_path_shape(k, cin, cout, h, w, per_frame):
    plan = int8_conv_plan(1, h, w, cin, cout, k, k, k // 2)
    M, K = h * w, k * k * cin
    expected = ("dot" if k == 1 and M <= DOT_MAX_M else "pointwise" if k == 1
                else "wgmma" if h * w >= 40 * 80 else "splitk")
    assert plan.route == expected
    m_tiles, n_tiles, splits = plan.grid
    if plan.route == "dot":  # one warp an output channel, each over all M rows
        assert plan.bm == M == 1 and plan.bn == DOT_WARPS and m_tiles == splits == 1
        assert n_tiles * DOT_WARPS >= cout > (n_tiles - 1) * DOT_WARPS
        assert plan.blocks == n_tiles
        return
    if plan.route == "pointwise":  # flat rows, 64 channels, K over a cluster
        assert plan.bm in (64, 32) and plan.bn == PW_BN
        assert m_tiles * plan.bm >= M > (m_tiles - 1) * plan.bm
        assert n_tiles * plan.bn >= cout > (n_tiles - 1) * plan.bn
        assert 1 <= splits <= MAX_CLUSTER and plan.iters * plan.bk >= K
        assert splits * plan.per_split >= plan.iters > (splits - 1) * plan.per_split
        # the clusters fill at least 90 % of the SMs, at most one wave over
        assert 0.9 * SMS <= plan.blocks == m_tiles * n_tiles * splits <= SMS + 8
        return
    # M: rectangles of th x tw output pixels that tile the h x w map
    assert plan.th * plan.tw <= plan.bm == TILE
    tiles_h, tiles_w = math.ceil(h / plan.th), math.ceil(w / plan.tw)
    assert m_tiles == tiles_h * tiles_w and tiles_h * plan.th >= h and tiles_w * plan.tw >= w
    covered = torch.zeros(h, w, dtype=torch.int32)
    for i in range(tiles_h):
        for j in range(tiles_w):
            covered[i * plan.th:(i + 1) * plan.th, j * plan.tw:(j + 1) * plan.tw] += 1
    assert bool((covered == 1).all())
    assert n_tiles * plan.bn >= cout > (n_tiles - 1) * plan.bn
    # K: every split takes a contiguous, non-empty range of the steps
    assert plan.iters == len(k_steps(k, k, cin)) == k * k * math.ceil(cin / TILE)
    assert splits * plan.per_split >= plan.iters > (splits - 1) * plan.per_split
    if plan.route == "wgmma":
        assert splits == 1 and 2 * m_tiles * n_tiles > SMS
    else:  # split-K fills the SMs that the thin conv's tiles leave idle
        assert splits >= 2 and m_tiles * n_tiles * splits <= SMS
        assert plan.per_split >= 4
    # persistent blocks, at most one per SM: block b takes units b, b + blocks, ...
    units = m_tiles * n_tiles * splits
    assert plan.blocks == min(units, SMS)
    taken = sorted(u for b in range(plan.blocks) for u in range(b, units, plan.blocks))
    assert taken == list(range(units))


@pytest.mark.parametrize("cin", [1456, 320, 672, 480])
@pytest.mark.parametrize("window", [3, 1])
def test_k_steps_cover_every_tap_and_channel_once(cin, window):
    nc = math.ceil(cin / TILE)
    steps = k_steps(window, window, cin)
    assert len(steps) == window * window * nc
    seen = torch.zeros(window, window, nc * TILE, dtype=torch.int32)
    for r, s, c0 in steps:
        assert c0 % TILE == 0
        seen[r, s, c0:c0 + TILE] += 1
    assert bool((seen == 1).all())  # every (r, s, c) once, the tail included
    tail = nc * TILE - cin          # channels that read as zeros, per tap
    assert tail == {1456: 80, 320: 64, 672: 96, 480: 32}[cin]
    # the kernel's order: channel chunks fastest, then s, then r
    assert steps[:nc] == [(0, 0, c * TILE) for c in range(nc)]


def splitk_replay(xq, w, pad, per_split, bk=TILE):
    """The split-K route in int64 torch on the CPU: split z sums the K steps
    [z * per_split, (z + 1) * per_split) of k_steps() over zero-padded
    pixels and a zero channel tail. -> the splits' partial sums."""
    B, C, H, W = xq.shape
    N, _, KH, KW = w.shape
    nc = math.ceil(C / bk)
    x = F.pad(xq.long(), (pad, pad, pad, pad, 0, nc * bk - C))
    wl = F.pad(w.long(), (0, 0, 0, 0, 0, nc * bk - C))
    OH, OW = H + 2 * pad - KH + 1, W + 2 * pad - KW + 1
    steps = k_steps(KH, KW, C, bk)
    partials = []
    for z in range(math.ceil(len(steps) / per_split)):
        acc = torch.zeros(B, N, OH, OW, dtype=torch.int64)
        for r, s, c0 in steps[z * per_split:(z + 1) * per_split]:
            patch = x[:, c0:c0 + bk, r:r + OH, s:s + OW]
            acc += torch.einsum("bchw,nc->bnhw", patch, wl[:, c0:c0 + bk, r, s])
        partials.append(acc)
    return partials


@pytest.mark.parametrize("per_split", [3, None])
def test_splitk_replay_matches_plain_accumulators(per_split):
    """3 splits of the 9 K steps, or one (the wgmma route's single split).
    Whichever split arrives last adds the others' slices to its own
    accumulators, in any order: every order gives the plain version's
    sums."""
    g = torch.Generator().manual_seed(48)
    B, C, N, H, W = 2, 48, 40, 7, 9
    xq = torch.randint(-127, 128, (B, C, H, W), generator=g,
                       dtype=torch.int8).contiguous(memory_format=CL)
    w = torch.randint(-127, 128, (N, C, 3, 3), generator=g,
                      dtype=torch.int8).contiguous(memory_format=CL)
    iters = len(k_steps(3, 3, C))
    partials = splitk_replay(xq, w, 1, per_split or iters)
    assert len(partials) == (3 if per_split else 1)
    want = int8_conv_plain(xq, w, torch.ones(N), torch.tensor(1.0), None, 1, torch.int32)
    for order in itertools.permutations(range(len(partials))):
        total = torch.zeros_like(partials[0])
        for z in order:
            total += partials[z]
        assert torch.equal(total.to(torch.int32), want)


@pytest.mark.parametrize("shape,match", [
    ((1, 8, 8, 20, 32, 3, 3, 1), "multiples of 16"),
    ((1, 2, 2, 64, 32, 5, 5, 0), "larger than"),
    ((1, 8, 8, 14800, 32, 3, 3, 1), "overflow"),
    ((1, 8, 8, 0, 32, 3, 3, 1), "no int8 conv"),
    ((1, 8, 8, 64, 32, 3, 3, -1), "no int8 conv"),
    ((1, 8, 8, 128, 65536 * TILE, 3, 3, 1), "grid holds"),
    ((2 ** 16, 256, 256, 16, 32, 1, 1, 0), "int32 indexes"),
    ((1, 10, 20, 64, 65536 * PW_BN, 1, 1, 0), "grid holds"),
])
def test_plan_rejects_shapes_no_route_takes(shape, match):
    with pytest.raises(ValueError, match=match):
        int8_conv_plan(*shape)
    assert 14800 * 9 > MAX_K >= 1456 * 9


@pytest.mark.parametrize("route,shape", [
    ("wgmma", (1, 80, 160, 512, 512, 3, 3, 1)),   # decode_layer_4: 400 tiles
    ("splitk", (1, 20, 40, 1456, 768, 3, 3, 1)),  # decode_layer_0: 42 tiles
    ("mma", (1, 20, 40, 64, 96, 3, 3, 1)),        # a 3x3 window with C < 128
    ("pointwise", (1, 20, 40, 672, 112, 1, 1, 0)),  # a stage-5 MBConv project
    ("dot", (1, 1, 1, 1152, 48, 1, 1, 0)),         # an SE squeeze, M = 1
], ids=ROUTES)
def test_every_route_is_taken_by_a_natural_shape(route, shape):
    plan = int8_conv_plan(*shape)
    assert plan.route == route
    assert (plan.splits > 1) == (route in ("splitk", "pointwise"))


class FakeLib:
    """avp_int8_weight_map's stand-in: writes the address into the map."""

    def __init__(self):
        self.encoded = []

    def avp_int8_weight_map(self, ptr, N, KH, KW, C, out):
        self.encoded.append(ptr)
        ctypes.memmove(out, ptr.to_bytes(8, "little"), 8)
        return 0


def test_weight_map_is_kept_on_the_weight():
    """Encoded once per weight and reused; a copy of the weight (another
    address) gets its own map, and a map follows the weight, not a global
    table."""
    lib = FakeLib()
    w = torch.zeros(24, 32, 3, 3, dtype=torch.int8).contiguous(memory_format=CL)
    first = int8_mod._weight_map(lib, w, 24, 3, 3, 32)
    assert int8_mod._weight_map(lib, w, 24, 3, 3, 32) == first
    assert len(first) == 128 and lib.encoded == [w.data_ptr()]
    w2 = copy.deepcopy(w)
    assert int8_mod._weight_map(lib, w2, 24, 3, 3, 32) != first
    assert lib.encoded == [w.data_ptr(), w2.data_ptr()]
    assert int8_mod._weight_map(lib, w, 24, 3, 3, 32) == first  # w's own map stayed
    assert len(lib.encoded) == 2


# (window, cin, cout, h, w, convs): the int8 conv shapes that
# precision="int8" at int8_min_channels=128 adds to MAIN_INT8's, counted over
# the four int8 wrappers (SceneSeg, Scene3D, DomainSeg, EgoLanes) at 320x640:
# the heads' 3x3 128-input convs (N = 1, 3 and 64 on 128-wide tiles, and the
# full-resolution 128 -> 128), ContextBlock.context_layer_4, and B0's 1x1
# convs and SE squeezes with 144 to 240 input channels (C % 32 == 16 on
# 144 and 240: a K range that ends on half a 32-channel mma step)
MIN128_INT8 = (
    (3, 128, 1, 320, 640, 1), (3, 128, 3, 80, 160, 1), (3, 128, 64, 320, 640, 2),
    (3, 128, 128, 320, 640, 4), (3, 128, 256, 10, 20, 4), (1, 144, 24, 80, 160, 4),
    (1, 144, 40, 40, 80, 4), (1, 240, 40, 40, 80, 4), (1, 240, 80, 20, 40, 4),
    (1, 192, 1152, 10, 20, 16), (1, 144, 6, 1, 1, 8), (1, 240, 10, 1, 1, 8),
)
MIN128_ROUTE = {(3, 128, 256, 10, 20): "splitk"}


def test_min128_table():
    assert not {s[:5] for s in MIN128_INT8} & {s[:5] for s in MAIN_INT8}
    assert sum(n for *_, n in MIN128_INT8) == 60


@pytest.mark.parametrize("k,cin,cout,h,w,convs", MIN128_INT8,
                         ids=[f"{k}x{k}-{ci}-{co}-{h}x{w}" for k, ci, co, h, w, _ in MIN128_INT8])
def test_plan_covers_min128_shape(k, cin, cout, h, w, convs):
    """Each shape gets a route whose tiles cover the M pixels and N output
    channels once, and whose K steps (3x3) or K ranges (1x1) cover every
    tap and channel once."""
    plan = int8_conv_plan(1, h, w, cin, cout, k, k, k // 2)
    M = h * w
    expected = ("dot" if k == 1 and M <= DOT_MAX_M else "pointwise" if k == 1
                else MIN128_ROUTE.get((k, cin, cout, h, w), "wgmma"))
    assert plan.route == expected
    m_tiles, n_tiles, splits = plan.grid
    if plan.route == "dot":
        assert plan.bm == M and n_tiles * DOT_WARPS >= cout > (n_tiles - 1) * DOT_WARPS
        return
    if plan.route == "pointwise":
        assert m_tiles * plan.bm >= M > (m_tiles - 1) * plan.bm
        assert n_tiles * PW_BN >= cout > (n_tiles - 1) * PW_BN
        seen = torch.zeros(cin, dtype=torch.int32)
        step = plan.per_split * plan.bk
        for z in range(splits):
            lo, hi = z * step, min(cin, (z + 1) * step)
            assert lo < hi and lo % plan.bk == 0
            seen[lo:hi] += 1
        assert bool((seen == 1).all())
        assert plan.blocks == m_tiles * n_tiles * splits
        return
    # N < 128 falls on one 128-wide N tile, whose columns from N on are masked
    assert n_tiles * TILE >= cout > (n_tiles - 1) * TILE
    assert plan.th * plan.tw <= TILE
    tiles_h, tiles_w = math.ceil(h / plan.th), math.ceil(w / plan.tw)
    assert m_tiles == tiles_h * tiles_w
    covered = torch.zeros(h, w, dtype=torch.int32)
    for i in range(tiles_h):
        for j in range(tiles_w):
            covered[i * plan.th:(i + 1) * plan.th, j * plan.tw:(j + 1) * plan.tw] += 1
    assert bool((covered == 1).all())
    assert plan.iters == len(k_steps(k, k, cin)) == 9
    assert splits * plan.per_split >= plan.iters > (splits - 1) * plan.per_split
    units = m_tiles * n_tiles * splits
    assert plan.blocks == min(units, SMS)
    taken = sorted(u for b in range(plan.blocks) for u in range(b, units, plan.blocks))
    assert taken == list(range(units))


@pytest.mark.parametrize("cout", [1, 3, 64])
@pytest.mark.parametrize("per_split", [9, 4])
def test_k_steps_at_small_n(cout, per_split):
    """The heads' 3x3 128 -> N convs at N = 1, 3 and 64: the K steps cover
    every (tap, channel) once, and a replay of them in one split (the
    wgmma route the heads take) or in splits of 4 steps gives the plain
    version's int32 accumulators at every N, the columns past N never
    written."""
    steps = k_steps(3, 3, 128)
    seen = torch.zeros(3, 3, 128, dtype=torch.int32)
    for r, s, c0 in steps:
        seen[r, s, c0:c0 + TILE] += 1
    assert len(steps) == 9 and bool((seen == 1).all())
    g = torch.Generator().manual_seed(cout + per_split)
    xq = torch.randint(-127, 128, (1, 128, 6, 10), generator=g,
                       dtype=torch.int8).contiguous(memory_format=CL)
    w = torch.randint(-127, 128, (cout, 128, 3, 3), generator=g,
                      dtype=torch.int8).contiguous(memory_format=CL)
    partials = splitk_replay(xq, w, 1, per_split)
    assert len(partials) == math.ceil(9 / per_split)
    want = int8_conv_plain(xq, w, torch.ones(cout), torch.tensor(1.0), None, 1, torch.int32)
    assert torch.equal(sum(partials).to(torch.int32), want)
    assert int8_conv_plan(1, 320, 640, 128, cout, 3, 3, 1).grid[1] == 1
