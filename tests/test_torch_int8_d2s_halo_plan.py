"""The plans of the int8 transposed conv on the wgmma kernel ("d2s") and of
the small-channel window conv ("halo"), ops/kernels/int8_conv.py, and
pure-Python models of how their kernels address memory, on the CPU.

The kernels (csrc/int8_conv_sm90.cu's d2s variant, csrc/int8_conv_halo.cu)
run only on the card; what they compute from the plan is held here:
- d2s: the rectangles cover each image's rows whole, the N tiles cover
  every (segment, o) once, the K splits cover C, shared memory fits, the
  5-D output map's boxes and strides are what TMA takes, and a model of
  the tiles stored through that map gives int8_conv_transpose_plain's
  layout, every output written once;
- halo: the rectangles cover the output once, the N tiles are the
  narrowest wgmma shape, the halo box is what TMA takes, shared memory
  fits, a model of the wgmmas' reads from each tile's halo (the
  accumulator rows are halo positions, a tap's A the same rows shifted;
  TMA's zero fill as the padding) gives int8_conv_plain's accumulators
  inside each slab, and a model of the staged epilogue's 16-byte windows
  writes every output byte once.
Integer sums, so every comparison is exact.
"""
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from autoware_vision_pilot_tpu_torch.ops.kernels import int8_conv as k

from test_torch_train_step import one_thread  # noqa: F401 (an autouse fixture)

CL = torch.channels_last
SMS = 132
ELEM = {torch.float32: 4, torch.bfloat16: 2, torch.int32: 4}

# (C, O, kh, h, w, B): chip_smoke.py's five main-path transposes and its
# other shapes, the card tests' shapes, and a K split (one tile, C = 1456)
TRANSPOSES = [(1280, 1280, 2, 10, 20, 1), (1456, 1456, 2, 10, 20, 1), (768, 768, 2, 20, 40, 1),
              (512, 512, 2, 40, 80, 1), (256, 256, 2, 80, 160, 1), (64, 3, 2, 5, 7, 1),
              (48, 12, 3, 6, 9, 2), (208, 20, 2, 13, 7, 1), (1456, 1456, 2, 10, 20, 2),
              (256, 256, 2, 20, 40, 1), (512, 512, 2, 8, 10, 2), (48, 64, 2, 3, 5, 1),
              (1456, 64, 2, 4, 4, 1)]


def d2s_smem(out_dtype):
    """csrc/int8_conv_sm90.cu's shared memory of the d2s variant: as many
    32 KB stages (up to 6) as fit beside the 128x128 staging tile and the
    table of 2048 columns' factors."""
    limit, staging = k.SMEM_LIMIT - 256, 128 * 128 * ELEM[out_dtype] + 2048 * 8
    stages = min(6, (limit - 1024 - 96 - staging) // 32768)
    return stages, stages * 32768 + staging + 2 * stages * 8 + 1024


@pytest.mark.parametrize("C,O,kh,h,w,B", TRANSPOSES,
                         ids=[f"{c}-{o}-k{kh}-{h}x{w}-b{b}" for c, o, kh, h, w, b in TRANSPOSES])
def test_d2s_plan_covers_the_product(C, O, kh, h, w, B):
    plan = k.int8_conv_transpose_plan(B, h, w, C, O, kh, kh, SMS)
    m_tiles, n_tiles, splits = plan.grid
    assert plan.route == "d2s" and plan.bm == plan.bn == plan.bk == k.TILE
    # M: rectangles of whole rows of one image (th divides h), cover once
    assert h % plan.th == 0 and plan.th * plan.tw <= k.TILE
    assert plan.th <= 256 and plan.tw <= 256 and plan.tw <= w
    tiles_w = math.ceil(w / plan.tw)
    assert m_tiles == B * (h // plan.th) * tiles_w
    covered = np.zeros((h, tiles_w * plan.tw), np.int32)
    for i in range(h // plan.th):
        for j in range(tiles_w):
            covered[i * plan.th:(i + 1) * plan.th, j * plan.tw:(j + 1) * plan.tw] += 1
    assert (covered[:, :w] == 1).all()
    # N: tiles (seg, o0) of 128 inside one of the kh kw segments, every o once
    o_tiles = math.ceil(O / k.TILE)
    assert n_tiles == kh * kh * o_tiles
    seen = np.zeros((kh * kh, o_tiles * k.TILE), np.int32)
    for n in range(n_tiles):
        seg, o0 = divmod(n, o_tiles)
        seen[seg, o0 * k.TILE:(o0 + 1) * k.TILE] += 1
    assert (seen == 1).all()
    # K: contiguous splits of the 128-channel steps, at least 4 steps each
    assert plan.iters == math.ceil(C / k.TILE)
    assert (splits - 1) * plan.per_split < plan.iters <= splits * plan.per_split
    assert splits == 1 or (plan.per_split >= 4 and 2 * m_tiles * n_tiles <= SMS)
    assert plan.blocks == min(m_tiles * n_tiles * splits, SMS)
    for dtype in ELEM:
        stages, smem = d2s_smem(dtype)
        assert stages >= 4 and smem <= k.SMEM_LIMIT
        if not k.d2s_tma_store(O, dtype):
            continue
        # the output map (O, kw, w, kh, B h): byte strides multiples of 16,
        # boxes (128 bytes of o, 1, tw, 1, th), each box dim <= 256
        e = ELEM[dtype]
        strides = [O * e, kh * O * e, w * kh * O * e, kh * w * kh * O * e]
        assert all(s % 16 == 0 for s in strides)
        box = (128 // e, 1, plan.tw, 1, plan.th)
        assert box[0] * e == 128 and max(box) <= 256 and O * e >= 128


@pytest.mark.parametrize("O,dtype,store", [
    (3, torch.bfloat16, False), (12, torch.bfloat16, False), (20, torch.bfloat16, False),
    (20, torch.float32, False), (12, torch.int32, False), (64, torch.bfloat16, True),
    (1456, torch.bfloat16, True), (1456, torch.float32, True), (36, torch.float32, True),
    (60, torch.bfloat16, False), (68, torch.bfloat16, False), (72, torch.bfloat16, True)])
def test_d2s_tma_store_rule(O, dtype, store):
    """The output map needs 16-byte strides and at least one box of o."""
    assert k.d2s_tma_store(O, dtype) == store


def gemm_acc(xq, weight):
    """The (B h w, kh kw O) int64 product of the transposed conv."""
    B, C, h, w = xq.shape
    _, O, kh, kw = weight.shape
    a = xq.permute(0, 2, 3, 1).reshape(B * h * w, C).long()
    wt = weight.permute(2, 3, 1, 0).reshape(kh * kw * O, C).long()
    return a @ wt.t()


def d2s_store_model(acc, plan, B, h, w, O, kh, kw, elem):
    """The d2s kernel's epilogue on the CPU: each unit's 128x128 tile (rows
    ml = pixel (y0 + ml // tw, x0 + ml % tw), columns o0 + c of segment
    seg = i kw + j), stored as the boxes (128 / elem o, 1, tw, 1, th) of
    the output's 5-D map at (o0 + q 128 / elem, j, x0, i, b h + y0); TMA
    skips coordinates outside the dims. -> (out (B, h kh, w kw, O), the
    writes per element)."""
    dims = (O, kw, w, kh, B * h)
    strides = (1, O, kw * O, w * kw * O, kh * w * kw * O)
    out = torch.full((B * h * kh * w * kw * O,), -(2 ** 40), dtype=torch.int64)
    writes = torch.zeros_like(out)
    m_tiles, n_tiles, _ = plan.grid
    o_tiles = math.ceil(O / k.TILE)
    tiles_h, tiles_w = h // plan.th, math.ceil(w / plan.tw)
    qc = 128 // elem
    for m in range(m_tiles):
        b, rem = divmod(m, tiles_h * tiles_w)
        y0, x0 = rem // tiles_w * plan.th, rem % tiles_w * plan.tw
        for n in range(n_tiles):
            seg, ot = divmod(n, o_tiles)
            i, j = divmod(seg, kw)
            o0 = ot * k.TILE
            tile = torch.zeros(k.TILE, k.TILE, dtype=torch.int64)
            for ml in range(plan.th * plan.tw):
                y, x = y0 + ml // plan.tw, x0 + ml % plan.tw
                if x < w:  # past w: never stored (outside the map's w)
                    row = acc[(b * h + y) * w + x, seg * O + o0: seg * O + min(O, o0 + k.TILE)]
                    tile[ml, :len(row)] = row
            for q in range(k.TILE // qc):
                eo = torch.arange(qc)
                for ey in range(plan.th):
                    for ex in range(plan.tw):
                        coords = [o0 + q * qc + eo, j, x0 + ex, i, b * h + y0 + ey]
                        inside = (coords[0] < dims[0]) & (coords[2] < dims[2]) & (
                            coords[4] < dims[4])
                        if not bool(inside.any()):
                            continue
                        lin = sum(c * s for c, s in zip(coords, strides))[inside]
                        out[lin] = tile[ey * plan.tw + ex, q * qc + eo[inside]]
                        writes[lin] += 1
    return out.reshape(B, h * kh, w * kw, O), writes


@pytest.mark.parametrize("B,h,w,C,O,kk,dtype", [
    (2, 4, 8, 32, 136, 2, torch.bfloat16),   # O past one 128-wide N tile, a batch of two
    (1, 3, 16, 16, 64, 3, torch.float32),    # k = 3, O one f32 box
    (2, 5, 24, 48, 72, 2, torch.bfloat16),   # O not a multiple of 64
    (1, 6, 20, 16, 40, 2, torch.int32),      # a rectangle narrower than w
    (1, 2, 130, 16, 64, 2, torch.bfloat16)])  # a wide map, a ragged last rectangle
def test_d2s_store_map_model_matches_plain_layout(B, h, w, C, O, kk, dtype):
    g = torch.Generator().manual_seed(B * 100 + O)
    xq = torch.randint(-127, 128, (B, C, h, w), generator=g, dtype=torch.int8)
    weight = torch.randint(-127, 128, (kk, kk, O, C), generator=g, dtype=torch.int8)
    weight = weight.permute(3, 2, 0, 1)
    plan = k.int8_conv_transpose_plan(B, h, w, C, O, kk, kk, SMS)
    assert k.d2s_tma_store(O, dtype)
    got, writes = d2s_store_model(gemm_acc(xq, weight), plan, B, h, w, O, kk, kk, ELEM[dtype])
    assert bool((writes == 1).all())  # every output written once
    want = k.int8_conv_transpose_plain(xq, weight, torch.ones(O), torch.tensor(1.0), None,
                                       torch.int32)
    assert torch.equal(got.permute(0, 3, 1, 2), want.long())


# (B, H, W, C, N, KH, KW, pad): the QAT export's head, the card tests' and
# chip_smoke.py's 3x3 with C < 128, then the edges: C = 16, 48, 112 (a K
# tail), N = 1, 3, 8, 9, 64, 65, a 1x1 window with padding, 5x5, a batch of
# two, maps smaller than a tile, and an SE squeeze forced onto the route
HALO = [(1, 320, 640, 64, 3, 3, 3, 1), (1, 20, 40, 64, 96, 3, 3, 1),
        (1, 9, 13, 16, 8, 3, 3, 1), (1, 9, 13, 48, 9, 3, 3, 1), (1, 9, 13, 112, 64, 3, 3, 1),
        (1, 7, 11, 32, 1, 3, 3, 1), (1, 7, 11, 32, 65, 3, 3, 1), (1, 10, 20, 320, 64, 1, 1, 1),
        (1, 1, 1, 480, 20, 1, 1, 2), (2, 13, 17, 48, 65, 5, 5, 2), (2, 6, 9, 64, 3, 3, 3, 1),
        (1, 3, 5, 16, 3, 3, 3, 1), (1, 1, 1, 1152, 48, 1, 1, 0), (1, 160, 320, 64, 64, 3, 3, 1)]


def halo_plan(B, H, W, C, N, KH, KW, pad):
    if KH * KW == 1 and pad == 0:  # int8_conv_plan sends it to the 1x1 routes
        return k._halo_plan(B, H, W, C, N, KH, KW, pad, SMS)
    plan = k.int8_conv_plan(B, H, W, C, N, KH, KW, pad, SMS)
    assert plan == k._halo_plan(B, H, W, C, N, KH, KW, pad, SMS)
    return plan


@pytest.mark.parametrize("B,H,W,C,N,KH,KW,pad", HALO,
                         ids=["-".join(map(str, s)) for s in HALO])
def test_halo_plan_covers_the_conv(B, H, W, C, N, KH, KW, pad):
    plan = halo_plan(B, H, W, C, N, KH, KW, pad)
    OH, OW = H + 2 * pad - KH + 1, W + 2 * pad - KW + 1
    m_tiles, n_tiles, splits = plan.grid
    assert plan.route == "halo" and splits == 1
    # N: the narrowest wgmma width that holds N, 64 above it
    assert plan.bn in k.HALO_WIDTHS and n_tiles == math.ceil(N / plan.bn)
    assert plan.bn == min([x for x in k.HALO_WIDTHS if x >= N] or [64])
    # M: th x tw rectangles of one image cover the output once; the tile's
    # halo positions, th rows of a power-of-two width hw, fill at most the
    # TILE accumulator rows
    hw = k.halo_width(plan.tw, KW)
    assert hw & (hw - 1) == 0 and hw >= plan.tw + KW - 1 and plan.th * hw <= k.TILE
    tiles_h, tiles_w = math.ceil(OH / plan.th), math.ceil(OW / plan.tw)
    assert m_tiles == B * tiles_h * tiles_w
    covered = np.zeros((tiles_h * plan.th, tiles_w * plan.tw), np.int32)
    for i in range(tiles_h):
        for j in range(tiles_w):
            covered[i * plan.th:(i + 1) * plan.th, j * plan.tw:(j + 1) * plan.tw] += 1
    assert (covered[:OH, :OW] == 1).all()
    # the halo box: 16 bytes of channels (a multiple of 16), each dim <= 256
    hh = plan.th + KH - 1
    assert hh <= 256 and hw <= 256 and k.HALO_SLAB == 16
    # weight steps (tap, 128-channel chunk); shared memory
    nc = math.ceil(C / k.HALO_CHUNK)
    assert plan.iters == KH * KW * nc
    assert 2 <= plan.stages <= k.HALO_STAGES and (not plan.resident or n_tiles == 1)
    lay = k.halo_layout(plan.th, plan.tw, KH, KW, C, N, plan.bn, plan.stages, plan.resident)
    assert lay.smem <= k.HALO_SMEM <= k.SMEM_LIMIT
    assert lay.slab_pitch % 128 == 0 and lay.halo_bytes % 1024 == 0
    assert lay.slabs % 2 == 0 and lay.slabs * k.HALO_SLAB >= min(C, k.HALO_CHUNK)
    # the halo is smaller than a window's reads of the tile from L2
    assert hh * hw < KH * KW * plan.th * plan.tw or KH * KW == 1
    # every position a tap reads lies inside the slab
    assert lay.slab_pitch >= (k.TILE + (KH - 1) * hw + KW - 1) * k.HALO_SLAB
    assert plan.blocks == min(m_tiles * n_tiles, k.HALO_BLOCKS_PER_SM * SMS)


def test_qat_head_halo_is_small():
    """64 -> 3 3x3 at 320x640: 4x30 tiles in halo rows of 32 (each input
    pixel read 1.6 times, not 9), one N tile of 8, the weights resident."""
    plan = k.int8_conv_plan(1, 320, 640, 64, 3, 3, 3, 1, SMS)
    assert (plan.route, plan.th, plan.tw, plan.bn, plan.resident) == ("halo", 4, 30, 8, True)
    assert k.halo_width(plan.tw, 3) == 32 and plan.grid == (1760, 1, 1)
    assert (plan.th + 2) * 32 / (plan.th * plan.tw) == pytest.approx(1.6)


def halo_model(xq, w, plan, pad):
    """The halo kernel's reads on the CPU: for each unit, the halo box of
    every 16-channel slab (th + KH - 1 rows of hw positions at (x0 - pad, y0
    - pad)) with zeros outside the image and past C (TMA's fill) in a slab
    of slab_pitch / 16 positions (what lies past the box is never stored:
    filled with noise here); accumulator row m (halo position m = y hw + x,
    TILE of them) sums tap (r, q) at position m + r hw + q, which must lie
    inside the slab. -> the int32 accumulators (B, OH, OW, N) of the rows
    with x < tw and y < th."""
    B, C, H, W = xq.shape
    N, _, KH, KW = w.shape
    OH, OW = H + 2 * pad - KH + 1, W + 2 * pad - KW + 1
    m_tiles, n_tiles, _ = plan.grid
    tiles_h, tiles_w = math.ceil(OH / plan.th), math.ceil(OW / plan.tw)
    hw, hh = k.halo_width(plan.tw, KW), plan.th + KH - 1
    lay = k.halo_layout(plan.th, plan.tw, KH, KW, C, N, plan.bn, plan.stages, plan.resident)
    positions = lay.slab_pitch // k.HALO_SLAB
    cp = math.ceil(C / k.HALO_CHUNK) * k.HALO_CHUNK
    x = xq.long().permute(0, 2, 3, 1)
    wl = F.pad(w.long(), (0, 0, 0, 0, 0, cp - C)).permute(0, 2, 3, 1)  # (N, KH, KW, cp)
    out = torch.full((B, OH, OW, N), -(2 ** 40), dtype=torch.int64)
    m = torch.arange(k.TILE)
    g = torch.Generator().manual_seed(1)
    for mt in range(m_tiles):
        b, rem = divmod(mt, tiles_h * tiles_w)
        y0, x0 = rem // tiles_w * plan.th, rem % tiles_w * plan.tw
        box = torch.zeros(hh, hw, cp, dtype=torch.int64)
        ys, xs = y0 - pad, x0 - pad
        sy, sx = max(0, ys), max(0, xs)
        ey, ex = min(H, ys + hh), min(W, xs + hw)
        if sy < ey and sx < ex:
            box[sy - ys:ey - ys, sx - xs:ex - xs, :C] = x[b, sy:ey, sx:ex]
        slab = torch.randint(-127, 128, (positions, cp), generator=g).long()
        slab[:hh * hw] = box.reshape(hh * hw, cp)
        for n in range(n_tiles):
            n0 = n * plan.bn
            part = wl[n0:n0 + plan.bn]
            wt = F.pad(part, (0, 0, 0, 0, 0, 0, 0, plan.bn - len(part)))
            acc = torch.zeros(k.TILE, plan.bn, dtype=torch.int64)
            for r in range(KH):
                for q in range(KW):
                    assert int(m[-1]) + r * hw + q < positions
                    acc += slab[m + r * hw + q] @ wt[:, r, q].t()
            for pos in range(k.TILE):
                y, xx = divmod(pos, hw)
                oh, ow = y0 + y, x0 + xx
                if y < plan.th and xx < plan.tw and oh < OH and ow < OW:
                    cols = min(plan.bn, N - n0)
                    out[b, oh, ow, n0:n0 + cols] = acc[pos, :cols]
    return out


@pytest.mark.parametrize("B,H,W,C,N,KH,KW,pad", [s for s in HALO if s[1] * s[2] <= 400],
                         ids=["-".join(map(str, s)) for s in HALO if s[1] * s[2] <= 400])
def test_halo_model_matches_plain_accumulators(B, H, W, C, N, KH, KW, pad):
    plan = halo_plan(B, H, W, C, N, KH, KW, pad)
    g = torch.Generator().manual_seed(C + N + KH)
    xq = torch.randint(-127, 128, (B, C, H, W), generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (N, C, KH, KW), generator=g, dtype=torch.int8)
    want = k.int8_conv_plain(xq.contiguous(memory_format=CL), w.contiguous(memory_format=CL),
                             torch.ones(N), torch.tensor(1.0), None, pad, torch.int32)
    assert torch.equal(halo_model(xq, w, plan, pad), want.permute(0, 2, 3, 1).long())


def copy_out_model(plan, B, OH, OW, N, elem):
    """The halo kernel's epilogue copy on the CPU, over every unit: each
    segment (an output row of the tile with one N tile, else a pixel's
    columns of its N tile) staged at its global offset's misalignment, then
    copied in the 16-byte windows the kernel's threads take (whole windows
    as one aligned store, the ragged ends element by element). -> the
    writes per output byte."""
    m_tiles, n_tiles, _ = plan.grid
    tiles_h, tiles_w = math.ceil(OH / plan.th), math.ceil(OW / plan.tw)
    total = B * OH * OW * N * elem
    writes = np.zeros(total, np.int32)
    rows_mode = n_tiles == 1
    for m in range(m_tiles):
        b, rem = divmod(m, tiles_h * tiles_w)
        y0, x0 = rem // tiles_w * plan.th, rem % tiles_w * plan.tw
        for n in range(n_tiles):
            n0 = n * plan.bn
            ncols = min(plan.bn, N - n0)
            segs = min(plan.th, OH - y0) if rows_mode else plan.th * plan.tw
            seg_len = (min(plan.tw, OW - x0) * N if rows_mode else ncols) * elem
            windows = (seg_len + 15) // 16 + 1
            for s in range(segs):
                if rows_mode:
                    start = ((b * OH + y0 + s) * OW + x0) * N
                else:
                    y, x = y0 + s // plan.tw, x0 + s % plan.tw
                    if y >= OH or x >= OW:
                        continue
                    start = ((b * OH + y) * OW + x) * N + n0
                gp = start * elem
                mis = gp % 16
                for j in range(windows):
                    lo, hi = max(0, 16 * j - mis), min(seg_len, 16 * j + 16 - mis)
                    if lo >= hi:
                        continue
                    assert hi - lo == 16 or (hi - lo) % elem == 0
                    if hi - lo == 16:
                        assert (gp + lo) % 16 == 0  # one aligned 16-byte store
                    writes[gp + lo:gp + hi] += 1
    return writes


@pytest.mark.parametrize("elem", [2, 4])
@pytest.mark.parametrize("B,H,W,C,N,KH,KW,pad", [s for s in HALO if s[1] * s[2] <= 400],
                         ids=["-".join(map(str, s)) for s in HALO if s[1] * s[2] <= 400])
def test_halo_copy_out_writes_every_byte_once(B, H, W, C, N, KH, KW, pad, elem):
    plan = halo_plan(B, H, W, C, N, KH, KW, pad)
    OH, OW = H + 2 * pad - KH + 1, W + 2 * pad - KW + 1
    assert (copy_out_model(plan, B, OH, OW, N, elem) == 1).all()
    # the staging holds every segment: its pitch, with the shift, fits a segment
    lay = k.halo_layout(plan.th, plan.tw, KH, KW, C, N, plan.bn, plan.stages, plan.resident)
    seg_bytes = (plan.tw * N if plan.grid[1] == 1 else plan.bn) * elem
    assert seg_bytes + 15 <= lay.seg_pitch and lay.seg_pitch % 16 == 0


def test_halo_plan_refuses_what_no_box_holds():
    with pytest.raises(ValueError, match="TMA box"):
        k._halo_plan(1, 300, 300, 16, 8, 1, 300, 0, SMS)
