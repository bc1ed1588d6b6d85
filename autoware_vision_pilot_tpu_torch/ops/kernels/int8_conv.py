"""Int8 convolution: the wrappers of csrc/int8_conv.cu,
csrc/int8_conv_sm90.cu, csrc/int8_conv_halo.cu, csrc/int8_conv_strided.cu
and csrc/int8_pointwise.cu,
the port of the int8 branch of autoware_vision_pilot_tpu/nn/layers.py::Conv2d
(:81-113) and ConvTranspose2d (:187-208), which the JAX package leaves to
XLA. On the card every kernel is called as a dispatcher operator,
``torch.ops.avp.*`` (csrc/torch_ops.cpp, loaded by torch_ops.py), so that a
program with int8 convs exports and runs without Python.

Kernels, each with its wrapper, its plain PyTorch version and its count of
launches:

- ``int8_quantize``: xq = clip(round_half_even(f32(x) / sx), -127, 127),
  sx a scalar or one scale per input channel (nn/layers.py:103-108).
- ``int8_conv``: the int32 accumulators of conv(xq, w), then
  ``cast(f32(acc) * dequant) + bias`` with dequant = sx * w_scale for a
  scalar sx, w_scale alone for a per-channel one, which the weights carry
  (:110-113); or the accumulators themselves for ``out_dtype=torch.int32``.
  ``int8_conv_plan`` picks one of six routes: "wgmma" (TMA loads and
  wgmma on 128x128 tiles), "splitk" (the same kernel over slices of K; the
  split that finishes a tile last runs its epilogue), "strided" (a kernel
  of its own for any stride, dilation and padding a dimension: a halo a
  phase of the input gathered once a tile (16-byte cp.async), each tap's
  wgmma reading it through a shifted descriptor, K in steps of 32
  channels split over the blocks of a cluster and summed in distributed
  shared memory, N tiles of 8-64; one launch), "pointwise" (1x1
  convs: TMA loads, the quantize into wgmma's register A fragments, K
  split over the blocks of a cluster), "dot" (1x1 convs of at most 8
  pixels, the M = 1 SE convs: a lane per 16 channels of an output
  channel) and "halo" (windows larger than 1x1 with C < 128, and a 1x1
  window with padding: each tile's input halo loaded once by TMA, each
  tap's wgmma reading it through a shifted descriptor, N tiles of 8-64).
  ``int8_conv.launches`` counts every conv launch;
  ``int8_conv.route_launches`` counts them by route.

- ``int8_conv_transpose``: the int8 branch of ConvTranspose2d
  (nn/layers.py:187-208) for kernel == stride, padding 0: int8_quantize,
  then one product of the (M = B h w, K = C) int8 activation and the (kh kw
  O, C) weights on the wgmma kernel ("d2s" plan), N tiled within each (i,
  j) output segment, whose epilogue writes each result (m, (i, j, o)) to
  out[b, h kh + i, w kw + j, o] (depth to space) through a TMA store, with
  w_scale[o] and bias[o]; ``int8_conv_transpose.launches`` counts the
  product's launches.

``int8_conv2d`` is the whole conv on a float input: on the "pointwise"
and "dot" routes one launch that quantizes as it loads (bit-equal to the
quantize kernel: it multiplies by 1 / sx in float64, which ``_reciprocal``
keeps on the scale tensor in eager runs and a traced program computes), on
the others quantize, then conv. On a CUDA tensor a wrapper launches its
kernel or raises; on a CPU tensor it runs the plain version, which
computes the conv in float64 on the int8 values (exact: |acc| <= 127^2 * K
< 2^53) and the same epilogue in torch ops. Every scale is a tensor on the
input's device, so no launch waits for the host.

The convs take JAX's whole int8 rule (nn/layers.py:73-79): any window, a
symmetric padding a dimension, a stride and a dilation a dimension, and
groups (one launch a group, on the group's channels); NHWC
(channels_last) inputs and (O, kh, kw, I/groups) weights, i.e. OIHW
weights in channels_last memory. The launch counters count eager launches
(a trace records the operator, and an exported program's calls are
counted by the operator library, torch_ops.calls()).
"""
from __future__ import annotations

import functools
import math
from typing import Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from . import torch_ops

CL = torch.channels_last
IN_DTYPES = (torch.float32, torch.bfloat16)
_OUT_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
_ELEM_BYTES = {torch.float32: 4, torch.bfloat16: 2, torch.int32: 4}
ROUTES = ("wgmma", "splitk", "strided", "halo", "pointwise", "dot")
FUSED_ROUTES = ("pointwise", "dot")  # they take a float input and quantize it
_IN_KIND = {torch.int8: 0, torch.bfloat16: 1, torch.float32: 2}
TILE = 128      # the wgmma route's BM = BN = BK (csrc/int8_conv_sm90.cu)
# the strided route's limits a dimension (StridedDim.fits): a halo of at
# most MAX_BOX input elements, a stride of at most MAX_TRAVERSAL where it
# loads a halo a phase (its kernel's phase tables hold that many)
MAX_BOX = 256
MAX_TRAVERSAL = 8
# the halo route (csrc/int8_conv_halo.cu): its N tiles (wgmma's small N
# shapes), the channels of a halo chunk and of a weight box, of a slab (one
# 16-byte pixel row), its most halo stages, its weight ring, and the dynamic
# shared memory a launch may take
HALO_WIDTHS = (8, 16, 24, 32, 48, 64)
HALO_CHUNK = 128
HALO_SLAB = 16
HALO_STAGES = 4
HALO_WSTAGES = 4
HALO_SMEM = 113 * 1024   # two blocks an SM
HALO_BLOCKS_PER_SM = 2
SMEM_LIMIT = 232_448  # an H100's shared memory a block can use (227 KB)
# the strided route (csrc/int8_conv_strided.cu): its output positions a
# block (two consumer warpgroups of 64), its K step (32 channels: one int8
# wgmma, two 16-byte slabs), its most stages, the words after each row of
# the int32 tile its cluster sums, and the dynamic shared memory a launch
# may take
ST_TILE = 128
ST_STEP = 32
ST_STAGES = 8
ST_PAD = 4
ST_SMEM = 200 * 1024
PW_WIDTHS = (64, 128, 192, 256)  # the pointwise route's N tiles (csrc/int8_pointwise.cu)
PW_BK = 16      # its K ranges are multiples of 16 channels (a TMA box starts on 16 bytes)
PW_STEP = 128   # its K step: 128 channels, one 128-byte row of an int8 TMA box
PW_MIN_RANGE = 64  # the fewest channels of a cluster rank's K range
# the pointwise plan's cost model, from the kernel's stage split on the H100
# (chip_smoke.py --parent): ns a value each consumer thread quantizes, and
# ns a byte of the int32 partial tile a cluster rank hands the others
PW_QUANTIZE_NS = 25.0
PW_REDUCE_NS_PER_BYTE = 0.06
MAX_CLUSTER = 8  # the portable thread-block cluster size
GPCS = 8        # an H100 SXM's GPCs; the blocks of a cluster run in one
DOT_MAX_M = 8   # the dot route's most output pixels
DOT_MAX_BYTES = 32 * 1024  # and most int8 activation bytes (M * C)
DOT_THREADS = 128  # its threads a block with at most a warp's lanes a channel
DOT_GROUPS = 4  # its channels a block with more
DOT_MAX_WARPS = 4  # and most warps a channel
DOT_CHUNK = 16  # its lanes take K in chunks of 16 channels, one 16-byte weight load
MAX_K = 133_144  # 127^2 * K < 2^31: the int32 accumulators cannot overflow
SMS = 132       # an H100 SXM's SM count; the wrapper passes the card's own


def f32_div(a: torch.Tensor, b: float) -> torch.Tensor:
    """a / b rounded once, on every device: torch divides a CUDA tensor by
    a Python number as a * (1 / b), which can differ by an ulp."""
    return a / torch.full_like(a, b)


def dynamic_input_scale(x: torch.Tensor):
    """The dynamic per-tensor scale of nn/layers.py:99-101 -> (sx, amax),
    both f32 0-dim tensors on x's device: amax = max(max|x|, 1e-6),
    sx = amax / 127."""
    amax = x.abs().amax().float().clamp_min(1e-6)
    return f32_div(amax, 127.0), amax


def _pair(v) -> tuple:
    return (v, v) if isinstance(v, int) else tuple(v)


def geometry(padding, stride=1, dilation=1) -> tuple:
    """(pad_h, pad_w, stride_h, stride_w, dil_h, dil_w) of a conv: JAX's
    padding [(ph, ph), (pw, pw)], window_strides and rhs_dilation, each an
    int or a pair."""
    (ph, pw), (sh, sw), (dh, dw) = _pair(padding), _pair(stride), _pair(dilation)
    if min(ph, pw) < 0 or min(sh, sw, dh, dw) < 1:
        raise ValueError(f"no int8 conv with padding {padding}, strides {stride}, dilations "
                         f"{dilation}: padding must be >= 0, strides and dilations >= 1")
    return ph, pw, sh, sw, dh, dw


def out_size(H: int, W: int, KH: int, KW: int, geo: tuple) -> tuple:
    """The conv's output (OH, OW) (lax.conv_general_dilated's), each 0 or
    less where the window does not fit the padded input."""
    ph, pw, sh, sw, dh, dw = geo
    eh, ew = H + 2 * ph - dh * (KH - 1), W + 2 * pw - dw * (KW - 1)
    return (eh - 1) // sh + 1 if eh > 0 else 0, (ew - 1) // sw + 1 if ew > 0 else 0


def _stride_one(geo: tuple) -> bool:
    """A stride-1 conv without dilation and with one padding: the routes
    before "strided" take it."""
    ph, pw, sh, sw, dh, dw = geo
    return ph == pw and (sh, sw, dh, dw) == (1, 1, 1, 1)


def _check_nhwc(x: torch.Tensor, what: str) -> None:
    if x.dim() != 4:
        raise ValueError(f"{what} must be 4-D NCHW, got {tuple(x.shape)}")
    if not x.is_contiguous(memory_format=CL):
        raise ValueError(f"{what} must be channels_last contiguous")


def _check_scale(x_scale: torch.Tensor, cin: int, device) -> None:
    if x_scale.dtype != torch.float32 or x_scale.device != device:
        raise TypeError(f"x_scale must be f32 on {device}, got "
                        f"{x_scale.dtype} on {x_scale.device}")
    if x_scale.shape not in ((), (cin,)):
        raise ValueError(f"x_scale must be () or ({cin},), got "
                         f"{tuple(x_scale.shape)}")


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _eager() -> bool:
    """Not inside a trace (torch.export, torch.compile): only eager
    launches are counted here, and only eager runs keep caches on
    tensors."""
    return not torch.compiler.is_compiling()


# ------------------------------------------------------------------ quantize

def int8_quantize_plain(x: torch.Tensor, x_scale: torch.Tensor) -> torch.Tensor:
    s = x_scale.reshape(1, -1, 1, 1) if x_scale.dim() == 1 else x_scale
    q = torch.clamp(torch.round(x.float() / s), -127, 127).to(torch.int8)
    return q.contiguous(memory_format=CL)


def padded_channels(c: int) -> int:
    """The channels the kernels see: C rounded up to a multiple of 16 (they
    copy 16 channels at a time). int8_conv and int8_quantize pad the rest
    with zeros on every call."""
    return c + -c % 16


def pad_channels(t: torch.Tensor, c: int) -> torch.Tensor:
    """``t`` (B, C, H, W) with zero channels up to ``c``, channels_last: the
    pad int8_conv and int8_quantize apply to x and the weights."""
    if t.shape[1] == c:
        return t
    return F.pad(t, (0, 0, 0, 0, 0, c - t.shape[1])).contiguous(memory_format=CL)


def int8_quantize(x: torch.Tensor, x_scale: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) f32/bf16 channels_last -> int8 channels_last; on the
    card the operator ``avp::int8_quantize``. Counts its kernel launches in
    ``int8_quantize.launches``."""
    if x.dtype not in IN_DTYPES:
        raise TypeError(f"x must be one of {IN_DTYPES}, got {x.dtype}")
    _check_nhwc(x, "x")
    _check_scale(x_scale, x.shape[1], x.device)
    if x.device.type == "cpu":
        return int8_quantize_plain(x, x_scale)
    if x.device.type != "cuda":
        raise ValueError(f"no int8 quantize for device {x.device}")
    index = x.get_device()
    if index != torch.cuda.current_device():  # the kernels launch on the current device
        with torch.cuda.device(index):
            return int8_quantize(x, x_scale)
    C = x.shape[1]
    Cp = padded_channels(C)
    if Cp != C:  # the kernel takes 16 channels a thread; the pad is cut off again
        sp = F.pad(x_scale, (0, Cp - C), value=1.0) if x_scale.dim() == 1 else x_scale
        return int8_quantize(pad_channels(x, Cp), sp)[:, :C].contiguous(memory_format=CL)
    torch_ops.load()
    xq = torch.ops.avp.int8_quantize(x, x_scale.contiguous())
    if _eager():
        int8_quantize.launches += 1
    return xq


int8_quantize.launches = 0


# ---------------------------------------------------------------------- plan

class Int8ConvPlan(NamedTuple):
    """How one int8 conv runs. ``grid`` is (M tiles, N tiles, K splits).
    The wgmma routes (and the transposed conv's "d2s") tile M as rectangles
    of ``th`` x ``tw`` output pixels of one image and K as ``iters`` steps
    of (tap r, tap s, a chunk of ``bk`` channels), ``per_split`` steps to a
    split; a unit of work is one (M tile, N tile, split), and each of the
    ``blocks`` persistent blocks takes every blocks-th unit. The halo route
    tiles M as th x tw rectangles too and N as ``bn`` channels, one split;
    its K is ``iters`` (tap, 128-channel chunk) weight steps, its halo ring
    has ``stages`` stages, and ``resident`` keeps every weight step in
    shared memory for a block's life. The pointwise route
    tiles M as ``bm`` flat rows (a consumer warpgroup per 64) and N as
    ``bn`` channels (bn / 64 wgmmas); the K splits are the blocks of one
    cluster, and split z takes the channels [z * per_split * bk, (z + 1) *
    per_split * bk) of the ``iters * bk``, in K steps of PW_STEP; one block
    per tile and split. The dot route runs ``bn`` output channels a block,
    ``bm`` = M rows each, over ``iters`` chunks of ``bk`` channels; its K
    splits are the ``grid[2]`` lanes of a channel, lane z taking chunks z,
    z + lanes, ... (``per_split`` of them at most). The strided route tiles
    M as th x tw rectangles (th hw <= 128 positions, hw the W halo's lines)
    and N as ``bn`` channels; its K is ``iters`` steps of ``bk`` = 32
    channels, ``per_split`` of them a rank of a cluster of ``grid[2]``
    blocks; ``stages`` units a batch in shared memory; ``phases`` = (a
    halo a phase along H, along W, the groups of a unit)."""
    route: str
    bm: int
    bn: int
    bk: int
    grid: tuple
    th: int
    tw: int
    iters: int
    per_split: int
    blocks: int
    stages: int = 0
    resident: bool = False
    phases: tuple = ()

    @property
    def splits(self) -> int:
        return self.grid[2]


def _widths(OW: int, bm: int = TILE) -> list:
    """The rectangle widths the plans weigh, widest first."""
    return sorted({min(OW, bm), *(w for w in (128, 64, 32, 16, 8) if w <= OW)}, reverse=True)


def _rectangle(OH: int, OW: int, bm: int = TILE) -> tuple:
    """The th x tw pixel rectangle (th * tw <= bm) that covers the OH x OW
    map in the fewest M tiles; the widest of those."""
    best = None
    for tw in _widths(OW, bm):
        th = min(bm // tw, OH)
        tiles = math.ceil(OH / th) * math.ceil(OW / tw)
        if best is None or tiles < best[0]:
            best = (tiles, th, tw)
    return best[1], best[2]


def _whole_rows_rectangle(OH: int, OW: int, bm: int = TILE) -> tuple:
    """_rectangle's choice among the rectangles whose th divides OH, so that
    no tile crosses an image's last row (the d2s epilogue's output map runs
    the B h rows of all images together)."""
    best = None
    for tw in _widths(OW, bm):
        th = max(d for d in range(1, min(bm // tw, OH) + 1) if OH % d == 0)
        tiles = OH // th * math.ceil(OW / tw)
        if best is None or tiles < best[0]:
            best = (tiles, th, tw)
    return best[1], best[2]


def halo_width(tw: int, KW: int) -> int:
    """The halo route's row of halo pixels in shared memory: the power of
    two, at least 8, that holds tw + KW - 1 (csrc/int8_conv_halo.cu)."""
    return max(8, 1 << (tw + KW - 2).bit_length())


def _halo_rectangle(OH: int, OW: int, KH: int, KW: int, bm: int = TILE) -> tuple:
    """The halo route's th x tw rectangle: for each halo width hw (a power
    of two from 8 to bm, at least KW), tw = hw - KW + 1 outputs a row (OW at
    most) and th = bm // hw rows (OH at most), so that the tile's halo
    positions th hw fill the bm accumulator rows; the fewest tiles, then the
    fewest halo pixels loaded, (th + KH - 1) hw a tile. Raises ValueError
    where no width holds the window."""
    best = None
    for hw in (8, 16, 32, 64, 128):
        if hw < KW or hw > bm:
            continue
        tw, th = min(hw - KW + 1, OW), min(bm // hw, OH)
        tiles = math.ceil(OH / th) * math.ceil(OW / tw)
        key = (tiles, tiles * (th + KH - 1) * hw)
        if best is None or key < best[0]:
            best = (key, th, tw)
    if best is None:
        raise ValueError(f"window {KH}x{KW}: its halo exceeds a TMA box (a row of at most "
                         f"{bm} pixels)")
    return best[1], best[2]


def _k_splits(tiles: int, iters: int, sms: int) -> tuple:
    """The wgmma kernel's K splits of ``tiles`` output tiles of ``iters`` K
    steps -> (splits, steps a split): up to sms // tiles contiguous ranges
    of at least 4 steps where the tiles fill at most half of the SMs, else
    one."""
    splits = max(1, min(sms // tiles, iters // 4))
    if 2 * tiles > sms or splits < 2:
        return 1, iters
    per_split = math.ceil(iters / splits)
    return math.ceil(iters / per_split), per_split  # no split left without a K step


@functools.lru_cache(maxsize=4096)
def int8_conv_plan(B: int, H: int, W: int, C: int, N: int, KH: int, KW: int,
                   pad, sms: int = SMS, stride=1, dilation=1) -> Int8ConvPlan:
    """The route, tiles, K splits and grid of an int8 conv of a (B, H, W,
    C) NHWC input (C a multiple of 16) with N output channels, a KH x KW
    window, ``pad`` zeros on each side (an int, or one a dimension),
    ``stride`` and ``dilation`` (an int, or one a dimension), on a card of
    ``sms`` SMs. A conv with a stride or a dilation other than 1, or with
    another padding a dimension, takes "strided" (_strided_plan: a halo a
    phase, N tiles of 8-64, K steps of 32 channels split over a cluster of
    up to 8 blocks, one block a tile, N tile and rank); the others:

    - "wgmma" for windows larger than 1x1 with C >= 128;
    - "splitk" for those of them whose 128x128 output tiles fill less than
      half of the SMs (the thin 20x40 and 10x20 3x3 convs): K is cut into
      up to sms // tiles contiguous ranges of at least 4 steps;
    - "dot" for 1x1 convs without padding of at most DOT_MAX_M output
      pixels whose int8 activation is at most DOT_MAX_BYTES (the M = 1 SE
      convs): one 16-channel chunk a lane, a power of two of a warp's
      lanes or up to four warps a channel (the warps add their sums in
      shared memory behind a barrier of theirs alone);
    - "pointwise" for the other 1x1 convs without padding: 128-row tiles
      where 64-row ones would already fill the SMs, else 64-row ones; each
      tile's K split over a cluster of as many blocks as the SMs hold, up
      to 8, in ranges of multiples of 16 channels and at least
      PW_MIN_RANGE, and no larger than lets every cluster run at once
      (clusters_at_once); and the N tile of PW_WIDTHS whose plan costs least by
      _pointwise_cost (the quantize a thread against the partial tile a
      rank hands on, in waves of the SMs);
    - "halo" for the rest (windows larger than 1x1 with C < 128, and a 1x1
      window with padding): _halo_plan.

    The wgmma routes launch persistent blocks, one per SM or one per unit
    of work, whichever is fewer; "strided" launches one block a unit.

    Raises ValueError for a shape that no route takes."""
    geo = geometry(pad, stride, dilation)
    OH, OW = out_size(H, W, KH, KW, geo)
    if min(B, H, W, C, N, KH, KW) <= 0:
        raise ValueError(f"no int8 conv of B={B} H={H} W={W} C={C} N={N} "
                         f"window {KH}x{KW} pad {pad}")
    if OH <= 0 or OW <= 0:
        raise ValueError(f"window {KH}x{KW} larger than the padded input {H}x{W}")
    if padded_channels(C) != C:
        raise ValueError(f"C = {C}: the kernels take multiples of 16 channels "
                         "(int8_conv pads the rest with zeros)")
    if KH * KW * C > MAX_K:
        raise ValueError(f"K = {KH * KW * C} > {MAX_K}: int32 accumulators could overflow")
    M = B * OH * OW
    if M >= 2 ** 31:
        raise ValueError(f"M = {M} output pixels: more than an int32 indexes")
    if not _stride_one(geo):
        return _strided_plan(B, OH, OW, C, N, KH, KW, geo, sms)
    pad = geo[0]
    if KH * KW == 1 and pad == 0:
        return _pointwise_plan(M, C, N, sms)
    if KH * KW == 1 or C < TILE:
        return _halo_plan(B, H, W, C, N, KH, KW, pad, sms)
    th, tw = _rectangle(OH, OW)
    m_tiles = B * math.ceil(OH / th) * math.ceil(OW / tw)
    n_tiles = math.ceil(N / TILE)
    iters = KH * KW * math.ceil(C / TILE)
    if n_tiles > 65535:
        raise ValueError(f"N = {N}: more output channels than the grid holds")
    tiles = m_tiles * n_tiles
    splits, per_split = _k_splits(tiles, iters, sms)
    return Int8ConvPlan("splitk" if splits > 1 else "wgmma", TILE, TILE, TILE,
                        (m_tiles, n_tiles, splits), th, tw, iters, per_split,
                        min(tiles * splits, sms))


class StridedDim(NamedTuple):
    """How the "strided" route loads one dimension of a tile of ``t``
    outputs (csrc/int8_conv_strided.cu::Dim): tap k reads input line x0 s +
    k d - p for output x0. ``phase``: a halo a phase, the taps' lines taken
    (o mod s) apart and offset floor(o / s) (o = k d - p) within it, every
    input line once a tile; else a box a tap (every tap its own group, line
    0). ``groups`` halos, each ``ext`` lines of the phase; tap k reads group
    ``tap_group[k]`` from line ``tap_line[k]`` on; group g starts at input
    line x0 s + ``base[g]``; its ``ext`` lines lie ``estride`` apart, over
    ``box`` input elements."""
    phase: bool
    groups: int
    ext: int
    span: int
    base: tuple
    tap_group: tuple
    tap_line: tuple
    estride: int
    box: int

    @property
    def fits(self) -> bool:
        """Whether the route takes the dimension: a halo of at most MAX_BOX
        input elements, a stride of at most MAX_TRAVERSAL between its lines
        (one line needs none)."""
        return self.box <= MAX_BOX and (self.box == 1 or self.estride <= MAX_TRAVERSAL)


def strided_dim(K: int, s: int, d: int, p: int, t: int, phase: bool) -> StridedDim:
    """The StridedDim of a dimension with K taps, stride s, dilation d and
    padding p, for tiles of t outputs."""
    offs = [k * d - p for k in range(K)]
    if not phase:
        return StridedDim(False, K, t, 0, tuple(offs), tuple(range(K)), (0,) * K,
                          s if t > 1 else 1, t * s if t > 1 else 1)
    phases = sorted({o % s for o in offs})
    amin = {f: min(o // s for o in offs if o % s == f) for f in phases}
    lines = tuple(o // s - amin[o % s] for o in offs)
    ext = t + max(lines)
    return StridedDim(True, len(phases), ext, max(lines),
                      tuple(amin[f] * s + f for f in phases),
                      tuple(phases.index(o % s) for o in offs), lines, s, ext * s)


class StridedLayout(NamedTuple):
    """The strided route's shared memory (csrc/int8_conv_strided.cu's
    entry point): a 16-channel slab's pitch (the halo of one group, and
    what the ST_TILE positions' taps read past it), a stage (``groups``
    halos of two slabs, then two slabs of ``taps`` weight boxes of bn rows),
    the stages, the int32 tile of this rank's own rows (ST_TILE rows of bn +
    ST_PAD words) in the same memory, the taps' and groups' tables after
    them, the slots of the other cs - 1 ranks' rows of this rank's share,
    and the launch's dynamic shared memory (1024 bytes of it align the
    base)."""
    slab_pitch: int
    groups: int
    taps: int
    stage_bytes: int
    stages: int
    tile_bytes: int
    smem: int


def strided_units(dh: StridedDim, dw: StridedDim, gu: int) -> list:
    """The taps (r, q) of each unit of ``gu`` groups (group g = gh dw.groups
    + gw, a unit the groups [u gu, (u + 1) gu)): a K step of 32 channels
    runs its units in turn."""
    G = dh.groups * dw.groups
    units = [[] for _ in range(math.ceil(G / gu))]
    for r, gh in enumerate(dh.tap_group):
        for q, gw in enumerate(dw.tap_group):
            units[(gh * dw.groups + gw) // gu].append((r, q))
    return units


def strided_layout(dh: StridedDim, dw: StridedDim, gu: int, bn: int, units_per_rank: int,
                   cs: int) -> StridedLayout:
    """The shared memory of a strided launch; the kernel's own arithmetic."""
    hw = dw.ext
    rows = max(dh.ext * hw, ST_TILE + dh.span * hw + dw.span)
    slab_pitch = _round_up(rows * HALO_SLAB, 128)
    taps = max(len(u) for u in strided_units(dh, dw, gu))
    stage_bytes = _round_up(gu * 2 * slab_pitch + taps * 2 * bn * HALO_SLAB, 1024)
    tile_bytes = ST_TILE * (bn + ST_PAD) * 4
    # each tap's (group, first position, r, q) and each group's offsets
    tables = _round_up(16 * len(dh.tap_group) * len(dw.tap_group) + 8 * dh.groups * dw.groups,
                       16)
    # the other ranks' rows of this rank's share: cs - 1 slots of ceil(ST_TILE / cs) rows
    recv = (cs - 1) * math.ceil(ST_TILE / cs) * bn * 4
    stages = max(1, min(units_per_rank, ST_STAGES,
                        (ST_SMEM - 1024 - tables - recv) // stage_bytes))
    smem = 1024 + max(stages * stage_bytes, tile_bytes) + tables + recv
    return StridedLayout(slab_pitch, gu, taps, stage_bytes, stages, tile_bytes, smem)


def _strided_tiles(OH: int, OW: int, KH: int, KW: int, geo: tuple, phase_h: bool,
                   phase_w: bool):
    """The th x tw rectangle of the strided route for these modes: th hw <=
    ST_TILE positions (hw = the W halo's lines), both dimensions within
    StridedDim.fits; the fewest tiles, then the fewest halo positions
    loaded, then the widest (the longest runs of a halo's rows). ->
    (th, tw, dim_h, dim_w), or None where no rectangle fits."""
    ph, pw, sh, sw, dh_, dw_ = geo
    best = None
    for tw in range(1, min(OW, ST_TILE) + 1):
        dw = strided_dim(KW, sw, dw_, pw, tw, phase_w)
        if not dw.fits or dw.ext > ST_TILE:
            continue
        th = min(OH, ST_TILE // dw.ext)
        while th > 0 and not strided_dim(KH, sh, dh_, ph, th, phase_h).fits:
            th -= 1
        if th == 0:
            continue
        dh = strided_dim(KH, sh, dh_, ph, th, phase_h)
        tiles = math.ceil(OH / th) * math.ceil(OW / tw)
        key = (tiles, tiles * dh.ext * dw.ext * dh.groups * dw.groups, -tw)
        if best is None or key < best[0]:
            best = (key, th, tw, dh, dw)
    return None if best is None else best[1:]


def _strided_plan(B: int, OH: int, OW: int, C: int, N: int, KH: int, KW: int, geo: tuple,
                  sms: int) -> Int8ConvPlan:
    """The "strided" plan (csrc/int8_conv_strided.cu): along each dimension
    a halo a phase where its stride is at most MAX_TRAVERSAL and the halo
    fits (else a box a tap, and one output a tile where the stride is
    larger); the rectangle of _strided_tiles; N tiles of the narrowest
    HALO_WIDTHS that holds N (64 above it); K as ceil(C / 32) steps of 32
    channels, split over the blocks of a cluster of up to MAX_CLUSTER (as
    many as the SMs hold, every cluster at once: clusters_at_once), each
    rank a contiguous range of ``per_split`` steps; a step's groups in
    units of ``phases[2]`` groups (all of them where a stage fits), and as
    many stages as the rank's units, up to ST_STAGES, as ST_SMEM holds.
    One block a (tile, N tile, rank): ``blocks`` of them. ``phases`` is
    (phase_h, phase_w, groups a unit). Raises ValueError where no tiling
    fits."""
    _, _, sh, sw, _, _ = geo
    bn = next((w for w in HALO_WIDTHS if w >= N), HALO_WIDTHS[-1])
    n_tiles = math.ceil(N / bn)
    if n_tiles > 65535:
        raise ValueError(f"N = {N}: more output channels than the grid holds")
    steps = math.ceil(C / ST_STEP)
    for phase_h, phase_w in ((True, True), (True, False), (False, True), (False, False)):
        if (phase_h and sh > MAX_TRAVERSAL) or (phase_w and sw > MAX_TRAVERSAL):
            continue
        found = _strided_tiles(OH, OW, KH, KW, geo, phase_h, phase_w)
        if found is None:
            continue
        th, tw, dh, dw = found
        m_tiles = B * math.ceil(OH / th) * math.ceil(OW / tw)
        tiles = m_tiles * n_tiles
        cs = max(1, min(MAX_CLUSTER, steps, sms // tiles))
        while cs > 1 and tiles > clusters_at_once(cs, sms):
            cs -= 1  # every cluster on the card at once
        per_split = math.ceil(steps / cs)
        cs = math.ceil(steps / per_split)  # no rank left without channels
        if m_tiles * cs >= 2 ** 31:
            continue
        G = dh.groups * dw.groups
        for gu in range(G, 0, -1):
            layout = strided_layout(dh, dw, gu, bn, per_split * math.ceil(G / gu), cs)
            if layout.smem <= ST_SMEM:
                return Int8ConvPlan("strided", ST_TILE, bn, ST_STEP, (m_tiles, n_tiles, cs), th,
                                    tw, steps, per_split, tiles * cs, layout.stages, False,
                                    (phase_h, phase_w, gu))
    raise ValueError(f"window {KH}x{KW} with geometry {geo}: no strided tiling fits the "
                     "route's halo limits and the shared memory")


class HaloLayout(NamedTuple):
    """The halo route's shared memory (csrc/int8_conv_halo.cu::layout): the
    16-channel slabs of a halo chunk and a slab's pitch (128-byte aligned
    for TMA), a halo stage, the weights (resident or the ring), an output
    segment's staging pitch and the staging, the epilogue's factors of
    every output channel, and the launch's dynamic shared memory (1024
    bytes of it align the base)."""
    slabs: int
    slab_pitch: int
    halo_bytes: int
    weight_bytes: int
    seg_pitch: int
    stage_bytes: int
    table_bytes: int
    smem: int


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def halo_layout(th: int, tw: int, KH: int, KW: int, C: int, N: int, bn: int, stages: int,
                resident: bool) -> HaloLayout:
    """The shared memory of a halo launch; the kernel's own arithmetic."""
    nc = math.ceil(C / HALO_CHUNK)
    # a chunk's slabs: 8, or C's own rounded up to an even count (a 32-channel step)
    slabs = HALO_CHUNK // HALO_SLAB if nc > 1 else (C // HALO_SLAB + 1) // 2 * 2
    # a slab: the halo, and what the taps of the TILE positions read past it
    hw = halo_width(tw, KW)
    slab_pitch = _round_up(max((th + KH - 1) * hw, TILE + (KH - 1) * hw + KW - 1) * HALO_SLAB,
                           128)
    halo_bytes = _round_up(slabs * slab_pitch, 1024)
    weight_bytes = (KH * KW * nc if resident else HALO_WSTAGES) * bn * HALO_CHUNK
    # a segment: an output row of the tile where one N tile holds N, else a
    # pixel's bn channels; 4-byte values at most, shifted by up to 15 bytes
    rows = math.ceil(N / bn) == 1
    seg_pitch = _round_up((tw * N if rows else bn) * 4, 16) + 16
    stage_bytes = (th if rows else th * tw) * seg_pitch
    table_bytes = _round_up(N * 8, 128)  # (dequant, bias) of each output channel
    smem = 1024 + stages * halo_bytes + weight_bytes + stage_bytes + table_bytes
    return HaloLayout(slabs, slab_pitch, halo_bytes, weight_bytes, seg_pitch, stage_bytes,
                      table_bytes, smem)


def _halo_plan(B: int, H: int, W: int, C: int, N: int, KH: int, KW: int, pad: int,
               sms: int = SMS) -> Int8ConvPlan:
    """The "halo" plan of a conv (C a multiple of 16): the rectangle of
    _halo_rectangle, N tiles of the narrowest HALO_WIDTHS that holds N (64
    above it), the weights resident where one N tile holds N and they fit,
    and as many halo stages (2 to HALO_STAGES) as HALO_SMEM holds;
    persistent blocks, HALO_BLOCKS_PER_SM an SM or one per unit. It runs
    any stride-1 window, so a test may hand it a 1x1 conv as well. Raises
    ValueError for a halo larger than a TMA box or than the shared
    memory."""
    OH, OW = H + 2 * pad - KH + 1, W + 2 * pad - KW + 1
    bn = next((w for w in HALO_WIDTHS if w >= N), HALO_WIDTHS[-1])
    n_tiles = math.ceil(N / bn)
    th, tw = _halo_rectangle(OH, OW, KH, KW)
    if th + KH - 1 > 256:
        raise ValueError(f"window {KH}x{KW}: its halo exceeds a TMA box (256 rows)")
    steps = KH * KW * math.ceil(C / HALO_CHUNK)
    for resident in (True, False) if n_tiles == 1 else (False,):
        for stages in range(HALO_STAGES, 1, -1):
            if halo_layout(th, tw, KH, KW, C, N, bn, stages, resident).smem <= HALO_SMEM:
                m_tiles = B * math.ceil(OH / th) * math.ceil(OW / tw)
                units = m_tiles * n_tiles
                return Int8ConvPlan("halo", TILE, bn, HALO_CHUNK, (m_tiles, n_tiles, 1), th, tw,
                                    steps, steps, min(units, HALO_BLOCKS_PER_SM * sms), stages,
                                    resident)
    raise ValueError(f"window {KH}x{KW} at C = {C}: its halo does not fit in shared memory")


def _pointwise_plan(M: int, C: int, N: int, sms: int) -> Int8ConvPlan:
    """The "pointwise" or "dot" plan of a 1x1 conv of M pixels."""
    if M <= DOT_MAX_M and M * C <= DOT_MAX_BYTES:
        return _dot_plan(M, C, N)
    if math.ceil(N / PW_WIDTHS[-1]) > 65535:
        raise ValueError(f"N = {N}: more output channels than the grid holds")
    return _pointwise_cheapest(M, C, N, sms)


def _pointwise_cheapest(M: int, C: int, N: int, sms: int) -> Int8ConvPlan:
    """The pointwise plan whose N tile costs least by _pointwise_cost."""
    plans = [_pointwise_tiles(M, C, N, bn, sms) for bn in PW_WIDTHS]
    return min(plans, key=lambda p: (_pointwise_cost(p, sms), p.bn))


def _pointwise_tiles(M: int, C: int, N: int, bn: int, sms: int) -> Int8ConvPlan:
    """The pointwise plan of a 1x1 conv with N tiles of ``bn`` columns."""
    n_tiles = math.ceil(N / bn)
    bm = 128 if math.ceil(M / 64) * math.ceil(N / PW_WIDTHS[-1]) >= sms else 64
    m_tiles = math.ceil(M / bm)
    tiles = m_tiles * n_tiles
    units = math.ceil(C / PW_BK)
    cs = max(1, min(MAX_CLUSTER, sms // tiles, units // (PW_MIN_RANGE // PW_BK)))
    while cs > 1 and tiles > clusters_at_once(cs, sms):
        cs -= 1  # every cluster on the card at once
    per_split = math.ceil(units / cs)
    cs = math.ceil(units / per_split)  # no rank left without channels
    return Int8ConvPlan("pointwise", bm, bn, PW_BK, (m_tiles, n_tiles, cs), 0, 0, units,
                        per_split, tiles * cs)


def clusters_at_once(cs: int, sms: int) -> int:
    """The clusters of ``cs`` blocks (one a SM) a card of ``sms`` SMs runs at
    once: a cluster runs inside one GPC, and each of the GPCS holds
    sms // GPCS SMs or more."""
    return sms if cs == 1 else GPCS * (sms // GPCS // cs)


def _pointwise_cost(plan: Int8ConvPlan, sms: int) -> float:
    """The pointwise plan's time in ns by a model of its two costs that
    depend on the tiles: each consumer thread quantizes bm * range / 256
    values, and each rank of a cluster hands the others (cs - 1) / cs of
    its int32 partial tile through distributed shared memory; blocks run
    in waves of one per SM."""
    cs = plan.splits
    values = plan.bm * plan.per_split * plan.bk / 256
    handed = (cs - 1) / cs * plan.bm * (plan.bn + 8) * 4
    waves = math.ceil(plan.blocks / sms)
    return waves * (values * PW_QUANTIZE_NS + handed * PW_REDUCE_NS_PER_BYTE)


def _dot_plan(M: int, C: int, N: int) -> Int8ConvPlan:
    """The "dot" plan of a 1x1 conv of M <= DOT_MAX_M pixels: one
    16-channel chunk a lane, up to 128 lanes (four warps) a channel."""
    chunks = math.ceil(C / DOT_CHUNK)
    if chunks <= 32:
        lanes = 1 << max(0, (chunks - 1).bit_length())  # a power of two up to a warp
        per_block = DOT_THREADS // lanes
    else:
        lanes = 32 * min(DOT_MAX_WARPS, math.ceil(chunks / 32))
        per_block = DOT_GROUPS
    blocks = math.ceil(N / per_block)
    return Int8ConvPlan("dot", M, per_block, DOT_CHUNK, (1, blocks, lanes), 0, 0, chunks,
                        math.ceil(chunks / lanes), blocks)


# ---------------------------------------------------------------------- conv

def int8_conv_plain(xq: torch.Tensor, weight: torch.Tensor,
                    weight_scale: torch.Tensor, x_scale: torch.Tensor,
                    bias: Optional[torch.Tensor], padding,
                    out_dtype: torch.dtype, stride=1, dilation=1,
                    groups: int = 1) -> torch.Tensor:
    """The plain version: lax.conv_general_dilated's int32 accumulators in
    float64 on the int8 values, then nn/layers.py:110-113 in torch ops."""
    acc = F.conv2d(xq.double(), weight.double(), None, stride, padding, dilation, groups)
    # the float64 sums are exact integers; round() only guards against an
    # algorithm that transforms its inputs (FFT, Winograd)
    acc = acc.round().to(torch.int32).contiguous(memory_format=CL)
    if out_dtype == torch.int32:
        return acc
    dequant = weight_scale if x_scale.dim() == 1 else x_scale * weight_scale
    y = (acc.float() * dequant.reshape(1, -1, 1, 1)).to(out_dtype)
    if bias is not None:
        y = y + bias.reshape(1, -1, 1, 1)
    return y.contiguous(memory_format=CL)


def int8_conv(xq: torch.Tensor, weight: torch.Tensor, weight_scale: torch.Tensor,
              x_scale: torch.Tensor, bias: Optional[torch.Tensor] = None,
              padding=0, out_dtype: torch.dtype = torch.bfloat16, *, stride=1,
              groups: int = 1, dilation=1) -> torch.Tensor:
    """int8 (B, C, H, W) channels_last, int8 OIHW (I = C / groups)
    channels_last weights -> (B, O, OH, OW) channels_last in ``out_dtype``
    (f32, bf16, or int32 for the raw accumulators). ``x_scale`` is the
    scale xq was made with. On the card it runs the route
    ``int8_conv_plan`` picks, once a group. Counts its kernel launches in
    ``int8_conv.launches`` and by route in ``int8_conv.route_launches``."""
    if xq.dtype != torch.int8 or weight.dtype != torch.int8:
        raise TypeError(f"xq and weight must be int8, got {xq.dtype}, {weight.dtype}")
    return _conv(xq, weight, weight_scale, x_scale, bias, padding, out_dtype, stride, dilation,
                 groups)


def _conv(x: torch.Tensor, weight: torch.Tensor, weight_scale: torch.Tensor,
          x_scale: torch.Tensor, bias: Optional[torch.Tensor], padding,
          out_dtype: torch.dtype, stride=1, dilation=1, groups: int = 1) -> torch.Tensor:
    """int8_conv and int8_conv2d: ``x`` is int8 (quantized with x_scale) or
    f32/bf16, which the "pointwise" and "dot" routes quantize as they load
    it and the other routes after int8_quantize."""
    if weight.dtype != torch.int8:
        raise TypeError(f"weight must be int8, got {weight.dtype}")
    if out_dtype not in _OUT_KIND:
        raise TypeError(f"out_dtype must be one of {tuple(_OUT_KIND)}, got {out_dtype}")
    quantized = x.dtype == torch.int8
    _check_nhwc(x, "xq" if quantized else "x")
    _check_nhwc(weight, "weight")
    geo = geometry(padding, stride, dilation)
    B, C, H, W = x.shape
    N, _, KH, KW = weight.shape
    if groups < 1 or C % groups or N % groups or weight.shape[1] * groups != C:
        raise ValueError(f"weight {tuple(weight.shape)} with groups={groups} does not take "
                         f"{C} channels")
    if weight_scale.dtype != torch.float32 or weight_scale.shape != (N,):
        raise TypeError(f"weight_scale must be f32 ({N},), got "
                        f"{weight_scale.dtype} {tuple(weight_scale.shape)}")
    _check_scale(x_scale, C, x.device)
    if bias is not None and out_dtype != torch.int32 and (
            bias.dtype != out_dtype or bias.shape != (N,)):
        raise TypeError(f"bias must be {out_dtype} ({N},), got {bias.dtype} "
                        f"{tuple(bias.shape)}")
    if any(t.device != x.device for t in (weight, weight_scale)):
        raise ValueError("x, weight and scales must be on one device")
    if x.device.type == "cpu":
        xq = x if quantized else int8_quantize_plain(x, x_scale)
        return int8_conv_plain(xq, weight, weight_scale, x_scale, bias, geo[:2], out_dtype,
                               geo[2:4], geo[4:], groups)
    if x.device.type != "cuda":
        raise ValueError(f"no int8 conv for device {x.device}")
    index = x.get_device()
    if index != torch.cuda.current_device():  # the kernels launch on the current device
        with torch.cuda.device(index):
            return _conv(x, weight, weight_scale, x_scale, bias, padding, out_dtype, stride,
                         dilation, groups)
    OH, OW = out_size(H, W, KH, KW, geo)
    if OH <= 0 or OW <= 0:
        raise ValueError(f"window {KH}x{KW} larger than the padded input {H}x{W}")
    if groups > 1:  # one launch a group, on its channels
        cg, ng = C // groups, N // groups
        per_channel = x_scale.dim() == 1
        outs = [_conv(x[:, g * cg:(g + 1) * cg].contiguous(memory_format=CL),
                      weight[g * ng:(g + 1) * ng], weight_scale[g * ng:(g + 1) * ng],
                      x_scale[g * cg:(g + 1) * cg] if per_channel else x_scale,
                      None if bias is None else bias[g * ng:(g + 1) * ng], padding, out_dtype,
                      stride, dilation)
                for g in range(groups)]
        return torch.cat(outs, dim=1).contiguous(memory_format=CL)
    Cp = padded_channels(C)
    if Cp != C:  # the kernels copy 16 channels at a time; zeros add nothing
        x, weight = pad_channels(x, Cp), pad_channels(weight, Cp)
        if x_scale.dim() == 1:
            x_scale = F.pad(x_scale, (0, Cp - C), value=1.0)
        C = Cp
    plan = int8_conv_plan(B, H, W, C, N, KH, KW, geo[:2], _sm_count(index), geo[2:4], geo[4:])
    if not quantized and plan.route not in FUSED_ROUTES:
        x = int8_quantize(x, x_scale)
    return _launch(plan, x, weight, weight_scale, x_scale, bias, geo[:2], out_dtype,
                   geo[2:4], geo[4:])


def int8_conv2d_launches(x_shape, weight_shape, padding=0, stride=1, dilation=1,
                         groups: int = 1, sms: int = SMS) -> Dict[str, int]:
    """The kernel launches ``int8_conv2d`` makes on the card for a float
    input of NCHW ``x_shape`` and an OIHW ``weight_shape`` -> {"quantize": n,
    route: n}: one conv a group on the route ``int8_conv_plan`` gives its
    channels (padded to 16), each after a quantize but on the "pointwise"
    and "dot" routes. Pure Python, as _conv decides."""
    B, C, H, W = x_shape
    N, _, KH, KW = weight_shape
    geo = geometry(padding, stride, dilation)
    plan = int8_conv_plan(B, H, W, padded_channels(C // groups), N // groups, KH, KW, geo[:2],
                          sms, geo[2:4], geo[4:])
    out = {"quantize": 0 if plan.route in FUSED_ROUTES else groups}
    out[plan.route] = groups
    return out


def _reciprocal(x_scale: torch.Tensor) -> torch.Tensor:
    """1 / x_scale in float64, correctly rounded: the "pointwise" and "dot"
    routes quantize with it (csrc/int8_common.cuh::quantize_rcp, the same
    values as the division). In an eager run it is kept on the scale tensor
    while its address and version are unchanged, so a static scale costs
    one launch, once; a trace records the reciprocal in the graph (a trace
    cannot see the kept one). An inference tensor (made under
    torch.inference_mode, as a per-channel scale padded to 16 channels
    there is) has no version to key on: its reciprocal is not kept."""
    if not _eager() or x_scale.is_inference():
        return torch.reciprocal(x_scale.double())
    key = (x_scale.data_ptr(), x_scale._version)
    kept = getattr(x_scale, "_rcp", None)
    if kept is not None and kept[0] == key:
        return kept[1]
    rcp = torch.reciprocal(x_scale.double()).contiguous()
    x_scale._rcp = (key, rcp)
    return rcp


def _launch(plan: Int8ConvPlan, x: torch.Tensor, weight: torch.Tensor,
            weight_scale: torch.Tensor, x_scale: torch.Tensor,
            bias: Optional[torch.Tensor], pad, out_dtype: torch.dtype, stride=1,
            dilation=1) -> torch.Tensor:
    """Runs ``plan`` on CUDA tensors of the current device that _conv has
    checked (C a multiple of 16, groups 1) through the route's operator,
    ``torch.ops.avp.int8_conv_<route>``: x int8, or f32/bf16 on the
    "pointwise" and "dot" routes. _conv passes the plan of the shape; a
    test may pass another plan of it (fewer persistent blocks, one split,
    the halo route for a 1x1 conv)."""
    if x.dtype != torch.int8 and plan.route not in FUSED_ROUTES:
        raise TypeError(f"the {plan.route} route takes an int8 input, got {x.dtype}")
    torch_ops.load()
    kind = _OUT_KIND[out_dtype]
    b = bias if out_dtype != torch.int32 else None
    scale = x_scale.contiguous()
    m_tiles, n_tiles, splits = plan.grid
    if plan.route in FUSED_ROUTES:
        rcp = None if x.dtype == torch.int8 else _reciprocal(scale)
        if plan.route == "pointwise":
            out = torch.ops.avp.int8_conv_pointwise(
                x, weight, weight_scale, scale, rcp, b,
                [plan.bm, plan.bn, m_tiles, n_tiles, splits, plan.per_split * plan.bk], kind)
        else:
            out = torch.ops.avp.int8_conv_dot(x, weight, weight_scale, scale, rcp, b, splits,
                                              kind)
    elif plan.route == "halo":
        ph = geometry(pad)[0]
        out = torch.ops.avp.int8_conv_halo(
            x, weight, weight_scale, scale, b, ph,
            [plan.th, plan.tw, plan.bn, m_tiles, n_tiles, plan.blocks, plan.stages,
             int(plan.resident)], kind)
    elif plan.route == "strided":
        phase_h, phase_w, gu = plan.phases
        out = torch.ops.avp.int8_conv_strided(
            x, weight, weight_scale, scale, b, list(geometry(pad, stride, dilation)),
            [plan.th, plan.tw, plan.bn, m_tiles, n_tiles, splits, plan.per_split, plan.stages,
             int(phase_h), int(phase_w), gu], kind)
    else:
        route = getattr(torch.ops.avp, f"int8_conv_{plan.route}")
        out = route(x, weight, weight_scale, scale, b, list(geometry(pad)),
                    [plan.th, plan.tw, m_tiles, n_tiles, splits, plan.per_split, plan.blocks],
                    kind)
    if _eager():
        int8_conv.launches += 1
        int8_conv.route_launches[plan.route] += 1
    return out


int8_conv.launches = 0
int8_conv.route_launches = dict.fromkeys(ROUTES, 0)


def int8_conv2d(x: torch.Tensor, weight: torch.Tensor, weight_scale: torch.Tensor,
                x_scale: torch.Tensor, bias: Optional[torch.Tensor] = None,
                padding=0, *, stride=1, dilation=1, groups: int = 1,
                plain: bool = False) -> torch.Tensor:
    """The whole int8 conv of nn/layers.py:81-113 on a float input, in the
    input's dtype: quantize, then conv with the dequant epilogue; on the
    card a 1x1 stride-1 conv ("pointwise" and "dot" routes) is one launch
    that quantizes as it loads, the others int8_quantize and int8_conv.
    ``plain=True`` runs the plain versions on any device (a reference run
    selects it explicitly; the kernels never fall back to it)."""
    if plain:
        geo = geometry(padding, stride, dilation)
        xq = int8_quantize_plain(x, x_scale)
        return int8_conv_plain(xq, weight, weight_scale, x_scale, bias, geo[:2], x.dtype,
                               geo[2:4], geo[4:], groups)
    if x.dtype not in IN_DTYPES:
        raise TypeError(f"x must be one of {IN_DTYPES}, got {x.dtype}")
    return _conv(x, weight, weight_scale, x_scale, bias, padding, x.dtype, stride, dilation,
                 groups)


# ------------------------------------------------------------ conv transpose

def _check_transpose_weight(weight: torch.Tensor) -> None:
    """(I, O, kh, kw) int8 over a (kh, kw, O, I) buffer, the layout of
    nn/layers.py::Int8ConvTranspose2d: each (i, j, o) row of I channels
    contiguous, the GEMM's (kh kw O, I) weights."""
    if weight.dtype != torch.int8 or weight.dim() != 4:
        raise TypeError(f"weight must be 4-D int8, got {weight.dtype} {tuple(weight.shape)}")
    if not weight.permute(2, 3, 1, 0).is_contiguous():
        raise ValueError(
            "the int8 conv-transpose weight must lie as (kh, kw, O, I) in memory (I "
            f"innermost); got strides {weight.stride()} for shape {tuple(weight.shape)}: "
            "was the module moved with memory_format=torch.channels_last?")


def int8_conv_transpose_plain(xq: torch.Tensor, weight: torch.Tensor,
                              weight_scale: torch.Tensor, x_scale: torch.Tensor,
                              bias: Optional[torch.Tensor],
                              out_dtype: torch.dtype) -> torch.Tensor:
    """The plain version: the accumulators in float64 on the int8 values
    (exact: |acc| <= 127^2 * C < 2^53), depth to space, then nn/layers.py:
    206-208 in torch ops: cast(f32(acc) * (sx * w_scale)) + bias."""
    B, C, h, w = xq.shape
    _, O, kh, kw = weight.shape
    acc = torch.einsum("bchw,coij->bhiwjo", xq.double(), weight.double())
    acc = acc.round().to(torch.int32).reshape(B, h * kh, w * kw, O)
    if out_dtype == torch.int32:
        return acc.permute(0, 3, 1, 2)
    y = (acc.float() * (x_scale * weight_scale)).to(out_dtype)
    if bias is not None:
        y = y + bias
    return y.permute(0, 3, 1, 2)


@functools.lru_cache(maxsize=1024)
def int8_conv_transpose_plan(B: int, h: int, w: int, C: int, O: int, kh: int, kw: int,
                             sms: int = SMS) -> Int8ConvPlan:
    """The "d2s" plan of an int8 transposed conv with kernel == stride: the
    wgmma kernel's plan of the 1x1 conv of the (B, h, w, C) int8
    activation (C a multiple of 16) with N tiled within each of the kh kw
    output segments, kh kw ceil(O / 128) N tiles of 128; the rectangle of
    _whole_rows_rectangle and the wgmma route's K splits."""
    if min(B, h, w, C, O, kh, kw) <= 0 or padded_channels(C) != C:
        raise ValueError(f"no int8 conv-transpose of B={B} h={h} w={w} C={C} O={O} "
                         f"kernel {kh}x{kw}")
    if C > MAX_K:
        raise ValueError(f"K = {C} > {MAX_K}: int32 accumulators could overflow")
    if B * h * w >= 2 ** 31 or kh * kw * O >= 2 ** 31:
        raise ValueError(f"M = {B * h * w}, N = {kh * kw * O}: more than an int32 indexes")
    th, tw = _whole_rows_rectangle(h, w)
    m_tiles = B * (h // th) * math.ceil(w / tw)
    n_tiles = kh * kw * math.ceil(O / TILE)
    iters = math.ceil(C / TILE)
    splits, per_split = _k_splits(m_tiles * n_tiles, iters, sms)
    return Int8ConvPlan("d2s", TILE, TILE, TILE, (m_tiles, n_tiles, splits), th, tw, iters,
                        per_split, min(m_tiles * n_tiles * splits, sms))


def d2s_tma_store(O: int, out_dtype: torch.dtype) -> bool:
    """Whether the d2s epilogue stores through the output's 5-D TMA map: its
    strides (O outputs a pixel) must be multiples of 16 bytes, and O must
    hold a box (128 bytes of outputs); else it stores value by value."""
    nbytes = O * _ELEM_BYTES[out_dtype]
    return nbytes % 16 == 0 and nbytes >= 128


def int8_conv_transpose(x: torch.Tensor, weight: torch.Tensor, weight_scale: torch.Tensor,
                        x_scale: torch.Tensor, bias: Optional[torch.Tensor] = None,
                        out_dtype: Optional[torch.dtype] = None, *,
                        plain: bool = False) -> torch.Tensor:
    """The int8 transposed conv of nn/layers.py:187-208 with kernel ==
    stride and padding 0. ``x`` (B, C, h, w) channels_last, f32 or bf16,
    quantized with the scalar ``x_scale``; ``weight`` int8 (C, O, kh, kw)
    over a (kh, kw, O, C) buffer; ``weight_scale`` f32 (O,); ``bias`` (O,)
    in ``out_dtype`` (the input's dtype by default; int32 gives the
    accumulators) -> (B, O, h kh, w kw) channels_last. On a CUDA tensor
    two launches, int8_quantize and the wgmma kernel's "d2s" variant (the
    operator ``avp::int8_conv_d2s``), or an error; on a CPU tensor, or with
    ``plain=True``, the plain version.
    Counts the d2s launches in ``int8_conv_transpose.launches``."""
    if out_dtype is None:
        out_dtype = x.dtype
    if x.dtype not in IN_DTYPES:
        raise TypeError(f"x must be one of {IN_DTYPES}, got {x.dtype}")
    if out_dtype not in _OUT_KIND:
        raise TypeError(f"out_dtype must be one of {tuple(_OUT_KIND)}, got {out_dtype}")
    _check_nhwc(x, "x")
    _check_transpose_weight(weight)
    B, C, h, w = x.shape
    I, O, kh, kw = weight.shape
    if I != C:
        raise ValueError(f"weight {tuple(weight.shape)} does not take {C} channels")
    if weight_scale.dtype != torch.float32 or weight_scale.shape != (O,):
        raise TypeError(f"weight_scale must be f32 ({O},), got "
                        f"{weight_scale.dtype} {tuple(weight_scale.shape)}")
    if x_scale.dim() != 0:
        raise ValueError("the int8 conv-transpose takes one scalar input scale "
                         f"(nn/layers.py:197-200), got {tuple(x_scale.shape)}")
    _check_scale(x_scale, C, x.device)
    if bias is not None and out_dtype != torch.int32 and (
            bias.dtype != out_dtype or bias.shape != (O,)):
        raise TypeError(f"bias must be {out_dtype} ({O},), got {bias.dtype} "
                        f"{tuple(bias.shape)}")
    if any(t.device != x.device for t in (weight, weight_scale)):
        raise ValueError("x, weight and scales must be on one device")
    if plain or x.device.type == "cpu":
        return int8_conv_transpose_plain(int8_quantize_plain(x, x_scale), weight,
                                         weight_scale, x_scale,
                                         bias if out_dtype != torch.int32 else None, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"no int8 conv-transpose for device {x.device}")
    index = x.get_device()
    if index != torch.cuda.current_device():  # the kernels launch on the current device
        with torch.cuda.device(index):
            return int8_conv_transpose(x, weight, weight_scale, x_scale, bias, out_dtype)
    Cp = padded_channels(C)
    if Cp != C:  # the kernel copies 16 channels at a time; zeros add nothing
        x = pad_channels(x, Cp)
        weight = F.pad(weight.permute(2, 3, 1, 0), (0, Cp - C)).permute(3, 2, 0, 1)
    plan = int8_conv_transpose_plan(B, h, w, Cp, O, kh, kw, _sm_count(index))
    xq = int8_quantize(x, x_scale)
    m_tiles, n_tiles, splits = plan.grid
    out = torch.ops.avp.int8_conv_d2s(
        xq, weight, weight_scale, x_scale, bias if out_dtype != torch.int32 else None,
        [plan.th, plan.tw, m_tiles, n_tiles, splits, plan.per_split, plan.blocks],
        d2s_tma_store(O, out_dtype), _OUT_KIND[out_dtype])
    if _eager():
        int8_conv_transpose.launches += 1
    return out


int8_conv_transpose.launches = 0
