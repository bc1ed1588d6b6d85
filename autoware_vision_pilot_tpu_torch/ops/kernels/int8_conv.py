"""Int8 convolution: the wrappers of csrc/int8_conv.cu,
csrc/int8_conv_sm90.cu and csrc/int8_pointwise.cu, the port of the int8
branch of autoware_vision_pilot_tpu/nn/layers.py::Conv2d (:81-113), which
the JAX package leaves to XLA.

Kernels, each with its wrapper, its plain PyTorch version and its count of
launches:

- ``int8_quantize``: xq = clip(round_half_even(f32(x) / sx), -127, 127),
  sx a scalar or one scale per input channel (nn/layers.py:103-108).
- ``int8_conv``: the int32 accumulators of conv(xq, w), then
  ``cast(f32(acc) * dequant) + bias`` with dequant = sx * w_scale for a
  scalar sx, w_scale alone for a per-channel one, which the weights carry
  (:110-113); or the accumulators themselves for ``out_dtype=torch.int32``.
  ``int8_conv_plan`` picks one of five routes: "wgmma" (TMA loads and
  wgmma on 128x128 tiles), "splitk" (the same kernel over slices of K; the
  split that finishes a tile last runs its epilogue), "pointwise" (1x1
  convs: mma.sync, K split over the blocks of a cluster), "dot" (1x1 convs
  of at most 8 pixels, the M = 1 SE convs: one warp per output channel)
  and "mma" (mma.sync, for windows larger than 1x1 with C < 128).
  ``int8_conv.launches`` counts every conv launch;
  ``int8_conv.route_launches`` counts them by route.

``int8_conv2d`` is the whole conv on a float input: on the "pointwise"
and "dot" routes one launch that quantizes as it loads (bit-equal to the
quantize kernel: it multiplies by 1 / sx in float64, which ``_reciprocal``
keeps on the scale tensor), on the others quantize, then conv. On a CUDA
tensor a wrapper launches its kernel or raises; on a CPU tensor it runs
the plain version, which computes the conv in float64 on the int8 values
(exact: |acc| <= 127^2 * K < 2^53) and the same epilogue in torch ops.
Every scale is a tensor on the input's device, so no launch waits for the
host.

The kernels cover what the selective-int8 path needs: groups 1, stride 1,
dilation 1, any window with symmetric padding, NHWC (channels_last) inputs
and (O, kh, kw, I) weights, i.e. OIHW weights in channels_last memory.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ...kernels import build

CL = torch.channels_last
IN_DTYPES = (torch.float32, torch.bfloat16)
_OUT_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
ROUTES = ("wgmma", "splitk", "mma", "pointwise", "dot")
FUSED_ROUTES = ("pointwise", "dot")  # they take a float input and quantize it
_IN_KIND = {torch.int8: 0, torch.bfloat16: 1, torch.float32: 2}
TILE = 128      # the wgmma route's BM = BN = BK (csrc/int8_conv_sm90.cu)
MMA_BK = 64     # the mma.sync route's K step (csrc/int8_conv.cu)
PW_BN = 64      # the pointwise route's output channels a tile (csrc/int8_pointwise.cu)
PW_BK = 32      # its K ranges are multiples of 32 channels, one mma.sync k
MAX_CLUSTER = 8  # the portable thread-block cluster size
DOT_MAX_M = 8   # the dot route's most output pixels
DOT_MAX_BYTES = 32 * 1024  # and most int8 activation bytes, held in shared memory
DOT_WARPS = 8   # its output channels a block
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


def _pad(padding) -> int:
    ph, pw = (padding, padding) if isinstance(padding, int) else tuple(padding)
    if ph != pw or ph < 0:
        raise ValueError(f"int8 conv needs one symmetric padding, got {padding}")
    return ph


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


def _check_aligned(*tensors: torch.Tensor) -> None:
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("the int8 kernels need 16-byte aligned tensors")


def _check_err(name: str, err: int) -> None:
    if err >= 100000:
        raise RuntimeError(f"{name}: the driver refused a tensor map, CUresult {err - 100000}")
    if err != 0:
        raise RuntimeError(f"{name} failed: cudaError_t {err}")


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _raw_stream(index: int) -> int:
    """The current stream of CUDA device ``index``, as the handle the C
    entry points take. torch.cuda.current_stream() builds a Stream object
    under a device guard, which costs the host more than the launch."""
    return torch._C._cuda_getCurrentRawStream(index)


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
    """(B, C, H, W) f32/bf16 channels_last -> int8 channels_last.
    Counts its kernel launches in ``int8_quantize.launches``."""
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
    B, C, H, W = x.shape
    Cp = padded_channels(C)
    if Cp != C:  # the kernel takes 16 channels a thread; the pad is cut off again
        sp = F.pad(x_scale, (0, Cp - C), value=1.0) if x_scale.dim() == 1 else x_scale
        return int8_quantize(pad_channels(x, Cp), sp)[:, :C].contiguous(memory_format=CL)
    xq = torch.empty_like(x, dtype=torch.int8, memory_format=CL)
    _check_aligned(x, xq)
    scale = x_scale.contiguous()
    err = build.load().avp_int8_quantize(
        x.data_ptr(), xq.data_ptr(), scale.data_ptr(),
        int(x_scale.dim() == 1), B * H * W, C, int(x.dtype == torch.bfloat16),
        _raw_stream(index))
    _check_err("avp_int8_quantize", err)
    int8_quantize.launches += 1
    return xq


int8_quantize.launches = 0


# ---------------------------------------------------------------------- plan

class Int8ConvPlan(NamedTuple):
    """How one int8 conv runs. ``grid`` is (M tiles, N tiles, K splits).
    The wgmma routes tile M as rectangles of ``th`` x ``tw`` output pixels
    of one image and K as ``iters`` steps of (tap r, tap s, a chunk of
    ``bk`` channels), ``per_split`` steps to a split; a unit of work is one
    (M tile, N tile, split), and each of the ``blocks`` persistent blocks
    takes every blocks-th unit. The mma route tiles M as ``bm`` flat rows
    and K in steps of ``bk`` bytes, one block per tile. The pointwise route
    tiles M as ``bm`` flat rows and N as ``bn`` channels; the K splits are
    the blocks of one cluster, and split z takes the channels
    [z * per_split * bk, (z + 1) * per_split * bk) of the ``iters * bk``;
    one block per tile and split. The dot route runs ``bn`` output
    channels a block, ``bm`` = M rows each."""
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

    @property
    def splits(self) -> int:
        return self.grid[2]


def _rectangle(OH: int, OW: int, bm: int = TILE) -> tuple:
    """The th x tw pixel rectangle (th * tw <= bm) that covers the OH x OW
    map in the fewest M tiles; the widest of those."""
    best = None
    for tw in sorted({min(OW, bm), *(w for w in (128, 64, 32, 16, 8) if w <= OW)},
                     reverse=True):
        th = min(bm // tw, OH)
        tiles = math.ceil(OH / th) * math.ceil(OW / tw)
        if best is None or tiles < best[0]:
            best = (tiles, th, tw)
    return best[1], best[2]


@functools.lru_cache(maxsize=4096)
def int8_conv_plan(B: int, H: int, W: int, C: int, N: int, KH: int, KW: int,
                   pad: int, sms: int = SMS) -> Int8ConvPlan:
    """The route, tiles, K splits and grid of a stride-1 int8 conv of a
    (B, H, W, C) NHWC input (C a multiple of 16) with N output channels, a
    KH x KW window and ``pad`` zeros on each side, on a card of ``sms`` SMs:

    - "wgmma" for windows larger than 1x1 with C >= 128;
    - "splitk" for those of them whose 128x128 output tiles fill less than
      half of the SMs (the thin 20x40 and 10x20 3x3 convs): K is cut into
      up to sms // tiles contiguous ranges of at least 4 steps;
    - "dot" for 1x1 convs without padding of at most DOT_MAX_M output
      pixels whose int8 activation fits in DOT_MAX_BYTES (the M = 1 SE
      convs);
    - "pointwise" for the other 1x1 convs without padding: 64 x 64 or
      32 x 64 tiles, whichever fills more SMs once each tile's K is split
      over a cluster of up to 8 blocks, in ranges of at least 64 channels
      (64 on a tie);
    - "mma" for the rest (windows larger than 1x1 with C < 128, and a 1x1
      window with padding).

    The wgmma routes launch persistent blocks, one per SM or one per unit
    of work, whichever is fewer.

    Raises ValueError for a shape that no route takes."""
    OH, OW = H + 2 * pad - KH + 1, W + 2 * pad - KW + 1
    if min(B, H, W, C, N, KH, KW) <= 0 or pad < 0:
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
    if KH * KW == 1 and pad == 0:
        return _pointwise_plan(M, C, N, sms)
    if KH * KW == 1 or C < TILE:
        return _mma_plan(M, N, KH * KW * C, sms)
    th, tw = _rectangle(OH, OW)
    m_tiles = B * math.ceil(OH / th) * math.ceil(OW / tw)
    n_tiles = math.ceil(N / TILE)
    iters = KH * KW * math.ceil(C / TILE)
    if n_tiles > 65535:
        raise ValueError(f"N = {N}: more output channels than the grid holds")
    tiles = m_tiles * n_tiles
    splits = max(1, min(sms // tiles, iters // 4))
    route = "splitk" if 2 * tiles <= sms and splits >= 2 else "wgmma"
    if route == "wgmma":
        splits = 1
    per_split = math.ceil(iters / splits)
    splits = math.ceil(iters / per_split)  # no split left without a K step
    units = tiles * splits
    return Int8ConvPlan(route, TILE, TILE, TILE, (m_tiles, n_tiles, splits), th, tw,
                        iters, per_split, min(units, sms))


def _mma_plan(M: int, N: int, K: int, sms: int) -> Int8ConvPlan:
    """The "mma" plan of a conv of M pixels, N output channels and K =
    KH * KW * C: 128x128 tiles where they fill the SMs, else 64x64. It
    runs any shape, so a test may hand it a 1x1 conv as well."""
    bm = 128 if math.ceil(M / 128) * math.ceil(N / 128) >= sms else 64
    iters = math.ceil(K / MMA_BK)
    grid = (math.ceil(M / bm), math.ceil(N / bm), 1)
    return Int8ConvPlan("mma", bm, bm, MMA_BK, grid, 0, 0, iters, iters, grid[0] * grid[1])


def _pointwise_plan(M: int, C: int, N: int, sms: int) -> Int8ConvPlan:
    """The "pointwise" or "dot" plan of a 1x1 conv of M pixels."""
    units = math.ceil(C / PW_BK)
    if M <= DOT_MAX_M and M * C <= DOT_MAX_BYTES:
        blocks = math.ceil(N / DOT_WARPS)
        return Int8ConvPlan("dot", M, DOT_WARPS, PW_BK, (1, blocks, 1), 0, 0,
                            units, units, blocks)
    n_tiles = math.ceil(N / PW_BN)
    if n_tiles > 65535:
        raise ValueError(f"N = {N}: more output channels than the grid holds")
    best = None
    for bm in (64, 32):
        tiles = math.ceil(M / bm) * n_tiles
        cs = max(1, min(MAX_CLUSTER, sms // tiles, units // 2))
        per_split = math.ceil(units / cs)
        cs = math.ceil(units / per_split)  # no rank left without channels
        fill = min(tiles * cs, sms)
        if best is None or fill > best[0]:
            best = (fill, bm, tiles, cs, per_split)
    _, bm, tiles, cs, per_split = best
    return Int8ConvPlan("pointwise", bm, PW_BN, PW_BK, (math.ceil(M / bm), n_tiles, cs),
                        0, 0, units, per_split, tiles * cs)


# ---------------------------------------------------------------------- conv

def int8_conv_plain(xq: torch.Tensor, weight: torch.Tensor,
                    weight_scale: torch.Tensor, x_scale: torch.Tensor,
                    bias: Optional[torch.Tensor], padding,
                    out_dtype: torch.dtype) -> torch.Tensor:
    acc = F.conv2d(xq.double(), weight.double(), None, 1, padding)
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


def _weight_map(lib, weight: torch.Tensor, N: int, KH: int, KW: int, C: int) -> bytes:
    """The weights' 128-byte TMA map, encoded once and kept on the weight
    tensor itself. The map holds the address and the shape alone, so it is
    encoded again only when they change."""
    key = (weight.data_ptr(), N, KH, KW, C)
    kept = getattr(weight, "_tma_map", None)
    if kept is not None and kept[0] == key:
        return kept[1]
    buf = ctypes.create_string_buffer(128)
    _check_err("avp_int8_weight_map",
               lib.avp_int8_weight_map(weight.data_ptr(), N, KH, KW, C,
                                       ctypes.addressof(buf)))
    weight._tma_map = (key, buf.raw)
    return buf.raw


def int8_conv(xq: torch.Tensor, weight: torch.Tensor, weight_scale: torch.Tensor,
              x_scale: torch.Tensor, bias: Optional[torch.Tensor] = None,
              padding=0, out_dtype: torch.dtype = torch.bfloat16, *, stride=1,
              groups: int = 1, dilation=1) -> torch.Tensor:
    """int8 (B, C, H, W) channels_last, int8 OIHW channels_last weights ->
    (B, O, OH, OW) channels_last in ``out_dtype`` (f32, bf16, or int32 for
    the raw accumulators). ``x_scale`` is the scale xq was made with. On
    the card it runs the route ``int8_conv_plan`` picks. Counts its kernel
    launches in ``int8_conv.launches`` and by route in
    ``int8_conv.route_launches``."""
    if xq.dtype != torch.int8 or weight.dtype != torch.int8:
        raise TypeError(f"xq and weight must be int8, got {xq.dtype}, {weight.dtype}")
    if groups != 1 or stride not in (1, (1, 1)) or dilation not in (1, (1, 1)):
        raise ValueError(f"int8 conv covers groups 1, stride 1, dilation 1; got "
                         f"groups={groups} stride={stride} dilation={dilation}")
    return _conv(xq, weight, weight_scale, x_scale, bias, padding, out_dtype)


def _conv(x: torch.Tensor, weight: torch.Tensor, weight_scale: torch.Tensor,
          x_scale: torch.Tensor, bias: Optional[torch.Tensor], padding,
          out_dtype: torch.dtype) -> torch.Tensor:
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
    pad = _pad(padding)
    B, C, H, W = x.shape
    N, _, KH, KW = weight.shape
    if weight.shape[1] != C:
        raise ValueError(f"weight {tuple(weight.shape)} does not take {C} channels")
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
        return int8_conv_plain(xq, weight, weight_scale, x_scale, bias, pad, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"no int8 conv for device {x.device}")
    index = x.get_device()
    if index != torch.cuda.current_device():  # the kernels launch on the current device
        with torch.cuda.device(index):
            return _conv(x, weight, weight_scale, x_scale, bias, padding, out_dtype)
    OH, OW = H + 2 * pad - KH + 1, W + 2 * pad - KW + 1
    if OH <= 0 or OW <= 0:
        raise ValueError(f"window {KH}x{KW} larger than the padded input {H}x{W}")
    Cp = padded_channels(C)
    if Cp != C:  # the kernels copy 16 channels at a time; zeros add nothing
        x, weight = pad_channels(x, Cp), pad_channels(weight, Cp)
        if x_scale.dim() == 1:
            x_scale = F.pad(x_scale, (0, Cp - C), value=1.0)
        C = Cp
    plan = int8_conv_plan(B, H, W, C, N, KH, KW, pad, _sm_count(index))
    if not quantized and plan.route not in FUSED_ROUTES:
        x = int8_quantize(x, x_scale)
    return _launch(plan, x, weight, weight_scale, x_scale, bias, pad, out_dtype)


def _reciprocal(x_scale: torch.Tensor) -> torch.Tensor:
    """1 / x_scale in float64, correctly rounded: the "pointwise" and "dot"
    routes quantize with it (csrc/int8_common.cuh::quantize_rcp, the same
    values as the division). Kept on the scale tensor while its address
    and version are unchanged, so a static scale costs one launch, once."""
    key = (x_scale.data_ptr(), x_scale._version)
    kept = getattr(x_scale, "_rcp", None)
    if kept is not None and kept[0] == key:
        return kept[1]
    rcp = torch.reciprocal(x_scale.double()).contiguous()
    x_scale._rcp = (key, rcp)
    return rcp


def _launch(plan: Int8ConvPlan, x: torch.Tensor, weight: torch.Tensor,
            weight_scale: torch.Tensor, x_scale: torch.Tensor,
            bias: Optional[torch.Tensor], pad: int, out_dtype: torch.dtype) -> torch.Tensor:
    """Runs ``plan`` on CUDA tensors of the current device that _conv has
    checked (C a multiple of 16): x int8, or f32/bf16 on the "pointwise"
    and "dot" routes. _conv passes the plan of the shape; a test may pass
    another plan of it (fewer persistent blocks, one split, the mma.sync
    route for a 1x1 conv)."""
    B, C, H, W = x.shape
    N, _, KH, KW = weight.shape
    OH, OW = H + 2 * pad - KH + 1, W + 2 * pad - KW + 1
    if x.dtype != torch.int8 and plan.route not in FUSED_ROUTES:
        raise TypeError(f"the {plan.route} route takes an int8 input, got {x.dtype}")
    _check_aligned(x, weight)
    lib = build.load()
    x_ptr = x_scale.data_ptr() if x_scale.dim() == 0 else None
    b_ptr = bias.data_ptr() if bias is not None and out_dtype != torch.int32 else None
    kind = _OUT_KIND[out_dtype]
    out = torch.empty((B, OH, OW, N), dtype=out_dtype, device=x.device)
    stream = _raw_stream(x.get_device())
    if plan.route in FUSED_ROUTES:
        rcp = None if x.dtype == torch.int8 else _reciprocal(x_scale)
        args = (x.data_ptr(), _IN_KIND[x.dtype], x_scale.data_ptr(),
                None if rcp is None else rcp.data_ptr(), int(x_scale.dim() == 1),
                weight.data_ptr(), weight_scale.data_ptr(), b_ptr, out.data_ptr(),
                B * H * W, C, N, kind)
        if plan.route == "pointwise":
            m_tiles, n_tiles, cs = plan.grid
            err = lib.avp_int8_conv_pointwise(*args, plan.bm, m_tiles, n_tiles, cs,
                                              plan.per_split * plan.bk, stream)
        else:
            err = lib.avp_int8_conv_dot(*args, stream)
        _check_err(f"avp_int8_conv_{plan.route}", err)
    elif plan.route == "mma":
        err = lib.avp_int8_conv_mma(
            x.data_ptr(), weight.data_ptr(), weight_scale.data_ptr(), x_ptr,
            b_ptr, out.data_ptr(), B, H, W, C, N, KH, KW, pad, kind, plan.bm,
            plan.grid[0], plan.grid[1], stream)
        _check_err("avp_int8_conv_mma", err)
    else:
        m_tiles, n_tiles, splits = plan.grid
        # split-K: each split's (M, N) partial sums, then one arrival
        # counter a tile
        ws = (torch.empty(splits * B * OH * OW * N + m_tiles * n_tiles,
                          dtype=torch.int32, device=x.device)
              if splits > 1 else None)
        err = lib.avp_int8_conv_wgmma(
            x.data_ptr(), _weight_map(lib, weight, N, KH, KW, C),
            weight_scale.data_ptr(), x_ptr, b_ptr, out.data_ptr(),
            None if ws is None else ws.data_ptr(), B, H, W, C, N, KH, KW, pad,
            kind, plan.th, plan.tw, m_tiles, n_tiles, splits, plan.per_split,
            plan.blocks, stream)
        _check_err("avp_int8_conv_wgmma", err)
    int8_conv.launches += 1
    int8_conv.route_launches[plan.route] += 1
    return out.permute(0, 3, 1, 2)


int8_conv.launches = 0
int8_conv.route_launches = dict.fromkeys(ROUTES, 0)


def int8_conv2d(x: torch.Tensor, weight: torch.Tensor, weight_scale: torch.Tensor,
                x_scale: torch.Tensor, bias: Optional[torch.Tensor] = None,
                padding=0, *, plain: bool = False) -> torch.Tensor:
    """The whole int8 conv of nn/layers.py:81-113 on a float input, in the
    input's dtype: quantize, then conv with the dequant epilogue; on the
    card a 1x1 conv ("pointwise" and "dot" routes) is one launch that
    quantizes as it loads, the others int8_quantize and int8_conv.
    ``plain=True`` runs the plain versions on any device (a reference run
    selects it explicitly; the kernels never fall back to it)."""
    if plain:
        xq = int8_quantize_plain(x, x_scale)
        return int8_conv_plain(xq, weight, weight_scale, x_scale, bias,
                               _pad(padding), x.dtype)
    if x.dtype not in IN_DTYPES:
        raise TypeError(f"x must be one of {IN_DTYPES}, got {x.dtype}")
    return _conv(x, weight, weight_scale, x_scale, bias, padding, x.dtype)
