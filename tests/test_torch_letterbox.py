"""The letterbox kernel's schedule on the CPU (ops/kernels/preprocess_kernel.py::
letterbox_plan, letterbox_pad_runs, segment_pixels, letterbox_pad_bits),
which csrc/letterbox.cu runs on the card: every output value written exactly
once (a warp a (row, 64 columns) unit, then a warp a 1 KB piece of the pad),
each warp's source bytes within its shared-memory copy, shared memory within
227 KB, and the pad constant the bits of the plain version's and JAX's pad
pixel. The kernel itself is held to the plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py phases 11 and 15).
"""
from __future__ import annotations

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from autoware_vision_pilot_tpu.ops.preprocess import letterbox as j_letterbox
from autoware_vision_pilot_tpu_torch.ops.kernels.preprocess_kernel import (
    LB_CHUNK, LB_PIECE, LB_SMEM_LIMIT, LB_WARPS, letterbox_pad_bits, letterbox_pad_runs,
    letterbox_plan, segment_pixels)
from autoware_vision_pilot_tpu_torch.ops.preprocess import (bilinear_taps, letterbox,
                                                            letterbox_geometry)

from test_torch_train_step import one_thread  # noqa: F401 (an autouse fixture)

# phase 11's sizes: landscape (pad rows), the KITTI size (an odd pad), pad
# columns with a width that is not a multiple of 8; and portrait, nh = 1
SIZES = [((720, 1280), (640, 640)), ((375, 1242), (640, 640)), ((360, 640), (181, 333)),
         ((1280, 720), (640, 640)), ((2, 1000), (640, 640))]


def written_values(B, H, W, out_hw, elem, extra_blocks=0):
    """Every output value index the kernel writes, in (B, h, w, 3) order,
    as its warps walk the plan (with ``extra_blocks`` more blocks than it
    asks for, warps past the last piece): a count a value."""
    plan = letterbox_plan(B, H, W, out_hw, elem)
    h, w = out_hw
    _, (nh, nw), (pad_x, pad_y) = letterbox_geometry(out_hw, (H, W))
    count = np.zeros(B * h * w * 3, np.int64)
    for unit in range(plan.image_blocks * LB_WARPS):
        if unit >= plan.units:
            continue  # the last image block's spare warps
        q, c = divmod(unit, plan.chunks)
        b, iy = divmod(q, nh)
        row = (b * h + pad_y + iy) * w * 3
        lo, hi = c * LB_CHUNK, min((c + 1) * LB_CHUNK, nw)
        count[row + (pad_x + lo) * 3:row + (pad_x + hi) * 3] += 1
        if c == 0:
            count[row:row + pad_x * 3] += 1
        if c == plan.chunks - 1:
            count[row + (pad_x + nw) * 3:row + w * 3] += 1
    runs = letterbox_pad_runs(B, out_hw, nh, pad_y, elem)
    per_word = 16 // elem
    for piece in range((plan.blocks + extra_blocks - plan.image_blocks) * LB_WARPS):
        for start, n, head, words, pieces in runs:  # the run that holds the piece
            if piece >= pieces:
                piece -= pieces
                continue
            w0, w1 = LB_PIECE * piece, min(LB_PIECE * (piece + 1), words)
            count[start + head + w0 * per_word:start + head + w1 * per_word] += 1
            if piece == 0:
                count[start:start + head] += 1
            if piece == pieces - 1:
                count[start + head + words * per_word:start + n] += 1
            break
    return plan, count


def check_schedule(B, H, W, out_hw, elem=2):
    plan, count = written_values(B, H, W, out_hw, elem)
    assert (count == 1).all()
    _, (nh, nw), _ = letterbox_geometry(out_hw, (H, W))
    assert plan.units == B * nh * plan.chunks
    assert 0 <= plan.image_blocks * LB_WARPS - plan.units < LB_WARPS
    assert 0 <= (plan.blocks - plan.image_blocks) * LB_WARPS - plan.pieces < LB_WARPS
    assert plan.smem == LB_WARPS * 2 * plan.slot <= LB_SMEM_LIMIT
    # each chunk's two source rows' bytes fit a warp's copy at any offset
    x0, x1, _ = bilinear_taps(W, nw)
    for c in range(plan.chunks):
        lo, hi = c * LB_CHUNK, min((c + 1) * LB_CHUNK, nw)
        assert x1[hi - 1] + 1 - x0[lo] <= segment_pixels(LB_CHUNK, W, nw)
        assert 3 * segment_pixels(LB_CHUNK, W, nw) + 15 <= plan.slot
    return plan


@pytest.mark.parametrize("n", [1, 3, 8])
@pytest.mark.parametrize("src,out_hw", SIZES)
def test_letterbox_schedule_writes_every_value_once(src, out_hw, n):
    for elem in (2, 4):  # bf16, f32
        check_schedule(n, *src, out_hw, elem)


def test_letterbox_schedule_with_more_blocks_than_units():
    """Warps past the last piece of the pad (the last block's spare warps,
    and any more) write nothing."""
    for extra in (1, 7, 100):
        _, count = written_values(3, 375, 1242, (640, 640), 2, extra)
        assert (count == 1).all()


def test_letterbox_plan_at_the_main_path_sizes():
    """720p -> 640x640 bf16: 10 warps a row, 450 image blocks of 8 at N = 1
    and 3,600 at N = 8; the pad rows (140 above, 140 below each image) in
    1 KB pieces, 1,050 at N = 1 and 8,400 at N = 8; a warp's copy of a
    source row 416 bytes (131 pixels)."""
    assert letterbox_plan(1, 720, 1280, (640, 640)) == (582, 450, 3600, 10, 1050, 416, 6656)
    assert letterbox_plan(8, 720, 1280, (640, 640)) == (4650, 3600, 28800, 10, 8400, 416, 6656)


@settings(max_examples=150, deadline=None, derandomize=True)
@given(B=st.integers(1, 4), H=st.integers(1, 700), W=st.integers(1, 1500),
       h=st.integers(1, 150), w=st.integers(1, 200), elem=st.sampled_from([2, 4]))
def test_letterbox_schedule_on_any_size(B, H, W, h, w, elem):
    _, (nh, nw), _ = letterbox_geometry((h, w), (H, W))
    if min(nh, nw) < 1:
        return  # the wrapper refuses such a frame
    check_schedule(B, H, W, (h, w), elem)


def kernel_constants():
    """The ``constexpr int NAME = expr;`` lines of csrc/letterbox.cu,
    evaluated in order. -> {NAME: value}."""
    src = Path(__file__).resolve().parents[1] / "autoware_vision_pilot_tpu_torch" / "csrc" / "letterbox.cu"
    names = {}
    for name, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);", src.read_text(), re.M):
        names[name] = eval(expr, {}, dict(names))  # small integer expressions of earlier names
    return names


def test_letterbox_constants_match_the_kernel():
    """The schedule's constants are the kernel's: the model replays the
    grid that csrc/letterbox.cu works out on the host."""
    c = kernel_constants()
    assert (c["CHUNK"], c["WARPS"], c["PIECE"], c["SMEM_LIMIT"]) == (
        LB_CHUNK, LB_WARPS, LB_PIECE, LB_SMEM_LIMIT)
    assert c["CHUNK"] == 32 * c["PX"]


def test_letterbox_plan_refuses_rows_past_shared_memory():
    with pytest.raises(ValueError):
        letterbox_plan(1, 10, 400000, (64, 64))


@pytest.mark.parametrize("dtype,view", [(torch.float32, torch.int32),
                                        (torch.bfloat16, torch.int16)])
def test_pad_constant_is_the_plain_version_pad_pixel(dtype, view):
    """The bits the kernel stores in every pad value are those of the
    plain version's pad pixel, in f32 and bf16, and of JAX's."""
    frame = np.random.default_rng(3).integers(0, 256, (1, 72, 128, 3), np.uint8)
    x, _, (_, pad_y) = letterbox(torch.from_numpy(frame), (128, 128), (72, 128), dtype=dtype)
    assert pad_y > 0
    pixel = x[0, 0].contiguous().view(view).flatten()
    mask = (1 << (8 * pixel.element_size())) - 1
    assert {int(v) & mask for v in pixel} == {letterbox_pad_bits(dtype)}
    jx, _, _ = j_letterbox(jnp.asarray(frame), (128, 128), (72, 128),
                           dtype=jnp.float32 if dtype == torch.float32 else jnp.bfloat16)
    jbits = np.asarray(jx[0, 0]).view(np.int32 if dtype == torch.float32 else np.int16)
    assert {int(v) & mask for v in jbits.flatten()} == {letterbox_pad_bits(dtype)}


@pytest.mark.parametrize("dtype,view", [(torch.float32, torch.int32),
                                        (torch.bfloat16, torch.int16)])
def test_pad_bits_for_every_pad_value(dtype, view):
    """letterbox_pad_bits against torch's own f32 multiply and bf16 cast
    (round to nearest even) for every pad value 0-255."""
    pads = torch.arange(256, dtype=torch.float32)
    ref = (pads * (1.0 / 255.0)).to(dtype).view(view)
    mask = (1 << (8 * ref.element_size())) - 1
    assert [letterbox_pad_bits(dtype, p) for p in range(256)] == [int(v) & mask for v in ref]
