"""The port's preprocessing and post-processing against the JAX package's
(ops/preprocess.py, ops/pallas/preprocess_kernel.py, ops/postprocess.py),
and the fused-preprocess wrapper's CPU branch and argument checks; and the
kernel library's C bindings and rebuild key (kernels/build.py).

The kernel itself (csrc/preprocess.cu) runs only on a GPU: its tests are
in test_torch_cuda.py. Here, ``test_kernel_arithmetic_is_the_plain_version``
replays the kernel's f32 operations in numpy and holds them bit-equal to
the plain version. f32 tolerance against JAX: 1e-5 absolute.
"""
import ctypes
import re
from pathlib import Path

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoware_vision_pilot_tpu.ops import postprocess as jpost
from autoware_vision_pilot_tpu.ops.pallas.preprocess_kernel import fused_preprocess_pallas
from autoware_vision_pilot_tpu.ops.preprocess import _bilinear_matrix
from autoware_vision_pilot_tpu.ops.preprocess import preprocess_imagenet as j_preprocess
from autoware_vision_pilot_tpu_torch.kernels import build
from autoware_vision_pilot_tpu_torch.ops import postprocess as tpost
from autoware_vision_pilot_tpu_torch.ops.kernels.preprocess_kernel import fused_preprocess
from autoware_vision_pilot_tpu_torch.ops.preprocess import (
    IMAGENET_MEAN, IMAGENET_STD, bilinear_taps, preprocess_imagenet, resize_bilinear)

from test_torch_train_step import one_thread  # noqa: F401 (an autouse fixture)

SHAPES = [  # (H, W) -> (h, w)
    ((72, 128), (32, 64)),    # downscale, the main path's 2.25x / 2x
    ((24, 40), (48, 96)),     # upscale
    ((75, 123), (40, 56)),    # odd sizes, mixed ratios
    ((37, 50), (64, 33)),     # upscale rows, downscale columns
]


def frame(hw, seed=0, batch=()):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (*batch, *hw, 3), dtype=np.uint8)


@pytest.mark.parametrize("src,dst", SHAPES + [((720, 1280), (320, 640)),
                                              ((375, 1242), (320, 640))])
def test_plain_preprocess_matches_jax(src, dst):
    """Against the Pallas kernel (interpret mode) at 1e-5 everywhere.
    Against JAX's preprocess_imagenet at 1e-5 at the main path's scales
    (2.25 x 2, 720p -> 320x640). At other scales jax.image.resize, which
    derives its weights in f32, differs from the Pallas kernel's float64
    taps by up to 3e-4 (375x1242); there the port may be no further from it
    than the Pallas kernel is, plus 1e-5."""
    f = frame(src, seed=src[0])
    out = preprocess_imagenet(torch.from_numpy(f), dst).numpy()
    assert out.shape == (*dst, 3) and out.dtype == np.float32
    pallas = np.asarray(fused_preprocess_pallas(
        jnp.asarray(f), dst, out_dtype=jnp.float32, interpret=True))
    np.testing.assert_allclose(out, pallas, atol=1e-5, rtol=0)
    ref = np.asarray(j_preprocess(jnp.asarray(f), dst))
    if (src[0] / dst[0], src[1] / dst[1]) == (2.25, 2.0):
        np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)
    else:
        assert (np.abs(out - ref) <= np.abs(pallas - ref) + 1e-5).all()


@pytest.mark.parametrize("n_in,n_out", [(720, 320), (1280, 640), (24, 48),
                                        (123, 56), (1, 4), (5, 1)])
def test_bilinear_taps_match_jax_matrix(n_in, n_out):
    i0, i1, frac = bilinear_taps(n_in, n_out)
    assert frac.dtype == np.float32 and i0.min() >= 0 and i1.max() < n_in
    m = np.zeros((n_out, n_in), np.float32)
    rows = np.arange(n_out)
    np.add.at(m, (rows, i0), 1 - frac)
    np.add.at(m, (rows, i1), frac)
    np.testing.assert_allclose(m, np.asarray(_bilinear_matrix(n_in, n_out)),
                               atol=1e-7, rtol=0)


def test_resize_matches_cv2_at_main_path_shape():
    f = frame((720, 1280), seed=1)
    out = resize_bilinear(torch.from_numpy(f), (320, 640)).numpy()
    ref = cv2.resize(f.astype(np.float32), (640, 320),
                     interpolation=cv2.INTER_LINEAR)
    np.testing.assert_allclose(out, ref, atol=1e-3)


def test_bgr_to_rgb_order():
    f = np.zeros((8, 8, 3), np.uint8)
    f[..., 0] = 255  # blue in BGR
    out = preprocess_imagenet(torch.from_numpy(f), (4, 4)).numpy()
    mean, std = IMAGENET_MEAN.numpy(), IMAGENET_STD.numpy()
    expect = (np.array([0.0, 0.0, 1.0], np.float32) - mean) / std
    np.testing.assert_allclose(out, np.broadcast_to(expect, out.shape),
                               atol=1e-6)


def _kernel_replay(f, dst):
    """The f32 operations of csrc/preprocess.cu for one (H, W, 3) frame,
    one numpy op per intrinsic, in the kernel's order."""
    f32 = np.float32
    y0, y1, fy = bilinear_taps(f.shape[0], dst[0])
    x0, x1, fx = bilinear_taps(f.shape[1], dst[1])
    gy, gx = (f32(1) - fy)[:, None, None], (f32(1) - fx)[None, :, None]
    fy, fx = fy[:, None, None], fx[None, :, None]
    p = f[..., ::-1].astype(f32)  # output channel c reads plane 2 - c
    t0 = p[y0][:, x0] * gy + p[y1][:, x0] * fy
    t1 = p[y0][:, x1] * gy + p[y1][:, x1] * fy
    v = t0 * gx + t1 * fx
    return (v * f32(1.0 / 255.0) - IMAGENET_MEAN.numpy()) / IMAGENET_STD.numpy()


@pytest.mark.parametrize("src,dst", SHAPES + [((720, 1280), (320, 640))])
def test_kernel_arithmetic_is_the_plain_version(src, dst):
    f = frame(src, seed=2)
    replay = _kernel_replay(f, dst)
    assert replay.dtype == np.float32
    np.testing.assert_array_equal(
        preprocess_imagenet(torch.from_numpy(f), dst).numpy(), replay)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_wrapper_cpu_branch_is_plain_version(out_dtype):
    before = fused_preprocess.launches
    f = torch.from_numpy(frame((45, 80), seed=3))
    out = fused_preprocess(f, (32, 64), out_dtype)
    assert out.shape == (1, 3, 32, 64) and out.dtype == out_dtype
    assert out.is_contiguous(memory_format=torch.channels_last)
    ref = preprocess_imagenet(f, (32, 64), out_dtype)
    assert torch.equal(out.permute(0, 2, 3, 1)[0], ref)
    batch = torch.from_numpy(frame((45, 80), seed=4, batch=(2,)))
    out_b = fused_preprocess(batch, (32, 64), out_dtype)
    assert out_b.shape == (2, 3, 32, 64)
    assert torch.equal(out_b.permute(0, 2, 3, 1),
                       preprocess_imagenet(batch, (32, 64), out_dtype))
    assert fused_preprocess.launches == before  # the plain version is no launch


@pytest.mark.parametrize("bad,kwargs,exc", [
    ("float frame", {}, TypeError),
    ("rank 2", {}, ValueError),
    ("rank 5", {}, ValueError),
    ("4 channels", {}, ValueError),
    ("non-contiguous", {}, ValueError),
    ("ok", {"out_hw": (32, 0)}, ValueError),
    ("ok", {"out_hw": (32.0, 64)}, ValueError),
    ("ok", {"out_dtype": torch.float16}, TypeError),
])
def test_wrapper_rejects(bad, kwargs, exc):
    f = torch.from_numpy(frame((16, 24), seed=5))
    f = {"float frame": f.float(), "rank 2": f[..., 0],
         "rank 5": f[None, None], "4 channels": torch.cat([f, f[..., :1]], -1),
         "non-contiguous": f.transpose(0, 1), "ok": f}[bad]
    with pytest.raises(exc):
        fused_preprocess(f, **{"out_hw": (8, 8), **kwargs})


def test_argmax_mask_ties_take_first_index():
    rng = np.random.default_rng(6)
    logits = rng.integers(-2, 3, (2, 5, 7, 3)).astype(np.float32)  # many ties
    logits[0, 0, 0] = [1.0, 1.0, 1.0]
    logits[0, 0, 1] = [0.0, 2.0, 2.0]
    out = tpost.argmax_mask(torch.from_numpy(logits))
    assert out.dtype == torch.int32
    ref = np.asarray(jpost.argmax_mask(jnp.asarray(logits)))
    np.testing.assert_array_equal(out.numpy(), ref)
    assert out[0, 0, 0] == 0 and out[0, 0, 1] == 1


def test_threshold_channels():
    x = np.random.default_rng(7).standard_normal((2, 6, 8, 3)).astype(np.float32)
    x[0, 0, 0] = 0.0  # not > 0
    for thr in (0.0, 0.5):
        out = tpost.threshold_channels(torch.from_numpy(x), thr)
        assert out.dtype == torch.float32
        np.testing.assert_array_equal(
            out.numpy(), np.asarray(jpost.threshold_channels(jnp.asarray(x), thr)))


def test_depth_minmax_scale():
    d = np.random.default_rng(8).standard_normal((3, 6, 8, 1)).astype(np.float32)
    d[2] = 0.25  # a constant frame: 0 everywhere, no division by zero
    out = tpost.depth_minmax_scale(torch.from_numpy(d)).numpy()
    np.testing.assert_allclose(
        out, np.asarray(jpost.depth_minmax_scale(jnp.asarray(d))), atol=1e-7)
    assert out.min() == 0.0 and out.max() == 1.0 and not out[2].any()


def test_kernel_binding_matches_c_signature():
    """The ctypes argtypes in kernels/build.py against the extern "C"
    declarations in csrc/*.cu: pointers (and the stream) as c_void_p, ints
    as c_int, long longs as c_int64, floats as c_float, in order. The
    library itself is built only on a GPU machine."""
    assert [p.name for p in build.sources()] == ["int8_conv.cu", "int8_conv_halo.cu",
                                                 "int8_conv_sm90.cu", "int8_conv_strided.cu",
                                                 "int8_pointwise.cu", "lane_filter.cu",
                                                 "launch_floor.cu", "letterbox.cu", "nms.cu",
                                                 "preprocess.cu"]
    decls = {}
    for src in build.sources():
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)',
                                       src.read_text()):
            decls[name] = [ctypes.c_void_p if "*" in p else
                           ctypes.c_int64 if "long long" in p else
                           ctypes.c_float if p.split()[0] == "float" else ctypes.c_int
                           for p in params.split(",")]
    # the kernels are bound by csrc/torch_ops.cpp as operators, whose
    # declarations must repeat the kernels' own
    op_decls = dict(re.findall(r"\nint (\w+)\(([^)]*)\);",
                               build.OPS_SOURCE.read_text().split('extern "C" {')[1]))
    assert sorted(op_decls) == ["avp_fused_preprocess", "avp_int8_conv_d2s", "avp_int8_conv_dot",
                                "avp_int8_conv_halo", "avp_int8_conv_pointwise",
                                "avp_int8_conv_strided", "avp_int8_conv_wgmma",
                                "avp_int8_quantize",
                                "avp_lane_filter_walk", "avp_letterbox", "avp_nms_greedy"]
    for src in build.sources():
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src.read_text()):
            if name in op_decls:
                assert op_decls[name].split() == params.split(), name
    assert decls.keys() - op_decls.keys() == build.SIGNATURES.keys()
    for name, argtypes in build.SIGNATURES.items():
        assert list(argtypes) == decls[name], name
    assert build.LIBRARY.parent == Path(build.__file__).resolve().parents[2] / "build" / "torch_kernels"


def test_rebuild_key_covers_headers(tmp_path):
    """The hash that decides a rebuild covers csrc/*.cu and the *.cuh
    headers they include, so an edited header rebuilds the library.
    No nvcc runs here: only the key is computed."""
    (tmp_path / "k.cu").write_text('#include "k.cuh"\n')
    (tmp_path / "k.cuh").write_text("#define TILE 64\n")
    (tmp_path / "notes.txt").write_text("not a source")
    key = build._digest(tmp_path)
    assert build._digest(tmp_path) == key
    (tmp_path / "notes.txt").write_text("still not a source")
    assert build._digest(tmp_path) == key
    (tmp_path / "k.cuh").write_text("#define TILE 128\n")
    assert build._digest(tmp_path) != key
    assert [p.name for p in build.sources(tmp_path)] == ["k.cu"]
