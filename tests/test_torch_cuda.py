"""Tests of the port that need an NVIDIA GPU: the fused-preprocess CUDA
kernel against its plain PyTorch version, and the main path on the card
against the CPU. They skip where there is no CUDA device.

This file imports no JAX, so it also runs on a machine that has none:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from autoware_vision_pilot_tpu_torch.ops.kernels.preprocess_kernel import fused_preprocess
from autoware_vision_pilot_tpu_torch.ops.preprocess import preprocess_imagenet
from autoware_vision_pilot_tpu_torch.pipeline import build_pipeline_fused

pytestmark = pytest.mark.cuda


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
