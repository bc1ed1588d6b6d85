"""Model benchmarking across precisions: f32 vs bf16 vs int8 weight-only
PTQ, the port of autoware_vision_pilot_tpu/export/benchmark_models.py.

Equivalent of Models/exports/benchmark_onnx_models.py (PyTorch vs
ONNX-FP32 vs INT8: speed + mIoU parity): measures per-precision latency
(utils/benchmark.py) and output agreement (mIoU for segmentation outputs,
max deviation for dense outputs) against the f32 baseline. The int8 row is
QuantizedInference (export/quantize.py), as in the JAX package.

Run: python -m autoware_vision_pilot_tpu_torch.export.benchmark_models
     [SceneSegLite|SceneSeg] [--device cpu]
"""
from __future__ import annotations

import copy
import sys
from typing import Dict

import numpy as np
import torch

from ..utils.benchmark import benchmark
from .quantize import QuantizedInference


def _nhwc(out: torch.Tensor) -> np.ndarray:
    """A network's NCHW output as the JAX package's NHWC f32 numpy array."""
    out = out.float()
    return (out.permute(0, 2, 3, 1) if out.dim() == 4 else out).cpu().numpy()


def compare_precisions(model: torch.nn.Module, input_shape, runs: int = 200,
                       seg_output: bool = True, name: str = "model",
                       device="cuda") -> Dict[str, Dict]:
    """``model`` (f32 weights) at an NCHW ``input_shape`` on ``device``.
    Returns {precision: {ms_per_iter, fps, runs, miou_vs_f32|max_dev_vs_f32}}."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.uniform(-2, 2, input_shape).astype(np.float32)).to(device)
    f32 = model.to(device=device, dtype=torch.float32).eval()
    bf16 = copy.deepcopy(f32).to(torch.bfloat16)
    q = QuantizedInference(f32)
    calls = {"f32": (lambda x: f32(x), x), "bf16": (lambda x: bf16(x), x.bfloat16()),
             "int8": (q, x)}

    results = {}
    with torch.no_grad():
        ref = _nhwc(f32(x))
        for precision, (fn, arg) in calls.items():
            results[precision] = benchmark(fn, arg, warmup=20, runs=runs,
                                           name=f"{name}/{precision}")
            if precision != "f32":
                results[precision].update(_agreement(ref, _nhwc(fn(arg)), seg_output))
    return results


def _agreement(ref: np.ndarray, out: np.ndarray, seg: bool) -> Dict:
    if seg and ref.ndim == 4 and ref.shape[-1] > 1:
        a = np.argmax(ref, -1)
        b = np.argmax(out, -1)
        inter = 0.0
        union = 0.0
        for c in range(ref.shape[-1]):
            inter += ((a == c) & (b == c)).sum()
            union += ((a == c) | (b == c)).sum()
        return {"miou_vs_f32": float(inter / max(union, 1))}
    return {"max_dev_vs_f32": float(np.abs(ref - out).max())}


def build(name: str) -> torch.nn.Module:
    """SceneSegLite (DeepLabV3+, 3 classes) or SceneSeg, weights from seed 0
    (nn/layers.py::init_seeded), f32 on the CPU."""
    from ..nn.layers import init_seeded

    if name == "SceneSegLite":
        from ..models.lite.deeplabv3plus import DeepLabV3Plus
        model = DeepLabV3Plus(output_channels=3)
    elif name == "SceneSeg":
        from ..models.scene_seg import SceneSegNetwork
        model = SceneSegNetwork()
    else:
        raise SystemExit(f"unknown model {name}")
    return init_seeded(model, torch.Generator().manual_seed(0)).eval()


def main(argv=None):
    args = list(sys.argv[1:] if argv is None else argv)
    device = "cuda"
    if "--device" in args:
        i = args.index("--device")
        device = args[i + 1]
        del args[i:i + 2]
    name = (args or ["SceneSegLite"])[0]
    res = compare_precisions(build(name), (1, 3, 320, 640), name=name, device=device)
    for k, v in res.items():
        print(k, v)
    return res


if __name__ == "__main__":
    main()
