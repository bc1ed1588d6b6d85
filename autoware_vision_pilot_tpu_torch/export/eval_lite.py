"""Lite model evaluation CLI, the port of
autoware_vision_pilot_tpu/export/eval_lite.py (the reference's
Models/exports/lite_models/eval_{sceneseglite,scene3dlite,egolaneslite}.py).

One CLI covers the three Lite tasks; the config's loss.type selects it
(cross_entropy -> mIoU, lanes_bce -> per-channel lane IoU, depth_ssi ->
AbsRel / delta1 / MAE). It runs on the card unless ``--device cpu`` is
given. Weights load from a .onnx artifact (``--onnx``, through
convert/onnx_import.py), or a flax msgpack file that the JAX package wrote
(``--msgpack``, through export/checkpoints.py::load_msgpack and
convert/from_jax.py), or a checkpoint directory of the port's Lite trainer
(``--checkpoint``), else come from seed 0 (smoke mode). ``--int8`` runs
the selected convs on the int8 kernels (export/quantize.py), calibrated on
noise as the JAX CLI does. ``--bench`` also times the forward on the card
with CUDA events over distinct frames already there. Its
``device_ms_per_frame`` is not the JAX CLI's pipelined mean under the same
key: it is the p50 of per-frame spans, each synchronized, so the host's
launch time is in it (``device_ms_stat`` says so in the summary), and
``device_fps`` is 1000 over the mean of those spans.

Usage:
  python -m autoware_vision_pilot_tpu_torch.export.eval_lite \\
      --config configs/SceneSegLite.yaml --synthetic 4 --bench [--int8]
  python -m autoware_vision_pilot_tpu_torch.export.eval_lite \\
      --config configs/SceneSegLite.yaml --msgpack best.msgpack \\
      --data /data/val_npz --height 320 --width 640

Data layout: a directory of .npz files, each with ``image`` (H, W, 3
uint8) and ``label`` (H, W int for seg; H, W float for depth; H, W, C float
for lane masks). ``--synthetic N`` evaluates on N random samples.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

import numpy as np
import torch

from ..convert.onnx_import import import_onnx
from ..export.checkpoints import load_checkpoint_weights
from ..export.quantize import calibrate_int8_activation_scales, quantize_for_int8_conv
from ..inference.infer import load_weights as load_into
from ..models.lite import build_lite_model
from ..nn.layers import init_seeded
from ..ops.preprocess import device_mean_std
from ..train.lite_trainer import load_experiment_config
from ..train.metrics import confusion_matrix, miou_from_confusion

WARM = 10  # --bench: untimed frames before the timed ones


def load_weights(model, args, device, dtype):
    """``model`` (built on the CPU in f32) with the weights ``args`` name,
    on ``device`` in ``dtype``, channels_last, in eval mode: ``--onnx``
    through convert/onnx_import.py::import_onnx over the seed-0 weights (a
    BatchNorm folded away in the file becomes the identity), as the JAX
    CLI imports it over its init; ``--checkpoint``, the weights of the
    latest ``path/step_N`` that train/lite_trainer.py saved (the JAX CLI
    reads its own trainer's orbax checkpoint there)."""
    if args.onnx:
        init_seeded(model, torch.Generator().manual_seed(0))
        model.load_state_dict(import_onnx(model, args.onnx), strict=True)
        model.to(device=device, dtype=dtype, memory_format=torch.channels_last)
        return model.eval()
    if not args.msgpack and args.checkpoint:
        init_seeded(model, torch.Generator().manual_seed(0))
        model.load_state_dict(load_checkpoint_weights(args.checkpoint), strict=True)
        model.to(device=device, dtype=dtype, memory_format=torch.channels_last)
        return model.eval()
    if not args.msgpack:
        print("eval_lite: no weights given — evaluating the random init (smoke mode)",
              file=sys.stderr)
    return load_into(model, checkpoint=args.msgpack or "", device=device, dtype=dtype)


def iter_samples(args, input_hw):
    """(image uint8 (H, W, 3), label) pairs: ``--synthetic`` from seed 0,
    else the .npz files of ``--data`` in name order."""
    h, w = input_hw
    if args.synthetic:
        rng = np.random.default_rng(0)
        for _ in range(args.synthetic):
            img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            if args.task == "depth":
                lbl = rng.random((h, w), dtype=np.float32)
            elif args.task == "lanes":
                lbl = (rng.random((h, w, 3)) > 0.9).astype(np.float32)
            else:
                lbl = rng.integers(0, args.num_classes, (h, w)).astype(np.int32)
            yield img, lbl
        return
    for f in sorted(pathlib.Path(args.data).glob("*.npz")):
        d = np.load(f)
        yield d["image"], d["label"]


def normalize(images_u8: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> the network input, NCHW over the NHWC buffer,
    as the JAX CLI's forward computes it: ``/ 255`` in ``dtype``, then
    ``(x - MEAN) / STD`` against f32 constants (so f32 in either dtype;
    the first conv casts). No BGR swap: the images are taken as RGB."""
    mean, std = device_mean_std(images_u8.device)
    x = images_u8.to(dtype) / 255.0
    return ((x - mean) / std).permute(0, 3, 1, 2)


def calibration_batches(input_hw, device, dtype):
    """The JAX CLI's int8 calibration input: four batches of two uint8
    noise images from ``default_rng(11)``, normalized, in ``dtype``."""
    rng = np.random.default_rng(11)
    return [normalize(torch.from_numpy(rng.integers(0, 256, (2, *input_hw, 3), dtype=np.uint8))
                      .to(device), dtype).to(dtype) for _ in range(4)]


def forward_fn(model, dtype):
    """-> forward(uint8 (B, H, W, 3) on the model's device) -> the model's
    output NHWC in f32."""
    @torch.inference_mode()
    def forward(images_u8):
        return model(normalize(images_u8, dtype).to(dtype)).float().permute(0, 2, 3, 1)
    return forward


def _at(lbl, shape):
    """The label sampled at the prediction's resolution (every ry-th row
    and column), when the head's output is smaller than the label."""
    if lbl.shape[:2] == shape:
        return lbl
    ry = lbl.shape[0] // shape[0]
    return lbl[::ry, ::ry][:shape[0], :shape[1]]


def score(task: str, pairs, num_classes: int = 3, ignore_index=None) -> dict:
    """The summary's metric entries over ``pairs`` of (model output (h, w,
    C) f32 numpy, label), as the JAX CLI computes them; ``samples`` is
    their count."""
    n = 0
    cm = np.zeros((num_classes, num_classes), np.int64)
    inter, union = np.zeros(3), np.zeros(3)
    absrel_sum, mae_sum, d1_sum, n_px = 0.0, 0.0, 0.0, 0
    for out, lbl in pairs:
        n += 1
        if task == "seg":
            pred = out.argmax(-1)
            cm += confusion_matrix(pred, _at(lbl, pred.shape), num_classes, ignore_index)
        elif task == "lanes":
            pred = 1.0 / (1.0 + np.exp(-out)) > 0.5
            gt = _at(lbl, pred.shape[:2]) > 0.5
            inter += (pred & gt).sum((0, 1))
            union += (pred | gt).sum((0, 1))
        else:
            pred = out[..., 0]
            lbl = _at(lbl, pred.shape)
            valid = lbl > 1e-6
            p, g = pred[valid], lbl[valid]
            absrel_sum += float((np.abs(p - g) / np.maximum(g, 1e-6)).sum())
            mae_sum += float(np.abs(p - g).sum())
            ratio = np.maximum(p / np.maximum(g, 1e-6), g / np.maximum(p, 1e-6))
            d1_sum += float((ratio < 1.25).sum())
            n_px += int(valid.sum())
    summary = {"samples": n}
    if task == "seg":
        per_class, miou, overall = miou_from_confusion(cm)
        summary["miou"] = round(float(miou), 5)
        summary["overall_iou"] = round(float(overall), 5)
        summary["per_class_iou"] = [None if np.isnan(x) else round(float(x), 5)
                                    for x in per_class]
    elif task == "lanes":
        iou = inter / np.maximum(union, 1)
        summary["lane_iou"] = [round(float(x), 5) for x in iou]
        summary["mean_lane_iou"] = round(float(iou.mean()), 5)
    else:
        summary["absrel"] = round(absrel_sum / max(n_px, 1), 5)
        summary["mae"] = round(mae_sum / max(n_px, 1), 5)
        summary["delta1"] = round(d1_sum / max(n_px, 1), 5)
    return summary


def card_name() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def bench(forward, input_hw, device, iters: int) -> dict:
    """p50 and p99 of ``forward`` on WARM + ``iters`` distinct uint8 frames
    already on the card, one at a time, CUDA events around each and a
    synchronize after it (host launch time included); frames/s from their
    mean."""
    pool = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (WARM + iters, 1, *input_hw, 3), dtype=np.uint8)).to(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    ms = []
    for i in range(len(pool)):
        start.record()
        forward(pool[i])
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
    timed = np.asarray(ms[WARM:])
    return {"device_ms_per_frame": float(np.percentile(timed, 50)),
            "device_ms_stat": "p50 of synchronized per-frame spans, host launch included",
            "device_ms_p99": float(np.percentile(timed, 99)),
            "device_fps": 1000.0 / float(timed.mean()), "card": card_name()}


def main(argv=None):
    ap = argparse.ArgumentParser("Lite model evaluation (PyTorch)")
    ap.add_argument("--config", required=True)
    ap.add_argument("--checkpoint", help="the Lite trainer's checkpoint dir (path/step_N)")
    ap.add_argument("--msgpack", help="flax msgpack weights file")
    ap.add_argument("--onnx", help=".onnx weights artifact")
    ap.add_argument("--data", help="dir of .npz samples (image,label)")
    ap.add_argument("--synthetic", type=int, default=0,
                    help="evaluate N synthetic samples (smoke mode)")
    ap.add_argument("--height", type=int, default=320)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--bench", action="store_true",
                    help="also time the forward on the card: device_ms_per_frame is the "
                         "p50 (and device_ms_p99 the p99) of per-frame CUDA-event spans, "
                         "synchronized after each frame, host launch time included")
    ap.add_argument("--bench-iters", type=int, default=120)
    ap.add_argument("--dtype", choices=["f32", "bf16"], default="f32")
    ap.add_argument("--int8", action="store_true",
                    help="selective int8 conv path (static activation scales "
                         "calibrated on noise)")
    ap.add_argument("--int8-min-ch", type=int, default=128)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", help="write the JSON summary here too")
    args = ap.parse_args(argv)

    cfg = load_experiment_config(args.config)
    loss = cfg.get("loss", {})
    args.task = {"depth_ssi": "depth", "lanes_bce": "lanes"}.get(
        loss.get("type", "cross_entropy"), "seg")
    args.num_classes = int(loss.get("num_classes", 3))

    dt = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    device = torch.device(args.device)
    if args.bench and device.type != "cuda":
        raise ValueError("--bench times the card: it needs --device cuda")
    input_hw = (args.height, args.width)
    model = load_weights(build_lite_model(cfg), args, device, dt)
    if args.int8:
        quantize_for_int8_conv(model, args.int8_min_ch)
        calibrate_int8_activation_scales(model, calibration_batches(input_hw, device, dt))
    forward = forward_fn(model, dt)

    def outputs():
        for img, lbl in iter_samples(args, input_hw):
            yield forward(torch.from_numpy(img[None]).to(device))[0].cpu().numpy(), lbl

    scores = score(args.task, outputs(), args.num_classes, loss.get("ignore_index"))
    summary = {"config": str(args.config), "task": args.task,
               "samples": scores.pop("samples"), "input_hw": list(input_hw), **scores}
    if args.bench:
        summary.update(bench(forward, input_hw, device, args.bench_iters))

    line = json.dumps(summary)
    print(line)
    if args.out:
        pathlib.Path(args.out).write_text(line + "\n")
    return summary


if __name__ == "__main__":
    main()
