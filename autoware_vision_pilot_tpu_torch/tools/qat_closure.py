"""QAT-to-deployment closure on the headline trunk, the port of
tools/qat_closure.py (the reference's QAT int8 flow,
Models/exports/README.md:19-55, with the accuracy-parity tables of
exports/benchmark_onnx_models.py):

1. float-train SceneSeg on synthetic scenes (tools/e2e_train_demo.py's
   recipe, the same scenes and batches);
2. QAT fine-tune (train/qat.py: STE weight fake-quant, activation
   fake-quant by forward pre-hooks), in two parts: the observers running
   for ``observe_steps`` steps, their amax max-merged over the steps
   (``ObserverSchedule``), then frozen: the static scales the deployment
   uses, with BatchNorm on its running statistics;
3. export through ``int8_variables_from_qat`` (per-channel activation
   scales folded into the int8 weights) onto the int8 kernels, saved as a
   flax msgpack file;
4. the int8 program against the bf16 program on held-out frames: argmax
   agreement, and the mIoU of both (and of an f32 control) against the
   ground truth.

The float and QAT steps compute in bf16 over f32 weights (autocast); the
bf16 program is a bf16 copy of the trained net, the int8 program its
int8 export with every other tensor in bf16 (export/quantize.py::
cast_quantized), whose convs run on the card's int8 kernels. Prints one
JSON line with the JAX tool's keys.

Run: python -m autoware_vision_pilot_tpu_torch.tools.qat_closure
     [--float-steps 80] [--qat-steps 80] [--observe-steps N] [--distill W]
     [--qat-lr 5e-5] [--min-ch 128] [--per-ch-act] [--batch 8] [--out DIR]
     [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import copy
import json
import pathlib
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from .common import default_out
from .e2e_train_demo import (CL, N_TRAIN, VAL_SEED0, batch_indices, miou_of, seeded_model,
                             seg_sample, to_device)

N_VAL = 16


class ObserverSchedule:
    """The observe-then-freeze schedule: at QAT steps before
    ``observe_steps`` the observers run (dynamic per-batch scales) and
    each step's amax is max-merged into a running amax by conv name, on
    the device; from step ``observe_steps`` on the scales are frozen to
    ``collect_act_scales`` of that running amax (the JAX tool's
    ``act_running``: a per-tensor scale the largest amax / 127 in float64,
    a per-channel one the elementwise largest / 127 in f32)."""

    def __init__(self, observe_steps: int):
        self.observe_steps = observe_steps
        self.amax: Dict[str, torch.Tensor] = {}
        self.frozen: Optional[Dict[str, object]] = None

    def static_scales(self, step: int) -> Optional[Dict[str, object]]:
        """None while the observers run, then the frozen scales."""
        if step < self.observe_steps:
            return None
        if self.frozen is None:
            self.frozen = self.scales()
        return self.frozen

    def observe(self, step: int, observers: Dict[str, List[torch.Tensor]]) -> None:
        """Merge one step's observers (train/qat.py's {name: [amax, ...]})
        while the observers run; later steps change nothing."""
        if step >= self.observe_steps:
            return
        for name, vals in observers.items():
            a = torch.stack([v.detach() for v in vals]).amax(0)
            prev = self.amax.get(name)
            self.amax[name] = a if prev is None else torch.maximum(prev, a)

    def scales(self) -> Dict[str, object]:
        from ..train.qat import collect_act_scales

        return collect_act_scales({name: [a] for name, a in self.amax.items()})


@torch.inference_mode()
def class_ids(model: nn.Module, x: torch.Tensor) -> np.ndarray:
    """The eval-mode forward of ``x`` (in the model's dtype) -> argmax of the
    f32 logits over the classes, (B, h, w) int32 on the host."""
    logits = model.eval()(x.contiguous(memory_format=CL))
    return torch.argmax(logits.float(), dim=1).to(torch.int32).cpu().numpy()


def run(float_steps: int = 80, qat_steps: int = 80, observe_steps: Optional[int] = None,
        distill: float = 0.0, qat_lr: float = 5e-5, min_ch: int = 128,
        per_ch_act: bool = False, batch: int = 8, out: Optional[str] = None, device="cuda",
        *, make_model: Optional[Callable[[], nn.Module]] = None, hw=(320, 640)) -> dict:
    """The closure -> the JSON result (also printed); the int8 export is
    written to ``out/scene_seg_qat_int8.msgpack``. ``make_model`` builds
    the SceneSeg network on the CPU (default: full width and depth for
    320x640); ``hw`` is the scenes' size."""
    from ..convert.from_jax import state_dict_to_variables
    from ..export.checkpoints import save_msgpack
    from ..export.quantize import cast_quantized
    from ..models import SceneSegNetwork
    from ..train import create_seg_train_state, make_seg_train_step, segmentation_ce_loss
    from ..train.qat import distillation_kl, int8_variables_from_qat, make_qat_loss
    from ..train.train_step import adamw, optimizer_step

    device = torch.device(device)
    out_dir = pathlib.Path(out or default_out("qat_closure"))
    out_dir.mkdir(parents=True, exist_ok=True)

    # --- data (e2e_train_demo's recipe: the split pinned by index) -------------
    rng = np.random.default_rng(0)
    train = [seg_sample(i, hw) for i in range(N_TRAIN)]
    val = [seg_sample(VAL_SEED0 + i, hw) for i in range(N_VAL)]
    train_x = to_device(np.stack([t[0] for t in train]), device)
    train_y = torch.from_numpy(np.stack([t[1] for t in train])).to(device)
    val_x = to_device(np.stack([v[0] for v in val]), device)
    val_y = np.stack([v[1] for v in val])

    def next_batch():
        idx = torch.from_numpy(batch_indices(rng, N_TRAIN, batch)).to(device)
        return train_x[idx].contiguous(memory_format=CL), train_y[idx]

    print("[qat_closure] init...", flush=True)
    model = seeded_model(make_model or SceneSegNetwork, 0, device)
    state = create_seg_train_state(model, adamw(3e-4))
    step_fn = make_seg_train_step(segmentation_ce_loss, compute_dtype=torch.bfloat16)
    generator = torch.Generator(device=device).manual_seed(1)

    # --- phase 1: float training ------------------------------------------------
    t0 = time.perf_counter()
    loss = torch.tensor(float("nan"))
    for _ in range(float_steps):
        state, loss = step_fn(state, *next_batch(), generator)
    float_loss = float(loss)
    float_s = time.perf_counter() - t0
    print(f"[qat_closure] float phase done ({float_s:.0f}s)", flush=True)

    # --- phase 2: QAT fine-tune, observers running, then frozen (with BatchNorm
    # on its running statistics: the reference's "observer freezing, batch norm
    # freezing", exports/README.md:23), a new AdamW at the low QAT rate
    qat_opt = adamw(qat_lr)([(n, p) for n, p in model.named_parameters()
                             if p.is_floating_point()])
    # the distillation teacher: a snapshot of the converged float net (a
    # teacher that moves with the student collapses, as the JAX tool found)
    teacher = copy.deepcopy(model).eval().requires_grad_(False) if distill > 0.0 else None

    def base(out, tgt, x):
        loss = segmentation_ce_loss(out.float(), tgt)
        if teacher is not None:
            with torch.no_grad():
                t_logits = teacher(x)
            loss = loss + distill * distillation_kl(t_logits, out)
        return loss

    observe_steps = observe_steps if observe_steps is not None else qat_steps // 2
    schedule = ObserverSchedule(observe_steps)
    t0 = time.perf_counter()
    qloss = torch.tensor(float("nan"))
    for phase_step in range(qat_steps):
        static = schedule.static_scales(phase_step)
        if phase_step == observe_steps:
            print(f"[qat_closure] freezing observers at step {phase_step}", flush=True)
        qat_loss = make_qat_loss(model, base, min_channels=min_ch, static_scales=static,
                                 freeze_bn=static is not None, per_channel_act=per_ch_act)
        x, y = next_batch()
        qat_opt.zero_grad(set_to_none=True)
        with torch.autocast(device.type, dtype=torch.bfloat16):
            qloss, observers = qat_loss(x, y, x, generator=generator)
        qloss.backward()
        optimizer_step(qat_opt)
        schedule.observe(phase_step, observers)
    act_scales = schedule.frozen if schedule.frozen is not None else schedule.scales()
    qat_loss_v = float(qloss.detach())
    qat_s = time.perf_counter() - t0
    print(f"[qat_closure] qat phase done ({qat_s:.0f}s)", flush=True)

    model.eval().requires_grad_(False)
    int8 = int8_variables_from_qat(model, act_scales, min_channels=min_ch)
    save_msgpack(out_dir / "scene_seg_qat_int8.msgpack", state_dict_to_variables(int8))

    # --- phase 3: the deployment programs side by side --------------------------
    bf16 = copy.deepcopy(model).to(torch.bfloat16)
    int8 = cast_quantized(int8, torch.bfloat16)
    pred_bf16 = class_ids(bf16, val_x.to(torch.bfloat16))
    print("[qat_closure] bf16 predict done", flush=True)
    pred_int8 = class_ids(int8, val_x.to(torch.bfloat16))
    print("[qat_closure] int8 predict done", flush=True)
    # the control: how far the bf16 program is from an f32 forward of the same
    # weights, the noise floor to judge the int8 agreement against
    pred_f32 = class_ids(model, val_x)
    print("[qat_closure] f32 control done", flush=True)
    agreement = float((pred_bf16 == pred_int8).mean())
    control = float((pred_bf16 == pred_f32).mean())

    result = {
        "metric": "qat_int8_closure",
        "float_steps": float_steps, "qat_steps": qat_steps,
        "float_loss": round(float_loss, 4),
        "qat_loss": round(qat_loss_v, 4),
        "argmax_agreement_int8_vs_bf16": round(agreement, 5),
        "control_agreement_bf16_vs_f32": round(control, 5),
        "miou_bf16": round(miou_of(pred_bf16, val_y), 4),
        "miou_int8": round(miou_of(pred_int8, val_y), 4),
        "miou_f32": round(miou_of(pred_f32, val_y), 4),
        "n_quantized_convs": len(act_scales),
        "min_ch": min_ch, "distill": distill,
        "per_ch_act": bool(per_ch_act),
        "observe_steps": observe_steps, "qat_lr": qat_lr,
        "float_train_s": round(float_s, 1), "qat_train_s": round(qat_s, 1),
    }
    print(json.dumps(result), flush=True)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--float-steps", type=int, default=80)
    ap.add_argument("--qat-steps", type=int, default=80)
    ap.add_argument("--observe-steps", type=int, default=None,
                    help="dynamic-observer steps before freezing (default qat_steps//2)")
    ap.add_argument("--distill", type=float, default=0.0,
                    help="weight of the self-distillation KL term (teacher: a snapshot "
                         "of the float net); optimizes int8-vs-bf16 agreement directly")
    ap.add_argument("--qat-lr", type=float, default=5e-5)
    # 128 matches the deployed int8 configuration: smaller convs are
    # launch-bound and int8 there only adds error; QAT mirrors deployment
    ap.add_argument("--min-ch", type=int, default=128)
    ap.add_argument("--per-ch-act", action="store_true",
                    help="per-input-channel activation scales (observed per channel, "
                         "folded into the int8 weights at export) instead of per-tensor")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--out", default=default_out("qat_closure"))
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    run(a.float_steps, a.qat_steps, a.observe_steps, a.distill, a.qat_lr, a.min_ch,
        a.per_ch_act, a.batch, a.out, a.device)
    return 0


if __name__ == "__main__":
    main()
