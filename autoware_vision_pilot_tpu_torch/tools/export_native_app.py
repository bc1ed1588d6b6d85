"""Export the per-frame pipeline as native-app bundles: the lateral step
always, and with --longitudinal the AutoSpeed detection step too; the port
of tools/export_native_app.py.

Produces the directory that ``autoware_vision_pilot_tpu_torch/host/tools/
visionpilot_app.cpp`` runs with no Python (export/native_app.py). The whole
lateral stack (preprocess -> EgoLanes -> temporal AutoSteer -> LaneFilter
-> LaneTracker -> PathFinder -> steering) is ONE AOTInductor package with
the carried state as explicit f32 wire tensors; the longitudinal bundle is
letterbox -> AutoSpeed "n" at 640x640 -> decode -> NMS, whose (max_det, 7)
table feeds the loop's ``--lon``, exported in a second process beside the
lateral one. On the card both call the hand kernels as the ``avp``
operators (csrc/torch_ops.cpp).

Weights: seed 0 by default (the export contract's proof); --lanes, --steer
and --speed take msgpack checkpoints (a JAX variables tree, as the JAX
tool's). f32, as the JAX tool exports.

Run: python -m autoware_vision_pilot_tpu_torch.tools.export_native_app
     [outdir] [--longitudinal] [--device cpu]
"""
from __future__ import annotations

import argparse
import contextlib
import multiprocessing
import pathlib
from concurrent.futures import ProcessPoolExecutor

import torch


def _export_longitudinal(out: str, frame_hw, speed: str, device: str) -> str:
    """The AutoSpeed bundle; main runs it in a process of its own beside
    the lateral export (each compile is minutes of g++ and Triton)."""
    from ..export.native_app import export_native_app
    from ..inference.infer import load_weights
    from ..models.auto_speed import AutoSpeedNetwork
    from ..runtime import Config
    from ..runtime.pipeline import build_longitudinal_step

    net = load_weights(AutoSpeedNetwork("n", 4, 640, 640), checkpoint=speed, device=device,
                       dtype=torch.float32)
    lon = build_longitudinal_step(net, Config(), frame_hw=frame_hw, input_hw=(640, 640),
                                  dtype=torch.float32)

    # the loop's contract is stateful; the detector is stateless: an empty
    # state (n_state 0)
    def lon_step(frame_u8, state):
        return {"dets": lon(frame_u8)}, state

    man = export_native_app(lon_step, (), (*frame_hw, 3), out, name="longitudinal",
                            outputs_from=lambda o: [o["dets"]], device=device)
    print(f"wrote {man}", flush=True)
    return str(man)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("out", nargs="?", default="exports/native_app")
    ap.add_argument("--lanes", default="", help="EgoLanes msgpack checkpoint")
    ap.add_argument("--steer", default="", help="AutoSteerTemporal msgpack checkpoint")
    ap.add_argument("--speed", default="", help="AutoSpeed msgpack checkpoint")
    ap.add_argument("--longitudinal", action="store_true",
                    help="also export the AutoSpeed detection bundle (letterbox -> net -> "
                         "decode -> NMS) the loop's --lon mode consumes")
    ap.add_argument("--frame-hw", default="720,1280")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    frame_hw = tuple(int(v) for v in args.frame_hw.split(","))

    from ..export.native_app import export_native_app
    from ..inference.infer import load_weights
    from ..models.auto_steer_temporal import AutoSteerTemporalNet
    from ..models.ego_lanes import EgoLanesNetwork
    from ..runtime import Config
    from ..runtime.pipeline import build_lateral_step, init_lateral_state

    with contextlib.ExitStack() as stack:
        lon = None
        if args.longitudinal:
            pool = stack.enter_context(ProcessPoolExecutor(
                1, mp_context=multiprocessing.get_context("spawn")))
            lon = pool.submit(_export_longitudinal, args.out, frame_hw, args.speed, args.device)
        kw = dict(device=args.device, dtype=torch.float32)
        lanes = load_weights(EgoLanesNetwork(), checkpoint=args.lanes, **kw)
        steer = load_weights(AutoSteerTemporalNet(), checkpoint=args.steer, **kw)
        step = build_lateral_step(lanes, steer, Config(), frame_hw=frame_hw, dtype=torch.float32)
        manifests = [export_native_app(step, init_lateral_state(0, device=args.device),
                                       (*frame_hw, 3), args.out, name="lateral",
                                       device=args.device)]
        print(f"wrote {manifests[-1]}", flush=True)
        if lon is not None:
            manifests.append(pathlib.Path(lon.result()))
    return manifests


if __name__ == "__main__":
    main()
