"""Manual end-to-end debug harness (the test_autosteer.cpp analog), the port
of tools/debug_autosteer.py: EgoLanes -> temporal AutoSteer over a video,
printing per-frame tensor statistics and frame-to-frame tensor diffs to
catch "identical tensor" temporal-buffer bugs (test_autosteer.cpp:21-82).

Each frame goes through ``EgoLanesInfer.inference_raw`` (the preprocess
kernel, EgoLanes, the raw pre-threshold logits) and, from the second frame
on, ``AutoSteerInfer`` on the logits of frames t-1 and t.

Run: python -m autoware_vision_pilot_tpu_torch.tools.debug_autosteer
     --video in.mp4 [--frames 30] [--egolanes-ckpt W] [--autosteer-ckpt W]
     [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import sys


def run(video: str, frames: int = 30, egolanes_ckpt: str = "", autosteer_ckpt: str = "",
        device="cuda", *, lanes=None, steer=None) -> dict:
    """-> {"frames": frames read, "diffs": max |logits t - logits t-1| from
    the second frame on, "angles": the steering of each of those frames};
    prints the statistics, the diffs and the angles as the JAX tool does.
    ``lanes`` and ``steer`` replace the default wrappers (an EgoLanesInfer
    and an AutoSteerInfer on ``device``)."""
    import cv2
    from ..inference import AutoSteerInfer, EgoLanesInfer
    from ..utils.benchmark import compare_tensors, tensor_stats

    lanes = lanes or EgoLanesInfer(checkpoint=egolanes_ckpt, device=device)
    steer = steer or AutoSteerInfer(checkpoint=autosteer_ckpt, device=device)

    cap = cv2.VideoCapture(video)
    # AutoSteer consumes the RAW pre-threshold EgoLanes logits
    # (main.cpp:516-524 / test_autosteer.cpp compares raw tensors):
    # thresholded masks give wrong steering angles.
    prev_raw = None
    n, diffs, angles = 0, [], []
    for i in range(frames):
        ok, frame = cap.read()
        if not ok:
            break
        n += 1
        raw = lanes.inference_raw(frame)
        tensor_stats(f"frame {i} egolanes raw logits", raw)
        if prev_raw is not None:
            diffs.append(compare_tensors(prev_raw, raw, f"egolanes t-1 vs t (frame {i})"))
            angle = steer.inference(prev_raw, raw)
            angles.append(angle)
            print(f"  -> steering {angle:+.1f} deg")
        prev_raw = raw
    cap.release()
    return {"frames": n, "diffs": diffs, "angles": angles}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--video", required=True)
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--egolanes-ckpt", default="")
    ap.add_argument("--autosteer-ckpt", default="")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    run(a.video, a.frames, a.egolanes_ckpt, a.autosteer_ckpt, a.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
