"""Per-model video visualization — the Models/visualizations/* scripts
(e.g. SceneSeg/video_visualization.py:12-155: read -> infer -> colormap ->
0.5 blend -> MJPG write) as one parameterized tool; the port of
autoware_vision_pilot_tpu/utils/video_viz.py. Each frame goes through the
port's inference/infer.py wrapper on ``device`` (the card unless told
otherwise: the preprocess kernel, or for AutoSpeed the letterbox and NMS
kernels); the composite is drawn on the host with cv2.

Run: python -m autoware_vision_pilot_tpu_torch.utils.video_viz \
        --model SceneSeg --video in.mp4 --out out.avi [--checkpoint ckpt] \
        [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None

from .visualization import (
    SCENE_SEG_PALETTE, blend, draw_lane_masks, depth_to_colormap,
)


def visualize_video(model_name: str, video_path: str, out_path: str,
                    checkpoint: str = "", max_frames: int | None = None,
                    fps: float = 20.0, device="cuda") -> int:
    from ..inference import (
        SceneSegInfer, Scene3DInfer, DomainSegInfer, EgoLanesInfer,
        AutoSpeedInfer)

    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        raise RuntimeError(f"cannot open {video_path}")
    ok, frame = cap.read()
    if not ok:
        raise RuntimeError("empty video")
    h, w = frame.shape[:2]
    writer = cv2.VideoWriter(out_path, cv2.VideoWriter_fourcc(*"MJPG"),
                             fps, (w, h))

    if model_name == "SceneSeg":
        infer = SceneSegInfer(checkpoint=checkpoint, device=device)
    elif model_name == "Scene3D":
        infer = Scene3DInfer(checkpoint=checkpoint, device=device)
    elif model_name == "DomainSeg":
        infer = DomainSegInfer(checkpoint=checkpoint, device=device)
    elif model_name == "EgoLanes":
        infer = EgoLanesInfer(checkpoint=checkpoint, device=device)
    elif model_name == "AutoSpeed":
        infer = AutoSpeedInfer(checkpoint=checkpoint, frame_hw=(h, w), device=device)
    else:
        raise ValueError(f"unknown model {model_name}")

    n = 0
    t0 = time.perf_counter()
    while ok and (max_frames is None or n < max_frames):
        if model_name == "SceneSeg":
            ids = infer.inference(frame)
            color = np.asarray(SCENE_SEG_PALETTE)[ids]
            color = cv2.resize(color, (w, h),
                               interpolation=cv2.INTER_NEAREST)
            out = blend(frame, color)
        elif model_name == "Scene3D":
            d = infer.inference(frame)
            cm = cv2.resize(depth_to_colormap(d), (w, h))
            out = blend(frame, cm)
        elif model_name == "DomainSeg":
            m = infer.inference(frame).astype(np.uint8)
            color = np.zeros((*m.shape, 3), np.uint8)
            color[m > 0] = (0, 165, 255)
            out = blend(frame, cv2.resize(color, (w, h),
                                          interpolation=cv2.INTER_NEAREST))
        elif model_name == "EgoLanes":
            masks = infer.inference(frame)
            out = draw_lane_masks(frame, masks)
        else:  # AutoSpeed
            dets = infer.inference(frame)
            out = frame.copy()
            for x1, y1, x2, y2, s, c in dets:
                cv2.rectangle(out, (int(x1), int(y1)), (int(x2), int(y2)),
                              (0, 255, 0), 2)
                cv2.putText(out, f"{int(c)}:{s:.2f}",
                            (int(x1), max(int(y1) - 4, 10)),
                            cv2.FONT_HERSHEY_SIMPLEX, 0.5, (0, 255, 0), 1)
        writer.write(out)
        n += 1
        ok, frame = cap.read()
    writer.release()
    cap.release()
    dt = time.perf_counter() - t0
    print(f"[viz] {model_name}: {n} frames in {dt:.1f}s ({n / dt:.1f} FPS) "
          f"-> {out_path}")
    return n


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", required=True)
    ap.add_argument("--video", required=True)
    ap.add_argument("--out", default="viz_out.avi")
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    visualize_video(a.model, a.video, a.out, a.checkpoint, a.max_frames, device=a.device)


if __name__ == "__main__":
    main()


def visualize_steering_graph(gt_angles, prediction_angles,
                             output_file: str | None = None,
                             show: bool = False):
    """GT-vs-prediction steering angle line plot
    (Models/visualizations/AutoSteer/graph_visualization.py:27-49)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    x = np.arange(len(gt_angles))
    fig = plt.figure(figsize=(12, 4))
    plt.plot(x, gt_angles, label="Ground Truth", color="green",
             linewidth=2)
    plt.plot(x, prediction_angles, label="Prediction", color="blue",
             linewidth=2, linestyle="--")
    plt.xlabel("Sample")
    plt.ylabel("Value")
    plt.title("Ground Truth/Prediction")
    plt.legend()
    plt.grid(True)
    plt.tight_layout()
    if output_file is not None:
        plt.savefig(output_file, dpi=300)
    if show:  # pragma: no cover
        plt.show()
    plt.close(fig)
    return fig


def mass_visualize_videos(model_name: str, video_dir: str, out_dir: str,
                          checkpoint: str = "",
                          max_frames: int | None = None,
                          suffix: str = ".mp4", device="cuda") -> list:
    """Run visualize_video over every video in a directory — the
    mass-video regression sweep
    (Models/visualizations/EgoLanes/mass_test_vid_inference.py), in-process
    instead of per-video subprocesses."""
    import os
    os.makedirs(out_dir, exist_ok=True)
    done = []
    for name in sorted(os.listdir(video_dir)):
        if not name.endswith(suffix):
            continue
        vid_id = name.rsplit(".", 1)[0]
        out_path = os.path.join(out_dir, vid_id + ".avi")
        n = visualize_video(model_name, os.path.join(video_dir, name),
                            out_path, checkpoint=checkpoint,
                            max_frames=max_frames, device=device)
        done.append((name, out_path, n))
    return done
