"""Camera / video source utilities (production_release/src/camera/
camera_utils.cpp: v4l2 enumeration, interactive selection, verification,
open, driver help); the port's own copy of
autoware_vision_pilot_tpu/drivers/camera.py. cv2 is needed only by the
functions that open a device or a video."""
from __future__ import annotations

import dataclasses
import glob
import pathlib
import re
from typing import Callable, List, Optional, Tuple

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


@dataclasses.dataclass
class CameraInfo:
    """One enumerated device (camera_utils.cpp CameraDevice)."""
    index: int
    path: str
    name: str = ""
    width: int = 0
    height: int = 0
    fps: float = 0.0


def _device_name(index: int) -> str:
    p = pathlib.Path(f"/sys/class/video4linux/video{index}/name")
    try:
        return p.read_text().strip()
    except OSError:
        return ""


def list_cameras(max_devices: int = 10) -> List[int]:
    """Enumerate /dev/video* nodes that open and deliver a frame."""
    return [d.index for d in enumerate_cameras(max_devices)]


def enumerate_cameras(max_devices: int = 10) -> List[CameraInfo]:
    """Enumerate working /dev/video* devices with name/format details
    (camera_utils.cpp listCameras)."""
    found = []
    for path in sorted(glob.glob("/dev/video*")):
        m = re.search(r"(\d+)$", path)
        if not m:
            continue
        idx = int(m.group(1))
        if idx >= max_devices:
            continue
        cap = cv2.VideoCapture(idx)
        if cap.isOpened():
            ok, _ = cap.read()
            if ok:
                found.append(CameraInfo(
                    index=idx, path=path, name=_device_name(idx),
                    width=int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
                    height=int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
                    fps=float(cap.get(cv2.CAP_PROP_FPS))))
        cap.release()
    return found


def select_camera(input_fn: Callable[[str], str] = input,
                  print_fn: Callable[[str], None] = print,
                  devices: Optional[List[CameraInfo]] = None,
                  ) -> Optional[CameraInfo]:
    """Interactive camera selection (camera_utils.cpp selectCamera
    :140-220): list devices with name/format, prompt for an index,
    'q' quits. IO is injected so the flow is testable headless. Returns
    the chosen CameraInfo or None."""
    if devices is None:
        devices = enumerate_cameras()
    if not devices:
        print_fn("\nNo camera devices found.")
        print_driver_instructions(print_fn)
        return None
    print_fn("\nAvailable cameras:\n")
    for i, d in enumerate(devices):
        fmt = ""
        if d.width and d.height:
            fmt = f" ({d.width}x{d.height}"
            fmt += f" @ {d.fps:.0f} fps)" if d.fps > 0 else ")"
        print_fn(f"  [{i}] {d.path} - {d.name}{fmt}")
    ans = input_fn(f"\nSelect camera [0-{len(devices) - 1}] "
                   f"or 'q' to quit: ").strip()
    if ans.lower() == "q":
        return None
    try:
        idx = int(ans)
    except ValueError:
        print_fn("Invalid selection.")
        return None
    if 0 <= idx < len(devices):
        return devices[idx]
    print_fn("Invalid selection.")
    return None


def verify_camera(device) -> bool:
    """Open + capture one frame to prove the device works
    (camera_utils.cpp verifyCamera :222-243)."""
    cap = cv2.VideoCapture(device)
    if not cap.isOpened():
        return False
    ok, frame = cap.read()
    cap.release()
    return bool(ok) and frame is not None and frame.size > 0


def print_driver_instructions(print_fn: Callable[[str], None] = print):
    """Manual driver-installation help (camera_utils.cpp
    printDriverInstructions :252-270)."""
    print_fn("=" * 40)
    print_fn("Manual Driver Installation")
    print_fn("=" * 40)
    print_fn("1. Place the driver package (.deb) in camera_driver/")
    print_fn("2. Install: sudo dpkg -i camera_driver/*.deb; sudo modprobe -a")
    print_fn("3. Verify devices: ls -l /dev/video*")
    print_fn("4. Run this program again")
    print_fn("=" * 40)


def open_camera(device_id: Optional[int] = None,
                resolution: Tuple[int, int] = (1280, 720)):
    """Open and verify a camera; auto-select the first working one when
    device_id is None."""
    if device_id is None:
        cams = list_cameras()
        if not cams:
            raise RuntimeError("no working cameras found")
        device_id = cams[0]
    cap = cv2.VideoCapture(device_id)
    if not cap.isOpened():
        raise RuntimeError(f"cannot open camera {device_id}")
    cap.set(cv2.CAP_PROP_FRAME_WIDTH, resolution[0])
    cap.set(cv2.CAP_PROP_FRAME_HEIGHT, resolution[1])
    ok, _ = cap.read()
    if not ok:
        cap.release()
        raise RuntimeError(f"camera {device_id} opened but delivers no frames")
    return cap


def open_video(path: str):
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise RuntimeError(f"cannot open video {path}")
    return cap
