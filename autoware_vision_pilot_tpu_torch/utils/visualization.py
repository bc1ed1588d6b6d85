"""Visualization: mask overlays, lane polynomial draws, detection boxes,
depth colormaps, HUD text. The port's own copy of
autoware_vision_pilot_tpu/utils/visualization.py: host numpy and cv2
(optional), composing the final BGR frame on the host as the JAX package
does.

Host-side cv2 equivalents of production_release/src/visualization/
{visualize.cpp,visualize_long.cpp} and middleware_recipes/common/
visualizers/*: per-task colormaps (scene FG red, egolanes 3 colors,
domain orange), 50/50 blends, tracked-object boxes with CIPO highlight,
FCW/AEB banners. Heavy per-pixel colorize runs on device via
ops.postprocess.colorize_mask; these helpers handle the final BGR frame
composition.
"""
from __future__ import annotations


import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None

# scene seg: class 0 background (transparent-ish), 1 foreground red,
# 2 road (reference uses red FG only in masks_visualization_engine.cpp:40-58)
SCENE_SEG_PALETTE = np.array([
    [0, 0, 0],        # background
    [0, 0, 255],      # foreground objects (BGR red)
    [220, 255, 0],    # road (BGR cyan-ish as the unified GT road color)
], np.uint8)

EGO_LANES_COLORS = (
    (255, 0, 0),      # ego left — blue (BGR)
    (0, 0, 255),      # ego right — red
    (0, 255, 0),      # other lanes — green
)

DOMAIN_COLOR = (0, 165, 255)  # roadwork orange


def blend(image_bgr: np.ndarray, overlay_bgr: np.ndarray,
          alpha: float = 0.5) -> np.ndarray:
    return cv2.addWeighted(image_bgr, 1 - alpha, overlay_bgr, alpha, 0)


def draw_lane_masks(frame_bgr: np.ndarray, lane_masks: np.ndarray,
                    crop_y: int = 0) -> np.ndarray:
    """Overlay thresholded EgoLanes masks (h, w, 3 float 0/1) onto the
    frame (resized to the cropped region)."""
    out = frame_bgr.copy()
    region = out[crop_y:]
    h, w = region.shape[:2]
    for c, color in enumerate(EGO_LANES_COLORS):
        m = cv2.resize(lane_masks[..., c], (w, h),
                       interpolation=cv2.INTER_NEAREST) > 0.5
        region[m] = (np.asarray(color) * 0.5 +
                     region[m] * 0.5).astype(np.uint8)
    return out


def draw_polyfit_lanes(frame_bgr: np.ndarray, coeffs6, color=(255, 200, 0),
                       crop_y: int = 0, model_hw=(80, 160),
                       thickness: int = 3) -> np.ndarray:
    """Draw a model-space quadratic x=f(y) onto the full frame."""
    c = np.asarray(coeffs6, np.float64)
    h, w = frame_bgr.shape[:2]
    sx = w / model_hw[1]
    sy = (h - crop_y) / model_hw[0]
    pts = []
    y0, y1 = c[4], c[5]
    if y1 <= y0:
        return frame_bgr
    for y in np.linspace(y0, y1, 24):
        x = c[1] * y * y + c[2] * y + c[3]
        pts.append((int(x * sx), int(y * sy) + crop_y))
    for a, b in zip(pts[:-1], pts[1:]):
        cv2.line(frame_bgr, a, b, color, thickness)
    return frame_bgr


def draw_detections(frame_bgr: np.ndarray, tracked_objects,
                    cipo_track_id: int = -1) -> np.ndarray:
    """Tracked-object boxes with CIPO highlight (visualize_long.cpp)."""
    for obj in tracked_objects:
        x, y, w, h = obj.bbox
        is_cipo = obj.track_id == cipo_track_id
        color = (0, 0, 255) if is_cipo else (0, 255, 0)
        cv2.rectangle(frame_bgr, (x, y), (x + w, y + h), color,
                      3 if is_cipo else 2)
        label = (f"#{obj.track_id} L{obj.class_id} "
                 f"{obj.distance_m:.1f}m {obj.velocity_ms:+.1f}m/s")
        cv2.putText(frame_bgr, label, (x, max(y - 6, 12)),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.5, color, 1)
    return frame_bgr


def draw_hud(frame_bgr: np.ndarray, steering_deg: float = 0.0,
             set_speed: float = 0.0, fps: float = 0.0,
             fcw: bool = False, aeb: bool = False,
             cut_in: bool = False,
             lane_departure: bool = False) -> np.ndarray:
    """Status text + FCW/AEB banners (main.cpp:905-974)."""
    h, w = frame_bgr.shape[:2]
    cv2.putText(frame_bgr,
                f"steer {steering_deg:+.1f}deg  v_set {set_speed:.1f}m/s  "
                f"{fps:.1f} FPS",
                (12, 28), cv2.FONT_HERSHEY_SIMPLEX, 0.7, (255, 255, 255), 2)
    banner_y = 64
    if aeb:
        cv2.rectangle(frame_bgr, (0, banner_y - 28), (w, banner_y + 8),
                      (0, 0, 255), -1)
        cv2.putText(frame_bgr, "AUTOMATIC EMERGENCY BRAKING",
                    (w // 2 - 220, banner_y), cv2.FONT_HERSHEY_SIMPLEX,
                    0.8, (255, 255, 255), 2)
    elif fcw:
        cv2.rectangle(frame_bgr, (0, banner_y - 28), (w, banner_y + 8),
                      (0, 120, 255), -1)
        cv2.putText(frame_bgr, "FORWARD COLLISION WARNING",
                    (w // 2 - 200, banner_y), cv2.FONT_HERSHEY_SIMPLEX,
                    0.8, (255, 255, 255), 2)
    if cut_in:
        cv2.putText(frame_bgr, "CUT-IN", (12, 96),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.8, (0, 255, 255), 2)
    if lane_departure:
        cv2.putText(frame_bgr, "LANE DEPARTURE", (12, 128),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.8, (0, 0, 255), 2)
    return frame_bgr


def draw_lane_masks_roi(frame_bgr: np.ndarray, lane_masks: np.ndarray,
                        crop_y: int = 420,
                        work_wh=(640, 320)) -> np.ndarray:
    """Lane overlay through the reference's exact ROI pipeline
    (main.cpp:891-902): take the cropped region below crop_y, resize it
    DOWN to the 640x320 working resolution, draw the masks in place
    there, then resize back up into the region. The double resize is
    what gives the reference display its soft mask edges."""
    out = frame_bgr.copy()
    region = out[crop_y:]
    work = cv2.resize(region, work_wh)
    for c, color in enumerate(EGO_LANES_COLORS):
        m = cv2.resize(lane_masks[..., c], work_wh,
                       interpolation=cv2.INTER_NEAREST) > 0.5
        work[m] = (np.asarray(color) * 0.5 + work[m] * 0.5).astype(
            np.uint8)
    out[crop_y:] = cv2.resize(work, (region.shape[1], region.shape[0]))
    return out


def draw_safety_alerts(frame_bgr: np.ndarray, fcw: bool,
                       aeb: bool) -> np.ndarray:
    """AEB/FCW text alerts with the reference's exact strings, positions
    and colors (main.cpp:930-939); AEB takes precedence."""
    w = frame_bgr.shape[1]
    if aeb:
        cv2.putText(frame_bgr, "!!! AEB ACTIVE !!!",
                    (w // 2 - 220, 120), cv2.FONT_HERSHEY_DUPLEX, 1.4,
                    (0, 0, 255), 3)
    elif fcw:
        cv2.putText(frame_bgr, "! FORWARD COLLISION WARNING !",
                    (w // 2 - 300, 120), cv2.FONT_HERSHEY_DUPLEX, 1.0,
                    (0, 128, 255), 2)
    return frame_bgr


def draw_cipo_hud(frame_bgr: np.ndarray, ideal_speed_ms: float,
                  safe_distance_m: float,
                  control_effort_ms2: float) -> np.ndarray:
    """Top-right CIPO HUD: set speed, RSS safe distance, color-coded
    control effort (green accelerate / red decelerate) — main.cpp:941-965.
    Call only when a CIPO exists, as the reference does."""
    w = frame_bgr.shape[1]
    cv2.putText(frame_bgr, f"Set: {ideal_speed_ms:.1f} m/s",
                (w - 300, 30), cv2.FONT_HERSHEY_SIMPLEX, 0.8,
                (0, 255, 255), 2)
    cv2.putText(frame_bgr, f"d_safe: {safe_distance_m:.1f}m",
                (w - 300, 60), cv2.FONT_HERSHEY_SIMPLEX, 0.7,
                (200, 200, 0), 2)
    effort_color = (0, 255, 0) if control_effort_ms2 >= 0 else (0, 0, 255)
    cv2.putText(frame_bgr, f"Effort: {control_effort_ms2:.2f} m/s^2",
                (w - 300, 90), cv2.FONT_HERSHEY_SIMPLEX, 0.7,
                effort_color, 2)
    return frame_bgr


def draw_frame_sync_label(frame_bgr: np.ndarray,
                          frame_num: int) -> np.ndarray:
    """Frame counter + SYNCHRONIZED indicator (main.cpp:968-974)."""
    cv2.putText(frame_bgr, f"Frame: {frame_num}", (10, 30),
                cv2.FONT_HERSHEY_SIMPLEX, 1.0, (0, 255, 255), 2)
    cv2.putText(frame_bgr, "SYNCHRONIZED", (10, 70),
                cv2.FONT_HERSHEY_SIMPLEX, 0.8, (0, 255, 0), 2)
    return frame_bgr


def unified_display_frame(frame_bgr: np.ndarray, lane_masks: np.ndarray,
                          tracked_objects=(), cipo_track_id: int = -1,
                          steering_deg: float = 0.0,
                          gt_steering_deg: float | None = None,
                          wheel_pred: np.ndarray | None = None,
                          wheel_gt: np.ndarray | None = None,
                          lane_departure: bool = False,
                          fcw: bool = False, aeb: bool = False,
                          cipo_exists: bool = False,
                          ideal_speed_ms: float = 0.0,
                          safe_distance_m: float = 0.0,
                          control_effort_ms2: float = 0.0,
                          frame_num: int = 0, crop_y: int = 420,
                          display_wh=(1280, 720)) -> np.ndarray:
    """The unified display composite in the REFERENCE's exact overlay
    order (unifiedDisplayThread, main.cpp:881-974):

      1. tracked-object boxes + CIPO on the full frame
      2. lane masks through the cropped-ROI 640x320 work-res pipeline
      3. resize to the display size, steering wheels (pred top-left,
         CAN ground truth top-right when valid)
      4. lane-departure banner
      5. AEB / FCW alerts
      6. CIPO HUD (set speed / d_safe / color-coded effort)
      7. frame counter + SYNCHRONIZED label
    """
    out = frame_bgr.copy()
    if tracked_objects:
        out = draw_detections(out, tracked_objects,
                              cipo_track_id=cipo_track_id)
    if lane_masks is not None:
        out = draw_lane_masks_roi(out, lane_masks, crop_y=crop_y)
    out = cv2.resize(out, display_wh)
    if wheel_pred is not None:
        rot_pred = rotate_steering_wheel(wheel_pred, steering_deg)
        rot_gt = None
        if gt_steering_deg is not None and wheel_gt is not None:
            rot_gt = rotate_steering_wheel(wheel_gt, gt_steering_deg)
        out = visualize_steering(out, steering_deg, rot_pred,
                                 gt_steering_deg, rot_gt)
    if lane_departure:
        out = show_lane_departure_warning(out)
    out = draw_safety_alerts(out, fcw=fcw, aeb=aeb)
    if cipo_exists:
        out = draw_cipo_hud(out, ideal_speed_ms, safe_distance_m,
                            control_effort_ms2)
    return draw_frame_sync_label(out, frame_num)


class FrameSyncBuffer:
    """Frame-id matcher for split lateral/longitudinal result streams
    (unifiedDisplayThread's lateral_buffer/long_buffer maps +
    lag cleanup, main.cpp:868-888 and 1112-1118).

    push results from either side; `pop_synced()` yields (frame_num,
    lateral, longitudinal) pairs in order and evicts them. Either buffer
    is capped at `max_lag` — if one pipeline stalls, the oldest unmatched
    frames are dropped rather than growing without bound."""

    def __init__(self, max_lag: int = 10):
        self.max_lag = max_lag
        self._lat: dict = {}
        self._lon: dict = {}

    def push_lateral(self, frame_num: int, result):
        self._lat[frame_num] = result
        self._trim()

    def push_longitudinal(self, frame_num: int, result):
        self._lon[frame_num] = result
        self._trim()

    def pop_synced(self):
        ready = sorted(self._lat.keys() & self._lon.keys())
        out = [(n, self._lat.pop(n), self._lon.pop(n)) for n in ready]
        return out

    def _trim(self):
        for buf in (self._lat, self._lon):
            while len(buf) > self.max_lag:
                buf.pop(min(buf))


def depth_to_colormap(depth01: np.ndarray) -> np.ndarray:
    """Relative depth in [0,1] -> BGR colormap image."""
    d = np.clip(np.asarray(depth01) * 255, 0, 255).astype(np.uint8)
    return cv2.applyColorMap(d, cv2.COLORMAP_PLASMA)


# ---- steering wheel composite (visualize.cpp:856-970) ----------------------

def make_steering_wheel_image(size: int = 128) -> np.ndarray:
    """Synthesize a BGRA steering-wheel sprite.

    The reference loads a wheel PNG and substitutes a dummy image when the
    file is missing (main.cpp:846-852); this procedural wheel is that
    fallback done properly — rim, three spokes, hub, alpha outside.
    """
    img = np.zeros((size, size, 4), np.uint8)
    c = size // 2
    r_out = int(size * 0.46)
    r_in = int(size * 0.36)
    color = (40, 40, 40, 255)
    cv2.circle(img, (c, c), r_out, color, -1, cv2.LINE_AA)
    cv2.circle(img, (c, c), r_in, (0, 0, 0, 0), -1, cv2.LINE_AA)
    for ang in (90.0, 210.0, 330.0):
        t = np.deg2rad(ang)
        x2 = int(c + r_in * np.cos(t))
        y2 = int(c + r_in * np.sin(t))
        cv2.line(img, (c, c), (x2, y2), color, max(2, size // 16),
                 cv2.LINE_AA)
    cv2.circle(img, (c, c), max(3, size // 10), color, -1, cv2.LINE_AA)
    return img


def rotate_steering_wheel(wheel_bgra: np.ndarray,
                          steering_angle_deg: float) -> np.ndarray:
    """Half-res resize then rotate about center with transparent borders
    (rotateSteeringWheel, visualize.cpp:856-881)."""
    if wheel_bgra is None or wheel_bgra.size == 0:
        return np.zeros((0, 0, 4), np.uint8)
    resized = cv2.resize(wheel_bgra, None, fx=0.5, fy=0.5,
                         interpolation=cv2.INTER_LINEAR)
    center = (resized.shape[1] / 2.0, resized.shape[0] / 2.0)
    rot = cv2.getRotationMatrix2D(center, steering_angle_deg, 1.0)
    return cv2.warpAffine(resized, rot,
                          (resized.shape[1], resized.shape[0]),
                          flags=cv2.INTER_LINEAR,
                          borderMode=cv2.BORDER_CONSTANT,
                          borderValue=(0, 0, 0, 0))


def overlay_alpha(img_bgr: np.ndarray, overlay_bgra: np.ndarray,
                  x: int, y: int) -> np.ndarray:
    """Alpha-blend a BGRA sprite onto the frame at (x, y); silently skips
    out-of-bounds placements (visualizeWheel, visualize.cpp:884-920)."""
    if overlay_bgra is None or overlay_bgra.size == 0:
        return img_bgr
    h, w = overlay_bgra.shape[:2]
    if x < 0 or y < 0 or x + w > img_bgr.shape[1] or \
            y + h > img_bgr.shape[0]:
        return img_bgr
    roi = img_bgr[y:y + h, x:x + w].astype(np.float32) / 255.0
    if overlay_bgra.shape[2] == 4:
        rgb = overlay_bgra[..., :3].astype(np.float32) / 255.0
        a = (overlay_bgra[..., 3:4].astype(np.float32) / 255.0)
        blended = rgb * a + roi * (1.0 - a)
        img_bgr[y:y + h, x:x + w] = (blended * 255.0).astype(np.uint8)
    else:
        img_bgr[y:y + h, x:x + w] = overlay_bgra[..., :3]
    return img_bgr


def visualize_steering(img_bgr: np.ndarray, steering_angle: float,
                       rotated_pred_wheel: np.ndarray,
                       gt_steering_angle: float | None = None,
                       rotated_gt_wheel: np.ndarray | None = None
                       ) -> np.ndarray:
    """Predicted wheel top-left + angle text; optional GT wheel top-right
    (visualizeSteering, visualize.cpp:921-968)."""
    w = img_bgr.shape[1]
    overlay_alpha(img_bgr, rotated_pred_wheel, 10, 10)
    if rotated_gt_wheel is not None and rotated_gt_wheel.size:
        overlay_alpha(img_bgr, rotated_gt_wheel, w - 80, 10)
    cv2.putText(img_bgr, f"Predicted angle: {steering_angle:.2f}",
                (10, 100), cv2.FONT_HERSHEY_SIMPLEX, 0.6,
                (62, 202, 130), 2)
    if gt_steering_angle is not None and not np.isnan(gt_steering_angle):
        cv2.putText(img_bgr, f"GT angle: {gt_steering_angle:.2f}",
                    (w - 180, 100), cv2.FONT_HERSHEY_SIMPLEX, 0.6,
                    (255, 255, 255), 2)
    return img_bgr


def show_lane_departure_warning(img_bgr: np.ndarray) -> np.ndarray:
    """Centered warning banner (showLaneDepartureWarning,
    visualize.cpp:970-992)."""
    width, height = 200, 40
    x = img_bgr.shape[1] // 2 - width // 2
    cv2.rectangle(img_bgr, (x, 20), (x + width, 20 + height),
                  (51, 153, 153))
    cv2.putText(img_bgr, "LANE DEPARTURE WARNING",
                (img_bgr.shape[1] // 2, 40), cv2.FONT_HERSHEY_SIMPLEX,
                2.0, (0, 0, 0), 2)
    return img_bgr


# ---- BEV debug view (drawBEVVis, visualize.cpp:584-770) --------------------

def gen_bev_points(coeffs6, bev_h: int = 640) -> np.ndarray:
    """Quadratic BEV coeffs [0, a, b, c, min_y, max_y] -> (N, 2) int points
    x = a*y^2 + b*y + c sampled per row inside [min_y, max_y] and the
    640-wide grid (genBEVPoints)."""
    c = np.asarray(coeffs6, np.float64)
    if c.size < 6:
        return np.zeros((0, 2), np.int32)
    a, b, cc, min_y, max_y = c[1], c[2], c[3], c[4], c[5]
    ys = np.arange(bev_h, dtype=np.float64)
    keep = (ys >= min_y) & (ys <= max_y)
    xs = a * ys * ys + b * ys + cc
    keep &= (xs >= 0) & (xs < 640)
    return np.stack([xs[keep], ys[keep]], -1).astype(np.int32)


def draw_bev_vis(orig_frame_bgr: np.ndarray, H_orig_to_bev: np.ndarray,
                 bev_left_coeffs=None, bev_right_coeffs=None,
                 bev_center_coeffs=None, valid: bool = True,
                 last_valid_width_pixels: float = 0.0) -> np.ndarray:
    """640x640 BEV debug composite: perspective-warped frame + ego-left
    (blue) / ego-right (magenta) / center (yellow) quadratics + lane-width
    bar near the bottom (drawBEVVis, visualize.cpp:619-770)."""
    bev = cv2.warpPerspective(orig_frame_bgr,
                              np.asarray(H_orig_to_bev, np.float64),
                              (640, 640))
    if not valid:
        cv2.putText(bev, "BEV Tracking: Waiting...", (20, 40),
                    cv2.FONT_HERSHEY_SIMPLEX, 1.0, (0, 0, 255), 2)
        return bev
    for coeffs, color in ((bev_left_coeffs, (255, 0, 0)),
                          (bev_right_coeffs, (255, 0, 200)),
                          (bev_center_coeffs, (0, 255, 255))):
        if coeffs is None:
            continue
        pts = gen_bev_points(coeffs)
        if len(pts) > 1:
            cv2.polylines(bev, [pts.reshape(-1, 1, 2)], False, color, 4,
                          cv2.LINE_AA)
    if last_valid_width_pixels > 0:
        y, cx = 600, 320
        half = int(last_valid_width_pixels / 2.0)
        cv2.line(bev, (cx - half, y), (cx + half, y), (255, 255, 255), 2)
        for ex in (cx - half, cx + half):
            cv2.line(bev, (ex, y - 10), (ex, y + 10), (255, 255, 255), 2)
        cv2.putText(bev, f"Lane Width: {last_valid_width_pixels:.0f} px",
                    (cx - 90, y - 18), cv2.FONT_HERSHEY_SIMPLEX, 0.6,
                    (255, 255, 255), 2)
    return bev

def make_stacked_view(view_debug: np.ndarray, view_final: np.ndarray,
                      view_bev: np.ndarray,
                      window_height: int = 720) -> np.ndarray:
    """Final composite layout (main.cpp:1286-1328):

        | [Debug] | [ BEV (640x640) ]
        | [Final] | [ black space   ]

    Left column = debug stacked on final, resized to window height
    preserving aspect; right column = BEV copied onto a black canvas of
    the same height; columns concatenated horizontally.
    """
    left_col = np.concatenate([view_debug, view_final], axis=0)
    aspect = left_col.shape[1] / left_col.shape[0]
    left_col = cv2.resize(left_col,
                          (int(window_height * aspect), window_height))
    right_col = np.zeros((window_height, view_bev.shape[1], 3), np.uint8)
    h = min(view_bev.shape[0], window_height)
    right_col[:h] = view_bev[:h]
    return np.concatenate([left_col, right_col], axis=1)
