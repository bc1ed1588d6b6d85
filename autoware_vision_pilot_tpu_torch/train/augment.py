"""Data augmentations on the device, the port of
autoware_vision_pilot_tpu/train/augment.py: the reference's
Albumentations pipelines (Models/data_utils/augmentations.py:34-113:
flip, grid shuffle, the per-profile noise sets) as batched tensor ops.

Every op takes a ``torch.Generator`` in place of the JAX key and NHWC
image batches (float in [0, 1]) with matching label maps, as the JAX
functions do. Its random numbers come from the four draw functions below
(``bernoulli``, ``uniform``, ``normal``, ``permutations``), in the order
the JAX op draws its own, so that a test can hand both packages the same
numbers. torch and JAX draw different numbers for one seed; the ops are
held to JAX with the same draws, never by their statistics.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..ops.preprocess import device_mean_std


def bernoulli(gen: torch.Generator, p: float, shape, device) -> torch.Tensor:
    """A bool tensor of ``shape``, each True with probability ``p`` (uniform
    < p, as jax.random.bernoulli)."""
    return (torch.rand(shape, generator=gen, device=gen.device) < p).to(device)


def uniform(gen: torch.Generator, shape, lo: float, hi: float, device) -> torch.Tensor:
    """Floats of ``shape`` uniform in [lo, hi)."""
    u = torch.rand(shape, generator=gen, device=gen.device)
    return (lo + u * (hi - lo)).to(device)


def normal(gen: torch.Generator, shape, device) -> torch.Tensor:
    """Standard normal floats of ``shape``."""
    return torch.randn(shape, generator=gen, device=gen.device).to(device)


def permutations(gen: torch.Generator, batch: int, n: int, device) -> torch.Tensor:
    """(batch, n) int64: a random permutation of range(n) a row."""
    u = torch.rand((batch, n), generator=gen, device=gen.device)
    return u.argsort(-1).to(device)


def normalize_imagenet(img):
    mean, std = device_mean_std(img.device)
    return (img - mean) / std


def _gate(gen, prob, B, device):
    return bernoulli(gen, prob, (B, 1, 1, 1), device)


def random_hflip(gen, img, label=None, prob: float = 0.5):
    """Per-sample horizontal flip of an NHWC batch and its (B, H, W) or
    (B, H, W, C) labels."""
    B = img.shape[0]
    flip = bernoulli(gen, prob, (B, 1, 1, 1), img.device)
    img = torch.where(flip, img.flip(2), img)
    if label is not None:
        lf = flip.reshape(B, *([1] * (label.dim() - 1)))
        label = torch.where(lf, label.flip(2), label)
    return img, label


def _shuffle_cells(x, perms, apply, gy, gx):
    """Each sample's (gy, gx) grid of cells permuted by its row of
    ``perms`` where ``apply``; the rows and columns past the grid stay."""
    B, H, W, C = x.shape
    ch, cw = H // gy, W // gx
    cells = x[:, :gy * ch, :gx * cw].reshape(B, gy, ch, gx, cw, C).permute(0, 1, 3, 2, 4, 5)
    cells = cells.reshape(B, gy * gx, ch, cw, C)
    shuf = cells[torch.arange(B, device=x.device)[:, None], perms]
    out = shuf.reshape(B, gy, gx, ch, cw, C).permute(0, 1, 3, 2, 4, 5).reshape(
        B, gy * ch, gx * cw, C)
    full = x.clone()
    full[:, :gy * ch, :gx * cw] = out
    return torch.where(apply.reshape(B, 1, 1, 1), full, x)


def random_grid_shuffle(gen, img, label=None, grid: Tuple[int, int] = (1, 2),
                        prob: float = 0.25):
    """Shuffle the cells of a (gy, gx) grid (RandomGridShuffle), each sample
    with probability ``prob``."""
    B = img.shape[0]
    gy, gx = grid
    perms = permutations(gen, B, gy * gx, img.device)
    apply = bernoulli(gen, prob, (B,), img.device)
    img = _shuffle_cells(img, perms, apply, gy, gx)
    if label is not None:
        lab = label if label.dim() == 4 else label[..., None]
        lab = _shuffle_cells(lab.float(), perms, apply, gy, gx)
        label = lab.to(label.dtype) if label.dim() == 4 else lab[..., 0].to(label.dtype)
    return img, label


def gaussian_noise(gen, img, sigma: float = 0.02, prob: float = 0.5):
    apply = _gate(gen, prob, img.shape[0], img.device)
    noise = normal(gen, img.shape, img.device) * sigma
    return torch.clamp(torch.where(apply, img + noise, img), 0.0, 1.0)


def color_jitter(gen, img, brightness: float = 0.2, contrast: float = 0.2, prob: float = 0.5):
    B = img.shape[0]
    apply = _gate(gen, prob, B, img.device)
    b = uniform(gen, (B, 1, 1, 1), -brightness, brightness, img.device)
    c = uniform(gen, (B, 1, 1, 1), 1 - contrast, 1 + contrast, img.device)
    mean = img.mean((1, 2, 3), keepdim=True)
    out = (img - mean) * c + mean + b
    return torch.clamp(torch.where(apply, out, img), 0.0, 1.0)


def random_crop_resize(gen, img, label, out_hw: Tuple[int, int],
                       scale_range: Tuple[float, float] = (0.5, 2.0)):
    """A random scale crop resized to ``out_hw`` by nearest sampling, the
    labels with it (Lite 'random_crop' mode)."""
    B, H, W, _ = img.shape
    oh, ow = out_hw
    s = uniform(gen, (B,), scale_range[0], min(scale_range[1], 1.0), img.device)
    ch = torch.clamp_min((s * H).to(torch.int32), 8)
    cw = torch.clamp_min((s * W).to(torch.int32), 8)
    x0 = (uniform(gen, (B,), 0.0, 1.0, img.device) * (W - cw)).to(torch.int32)
    y0 = (uniform(gen, (B,), 0.0, 1.0, img.device) * (H - ch)).to(torch.int32)
    # each output row's source row: (i * crop height / oh) in float32, truncated
    ys = y0[:, None] + (torch.arange(oh, device=img.device) * ch[:, None] / oh).to(torch.int32)
    xs = x0[:, None] + (torch.arange(ow, device=img.device) * cw[:, None] / ow).to(torch.int32)
    b = torch.arange(B, device=img.device)[:, None, None]
    ys, xs = ys.long()[:, :, None], xs.long()[:, None, :]
    return img[b, ys, xs], label[b, ys, xs]


# ------------------------------------------------------------------
# Photometric and weather primitives (Albumentations analogs, batched)
# ------------------------------------------------------------------

def to_gray(gen, img, prob: float = 0.1):
    """A.ToGray(method='weighted_average')."""
    gate = _gate(gen, prob, img.shape[0], img.device)
    w = torch.tensor([0.299, 0.587, 0.114], dtype=img.dtype).to(img.device)
    g = torch.sum(img * w, -1, keepdim=True)
    return torch.where(gate, g.expand_as(img), img)


def multiplicative_noise(gen, img, multiplier=(0.5, 1.5), prob: float = 0.5):
    """A.MultiplicativeNoise(per_channel=False)."""
    B = img.shape[0]
    gate = _gate(gen, prob, B, img.device)
    m = uniform(gen, (B, 1, 1, 1), multiplier[0], multiplier[1], img.device)
    return torch.clamp(torch.where(gate, img * m, img), 0.0, 1.0)


def pixel_dropout(gen, img, dropout_prob: float = 0.025, prob: float = 0.25):
    """A.PixelDropout(per_channel=True)."""
    gate = _gate(gen, prob, img.shape[0], img.device)
    keep = bernoulli(gen, 1.0 - dropout_prob, img.shape, img.device)
    return torch.where(gate, img * keep, img)


def iso_noise(gen, img, color_shift=(0.1, 0.3), intensity: float = 0.5, prob: float = 0.5):
    """A.ISONoise: luma gaussian noise and a random per-channel shift."""
    B = img.shape[0]
    gate = _gate(gen, prob, B, img.device)
    luma = normal(gen, (*img.shape[:3], 1), img.device) * 0.05 * intensity
    shift = uniform(gen, (B, 1, 1, 1), color_shift[0], color_shift[1], img.device)
    col = normal(gen, (B, 1, 1, 3), img.device) * 0.05 * shift
    return torch.clamp(torch.where(gate, img + luma + col, img), 0.0, 1.0)


def random_fog(gen, img, alpha_coef: float = 0.1, prob: float = 0.25):
    """A.RandomFog analog: a blend toward white, denser near the top."""
    B, H, _, _ = img.shape
    gate = _gate(gen, prob, B, img.device)
    a = uniform(gen, (B, 1, 1, 1), 0.5, 1.0, img.device)
    grad = torch.linspace(1.0, 0.3, H, device=img.device).reshape(1, H, 1, 1)
    alpha = torch.clamp(a * alpha_coef * 5.0 * grad, 0.0, 0.9)
    return torch.where(gate, img * (1 - alpha) + alpha, img)


def random_shadow(gen, img, roi=(0.2, 0.2, 0.8, 0.8), intensity=(0.3, 0.7), prob: float = 0.05):
    """A.RandomShadow analog: a random axis-aligned patch inside the ROI
    darkened by a random intensity."""
    B, H, W, _ = img.shape
    d = img.device
    gate = _gate(gen, prob, B, d)
    x0r, y0r, x1r, y1r = roi
    cx = uniform(gen, (B, 1, 1, 1), x0r, x1r, d) * W
    cy = uniform(gen, (B, 1, 1, 1), y0r, y1r, d) * H
    hw = uniform(gen, (B, 1, 1, 1), 0.05, 0.25, d) * W
    hh = uniform(gen, (B, 1, 1, 1), 0.05, 0.25, d) * H
    it = uniform(gen, (B, 1, 1, 1), intensity[0], intensity[1], d)
    ys = torch.arange(H, device=d).reshape(1, H, 1, 1)
    xs = torch.arange(W, device=d).reshape(1, 1, W, 1)
    inside = ((ys - cy).abs() < hh) & ((xs - cx).abs() < hw)
    shaded = torch.where(inside, img * (1 - it), img)
    return torch.where(gate, shaded, img)


def random_rain(gen, img, slant: int = 3, streaks: float = 0.0008, prob: float = 0.1):
    """A.RandomRain analog: sparse seeds smeared along a slanted vertical
    into streaks, blended bright; the scene slightly darkened."""
    B, H, W, _ = img.shape
    gate = _gate(gen, prob, B, img.device)
    seeds = bernoulli(gen, streaks, (B, H, W, 1), img.device).to(img.dtype)
    streak = torch.zeros_like(seeds)
    for i in range(8):  # an 8-pixel streak, slanted
        streak = streak + torch.roll(seeds, (i, (i * slant) // 8), dims=(1, 2))
    streak = torch.clamp(streak, 0.0, 1.0)
    rained = torch.clamp(img * 0.92 + streak * 0.7, 0.0, 1.0)
    return torch.where(gate, rained, img)


def spatter(gen, img, intensity: float = 0.3, prob: float = 0.1):
    """A.Spatter(mode='rain') analog: smooth random blobs blended dark."""
    B, H, W, _ = img.shape
    gate = _gate(gen, prob, B, img.device)
    coarse = normal(gen, (B, H // 8 or 1, W // 8 or 1, 1), img.device)
    # an upsample, where jax.image.resize's bilinear is half-pixel linear
    blob = F.interpolate(coarse.permute(0, 3, 1, 2), size=(H, W), mode="bilinear",
                         align_corners=False).permute(0, 2, 3, 1)
    mask = (blob > 1.0).to(img.dtype)
    spat = torch.clamp(img * (1 - 0.5 * mask * intensity * 2) + mask * 0.05, 0.0, 1.0)
    return torch.where(gate, spat, img)


def random_gravel(gen, img, roi=(0.2, 0.2, 0.8, 0.8), prob: float = 0.05):
    """A.RandomGravel analog: bright speckles inside the ROI."""
    B, H, W, _ = img.shape
    d = img.device
    gate = _gate(gen, prob, B, d)
    speck = bernoulli(gen, 0.002, (B, H, W, 1), d).to(img.dtype)
    ys = torch.arange(H, device=d).reshape(1, H, 1, 1) / H
    xs = torch.arange(W, device=d).reshape(1, 1, W, 1) / W
    in_roi = (ys > roi[1]) & (ys < roi[3]) & (xs > roi[0]) & (xs < roi[2])
    out = torch.clamp(img + speck * in_roi * 0.6, 0.0, 1.0)
    return torch.where(gate, out, img)


def _rgb_to_hsv_vec(img):
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    mx = img.amax(-1)
    mn = img.amin(-1)
    d = mx - mn + 1e-8
    h = torch.where(mx == r, torch.remainder((g - b) / d, 6.0),
                    torch.where(mx == g, (b - r) / d + 2.0, (r - g) / d + 4.0))
    return torch.stack([h / 6.0, d / (mx + 1e-8), mx], -1)


def _hsv_to_rgb_vec(hsv):
    h, s, v = hsv[..., 0] * 6.0, hsv[..., 1], hsv[..., 2]
    i = torch.floor(h)
    f = h - i
    p = v * (1 - s)
    q = v * (1 - s * f)
    t = v * (1 - s * (1 - f))
    i = torch.remainder(i.to(torch.int32), 6).long()[..., None]

    def choose(*options):  # jnp.choose: option i at each place (i in 0..5)
        return torch.gather(torch.stack(options, -1), -1, i)[..., 0]
    return torch.stack([choose(v, q, p, p, t, v), choose(t, v, v, q, p, p),
                        choose(p, p, t, v, v, q)], -1)


def hue_saturation_value(gen, img, hue_shift: float = 0.5, sat_shift: float = 0.6,
                         val_shift: float = 0.3, prob: float = 1.0):
    """A.HueSaturationValue analog (shifts as fractions of the full range;
    the roadwork profile's ±180 degrees is hue_shift 0.5)."""
    B = img.shape[0]
    d = img.device
    gate = _gate(gen, prob, B, d)
    dh = uniform(gen, (B, 1, 1), -hue_shift, hue_shift, d)
    ds = uniform(gen, (B, 1, 1), -sat_shift, sat_shift, d)
    dv = uniform(gen, (B, 1, 1), -val_shift, val_shift, d)
    hsv = _rgb_to_hsv_vec(img)
    hsv = torch.stack([torch.remainder(hsv[..., 0] + dh, 1.0),
                       torch.clamp(hsv[..., 1] + ds, 0.0, 1.0),
                       torch.clamp(hsv[..., 2] + dv, 0.0, 1.0)], -1)
    return torch.where(gate, _hsv_to_rgb_vec(hsv), img)


def brightness_contrast(gen, img, brightness: float = 0.3, contrast: float = 0.5,
                        prob: float = 0.05):
    """A.RandomBrightnessContrast with explicit limits."""
    return color_jitter(gen, img, brightness=brightness, contrast=contrast, prob=prob)


# ------------------------------------------------------------------
# The per-profile compositions (augmentations.py:63-113)
# ------------------------------------------------------------------

def profile_moderate(gen, img):
    """transform_moderate (augmentations.py:63-79): the light set of the
    segmentation trainers."""
    img = pixel_dropout(gen, img, 0.25, prob=0.05)
    img = multiplicative_noise(gen, img, (0.2, 0.5), prob=0.05)
    img = spatter(gen, img, prob=0.05)
    img = to_gray(gen, img, prob=0.1)
    img = random_rain(gen, img, prob=0.05)
    img = random_shadow(gen, img, prob=0.05)
    img = random_gravel(gen, img, prob=0.05)
    img = brightness_contrast(gen, img, 0.3, 0.5, prob=0.05)
    img = iso_noise(gen, img, (0.1, 0.3), prob=0.05)
    return gaussian_noise(gen, img, 0.02, prob=0.05)


def profile_noise(gen, img):
    """transform_noise (augmentations.py:81-97): the heavy set."""
    img = multiplicative_noise(gen, img, (0.5, 1.5), prob=0.5)
    img = pixel_dropout(gen, img, 0.025, prob=0.25)
    img = color_jitter(gen, img, brightness=0.6, contrast=0.6, prob=0.5)
    img = gaussian_noise(gen, img, 0.02, prob=0.5)
    img = gaussian_noise(gen, img, 0.1, prob=0.5)
    img = iso_noise(gen, img, (0.1, 0.5), prob=0.5)
    img = random_fog(gen, img, alpha_coef=0.2, prob=0.25)
    img = random_fog(gen, img, alpha_coef=0.04, prob=0.25)
    img = random_rain(gen, img, prob=0.1)
    img = spatter(gen, img, prob=0.1)
    return to_gray(gen, img, prob=0.1)


def profile_roadwork(gen, img):
    """transform_noise_roadwork (augmentations.py:99-104): an extreme HSV
    shift (hue ±180 degrees) and frequent grayscale."""
    img = hue_saturation_value(gen, img, 0.5, 0.6, 0.31, prob=1.0)
    return to_gray(gen, img, prob=0.5)


def profile_autosteer(gen, img):
    """transform_noise_autosteer (augmentations.py:106-112)."""
    img = brightness_contrast(gen, img, 0.3, 0.3, prob=0.5)
    img = gaussian_noise(gen, img, 0.02, prob=0.3)
    return to_gray(gen, img, prob=0.1)


NOISE_PROFILES = {
    "none": dict(sigma=0.0, prob=0.0),
    "moderate": dict(sigma=0.02, prob=0.5),
    "heavy": dict(sigma=0.05, prob=0.7),
    "roadwork": dict(sigma=0.03, prob=0.5),
}

PROFILE_FNS = {
    "moderate": profile_moderate,
    "noise": profile_noise,
    "roadwork": profile_roadwork,
    "autosteer": profile_autosteer,
}


def augment_batch(gen, img, label, *, flip_prob=0.5, noise_profile="moderate",
                  grid_shuffle=False, grid=(1, 2), grid_prob=0.25, jitter=True):
    """The default train-time augmentation: flip, the optional grid
    shuffle, then a profile ('moderate', 'noise', 'roadwork', 'autosteer':
    the reference's Albumentations sets) or, for 'none' and 'heavy', the
    simple gaussian noise and colour jitter."""
    img, label = random_hflip(gen, img, label, flip_prob)
    if grid_shuffle:
        img, label = random_grid_shuffle(gen, img, label, grid, grid_prob)
    prof_fn = PROFILE_FNS.get(noise_profile)
    if prof_fn is not None:
        img = prof_fn(gen, img)
    else:
        prof = NOISE_PROFILES.get(noise_profile, NOISE_PROFILES["moderate"])
        if prof["prob"] > 0:
            img = gaussian_noise(gen, img, **prof)
        if jitter:
            img = color_jitter(gen, img)
    return img, label
