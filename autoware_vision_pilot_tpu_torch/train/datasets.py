"""Dataset loading for the unified GT format, the port's own copy of
autoware_vision_pilot_tpu/train/datasets.py (numpy, PIL and cv2; no
torch). The samplers draw from a ``np.random.Generator`` exactly as the
JAX package's do, so a seed gives the same sample order in both.

The reference converts ~20 open datasets into one color-coded mask format
(Models/data_parsing/*) and loads them with per-pixel Python loops
(data_utils/load_data_scene_seg.py:55-143). Here the same GT convention is
decoded vectorized (numpy) and batched for the device input pipeline:

- SceneSeg: 9 semantic colors folded to 3 classes (background incl. sky /
  foreground / road) + per-sample class weights n_pix/(freq+5120).
- 90/10 train/val split by index ((i+1) % 10 == 0 -> val), dataset-specific
  ROI crops, multi-dataset sample-by-sample round-robin interleave
  (training/train_scene_seg.py:104-160).

A synthetic in-memory dataset provides the same interface for tests and
benchmarks without data on disk.
"""
from __future__ import annotations

import pathlib
from typing import Iterator, Sequence, Tuple

import numpy as np

try:
    from PIL import Image
except ImportError:  # pragma: no cover
    Image = None

# SceneSeg unified color code (load_data_scene_seg.py:57-66)
SCENESEG_COLOURS = {
    "sky": (61, 184, 255),
    "background_objects": (61, 93, 255),
    "road_edge_delimiter": (216, 255, 61),
    "unlabelled": (0, 0, 0),
    "vulnerable_living": (255, 61, 61),
    "small_mobile_vehicle": (255, 190, 61),
    "large_mobile_vehicle": (255, 116, 61),
    "foreground_objects": (255, 28, 145),
    "road": (0, 255, 220),
}
_BACKGROUND = ("background_objects", "road_edge_delimiter", "unlabelled", "sky")
_FOREGROUND = ("vulnerable_living", "small_mobile_vehicle",
               "large_mobile_vehicle", "foreground_objects")

ROI_CROPS = {
    "ACDC": (0, 0, 1919, 990),
    "BDD100K": (0, 0, 1000, 500),
    "IDDAW": (0, 476, 2047, 1500),
    "MUSES": (0, 0, 1919, 918),
}


def decode_scene_seg_mask(label_rgb: np.ndarray
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Color mask (H,W,3) -> (class ids (H,W) int32 {0=bg,1=fg,2=road},
    class_weights (3,)). Vectorized equivalent of createGroundTruth."""
    h, w = label_rgb.shape[:2]
    ids = np.zeros((h, w), np.int32)  # default/unmatched -> background
    flat = label_rgb.reshape(-1, 3)

    def match(names):
        m = np.zeros(flat.shape[0], bool)
        for n in names:
            m |= np.all(flat == SCENESEG_COLOURS[n], axis=1)
        return m.reshape(h, w)

    fg = match(_FOREGROUND)
    road = match(("road",))
    ids[fg] = 1
    ids[road] = 2

    n = h * w
    bg_freq = int(match(_BACKGROUND).sum())
    weights = np.array([
        n / (bg_freq + 5120),
        n / (int(fg.sum()) + 5120),
        n / (int(road.sum()) + 5120),
    ], np.float32)
    return ids, weights


class SceneSegDataset:
    """Unified-format SceneSeg dataset: sorted image/label pngs, 90/10 split."""

    def __init__(self, images_dir: str, labels_dir: str,
                 dataset: str = "ACDC"):
        self.dataset = dataset
        self.images = sorted(pathlib.Path(images_dir).glob("*.png"))
        self.labels = sorted(pathlib.Path(labels_dir).glob("*.png"))
        if len(self.images) != len(self.labels):
            raise ValueError("image/label count mismatch")
        if not self.images:
            raise ValueError("no images found")
        self.train_idx = [i for i in range(len(self.images))
                          if (i + 1) % 10 != 0]
        self.val_idx = [i for i in range(len(self.images))
                        if (i + 1) % 10 == 0]

    def item_count(self):
        return len(self.train_idx), len(self.val_idx)

    def _load(self, i):
        img = Image.open(self.images[i]).convert("RGB")
        lab = Image.open(self.labels[i]).convert("RGB")
        crop = ROI_CROPS.get(self.dataset)
        if crop:
            img = img.crop(crop)
            lab = lab.crop(crop)
        elif self.dataset == "COMMA10K":
            w, h = img.size
            img = img.crop((0, 0, w - 1, int(h * 0.7)))
            lab = lab.crop((0, 0, w - 1, int(h * 0.7)))
        ids, weights = decode_scene_seg_mask(np.asarray(lab))
        return np.asarray(img), ids, weights

    def get_train(self, k):
        return self._load(self.train_idx[k])

    def get_val(self, k):
        return self._load(self.val_idx[k])


class SyntheticSegDataset:
    """In-memory random dataset with the SceneSegDataset interface; for
    tests/benchmarks (num_classes-way labels, images uint8)."""

    def __init__(self, n_train=32, n_val=4, hw=(320, 640), num_classes=3,
                 seed=0):
        rng = np.random.default_rng(seed)
        self.hw = hw
        self.num_classes = num_classes
        self._train = [(rng.integers(0, 256, (*hw, 3), dtype=np.uint8),
                        rng.integers(0, num_classes, hw).astype(np.int32),
                        np.ones(num_classes, np.float32))
                       for _ in range(n_train)]
        self._val = [(rng.integers(0, 256, (*hw, 3), dtype=np.uint8),
                      rng.integers(0, num_classes, hw).astype(np.int32),
                      np.ones(num_classes, np.float32))
                     for _ in range(n_val)]

    def item_count(self):
        return len(self._train), len(self._val)

    def get_train(self, k):
        return self._train[k]

    def get_val(self, k):
        return self._val[k]


class DepthDataset:
    """Scene3D-style dataset: images + float depth maps (.npy or 16-bit
    png in millimeters). Same 90/10 split and interface as SceneSegDataset
    (the load_data_scene_3d role)."""

    def __init__(self, images_dir: str, depth_dir: str):
        self.images = sorted(pathlib.Path(images_dir).glob("*.png"))
        self.depths = sorted(
            list(pathlib.Path(depth_dir).glob("*.npy")) +
            list(pathlib.Path(depth_dir).glob("*.png")))
        if len(self.images) != len(self.depths):
            raise ValueError("image/depth count mismatch")
        self.train_idx = [i for i in range(len(self.images))
                          if (i + 1) % 10 != 0]
        self.val_idx = [i for i in range(len(self.images))
                        if (i + 1) % 10 == 0]

    def item_count(self):
        return len(self.train_idx), len(self.val_idx)

    def _load(self, i):
        import cv2
        img = np.asarray(Image.open(self.images[i]).convert("RGB"))
        p = self.depths[i]
        if p.suffix == ".npy":
            depth = np.load(p).astype(np.float32)
        else:
            depth = cv2.imread(str(p), cv2.IMREAD_UNCHANGED).astype(
                np.float32) / 1000.0  # mm -> m
        return img, depth, np.ones(1, np.float32)

    def get_train(self, k):
        return self._load(self.train_idx[k])

    def get_val(self, k):
        return self._load(self.val_idx[k])


class EgoLanesMaskDataset:
    """EgoLanes-style dataset: images + 3-channel binary lane masks at
    quarter resolution (the load_data_ego_lanes role)."""

    def __init__(self, images_dir: str, masks_dir: str):
        self.images = sorted(pathlib.Path(images_dir).glob("*.png"))
        self.masks = sorted(pathlib.Path(masks_dir).glob("*.png"))
        if len(self.images) != len(self.masks):
            raise ValueError("image/mask count mismatch")
        self.train_idx = [i for i in range(len(self.images))
                          if (i + 1) % 10 != 0]
        self.val_idx = [i for i in range(len(self.images))
                        if (i + 1) % 10 == 0]

    def item_count(self):
        return len(self.train_idx), len(self.val_idx)

    def _load(self, i):
        img = np.asarray(Image.open(self.images[i]).convert("RGB"))
        mask = np.asarray(Image.open(self.masks[i]).convert("RGB"))
        return img, (mask > 127).astype(np.float32), np.ones(3, np.float32)

    def get_train(self, k):
        return self._load(self.train_idx[k])

    def get_val(self, k):
        return self._load(self.val_idx[k])


def round_robin_interleave(datasets: Sequence, rng: np.random.Generator
                           ) -> Iterator[Tuple[int, int]]:
    """Sample-by-sample multi-dataset interleave with per-epoch shuffle
    (train_scene_seg.py:104-160): yields (dataset_idx, sample_idx) cycling
    datasets until each is exhausted."""
    orders = [rng.permutation(d.item_count()[0]) for d in datasets]
    cursors = [0] * len(datasets)
    remaining = sum(len(o) for o in orders)
    d = 0
    while remaining:
        for _ in range(len(datasets)):
            if cursors[d] < len(orders[d]):
                yield d, int(orders[d][cursors[d]])
                cursors[d] += 1
                remaining -= 1
                d = (d + 1) % len(datasets)
                break
            d = (d + 1) % len(datasets)


def resize_sample(img: np.ndarray, ids: np.ndarray, hw: Tuple[int, int]):
    """cv2's bilinear resize of the image and nearest resize of the labels
    to ``hw``; an array already of that size is returned as it is (cv2
    would copy it unchanged), so cv2 is needed only where a size changes."""
    if img.shape[:2] != tuple(hw) or ids.shape[:2] != tuple(hw):
        import cv2
        img = cv2.resize(img, (hw[1], hw[0]), interpolation=cv2.INTER_LINEAR)
        ids = cv2.resize(ids, (hw[1], hw[0]), interpolation=cv2.INTER_NEAREST)
    return img, ids


def batched_loader(dataset, indices: Sequence[int], batch_size: int,
                   hw: Tuple[int, int] = (320, 640), train: bool = True):
    """Yield (images_u8 (B,H,W,3), labels (B,H,W), weights (B,C)) batches,
    resizing on host with nearest labels."""
    get = dataset.get_train if train else dataset.get_val
    batch_img, batch_lab, batch_w = [], [], []
    for i in indices:
        img, ids, w = get(i)
        img, ids = resize_sample(img, ids, hw)
        batch_img.append(img)
        batch_lab.append(ids)
        batch_w.append(w)
        if len(batch_img) == batch_size:
            yield (np.stack(batch_img), np.stack(batch_lab),
                   np.stack(batch_w))
            batch_img, batch_lab, batch_w = [], [], []
    if batch_img:
        yield np.stack(batch_img), np.stack(batch_lab), np.stack(batch_w)
