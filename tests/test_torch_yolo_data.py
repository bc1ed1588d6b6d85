"""The port's YOLO data (autoware_vision_pilot_tpu_torch/train/yolo_data.py)
against the JAX package's: every op and the batcher bit-equal for the same
np.random.Generator (both run numpy and cv2 on the host)."""
import numpy as np
import pytest

from autoware_vision_pilot_tpu.train import yolo_data as jyd
from autoware_vision_pilot_tpu_torch.train import yolo_data as tyd

from test_torch_train_step import one_thread  # noqa: F401 (an autouse fixture)


def samples(mod, n=5, seed=0, hw=(60, 100)):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        img = rng.integers(0, 256, (*hw, 3), dtype=np.uint8)
        k = i % 4  # one sample without boxes
        xy = rng.uniform(0, min(hw) - 20, (k, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(3, 20, (k, 2))], -1).reshape(k, 4)
        out.append(mod.DetSample(img, boxes, rng.integers(0, 4, k)))
    return out


def assert_same(a, b):
    for x, y in zip((a.image, a.boxes_xyxy, a.labels), (b.image, b.boxes_xyxy, b.labels)):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("op", ["hsv", "mosaic4", "mixup", "perspective", "perspective-empty"])
def test_ops_bit_equal(op):
    ts, js = samples(tyd), samples(jyd)
    rt, rj = np.random.default_rng(5), np.random.default_rng(5)
    if op == "hsv":
        np.testing.assert_array_equal(tyd.hsv_augment(ts[0].image, rt),
                                      jyd.hsv_augment(js[0].image, rj))
    elif op == "mosaic4":
        assert_same(tyd.mosaic4(ts[:4], (64, 128), rt), jyd.mosaic4(js[:4], (64, 128), rj))
    elif op == "mixup":
        assert_same(tyd.mixup(ts[1], ts[2], rt), jyd.mixup(js[1], js[2], rj))
    else:
        i = 0 if op == "perspective-empty" else 3
        assert_same(tyd.random_perspective(ts[i], rt, degrees=10.0, shear=2.0),
                    jyd.random_perspective(js[i], rj, degrees=10.0, shear=2.0))
    assert rt.bit_generator.state == rj.bit_generator.state


@pytest.mark.parametrize("n", [0, 3, 80])
def test_pad_targets_bit_equal(n):
    rng = np.random.default_rng(n)
    xy = rng.uniform(0, 100, (n, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(1, 30, (n, 2))], -1).reshape(n, 4)
    labels = rng.integers(0, 4, n)
    for a, b in zip(tyd.pad_targets(boxes, labels, (64, 128), 64),
                    jyd.pad_targets(boxes, labels, (64, 128), 64)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mosaic,mixup", [(1.0, 0.15), (0.0, 1.0), (0.5, 0.5)])
def test_batcher_bit_equal(mosaic, mixup):
    kw = dict(input_hw=(64, 128), batch_size=2, max_boxes=16, mosaic_prob=mosaic,
              mixup_prob=mixup, seed=9)
    tb, jb = iter(tyd.YoloBatcher(samples(tyd), **kw)), iter(jyd.YoloBatcher(samples(jyd), **kw))
    for _ in range(3):
        for a, b in zip(next(tb), next(jb)):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
