"""Raw annotations -> the parsers -> the unified layout -> the port's
loaders, on the CPU, through chip_smoke.py phase 39's own functions
(write_raw_datasets, parse_raw_datasets, unified_loaders,
check_read_back) at the datasets' published frame sizes, one sample of
each format.

The layout the port's parsers write is held byte for byte to the one the
JAX package's parsers write from the same raw files; the port's loaders
(SceneSegDataset, DepthDataset, EgoLanesMaskDataset) must give back the
SceneSeg ids, depths, validity and lane masks the parsers produced, and
the same samples as the JAX package's loaders.
"""
import cv2
import numpy as np
import pytest

import chip_smoke
from autoware_vision_pilot_tpu.train import datasets as jds
from autoware_vision_pilot_tpu_torch.data_parsing import culane, tusimple
from autoware_vision_pilot_tpu_torch.train import datasets as tds

from test_torch_data_parsing import same, same_tree


@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    raw = chip_smoke.write_raw_datasets(root / "raw", n=1, seed=3)
    jax = chip_smoke.parse_raw_datasets(raw, root / "jax", "autoware_vision_pilot_tpu")[0]
    port = chip_smoke.parse_raw_datasets(raw, root / "port")[0]
    return root, raw, jax, port


def test_the_port_writes_the_jax_layout(layouts):
    root, _, jax, port = layouts
    same(jax, port)
    same_tree(root / "jax", root / "port")
    assert sorted(p.relative_to(root / "port").as_posix() for p in (root / "port").rglob("*.*")) \
        == ["bdd100k/images/00000.png", "bdd100k/labels/00000.png", "depth/depth/0.npy",
            "depth/depth/1.npy", "depth/image/0.png", "depth/image/1.png",
            "depth/validity/0.png", "depth/validity/1.png",
            "egolanes/images/culane_00000.png", "egolanes/images/tusimple_00000.png",
            "egolanes/labels/culane_00000.png", "egolanes/labels/tusimple_00000.png",
            "mapillary/images/00000.png", "mapillary/labels/00000.png"]


def test_the_loaders_read_back_what_the_parsers_wrote(layouts):
    root, _, _, port = layouts
    chip_smoke.check_read_back(root / "port", port, chip_smoke.unified_loaders(root / "port"))


def test_lane_masks_come_back_as_the_parsers_float_masks(layouts):
    """rasterize_lanes' float {0, 1} masks, through an 8-bit PNG and
    EgoLanesMaskDataset's > 127, unchanged."""
    root, raw, _, _ = layouts
    masks = [culane.culane_to_unified(str(raw / "culane" / "00000.lines.txt")),
             tusimple.tusimple_to_unified(str(raw / "tusimple" / "label_data.json"))[0]["masks"]]
    ds = tds.EgoLanesMaskDataset(root / "port" / "egolanes" / "images",
                                 root / "port" / "egolanes" / "labels")
    for k, want in enumerate(masks):
        assert want.dtype == np.float32 and set(np.unique(want)) == {0.0, 1.0}
        got = ds.get_train(k)[1]
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_depth_and_validity_come_back_bit_for_bit(layouts):
    root, _, _, port = layouts
    ds = tds.DepthDataset(root / "port" / "depth" / "image", root / "port" / "depth" / "depth")
    for k, (name, image, (dense, validity)) in enumerate(port["depth"]):
        img, depth, _ = ds.get_train(k)
        assert depth.tobytes() == dense.tobytes() and np.array_equal(img, image[..., ::-1])
        read = cv2.imread(str(root / "port" / "depth" / "validity" / f"{name}.png"),
                          cv2.IMREAD_UNCHANGED)
        assert np.array_equal(read, validity * 255) and validity.any()


@pytest.mark.parametrize("layout,loader,args", [
    ("bdd100k", "SceneSegDataset", ("images", "labels", "BDD100K")),
    ("mapillary", "SceneSegDataset", ("images", "labels", "Mapillary")),
    ("depth", "DepthDataset", ("image", "depth")),
    ("egolanes", "EgoLanesMaskDataset", ("images", "labels"))])
def test_the_port_loaders_equal_jax_loaders(layouts, layout, loader, args):
    root = layouts[0] / "port" / layout
    a = [root / a for a in args[:2]] + list(args[2:])
    jd, td = getattr(jds, loader)(*a), getattr(tds, loader)(*a)
    assert jd.item_count() == td.item_count()
    for k in range(td.item_count()[0]):
        same(jd.get_train(k), td.get_train(k))
