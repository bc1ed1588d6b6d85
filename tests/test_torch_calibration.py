"""The port's calibration (autoware_vision_pilot_tpu_torch/calibration)
against the JAX package's (autoware_vision_pilot_tpu/calibration), the
checks of tests/test_calibration.py on both. Both are the same float64
numpy and cv2 code, so every result is bit-equal (rtol 0, atol 0); the
properties tests/test_calibration.py checks are checked again on the port.
The app's load_homography reads its YAML through the port's
load_homography_yaml.
"""
import numpy as np
import pytest

import autoware_vision_pilot_tpu.calibration as jc
from autoware_vision_pilot_tpu.calibration.homography import apply_homography as j_apply
from autoware_vision_pilot_tpu_torch import calibration as tc
from autoware_vision_pilot_tpu_torch.calibration.homography import apply_homography

from test_torch_train_step import one_thread  # noqa: F401 (an autouse fixture)

H_TRUE = np.array([[0.02, -0.001, -10.0], [0.0005, 0.05, -30.0], [1e-5, 1e-3, 1.0]])
K = np.array([[800.0, 0, 640], [0, 800, 360], [0, 0, 1]])


def test_exports_are_the_jax_packages():
    names = [n for n in dir(jc) if not n.startswith("_") and callable(getattr(jc, n))]
    assert set(names) <= set(dir(tc)), set(names) - set(dir(tc))


def test_homography_dlt_recovers_known_h():
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 1280, (20, 2))
    world = apply_homography(H_TRUE, img)
    np.testing.assert_array_equal(world, j_apply(H_TRUE, img))
    H = tc.compute_homography(img, world)
    np.testing.assert_array_equal(H, jc.compute_homography(img, world))
    err = tc.homography_reprojection_error(H, img, world)
    assert err == jc.homography_reprojection_error(H, img, world) and err < 1e-6
    with pytest.raises(ValueError):
        tc.compute_homography(img[:3], world[:3])


def test_homography_yaml_roundtrip_both_ways(tmp_path):
    H = np.arange(9, dtype=np.float64).reshape(3, 3) + 1
    tc.save_homography_yaml(H, tmp_path / "port.yaml")
    jc.save_homography_yaml(H, tmp_path / "jax.yaml")
    assert (tmp_path / "port.yaml").read_bytes() == (tmp_path / "jax.yaml").read_bytes()
    np.testing.assert_array_equal(jc.load_homography_yaml(tmp_path / "port.yaml"), H)
    np.testing.assert_array_equal(tc.load_homography_yaml(tmp_path / "jax.yaml"), H)
    (tmp_path / "flat.yaml").write_text("H: [1, 0, 2, 0, 1, 3, 0, 0, 1]\n")
    np.testing.assert_array_equal(tc.load_homography_yaml(tmp_path / "flat.yaml"),
                                  jc.load_homography_yaml(tmp_path / "flat.yaml"))


def test_app_loads_the_homography_through_calibration(tmp_path):
    from autoware_vision_pilot_tpu_torch.app import load_homography
    from autoware_vision_pilot_tpu_torch.runtime.config import Config
    H = np.arange(9, dtype=np.float64).reshape(3, 3) + 0.5
    jc.save_homography_yaml(H, tmp_path / "h.yaml")
    cfg = Config()
    cfg.homography_yaml = str(tmp_path / "h.yaml")
    np.testing.assert_array_equal(load_homography(cfg), H)
    cfg.homography_yaml = str(tmp_path / "missing.yaml")
    np.testing.assert_array_equal(load_homography(cfg), np.eye(3))


def test_rotation_homography_identity():
    R = tc.get_rotation_matrix(0.0, 0.0, 0.0)
    np.testing.assert_allclose(tc.rotation_homography(K, R), np.eye(3), atol=1e-12)
    for angles in ((2.0, 0.0, 0.0), (-1.5, 3.0, 0.7)):
        R = tc.get_rotation_matrix(*angles)
        np.testing.assert_array_equal(R, jc.get_rotation_matrix(*angles))
        np.testing.assert_array_equal(tc.rotation_homography(K, R),
                                      jc.rotation_homography(K, R))
    Hp = tc.rotation_homography(K, tc.get_rotation_matrix(2.0, 0.0, 0.0))
    pt = apply_homography(Hp, np.array([[640.0, 360.0]]))[0]
    assert abs(pt[0] - 640) < 2 and abs(pt[1] - 360) > 10


def test_homography_ransac_rejects_outliers():
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 1280, (40, 2))
    world = apply_homography(H_TRUE, img)
    bad = rng.choice(40, 12, replace=False)  # 30% outliers
    world_noisy = world.copy()
    world_noisy[bad] += rng.uniform(20.0, 80.0, (12, 2))
    assert tc.homography_reprojection_error(tc.compute_homography(img, world_noisy),
                                            img, world) > 1.0
    H, mask = tc.compute_homography_ransac(img, world_noisy, threshold=5.0)
    Hj, mask_j = jc.compute_homography_ransac(img, world_noisy, threshold=5.0)
    np.testing.assert_array_equal(H, Hj)
    np.testing.assert_array_equal(mask, mask_j)
    assert tc.homography_reprojection_error(H, img, world) < 1e-3
    assert np.abs(H - H_TRUE).max() < 1e-3
    expected = np.ones(40, bool)
    expected[bad] = False
    assert (mask == expected).all()


def test_standardize_pose_matches_jax():
    img = np.random.default_rng(2).integers(0, 256, (72, 128, 3), dtype=np.uint8)
    k = np.array([[100.0, 0, 64], [0, 100.0, 36], [0, 0, 1]])
    dist = np.array([-0.1, 0.01, 0.001, -0.002, 0.0])
    np.testing.assert_array_equal(tc.undistort_image(img, k, dist),
                                  jc.undistort_image(img, k, dist))
    for height in (1.0, 0.8):
        got = tc.standardize_pose(img, k, dist, 1.5, -0.5, 0.2, height)
        assert got.shape == img.shape
        np.testing.assert_array_equal(got, jc.standardize_pose(img, k, dist, 1.5, -0.5, 0.2,
                                                               height))
