"""The port's dataset parsers (autoware_vision_pilot_tpu_torch/data_parsing/)
against the JAX package's, on the CPU: the lane, segmentation, depth and
detection formats and their shared core.

Both packages run numpy and cv2 on the host, so every output is held
exactly: arrays bit for bit (type, dtype, shape and bytes), dicts, lists,
tuples and scalars equal and of the same type (NaN equal to NaN), files
byte for byte. Each case hands both functions their own copy of the same
seeded inputs; a case that raises must raise the same exception with the
same message on both sides. tests/test_torch_data_parsing_geo.py holds the
BEV, comma2k19 and ZOD modules, tests/test_torch_data_parsing_roundtrip.py
the path from raw annotations through the unified layout to the loaders.
"""
import copy
import dataclasses
import importlib
import inspect
import json
import pathlib
import pkgutil

import numpy as np
import pytest

import autoware_vision_pilot_tpu.data_parsing as jdp
import autoware_vision_pilot_tpu_torch.data_parsing as tdp
from autoware_vision_pilot_tpu.train.datasets import SCENESEG_COLOURS

from chip_smoke import KITTI_CALIB  # KITTI's 2011_09_26 calibration

REPO = pathlib.Path(__file__).resolve().parents[1]
OUT = "<out>"  # an argument the runner replaces by each side's own directory
MODULES = sorted(m.name for m in pkgutil.iter_modules(jdp.__path__))


def modules(name):
    return (importlib.import_module(f"autoware_vision_pilot_tpu.data_parsing.{name}"),
            importlib.import_module(f"autoware_vision_pilot_tpu_torch.data_parsing.{name}"))


def same(a, b, where="out"):
    """Exact equality of two results, recursively; files are compared by
    ``same_tree``."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert type(a) is type(b), where
        assert (a.dtype, a.shape) == (b.dtype, b.shape), where
        if a.dtype == object:
            for i, (x, y) in enumerate(zip(a.ravel(), b.ravel())):
                same(x, y, f"{where}[{i}]")
        else:
            assert a.tobytes() == b.tobytes(), where
    elif isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), where
        for k in a:
            same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{where}[{i}]")
    elif dataclasses.is_dataclass(a) and not isinstance(a, type):
        assert type(a).__name__ == type(b).__name__, where
        same(dataclasses.asdict(a), dataclasses.asdict(b), where)
    elif isinstance(a, (float, np.floating)):
        assert type(a) is type(b), where
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes(), f"{where}: {a!r} vs {b!r}"
    elif type(a).__module__.startswith("autoware_vision_pilot_tpu"):
        assert type(a).__name__ == type(b).__name__, where
        same(vars(a), vars(b), where)
    else:
        assert type(a) is type(b) and a == b, f"{where}: {a!r} vs {b!r}"


def same_tree(a: pathlib.Path, b: pathlib.Path):
    """Two directory trees with the same files, byte for byte."""
    fa = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    fb = sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file())
    assert fa == fb
    for rel in fa:
        assert (a / rel).read_bytes() == (b / rel).read_bytes(), rel


def outcome(fn, args, kwargs):
    try:
        return fn(*args, **kwargs)
    except Exception as e:  # the case holds the raise itself to JAX's
        return ("raised", type(e).__name__, str(e))


def run_both(jfn, tfn, args, kwargs=None, tmp=None):
    """Both functions on copies of the same arguments -> (JAX's, the
    port's), held equal; an OUT argument becomes tmp/jax and tmp/port, and
    the trees written there are held byte for byte."""
    kwargs = kwargs or {}
    res = []
    for side, fn in (("jax", jfn), ("port", tfn)):
        out = None if tmp is None else tmp / side
        if out is not None:
            out.mkdir(parents=True, exist_ok=True)
        sub = lambda v: str(out / v[len(OUT):].lstrip("/")) if (  # noqa: E731
            isinstance(v, str) and v.startswith(OUT)) else v
        a = [sub(v) for v in copy.deepcopy(args)]
        k = {n: sub(v) for n, v in copy.deepcopy(kwargs).items()}
        res.append(outcome(fn, a, k))
    same(res[0], res[1])
    if tmp is not None:
        same_tree(tmp / "jax", tmp / "port")
    return res


def held(module, name, *args, tmp=None, **kwargs):
    jm, tm = modules(module)
    return run_both(getattr(jm, name), getattr(tm, name), args, kwargs, tmp)


# ---------- seeded inputs ----------

def polylines(seed, n, hw, max_pts=8):
    """``n`` float32 (k, 2) polylines across an image of ``hw``, some of 0
    or 1 points, some leaving the frame."""
    rng = np.random.default_rng(seed)
    h, w = hw
    out = []
    for _ in range(n):
        k = int(rng.integers(0, max_pts + 1))
        ys = np.sort(rng.uniform(-5, h + 5, k))[::-1]
        xs = rng.uniform(0, w, 1) + rng.normal(0, w / 20, k).cumsum()
        out.append(np.stack([xs, ys], -1).astype(np.float32).reshape(-1, 2))
    return out


def tusimple_line(seed, n_lanes=4, raw=True):
    rng = np.random.default_rng(seed)
    h = list(range(160, 720, 10))
    lanes = []
    for i in range(n_lanes):
        xs = (rng.uniform(100, 1200) + rng.normal(0, 6, len(h)).cumsum()).round(1)
        xs[rng.random(len(h)) < 0.3] = -2
        if i == n_lanes - 1:
            xs[:-1] = -2  # one valid sample: dropped
        lanes.append(xs.tolist())
    rec = {"lanes": lanes, "h_samples": h}
    if raw:
        rec["raw_file"] = f"clips/0530/{seed}/20.jpg"
    return json.dumps(rec)


def culane_text(seed, n_lanes=4):
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n_lanes):
        k = 1 if i == 0 else int(rng.integers(2, 30))
        ys = np.linspace(589, 589 - 10 * (k - 1), k)
        xs = rng.uniform(200, 1400) + rng.normal(0, 4, k).cumsum()
        rows.append(" ".join(f"{x:.5f} {y:.0f}" for x, y in zip(xs, ys)) + " ")
    rows.insert(2, "")
    return "\n".join(rows) + "\n"


def curvelanes_text(seed, n_lanes=4):
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n_lanes):
        k = 1 if i == 0 else int(rng.integers(2, 12))
        pts = [{"x": f"{x:.3f}", "y": f"{y:.3f}"}
               for x, y in zip(rng.uniform(0, 2560, k), rng.uniform(0, 1440, k))]
        lines.append(pts)
    return json.dumps({"Lines": lines})


# ---------- the modules and their names ----------

def public(mod):
    return sorted(n for n, v in vars(mod).items()
                  if not n.startswith("_") and (inspect.isfunction(v) or inspect.isclass(v))
                  and v.__module__ == mod.__name__)


@pytest.mark.parametrize("name", MODULES)
def test_module_has_jax_public_names_and_constants(name):
    """Every module of the JAX package has a port with the same public
    functions and classes, and equal constants and private tables."""
    jm, tm = modules(name)
    assert public(tm) == public(jm)
    for k, v in vars(jm).items():
        if k.startswith("__") or callable(v) or inspect.ismodule(v):
            continue
        assert k in vars(tm), k
        same(v, vars(tm)[k], k)


def test_package_exports_match_jax():
    assert sorted(n for n in vars(tdp) if not n.startswith("_")) == \
        sorted(n for n in vars(jdp) if not n.startswith("_"))
    for n in dir(jdp):
        if not n.startswith("_") and callable(getattr(jdp, n)):
            assert getattr(tdp, n).__module__.startswith("autoware_vision_pilot_tpu_torch.")


def test_port_imports_nothing_of_jax():
    root = pathlib.Path(tdp.__file__).parent
    files = list(root.glob("*.py")) + [root.parent / "utils" / f for f in
                                       ("check_data.py", "manual_audit.py")]
    for f in files:
        for line in f.read_text().splitlines():
            s = line.strip()
            assert not s.startswith(("import jax", "from jax", "import flax", "from flax",
                                     "from autoware_vision_pilot_tpu.",
                                     "from autoware_vision_pilot_tpu import",
                                     "import autoware_vision_pilot_tpu.")), (f, s)


# ---------- common ----------

@pytest.mark.parametrize("seed,n", [(0, 6), (1, 3), (2, 0), (3, 9)])
def test_classify_and_rasterize_lanes(seed, n):
    lanes = polylines(seed, n, (72, 128))
    held("common", "classify_ego_lanes", lanes, 128)
    held("common", "rasterize_lanes", lanes, (72, 128))
    held("common", "rasterize_lanes", lanes, (72, 128), thickness=1)


def test_classify_ego_lanes_edge_cases():
    empty = np.zeros((0, 2), np.float32)
    mid = np.array([[64.0, 10.0], [64.0, 70.0]], np.float32)
    tie = np.array([[40.0, 70.0], [50.0, 70.0], [44.0, 20.0]], np.float32)
    for lanes in ([], [empty, empty], [mid, mid + [1, 0]], [tie, tie[::-1]], [empty, mid]):
        held("common", "classify_ego_lanes", lanes, 128)
        held("common", "rasterize_lanes", lanes, (72, 128))


@pytest.mark.parametrize("density,iters", [(0.02, 50), (0.002, 3), (0.0, 50), (1.0, 50)])
def test_lidar_depth_fill(density, iters):
    rng = np.random.default_rng(int(density * 1000) + iters)
    sparse = np.where(rng.random((60, 200)) < density, rng.uniform(1, 80, (60, 200)), 0)
    held("common", "lidar_depth_fill", sparse, max_iters=iters)
    held("common", "lidar_depth_fill", sparse.astype(np.float32))


def test_write_unified_sample(tmp_path):
    rng = np.random.default_rng(5)
    image = rng.integers(0, 256, (36, 64, 3), dtype=np.uint8)
    label = np.array(list(SCENESEG_COLOURS.values()), np.uint8)[rng.integers(0, 9, (36, 64))]
    held("common", "write_unified_sample", OUT, "000007", image, label, tmp=tmp_path)


# ---------- reprojection ----------

def test_reprojection():
    rng = np.random.default_rng(6)
    K = np.array([[500.0, 0, 320], [0, 500, 240], [0, 0, 1]])
    for roll, pitch, yaw in rng.uniform(-0.3, 0.3, (3, 3)):
        held("reprojection", "euler_to_rotation", roll, pitch, yaw)
    R = tdp.reprojection.euler_to_rotation(0.01, -0.02, 0.03)
    pts = np.c_[rng.uniform(-5, 5, 20), rng.uniform(0.5, 2, 20), rng.uniform(2, 60, 20)]
    held("reprojection", "project_points", pts, K)
    held("reprojection", "world_to_camera", pts, R, np.array([0.1, -1.5, 0.2]))
    pixels = np.c_[rng.uniform(0, 640, 20), rng.uniform(0, 480, 20)]
    pixels[:3, 1] = 240  # on the horizon: inf / nan
    ground = held("reprojection", "image_to_ground", pixels, K, R, 1.5)[0]
    held("reprojection", "ground_to_bev_pixels", ground)
    held("reprojection", "ground_to_bev_pixels", ground, (320, 640), 25.0)


# ---------- the lane formats ----------

@pytest.mark.parametrize("seed,raw", [(0, True), (1, False), (2, True)])
def test_tusimple(tmp_path, seed, raw):
    held("tusimple", "parse_tusimple_label", tusimple_line(seed, raw=raw))
    path = tmp_path / "label.json"
    path.write_text("\n".join([tusimple_line(seed), "", tusimple_line(seed + 10, 3), "  "]))
    held("tusimple", "tusimple_to_unified", str(path))
    held("tusimple", "tusimple_to_unified", str(path), (180, 320), 2)


@pytest.mark.parametrize("seed", [0, 1])
def test_culane(tmp_path, seed):
    text = culane_text(seed)
    held("culane", "parse_culane_lines", text)
    held("culane", "parse_culane_lines", "")
    path = tmp_path / "00000.lines.txt"
    path.write_text(text)
    held("culane", "culane_to_unified", str(path))
    held("culane", "culane_to_unified", str(path), (295, 820), 3)


@pytest.mark.parametrize("seed", [0, 1])
def test_curvelanes(tmp_path, seed):
    text = curvelanes_text(seed)
    held("curvelanes", "parse_curvelanes_label", text)
    held("curvelanes", "parse_curvelanes_label", "{}")
    path = tmp_path / "a.lines.json"
    path.write_text(text)
    held("curvelanes", "curvelanes_to_unified", str(path), (1440, 2560))
    held("curvelanes", "curvelanes_to_unified", str(path), (144, 256), 2)


# ---------- the segmentation label maps ----------

def test_bdd100k_and_cityscapes_like():
    rng = np.random.default_rng(7)
    held("bdd100k", "bdd100k_drivable_to_sceneseg", rng.integers(0, 256, (72, 128), dtype=np.uint8))
    held("bdd100k", "bdd100k_drivable_to_sceneseg", rng.integers(0, 20, (72, 128)))
    held("cityscapes_like", "cityscapes_labelids_to_sceneseg",
         rng.integers(0, 35, (72, 128), dtype=np.uint8))
    colours = np.array([(64, 32, 32), (255, 0, 0), (128, 128, 96), (0, 255, 102),
                        (204, 0, 255), (8, 8, 8)], np.uint8)
    held("cityscapes_like", "comma10k_to_sceneseg", colours[rng.integers(0, 6, (72, 128))])


def test_mapillary():
    rng = np.random.default_rng(8)
    ids = rng.integers(0, 66, (72, 128), dtype=np.uint8)
    for variant in (ids, np.where(ids == 28, 13, ids), np.full((8, 8), 10, np.uint8),
                    np.full((8, 8), 13, np.int32), np.array([[300, -4], [13, 13]])):
        held("mapillary", "mapillary_ids_to_sceneseg", variant)
    colours = np.array([(210, 60, 60), (250, 170, 35), (0, 0, 0), (210, 60, 61)], np.uint8)
    held("mapillary", "mapillary_v2_to_roadwork", colours[rng.integers(0, 4, (72, 128))])
    held("mapillary", "mapillary_v2_to_roadwork", np.zeros((4, 4, 3), np.uint8))
    rgba = np.concatenate([colours[rng.integers(0, 4, (8, 8))], np.full((8, 8, 1), 7, np.uint8)], -1)
    held("mapillary", "mapillary_v2_to_roadwork", rgba)
    names = list(tdp.mapillary.MAPILLARY_TO_CITYSCAPES) + ["not--a--label"]
    names = [names[i] for i in rng.permutation(len(names))]
    held("mapillary", "mapillary_to_cityscapes_trainids",
         rng.integers(0, 70, (72, 128), dtype=np.uint8), names)
    held("mapillary", "mapillary_to_cityscapes_trainids",
         rng.integers(0, 300, (8, 8)), names[:5] * 60)


def test_roadwork():
    rng = np.random.default_rng(9)
    polys = [rng.uniform(0, 128, (k, 2)).astype(np.float32) for k in (3, 2, 6, 0, 4)]
    held("roadwork", "polygons_to_binary_mask", polys, (72, 128))
    held("roadwork", "polygons_to_binary_mask", [], (72, 128))
    segs = [{"segmentation": [p.ravel().round(2).tolist()]} for p in polys if len(p)]
    for rec in ({"annotations": segs}, segs, {"annotations": [{"segmentation": {"counts": 3}},
                                                              {"bbox": [1, 2, 3, 4]}]}, {}):
        held("roadwork", "parse_roadwork_annotation", json.dumps(rec))


# ---------- the depth formats ----------



def kitti_points(seed, n=4000):
    """Velodyne returns in front of the car: a ground plane, a wall and
    pairs that land on the same pixel at two depths."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(2, 70, n)
    y = rng.uniform(-20, 20, n)
    z = np.where(rng.random(n) < 0.7, -1.7, rng.uniform(-1.7, 2, n))
    pts = np.c_[x, y, z, rng.random(n)]
    twins = pts[:200].copy()
    twins[:, :3] *= 1.3  # the same ray, farther: the same pixel to rounding
    dup = pts[200:300].copy()  # the same point twice
    return np.concatenate([pts, twins, dup, [[-5, 0, 0, 0]]]).astype(np.float32)


def test_parse_kitti_calib_with_odd_lines():
    held("kitti_depth", "parse_kitti_calib", KITTI_CALIB)
    odd = KITTI_CALIB + "\n".join([
        "", "calib_time: 09-Jan-2012 13:57:47", "EMPTY:", "BLANKS:    ", "LEAD: x 1 2",
        "TAIL: 1 2 x 3", "COMMA: 1,2,3", "NOCOLON 1 2 3", "  SPACED KEY :  4.5e-1\t-2 ",
        "TWO: a: 1 2", "NAN: nan inf -inf"])
    with pytest.warns(DeprecationWarning):
        held("kitti_depth", "parse_kitti_calib", odd)


def test_velodyne_to_depth_keeps_the_nearest_point():
    cal = tdp.kitti_depth.parse_kitti_calib(KITTI_CALIB)
    P2, R0 = cal["P2"].reshape(3, 4), cal["R0_rect"].reshape(3, 3)
    Tr = cal["Tr_velo_to_cam"].reshape(3, 4)
    pts = kitti_points(10)
    sparse = held("kitti_depth", "velodyne_to_depth", pts, P2, R0, Tr, (375, 1242), fill=False)[0]
    held("kitti_depth", "velodyne_to_depth", pts, P2, R0, Tr, (375, 1242))
    # the duplicate-pixel pairs really collide, and the nearer one is kept
    cam = R0 @ (Tr @ np.c_[pts[:, :3], np.ones(len(pts))].T)
    uv = np.round((P2 @ np.vstack([cam, np.ones(cam.shape[1])]))[:2] / (P2 @ np.vstack(
        [cam, np.ones(cam.shape[1])]))[2]).astype(int)
    keys = uv[0] * 10_000 + uv[1]
    _, counts = np.unique(keys[(cam[2] > 0.1) & (uv[0] >= 0) & (uv[0] < 1242) & (uv[1] >= 0)
                               & (uv[1] < 375)], return_counts=True)
    assert (counts > 1).sum() >= 50
    inside = (cam[2] > 0.1) & (uv[0] >= 0) & (uv[0] < 1242) & (uv[1] >= 0) & (uv[1] < 375)
    nearest = {}
    for k, z in zip(keys[inside], cam[2][inside]):
        nearest[k] = min(nearest.get(k, np.inf), z)
    got = sparse[uv[1][inside], uv[0][inside]]
    want = np.array([nearest[k] for k in keys[inside]], np.float32)
    np.testing.assert_array_equal(got, want)


def test_depth_formats():
    rng = np.random.default_rng(11)
    h, w = 40, 160
    image = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    depth = np.where(rng.random((h, w)) < 0.05, rng.integers(300, 60000, (h, w)), 0).astype(np.uint16)
    held("depth_datasets", "drivingstereo_depth_from_png", depth)
    held("depth_datasets", "drivingstereo_depth_from_png", depth // 512)  # refused: 8-bit
    held("depth_datasets", "drivingstereo_sample", image, depth)
    held("depth_datasets", "argoverse_depth_from_disparity", depth, 1685.0)
    held("depth_datasets", "argoverse_depth_from_disparity", depth, 30000.0, 0.5)  # past the cap
    held("depth_datasets", "argoverse_sample", image, depth, 1685.0)
    big = rng.integers(0, 256, (1800, 64, 3), dtype=np.uint8)
    bigd = np.where(rng.random((1800, 64)) < 0.05, 4000, 0).astype(np.uint16)
    held("depth_datasets", "argoverse_sample", big, bigd, 1685.0)
    sparse = np.where(rng.random((h, w)) < 0.03, rng.uniform(1, 90, (h, w)), 0).astype(np.float32)
    held("depth_datasets", "make_depth_sample", image, sparse)
    held("depth_datasets", "make_depth_sample", image, sparse, (5, 3, 150, 30))
    held("depth_datasets", "ddad_sample", image, sparse)
    calib = {"camera_data_": [
        {"key": "image_raw_ring_front_center", "value": {"focal_length_y_px_": 1.0}},
        {"key": "image_raw_stereo_front_left_rect", "value": {"focal_length_y_px_": 1685}}]}
    held("depth_datasets", "parse_argoverse_calib", calib)
    held("depth_datasets", "parse_argoverse_calib", calib, "image_raw_ring_front_center")
    held("depth_datasets", "parse_argoverse_calib", calib, "no_such_camera")


def test_save_depth_sample(tmp_path):
    rng = np.random.default_rng(12)
    image = rng.integers(0, 256, (30, 50, 3), dtype=np.uint8)
    _, dense, valid = tdp.depth_datasets.make_depth_sample(
        image, np.where(rng.random((30, 50)) < 0.05, 7.25, 0).astype(np.float32))
    held("depth_datasets", "save_depth_sample", OUT, 3, image, dense, valid, tmp=tmp_path)


# ---------- Jiqing, Once3DLane, OpenLane ----------

def jiqing_text(seed, n=4, keep_order=True):
    rng = np.random.default_rng(seed)
    rows = []
    xs = np.sort(rng.uniform(200, 1800, n)) if keep_order else rng.uniform(200, 1800, n)
    for i, x in enumerate(xs):
        ys = np.sort(rng.uniform(400, 1075, 6))
        pts = "".join(f"({x + 0.3 * (y - 900) * (i - n / 2):.1f}, {y:.1f})" for y in ys)
        rows.append(f"lane_{i}: {pts}")
    rows.insert(1, "lane_x:   ")
    rows.insert(2, "")
    rows.append("lane_y: (100.0, 1000.0)")  # below the crop only: dropped
    return "\n".join(rows)


def test_jiqing():
    for seed in range(4):
        held("jiqing_once3d", "parse_jiqing_gt", jiqing_text(seed))
    held("jiqing_once3d", "parse_jiqing_gt", jiqing_text(4, n=1))  # < 2 lanes
    left_only = "a: (100.0, 500.0)(110.0, 900.0)\nb: (300.0, 500.0)(320.0, 900.0)\n"
    held("jiqing_once3d", "parse_jiqing_gt", left_only)  # no anchor right of centre
    held("jiqing_once3d", "parse_jiqing_gt", jiqing_text(5), (1280, 720), 60)


def test_jiqing_helpers():
    lines = [np.array([[300.0, 900], [310, 500]]), np.array([[800.0, 900], [800, 500]]),
             np.array([[1500.0, 900], [1400, 900]]), np.array([[1200.0, 950], [1100, 600]])]
    for ln in lines:
        held("jiqing_once3d", "line_anchor", ln, 960)
    held("jiqing_once3d", "classify_ego_pair", lines, 1920, 960)
    held("jiqing_once3d", "classify_ego_pair", lines, 1920, 960, presorted=True)
    held("jiqing_once3d", "classify_ego_pair", lines[:2], 1920, 960)  # None
    held("jiqing_once3d", "classify_ego_pair", lines, 1920, 960, True, [1000.0, 1, 2, 3])
    held("jiqing_once3d", "rasterize_ego_mask", lines, (0, 3, [1, 2]), (480, 960))
    held("jiqing_once3d", "rasterize_ego_mask", lines, (0, 3, []), (480, 960), 1)


def lane3d(x_m, k=12, bend=0.0):
    zs = np.linspace(4, 40, k)
    return [[x_m + bend * z * z, 1.5, z] for z in zs]


def test_once3d():
    K3 = [[1000.0, 0.0, 960.0], [0.0, 1000.0, 510.0], [0.0, 0.0, 1.0]]
    K4 = [row + [0.1] for row in K3]
    entries = [
        {"lane_num": 3, "calibration": K3, "lanes": [lane3d(-1.8), lane3d(1.8), lane3d(5.4, bend=0.01)]},
        {"lane_num": 2, "calibration": K4, "lanes": [lane3d(-1.7, bend=-0.004), lane3d(1.9)]},
        {"lane_num": 1, "calibration": K3, "lanes": [lane3d(0)]},
        {"calibration": K3, "lanes": []},
        {"lane_num": 2, "calibration": K3, "lanes": [lane3d(-9), lane3d(-6)]},  # off-centre
        {"lane_num": 2, "calibration": K3, "lanes": [lane3d(-1.8, k=1), lane3d(1.8)]},
        {"lane_num": 7, "calibration": K3, "lanes": [lane3d(x) for x in range(-10, 11, 3)]},
    ]
    for e in entries:
        held("jiqing_once3d", "parse_once3d_entry", e)
    held("jiqing_once3d", "parse_once3d_entry", entries[0], (1280, 720))


def test_openlane():
    rec = {"raw_file": "a.jpg", "results": [
        {"cipo_level": 1, "box2d": {"x1": 10, "y1": 20, "x2": 50, "y2": 60}},
        {"cipo_level": 5, "box2d": {"x1": 0, "y1": 0, "x2": 5, "y2": 5}},
        {"cipo_level": "2", "box2d": [100, 100, 150.5, 140]},
        {"cipo_level": 3, "box2d": [7, 7, 7, 7]},
        {"cipo_level": "x", "box2d": [1, 2, 3, 4]},
        {"cipo_level": None, "box2d": [1, 2, 3, 4]},
        {"cipo_level": 4},
        {"attribute": 4, "bbox": [1.5, 2, 30, 40]},
    ]}
    held("openlane", "parse_openlane_cipo", json.dumps(rec))
    held("openlane", "parse_openlane_cipo", json.dumps(
        {"file_path": "b.jpg", "objects": rec["results"][::-1]}))
    held("openlane", "parse_openlane_cipo", "{}")
