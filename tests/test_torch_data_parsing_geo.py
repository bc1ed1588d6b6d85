"""The port's geometric data parsers against the JAX package's, on the CPU:
the EgoLanes BEV ground truth (data_parsing/egolanes_bev.py), the
comma2k19 drivable path (comma2k19.py) and the ZOD AutoDrive labels
(zod.py). Every output is held exactly (tests/test_torch_data_parsing.py::
same): the BEV entries and the JSON files parse_dataset writes, the
geodesy's float64 arrays bit for bit, the radar clusters as the sorted
lists JAX returns, ties in range included.
"""
import json

import numpy as np
import pytest

from autoware_vision_pilot_tpu.data_parsing import comma2k19 as jc2k
from autoware_vision_pilot_tpu.data_parsing import egolanes_bev as jbev
from autoware_vision_pilot_tpu_torch.data_parsing import comma2k19 as tc2k
from autoware_vision_pilot_tpu_torch.data_parsing import egolanes_bev as tbev

from test_torch_data_parsing import OUT, held, run_both


# ---------- EgoLanes BEV ----------

def gentle_frame():
    """tests/test_egolanes_bev.py's gently right-curving road."""
    return {"egoleft_lane": [(0.38, 1.0), (0.41, 0.8), (0.44, 0.62), (0.46, 0.5)],
            "egoright_lane": [(0.62, 1.0), (0.60, 0.8), (0.57, 0.62), (0.55, 0.5)],
            "drivable_path": [(0.50, 1.0), (0.505, 0.8), (0.506, 0.62), (0.505, 0.5)]}


def bev_frames(seed, n=6):
    """Seeded variations of the gentle road (shift, bend, width, points),
    and one frame for each reason the parser skips a frame."""
    rng = np.random.default_rng(seed)
    frames = {}
    for i in range(n):
        shift, bend, width = rng.uniform(-0.04, 0.04), rng.uniform(-0.1, 0.1), rng.uniform(0.9, 1.1)
        ys = np.sort(rng.uniform(0.45, 0.95, int(rng.integers(3, 7))))[::-1]
        ys = np.r_[1.0, ys]

        def line(x0):
            return [(float(0.5 + shift + (x0 - 0.5) * width * (0.4 + 0.6 * y)
                           + bend * (1 - y) ** 2), float(y)) for y in ys]
        frames[f"{seed:02d}{i:04d}"] = {"egoleft_lane": line(0.38), "egoright_lane": line(0.62),
                                        "drivable_path": line(0.5)}
    bad = {k: gentle_frame() for k in ("offcentre", "degenerate", "steep", "crossed", "above")}
    bad["offcentre"]["drivable_path"] = [(x + 0.2, y) for x, y in gentle_frame()["drivable_path"]]
    bad["degenerate"]["egoleft_lane"] = [(0.5, 1.0)] * 2
    bad["steep"]["drivable_path"] = [(0.5 + 0.6 * (1 - y), y) for _, y in
                                     gentle_frame()["drivable_path"]]
    bad["crossed"]["egoleft_lane"], bad["crossed"]["egoright_lane"] = (
        gentle_frame()["egoright_lane"], gentle_frame()["egoleft_lane"])
    bad["above"]["drivable_path"] = [(0.5, 0.2), (0.5, 0.1)]
    frames.update({f"{seed:02d}{k}": f for k, f in bad.items()})
    return frames


@pytest.mark.parametrize("dataset", sorted(jbev.DATASETS))
def test_frame_bev_gt(dataset):
    cfg_j, cfg_t = jbev.DATASETS[dataset], tbev.DATASETS[dataset]
    kept = 0
    for frame in bev_frames(len(dataset)).values():
        entry, _ = run_both(lambda f: jbev.frame_bev_gt(cfg_j, f),
                            lambda f: tbev.frame_bev_gt(cfg_t, f), [frame])[0]
        kept += entry is not None
    assert kept >= 2  # the cases reach the entry, not only the skips


def test_bev_steps():
    """Each step of the per-frame path on its own, for every preset."""
    for name in sorted(jbev.DATASETS):
        cj, ct = jbev.DATASETS[name], tbev.DATASETS[name]
        for frame in list(bev_frames(7, 3).values())[:3] + [gentle_frame()]:
            el, er, path = frame["egoleft_lane"], frame["egoright_lane"], frame["drivable_path"]
            sps = run_both(lambda a, b: jbev.find_source_points(cj, a, b),
                           lambda a, b: tbev.find_source_points(ct, a, b), [el, er])[0]
            H = run_both(lambda s: jbev.bev_homography(cj, s),
                         lambda s: tbev.bev_homography(ct, s), [sps])[0]
            fitted = run_both(lambda p, s, h: jbev.transform_bev(cj, p, s, h),
                              lambda p, s, h: tbev.transform_bev(ct, p, s, h),
                              [path, sps, H])[0][0]
            held("egolanes_bev", "transformed_distance", sps["LS"], sps["midanchor_start"], H)
            for off in (-40.5, 37.0, 400.0):
                run_both(lambda *a: jbev.ego_side(cj, *a), lambda *a: tbev.ego_side(ct, *a),
                         [fitted, off, H])
            bev = [(float(x), float(y)) for x, y in fitted]
            for pts in (bev, [(p[0] + 300, p[1]) for p in bev], [(-5.0, 10.0)]):
                run_both(lambda p: jbev.fit_bev_line(cj, p), lambda p: tbev.fit_bev_line(ct, p),
                         [pts])


def test_bev_helpers():
    rng = np.random.default_rng(8)
    line = [(float(x), float(y)) for x, y in zip(rng.uniform(0, 800, 6), np.linspace(400, 100, 6))]
    for ln in (line, [(50.0, 300.0), (50.0, 200.0)], [(50.0, 300.0), (60.0, 300.0), (70, 200)],
               [(1.0, 2.0), (1.0, 5.0), (1.0, 7.0), (3.0, 9.0)]):
        held("egolanes_bev", "line_anchor", ln, 400)
        held("egolanes_bev", "anchor_angle", ln)
        held("egolanes_bev", "interp_x", ln, 250.0)
        held("egolanes_bev", "normalize_coords", ln, 800, 400)
    for quota in (3, 6, 30):
        held("egolanes_bev", "interp_line", line, quota)
    held("egolanes_bev", "interp_x", line[::-1], 123.0)


def test_bev_config_presets():
    held("egolanes_bev", "BEVConfig", 800, 400)
    held("egolanes_bev", "BEVConfig", 1280, 720, bev_w=320, y_step=64)


def test_parse_dataset_writes_jax_files(tmp_path):
    src = tmp_path / "in" / "drivable_path.json"
    src.parent.mkdir()
    src.write_text(json.dumps(bev_frames(3)))
    for i, (dataset, early) in enumerate((("curvelanes", None), ("tusimple", 4), ("culane", None),
                                          ("openlane", 1))):
        held("egolanes_bev", "parse_dataset", str(src), dataset, OUT + "/bev.json",
             OUT + "/skipped.json", early, tmp=tmp_path / f"run{i}")
    held("egolanes_bev", "parse_dataset", src, "tusimple")  # no files written


# ---------- comma2k19 ----------

def rot_to_quat(R):
    w = np.sqrt(max(0.0, 1 + R[0, 0] + R[1, 1] + R[2, 2])) / 2
    return np.array([w, (R[2, 1] - R[1, 2]) / (4 * w), (R[0, 2] - R[2, 0]) / (4 * w),
                     (R[1, 0] - R[0, 1]) / (4 * w)])


def drive(curvature, n=300, length=120.0, pitch=0.0, seed=0):
    """A drive at the equator heading north (ECEF +y, down -x) along an arc
    of ``curvature`` (1/m), GPS jitter from ``seed``; one orientation for
    every frame, pitched by ``pitch`` rad."""
    rng = np.random.default_rng(seed)
    s = np.linspace(0, length, n)
    th = curvature * s
    y = np.sin(th) / curvature if curvature else s
    z = (1 - np.cos(th)) / curvature if curvature else np.zeros(n)
    pos = np.stack([np.full(n, 6378137.0), y, z], -1) + rng.normal(0, 0.01, (n, 3))
    fwd, down = np.array([0, 1, 0.0]), np.array([-1, 0, 0.0])
    R = np.stack([fwd, np.cross(down, fwd), down], -1)
    c, s_ = np.cos(pitch), np.sin(pitch)
    R = R @ np.array([[c, 0, s_], [0, 1, 0], [-s_, 0, c]])
    return pos, np.tile(rot_to_quat(R), (n, 1))


DRIVES = {"straight": dict(curvature=0.0), "left": dict(curvature=0.002, seed=1),
          "right": dict(curvature=-0.001, seed=2), "tight": dict(curvature=0.03, seed=3),
          "pitched": dict(curvature=0.001, pitch=0.02, seed=4),
          "parked": dict(curvature=0.0, length=0.5, seed=5)}


@pytest.mark.parametrize("name", list(DRIVES))
def test_comma2k19_drivable_path(name):
    pos, quats = drive(**DRIVES[name])
    for idx in (0, 40):
        held("comma2k19", "local_path", idx, pos, quats)
        pts = held("comma2k19", "drivable_path_points", idx, pos, quats)[0]
        held("comma2k19", "drivable_path_points", idx, pos, quats, 1.5)
    if name in ("straight", "left", "right"):
        assert pts is not None
    if pts is not None:
        held("comma2k19", "rasterize_drivable_path", pts)
        held("comma2k19", "rasterize_drivable_path", pts, (262, 524), 1)
        held("comma2k19", "normalize_path", pts)
        held("comma2k19", "normalize_path", pts, (524, 262))


def test_comma2k19_geodesy():
    rng = np.random.default_rng(9)
    geo = np.stack([rng.uniform(-80, 80, 32), rng.uniform(-179, 179, 32),
                    rng.uniform(-100, 4000, 32)], -1)
    ecef = held("comma2k19", "geodetic_to_ecef", geo)[0]
    held("comma2k19", "geodetic_to_ecef", [0.0, 0.0, 0.0])
    held("comma2k19", "ecef_to_geodetic", ecef)
    held("comma2k19", "ecef_to_geodetic", ecef[0])
    held("comma2k19", "ned_matrix", 37.4, -122.1)
    eul = rng.uniform(-np.pi, np.pi, (16, 3))
    q = held("comma2k19", "euler_to_quat", eul)[0]
    held("comma2k19", "quat_to_rot", q)
    held("comma2k19", "quat_to_rot", q[0])
    held("comma2k19", "quat_to_euler", q)
    held("comma2k19", "quat_to_euler", [[1.0, 0, 0, 0], [0.5, 0.5, 0.5, 0.5]])
    pts = np.c_[rng.uniform(-5, 80, 40), rng.uniform(-20, 20, 40), rng.uniform(-2, 3, 40)]
    held("comma2k19", "project_to_image", pts)


def test_comma2k19_local_coord():
    rng = np.random.default_rng(10)
    anchor = [37.4, -122.1, 10.0]
    ned = rng.uniform(-500, 500, (8, 3))
    for make in ("__call__", "from_geodetic", "from_ecef"):
        arg = tc2k.geodetic_to_ecef(anchor) if make == "from_ecef" else anchor
        jc, tc = run_both(getattr(jc2k.LocalCoord, make), getattr(tc2k.LocalCoord, make), [arg])
        run_both(jc.ned_to_ecef, tc.ned_to_ecef, [ned])
        geo = run_both(jc.ned_to_geodetic, tc.ned_to_geodetic, [ned])[0]
        run_both(jc.ecef_to_ned, tc.ecef_to_ned, [jc.ned_to_ecef(ned)])
        run_both(jc.geodetic_to_ned, tc.geodetic_to_ned, [geo])


# ---------- ZOD ----------

def radar_scene(seed, ties=True):
    """Radar returns: an on-path car, an off-path one, a pair of clusters
    mirrored across the axis (equal ranges), noise, and points above and
    below the height gate."""
    rng = np.random.default_rng(seed)
    noise = (rng.uniform(5, 150, 20), rng.choice([-1, 1], 20) * rng.uniform(12, 30, 20),
             rng.normal(0, 3, 20))
    parts = [(30 + rng.normal(0, 0.2, 6), rng.normal(0, 0.1, 6), np.full(6, -2.0)),
             (25 + rng.normal(0, 0.2, 6), 8 + rng.normal(0, 0.1, 6), np.zeros(6)), noise]
    if ties:
        dx, dy = rng.normal(0, 0.1, 5), rng.normal(0, 0.05, 5)
        parts += [(45 + dx, 3 + dy, np.full(5, 1.0)), (45 + dx, -(3 + dy), np.full(5, 1.0))]
    x, y, v = (np.concatenate(p) for p in zip(*parts))
    z = rng.uniform(-0.3, 0.8, len(x))
    z[12:32:3] = rng.choice([-0.9, 1.5], 7)  # noise outside the height gate
    return x, y, z, v


@pytest.mark.parametrize("seed,ties", [(0, True), (1, True), (2, False)])
def test_zod_clusters_and_cipo(seed, ties):
    x, y, z, v = radar_scene(seed, ties)
    clusters = held("zod", "cluster_radar_points", x, y, z, v)[0]
    held("zod", "cluster_radar_points", x, y, z, v, min_samples=3, eps=0.5, max_range_m=40.0)
    if ties:
        ranges = [c["range"] for c in clusters]
        assert len(ranges) != len(set(ranges))  # a tie in range the sort must keep in order
    for k in (0.0, 0.01, -0.02, 0.2):
        cipo = held("zod", "find_cipo_on_path", clusters, k)[0]
        held("zod", "find_cipo_on_path", clusters, k, 2.5, 40.0)
        held("zod", "make_autodrive_label", cipo, k)
        held("zod", "make_autodrive_label", cipo, k, 20.0)
    held("zod", "cluster_radar_points", x, y, np.full_like(z, 5.0), v)  # all gated: []
    held("zod", "cluster_radar_points", [], [], [], [])


def test_zod_geometry():
    rng = np.random.default_rng(11)
    for wheel in (0.0, 0.168, -3.0, 7.5):
        held("zod", "curvature_from_steering", wheel)
    ts = np.array([100, 200, 300, 300, 450], np.uint64)
    for q in (0, 250, 300, 10 ** 6):
        held("zod", "find_closest_idx", q, ts)
    az, el, rg = rng.uniform(-1, 1, 9), rng.uniform(-0.1, 0.1, 9), rng.uniform(1, 200, 9)
    held("zod", "radar_spherical_to_cartesian", az, el, rg)
    for k, r in ((0.0, 50.0), (0.01, 10.0), (-0.05, 80.0), (1e-10, 5.0), (0.5, 100.0)):
        held("zod", "path_azimuth_at_range", k, r)
    held("zod", "pixel_to_h_angle_deg", 1200.5, 3848, 120.0)
    crop = held("zod", "center_crop_50deg", (3848, 2168), 120.0)[0]
    held("zod", "center_crop_50deg", (1920, 1080), 90.0, 40.0)
    held("zod", "pixel_to_h_angle_deg_50", 700.25, crop)
    held("zod", "bbox_crop_to_full", (10.0, 20.5, 300.0, 400.0), crop)
