"""The port's data tools against the JAX package's, on the CPU:
utils/check_data.py (``check_dataset``'s report, the audit images it
writes and the CLI's printout and exit code) and utils/manual_audit.py
(``AuditSession``: accept, reject, back, save and resume, as
tests/test_utils_tools.py runs JAX's). ``run_audit_app`` needs a display
(cv2.imshow) and is left out, as it is for the JAX package.
"""
import contextlib
import io
import json
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest

from autoware_vision_pilot_tpu.train.datasets import SCENESEG_COLOURS
from autoware_vision_pilot_tpu.utils import check_data as jcd
from autoware_vision_pilot_tpu.utils import manual_audit as jma
from autoware_vision_pilot_tpu_torch.data_parsing.common import write_unified_sample
from autoware_vision_pilot_tpu_torch.utils import check_data as tcd
from autoware_vision_pilot_tpu_torch.utils import manual_audit as tma

from test_torch_data_parsing import OUT, REPO, outcome, run_both

COLOURS = np.array(list(SCENESEG_COLOURS.values()), np.uint8)


def unified_set(root, n=4, seed=0, hw=(24, 40)):
    rng = np.random.default_rng(seed)
    for i in range(n):
        write_unified_sample(root, f"{i:04d}", rng.integers(0, 256, (*hw, 3), dtype=np.uint8),
                             COLOURS[rng.integers(0, len(COLOURS), hw)])
    return root


def broken_sets(tmp_path):
    """A set of each fault check_dataset reports."""
    sets = {}
    root = unified_set(tmp_path / "unknown_colours", seed=1)
    lab = cv2.imread(str(root / "labels" / "0002.png"))
    lab[3:9, 5:17] = (1, 2, 3)
    cv2.imwrite(str(root / "labels" / "0002.png"), lab)
    sets["unknown_colours"] = root
    root = unified_set(tmp_path / "count", seed=2)
    (root / "labels" / "0003.png").unlink()
    sets["count"] = root
    root = unified_set(tmp_path / "names", seed=3)
    (root / "labels" / "0001.png").rename(root / "labels" / "0001b.png")
    sets["names"] = root
    root = unified_set(tmp_path / "size", seed=4)
    cv2.imwrite(str(root / "images" / "0000.png"), np.zeros((12, 40, 3), np.uint8))
    sets["size"] = root
    root = unified_set(tmp_path / "unreadable_image", seed=5)
    (root / "images" / "0002.png").write_bytes(b"not a png")
    sets["unreadable_image"] = root
    root = unified_set(tmp_path / "unreadable_label", seed=6)
    (root / "labels" / "0002.png").write_bytes(b"not a png")
    sets["unreadable_label"] = root
    sets["empty"] = tmp_path / "empty"
    return sets


@pytest.mark.parametrize("limit", [None, 2])
def test_check_dataset_on_a_clean_set(tmp_path, limit):
    root = unified_set(tmp_path / "set")
    report = run_both(jcd.check_dataset, tcd.check_dataset, [root, None, limit])[0]
    assert not report["bad_pairs"] and not report["mismatched_names"]
    assert report["unknown_colors"] == 0
    run_both(jcd.check_dataset, tcd.check_dataset, [root, OUT + "/audit", limit], tmp=tmp_path / "a")
    assert len(list((tmp_path / "a" / "port" / "audit").glob("*.png"))) == (limit or 4)


def test_check_dataset_reports_each_fault_as_jax_does(tmp_path):
    for name, root in broken_sets(tmp_path).items():
        report = run_both(jcd.check_dataset, tcd.check_dataset, [root])[0]
        if name == "unreadable_label":
            assert report[0] == "raised", report  # cvtColor of no image, in both
        elif name == "unknown_colours":
            assert report["unknown_colors"] == 72
        elif name != "empty":
            assert report["bad_pairs"] or report["mismatched_names"], name


def cli(main, argv):
    """-> (the exit code, or what it raised; the printout)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = outcome(main, [argv], {})
    return code, buf.getvalue()


def test_check_data_cli_prints_and_exits_as_jax(tmp_path):
    sets = {"clean": unified_set(tmp_path / "clean"), **broken_sets(tmp_path)}
    sets.pop("unreadable_label")
    codes = {}
    for name, root in sets.items():
        for argv in ([str(root)], [str(root), "--limit", "1"],
                     [str(root), "--audit-dir", str(tmp_path / "audit" / name)]):
            j, t = cli(jcd.main, argv), cli(tcd.main, argv)
            assert j == t, (name, argv)
            codes.setdefault(name, t[0])
    assert codes == {"clean": 0, "unknown_colours": 0, "count": 1, "names": 1, "size": 1,
                     "unreadable_image": 1, "empty": 0}
    # the audit overlay of a pair of two sizes raises in both (cv2.addWeighted)
    assert cli(tcd.main, [str(sets["size"]), "--audit-dir", str(tmp_path / "s")])[0][0] == "raised"


def test_check_data_runs_as_a_module(tmp_path):
    """``python -m autoware_vision_pilot_tpu_torch.utils.check_data``: the
    JAX CLI's printout and exit code."""
    root = broken_sets(tmp_path)["names"]
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    got = subprocess.run([sys.executable, "-m", "autoware_vision_pilot_tpu_torch.utils.check_data",
                          str(root)], capture_output=True, text=True, env=env, timeout=120)
    assert (got.returncode, got.stdout) == cli(jcd.main, [str(root)])


def image_folder(root, n=4):
    root.mkdir(parents=True, exist_ok=True)
    for i in range(n):
        cv2.imwrite(str(root / f"f{i:03d}.png"), np.full((8, 8, 3), i * 10, np.uint8))
    (root / "notes.txt").write_text("not an image")
    cv2.imwrite(str(root / "g.JPG"), np.zeros((4, 4, 3), np.uint8))
    return root


def session_state(s):
    return (s.image_files, s.accepted, s.rejected, s.current_index, s.done, s.current, s.summary())


def test_audit_session_accept_reject_back_and_resume(tmp_path):
    """Both packages' sessions through the same key presses, their states
    and the saved audit_state.json equal after each."""
    folders = {side: image_folder(tmp_path / side) for side in ("jax", "port")}
    keys = [["accept", "reject", "save"], ["back", "back", "back", "reject", "accept", "save"],
            ["accept", "accept", "accept", "accept", "save"], ["back", "save"]]
    for round_keys in keys:  # each round resumes from the file the last one saved
        sessions = {"jax": jma.AuditSession(folders["jax"]),
                    "port": tma.AuditSession(folders["port"])}
        assert session_state(sessions["jax"]) == session_state(sessions["port"])
        for key in round_keys:
            for s in sessions.values():
                getattr(s, key)()
            assert session_state(sessions["jax"]) == session_state(sessions["port"])
        assert (folders["jax"] / jma.STATE_FILE).read_text() == \
            (folders["port"] / tma.STATE_FILE).read_text()
    final = json.loads((folders["port"] / tma.STATE_FILE).read_text())
    assert final == {"accepted": ["f001.png", "f002.png", "f003.png"],
                     "rejected": ["f000.png"], "current_index": 4}


def test_audit_session_state_file_elsewhere(tmp_path):
    folder = image_folder(tmp_path / "imgs")
    for mod, side in ((jma, "jax"), (tma, "port")):
        s = mod.AuditSession(folder, tmp_path / f"{side}.json")
        s.reject()
        s.save()
    (tmp_path / "stale.json").write_text(json.dumps(
        {"accepted": ["gone.png", "f000.png"], "rejected": ["f001.png"], "current_index": 99}))
    assert (tmp_path / "jax.json").read_text() == (tmp_path / "port.json").read_text()
    resumed = [session_state(mod.AuditSession(folder, tmp_path / "stale.json"))
               for mod in (jma, tma)]
    assert resumed[0] == resumed[1] and resumed[1][3] == 5 and resumed[1][4]
