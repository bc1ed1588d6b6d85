"""The port's Lite evaluation CLI (export/eval_lite.py) against the JAX
package's, on the CPU in f32: the whole slice, from a msgpack file that the
JAX package's ``save_msgpack`` wrote, through ``main`` on both sides.

For each of the three Lite configs at 64x128 on two synthetic samples:
the port's forward outputs (read where ``main`` scores them) are within
atol 2e-4, rtol 1e-3 of JAX's (read by a ``jax.debug.callback`` on the
model's output inside JAX's jitted forward); the port's scoring of JAX's
outputs gives JAX's summary exactly; the predictions are equal wherever
JAX's outputs decide them by more than the bar (seg: the top two logits;
lanes: the logit against 0), and the two summaries are equal unless a
prediction within the bar went the other way (depth: always equal).

JAX's ``main`` calls ``model.init`` only to give ``load_msgpack`` its
target tree: the file's values replace every leaf. The test hands it
``jax.eval_shape``'s tree in place of the op-by-op init (~40 s a net on
an 8-core CPU); nothing else of JAX's CLI is changed.

The CLI's refusals (``--bench`` on the CPU, a missing ``--checkpoint``)
and its smoke mode are here too; its ``--int8`` is in tests/test_torch_lite_int8.py
and its ``--onnx`` in tests/test_torch_convert_import.py.
"""
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from autoware_vision_pilot_tpu.export import eval_lite as jeval
from autoware_vision_pilot_tpu.export.checkpoints import save_msgpack
from autoware_vision_pilot_tpu.models.lite import build_lite_model as j_build
from autoware_vision_pilot_tpu.train.lite_trainer import load_experiment_config

from autoware_vision_pilot_tpu_torch.export import eval_lite as teval

from test_torch_layers import ATOL, RTOL, seeded_variables
from test_torch_train_step import one_thread  # noqa: F401 (an autouse fixture)

CONFIGS = pathlib.Path(__file__).resolve().parents[1] / "configs"
HW = (64, 128)
TASKS = {"SceneSegLite": "seg", "EgoLanesLite": "lanes", "Scene3DLite": "depth"}


class ShapeInit:
    """A JAX Lite model whose ``init`` is ``jax.eval_shape``'s, and whose
    ``apply`` sends each output to ``outputs`` (a host callback)."""

    def __init__(self, model, outputs):
        self.model, self.outputs = model, outputs

    def init(self, rng, x):
        return jax.eval_shape(self.model.init, rng, x)

    def apply(self, variables, x, **kw):
        y = self.model.apply(variables, x, **kw)
        jax.debug.callback(lambda a: self.outputs.append(np.asarray(a, np.float32)), y)
        return y


@pytest.fixture(scope="module")
def weight_files(tmp_path_factory):
    """Seeded JAX variables of each config's net, as JAX's save_msgpack
    writes them -> {config: path}."""
    out = {}
    for i, name in enumerate(TASKS):
        model = j_build(load_experiment_config(CONFIGS / f"{name}.yaml"))
        v = seeded_variables(model, jax.ShapeDtypeStruct((1, *HW, 3), jnp.float32), seed=40 + i)
        out[name] = tmp_path_factory.mktemp(name) / f"{name}.msgpack"
        save_msgpack(out[name], v)
    return out


def decided(task, ref, bar):
    """Where JAX's output decides the prediction by more than ``bar``."""
    if task == "seg":
        top = np.sort(ref, -1)
        return top[..., -1] - top[..., -2] > bar
    return np.abs(ref) > bar


def prediction(task, out):
    return out.argmax(-1) if task == "seg" else out > 0


@pytest.mark.parametrize("name", list(TASKS))
def test_eval_lite_matches_jax(name, weight_files, monkeypatch, tmp_path):
    task = TASKS[name]
    argv = ["--config", str(CONFIGS / f"{name}.yaml"), "--msgpack", str(weight_files[name]),
            "--synthetic", "2", "--height", str(HW[0]), "--width", str(HW[1])]
    jax_outs = []
    monkeypatch.setattr(jeval, "build_lite_model",
                        lambda cfg, **kw: ShapeInit(j_build(cfg, **kw), jax_outs))
    want = jeval.main(argv)
    pairs = []
    score = teval.score

    def spy(task_, pairs_, *a):
        pairs.extend(pairs_)
        return score(task_, pairs, *a)

    monkeypatch.setattr(teval, "score", spy)
    got = teval.main(argv + ["--device", "cpu", "--out", str(tmp_path / "s.json")])
    assert (tmp_path / "s.json").read_text().strip() == json.dumps(got)
    assert got["task"] == want["task"] == task and got["samples"] == want["samples"] == 2
    assert len(pairs) == len(jax_outs) == 2

    cfg = load_experiment_config(CONFIGS / f"{name}.yaml")
    scored = score(task, [(r[0], lbl) for r, (_, lbl) in zip(jax_outs, pairs)],
                   int(cfg["loss"].get("num_classes", 3)), cfg["loss"].get("ignore_index"))
    assert {"config": want["config"], "task": task, "input_hw": list(HW), **scored} == want

    bar = ATOL + RTOL * max(np.abs(r).max() for r in jax_outs)
    flips = 0
    for (out, _), ref in zip(pairs, jax_outs):
        np.testing.assert_allclose(out, ref[0], atol=ATOL, rtol=RTOL)
        if task != "depth":
            where = decided(task, ref[0], bar)
            p, q = prediction(task, out), prediction(task, ref[0])
            np.testing.assert_array_equal(p[where], q[where])
            flips += int((p != q).sum())
    if flips == 0:  # depth: the metrics of outputs that agree to ~2e-7
        assert got == want
    else:  # a prediction within the bar of a tie went the other way
        assert set(got) == set(want)


def test_eval_lite_refuses_what_is_not_ported():
    base = ["--config", str(CONFIGS / "SceneSegLite.yaml"), "--synthetic", "1",
            "--device", "cpu"]
    with pytest.raises(FileNotFoundError):  # --onnx is ported: a missing file, not a refusal
        teval.main(base + ["--onnx", "missing.onnx"])
    with pytest.raises(FileNotFoundError):  # --checkpoint is ported: a missing directory
        teval.main(base + ["--checkpoint", "ckpt/"])
    with pytest.raises(ValueError, match="--bench times the card"):
        teval.main(base + ["--height", "32", "--width", "64", "--bench"])


def test_eval_lite_smoke_mode(capsys):
    """No weights: seed 0, JAX's message, a finite summary."""
    s = teval.main(["--config", str(CONFIGS / "EgoLanesLite.yaml"), "--synthetic", "1",
                    "--height", "32", "--width", "64", "--device", "cpu"])
    assert "random init (smoke mode)" in capsys.readouterr().err
    assert s["samples"] == 1 and len(s["lane_iou"]) == 3
    assert all(np.isfinite(s["lane_iou"]))
