"""The port's accuracy tools (autoware_vision_pilot_tpu_torch/tools/) against
the JAX package's tools/ on the CPU.

- The data makers (``make_scene``, ``make_boxed_scene``,
  ``render_lane_masks``, ``make_pair``) are bit-equal to the JAX tools',
  and leave their generator in the same state; ``gen_synthetic_dataset``
  writes the same files byte for byte.
- ``e2e_train_demo``'s recipe (the index-pinned split, the batch indices)
  and its mIoU are the JAX tool's.
- ``qat_closure``'s observer schedule (the amax max-merged over the
  observe steps, the scales frozen at step ``observe_steps``) and its
  ``n_quantized_convs`` equal the JAX tool's loop over JAX's observers,
  each port conv fed JAX's input (tests/test_torch_qat.py's ``forcing``),
  SceneSeg at dryrun depth on 64x128.
- Each tool's ``run`` completes at a small size and prints the keys of the
  JAX tool's JSON line (read from the JAX tool's source); the QAT export
  goes through ``validate_checkpoint`` (its int8 convs on their plain
  versions here) and counts every labelled pixel.
- Every tool imports with JAX unimportable.
"""
import ast
import filecmp
import json
import pathlib
import subprocess
import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoware_vision_pilot_tpu.models import efficientnet as je
from autoware_vision_pilot_tpu.models.scene_seg import SceneSegNetwork as JSceneSeg
from autoware_vision_pilot_tpu.train import metrics as jmetrics
from autoware_vision_pilot_tpu.train import qat as jqat
from autoware_vision_pilot_tpu.train.datasets import decode_scene_seg_mask as jdecode
from autoware_vision_pilot_tpu_torch.inference import AutoSteerInfer, EgoLanesInfer
from autoware_vision_pilot_tpu_torch.inference.infer import load_weights
from autoware_vision_pilot_tpu_torch.models import efficientnet as te
from autoware_vision_pilot_tpu_torch.models.auto_steer_temporal import AutoSteerTemporalNet
from autoware_vision_pilot_tpu_torch.models.ego_lanes import EgoLanesNetwork
from autoware_vision_pilot_tpu_torch.models.scene_seg import SceneSegNetwork
from autoware_vision_pilot_tpu_torch.nn.layers import Int8Conv2d
from autoware_vision_pilot_tpu_torch.tools import (debug_autosteer, e2e_autospeed_demo,
                                                   e2e_autosteer_demo, e2e_train_demo,
                                                   gen_synthetic_dataset, qat_closure,
                                                   validate_checkpoint)
from autoware_vision_pilot_tpu_torch.train import qat as tqat

from test_torch_layers import port_with, seeded_variables
from test_torch_qat import capture_conv_inputs, forcing, name_map, rnd, sown
from test_torch_train_step import one_thread  # noqa: F401 (an autouse fixture)

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_TOOLS = ROOT / "tools"
sys.path.insert(0, str(JAX_TOOLS))
import e2e_autospeed_demo as j_autospeed  # noqa: E402
import e2e_autosteer_demo as j_autosteer  # noqa: E402
import gen_synthetic_dataset as j_gen  # noqa: E402

CTX, HW = (2, 4), (64, 128)
SMALL_CTX, SMALL_HW = (1, 2), (32, 64)  # the runs that train
TOOLS = ("gen_synthetic_dataset", "e2e_train_demo", "validate_checkpoint",
         "e2e_autosteer_demo", "e2e_autospeed_demo", "qat_closure", "debug_autosteer")


def dryrun_scene_seg():
    return SceneSegNetwork(SMALL_CTX, te.B0_DRYRUN_STAGES)


def assert_same(a, b):
    assert type(a) is type(b)
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
    elif isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
    else:
        assert a == b


def same_draws(jax_fn, port_fn, seed, n=3):
    """n calls of each on generators of one seed: equal values, and the
    generators left in one state."""
    rj, rp = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(n):
        assert_same(jax_fn(rj), port_fn(rp))
    assert rj.bit_generator.state == rp.bit_generator.state


@pytest.mark.parametrize("hw", [(320, 640), (96, 200)])
@pytest.mark.parametrize("seed", [0, 1, 10_003])
def test_make_scene_is_the_jax_tools(hw, seed):
    same_draws(lambda r: j_gen.make_scene(r, hw),
               lambda r: gen_synthetic_dataset.make_scene(r, hw), seed)


@pytest.mark.parametrize("hw", [(256, 512), (128, 256)])
def test_make_boxed_scene_is_the_jax_tools(hw):
    for seed in (0, 1234, 7):
        same_draws(lambda r: j_autospeed.make_boxed_scene(r, hw),
                   lambda r: e2e_autospeed_demo.make_boxed_scene(r, hw), seed, n=4)


def test_autosteer_masks_are_the_jax_tools():
    for seed in range(6):
        same_draws(j_autosteer.make_pair, e2e_autosteer_demo.make_pair, seed)
    for angle in (-30.0, -11.7, 0.0, 4.5, 30.0):
        for h, w in ((80, 160), (24, 48), (7, 3)):
            same_draws(lambda r: j_autosteer.render_lane_masks(angle, r, h, w),
                       lambda r: e2e_autosteer_demo.render_lane_masks(angle, r, h, w), 5, n=2)


def test_train_batches_are_make_boxed_scene_in_order():
    """The two-thread batch maker gives the scenes a loop of
    make_boxed_scene would, padded as pad_targets pads them."""
    from autoware_vision_pilot_tpu.train.yolo_data import pad_targets as jpad
    hw, steps, batch = (96, 192), 3, 5
    rng = np.random.default_rng(4)
    want = []
    for _ in range(steps):
        scenes = [j_autospeed.make_boxed_scene(rng, hw) for _ in range(batch)]
        padded = [jpad(b, l, hw, e2e_autospeed_demo.MAX_BOXES) for _, b, l in scenes]
        want.append((np.stack([s[0] for s in scenes]),
                     *(np.stack([p[k] for p in padded]) for k in range(3))))
    got = list(e2e_autospeed_demo.train_batches(np.random.default_rng(4), steps, batch, hw))
    assert len(got) == steps
    for g, w in zip(got, want):
        assert_same(tuple(g), tuple(w))


def test_gen_synthetic_dataset_writes_the_jax_tools_files(tmp_path):
    args = ["--n", "4", "--hw", "64", "128"]
    assert j_gen.main([str(tmp_path / "jax"), *args]) == 0
    assert gen_synthetic_dataset.main([str(tmp_path / "port"), *args]) == 0
    for sub in ("images", "labels"):
        names = sorted(p.name for p in (tmp_path / "jax" / sub).iterdir())
        assert names == [f"{i:05d}.png" for i in range(4)]
        assert sorted(p.name for p in (tmp_path / "port" / sub).iterdir()) == names
        match, mismatch, errors = filecmp.cmpfiles(tmp_path / "jax" / sub,
                                                   tmp_path / "port" / sub, names, shallow=False)
        assert match == names and not mismatch and not errors


def test_e2e_train_demo_recipe_is_the_jax_tools():
    """The JAX tool's split (scene i from default_rng(i), validation from
    10_000) and its batches (rng.choice of default_rng(0), step by step)."""
    for i in (0, 47, 10_000, 10_007):
        img, lab = j_gen.make_scene(np.random.default_rng(i), (320, 640))
        ids, _ = jdecode(lab)
        assert_same(e2e_train_demo.seg_sample(i), (img.astype(np.float32) / 255.0,
                                                   ids.astype(np.int32)))
    assert e2e_train_demo.VAL_SEED0 == 10_000
    assert (e2e_train_demo.N_TRAIN, e2e_train_demo.N_VAL, qat_closure.N_VAL) == (48, 8, 16)
    rj, rp = np.random.default_rng(0), np.random.default_rng(0)
    for _ in range(60):
        assert_same(rj.choice(48, 8, replace=False), e2e_train_demo.batch_indices(rp, 48, 8))


def test_miou_is_the_jax_tools():
    rng = np.random.default_rng(3)
    pred = rng.integers(0, 3, (4, 16, 32)).astype(np.int32)
    gt = rng.integers(0, 3, (4, 16, 32)).astype(np.int32)
    gt[1] = np.where(gt[1] == 1, 0, gt[1])  # a class missing from one image
    cm = sum(np.asarray(jmetrics.confusion_matrix(jnp.asarray(pred[i]), jnp.asarray(gt[i]), 3))
             for i in range(4))
    assert e2e_train_demo.miou_of(pred, gt) == jmetrics.miou_from_confusion(cm)[1]


@pytest.mark.parametrize("min_ch,per_channel", [(32, False), (128, True)])
def test_qat_observer_schedule_is_the_jax_tools(min_ch, per_channel):
    """Four QAT forwards of one SceneSeg with observe_steps 2: the JAX
    tool's act_running (per-step collect_act_scales, np.maximum across the
    steps before the freeze) and the port's ObserverSchedule, each port
    conv fed JAX's input, are the same scales by conv, bit for bit; the
    frozen scales do not move after the freeze; n_quantized_convs agree."""
    jmod = JSceneSeg(ctx_hw=CTX, backbone_stages=je.B0_DRYRUN_STAGES)
    v = seeded_variables(jmod, jnp.zeros((1, *HW, 3)), seed=21)
    port = port_with(SceneSegNetwork(CTX, te.B0_DRYRUN_STAGES), v)
    names = name_map(port)

    @jax.jit  # once for the four forwards; the variables an argument, as in test_torch_qat
    def jax_forward(vv, xx):
        with capture_conv_inputs():
            return jqat.qat_apply(jmod, vv, xx, mutable=["intermediates"], min_channels=min_ch,
                                  per_channel_act=per_channel)
    observe_steps, act_running = 2, {}
    schedule = qat_closure.ObserverSchedule(observe_steps)
    for step in range(4):
        x = rnd((2, *HW, 3), 30 + step)
        if step == observe_steps:
            want = dict(act_running)
            frozen = schedule.static_scales(step)
        inter = jax.tree.map(np.asarray, jax_forward(v, jnp.asarray(x))[1]["intermediates"])
        inputs = {p: vals[0] for p, vals in sown(inter, "x_in").items()}
        scales = jqat.collect_act_scales(inter)
        if step < observe_steps:  # the JAX tool's loop
            for path, s in scales.items():
                prev = act_running.get(path)
                act_running[path] = s if prev is None else np.maximum(prev, s)
        observers = {}
        remove = forcing(port, inputs)
        try:
            with torch.no_grad():
                tqat.qat_apply(port, torch.from_numpy(x).permute(0, 3, 1, 2),
                               min_channels=min_ch, per_channel_act=per_channel,
                               static_scales=schedule.static_scales(step),
                               observers=observers)
        finally:
            remove()
        schedule.observe(step, observers)
    assert schedule.static_scales(3) is frozen
    assert len(frozen) == len(want) > 0
    assert {names[p] for p in want} == set(frozen)
    for path, s in want.items():
        got = frozen[names[path]]
        if per_channel:
            assert got.dtype == s.dtype == np.float32 and np.array_equal(got, s), path
        else:
            assert isinstance(got, float) and got == s, path
    assert len(schedule.scales()) == len(want)  # later steps merged nothing


def jax_tool_keys(name):
    """The keys of the JSON line the JAX tool prints: its dict literal with
    a "metric" key."""
    for node in ast.walk(ast.parse((JAX_TOOLS / f"{name}.py").read_text())):
        if isinstance(node, ast.Dict):
            keys = [k.value for k in node.keys if isinstance(k, ast.Constant)]
            if "metric" in keys:
                return keys
    raise AssertionError(f"no JSON line in tools/{name}.py")


def json_line(out):
    lines = [json.loads(line) for line in out.splitlines() if line.startswith('{"metric"')]
    assert len(lines) == 1, out
    return lines[0]


def test_e2e_train_demo_runs(tmp_path, capsys):
    result = e2e_train_demo.run(2, 2, str(tmp_path), "cpu", make_model=dryrun_scene_seg,
                                hw=SMALL_HW)
    line = json_line(capsys.readouterr().out)
    assert list(line) == jax_tool_keys("e2e_train_demo") and line == result
    assert result["checkpoint_roundtrip"] == "identical" and result["viz"] is True
    assert len(result["loss_first5"]) == 2 and all(np.isfinite(result["loss_first5"]))
    assert (tmp_path / "scene_seg_demo.msgpack").exists()
    assert (tmp_path / "val0_overlay.png").exists()


def test_qat_closure_and_validate_checkpoint_run(tmp_path, capsys):
    """qat_closure at dryrun depth, per-channel scales, with distillation;
    then its int8 export through validate_checkpoint over a synthetic
    dataset: the int8 convs load where the tree has them, and the
    confusion matrix counts every labelled pixel of the validation split."""
    result = qat_closure.run(1, 2, None, 0.5, 5e-5, 32, True, 2, str(tmp_path / "qat"), "cpu",
                             make_model=dryrun_scene_seg, hw=SMALL_HW)
    line = json_line(capsys.readouterr().out)
    assert list(line) == jax_tool_keys("qat_closure") and line == result
    assert result["observe_steps"] == 1 and result["n_quantized_convs"] > 0
    for k in ("argmax_agreement_int8_vs_bf16", "control_agreement_bf16_vs_f32"):
        assert 0.0 <= result[k] <= 1.0
    ckpt = tmp_path / "qat" / "scene_seg_qat_int8.msgpack"

    gen_synthetic_dataset.run(str(tmp_path / "ds"), 20, SMALL_HW)
    cm, iou, miou, overall = validate_checkpoint.run(
        [f"{tmp_path / 'ds'}:SYN"], str(ckpt), 4, "cpu", make_model=dryrun_scene_seg,
        hw=SMALL_HW)
    assert cm.sum() == 2 * SMALL_HW[0] * SMALL_HW[1]  # samples 9 and 19, every pixel labelled
    assert 0.0 <= miou <= 1.0 and iou.shape == (3,)
    model = validate_checkpoint.load_model(dryrun_scene_seg, str(ckpt), "cpu")
    assert sum(isinstance(m, Int8Conv2d) for m in model.modules()) == 30  # >= 32 channels
    assert all(m.input_scale is not None and m.input_scale.dim() == 1
               for m in model.modules() if isinstance(m, Int8Conv2d))


def test_e2e_autosteer_demo_runs(tmp_path, capsys):
    result = e2e_autosteer_demo.run(3, 4, 8, 1e-3, str(tmp_path), "cpu")
    out = capsys.readouterr().out
    line = json_line(out)
    assert list(line) == jax_tool_keys("e2e_autosteer_demo") and line == result
    assert json.loads((tmp_path / "result.json").read_text()) == result
    assert (tmp_path / "final.msgpack").exists()
    assert "[autosteer_demo] step 0 loss" in out


def test_e2e_autospeed_demo_runs(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(e2e_autospeed_demo, "default_out", lambda name: str(tmp_path / name))
    result = e2e_autospeed_demo.run(2, 2, 2e-3, 3, 0.1, "cpu", hw=(96, 192))
    line = json_line(capsys.readouterr().out)
    assert list(line) == jax_tool_keys("e2e_autospeed_demo") and line == result
    assert np.isfinite(result["final_loss"]) and 0.0 <= result["map50"] <= 1.0
    assert (tmp_path / "e2e_autospeed" / "final.msgpack").exists()


def test_debug_autosteer_runs(tmp_path, capsys):
    """Three distinct frames: two nonzero frame-to-frame diffs and two
    steering angles; a repeated frame gives a zero diff and the warning."""
    vid = tmp_path / "clip.avi"
    w = cv2.VideoWriter(str(vid), cv2.VideoWriter_fourcc(*"MJPG"), 10.0, (128, 64))
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 255, (64, 128, 3), dtype=np.uint8) for _ in range(3)]
    for f in frames + frames[-1:]:
        w.write(f)
    w.release()
    lanes = EgoLanesInfer(model=EgoLanesNetwork(CTX, te.B0_DRYRUN_STAGES), input_hw=HW,
                          device="cpu")
    steer = AutoSteerInfer(device="cpu")
    steer.model = load_weights(AutoSteerTemporalNet((HW[0] // 4, HW[1] // 4)), device="cpu")
    got = debug_autosteer.run(str(vid), 5, device="cpu", lanes=lanes, steer=steer)
    out = capsys.readouterr().out
    assert got["frames"] == 4 and len(got["diffs"]) == 3 and len(got["angles"]) == 3
    assert got["diffs"][0] > 0 and got["diffs"][1] > 0 and got["diffs"][2] == 0.0
    assert out.count("IDENTICAL") == 1
    assert "raw logits" in out and "steering" in out
    assert all(-30 <= a <= 30 for a in got["angles"])


def test_tools_import_without_jax():
    code = ("import sys; sys.modules['jax'] = None\n"
            "import importlib\n"
            f"for name in {TOOLS!r}:\n"
            "    importlib.import_module('autoware_vision_pilot_tpu_torch.tools.' + name)\n"
            "assert not any(m == 'jax' or m.startswith(('jax.', 'flax', 'optax', "
            "'autoware_vision_pilot_tpu.')) for m in sys.modules if sys.modules[m] is not None)\n"
            "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr
