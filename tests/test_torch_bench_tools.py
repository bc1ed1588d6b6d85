"""The port's bench tools (autoware_vision_pilot_tpu_torch/tools/bench_*.py and
profile_pipeline_stages.py) against the JAX package's tools/ on the CPU.

- bench_zoo: the eight models and shapes are the JAX tool's ``models()``,
  and each model's parameter count (float parameters and BatchNorm
  statistics) is the count of JAX's variables (``jax.eval_shape`` of its
  init), at full width.
- profile_pipeline_stages: each stage function, on the tool's seeded numpy
  inputs at a small size (a 144x256 frame to 64x128, the main path's 2.25 x
  2 scale), against the JAX tool's stage on the same inputs and the same
  weights (JAX's seeded variables through convert/from_jax.py): the
  preprocess at 1e-5 (the resize taps' bar at this scale,
  tests/test_torch_preprocess.py), the B0 trunk and EgoLanes at dryrun depth
  and the full-depth stack at atol 2e-4, rtol 1e-3, the post-processing
  exactly.
- The --int8 recipes of bench_app_loop (EgoLanes on the preprocessed crop,
  AutoSpeed on the letterboxed frames) and bench_fleet (EgoLanes on N(0, 1)
  inputs) against the JAX tools' recipe on the same frames: every
  calibrated input scale to rtol 1e-5, the same convs selected (at
  min_channels 128, at dryrun depth).
- The frame pools, calibration frames, fleet ticks, train batches and
  profile inputs are the JAX tools' numpy draws bit for bit (the JAX
  tools' own statements, read from their sources and run).
- Each tool takes the JAX tool's flags, prints its keys and metric names
  (the fleet's by running the JAX tool's ``main``), runs at a small size on
  the CPU, refuses ``--device cuda`` without a card, and imports without
  JAX; the port's container file copies what exists and its entry point
  answers ``--help``.
"""
import ast
import json
import pathlib
import subprocess
import sys

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autoware_vision_pilot_tpu.export import quantize as jq
from autoware_vision_pilot_tpu.models import efficientnet as je
from autoware_vision_pilot_tpu.models.auto_speed import AutoSpeedNetwork as JAutoSpeed
from autoware_vision_pilot_tpu.models.ego_lanes import EgoLanesNetwork as JLanes
from autoware_vision_pilot_tpu.models.multitask import SharedPerceptionStack as JStack
from autoware_vision_pilot_tpu.nn import layers as jl
from autoware_vision_pilot_tpu.ops import postprocess as jpost
from autoware_vision_pilot_tpu.ops.preprocess import letterbox as j_letterbox
from autoware_vision_pilot_tpu.ops.preprocess import preprocess_imagenet as j_preprocess
from autoware_vision_pilot_tpu_torch.models import SceneSegNetwork
from autoware_vision_pilot_tpu_torch.models import efficientnet as te
from autoware_vision_pilot_tpu_torch.models.auto_speed import AutoSpeedNetwork
from autoware_vision_pilot_tpu_torch.models.ego_lanes import EgoLanesNetwork
from autoware_vision_pilot_tpu_torch.models.multitask import SharedPerceptionStack
from autoware_vision_pilot_tpu_torch.nn.layers import Int8Conv2d
from autoware_vision_pilot_tpu_torch.pipeline import calibration_batches
from autoware_vision_pilot_tpu_torch.runtime.pipeline import (build_lateral_pipeline,
                                                              build_longitudinal_pipeline)
from autoware_vision_pilot_tpu_torch.tools import (bench_app_loop, bench_fleet, bench_train,
                                                   bench_zoo, profile_pipeline_stages)

from test_torch_layers import ATOL, RTOL, from_port, port_with, seeded_variables, to_port
from test_torch_train_step import one_thread  # noqa: F401 (an autouse fixture)

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_TOOLS = ROOT / "tools"
sys.path.insert(0, str(JAX_TOOLS))
import bench_fleet as j_fleet  # noqa: E402
import bench_zoo as j_zoo  # noqa: E402

TOOLS = ("bench_app_loop", "bench_fleet", "bench_train", "bench_zoo",
         "profile_pipeline_stages")
CTX, NET_HW = (2, 4), (64, 128)
FRAME_HW, CROP_Y = (164, 256), 20  # the crop 144x256 -> 64x128: the main path's 2.25 x 2
SPEED_HW = (128, 128)  # AutoSpeed's input: the 164x256 frame letterboxes at scale 0.5
MIN_CH = 128


def jax_source(name):
    return ast.parse((JAX_TOOLS / f"{name}.py").read_text())


def jax_function(name, fn):
    return next(n for n in ast.walk(jax_source(name))
                if isinstance(n, ast.FunctionDef) and n.name == fn)


def run_jax_statements(name, fn, targets, namespace):
    """Runs, in order, the statements of the JAX tool ``name``'s function
    ``fn`` that assign one of ``targets`` (its own code, read from its
    source) in ``namespace`` -> the namespace."""
    body = sorted((n for n in ast.walk(jax_function(name, fn)) if isinstance(n, ast.Assign)
                   and any(isinstance(t, ast.Name) and t.id in targets for t in n.targets)),
                  key=lambda n: n.lineno)
    code = compile(ast.Module(body=body, type_ignores=[]), f"tools/{name}.py", "exec")
    namespace = {"np": np, "jnp": jnp, "jax": jax, **namespace}
    exec(code, namespace)
    return namespace


# ---------- bench_zoo ----------

def test_zoo_is_the_jax_tools_models_and_parameter_counts():
    port = list(bench_zoo.models())
    ref = list(j_zoo.models())
    assert [(n, s) for n, _, s in port] == [(n, s) for n, _, s in ref]
    for (name, make, shape), (_, jmodel, _) in zip(port, ref):
        x = jax.ShapeDtypeStruct(shape, jnp.bfloat16)
        init = ((lambda k, x: jmodel.init(k, x, x)) if name == "AutoDrive"
                else (lambda k, x: jmodel.init(k, x)))
        variables = jax.eval_shape(init, jax.random.key(0), x)
        assert bench_zoo.param_count(make()) == sum(
            leaf.size for leaf in jax.tree.leaves(variables)), name


def test_zoo_keys_and_error_line(capsys):
    def boom():
        raise RuntimeError("no such model")

    zoo = [("SceneSeg", lambda: SceneSegNetwork((1, 2), te.B0_DRYRUN_STAGES), (1, 32, 64, 3)),
           ("broken", boom, (1, 32, 64, 3))]
    lines = bench_zoo.run("cpu", torch.float32, zoo=zoo, warmup=1, timed=2)
    keys = next(n for n in ast.walk(jax_function("bench_zoo", "main"))
                if isinstance(n, ast.Dict) and len(n.keys) == 5)
    jax_keys = [k.value for k in keys.keys]
    assert list(lines[0])[:5] == jax_keys
    assert lines[0]["shape"] == [1, 32, 64, 3] and lines[0]["ms_per_forward"] > 0
    assert {"p50_ms", "p99_ms"} <= set(lines[0]) and lines[0]["card"] == "cpu"
    assert lines[1] == {"model": "broken", "error": "no such model"}
    assert capsys.readouterr().out.count('{"model"') == 2


# ---------- profile_pipeline_stages ----------

@pytest.fixture(scope="module")
def stage_models():
    """JAX modules, their seeded variables and the port's modules loaded
    with them: the full-depth stack, a dryrun-depth EgoLanes and trunk."""
    spec = jax.ShapeDtypeStruct((1, *NET_HW, 3), jnp.float32)
    jax_mods = {"stack": JStack(ctx_hw=CTX, with_domain=False),
                "lanes": JLanes(ctx_hw=CTX, backbone_stages=je.B0_DRYRUN_STAGES),
                "trunk": je.EfficientNetB0Features(stages=je.B0_DRYRUN_STAGES)}
    variables = {k: seeded_variables(m, spec, seed=40 + i)
                 for i, (k, m) in enumerate(jax_mods.items())}
    port = {"stack": port_with(SharedPerceptionStack(CTX, with_domain=False), variables["stack"]),
            "lanes": port_with(EgoLanesNetwork(CTX, te.B0_DRYRUN_STAGES), variables["lanes"]),
            "trunk": port_with(te.EfficientNetB0Features(te.B0_DRYRUN_STAGES),
                               variables["trunk"])}
    return jax_mods, variables, port


def test_profile_stages_are_the_jax_tools_stages(stage_models):
    jax_mods, v, port = stage_models
    inputs = profile_pipeline_stages.draw_inputs(np.random.default_rng(0), 2, (144, 256),
                                                 NET_HW)
    dev = profile_pipeline_stages.on_device(inputs, "cpu", torch.float32)
    fns = profile_pipeline_stages.stage_functions(port["stack"], port["lanes"], port["trunk"],
                                                  NET_HW, torch.float32)
    assert tuple(fns) == profile_pipeline_stages.STAGES
    with torch.inference_mode():
        for i in range(2):
            frame, x = inputs["frames"][i], inputs["xs"][i].astype(np.float32)
            got = fns["preprocess"][0](dev["frames"][i])
            ref = j_preprocess(jnp.asarray(frame)[None], NET_HW, dtype=jnp.float32)
            np.testing.assert_allclose(from_port(got), np.asarray(ref), atol=1e-5, rtol=0)
            xt = dev["xs"][i]
            ref = jax.jit(jax_mods["trunk"].apply)(v["trunk"], x)[4]
            np.testing.assert_allclose(from_port(fns["backbone"][0](xt)), np.asarray(ref),
                                       atol=ATOL, rtol=RTOL)
            seg, depth, _ = jax.jit(jax_mods["stack"].apply)(v["stack"], x)
            got_seg, got_depth = fns["stack_full"][0](xt)
            np.testing.assert_allclose(from_port(got_seg), np.asarray(seg), atol=ATOL, rtol=RTOL)
            np.testing.assert_allclose(from_port(got_depth), np.asarray(depth), atol=ATOL,
                                       rtol=RTOL)
            ref = jax.jit(jax_mods["lanes"].apply)(v["lanes"], x)
            np.testing.assert_allclose(from_port(fns["egolanes_full"][0](xt)), np.asarray(ref),
                                       atol=ATOL, rtol=RTOL)
            post = inputs["post"][i]
            got = fns["postprocess"][0](dev["post"][i])
            ref = (jpost.argmax_mask(jnp.asarray(post[0])),
                   jpost.depth_minmax_scale(jnp.asarray(post[1])),
                   jpost.threshold_channels(jnp.asarray(post[2])))
            for g, r in zip(got, ref):
                assert g.numpy().dtype == np.asarray(r).dtype
                np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_profile_runs_and_names_the_jax_tools_stages(stage_models, capsys):
    _, _, port = stage_models
    lines = profile_pipeline_stages.run("cpu", torch.float32, frame_hw=(144, 256),
                                        out_hw=NET_HW, models=(port["stack"], port["lanes"],
                                                               port["trunk"]),
                                        warmup=1, timed=2)
    jax_stages = [n.slice.value for n in ast.walk(jax_function("profile_pipeline_stages", "main"))
                  if isinstance(n, ast.Subscript) and isinstance(n.value, ast.Name)
                  and n.value.id == "results" and isinstance(n.ctx, ast.Store)]
    assert [x["stage"] for x in lines] == jax_stages
    for x in lines[:-1]:
        assert set(x) == {"stage", "ms", "p50_ms", "p99_ms", "card"} and x["ms"] > 0
    assert capsys.readouterr().out.count('{"stage"') == 7


def test_profile_inputs_are_the_jax_tools_draws():
    ns = run_jax_statements("profile_pipeline_stages", "main", {"rng", "frame", "x"}, {})
    got = profile_pipeline_stages.draw_inputs(np.random.default_rng(0))
    np.testing.assert_array_equal(got["frames"][0], np.asarray(ns["frame"]))
    assert np.array_equal(got["xs"][0].astype(jnp.bfloat16).view(np.uint16),
                          np.asarray(ns["x"]).view(np.uint16))
    assert len(got["frames"]) == len(got["xs"]) == len(got["post"]) == profile_pipeline_stages.POOL


# ---------- the --int8 recipes ----------

class Jitted:
    """A flax module whose ``apply`` (with mutable intermediates, as JAX's
    calibration calls it once a batch) runs jitted, recording the input of
    every int8 conv in call order (flax ``intercept_methods`` inside the
    jit, returned as outputs)."""

    def __init__(self, module):
        def apply(variables, x):
            calls = []

            def intercept(next_fun, args, kwargs, context):
                m = context.module
                if (isinstance(m, jl.Conv2d) and context.method_name == "__call__"
                        and m.has_variable("params", "w_scale")):
                    calls.append(args[0])
                return next_fun(*args, **kwargs)

            with fnn.intercept_methods(intercept):
                out = module.apply(variables, x, mutable=["intermediates"])
            return out, calls

        self._apply = jax.jit(apply)
        self.inputs = []

    def apply(self, variables, x, mutable):
        assert mutable == ["intermediates"]
        out, calls = self._apply(variables, x)
        self.inputs += [np.asarray(c) for c in calls]
        return out


def jax_calibrated(jitted, variables, batches):
    """JAX's recipe: quantize_variables_for_int8_conv at MIN_CH (jitted),
    then calibrate_int8_activation_scales through ``jitted`` -> the tree,
    the int8 convs' inputs in call order."""
    jitted.inputs = []
    q = jax.jit(lambda v: jq.quantize_variables_for_int8_conv(v, MIN_CH))(variables)
    return jq.calibrate_int8_activation_scales(jitted, q, batches), jitted.inputs


def port_calibrated(recipe, inputs):
    """Runs ``recipe()`` with every Int8Conv2d call fed the next of JAX's
    ``inputs`` (so the activations are JAX's and the scales bit-equal;
    left alone they drift with the floats, ROADMAP "Int8 is chaotic") ->
    the port's own input of each call, NHWC."""
    own = []

    def pre(m, args):
        if isinstance(m, Int8Conv2d):
            own.append(from_port(args[0]))
            return (to_port(inputs[len(own) - 1]).contiguous(memory_format=torch.channels_last),)

    handle = torch.nn.modules.module.register_module_forward_pre_hook(pre)
    try:
        recipe()
    finally:
        handle.remove()
    assert len(own) == len(inputs)
    return own


def jax_scales(variables):
    """{module path: x_scale} of a calibrated JAX tree."""
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(variables["params"]):
        if path[-1].key == "x_scale":
            out[tuple(p.key for p in path[:-1])] = float(leaf)
    return out


def assert_same_recipe(port_model, jax_variables, own, inputs, n_min):
    """The same convs selected, the same scales, and the first int8 conv
    of each calibration batch saw, in the port, JAX's input at the float
    bar: the batches themselves are JAX's."""
    from autoware_vision_pilot_tpu_torch.convert.from_jax import state_dict_to_variables

    got, want = jax_scales(state_dict_to_variables(port_model)), jax_scales(jax_variables)
    n = sum(isinstance(m, Int8Conv2d) for m in port_model.modules())
    assert sorted(got) == sorted(want) and n == len(want) >= n_min
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=str(k))
    per_batch = len(inputs) // 4
    for b in range(4):
        np.testing.assert_allclose(own[b * per_batch], inputs[b * per_batch], atol=ATOL,
                                   rtol=RTOL)


@pytest.fixture(scope="module")
def lanes_recipe():
    """EgoLanes at dryrun depth: its module, jitted apply and seeded
    variables (the two recipes share them)."""
    jnet = JLanes(ctx_hw=CTX, backbone_stages=je.B0_DRYRUN_STAGES)
    v = seeded_variables(jnet, jax.ShapeDtypeStruct((1, *NET_HW, 3), jnp.float32), seed=50)
    return Jitted(jnet), v


def test_fleet_int8_recipe_is_the_jax_tools(lanes_recipe):
    """The calibration inputs are the JAX tool's statements' (320x640, bit
    for bit); the recipe at 64x128, on the same draws at that size, is JAX's."""
    ns = run_jax_statements("bench_fleet", "bench_fleet", {"rngq", "cal"},
                            {"dtype": jnp.float32})
    for got, ref in zip(calibration_batches((320, 640), torch.float32, "cpu"), ns["cal"]):
        np.testing.assert_array_equal(from_port(got), np.asarray(ref))
    jitted, v = lanes_recipe
    rng = np.random.default_rng(7)
    cal = [jnp.asarray(rng.normal(0.0, 1.0, (1, *NET_HW, 3)), jnp.float32) for _ in range(4)]
    ref, inputs = jax_calibrated(jitted, v, cal)
    port = port_with(EgoLanesNetwork(CTX, te.B0_DRYRUN_STAGES), v)
    own = port_calibrated(lambda: bench_fleet.int8_lanes(port, "cpu", torch.float32, MIN_CH,
                                                         NET_HW), inputs)
    assert_same_recipe(port, ref, own, inputs, 10)


def test_app_loop_int8_recipe_is_the_jax_tools(lanes_recipe):
    """The JAX tool's `if int8:` block (tools/bench_app_loop.py) at this
    geometry, f32: its frames, the crop's preprocess, the letterbox."""
    jspeed = JAutoSpeed(variant="n", num_classes=4, img_h=SPEED_HW[0], img_w=SPEED_HW[1])
    jitted_lanes, lanes_v = lanes_recipe
    speed_v = seeded_variables(jspeed, jax.ShapeDtypeStruct((1, *SPEED_HW, 3), jnp.float32),
                               seed=52)
    crng = np.random.default_rng(7)
    frames = [jnp.asarray(crng.integers(0, 255, (*FRAME_HW, 3), dtype=np.uint8))
              for _ in range(4)]
    assert all(np.array_equal(a, np.asarray(b)) for a, b in
               zip(bench_app_loop.calibration_frames(FRAME_HW), frames))
    ref_lanes, lanes_in = jax_calibrated(
        jitted_lanes, lanes_v, [j_preprocess(f[None, CROP_Y:], NET_HW, dtype=jnp.float32)
                                for f in frames])
    ref_speed, speed_in = jax_calibrated(
        Jitted(jspeed), speed_v, [j_letterbox(f[None], SPEED_HW, FRAME_HW, dtype=jnp.float32)[0]
                                  for f in frames])
    lanes = port_with(EgoLanesNetwork(CTX, te.B0_DRYRUN_STAGES), lanes_v)
    speed = port_with(AutoSpeedNetwork("n", 4, *SPEED_HW), speed_v)
    own = port_calibrated(lambda: bench_app_loop.int8_nets(
        lanes, speed, "cpu", torch.float32, MIN_CH, frame_hw=FRAME_HW, crop_y=CROP_Y,
        net_hw=NET_HW, input_hw=SPEED_HW), lanes_in + speed_in)
    assert_same_recipe(lanes, ref_lanes, own[:len(lanes_in)], lanes_in, 10)
    assert_same_recipe(speed, ref_speed, own[len(lanes_in):], speed_in, 10)


# ---------- the JAX tools' numpy draws ----------

def test_app_loop_pools_and_source_are_the_jax_tools():
    ns = run_jax_statements("bench_app_loop", "main", {"pool_seed"}, {})
    for fn in ("make_pool", "make_source"):
        node = jax_function("bench_app_loop", fn)
        exec(compile(ast.Module(body=[node], type_ignores=[]), "bench_app_loop", "exec"), ns)
    for k in range(3):  # pools 1000, 1001, 1002 in the JAX tool's order
        host, dev = ns["make_pool"](2)
        got = bench_app_loop.make_pool(bench_app_loop.POOL_SEED + k, 2)
        assert all(np.array_equal(a, b) for a, b in zip(got, host))
        for mode in ("upload", "preuploaded"):
            ref, port = ns["make_source"](host, dev, mode), bench_app_loop.make_source(got, got, mode)
            for _ in range(3):
                r, p = ref(), port()
                if mode == "preuploaded":
                    assert np.array_equal(r[0], p[0]) and np.array_equal(np.asarray(r[1]), p[1])
                else:
                    assert np.array_equal(r, p)


def test_app_loop_configs_and_flags_are_the_jax_tools():
    node = next(n for n in ast.walk(jax_function("bench_app_loop", "main"))
                if isinstance(n, ast.Assign) and getattr(n.targets[0], "id", "") == "configs")
    assert tuple(tuple(c) for c in ast.literal_eval(node.value)) == bench_app_loop.CONFIGS
    a = bench_app_loop.parser().parse_args(["50", "--int8"])
    assert (a.n_frames, a.int8, a.device) == (50, True, "cuda")
    a = bench_app_loop.parser().parse_args([])
    assert (a.n_frames, a.int8) == (100, False)


def test_fleet_ticks_are_the_jax_tools():
    ns = run_jax_statements("bench_fleet", "bench_fleet", {"rng", "ticks"},
                            {"n_streams": 2, "n_ticks": 3})
    got = bench_fleet.draw_ticks(np.random.default_rng(0), 2, 3)
    assert all(np.array_equal(a, np.asarray(b)) for a, b in zip(got, ns["ticks"]))


def test_train_batches_are_the_jax_tools():
    ns = run_jax_statements("bench_train", "main", {"B", "rng", "batches"},
                            {"args": type("A", (), {"batch": 2})})
    got = bench_train.draw_batches(np.random.default_rng(0), 2)
    for (x, y), (rx, ry) in zip(got, ns["batches"]):
        assert x.dtype == np.asarray(rx).dtype and np.array_equal(x, np.asarray(rx))
        assert y.dtype == np.asarray(ry).dtype and np.array_equal(y, np.asarray(ry))


# ---------- flags, keys and metric names ----------

def jax_flags(name):
    return [(n.args[0].value, {k.arg: ast.literal_eval(k.value) for k in n.keywords
                               if k.arg in ("default", "action")})
            for n in ast.walk(jax_source(name))
            if isinstance(n, ast.Call) and getattr(n.func, "attr", "") == "add_argument"]


@pytest.mark.parametrize("name", ["bench_fleet", "bench_train"])
def test_flags_and_defaults_are_the_jax_tools(name):
    port = __import__(f"autoware_vision_pilot_tpu_torch.tools.{name}", fromlist=["parser"])
    defaults = vars(port.parser().parse_args([]))
    flags = jax_flags(name)
    assert flags
    for flag, kw in flags:
        dest = flag.lstrip("-")
        assert defaults[dest] == kw.get("default", False if kw.get("action") else None)
    assert defaults["device"] == "cuda"


def test_fleet_metric_names_are_the_jax_tools(monkeypatch, capsys):
    """The JAX tool's main with its bench_fleet stubbed prints its lines; the
    port's names and keys for the same flags are the same."""
    monkeypatch.setattr(j_fleet, "bench_fleet", lambda n, *a, **k: 10.0 * n)
    argv = ["--streams", "1,3", "--int8", "--pad_to", "4"]
    monkeypatch.setattr(sys, "argv", ["bench_fleet.py", *argv])
    j_fleet.main()
    ref = [json.loads(line) for line in capsys.readouterr().out.splitlines()
           if line.startswith("{")]
    monkeypatch.setattr(bench_fleet, "bench_fleet", lambda nets, ticks, **k: {
        "fps": 10.0 * len(ticks[0]), "tick_ms": [1.0, 2.0]})
    monkeypatch.setattr(bench_fleet, "draw_ticks", lambda rng, n, t, hw: [np.zeros((n, 1))])
    got = bench_fleet.run([1, 3], 60, True, 4, "cpu", torch.float32, nets=(None, None))
    assert [x["metric"] for x in got] == [x["metric"] for x in ref]
    for g, r in zip(got, ref):
        assert {k: g[k] for k in r} == r
        assert {"p50_ms", "p99_ms", "card"} <= set(g)


def test_train_keys_are_the_jax_tools():
    node = next(n for n in ast.walk(jax_source("bench_train")) if isinstance(n, ast.Dict)
                and any(getattr(k, "value", None) == "metric" for k in n.keys))
    keys = [k.value for k in node.keys]
    metric = node.values[0].value
    line = bench_train.run(2, 1, 2, "cpu",
                           make_model=lambda: SceneSegNetwork((1, 2), te.B0_DRYRUN_STAGES),
                           hw=(32, 64), warmup=0, compute_dtype=torch.float32)
    assert list(line)[:len(keys)] == keys and line["metric"] == metric
    assert line["batch"] == 2 and line["microbatches"] == 2 and line["world"] == 1
    assert np.isfinite(line["final_loss"]) and line["value"] > 0 and line["card"] == "cpu"


# ---------- the loops at a small size ----------

@pytest.fixture(scope="module")
def loop_nets():
    lat = build_lateral_pipeline("cpu", torch.float32, frame_hw=(120, 200), crop_y=20,
                                 net_hw=(96, 192), backbone_stages=te.B0_DRYRUN_STAGES)
    lon = build_longitudinal_pipeline("cpu", torch.float32, frame_hw=(120, 200),
                                      input_hw=(128, 128))
    return lat, lon


def test_app_loop_runs(loop_nets, capsys):
    configs = (bench_app_loop.CONFIGS[0][:3] + ((1, 2),), bench_app_loop.CONFIGS[2][:3] + ((1,),))
    lines = bench_app_loop.run(2, nets=loop_nets, device="cpu", dtype=torch.float32,
                               frame_hw=(120, 200), configs=configs, warm_frames=1)
    assert [(x["config"], x["depth"]) for x in lines] == [
        ("upload   +tracking", 1), ("upload   +tracking", 2), ("preupload no-track", 1)]
    for x in lines:
        assert x["frames"] == 2 and x["fps"] > 0 and x["host_p50_ms"] > 0
        assert x["card"] == "cpu" and not x["int8"]
    assert capsys.readouterr().out.count('{"config"') == 3


def test_fleet_runs(loop_nets):
    lat, _ = loop_nets
    lines = bench_fleet.run([2], 1, device="cpu", dtype=torch.float32,
                            nets=(lat.lanes, lat.steer_net), frame_hw=(120, 200), crop_y=20,
                            net_hw=(96, 192))
    assert [x["metric"] for x in lines] == ["fleet_lateral_2streams_aggregate_fps"]
    assert all(x["value"] > 0 and x["p50_ms"] > 0 for x in lines)


@pytest.mark.parametrize("name", TOOLS)
def test_tools_refuse_a_missing_card(name, monkeypatch):
    port = __import__(f"autoware_vision_pilot_tpu_torch.tools.{name}", fromlist=["main"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        port.main(["--device", "cuda"])


def test_bench_tools_import_without_jax():
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


# ---------- the port's container ----------

def test_dockerfile_copies_what_exists_and_the_entry_point_answers_help():
    from autoware_vision_pilot_tpu_torch import app

    dockerfile = ROOT / "autoware_vision_pilot_tpu_torch" / "docker" / "Dockerfile"
    lines = [line.split() for line in dockerfile.read_text().splitlines()]
    copies = [words[1:-1] for words in lines if words and words[0] == "COPY"]
    assert copies
    for sources in copies:
        for src in sources:
            assert (ROOT / src).exists(), src
    entry = next(words for words in lines if words and words[0] == "ENTRYPOINT")
    assert " ".join(entry[1:]) == '["python", "-m", "autoware_vision_pilot_tpu_torch.app"]'
    with pytest.raises(SystemExit) as e:
        app.main(["--help"])
    assert e.value.code == 0
