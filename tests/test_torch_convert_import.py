"""The port's weight importers (convert/torch_import.py, convert/onnx_import.py
over convert/onnx_proto.py) against the JAX package's, and eval_lite's
``--onnx``, on the CPU.

The JAX importers fill flax trees, the port's a module's state_dict; the
JAX result is carried into the port's layout by convert/from_jax.py and
must equal the port's key by key, bit for bit (rtol 0, atol 0): both take
the same numbers from the same file, the JAX side transposing what the
port keeps in torch's layout. The ONNX writer gives the JAX writer's bytes.
The cases are the JAX package's own (tests/test_onnx_import.py): a named
export, a BatchNorm-folded one (identity BN), a TorchScript-style folded
export with mangled names and a fused bias on a bias-free conv, a wrapper
prefix, and ``strict=False``, where both importers return the first
candidate and never try the stripped names.
"""
import json
import pathlib

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from autoware_vision_pilot_tpu.convert import import_state_dict as j_import_sd
from autoware_vision_pilot_tpu.convert import onnx_proto as j_proto
from autoware_vision_pilot_tpu.convert.onnx_import import import_onnx as j_import_onnx
from autoware_vision_pilot_tpu.convert.onnx_import import (
    save_state_dict_as_onnx as j_save)
from autoware_vision_pilot_tpu.export import eval_lite as jeval
from autoware_vision_pilot_tpu.export.checkpoints import save_msgpack
from autoware_vision_pilot_tpu.models.efficientnet import B0_DRYRUN_STAGES as J_DRYRUN
from autoware_vision_pilot_tpu.models.lite import build_lite_model as j_build
from autoware_vision_pilot_tpu.models.scene_seg import SceneSegNetwork as JSceneSeg
from autoware_vision_pilot_tpu.nn import layers as jl
from autoware_vision_pilot_tpu.train.lite_trainer import load_experiment_config
from autoware_vision_pilot_tpu_torch.convert import (
    import_onnx, import_state_dict, load_onnx_state_dict, onnx_proto,
    save_state_dict_as_onnx)
from autoware_vision_pilot_tpu_torch.convert.from_jax import variables_to_state_dict
from autoware_vision_pilot_tpu_torch.convert.onnx_import import _qual_from_node_name
from autoware_vision_pilot_tpu_torch.export import eval_lite as teval
from autoware_vision_pilot_tpu_torch.models.efficientnet import B0_DRYRUN_STAGES
from autoware_vision_pilot_tpu_torch.models.scene_seg import SceneSegNetwork
from autoware_vision_pilot_tpu_torch.nn import layers as tl

from test_torch_eval_lite import ShapeInit
from test_torch_layers import ATOL, RTOL, seeded_variables
from test_torch_train_step import one_thread  # noqa: F401 (an autouse fixture)

CONFIGS = pathlib.Path(__file__).resolve().parents[1] / "configs"
TINY_IO = ((("input", ("batch_size", 3, 16, 32)),), (("output", ("batch_size", 4, 16, 32)),))


def assert_same(port_sd, jax_vars, module):
    want = variables_to_state_dict(jax_vars, module)
    assert set(port_sd) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(port_sd[k].numpy(), v.numpy(), err_msg=k)


def seeded_state_dict(module, seed):
    """A torch-layout state_dict for ``module``: numpy values from a seed."""
    rng = np.random.default_rng(seed)
    return {k: (rng.uniform(0.5, 1.5, v.shape) if k.endswith("running_var")
                else rng.normal(0.0, 0.2, v.shape)).astype(np.float32)
            for k, v in module.state_dict().items()}


@pytest.fixture(scope="module")
def scene_seg():
    """SceneSeg at dryrun depth: the JAX target tree, the port module and a
    reference state_dict for it."""
    jmod = JSceneSeg(ctx_hw=(2, 4), backbone_stages=J_DRYRUN)
    v = seeded_variables(jmod, jax.ShapeDtypeStruct((1, 64, 128, 3), jnp.float32), seed=70)
    port = SceneSegNetwork((2, 4), B0_DRYRUN_STAGES)
    return v, port, seeded_state_dict(port, 71)


def test_torch_import_matches_jax(scene_seg):
    v, port, sd = scene_seg
    got = import_state_dict(port, sd)
    assert_same(got, j_import_sd(v, sd), port)
    port.load_state_dict(got, strict=True)
    # a torch state_dict as tensors, num_batches_tracked beside each BN, a prefix
    wrapped = {f"net.{k}": torch.from_numpy(a) for k, a in sd.items()}
    wrapped["net.Backbone.encoder.0.1.num_batches_tracked"] = torch.tensor(3)
    pm = {"net.": "", "net.Backbone.": "Backbone."}  # the longest prefix first
    assert_same(import_state_dict(port, wrapped, prefix_map=pm),
                j_import_sd(v, {k: t.numpy() for k, t in wrapped.items()}, prefix_map=pm),
                port)


def test_torch_import_strictness_matches_jax(scene_seg):
    v, port, sd = scene_seg
    key = "SceneNeck.upsample_layer_0.weight"
    short = {k: a for k, a in sd.items() if k != key}
    for fn in (lambda s: import_state_dict(port, s), lambda s: j_import_sd(v, s)):
        with pytest.raises(KeyError, match="missing torch weights"):
            fn(short)
        with pytest.raises(KeyError, match="unused torch weights: \\['extra.weight'\\]"):
            fn({**sd, "extra.weight": np.zeros(3, np.float32)})
        with pytest.raises(ValueError, match="shape mismatch"):
            fn({**sd, key: sd[key][:, :-1]})
    with pytest.raises(KeyError, match=key.replace(".", "\\.")):
        import_state_dict(port, short)
    got = import_state_dict(port, short, strict=False)
    targets = port.state_dict()
    assert torch.equal(got[key], targets[key])  # kept: the module's own
    want = variables_to_state_dict(j_import_sd(v, short, strict=False), port)
    for k in got:
        if k != key:
            np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)


def test_onnx_writer_gives_the_jax_writers_bytes(scene_seg, tmp_path):
    _, port, sd = scene_seg
    j_save(sd, tmp_path / "jax.onnx", "SceneSeg", producer="avp")
    save_state_dict_as_onnx(sd, tmp_path / "port.onnx", "SceneSeg", producer="avp")
    save_state_dict_as_onnx({k: torch.from_numpy(a) for k, a in sd.items()},
                            tmp_path / "tensors.onnx", "SceneSeg", producer="avp")
    ref = (tmp_path / "jax.onnx").read_bytes()
    assert (tmp_path / "port.onnx").read_bytes() == ref
    assert (tmp_path / "tensors.onnx").read_bytes() == ref
    m = onnx_proto.load_model(tmp_path / "jax.onnx")
    j = j_proto.load_model(tmp_path / "jax.onnx")
    assert set(m.graph.initializers) == set(j.graph.initializers) == set(sd)
    assert onnx_proto.serialize_model(m) == j_proto.serialize_model(j)


def test_named_onnx_import_matches_jax(scene_seg, tmp_path):
    v, port, sd = scene_seg
    path = tmp_path / "SceneSeg.onnx"
    save_state_dict_as_onnx(sd, path, "SceneSeg")
    got = import_onnx(port, path)
    assert_same(got, j_import_onnx(v, path), port)
    for k, a in sd.items():
        np.testing.assert_array_equal(got[k].numpy(), a, err_msg=k)
    raw = load_onnx_state_dict(path)
    assert set(raw) == set(sd)


class JTiny(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        x = jl.Conv2d(8, 3, padding=1, name="conv1")(x)
        x = jl.silu(jl.BatchNorm2d(name="bn1")(x))
        return jl.Conv2d(4, 1, name="conv2")(x)


class PortTiny(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = tl.Conv2d(3, 8, 3, 1, 1)
        self.bn1 = tl.BatchNorm2d(8)
        self.conv2 = tl.Conv2d(8, 4, 1)

    def forward(self, x):
        return self.conv2(tl.silu(self.bn1(self.conv1(x))))


def tiny():
    v = seeded_variables(JTiny(), jax.ShapeDtypeStruct((1, 16, 32, 3), jnp.float32), seed=72)
    port = PortTiny()
    port.load_state_dict(variables_to_state_dict(v, port))
    return v, port


def test_folded_bn_onnx_import_matches_jax(tmp_path):
    """A BN folded into conv1 (its initializers gone): identity BN on both
    sides; a missing conv still raises on both."""
    v, port = tiny()
    sd = seeded_state_dict(port, 73)
    g = sd["bn1.weight"] / np.sqrt(sd["bn1.running_var"] + 1e-5)
    folded = {"conv1.weight": sd["conv1.weight"] * g[:, None, None, None],
              "conv1.bias": (sd["conv1.bias"] - sd["bn1.running_mean"]) * g + sd["bn1.bias"],
              "conv2.weight": sd["conv2.weight"], "conv2.bias": sd["conv2.bias"]}
    path = tmp_path / "folded.onnx"
    save_state_dict_as_onnx(folded, path, "Tiny", io=TINY_IO)
    got = import_onnx(port, path)
    assert_same(got, j_import_onnx(v, path), port)
    assert float(got["bn1.running_var"][0]) == np.float32(1 - 1e-5)
    assert torch.equal(got["bn1.weight"], torch.ones(8))
    broken = tmp_path / "broken.onnx"
    save_state_dict_as_onnx({k: a for k, a in folded.items() if not k.startswith("conv2")},
                            broken, "Tiny", io=TINY_IO)
    with pytest.raises(KeyError, match="core weights"):
        import_onnx(port, broken)
    with pytest.raises(KeyError):
        j_import_onnx(v, broken)


class JSeq(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        x = jl.Conv2d(8, 3, padding=1, use_bias=False, name="features_0")(x)
        x = jl.silu(jl.BatchNorm2d(name="features_1")(x))
        x = jl.Conv2d(4, 1, use_bias=False, name="features_3")(x)
        return jl.BatchNorm2d(name="features_4")(x)


class _PortSeq(nn.Module):
    def __init__(self):
        super().__init__()
        self.features = nn.Sequential(tl.Conv2d(3, 8, 3, 1, 1, bias=False), tl.BatchNorm2d(8),
                                      nn.SiLU(), tl.Conv2d(8, 4, 1, bias=False),
                                      tl.BatchNorm2d(4))


def test_mangled_folded_export_matches_jax(tmp_path):
    """tests/test_onnx_import.py's TorchScript-style folded export: fused
    weights under 'onnx::Conv_*' names, found again from the Conv nodes'
    scopes, their fused biases routed into the BN after each conv."""
    v = seeded_variables(JSeq(), jax.ShapeDtypeStruct((1, 16, 32, 3), jnp.float32), seed=74)
    port = _PortSeq()
    port.load_state_dict(variables_to_state_dict(v, port))
    rng = np.random.default_rng(75)
    g = j_proto.Graph(name="main_graph")
    for name, shape in [("onnx::Conv_21", (8, 3, 3, 3)), ("onnx::Conv_22", (8,)),
                        ("onnx::Conv_24", (4, 8, 1, 1)), ("onnx::Conv_25", (4,))]:
        g.initializers[name] = j_proto.Tensor.from_numpy(
            name, rng.normal(0, 0.3, shape).astype(np.float32))
    g.inputs.append(j_proto.ValueInfo(name="input", shape=["batch_size", 3, 16, 32]))
    g.outputs.append(j_proto.ValueInfo(name="output", shape=["batch_size", 4, 16, 32]))
    g.nodes += [
        j_proto.Node(op_type="Conv", name="/features/features.0/Conv",
                     inputs=["input", "onnx::Conv_21", "onnx::Conv_22"], outputs=["a"]),
        j_proto.Node(op_type="Conv", name="/features/features.3/Conv",
                     inputs=["a", "onnx::Conv_24", "onnx::Conv_25"], outputs=["output"])]
    path = tmp_path / "seq_folded.onnx"
    j_proto.save_model(j_proto.Model(producer_name="pytorch", graph=g), path)
    got = import_onnx(port, path)
    assert_same(got, j_import_onnx(v, path), port)
    np.testing.assert_array_equal(got["features.1.bias"].numpy(),
                                  g.initializers["onnx::Conv_22"].to_numpy())
    assert _qual_from_node_name("/Backbone/encoder/encoder.0/encoder.0.0/Conv") == \
        "Backbone.encoder.0.0"


def test_wrapper_prefix_and_strict_false_match_jax(tmp_path):
    """Names under a wrapper ('model.'): strict, the stripped candidate is
    taken after the names as they are fail. With strict=False the first
    candidate returns at once, with nothing of the file in it: the JAX
    importer does the same (onnx_import.py:280), and so does the port."""
    v, port = tiny()
    sd = seeded_state_dict(port, 76)
    path = tmp_path / "wrapped.onnx"
    save_state_dict_as_onnx({f"model.{k}": a for k, a in sd.items()}, path, "Tiny", io=TINY_IO)
    got = import_onnx(port, path)
    assert_same(got, j_import_onnx(v, path), port)
    for k, a in sd.items():
        np.testing.assert_array_equal(got[k].numpy(), a, err_msg=k)
    loose = import_onnx(port, path, strict=False)
    assert_same(loose, j_import_onnx(v, path, strict=False), port)
    own = port.state_dict()
    assert all(torch.equal(loose[k], own[k]) for k in own)  # the file was not read


def test_eval_lite_onnx_matches_jax(tmp_path, monkeypatch):
    """eval_lite --onnx on SceneSegLite at 64x128. The file, written by the
    port's writer from seeded weights under the reference's torch names,
    gives the outputs that JAX's CLI gives for the same weights (from a
    msgpack file; within atol 2e-4, rtol 1e-3), and the port's seed-0
    weights written so give its smoke mode's summary.

    JAX's own --onnx cannot place this file's ConvBNReLU BatchNorms
    (``aspp.b0.bn.weight``: its torch importer strips every ``.bn``, the
    JAX BatchNorm2d wrapper's name, and looks for ``aspp.b0.weight``), so
    its folded path sets them to the identity: a reference fault (ROADMAP
    Queue 3), recorded here; the port imports every key."""
    name, hw = "SceneSegLite", (64, 128)
    cfg = load_experiment_config(CONFIGS / f"{name}.yaml")
    v = seeded_variables(j_build(cfg), jax.ShapeDtypeStruct((1, *hw, 3), jnp.float32), seed=77)
    port = teval.build_lite_model(cfg)
    sd = variables_to_state_dict(v, port)
    path = tmp_path / f"{name}.onnx"
    save_state_dict_as_onnx(sd, path, name)
    got_sd = import_onnx(port, path)
    assert all(torch.equal(got_sd[k], t) for k, t in sd.items())
    j_sd = variables_to_state_dict(j_import_onnx(v, path), port)
    assert torch.equal(j_sd["aspp.b0.bn.weight"], torch.ones_like(sd["aspp.b0.bn.weight"]))
    assert not torch.equal(sd["aspp.b0.bn.weight"], j_sd["aspp.b0.bn.weight"])

    msgpack = tmp_path / f"{name}.msgpack"
    save_msgpack(msgpack, v)
    common = ["--config", str(CONFIGS / f"{name}.yaml"), "--synthetic", "2",
              "--height", str(hw[0]), "--width", str(hw[1])]
    jax_outs = []
    monkeypatch.setattr(jeval, "build_lite_model",
                        lambda c, **kw: ShapeInit(j_build(c, **kw), jax_outs))
    want = jeval.main(common + ["--msgpack", str(msgpack)])
    outs = []
    forward_fn = teval.forward_fn

    def spy(model, dtype):
        fwd = forward_fn(model, dtype)
        return lambda x: outs.append(fwd(x)) or outs[-1]

    monkeypatch.setattr(teval, "forward_fn", spy)
    got = teval.main(common + ["--onnx", str(path), "--device", "cpu",
                               "--out", str(tmp_path / "s.json")])
    assert json.loads((tmp_path / "s.json").read_text()) == got
    assert len(outs) == len(jax_outs) == 2
    for a, b in zip(outs, jax_outs):
        np.testing.assert_allclose(a[0].numpy(), b[0], atol=ATOL, rtol=RTOL)
    assert got["task"] == want["task"] == "seg" and got["samples"] == want["samples"] == 2
    monkeypatch.setattr(teval, "forward_fn", forward_fn)
    seeded = tl.init_seeded(teval.build_lite_model(cfg), torch.Generator().manual_seed(0))
    save_state_dict_as_onnx(seeded.state_dict(), tmp_path / "seed0.onnx", name)
    smoke = common + ["--device", "cpu"]
    assert teval.main(smoke + ["--onnx", str(tmp_path / "seed0.onnx")]) == teval.main(smoke)
