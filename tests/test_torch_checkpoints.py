"""The port's msgpack weight reader (export/checkpoints.py::load_msgpack,
which needs no JAX, flax or msgpack package) against the JAX package's
writer (export/checkpoints.py::save_msgpack, flax.serialization.to_bytes).

The JAX package writes the variables of EgoLanes, temporal AutoSteer and
AutoSpeed "n" (EgoLanes at dryrun depth, AutoSpeed at a 64x64 input; the
values from numpy seeds) in f32 and in bf16. Every comparison is exact:
the reader must return the same bits, and a port network loaded from the
file must hold the same parameters as one loaded by convert/from_jax.py
from the variables in memory.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from autoware_vision_pilot_tpu.export.checkpoints import save_msgpack
from autoware_vision_pilot_tpu.models.auto_speed import AutoSpeedNetwork as JSpeed
from autoware_vision_pilot_tpu.models.auto_steer_temporal import AutoSteerTemporalNet as JSteer
from autoware_vision_pilot_tpu.models.efficientnet import B0_DRYRUN_STAGES as J_DRYRUN
from autoware_vision_pilot_tpu.models.ego_lanes import EgoLanesNetwork as JLanes

from autoware_vision_pilot_tpu_torch.app import _load_model_vars
from autoware_vision_pilot_tpu_torch.convert.from_jax import variables_to_state_dict
from autoware_vision_pilot_tpu_torch.export.checkpoints import load_msgpack, unpackb
from autoware_vision_pilot_tpu_torch.models.auto_speed import AutoSpeedNetwork
from autoware_vision_pilot_tpu_torch.models.auto_steer_temporal import AutoSteerTemporalNet
from autoware_vision_pilot_tpu_torch.models.efficientnet import B0_DRYRUN_STAGES
from autoware_vision_pilot_tpu_torch.models.ego_lanes import EgoLanesNetwork
from autoware_vision_pilot_tpu_torch.runtime.config import Config, ModelConfig

from test_torch_layers import seeded_variables
from test_torch_train_step import one_thread  # noqa: F401 (an autouse fixture)

NETS = {
    "egolanes": (lambda: JLanes(ctx_hw=(2, 4), backbone_stages=J_DRYRUN), (1, 64, 128, 3),
                 lambda: EgoLanesNetwork((2, 4), B0_DRYRUN_STAGES)),
    "autosteer": (lambda: JSteer(), (1, 16, 32, 6), lambda: AutoSteerTemporalNet((16, 32))),
    "autospeed": (lambda: JSpeed(variant="n", num_classes=4, img_h=64, img_w=64),
                  (1, 64, 64, 3), lambda: AutoSpeedNetwork("n", 4, 64, 64)),
}
DTYPES = {"f32": jnp.float32, "bf16": jnp.bfloat16}


@pytest.fixture(scope="module", params=list(NETS))
def net_vars(request):
    jnet, shape, port = NETS[request.param]
    v = seeded_variables(jnet(), jax.ShapeDtypeStruct(shape, jnp.float32), seed=40)
    return request.param, v, port


def leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def bits(a):
    """The bytes of a leaf, numpy or torch (bf16 as its uint16 words)."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy().tobytes() if a.dtype == torch.bfloat16 else \
            a.numpy().tobytes()
    return np.asarray(a).tobytes()


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_load_msgpack_returns_jax_bits(net_vars, dtype, tmp_path):
    name, v, port = net_vars
    v = jax.tree.map(lambda x: jnp.asarray(x).astype(DTYPES[dtype]), v)
    path = tmp_path / f"{name}.msgpack"
    save_msgpack(path, v)
    got = leaves(load_msgpack(path))
    ref = leaves(jax.tree.map(np.asarray, serialization.to_state_dict(v)))
    assert got.keys() == ref.keys()
    for k in ref:
        a, b = got[k], ref[k]
        if dtype == "bf16":
            assert isinstance(a, torch.Tensor) and a.dtype == torch.bfloat16, k
        else:
            assert isinstance(a, np.ndarray) and a.dtype == b.dtype, k
        assert tuple(a.shape) == b.shape and bits(a) == bits(b), k

    # a port network loaded from the file holds what from_jax puts in it
    # from the variables in memory
    from_file, in_memory = port(), port()
    from_file.load_state_dict(variables_to_state_dict(load_msgpack(path), from_file))
    in_memory.load_state_dict(variables_to_state_dict(jax.tree.map(np.asarray, v), in_memory))
    a, b = from_file.state_dict(), in_memory.state_dict()
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def test_app_loads_the_configured_weights(net_vars, tmp_path, capsys):
    """app.py::_load_model_vars: the file's weights when cfg.models[name]
    .path exists, else the seeded init and the JAX package's warning."""
    name, v, port = net_vars
    path = tmp_path / f"{name}.msgpack"
    save_msgpack(path, v)
    cfg = Config()
    cfg.models[name] = ModelConfig(path=str(path))
    loaded = _load_model_vars(cfg, name, port(), torch.Generator().manual_seed(0))
    ref = port()
    ref.load_state_dict(variables_to_state_dict(jax.tree.map(np.asarray, v), ref))
    for k, t in ref.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], t), k
    assert "WARNING" not in capsys.readouterr().out
    cfg.models[name].path = str(tmp_path / "missing.msgpack")
    seeded = _load_model_vars(cfg, name, port(), torch.Generator().manual_seed(0))
    assert f"[app] WARNING: no weights for {name} ({tmp_path / 'missing.msgpack'}) — random " \
           "init" in capsys.readouterr().out
    assert any(not torch.equal(seeded.state_dict()[k], t) for k, t in ref.state_dict().items())


def test_chunked_leaves_are_joined(monkeypatch, tmp_path):
    """A leaf above flax's chunk size is written as a map of flat chunks
    (serialization.py:324, :356-379); the reader joins it again, in f32 and
    bf16. The chunk size is cut to 256 bytes so that small leaves split."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 256)
    rng = np.random.default_rng(41)
    tree = {"params": {"big": rng.standard_normal((7, 33)).astype(np.float32),
                       "big16": jnp.asarray(rng.standard_normal((5, 61)), jnp.bfloat16),
                       "small": np.arange(3, dtype=np.int32)}}
    path = tmp_path / "chunked.msgpack"
    save_msgpack(path, tree)
    raw = unpackb(path.read_bytes())
    assert raw["params"]["big"]["__msgpack_chunked_array__"]
    got = load_msgpack(path)["params"]
    np.testing.assert_array_equal(got["big"], tree["params"]["big"])
    assert bits(got["big16"]) == bits(np.asarray(tree["params"]["big16"]))
    np.testing.assert_array_equal(got["small"], tree["params"]["small"])


def test_decoder_takes_flax_scalars_and_refuses_the_rest():
    """numpy scalars (flax ext type 3), ints and floats of every width, nil,
    bools, str and bin round-trip as flax's own reader returns them; a
    complex leaf (ext type 2) and a truncated file raise."""
    tree = {"a": np.float32(2.5), "b": np.int8(-3), "c": jnp.bfloat16(1.5), "d": 70000,
            "e": -70000, "f": 2 ** 40, "g": -(2 ** 40), "h": 1.25, "i": None, "j": True,
            "k": "x" * 300, "m": [1, 2, 3], "n": {"o": np.zeros((0, 3), np.float32)}}
    data = serialization.to_bytes(tree)
    got, ref = unpackb(data), serialization.msgpack_restore(data)
    for k in ref:
        if k == "c":
            assert got[k].dtype == torch.bfloat16 and got[k].float().item() == 1.5
        elif k == "n":
            assert got[k]["o"].shape == (0, 3)
        else:
            assert got[k] == ref[k] and type(got[k]) is type(ref[k]), k
    with pytest.raises(ValueError):
        unpackb(serialization.to_bytes({"z": 1 + 2j}))
    with pytest.raises(ValueError):
        unpackb(data[:-3])
