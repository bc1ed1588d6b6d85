"""The port's export and benchmarking utilities against the JAX package's:
export/stablehlo_export.py (torch.export programs in place of StableHLO),
export/benchmark_models.py and utils/benchmark.py, on the CPU at small
sizes. The avp operators and an exported program on the card are in
tests/test_torch_cuda.py."""
from __future__ import annotations

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import flax.linen as fnn

from autoware_vision_pilot_tpu.export import benchmark_models as jbm
from autoware_vision_pilot_tpu.export import stablehlo_export as jexp
from autoware_vision_pilot_tpu.utils import benchmark as jbench

from autoware_vision_pilot_tpu_torch.convert.from_jax import variables_to_state_dict
from autoware_vision_pilot_tpu_torch.export import benchmark_models as tbm
from autoware_vision_pilot_tpu_torch.export import stablehlo_export as texp
from autoware_vision_pilot_tpu_torch.export.quantize import quantize_for_int8_conv
from autoware_vision_pilot_tpu_torch.models.efficientnet import B0_DRYRUN_STAGES
from autoware_vision_pilot_tpu_torch.models.scene_seg import SceneSegNetwork
from autoware_vision_pilot_tpu_torch.nn.layers import Conv2d, Int8Conv2d, init_seeded
from autoware_vision_pilot_tpu_torch.utils import benchmark as tbench

from test_torch_train_step import one_thread  # noqa: F401 (an autouse fixture)


class Tiny(fnn.Module):
    """tests/test_export.py's net."""

    @fnn.compact
    def __call__(self, x, train=False):
        h = fnn.Conv(8, (3, 3), padding=1)(x)
        return fnn.Conv(2, (1, 1))(fnn.relu(h))


class TorchTiny(torch.nn.Module):
    """Tiny in the port's layers, its modules named as flax names them."""

    def __init__(self):
        super().__init__()
        self.Conv_0 = Conv2d(3, 8, 3, 1, 1)
        self.Conv_1 = Conv2d(8, 2, 1)

    def forward(self, x):
        return self.Conv_1(torch.relu(self.Conv_0(x)))


def tiny_pair(seed):
    """JAX's Tiny and its variables; the port's, with the same weights
    through convert/from_jax.py (flax's core Conv names its kernel
    ``kernel``, the JAX package's own layers ``w``: the same HWIO array)."""
    m = Tiny()
    v = m.init(jax.random.key(seed), jnp.zeros((1, 8, 8, 3)))
    params = {name: {"w" if k == "kernel" else "b": np.asarray(a) for k, a in leaf.items()}
              for name, leaf in v["params"].items()}
    t = TorchTiny()
    t.load_state_dict(variables_to_state_dict({"params": params}, t), strict=True)
    return m, v, t.eval()


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def test_export_shapes_are_jax_s_in_nchw():
    assert texp.EXPORT_SHAPES.keys() == jexp.EXPORT_SHAPES.keys()
    for name, (n, h, w, c) in jexp.EXPORT_SHAPES.items():
        assert texp.EXPORT_SHAPES[name] == (n, c, h, w)


def test_stablehlo_roundtrip_against_jax(tmp_path):
    """tests/test_export.py::test_stablehlo_roundtrip's net through both
    packages' export_stablehlo / load_stablehlo: the loaded programs agree."""
    m, v, t = tiny_pair(3)
    p = jexp.export_stablehlo(lambda x: m.apply(v, x), (jnp.zeros((1, 8, 8, 3)),),
                              tmp_path / "tiny.stablehlo")
    x = np.random.default_rng(1).normal(size=(1, 8, 8, 3)).astype(np.float32)
    ref = jexp.load_stablehlo(p)(jnp.asarray(x))
    ref = np.asarray(ref[0] if isinstance(ref, (tuple, list)) else ref).reshape(1, 8, 8, 2)

    path = texp.export_stablehlo(t, (torch.zeros((1, 3, 8, 8)),), tmp_path / "tiny.pt2")
    assert path.exists() and path.stat().st_size > 0
    out = texp.load_stablehlo(path)(nchw(x))
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), ref, atol=1e-5, rtol=0)
    # a plain callable is wrapped in a module of its own
    path = texp.export_stablehlo(lambda x: t(x) * 2, (torch.zeros((1, 3, 8, 8)),),
                                 tmp_path / "fn.pt2")
    assert torch.equal(texp.load_stablehlo(path)(nchw(x)), t(nchw(x)) * 2)


def test_export_model_is_bit_equal_to_eager(tmp_path):
    net = SceneSegNetwork((10, 20), B0_DRYRUN_STAGES)
    init_seeded(net, torch.Generator().manual_seed(0)).eval()
    path = texp.export_model(net, "SceneSeg", tmp_path, dtype=torch.float32)
    assert path == tmp_path / "SceneSeg.pt2"
    prog = texp.load_stablehlo(path)
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=texp.EXPORT_SHAPES["SceneSeg"]).astype(np.float32))
    with torch.no_grad():
        assert torch.equal(prog(x), net(x))


def test_int8_exports_its_plain_versions_on_the_cpu(tmp_path):
    """On the CPU an Int8Conv2d runs its plain versions, which export; on
    the card it raises (tests/test_torch_cuda.py)."""
    torch.manual_seed(0)
    net = torch.nn.Sequential(Conv2d(32, 16, 3, 1, 1), torch.nn.ReLU(), Conv2d(16, 32, 1))
    init_seeded(net, torch.Generator().manual_seed(1))
    q = quantize_for_int8_conv(net, min_channels=16,
                               act_scales={"0": torch.tensor(0.03), "2": torch.tensor(0.02)})
    assert sum(isinstance(m, Int8Conv2d) for m in q.modules()) == 2
    x = torch.randn((1, 32, 6, 10))
    path = texp.export_stablehlo(q, (x,), tmp_path / "int8.pt2")
    with torch.no_grad():
        assert torch.equal(texp.load_stablehlo(path)(x), q(x))


def stats_arrays():
    """Values on a grid of 1/16: every sum exact in f32, so the two
    packages' reductions, which add in other orders, agree to the bit."""
    rng = np.random.default_rng(4)
    return [(np.round(rng.normal(size=(3, 5)) * 16) / 16).astype(np.float32),
            (rng.integers(-8, 9, (2, 3, 4)) / 4).astype(np.float32),
            (np.arange(-3, 4) / 4).astype(np.float32)]


@pytest.mark.parametrize("i", range(3))
def test_tensor_stats_and_compare_tensors_match_jax(i, capsys):
    a = stats_arrays()[i]
    b = a + np.float32(0.25) * (np.arange(a.size).reshape(a.shape) % 3 == 0)
    s = tbench.tensor_stats("x", torch.from_numpy(a))
    assert s == jbench.tensor_stats("x", jnp.asarray(a))
    assert tbench.compare_tensors(torch.from_numpy(a), torch.from_numpy(b), "ab") == \
        jbench.compare_tensors(jnp.asarray(a), jnp.asarray(b), "ab")
    assert tbench.compare_tensors(a, a, "same") == jbench.compare_tensors(a, a, "same") == 0.0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == lines[1] and lines[2] == lines[3] and lines[4] == lines[5]
    assert "IDENTICAL" in lines[4]


def test_agreement_matches_jax():
    rng = np.random.default_rng(5)
    ref = rng.normal(size=(1, 6, 10, 3)).astype(np.float32)
    out = ref + rng.normal(scale=0.3, size=ref.shape).astype(np.float32)
    for seg in (True, False):
        assert tbm._agreement(ref, out, seg) == jbm._agreement(ref, out, seg)
    dense = ref[..., :1]  # one channel: a dense output even when seg
    assert tbm._agreement(dense, out[..., :1], True) == jbm._agreement(dense, out[..., :1], True)
    assert set(tbm._agreement(ref, out, True)) == {"miou_vs_f32"}


def test_compare_precisions_returns_jax_s_keys():
    m, v, t = tiny_pair(0)
    jres = jbm.compare_precisions(m, v, (1, 8, 8, 3), runs=2, name="tiny")
    tres = tbm.compare_precisions(t, (1, 3, 8, 8), runs=2, name="tiny", device="cpu")
    assert {k: set(d) for k, d in tres.items()} == {k: set(d) for k, d in jres.items()}
    assert all(d["runs"] == 2 and d["ms_per_iter"] > 0 for d in tres.values())
    assert 0.0 <= tres["int8"]["miou_vs_f32"] <= 1.0


def test_benchmark_times_the_calls():
    calls = []
    res = tbench.benchmark(lambda x: calls.append(x), torch.zeros(1), warmup=3, runs=5)
    assert len(calls) == 8 and res["runs"] == 5 and res["ms_per_iter"] > 0 and res["fps"] > 0


def test_flops_estimate_of_one_conv():
    n, c, o, k, h, w = 2, 5, 7, 3, 9, 11
    conv = Conv2d(c, o, k, 1, 0)
    flops = tbench.flops_estimate(conv, torch.zeros((n, c, h, w)))
    assert flops == 2 * n * (h - k + 1) * (w - k + 1) * o * c * k * k
    assert tbench.flops_estimate(conv, torch.zeros((n, c + 1, h, w))) is None
