"""The port's longitudinal program (runtime/pipeline.py::
build_longitudinal_step and the modules under it: the YOLO blocks,
AutoSpeed, letterbox, the YOLO decode and the fixed-shape NMS) against the
JAX package, on the CPU in f32.

Inputs and weights are drawn with numpy from seeds and handed to both
sides. Tolerances, and why:
- the networks and blocks: atol 2e-4, rtol 1e-3 (tests/test_models_parity.py's
  bar); the YOLO nets' activations grow to ~1e2 through CTX and C2PSA, so
  the relative term carries;
- exact: ``make_anchors``, ``upsample2x_nearest``, ``letterbox`` where the
  resize scale is exact (720x1280 -> 640x640 and the test frame 180x320 ->
  128x128, both a factor 2 or 2.5), ``decode_yolo_to_original`` given the
  same ``pred``, the plain NMS against JAX's jitted ``nms_fixed``, and the
  step's packed table against JAX's step run op by op given the same pred;
- ``letterbox`` at 375x1242 -> 640x640: JAX resizes with f32 weights, the
  port with the preprocess kernel's float64 taps; measured 7.1e-5, bar
  twice that;
- the step jitted: XLA rewrites the division by the constant letterbox
  scale as a product with its reciprocal (0.4 -> 2.5 at the test geometry),
  the port divides as JAX's op-by-op step does; boxes within 2 ulps, the
  rest of the table equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from autoware_vision_pilot_tpu.convert.torch_import import flatten_params, import_state_dict
from autoware_vision_pilot_tpu.models import auto_speed as jas
from autoware_vision_pilot_tpu.models import yolo_layers as jyl
from autoware_vision_pilot_tpu.nn.layers import upsample2x_nearest as j_upsample
from autoware_vision_pilot_tpu.ops import postprocess as jpost
from autoware_vision_pilot_tpu.ops.preprocess import letterbox as j_letterbox
from autoware_vision_pilot_tpu.runtime import config as jconfig
from autoware_vision_pilot_tpu.runtime import pipeline as jpipe

from autoware_vision_pilot_tpu_torch.models import auto_speed as tas
from autoware_vision_pilot_tpu_torch.models import yolo_layers as tyl
from autoware_vision_pilot_tpu_torch.nn.layers import init_seeded, upsample2x_nearest
from autoware_vision_pilot_tpu_torch.ops import postprocess as tpost
from autoware_vision_pilot_tpu_torch.ops.kernels import nms_kernel
from autoware_vision_pilot_tpu_torch.ops.kernels.nms_kernel import nms_fixed, nms_greedy
from autoware_vision_pilot_tpu_torch.ops.kernels.preprocess_kernel import fused_letterbox
from autoware_vision_pilot_tpu_torch.ops.preprocess import letterbox, letterbox_geometry
from autoware_vision_pilot_tpu_torch.runtime.pipeline import build_longitudinal_pipeline

from test_torch_cuda import nms_candidates as candidates
from test_torch_layers import (P, assert_close, normal_input, port_with, seeded_variables,
                               to_port)

FRAME_HW, INPUT_HW = (180, 320), (128, 128)  # scale 0.4, pad_y 28
MAX_DET = 64


def t(a):
    return torch.from_numpy(np.array(a))


def run_both(jmod, port, x, seed):
    v = seeded_variables(jmod, x, seed=seed)
    port_with(port, v)
    with torch.no_grad():
        y = port(to_port(x))
    return y, jmod.apply(v, x)


# ---------- layers and blocks ----------

def test_upsample2x_nearest_matches_jax():
    x = normal_input((2, 3, 5, 7), seed=1)
    y = upsample2x_nearest(to_port(x).contiguous(memory_format=torch.channels_last))
    assert_close(y, j_upsample(x), atol=0, rtol=0)
    assert y.is_contiguous(memory_format=torch.channels_last)


def test_yolo_conv_uses_bn_eps_1e3():
    """With running variances near 1e-3 the eps decides the output: 1e-5
    would be 2x off. The port's YoloConv carries eps 1e-3, as flax's."""
    jmod = jyl.YoloConv(16, k=3, s=2, p=1, precision=P)
    x = normal_input((1, 9, 11, 8), seed=2)
    v = seeded_variables(jmod, x, seed=3)
    var = np.random.default_rng(4).uniform(5e-4, 2e-3, 16).astype(np.float32)
    v = {"params": v["params"], "batch_stats": {"norm": {**v["batch_stats"]["norm"], "var": var}}}
    port = port_with(tyl.YoloConv(8, 16, 3, 2, 1), v)
    assert port.norm.eps == tyl.BN_EPS == 1e-3
    with torch.no_grad():
        assert_close(port(to_port(x)), jmod.apply(v, x))


# block name -> (JAX module, port module, NHWC input shape)
BLOCKS = {
    "conv_k3_s2": (jyl.YoloConv(24, k=3, s=2, p=1, precision=P), tyl.YoloConv(16, 24, 3, 2, 1),
                   (1, 10, 12, 16)),
    "conv_depthwise_identity": (jyl.YoloConv(16, k=3, p=1, g=16, act="identity", precision=P),
                                tyl.YoloConv(16, 16, 3, 1, 1, 16, "identity"), (1, 8, 8, 16)),
    "residual": (jyl.Residual(16, precision=P), tyl.Residual(16), (1, 8, 8, 16)),
    "c3k": (jyl.C3K(32, precision=P), tyl.C3K(16, 32), (1, 8, 8, 16)),
    "c3k2": (jyl.C3K2(32, n=1, csp=False, precision=P), tyl.C3K2(48, 32, 1, False),
             (1, 8, 8, 48)),
    "c3k2_csp_n2": (jyl.C3K2(32, n=2, csp=True, precision=P), tyl.C3K2(48, 32, 2, True),
                    (1, 8, 8, 48)),
    "sppf": (jyl.SPPF(32, precision=P), tyl.SPPF(32, 32), (1, 6, 7, 32)),
    "attention": (jyl.Attention(128, 2, precision=P), tyl.Attention(128, 2), (1, 4, 5, 128)),
    "psa_block": (jyl.PSABlock(128, 2, precision=P), tyl.PSABlock(128, 2), (1, 4, 4, 128)),
    "c2psa": (jyl.C2PSA(256, precision=P), tyl.C2PSA(256, 256), (1, 4, 4, 256)),
    "ctx": (jyl.CTX(16, 32, r=2, h=6, w=10, precision=P), tyl.CTX(16, 32, 2, 6, 10),
            (2, 6, 10, 16)),
}


@pytest.mark.parametrize("name", list(BLOCKS))
def test_yolo_block_matches_jax(name):
    jmod, port, shape = BLOCKS[name]
    y, ref = run_both(jmod, port, normal_input(shape, seed=5), seed=6)
    assert y.shape == tuple(np.asarray(ref).shape[i] for i in (0, 3, 1, 2))
    assert_close(y, ref)


def test_ctx_keeps_its_size_assert():
    port = tyl.CTX(8, 8, 2, 4, 4)
    init_seeded(port, torch.Generator().manual_seed(0))
    with pytest.raises(AssertionError, match="CTX configured"):
        port(torch.zeros(1, 8, 4, 5))


def test_dfl_decode_matches_jax():
    x = normal_input((2, 30, 64), seed=7) * 3
    out = tyl.dfl_decode(t(x), 16)
    np.testing.assert_allclose(out.numpy(), np.asarray(jyl.dfl_decode(jnp.asarray(x), 16, P)),
                               atol=1e-5, rtol=1e-6)


def test_make_anchors_matches_jax():
    shapes, strides = ((16, 16), (8, 8), (4, 4)), (8, 16, 32)
    a, s = tas.make_anchors(shapes, strides)
    ja, js = jas.make_anchors(shapes, strides)
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


# ---------- AutoSpeed ----------

@pytest.fixture(scope="module")
def speed_pair():
    """(JAX AutoSpeed "n" for 128x128, its seeded variables, the port's with
    the same weights)."""
    jnet = jas.AutoSpeedNetwork("n", 4, *INPUT_HW, precision=lax.Precision.HIGHEST)
    v = seeded_variables(jnet, jax.ShapeDtypeStruct((1, *INPUT_HW, 3), jnp.float32), seed=8)
    return jnet, v, port_with(tas.AutoSpeedNetwork("n", 4, *INPUT_HW), v)


def test_auto_speed_matches_jax(speed_pair):
    jnet, v, port = speed_pair
    x = np.random.default_rng(9).random((1, *INPUT_HW, 3), dtype=np.float32)
    ref = np.asarray(jax.jit(jnet.apply)(v, x))
    with torch.no_grad():
        y = port(to_port(x)).numpy()
    assert y.shape == ref.shape == (1, 16 * 16 + 8 * 8 + 4 * 4, 8)
    np.testing.assert_allclose(y, ref, atol=2e-4, rtol=1e-3)


def test_auto_speed_weight_bridge_round_trip(speed_pair):
    """JAX variables -> from_jax -> the port's state_dict() -> the JAX
    package's own torch importer (strict) -> the same bits, the CTX's
    Conv1d kernels (``w1``, (3, I, O) <-> (O, I, 3)) included."""
    _, v, port = speed_pair
    sd = {k: a.numpy() for k, a in port.state_dict().items()}
    assert sd["net.p2_1.exp0.weight"].shape == (32 * 32, 32, 3)
    back = import_state_dict(v, sd, strict=True)
    for coll in ("params", "batch_stats"):
        a, b = flatten_params(v[coll]), flatten_params(back[coll])
        assert a.keys() == b.keys()
        for k in a:
            assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k


# ---------- letterbox ----------

# (source, output, bar): exact where the resize factor is exact, else
# twice the measured gap of the resize taps
LETTERBOX_GAP = {((720, 1280), (640, 640)): 0.0, (FRAME_HW, INPUT_HW): 0.0,
                 ((375, 1242), (640, 640)): 1.5e-4}


@pytest.mark.parametrize("src,dst", list(LETTERBOX_GAP))
def test_letterbox_matches_jax(src, dst):
    frame = np.random.default_rng(10).integers(0, 256, (*src, 3), np.uint8)
    ref, jscale, jpad = j_letterbox(jnp.asarray(frame)[None], dst, src)
    out, scale, pad = letterbox(t(frame)[None], dst, src)
    assert (scale, pad) == (jscale, jpad)
    assert out.shape == ref.shape and out.dtype == torch.float32
    gap = np.abs(out.numpy() - np.asarray(ref)).max()
    assert gap <= LETTERBOX_GAP[(src, dst)], gap
    pad_y = pad[1]
    assert (out[0, :pad_y] == np.float32(114) * np.float32(1 / 255)).all()


def test_letterbox_geometry():
    assert letterbox_geometry((640, 640), (720, 1280)) == (0.5, (360, 640), (0, 140))
    assert letterbox_geometry(INPUT_HW, FRAME_HW) == (0.4, (72, 128), (0, 28))
    assert letterbox_geometry((640, 640), (1280, 720)) == (0.5, (640, 360), (140, 0))


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_fused_letterbox_cpu_branch_is_plain_version(out_dtype):
    frame = t(np.random.default_rng(11).integers(0, 256, (2, *FRAME_HW, 3), np.uint8))
    before = fused_letterbox.launches
    x, scale, pad = fused_letterbox(frame, INPUT_HW, out_dtype)
    assert x.shape == (2, 3, *INPUT_HW) and x.dtype == out_dtype
    assert x.is_contiguous(memory_format=torch.channels_last)
    ref, rscale, rpad = letterbox(frame, INPUT_HW, FRAME_HW, dtype=out_dtype)
    assert torch.equal(x.permute(0, 2, 3, 1), ref) and (scale, pad) == (rscale, rpad)
    assert fused_letterbox.launches == before


@pytest.mark.parametrize("hw,kwargs,exc", [((16, 24), {"out_hw": (640, 0)}, ValueError),
                                           ((16, 24), {"out_hw": (64.0, 64)}, ValueError),
                                           ((16, 24), {"out_dtype": torch.float16}, TypeError),
                                           ((100, 10), {"out_hw": (1, 100)}, ValueError)])
def test_fused_letterbox_rejects(hw, kwargs, exc):
    """Bad sizes and types; a frame whose letterbox is 0 pixels wide."""
    frame = t(np.zeros((*hw, 3), np.uint8))
    with pytest.raises(exc):
        fused_letterbox(frame, **{"out_hw": (32, 32), **kwargs})


# ---------- decode and NMS ----------

def test_decode_yolo_to_original_matches_jax():
    """Given the same pred, bit for bit, at the production scale (0.5) and
    the test geometry's (0.4, not a power of two), with ties in the class
    scores (the first maximum) and boxes beyond the frame (clamped)."""
    rng = np.random.default_rng(12)
    pred = np.concatenate([rng.uniform(-50, 700, (500, 2)), rng.uniform(0, 400, (500, 2)),
                           rng.integers(0, 4, (500, 4)) / 4], 1).astype(np.float32)
    for scale, pad, hw in ((0.5, (0, 140), (720, 1280)), (0.4, (0, 28), FRAME_HW)):
        out = tpost.decode_yolo_to_original(t(pred), scale, pad, hw)
        ref = jpost.decode_yolo_to_original(jnp.asarray(pred), scale, pad, hw)
        for a, b in zip(out, ref):
            assert a.dtype == torch.from_numpy(np.asarray(b)).dtype
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


NMS_CASES = [("random", 13, 2000, True), ("random", 14, 8400, True),
             ("random", 15, 2000, False), ("dense", 16, 2000, True),
             ("dense", 17, 2000, False), ("below", 18, 2000, True),
             ("grid", 19, 2000, True), ("ties", 20, 2000, True),
             ("ties", 21, 2000, False), ("random", 22, 100, True),
             ("dense", 23, 40, True)]


@pytest.mark.parametrize("kind,seed,A,class_aware", NMS_CASES)
def test_nms_fixed_matches_jax(kind, seed, A, class_aware):
    """The plain NMS (the wrapper's CPU branch) against JAX's jitted
    nms_fixed, every output bit for bit; A = 100 and 40 < 4 * max_det."""
    boxes, scores, cls = candidates(kind, seed, A)
    kw = dict(max_det=MAX_DET, iou_thresh=0.5, conf_thresh=0.5, class_aware=class_aware)
    before = nms_greedy.launches
    out = nms_fixed(t(boxes), t(scores), t(cls), **kw)
    ref = jpost.nms_fixed(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(cls), **kw)
    assert nms_greedy.launches == before  # the plain version is no launch
    for a, b in zip(out, ref):
        assert a.dtype == torch.from_numpy(np.asarray(b)).dtype
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    n_valid = int(out[3].sum())
    assert out[3][:n_valid].all() and not out[3][n_valid:].any()
    assert (n_valid == 0) == (kind == "below")
    if kind == "grid":
        assert n_valid == MAX_DET


def test_nms_ignores_the_order_of_dropped_candidates():
    """Scores below the threshold become -1 and fill the top-k's tail with
    ties. They are never alive and never written, so their order changes
    nothing."""
    boxes, scores, cls = candidates("random", 24, 2000)
    scores[100:] *= 0.4  # 100 candidates above 0.5 of k = 256
    top = list(tpost.nms_topk(t(boxes), t(scores), t(cls), max_det=MAX_DET, conf_thresh=0.5))
    assert int((top[1] < 0).sum()) > 100
    kw = dict(max_det=MAX_DET, iou_thresh=0.5, conf_thresh=0.5)
    ref = tpost.nms_greedy_plain(*top, **kw)
    tail = torch.nonzero(top[1] < 0)[:, 0]
    perm = torch.arange(len(top[1]))
    perm[tail] = tail[torch.randperm(len(tail), generator=torch.Generator().manual_seed(0))]
    out = tpost.nms_greedy_plain(*(a[perm] for a in top), **kw)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)


def test_nms_greedy_checks_its_input():
    boxes, scores, cls = (t(a) for a in candidates("random", 25, 300))
    top = tpost.nms_topk(boxes, scores, cls)
    with pytest.raises(TypeError):
        nms_greedy(top[0].double(), *top[1:])
    with pytest.raises(TypeError):
        nms_greedy(*top[:2], top[2].long())
    with pytest.raises(ValueError):
        nms_greedy(top[0][:, :3], *top[1:])
    with pytest.raises(ValueError):
        nms_greedy(*top, max_det=0)


@pytest.mark.parametrize("k", [1, 31, 32, 33, 64, 255, 256, 257, 1024])
def test_nms_cluster_size_choice(k):
    """The wrapper's cluster: a block per 32-row word of the suppression
    matrix, at most the 8 blocks of a portable cluster, so that every block
    has rows to build; block 0's shared memory (candidates, then the matrix
    by word, rows padded to 32 plus 4) fits the 227 KB a block may have."""
    cs = nms_kernel.cluster_size(k)
    assert cs == min(8, -(-k // 32)) and 1 <= cs <= nms_kernel.MAX_CLUSTER
    assert all((k - rank + cs - 1) // cs >= 1 for rank in range(cs))
    nw = -(-k // 32)
    assert -(-24 * k // 16) * 16 + nw * (32 * nw + 4) * 4 <= 227 * 1024
    assert k <= nms_kernel.MAX_K


# ---------- the whole step ----------

class GivenPred:
    """A stand-in for AutoSpeedNetwork in the JAX step: ``apply`` returns
    the pred passed as its variables."""

    def __init__(self, **kwargs):
        pass

    def apply(self, pred, x):
        return pred


@pytest.fixture(scope="module")
def step_inputs(speed_pair):
    """Three frames at the test geometry and JAX's pred on each, computed as
    the JAX step computes it (letterbox, then apply), op by op."""
    jnet, v, _ = speed_pair
    frames = np.random.default_rng(26).integers(0, 256, (3, *FRAME_HW, 3), np.uint8)
    preds = []
    for f in frames:
        x, _, _ = j_letterbox(jnp.asarray(f)[None], INPUT_HW, FRAME_HW)
        preds.append(np.asarray(jnet.apply(v, x)))
    return frames, preds


@pytest.fixture(scope="module")
def port_step(speed_pair):
    pipe = build_longitudinal_pipeline("cpu", torch.float32, frame_hw=FRAME_HW,
                                       input_hw=INPUT_HW, max_det=MAX_DET)
    pipe.net.load_state_dict(speed_pair[2].state_dict())
    return pipe


def test_longitudinal_step_matches_jax(speed_pair, step_inputs, port_step):
    """The packed (64, 7) table of the port's step, its network returning
    JAX's pred (a forward hook), against JAX's step given the same pred:
    bit for bit against the step run op by op; against the jitted step
    (XLA multiplies by 1 / 0.4 where both divide), boxes within 2 ulps and
    the rest equal. The port's own pred is within the networks' bar."""
    frames, preds = step_inputs
    cfg = jconfig.Config()

    def given_step(frame, pred):
        return jpipe.build_longitudinal_step(pred, cfg, frame_hw=FRAME_HW, input_hw=INPUT_HW,
                                             dtype=jnp.float32, max_det=MAX_DET)(frame)

    mp = pytest.MonkeyPatch()
    mp.setattr(jpipe, "AutoSpeedNetwork", GivenPred)
    forced, own = {}, {}

    def hook(m, args, y):
        own["pred"] = y
        return forced["pred"]

    handle = port_step.net.register_forward_hook(hook)
    try:
        jitted = jax.jit(given_step)
        n_valid = []
        for frame, pred in zip(frames, preds):
            forced["pred"] = t(pred)
            out = port_step(t(frame)).numpy()
            eager = np.asarray(given_step(jnp.asarray(frame), jnp.asarray(pred)))
            jit = np.asarray(jitted(jnp.asarray(frame), jnp.asarray(pred)))
            assert out.shape == (MAX_DET, 7) and out.dtype == np.float32
            np.testing.assert_array_equal(out, eager)
            np.testing.assert_array_equal(out[:, 4:], jit[:, 4:])
            np.testing.assert_allclose(out[:, :4], jit[:, :4], rtol=2.4e-7, atol=0)
            np.testing.assert_allclose(own["pred"].numpy(), pred, atol=2e-4, rtol=1e-3)
            n_valid.append(int(out[:, 6].sum()))
    finally:
        handle.remove()
        mp.undo()
    assert all(n > 1 for n in n_valid), n_valid
