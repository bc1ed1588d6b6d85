"""The detection loss (autoware_vision_pilot_tpu_torch/train/detection_loss.py)
and AutoSpeed's train-mode output against the JAX package's, on the CPU in
f32 at atol 2e-4, rtol 1e-3.

The maps are AutoSpeed "n"'s train-mode head outputs at 64x128 (A = 168
anchors), batch 2, from JAX's net on numpy-seeded weights; the port's net
on the same weights gives the same maps and the same BatchNorm statistics.
Each function of the loss (``ciou``, ``plain_iou_pairs``,
``task_aligned_assign``, ``df_loss``) is held to JAX's on the same inputs,
then the loss and its gradient with respect to the maps. The targets are
12 boxes an image (4 of them padding) in normalized cx, cy, w, h.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from autoware_vision_pilot_tpu.models import auto_speed as jas
from autoware_vision_pilot_tpu.train import detection_loss as jdl
from autoware_vision_pilot_tpu_torch.convert.from_jax import variables_to_state_dict
from autoware_vision_pilot_tpu_torch.models import auto_speed as tas
from autoware_vision_pilot_tpu_torch.train import detection_loss as tdl

from test_torch_layers import ATOL, RTOL, seeded_variables, to_port
from test_torch_train_step import one_thread  # noqa: F401

HW, BATCH, M = (64, 128), 2, 12


def targets(seed=0, batch=BATCH, m=M, valid=8):
    """Normalized xywh boxes (B, M, 4), labels (B, M), mask (B, M): ``valid``
    real boxes an image, the rest padding."""
    rng = np.random.default_rng(seed)
    wh = rng.uniform(0.05, 0.5, (batch, m, 2))
    cxy = rng.uniform(0.0, 1.0, (batch, m, 2)) * (1 - wh) + wh / 2
    boxes = np.concatenate([cxy, wh], -1).astype(np.float32)
    labels = rng.integers(0, 4, (batch, m)).astype(np.int32)
    mask = np.zeros((batch, m), bool)
    mask[:, :valid] = True
    return boxes, labels, mask


@pytest.fixture(scope="module")
def maps():
    """JAX's and the port's train-mode maps and batch stats on one input."""
    jnet = jas.AutoSpeedNetwork("n", 4, *HW, precision=lax.Precision.HIGHEST)
    v = seeded_variables(jnet, jnp.zeros((1, *HW, 3)), seed=7)
    x = np.random.default_rng(1).uniform(0, 1, (BATCH, *HW, 3)).astype(np.float32)
    outs, mut = jax.jit(lambda v, x: jnet.apply(v, x, train=True, mutable=["batch_stats"]))(v, x)
    net = tas.AutoSpeedNetwork("n", 4, *HW)
    net.load_state_dict(variables_to_state_dict(v, net))
    net.train()
    with torch.no_grad():
        got = net(to_port(x))
    want_stats = variables_to_state_dict({"params": v["params"],
                                         "batch_stats": mut["batch_stats"]}, net)
    return [np.asarray(o) for o in outs], [g.numpy() for g in got], want_stats, net.state_dict()


def test_autospeed_train_mode_gives_raw_maps(maps):
    want, got, want_stats, got_stats = maps
    assert [g.shape for g in got] == [(BATCH, 8, 16, 68), (BATCH, 4, 8, 68), (BATCH, 2, 4, 68)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL)
    stats = [k for k in want_stats if k.endswith(("running_mean", "running_var"))]
    assert stats
    for k in stats:
        np.testing.assert_allclose(got_stats[k].numpy(), want_stats[k].numpy(), atol=ATOL,
                                   rtol=RTOL, err_msg=k)


def test_autospeed_eval_mode_still_decodes():
    net = tas.AutoSpeedNetwork("n", 4, *HW)
    from autoware_vision_pilot_tpu_torch.nn.layers import init_seeded
    init_seeded(net, torch.Generator().manual_seed(0)).eval()
    with torch.no_grad():
        out = net(torch.rand(1, 3, *HW))
    assert out.shape == (1, 168, 8)


def flat_inputs(maps_np):
    """The assigner's inputs from the maps as JAX's loss builds them."""
    outs = [jnp.asarray(m) for m in maps_np]
    flat = jnp.concatenate([o.reshape(BATCH, -1, 68) for o in outs], 1)
    anc, strd = jas.make_anchors([(o.shape[1], o.shape[2]) for o in outs], (8, 16, 32),
                                 flat.dtype)
    from autoware_vision_pilot_tpu.models.yolo_layers import dfl_decode
    d = dfl_decode(flat[..., :64], 16)
    pd = jnp.concatenate([anc[None] - d[..., :2], anc[None] + d[..., 2:]], -1)
    boxes, labels, mask = targets()
    g = boxes * np.array([HW[1], HW[0], HW[1], HW[0]], np.float32)
    gt = np.stack([g[..., 0] - g[..., 2] / 2, g[..., 1] - g[..., 3] / 2,
                   g[..., 0] + g[..., 2] / 2, g[..., 1] + g[..., 3] / 2], -1) * mask[..., None]
    return (np.asarray(jax.nn.sigmoid(flat[..., 64:])), np.asarray(pd * strd[None]),
            np.asarray(anc * strd), labels, gt.astype(np.float32), mask, np.asarray(pd))


@pytest.mark.parametrize("fn", ["ciou", "plain_iou_pairs", "df_loss"])
def test_loss_parts_match_jax(fn):
    rng = np.random.default_rng(3)
    xy = rng.uniform(0, 100, (2, 50, 2))
    a = np.concatenate([xy, xy + rng.uniform(0.5, 40, (2, 50, 2))], -1).astype(np.float32)
    b = np.concatenate([xy + rng.normal(0, 5, (2, 50, 2)),
                        xy + rng.uniform(0.5, 40, (2, 50, 2))], -1).astype(np.float32)
    if fn == "df_loss":
        dist = rng.normal(0, 2, (2, 50, 4, 16)).astype(np.float32)
        t = rng.uniform(0, 14.99, (2, 50, 4)).astype(np.float32)
        want = jdl.df_loss(jnp.asarray(dist), jnp.asarray(t), 15)
        got = tdl.df_loss(torch.from_numpy(dist), torch.from_numpy(t), 15)
    else:
        want = getattr(jdl, fn)(jnp.asarray(a), jnp.asarray(b))
        got = getattr(tdl, fn)(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_ciou_alpha_is_detached():
    """JAX stops the gradient at alpha: the gradient of the CIoU equals that
    of the same expression with alpha a constant."""
    rng = np.random.default_rng(4)
    xy = rng.uniform(0, 50, (20, 2))
    a = np.concatenate([xy, xy + rng.uniform(1, 30, (20, 2))], -1).astype(np.float32)
    b = np.concatenate([xy + 3, xy + rng.uniform(1, 30, (20, 2))], -1).astype(np.float32)
    want = jax.grad(lambda p: jdl.ciou(p, jnp.asarray(b)).sum())(jnp.asarray(a))
    p = torch.from_numpy(a).requires_grad_(True)
    tdl.ciou(p, torch.from_numpy(b)).sum().backward()
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_assigner_matches_jax(maps):
    scores, pd, anc, labels, gt, mask, _ = flat_inputs(maps[0])
    want = jdl.task_aligned_assign(jnp.asarray(scores), jnp.asarray(pd), jnp.asarray(anc),
                                   jnp.asarray(labels), jnp.asarray(gt), jnp.asarray(mask), nc=4)
    got = tdl.task_aligned_assign(*(torch.from_numpy(a) for a in (scores, pd, anc, labels, gt,
                                                                   mask)), nc=4)
    assert int(np.asarray(want[2]).sum()) > 0, "no foreground anchor: the test sees nothing"
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=RTOL)


def test_assigner_breaks_ties_as_jax():
    """Equal alignments: lax.top_k's lower index first, the stable sort's too."""
    A, anc = 40, np.stack([np.arange(40) % 8 * 8 + 4, np.arange(40) // 8 * 8 + 4], -1)
    scores = np.full((1, A, 2), 0.5, np.float32)
    pd = np.tile(np.array([[0, 0, 64, 40]], np.float32), (1, A, 1))
    gt = np.array([[[0, 0, 64, 40]]], np.float32)
    args = (scores, pd, anc.astype(np.float32), np.zeros((1, 1), np.int32), gt,
            np.ones((1, 1), bool))
    want = jdl.task_aligned_assign(*(jnp.asarray(a) for a in args), nc=2)
    got = tdl.task_aligned_assign(*(torch.from_numpy(a) for a in args), nc=2)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert int(got[2].sum()) == 10


def test_detection_loss_and_gradient_match_jax(maps):
    boxes, labels, mask = targets()
    outs = maps[0]

    def jloss(o):
        return jdl.detection_loss(o, jnp.asarray(boxes), jnp.asarray(labels), jnp.asarray(mask))

    (jtotal, jparts), jgrad = jax.value_and_grad(jloss, has_aux=True)(
        [jnp.asarray(o) for o in outs])
    touts = [torch.from_numpy(o).requires_grad_(True) for o in outs]
    total, parts = tdl.detection_loss(touts, torch.from_numpy(boxes), torch.from_numpy(labels),
                                      torch.from_numpy(mask))
    total.backward()
    assert float(jparts["box"]) > 0 and float(jparts["dfl"]) > 0
    np.testing.assert_allclose(float(total), float(jtotal), atol=ATOL, rtol=RTOL)
    for k in ("box", "cls", "dfl"):
        np.testing.assert_allclose(float(parts[k]), float(jparts[k]), atol=ATOL, rtol=RTOL)
    for t, g in zip(touts, jgrad):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=ATOL, rtol=RTOL)


def test_train_step_after_an_inference_mode_forward():
    """The decode's constant tables are kept per device: made first under
    torch.inference_mode (a serving forward), they must still enter a
    train step's autograd graph in the same process."""
    from autoware_vision_pilot_tpu_torch.models import yolo_layers
    from autoware_vision_pilot_tpu_torch.nn.layers import init_seeded

    yolo_layers._bins.cache_clear()
    tas.device_anchors.cache_clear()
    net = init_seeded(tas.AutoSpeedNetwork("n", 4, *HW), torch.Generator().manual_seed(1))
    with torch.inference_mode():
        net.eval()(torch.rand(1, 3, *HW))
    net.train()
    for p in net.parameters():
        p.requires_grad_(True)
    boxes, labels, mask = targets()
    with torch.no_grad():
        x = torch.rand(BATCH, 3, *HW)
    total, _ = tdl.detection_loss(net(x), torch.from_numpy(boxes), torch.from_numpy(labels),
                                  torch.from_numpy(mask))
    total.backward()
    assert all(p.grad is not None for p in net.head.parameters())
