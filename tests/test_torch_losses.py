"""The port's training losses and metrics (autoware_vision_pilot_tpu_torch/
train/losses.py, metrics.py, qat.py::distillation_kl) against the JAX
package's, on the CPU in f32: every loss in value and in gradient
(``jax.grad`` against autograd) at atol 2e-4, rtol 1e-3; the numpy metrics
equal. Inputs come from numpy seeds; NHWC arrays reach the port as NCHW.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from autoware_vision_pilot_tpu.train import losses as jlo
from autoware_vision_pilot_tpu.train import metrics as jme
from autoware_vision_pilot_tpu.train import qat as jqat
from autoware_vision_pilot_tpu_torch.train import losses as tlo
from autoware_vision_pilot_tpu_torch.train import metrics as tme
from autoware_vision_pilot_tpu_torch.train import qat as tqat

from test_torch_layers import ATOL, RTOL
from test_torch_train_step import one_thread  # noqa: F401 (an autouse fixture)

B, H, W = 2, 16, 32


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _total(tree):
    return sum(x.sum() for x in _leaves(tree))


def _nchw(a):
    return np.ascontiguousarray(np.moveaxis(a, -1, 1)) if a.ndim == 4 else a


def both(jfn, tfn, arrays, grads=(0,), nhwc=()):
    """jfn(*arrays) against tfn(*the same as tensors) in value, and the
    gradient of the sum of every output w.r.t. the arrays ``grads``;
    indices in ``nhwc`` go to the port as NCHW."""
    jargs = [jnp.asarray(a) for a in arrays]
    jval = jax.jit(jfn)(*jargs)
    jgrad = jax.jit(jax.grad(lambda *a: _total(jfn(*a)), argnums=tuple(grads)))(*jargs)
    targs = [torch.from_numpy(_nchw(a) if i in nhwc else np.array(a)) for i, a in enumerate(arrays)]
    for i in grads:
        targs[i].requires_grad_(True)
    tval = tfn(*targs)
    _total(tval).backward()
    jl, tl = _leaves(jval), _leaves(tval)
    assert len(jl) == len(tl)
    for j, t in zip(jl, tl):
        np.testing.assert_allclose(torch.as_tensor(t).detach().numpy(), np.asarray(j),
                                   atol=ATOL, rtol=RTOL)
    for k, i in enumerate(grads):
        g = targs[i].grad  # None where the port detaches (JAX: zeros)
        g = np.zeros(targs[i].shape, np.float32) if g is None else g.numpy()
        g = np.moveaxis(g, 1, -1) if i in nhwc else g
        np.testing.assert_allclose(g, np.asarray(jgrad[k]), atol=ATOL, rtol=RTOL)


def rnd(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def test_segmentation_ce_loss():
    logits = rnd((B, H, W, 3), 0, 2.0)
    ids = np.random.default_rng(1).integers(0, 3, (B, H, W)).astype(np.int32)
    w = np.array([0.5, 2.0, 1.5], np.float32)
    both(jlo.segmentation_ce_loss, tlo.segmentation_ce_loss, [logits, ids, w], nhwc=(0,))
    both(lambda lg, t: jlo.segmentation_ce_loss(lg, t), tlo.segmentation_ce_loss,
         [logits, ids], nhwc=(0,))
    soft = np.random.default_rng(2).dirichlet(np.ones(3), (B, H, W)).astype(np.float32)
    both(jlo.segmentation_ce_loss, tlo.segmentation_ce_loss, [logits, soft, w],
         grads=(0, 1), nhwc=(0, 1))


def test_binary_and_lanes_losses():
    logits = rnd((B, H, W, 3), 3, 2.0)
    tgt = (np.random.default_rng(4).random((B, H, W, 3)) > 0.7).astype(np.float32)
    both(jlo.binary_seg_loss, tlo.binary_seg_loss, [logits[..., :1], tgt[..., :1]],
         nhwc=(0, 1))
    both(jlo.lanes_bce_edge_loss, tlo.lanes_bce_edge_loss, [logits, tgt], nhwc=(0, 1))
    both(lambda a, b: jlo.lanes_bce_edge_loss(a, b, 0.3, 2.0),
         lambda a, b: tlo.lanes_bce_edge_loss(a, b, 0.3, 2.0), [logits, tgt], nhwc=(0, 1))
    both(jlo.weighted_egolanes_loss, tlo.weighted_egolanes_loss, [logits, tgt], nhwc=(0, 1))


def test_edge_losses():
    p, g = rnd((B, H, W, 1), 5), rnd((B, H, W, 1), 6)
    both(jlo.edge_loss, tlo.edge_loss, [p, g], grads=(0, 1), nhwc=(0, 1))
    both(jlo.multi_scale_edge_loss, tlo.multi_scale_edge_loss, [p, g], grads=(0, 1),
         nhwc=(0, 1))
    both(lambda a, b: jlo.multi_scale_edge_loss(a, b, 2),
         lambda a, b: tlo.multi_scale_edge_loss(a, b, 2), [p, g], nhwc=(0, 1))


@pytest.mark.parametrize("n", [1, 2, 10, 1001, 4096])
def test_quantile_matches_jnp(n):
    x = rnd((n,), n)
    for q in (0.0, 0.1, 0.5, 0.9, 1.0):
        got = tlo.quantile_linear(torch.from_numpy(x), q)
        assert got.item() == float(jnp.quantile(jnp.asarray(x), q))


def test_depth_losses():
    p = np.abs(rnd((B, H, W, 1), 7)) + 0.1
    g = np.abs(rnd((B, H, W, 1), 8)) + 0.1
    both(jlo.robust_mae, tlo.robust_mae, [p, g], grads=(0, 1), nhwc=(0, 1))
    both(jlo.ssi_mae_depth_loss, tlo.ssi_mae_depth_loss, [p, g], grads=(0, 1), nhwc=(0, 1))
    both(lambda a, b: jlo.ssi_mae_depth_loss(a, b, 0.25),
         lambda a, b: tlo.ssi_mae_depth_loss(a, b, 0.25), [p, g], nhwc=(0, 1))


def _homography():
    return np.array([[1.1, 0.05, 12.0], [0.02, 0.9, 30.0], [1e-4, 2e-4, 1.0]], np.float32)


def test_bev_losses():
    K = 11
    gt_x, pred_x, gt_y = rnd((K,), 9, 0.2) + 0.5, rnd((K,), 10, 0.2) + 0.5, \
        np.linspace(0.1, 0.9, K).astype(np.float32)
    reproj = np.stack([rnd((K,), 11, 0.1) + 0.5, rnd((K,), 12, 0.1) + 0.4])
    Hm, bev, persp = _homography(), (640, 640), (640, 320)
    both(jlo.bev_data_loss, tlo.bev_data_loss, [gt_x, pred_x], grads=(1,))
    both(jlo.bev_gradient_loss, tlo.bev_gradient_loss, [gt_x, pred_x], grads=(1,))
    both(lambda x, y: jlo.project_bev_to_image(x, y, Hm, bev, persp),
         lambda x, y: tlo.project_bev_to_image(x, y, Hm, bev, persp), [pred_x, gt_y],
         grads=(0, 1))
    both(lambda r, y, x: jlo.reprojected_data_loss(r, y, x, Hm, bev, persp),
         lambda r, y, x: tlo.reprojected_data_loss(r, y, x, Hm, bev, persp),
         [reproj, gt_y, pred_x], grads=(2,))
    both(lambda r, y, x: jlo.reprojected_gradient_loss(r, y, x, Hm, bev, persp),
         lambda r, y, x: tlo.reprojected_gradient_loss(r, y, x, Hm, bev, persp),
         [reproj, gt_y, pred_x], grads=(2,))
    names = ("path", "ego_left", "ego_right")
    gts = [np.stack([rnd((K,), 20 + i, 0.2) + 0.5, gt_y]) for i in range(3)]
    preds = [rnd((K,), 30 + i, 0.2) + 0.5 for i in range(3)]
    reps = [np.stack([rnd((K,), 40 + i, 0.1) + 0.5, rnd((K,), 50 + i, 0.1) + 0.4])
            for i in range(3)]

    def corridor(mod, with_reproj):
        def fn(*a):
            gt = dict(zip(names, a[0:3]))
            pred = dict(zip(names, a[3:6]))
            rp = dict(zip(names, a[6:9])) if with_reproj else None
            return mod.corridor_bev_losses(gt, pred, gt_reproj=rp,
                                           homography=Hm if with_reproj else None)
        return fn

    for with_reproj in (False, True):
        both(corridor(jlo, with_reproj), corridor(tlo, with_reproj), gts + preds + reps,
             grads=(3, 4, 5))


def test_data_and_denoising_loss():
    a, b, c = rnd((B, 40), 60), rnd((B, 40), 61), rnd((B, 40), 62)
    both(jlo.data_and_denoising_loss, tlo.data_and_denoising_loss, [a, b, c], grads=(0, 2))
    both(jlo.data_and_denoising_loss, tlo.data_and_denoising_loss, [a, b], grads=(0,))


def test_distillation_kl():
    t, s = rnd((B, H, W, 3), 63, 2.0), rnd((B, H, W, 3), 64, 2.0)
    both(jqat.distillation_kl, tqat.distillation_kl, [t, s], grads=(0, 1), nhwc=(0, 1))


def _boxes(rng, n):
    xy = rng.uniform(0, 80, (n, 2))
    wh = rng.uniform(4, 40, (n, 2))
    return np.concatenate([xy, xy + wh], 1)


def test_detection_metrics_equal():
    rng = np.random.default_rng(70)
    a, b = _boxes(rng, 7), _boxes(rng, 5)
    np.testing.assert_array_equal(tme.box_iou_matrix(a, b), jme.box_iou_matrix(a, b))
    rec = np.sort(rng.random(30))
    prec = rng.random(30)
    assert tme.average_precision(rec, prec) == jme.average_precision(rec, prec)
    assert tme.average_precision([], []) == jme.average_precision([], []) == 0.0
    gts, preds = [], []
    for i in range(6):
        g = _boxes(rng, int(rng.integers(0, 6)))
        gc = rng.integers(0, 3, len(g))
        # predictions: jittered ground truth plus spurious boxes
        p = np.concatenate([g + rng.normal(0, 3, g.shape), _boxes(rng, 3)])
        pc = np.concatenate([gc, rng.integers(0, 3, 3)])
        gts.append((g, gc))
        preds.append((p, rng.random(len(p)), pc))
    got, want = tme.detection_map(preds, gts, 4), jme.detection_map(preds, gts, 4)
    assert got == want and np.isfinite(got[0])
    tp = {t: (rng.random(20) > 0.4).astype(float) for t in (0.05, 0.1, 0.2)}
    fp = {t: 1.0 - v for t, v in tp.items()}
    conf = rng.random(20)
    assert tme.vector_ap(tp, fp, conf, 15) == jme.vector_ap(tp, fp, conf, 15)
