"""Training losses, the port of autoware_vision_pilot_tpu/train/losses.py.

- segmentation_ce_loss: class-weighted cross-entropy
  (Models/training/scene_seg_trainer.py:128-131).
- ssi_mae_depth_loss: scale-shift-invariant normalization + 90th-quantile
  robust mAE + multi-scale Sobel edge loss (scene_3d_trainer.py:151-196).
- lanes_bce_edge_loss, weighted_egolanes_loss: per-channel BCE +
  multi-scale edge consistency (ego_lanes_trainer.py:268-542).
- binary_seg_loss: BCE-with-logits for DomainSeg.
- the EgoLanes BEV / reprojected corridor family and
  data_and_denoising_loss (ego_lanes_trainer.py:268-578).

The dense losses take the port's NCHW logits and NCHW targets (class ids
are (B, H, W)); the BEV losses take (N,) and (2, N) point tensors. Each
reduces to a scalar and is differentiable with autograd, with the JAX
functions' arithmetic. Inside a data-parallel step (parallel/sharding.py::
batch_sharded) the batch-wide parts (the weighted CE's normalizer, the SSI
extrema and mean, robust_mae's quantile and count) are taken over the
whole batch, so that the ranks' losses average to the whole batch's.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..parallel.sharding import batch_gather, batch_normalizer

SOBEL_GX = ((1.0, 0.0, -1.0), (2.0, 0.0, -2.0), (1.0, 0.0, -1.0))
SOBEL_GY = ((1.0, 2.0, 1.0), (0.0, 0.0, 0.0), (-1.0, -2.0, -1.0))


def segmentation_ce_loss(logits, target_onehot_or_ids, class_weights=None):
    """Cross-entropy over the class channel. logits (B, C, H, W); target
    either (B, H, W) int ids or (B, C, H, W) one-hot/soft; torch's weighted
    CE: sum(w_y * nll) / sum(w_y)."""
    C = logits.shape[1]
    logp = F.log_softmax(logits, dim=1)
    tgt = target_onehot_or_ids
    if tgt.dim() == logits.dim() - 1:
        tgt = F.one_hot(tgt.long(), C).permute(0, 3, 1, 2).to(logp.dtype)
    if class_weights is None:
        class_weights = torch.ones(C, dtype=logp.dtype, device=logits.device)
    w = torch.as_tensor(class_weights, dtype=logp.dtype, device=logits.device)
    w = w.reshape(1, C, 1, 1)
    nll = -(tgt * logp)
    wsum = torch.sum(tgt * w, dim=1)
    return torch.sum(nll * w) / batch_normalizer(torch.sum(wsum), 1e-12)


def _bce_with_logits(logits, target):
    return torch.mean(torch.clamp_min(logits, 0) - logits * target
                      + torch.log1p(torch.exp(-torch.abs(logits))))


def binary_seg_loss(logits, target):
    """BCE with logits (DomainSeg binary roadwork head)."""
    return _bce_with_logits(logits, target)


def _ssi_norm(x):
    """(x - min) / (max - mean): the reference's get_ssi_nom_tensor, the
    extrema and mean over the whole batch."""
    whole = batch_gather(x)
    return (x - torch.min(whole)) / (torch.max(whole) - torch.mean(whole))


def _sobel(x_n1hw):
    k = torch.tensor((SOBEL_GX, SOBEL_GY), dtype=x_n1hw.dtype, device=x_n1hw.device)
    return F.conv2d(x_n1hw, k[:, None], padding=1)


def edge_loss(pred_n1hw, gt_n1hw):
    gp = _sobel(pred_n1hw)
    gg = _sobel(gt_n1hw)
    return torch.mean(torch.abs(gp[:, 0] - gg[:, 0]) + torch.abs(gp[:, 1] - gg[:, 1]))


def _avgpool2(x):
    return F.avg_pool2d(x, 2)


def multi_scale_edge_loss(pred, gt, scales: int = 4):
    total = 0.0
    p, g = pred, gt
    for i in range(scales):
        total = total + edge_loss(p, g)
        if i < scales - 1:
            p, g = _avgpool2(p), _avgpool2(g)
    return total / scales


def quantile_linear(x, q: float):
    """The ``q`` quantile of all of ``x`` with linear interpolation, as
    ``jnp.quantile`` computes it (in f32: position q (n - 1), weights of
    its floor and ceiling). It sorts and indexes, so it takes any number of
    elements (``torch.quantile`` refuses inputs above 2^24)."""
    v = torch.sort(x.detach().reshape(-1)).values
    n = v.numel()
    pos = torch.tensor(q, dtype=torch.float32) * torch.tensor(n - 1, dtype=torch.float32)
    high_w = pos - torch.floor(pos)
    low_w = 1.0 - high_w  # f32 scalars on the host: exact as Python floats
    low = min(max(int(torch.floor(pos)), 0), n - 1)
    high = min(max(int(torch.ceil(pos)), 0), n - 1)
    return v[low] * float(low_w) + v[high] * float(high_w)


def robust_mae(pred, gt, quantile: float = 0.9):
    """Mean of |err| below its q-th quantile (a masked mean), the quantile
    and the count over the whole batch."""
    err = torch.abs(pred - gt)
    mask = err < quantile_linear(batch_gather(err.detach()), quantile)
    return torch.sum(err * mask) / batch_normalizer(torch.sum(mask), 1)


def ssi_mae_depth_loss(pred_n1hw, gt_n1hw, edge_scale: float = 1.0):
    """Scene3D total loss: robust SSI-mAE + edge_scale * multi-scale edges.
    Returns (total, mae, edge)."""
    p = _ssi_norm(pred_n1hw)
    g = _ssi_norm(gt_n1hw)
    mae = robust_mae(p, g)
    e = multi_scale_edge_loss(p, g)
    return mae + edge_scale * e, mae, e


def lanes_bce_edge_loss(logits_nchw, target_nchw, bce_weight: float = 1.0,
                        edge_weight: float = 1.0):
    """EgoLanes: per-channel BCE + multi-scale edge consistency on the
    sigmoid probabilities. Returns (total, bce, edge)."""
    bce = _bce_with_logits(logits_nchw, target_nchw)
    prob = torch.sigmoid(logits_nchw)
    C = logits_nchw.shape[1]
    e = 0.0
    for c in range(C):
        e = e + multi_scale_edge_loss(prob[:, c:c + 1], target_nchw[:, c:c + 1])
    e = e / C
    return bce_weight * bce + edge_weight * e, bce, e


# ---- EgoLanes BEV / reprojected loss family --------------------------------
# BEV lane/path elements are (2, N) tensors [x_vals; y_vals] in normalized
# BEV coordinates; the homography maps BEV pixels -> perspective pixels.

def weighted_egolanes_loss(logits_nchw, target_nchw):
    """Per-channel BCE + multi-scale edge with the reference's channel
    weighting: 2*ego-left + 2*ego-right + 1*other
    (ego_lanes_trainer.py:280-304). Returns (total, per_channel)."""
    weights = (2.0, 2.0, 1.0)
    prob = torch.sigmoid(logits_nchw)
    per_channel = []
    total = 0.0
    for c, w in enumerate(weights):
        bce = _bce_with_logits(logits_nchw[:, c], target_nchw[:, c])
        e = multi_scale_edge_loss(prob[:, c:c + 1], target_nchw[:, c:c + 1])
        ch_loss = bce + e
        per_channel.append(ch_loss)
        total = total + w * ch_loss
    return total, per_channel


def bev_data_loss(gt_x, pred_x):
    """Mean absolute error over BEV x-values (calc_BEV_data_loss,
    ego_lanes_trainer.py:446-459)."""
    return torch.mean(torch.abs(gt_x - pred_x))


def bev_gradient_loss(gt_x, pred_x):
    """Finite-difference gradient MAE; the reference divides the (N-1)-term
    sum by N (calc_BEV_graient_loss, :463-481)."""
    d = torch.abs(torch.diff(gt_x) - torch.diff(pred_x))
    return torch.sum(d) / gt_x.shape[-1]


def project_bev_to_image(bev_x, bev_y, homography, bev_wh, perspective_wh):
    """Normalized BEV points -> normalized perspective-image points through
    the 3x3 BEV->image homography (projectBEVtoImage, :554-578)."""
    bw, bh = bev_wh
    pw, ph = perspective_wh
    H = torch.as_tensor(homography, dtype=bev_x.dtype, device=bev_x.device)
    px = bw * bev_x
    py = bh * bev_y
    hx = px * H[0, 0] + py * H[0, 1] + H[0, 2]
    hy = px * H[1, 0] + py * H[1, 1] + H[1, 2]
    hs = px * H[2, 0] + py * H[2, 1] + H[2, 2]
    return torch.stack([hx / hs / pw, hy / hs / ph], dim=0)   # (2, N)


def reprojected_data_loss(gt_reproj_xy, gt_y, pred_x, homography,
                          bev_wh, perspective_wh):
    """L1 between GT reprojected points and the prediction's BEV x-values
    (at the GT y-samples) pushed through the same homography
    (calc_reprojected_data_loss, :485-512)."""
    pred_xy = project_bev_to_image(pred_x, gt_y, homography, bev_wh, perspective_wh)
    err = torch.abs(gt_reproj_xy[0] - pred_xy[0]) + torch.abs(gt_reproj_xy[1] - pred_xy[1])
    return torch.mean(err)


def reprojected_gradient_loss(gt_reproj_xy, gt_y, pred_x, homography,
                              bev_wh, perspective_wh):
    """Finite-difference gradient error on the reprojected x-coordinates
    (calc_reprojected_gradient_loss, :516-541); (N-1)-sum / N."""
    pred_xy = project_bev_to_image(pred_x, gt_y, homography, bev_wh, perspective_wh)
    d = torch.abs(torch.diff(gt_reproj_xy[0]) - torch.diff(pred_xy[0]))
    return torch.sum(d) / gt_y.shape[-1]


def corridor_bev_losses(gt_elems, pred_elems, gt_reproj=None,
                        homography=None, bev_wh=(640, 640),
                        perspective_wh=(640, 320)):
    """Driving-corridor aggregate over (path, ego-left, ego-right):
    averaged BEV data + gradient losses, plus reprojected data/gradient
    when the homography and GT reprojections are given
    (calc_*_driving_corridor, :362-441). gt_elems/pred_elems: dicts
    name -> (2, N) gt / (N,) pred-x. Returns a dict of scalars."""
    names = tuple(gt_elems.keys())
    out = {}
    data = grad = 0.0
    for n in names:
        data = data + bev_data_loss(gt_elems[n][0], pred_elems[n])
        grad = grad + bev_gradient_loss(gt_elems[n][0], pred_elems[n])
    out["bev_data"] = data / len(names)
    out["bev_gradient"] = grad / len(names)
    if gt_reproj is not None and homography is not None:
        rd = rg = 0.0
        for n in names:
            rd = rd + reprojected_data_loss(gt_reproj[n], gt_elems[n][1], pred_elems[n],
                                            homography, bev_wh, perspective_wh)
            rg = rg + reprojected_gradient_loss(gt_reproj[n], gt_elems[n][1], pred_elems[n],
                                                homography, bev_wh, perspective_wh)
        out["reproj_data"] = rd / len(names)
        out["reproj_gradient"] = rg / len(names)
    return out


def data_and_denoising_loss(pred_data, gt_data, pred_noisy_data=None):
    """L1 data loss + optional denoising consistency L1 between clean and
    noisy-input predictions (calc_data_loss/calc_denoising_loss,
    :268-277). Returns (data, denoising)."""
    data = torch.mean(torch.abs(pred_data - gt_data))
    den = (torch.mean(torch.abs(pred_data - pred_noisy_data)) if pred_noisy_data is not None
           else torch.zeros((), dtype=data.dtype, device=data.device))
    return data, den
