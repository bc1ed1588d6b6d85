"""What the ranks of the CPU tests' torch.distributed worlds run
(autoware_vision_pilot_tpu_torch/parallel/distributed.py::run_world spawns
them): imports only the port, torch and numpy, so that a rank starts
without JAX. Each function takes numpy inputs made by the test and returns
numpy arrays or tensors, which run_world brings back to the test."""
import os

import numpy as np
import torch

from autoware_vision_pilot_tpu_torch.core.mesh import make_mesh
from autoware_vision_pilot_tpu_torch.nn import layers as tl


class TinySeg(torch.nn.Module):
    """The JAX package's TinySeg of its data-parallel test (conv,
    BatchNorm, ReLU, conv: 3 class logits) with a dropout before the last
    conv."""

    def __init__(self):
        super().__init__()
        self.c1 = tl.Conv2d(3, 8, 3, 1, 1)
        self.bn = tl.BatchNorm2d(8, momentum=0.01)  # flax's default 0.99
        self.drop = tl.Dropout(0.3)
        self.c2 = tl.Conv2d(8, 3, 1)

    def forward(self, x):
        return self.c2(self.drop(torch.relu(self.bn(self.c1(x)))))


def replaying(masks):
    """A stand-in for nn.layers.draw_keep_mask that hands out ``masks`` in
    turn (as JAX's traced step repeats its one draw), checking each shape."""
    k = [0]

    def draw(shape, keep_prob, device):
        m = masks[k[0] % len(masks)]
        k[0] += 1
        assert tuple(shape) == m.shape, (tuple(shape), m.shape)
        return torch.from_numpy(m).to(device)

    return draw


def sgd_step(state_dict, images, targets, masks, mesh, microbatches=2):
    """One make_seg_train_step step of TinySeg (sgd 0.1, the CE) from
    ``state_dict`` on the NHWC batch -> (loss, the state dict after)."""
    from autoware_vision_pilot_tpu_torch.train import optim
    from autoware_vision_pilot_tpu_torch.train.losses import segmentation_ce_loss
    from autoware_vision_pilot_tpu_torch.train.train_step import (create_seg_train_state,
                                                                  make_seg_train_step)

    model = TinySeg()
    model.load_state_dict(state_dict)
    state = create_seg_train_state(model, optim.sgd(0.1))
    step = make_seg_train_step(segmentation_ce_loss, mesh=mesh, microbatches=microbatches)
    draw = tl.draw_keep_mask
    tl.draw_keep_mask = replaying(masks)
    try:
        x = torch.from_numpy(images).permute(0, 3, 1, 2)
        state, loss = step(state, x, torch.from_numpy(targets), torch.Generator())
    finally:
        tl.draw_keep_mask = draw
    return float(loss), {k: v.clone() for k, v in model.state_dict().items()}


def contiguous_order(a, world, microbatches):
    """``a`` permuted so that the step's rows of microbatch i on rank r are
    the rows a split contiguous per rank would give it (rank r: rows r B / W
    up to the next rank's, then its microbatches): the order the test must
    tell from the right one."""
    b = len(a) // (world * microbatches)
    blocks = a.reshape(world, microbatches, b, *a.shape[1:])
    return np.ascontiguousarray(blocks.swapaxes(0, 1).reshape(a.shape))


def dp_world(case):
    """Rank side of tests/test_torch_dp_train.py: the TinySeg step in the
    right row order and in the contiguous one, and a Lite trainer step and
    validation."""
    torch.set_num_threads(1)
    mesh = make_mesh(devices="cpu")
    out = {"rank": mesh.rank, "world": mesh.size}
    args = (case["state"], case["images"], case["targets"], case["masks"])
    out["step"] = sgd_step(*args, mesh)
    w, mb = mesh.size, 2
    out["contiguous"] = sgd_step(case["state"], contiguous_order(case["images"], w, mb),
                                 contiguous_order(case["targets"], w, mb), case["masks"], mesh)
    out["lite"] = lite_run(case["lite"], mesh)
    out["det"] = det_run(case["det"], mesh)
    return out


def det_run(case, mesh):
    """One DetectionTrainer step (AutoSpeed "n" at 64x128 from seed 0) and a
    validation of the live weights -> (the loss, the first moments, the
    state dict, the mAPs)."""
    from autoware_vision_pilot_tpu_torch.models.auto_speed import AutoSpeedNetwork
    from autoware_vision_pilot_tpu_torch.train.detection_trainer import (DetectionTrainer,
                                                                         DetectionTrainerConfig)

    tr = DetectionTrainer(AutoSpeedNetwork("n", 4, 64, 128),
                          DetectionTrainerConfig(input_hw=(64, 128), max_boxes=8),
                          mesh=mesh, device="cpu")
    loss = tr.fit_step(*case["batch"])
    moments = {n: tr.state.optimizer.state[p]["exp_avg"].clone()
               for n, p in tr.model.named_parameters()}
    maps = tr.validate(iter(case["val"]), use_ema=False)
    return float(loss), moments, {k: v.clone() for k, v in tr.model.state_dict().items()}, maps


def lite_run(case, mesh):
    """One LiteTrainer step (fit) and a validation from ``case``'s weights,
    config and batches -> (the state dict, the mIoU). TensorBoard, which
    the trainer uses where it is installed, is hidden from it: importing it
    takes seconds."""
    import sys

    from autoware_vision_pilot_tpu_torch.train.lite_trainer import LiteTrainer

    def batches():
        while True:
            yield case["images"], case["labels"]

    def val():
        yield case["val_images"], case["val_labels"]

    model = TinySeg()
    model.load_state_dict(case["state"])
    draw, board = tl.draw_keep_mask, sys.modules.get("torch.utils.tensorboard", False)
    tl.draw_keep_mask = replaying(case["masks"])
    sys.modules["torch.utils.tensorboard"] = None
    try:
        trainer = LiteTrainer(model, case["cfg"], batches, val, input_hw=case["hw"],
                              num_classes=3, mesh=mesh, device="cpu")
        trainer.fit(max_steps=1)
        miou = trainer.validate(1)
        trainer.close()
    finally:
        tl.draw_keep_mask = draw
        if board is False:
            del sys.modules["torch.utils.tensorboard"]
        else:
            sys.modules["torch.utils.tensorboard"] = board
    return {k: v.clone() for k, v in trainer.model.state_dict().items()}, miou


def loss_world(case):
    """Rank side of tests/test_torch_parallel.py: the mesh, the collectives
    and the batch-wide losses on this rank's rows, with their gradients."""
    from autoware_vision_pilot_tpu_torch.parallel.distributed import make_hybrid_mesh
    from autoware_vision_pilot_tpu_torch.parallel.sharding import (
        all_reduce_mean, batch_sharded, cross_replica_psum, eval_rows, gather_rows, shard_batch)
    from autoware_vision_pilot_tpu_torch.train import losses
    from autoware_vision_pilot_tpu_torch.train.detection_loss import detection_loss

    torch.set_num_threads(1)
    mesh = make_mesh(devices="cpu")
    r, w = mesh.rank, mesh.size
    out = {"rank": r, "shape": mesh.shape, "devices": [str(d) for d in mesh.devices.flat]}
    out["hybrid one host"] = make_hybrid_mesh().shape
    os.environ["LOCAL_WORLD_SIZE"] = "1"
    out["hybrid two hosts"] = make_hybrid_mesh().shape
    del os.environ["LOCAL_WORLD_SIZE"]
    out["mean"] = all_reduce_mean(mesh, torch.tensor(case["values"][r]))
    out["shard"] = shard_batch(mesh, {"rows": torch.arange(8.0), "odd": torch.arange(5.0)})
    x = torch.tensor([1.0 + r], requires_grad=True)
    (cross_replica_psum(x, mesh) * (r + 1)).sum().backward()
    out["psum grad"] = x.grad.clone()
    rows = eval_rows(mesh, 5)
    out["gathered"] = gather_rows(mesh, list(range(rows.start, rows.stop)))

    def mine(a):
        n = len(a) // w
        return torch.from_numpy(a[r * n:(r + 1) * n])

    maps = [mine(m).requires_grad_(True) for m in case["maps"]]
    pred = mine(case["pred"]).requires_grad_(True)
    logits = mine(case["logits"]).requires_grad_(True)
    with batch_sharded(mesh):
        det, parts = detection_loss(maps, *(mine(a) for a in case["targets"]))
        mae = losses.robust_mae(pred, mine(case["gt"]))
        ssi = losses.ssi_mae_depth_loss(pred, mine(case["gt"]))[0]
        ce = losses.segmentation_ce_loss(logits, mine(case["ids"]), case["class_weights"])
    out["losses"] = {"det": float(det), "robust_mae": float(mae), "ssi": float(ssi),
                     "ce": float(ce), **{k: float(v) for k, v in parts.items()}}
    out["grads"] = {"det": [m_ for m_ in torch.autograd.grad(det, maps)],
                    "robust_mae": torch.autograd.grad(mae, pred)[0],
                    "ssi": torch.autograd.grad(ssi, pred)[0],
                    "ce": torch.autograd.grad(ce, logits)[0]}
    return out


def failing_world(_):
    """Rank 1 raises; rank 0 waits in a collective that never completes."""
    import torch.distributed as dist

    if dist.get_rank() == 1:
        raise ValueError("rank 1 fails on purpose")
    dist.all_reduce(torch.ones(1))
    return "unreachable"
