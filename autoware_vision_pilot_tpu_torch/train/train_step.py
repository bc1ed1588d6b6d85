"""The segmentation train step on one card, the port of
autoware_vision_pilot_tpu/train/train_step.py.

The JAX step is one jitted SPMD program over a mesh; here it is an eager
PyTorch step on one device: forward in train mode (BatchNorm on batch
statistics, dropout and stochastic depth from an explicit generator),
autograd, the optimizer, then the EMA. Gradient accumulation (the
reference's batch-size-by-accumulation trick, train_scene_seg.py:113-129)
runs the microbatches in order, the BatchNorm running statistics carried
from one to the next, and averages their gradients, as the JAX scan does.

``TrainState`` holds the module (the JAX ``params`` and ``batch_stats``
are its parameters and buffers), the optimizer (``opt_state``), the step
and the EMA copies of the parameters. ``adamw`` stands in for
``optax.adamw(lr)`` with optax's defaults. bf16 compute is
``compute_dtype=torch.bfloat16``: autocast over f32 master weights, the
counterpart of a flax net with ``dtype=jnp.bfloat16`` and f32 params.
Data parallelism over several cards (the JAX ``mesh``) is ROADMAP Queue 1
item 6.6.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch
from torch import nn

from ..nn.layers import dropout_generator


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    ema: Optional[Dict[str, torch.Tensor]] = None


def adamw(lr: float):
    """``optax.adamw(lr)``: a factory of ``torch.optim.AdamW`` over the
    parameters it is given, with optax's defaults, betas (0.9, 0.999), eps
    1e-8 outside the square root and weight decay 1e-4 (torch's own
    default is 1e-2). Every parameter is decayed, BatchNorm scales and
    biases included, as optax decays every leaf."""
    def make(params) -> torch.optim.Optimizer:
        return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=1e-4)
    return make


def create_seg_train_state(model: nn.Module, tx: Callable, ema: bool = False) -> TrainState:
    """A TrainState over ``model`` as it is (its weights set by init_seeded
    or loaded): its float parameters are set to require gradients (the
    port's layers create theirs without), ``tx`` (e.g. ``adamw(1e-4)``)
    builds the optimizer over them; with ``ema`` the EMA starts as a copy
    of them."""
    params = [p for p in model.parameters() if p.is_floating_point()]
    for p in params:
        p.requires_grad_(True)
    copies = ({n: p.detach().clone() for n, p in model.named_parameters()
               if p.is_floating_point()} if ema else None)
    return TrainState(model, tx(params), 0, copies)


def optimizer_step(optimizer: torch.optim.Optimizer) -> None:
    """``optimizer.step()`` with a zero gradient for every parameter that got
    none (a frozen subtree): optax updates every leaf, so AdamW's weight
    decay still applies there, where torch would skip the parameter."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
    optimizer.step()


def make_seg_train_step(loss_fn: Callable, mesh=None, microbatches: int = 1,
                        ema_decay: Optional[float] = None,
                        compute_dtype: torch.dtype = torch.float32):
    """The train step ``step(state, images, targets, generator) -> (state,
    mean loss)`` (a 0-d tensor on the device; nothing waits for it).

    loss_fn(logits, targets) -> scalar, on the logits in f32 (cast up from
    ``compute_dtype``). ``images`` (B, 3, H, W) and
    ``targets`` are on the model's device; with ``microbatches`` > 1 their
    leading dim is split into that many equal slices, run in order, and
    the gradients averaged. ``generator`` (on any device; its masks are
    moved to the images') draws the dropout and stochastic-depth masks.
    The update is in place: the module, the optimizer and the EMA of
    ``state`` change, and its step counts one more."""
    if mesh is not None:
        raise NotImplementedError("the train step over a mesh of several cards is ROADMAP "
                                  "Queue 1 item 6.6; this step runs on one device")

    def step(state: TrainState, images: torch.Tensor, targets: torch.Tensor,
             generator: torch.Generator):
        model, opt = state.model, state.optimizer
        B = images.shape[0]
        if B % microbatches:
            raise ValueError(f"batch {B} does not split into {microbatches} microbatches")
        n = B // microbatches
        model.train()
        opt.zero_grad(set_to_none=True)
        losses = []
        with dropout_generator(generator):
            for i in range(microbatches):
                with torch.autocast(images.device.type, dtype=compute_dtype,
                                    enabled=compute_dtype != torch.float32):
                    out = model(images[i * n:(i + 1) * n])
                loss = loss_fn(out.float(), targets[i * n:(i + 1) * n])
                loss.backward()
                losses.append(loss.detach())
        if microbatches > 1:
            for group in opt.param_groups:
                for p in group["params"]:
                    if p.grad is not None:
                        p.grad.div_(microbatches)
        optimizer_step(opt)
        if ema_decay is not None and state.ema is not None:
            with torch.no_grad():
                for name, p in model.named_parameters():
                    if name in state.ema:
                        e = state.ema[name]
                        e.copy_(e * ema_decay + p * (1 - ema_decay))
        state.step += 1
        return state, torch.stack(losses).mean()

    return step
