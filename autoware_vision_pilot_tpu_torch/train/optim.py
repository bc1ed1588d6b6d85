"""The optax pieces the trainers use, on torch optimizers: the learning-rate
schedules (``warmup_cosine_decay_schedule``, ``cosine_decay_schedule``,
``exponential_decay``, ``polynomial_schedule``), ``clip_by_global_norm``,
``adamw`` and ``sgd`` (optax's ``chain(add_decayed_weights, sgd)``), and
``multi_transform`` with ``set_to_zero``.

A schedule is a function of the update count n (the updates made so far)
to the learning rate, in float32 arithmetic in optax's order. optax
evaluates it at the count *before* the update, so the first update of a
warm-up runs at ``schedule(0)``, which is 0; the optimizers here do the
same: each param group keeps its count (``group["count"]``, saved in the
optimizer's state_dict) and sets ``lr = schedule(count)`` before its
update. ``torch.optim.lr_scheduler`` steps after the update, one off from
that.

An optimizer factory (``adamw(...)``, ``sgd(...)``, ``multi_transform(...)``)
takes the parameters, as ``(name, parameter)`` pairs (``named_parameters``)
or bare, and returns a ``torch.optim.Optimizer``; train_step.py::
create_seg_train_state calls it. ``set_to_zero`` leaves its parameters out
of the optimizer: they get no update and no weight decay, as under optax,
which is the opposite of train_step.py::optimizer_step's rule for trained
parameters that got no gradient (a zero gradient, still decayed).
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Union

import numpy as np
import torch

F32 = np.float32
Schedule = Callable[[int], float]


def _f32(x) -> float:
    return float(np.asarray(x, F32))


def polynomial_schedule(init_value: float, end_value: float, power: float,
                        transition_steps: int, transition_begin: int = 0) -> Schedule:
    """optax.polynomial_schedule: (I - E) (1 - clip(n - B, 0, T) / T)^P + E."""
    if transition_steps <= 0:
        return lambda count: float(init_value)
    begin = max(transition_begin, 0)

    def schedule(count: int) -> float:
        n = F32(min(max(count - begin, 0), transition_steps))
        frac = F32(1) - n / F32(transition_steps)
        return _f32((F32(init_value) - F32(end_value)) * frac ** F32(power) + F32(end_value))

    return schedule


def linear_schedule(init_value: float, end_value: float, transition_steps: int,
                    transition_begin: int = 0) -> Schedule:
    return polynomial_schedule(init_value, end_value, 1, transition_steps, transition_begin)


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0,
                          exponent: float = 1.0) -> Schedule:
    """optax.cosine_decay_schedule: I ((1 - a) (0.5 (1 + cos(pi min(n, D) / D)))^e + a)."""
    if not decay_steps > 0:
        raise ValueError(f"cosine_decay_schedule needs positive decay_steps, got {decay_steps}")

    def schedule(count: int) -> float:
        n = F32(min(float(count), float(decay_steps)))
        cos = F32(0.5) * (F32(1) + np.cos(F32(np.pi) * n / F32(decay_steps)))
        decayed = (F32(1) - F32(alpha)) * cos ** F32(exponent) + F32(alpha)
        return _f32(F32(init_value) * decayed)

    return schedule


def exponential_decay(init_value: float, transition_steps: int, decay_rate: float,
                      transition_begin: int = 0, staircase: bool = False,
                      end_value: Optional[float] = None) -> Schedule:
    """optax.exponential_decay: I r^((n - B) / T), floored with ``staircase``,
    I until n passes B, clipped at ``end_value``."""
    if transition_steps <= 0 or decay_rate == 0:
        return lambda count: float(init_value)
    begin = max(transition_begin, 0)

    def schedule(count: int) -> float:
        dn = count - begin
        p = F32(dn) / F32(transition_steps)
        if staircase:
            p = np.floor(p)
        value = F32(init_value) if dn <= 0 else F32(init_value) * np.power(F32(decay_rate), p)
        if end_value is not None:
            value = (max if decay_rate < 1.0 else min)(value, F32(end_value))
        return _f32(value)

    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int, end_value: float = 0.0,
                                 exponent: float = 1.0) -> Schedule:
    """optax.warmup_cosine_decay_schedule: linear from ``init_value`` to
    ``peak_value`` over ``warmup_steps``, then a cosine decay to
    ``end_value`` at ``decay_steps`` (counted from 0)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    warm = linear_schedule(init_value, peak_value, warmup_steps)
    decay = cosine_decay_schedule(peak_value, decay_steps - warmup_steps, alpha, exponent)
    return lambda count: warm(count) if count < warmup_steps else decay(count - warmup_steps)


def as_schedule(lr: Union[float, Schedule]) -> Schedule:
    return lr if callable(lr) else (lambda count: float(lr))


@torch.no_grad()
def clip_by_global_norm(grads: Iterable[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm on ``grads`` in place: where the global norm
    g = sqrt(sum |t|^2) is at least ``max_norm``, every t becomes
    (t / g) * max_norm. Makes no host synchronisation. -> g."""
    grads = [g for g in grads if g is not None]
    norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm.to(g.dtype) * max_norm))
    return norm


class _Scheduled:
    """A torch optimizer behind optax's chain: the gradients first clipped by
    their global norm (``clip_norm``), then each group's ``lr`` set to
    ``schedule(count)`` at its count of updates made, then the update."""

    def __init__(self, params, schedule: Schedule, clip_norm: Optional[float], **kw):
        self.schedule = schedule
        self.clip_norm = clip_norm
        super().__init__(params, lr=schedule(0), **kw)
        for group in self.param_groups:
            group.setdefault("count", 0)

    @torch.no_grad()
    def step(self, closure=None):
        if self.clip_norm is not None:
            clip_by_global_norm((p.grad for g in self.param_groups for p in g["params"]),
                                self.clip_norm)
        for group in self.param_groups:
            group["lr"] = self.schedule(group["count"])
            group["count"] += 1
        return super().step(closure)


class AdamW(_Scheduled, torch.optim.AdamW):
    """optax.adamw (optionally after clip_by_global_norm) on torch's AdamW."""


class SGD(_Scheduled, torch.optim.SGD):
    """optax.chain(add_decayed_weights(wd), sgd(lr, momentum)) on torch's SGD:
    g + wd p into the momentum trace m = g' + momentum m (the first trace g'),
    then p -= lr m, as torch's SGD with weight_decay and dampening 0 does."""


def adamw(lr: Union[float, Schedule], b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 1e-4, clip_norm: Optional[float] = None):
    """``optax.adamw(lr, b1, b2, eps, weight_decay=...)`` (``lr`` a float or a
    schedule), behind ``optax.clip_by_global_norm(clip_norm)`` when given:
    a factory of the optimizer over the parameters it is given. optax's
    defaults: eps outside the square root, every parameter decayed."""
    schedule = as_schedule(lr)

    def make(params) -> torch.optim.Optimizer:
        return AdamW(list(params), schedule, clip_norm, betas=(b1, b2), eps=eps,
                     weight_decay=weight_decay)
    return make


def sgd(lr: Union[float, Schedule], momentum: float = 0.0, weight_decay: float = 0.0):
    """``optax.chain(optax.add_decayed_weights(weight_decay), optax.sgd(lr,
    momentum))``: a factory of the optimizer over the parameters it is given."""
    schedule = as_schedule(lr)

    def make(params) -> torch.optim.Optimizer:
        return SGD(list(params), schedule, None, momentum=momentum, weight_decay=weight_decay)
    return make


def set_to_zero():
    """optax.set_to_zero: the label's parameters get no update (None in
    ``multi_transform``'s table)."""
    return None


def multi_transform(transforms: Dict[str, Optional[Callable]],
                    labels: Union[Dict[str, str], Callable[[str], str]]):
    """optax.multi_transform: each parameter goes to the factory of its
    label, ``labels[name]`` (or ``labels(name)``); a label whose transform
    is ``set_to_zero()`` keeps its parameters out of every optimizer. The
    factory takes ``(name, parameter)`` pairs and returns the optimizer of
    the one label that trains anything (the trainers use one)."""
    label_of = labels if callable(labels) else labels.__getitem__

    def make(named_params) -> torch.optim.Optimizer:
        groups: Dict[str, list] = {}
        for item in named_params:
            if not isinstance(item, tuple):
                raise TypeError("multi_transform labels parameters by name: pass "
                                "named_parameters()")
            name, p = item
            label = label_of(name)
            if label not in transforms:
                raise KeyError(f"no transform for label {label!r} of {name}")
            groups.setdefault(label, []).append((name, p))
        trained = {k: v for k, v in groups.items() if transforms[k] is not None}
        if len(trained) != 1:
            raise ValueError(f"multi_transform here trains one label, got {sorted(trained)}")
        (label, params), = trained.items()
        return transforms[label](params)
    return make
