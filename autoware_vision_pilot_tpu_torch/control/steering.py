"""Lateral control: hybrid Stanley + PID + feed-forward steering, the port of
autoware_vision_pilot_tpu/control/steering.py.

Rebuild of production_release/src/steering_control/steering_controller.cpp:28-41
and steering_filter.cpp:17-39: plain Python classes for a host control loop,
and a functional step on tensors for the per-frame lateral step on the card.
"""
from __future__ import annotations

import math
from collections import deque
from typing import NamedTuple

import torch


class SteeringController:
    """steering = K_d*(yaw - prev_yaw) + atan(K_i*cte) + K_p*yaw + ff*K_S."""

    def __init__(self, K_p: float, K_i: float, K_d: float, K_S: float):
        self.K_p, self.K_i, self.K_d, self.K_S = K_p, K_i, K_d, K_S
        self.prev_yaw_error = 0.0

    def compute_steering(self, cte: float, yaw_error: float,
                         feed_forward: float) -> float:
        angle = (self.K_d * (yaw_error - self.prev_yaw_error)
                 + math.atan(self.K_i * cte)
                 + self.K_p * yaw_error
                 + feed_forward * self.K_S)
        self.prev_yaw_error = yaw_error
        return angle


class SteeringFilter:
    """Moving average over a 10-deep ring buffer (steering_filter.cpp).

    The reference accumulates into a long long (0LL), truncating each sample
    to an integer before summing; this keeps the float mean the code plainly
    intends, as the JAX package does.
    """

    def __init__(self, smoothing_factor: float = 0.5, initial: float = 0.0):
        self.buf = deque(maxlen=10)
        self.previous_steering = initial

    def filter(self, current_steering: float, dt: float = 0.0) -> float:
        self.buf.append(current_steering)
        return sum(self.buf) / len(self.buf)

    def reset(self, value: float = 0.0):
        self.previous_steering = value
        self.buf.clear()


class SteeringState(NamedTuple):
    prev_yaw_error: torch.Tensor   # () f32
    ring: torch.Tensor             # (10,) f32
    ring_len: torch.Tensor         # () int32


def steering_init(device="cuda") -> SteeringState:
    return SteeringState(torch.zeros((), device=device),
                         torch.zeros(10, device=device),
                         torch.zeros((), dtype=torch.int32, device=device))


def steering_step(state: SteeringState, cte, yaw_error, feed_forward,
                  K_p, K_i, K_d, K_S, fused_valid=None, bev_valid=None):
    """One control tick (main.cpp:511-589): the angle is computed, and
    prev_yaw_error advances, only when ``bev_valid`` and ``fused_valid``; the
    moving-average ring takes the angle (0 on a fused-invalid frame) only
    when ``bev_valid``. ``yaw_error`` in degrees, ``cte`` in meters,
    ``feed_forward`` the fused curvature channel. Flags default to True.
    -> (filtered, angle, new state), 0-d f32 tensors on the state's device.
    """
    ones = torch.ones((), dtype=torch.bool, device=state.ring.device)
    fused_valid = ones if fused_valid is None else fused_valid
    bev_valid = ones if bev_valid is None else bev_valid
    compute = fused_valid & bev_valid
    angle = (K_d * (yaw_error - state.prev_yaw_error)
             + torch.atan(K_i * cte) + K_p * yaw_error + feed_forward * K_S)
    angle = torch.where(compute, angle, 0.0)
    prev_yaw = torch.where(compute, yaw_error, state.prev_yaw_error)
    pushed = torch.cat([angle.reshape(1), state.ring[:-1]])
    ring = torch.where(bev_valid, pushed, state.ring)
    n = torch.where(bev_valid, torch.clamp(state.ring_len + 1, max=10),
                    state.ring_len)
    live = torch.arange(10, device=ring.device) < n
    mean = (ring * live).sum() / torch.clamp(n, min=1)
    filtered = torch.where(bev_valid, mean, 0.0)
    return filtered, angle, SteeringState(prev_yaw, ring, n)
