"""Longitudinal PID: (target - current) speed -> accel effort (m/s^2); the
port's own copy of autoware_vision_pilot_tpu/control/pi_controller.py (host
scalar code, as there).

Rebuild of production_release/src/longitudinal/pi_controller.cpp:23-38,
including the reset-on-cut-in contract (main.cpp:730-735).
"""
from __future__ import annotations


class PIController:
    def __init__(self, K_p: float, K_i: float, K_d: float):
        self.K_p, self.K_i, self.K_d = K_p, K_i, K_d
        self.integral_error = 0.0
        self.prev_error = 0.0

    def compute_effort(self, current_speed: float, target_speed: float) -> float:
        error = target_speed - current_speed
        self.integral_error += error
        effort = (self.K_p * error
                  + self.K_i * self.integral_error
                  + self.K_d * (error - self.prev_error))
        self.prev_error = error
        return effort

    def reset(self):
        self.integral_error = 0.0
        self.prev_error = 0.0
