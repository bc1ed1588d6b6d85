"""Longitudinal planning: Mobileye-RSS safe distance + banded accel policy;
the port's own copy of autoware_vision_pilot_tpu/control/speed_planner.py
(host scalar code, as there).

Rebuild of production_release/src/speed_planning/speed_planning.cpp:55-115.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RSSConstants:
    a_max_brake: float = 4.5    # lead car max decel (m/s^2)
    a_max_accel: float = 2.0    # ego max accel
    a_min_brake: float = 1.0    # ego comfortable decel
    response_time: float = 0.1  # 10 Hz pipeline
    speed_limit: float = 31.0   # ~70 mph


class SpeedPlanner:
    def __init__(self, relative_cipo_speed: float = 0.0,
                 cipo_distance: float = 0.0, ego_speed: float = 0.0,
                 absolute_cipo_speed: float = 0.0,
                 is_cipo_present: bool = False,
                 constants: RSSConstants = RSSConstants()):
        self.relative_cipo_speed = relative_cipo_speed
        self.cipo_distance = cipo_distance
        self.ego_speed = ego_speed
        self.absolute_cipo_speed = absolute_cipo_speed
        self.is_cipo_present = is_cipo_present
        self.c = constants
        self.speed_limit = constants.speed_limit
        self.fcw = False
        self.aeb = False

    def set_ego_speed(self, v): self.ego_speed = v
    def set_is_cipo_present(self, p): self.is_cipo_present = p

    def set_cipo_state(self, relative_speed, distance):
        self.relative_cipo_speed = relative_speed
        self.cipo_distance = distance

    def calc_safe_rss_distance(self) -> float:
        c = self.c
        cipo_abs = self.ego_speed + self.relative_cipo_speed
        v_react = self.ego_speed + c.response_time * c.a_max_accel
        d = (c.response_time * self.ego_speed
             + 0.5 * c.a_max_accel * c.response_time ** 2
             + v_react * v_react / (2.0 * c.a_min_brake)
             - cipo_abs * cipo_abs / (2.0 * c.a_max_brake))
        return max(d, 5.0)  # floor at one car length

    def calc_ideal_driving_speed(self) -> float:
        accel = 0.0
        self.fcw = False
        self.aeb = False
        if self.is_cipo_present:
            d_safe = self.calc_safe_rss_distance()
            d = self.cipo_distance
            if d >= d_safe * 1.1:
                accel = 1.0
            elif d_safe * 0.5 <= d <= d_safe * 0.9:
                accel = -1.0
            elif d_safe * 0.25 <= d < d_safe * 0.5:
                accel = -2.5
                self.fcw = True
            elif d < d_safe * 0.25:
                accel = -5.0
                self.fcw = True
                self.aeb = True
            # 0.9..1.1 band: hold speed
        else:
            accel = 1.0
        set_speed = self.ego_speed + accel * 0.5  # 0.5 s look-ahead
        return max(0.0, min(set_speed, self.speed_limit))

    def get_fcw_state(self) -> bool:
        return self.fcw

    def get_aeb_state(self) -> bool:
        return self.aeb
