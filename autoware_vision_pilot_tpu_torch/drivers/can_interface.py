"""CAN bus interface: live SocketCAN or .asc log replay; the port's own copy
of autoware_vision_pilot_tpu/drivers/can_interface.py (standard library only).

Rebuild of production_release/src/drivers/can_interface.cpp: decodes ego
speed (frame ID 0xA1) and steering angle (0xA4), polled once per captured
frame (main.cpp:427-432). Uses Python's native AF_CAN sockets for live
mode; graceful degradation (missing bus -> can_valid stays False,
main.cpp:1832-1840 contract).
"""
from __future__ import annotations

import dataclasses
import re
import socket
import struct
import time
from pathlib import Path
from typing import List, Optional, Tuple

SPEED_FRAME_ID = 0xA1
STEERING_FRAME_ID = 0xA4


@dataclasses.dataclass
class CanVehicleState:
    speed_ms: float = float("nan")
    steering_angle_deg: float = float("nan")
    valid: bool = False
    timestamp: float = 0.0


def decode_speed(data: bytes) -> float:
    """Speed little-endian uint16 in 0.01 m/s at bytes 0..2."""
    if len(data) < 2:
        return float("nan")
    return struct.unpack_from("<H", data, 0)[0] * 0.01


def decode_steering(data: bytes) -> float:
    """Steering int16 in 0.1 deg at bytes 0..2."""
    if len(data) < 2:
        return float("nan")
    return struct.unpack_from("<h", data, 0)[0] * 0.1


class CanInterface:
    """mode 'live' (SocketCAN) or 'replay' (.asc file)."""

    def __init__(self, interface_name: str = "can0",
                 replay_file: Optional[str] = None):
        self.state = CanVehicleState()
        self._sock = None
        self._replay: List[Tuple[float, int, bytes]] = []
        self._replay_pos = 0
        self._replay_t0 = None
        if replay_file:
            self._load_asc(replay_file)
        else:
            try:
                s = socket.socket(socket.AF_CAN, socket.SOCK_RAW,
                                  socket.CAN_RAW)
                s.bind((interface_name,))
                s.setblocking(False)
                self._sock = s
            except OSError as e:
                print(f"[can] cannot open {interface_name}: {e} — "
                      "continuing without CAN")

    @property
    def ok(self) -> bool:
        return self._sock is not None or bool(self._replay)

    def _load_asc(self, path: str):
        """Vector .asc line format: '<time> <chan> <id> Rx d <len> <b0> ...'"""
        pat = re.compile(
            r"^\s*([\d.]+)\s+\d+\s+([0-9A-Fa-f]+)x?\s+Rx\s+d\s+(\d+)((?:\s+[0-9A-Fa-f]{1,2})*)")
        for line in Path(path).read_text().splitlines():
            m = pat.match(line)
            if not m:
                continue
            t = float(m.group(1))
            can_id = int(m.group(2), 16)
            data = bytes(int(b, 16) for b in m.group(4).split())
            self._replay.append((t, can_id, data))
        self._replay.sort(key=lambda r: r[0])

    def _apply(self, can_id: int, data: bytes):
        if can_id == SPEED_FRAME_ID:
            self.state.speed_ms = decode_speed(data)
        elif can_id == STEERING_FRAME_ID:
            self.state.steering_angle_deg = decode_steering(data)
        self.state.timestamp = time.monotonic()
        self.state.valid = not (self.state.speed_ms != self.state.speed_ms)

    def update(self):
        """Drain pending frames (live) or replay frames up to now."""
        if self._sock is not None:
            while True:
                try:
                    frame = self._sock.recv(16)
                except BlockingIOError:
                    break
                except OSError:
                    break
                can_id, length = struct.unpack_from("<IB3x", frame)
                can_id &= socket.CAN_EFF_MASK
                self._apply(can_id, frame[8:8 + length])
        elif self._replay:
            now = time.monotonic()
            if self._replay_t0 is None:
                self._replay_t0 = now - self._replay[0][0]
            t_rel = now - self._replay_t0
            while (self._replay_pos < len(self._replay)
                   and self._replay[self._replay_pos][0] <= t_rel):
                _, can_id, data = self._replay[self._replay_pos]
                self._apply(can_id, data)
                self._replay_pos += 1

    def get_state(self) -> CanVehicleState:
        return self.state
