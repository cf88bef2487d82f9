"""Robot hardware device abstraction + mocks.

The reference vendors LeRobot's hardware layer (cameras, motor buses,
teleop — lerobot_custom/lerobot/common/robot_devices/, SURVEY.md §2.4) and
its test suite mocks those drivers (tests/cameras/mock_cv2.py etc.). The
CoVer path never touches real hardware; this module provides the same
pattern: Protocol interfaces + deterministic mocks, so policy-serving code
written against `Camera`/`MotorBus` runs in CI and swaps in real drivers
on a robot host.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Protocol, Sequence

import numpy as np


class Camera(Protocol):
    def connect(self) -> None: ...
    def read(self) -> np.ndarray: ...
    def disconnect(self) -> None: ...


class MotorBus(Protocol):
    def connect(self) -> None: ...
    def read_positions(self) -> np.ndarray: ...
    def write_positions(self, positions: np.ndarray) -> None: ...
    def disconnect(self) -> None: ...


class MockCamera:
    """Deterministic synthetic frames (mock_cv2/mock_pyrealsense2 pattern)."""

    def __init__(self, width: int = 256, height: int = 256, seed: int = 0):
        self.width, self.height = width, height
        self._rng = np.random.default_rng(seed)
        self._connected = False
        self._t = 0

    def connect(self):
        self._connected = True

    def read(self) -> np.ndarray:
        if not self._connected:
            raise RuntimeError("camera not connected")
        self._t += 1
        img = np.full((self.height, self.width, 3), 64, np.uint8)
        x = (self._t * 5) % self.width
        img[:, max(0, x - 4):x + 4] = 200
        return img

    def disconnect(self):
        self._connected = False


class MockMotorBus:
    """First-order servo dynamics toward commanded positions
    (mock_dynamixel_sdk pattern)."""

    def __init__(self, num_motors: int = 7, alpha: float = 0.5):
        self.num_motors = num_motors
        self.alpha = alpha
        self._pos = np.zeros(num_motors)
        self._target = np.zeros(num_motors)
        self._connected = False

    def connect(self):
        self._connected = True

    def read_positions(self) -> np.ndarray:
        if not self._connected:
            raise RuntimeError("bus not connected")
        self._pos = self._pos + self.alpha * (self._target - self._pos)
        return self._pos.copy()

    def write_positions(self, positions: np.ndarray):
        if not self._connected:
            raise RuntimeError("bus not connected")
        self._target = np.asarray(positions, np.float64).copy()

    def disconnect(self):
        self._connected = False


class RobotInterface:
    """Minimal robot composed of named cameras + a motor bus."""

    def __init__(self, cameras: Dict[str, Camera], bus: MotorBus):
        self.cameras = cameras
        self.bus = bus

    def connect(self):
        for c in self.cameras.values():
            c.connect()
        self.bus.connect()

    def observe(self) -> Dict:
        return {"images": {k: c.read() for k, c in self.cameras.items()},
                "positions": self.bus.read_positions()}

    def act(self, positions: np.ndarray):
        self.bus.write_positions(positions)

    def disconnect(self):
        for c in self.cameras.values():
            c.disconnect()
        self.bus.disconnect()


def make_mock_robot(num_motors: int = 7) -> RobotInterface:
    return RobotInterface({"top": MockCamera()}, MockMotorBus(num_motors))
