"""Punctual light store + IBL configuration.

Mirrors reference behavior: crates/renderer/src/lights.rs (slotmap of
directional/point/spot lights packed densely into a 64-byte-per-light
storage buffer with an enum tag, plus a small info uniform with light
count and IBL mip counts; lights/ibl.rs holds prefiltered/irradiance
cubemaps + BRDF LUT). Here lights pack into a (cap, 16) f32 array; the
active count is a scalar; IBL arrays live on the scene's environment.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict

import numpy as np

from ..errors import LightError
from ..utils.allocator import SlotAllocator

F = np.float32

# packed light layout, 16 f32 per light (reference: lights.rs BYTE_SIZE=64)
L_KIND = 0          # 0 directional, 1 point, 2 spot
L_COLOR = 1         # 3 (already multiplied by intensity)
L_INTENSITY = 4
L_POSITION = 5      # 3
L_DIRECTION = 8     # 3
L_RANGE = 11        # 0 => unlimited
L_INNER_COS = 12
L_OUTER_COS = 13
LIGHT_F32 = 16


class LightKind(enum.Enum):
    DIRECTIONAL = 0
    POINT = 1
    SPOT = 2


@dataclass
class Light:
    """Reference: lights.rs:315 Light enum, flattened."""

    kind: LightKind
    color: np.ndarray = field(default_factory=lambda: np.ones(3, dtype=F))
    intensity: float = 1.0
    position: np.ndarray = field(default_factory=lambda: np.zeros(3, dtype=F))
    direction: np.ndarray = field(default_factory=lambda: np.array([0, 0, -1], dtype=F))
    range: float = 0.0
    inner_cone_angle: float = 0.0
    outer_cone_angle: float = np.pi / 4

    @staticmethod
    def directional(direction, color=(1, 1, 1), intensity=1.0) -> "Light":
        d = np.asarray(direction, dtype=F)
        return Light(LightKind.DIRECTIONAL, np.asarray(color, F), intensity, direction=d / np.linalg.norm(d))

    @staticmethod
    def point(position, color=(1, 1, 1), intensity=1.0, range=0.0) -> "Light":
        return Light(LightKind.POINT, np.asarray(color, F), intensity, np.asarray(position, F), range=range)

    @staticmethod
    def spot(position, direction, color=(1, 1, 1), intensity=1.0, range=0.0,
             inner_cone_angle=0.0, outer_cone_angle=np.pi / 4) -> "Light":
        d = np.asarray(direction, dtype=F)
        return Light(LightKind.SPOT, np.asarray(color, F), intensity, np.asarray(position, F),
                     d / np.linalg.norm(d), range, inner_cone_angle, outer_cone_angle)

    def pack(self) -> np.ndarray:
        row = np.zeros(LIGHT_F32, dtype=F)
        row[L_KIND] = self.kind.value
        row[L_COLOR : L_COLOR + 3] = self.color
        row[L_INTENSITY] = self.intensity
        row[L_POSITION : L_POSITION + 3] = self.position
        row[L_DIRECTION : L_DIRECTION + 3] = self.direction
        row[L_RANGE] = self.range
        row[L_INNER_COS] = np.cos(self.inner_cone_angle)
        row[L_OUTER_COS] = np.cos(self.outer_cone_angle)
        return row


class Lights:
    """Dense packed light store (reference: lights.rs:143-478).

    Unlike transforms/materials, lights pack densely (order-independent in
    the shading loop), so removal swaps the last row in — matching the
    reference's dense storage-buffer packing.
    """

    def __init__(self, initial_capacity: int = 16):
        self._alloc = SlotAllocator(initial_capacity)
        self._lights: Dict[int, Light] = {}
        self.gpu_dirty = True

    def insert(self, light: Light) -> int:
        key = self._alloc.insert()
        self._alloc.take_needs_resize()
        self._lights[key] = light
        self.gpu_dirty = True
        return key

    def _check(self, key: int) -> None:
        if key not in self._lights:
            raise LightError(f"unknown or removed light key {key}")

    def update(self, key: int, light: Light) -> None:
        self._check(key)
        self._lights[key] = light
        self.gpu_dirty = True

    def get(self, key: int) -> Light:
        self._check(key)
        return self._lights[key]

    def remove(self, key: int) -> None:
        self._check(key)
        del self._lights[key]
        self._alloc.remove(key)
        self.gpu_dirty = True

    @property
    def count(self) -> int:
        return len(self._lights)

    def packed(self, capacity: int) -> np.ndarray:
        """Dense (capacity, LIGHT_F32) array; rows beyond count are zero."""
        out = np.zeros((capacity, LIGHT_F32), dtype=F)
        for i, (_, light) in enumerate(sorted(self._lights.items())):
            out[i] = light.pack()
        return out
