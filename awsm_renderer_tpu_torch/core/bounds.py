"""Axis-aligned bounding boxes.

Mirrors reference behavior: crates/renderer/src/bounds.rs:7-60
(Aabb { min, max }, extend, transform-by-mat4).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

F = np.float32


@dataclass
class Aabb:
    min: np.ndarray  # (3,) f32
    max: np.ndarray  # (3,) f32

    @staticmethod
    def from_points(points: np.ndarray) -> "Aabb":
        points = np.asarray(points, dtype=F).reshape(-1, 3)
        return Aabb(points.min(axis=0), points.max(axis=0))

    @staticmethod
    def empty() -> "Aabb":
        return Aabb(np.full(3, np.inf, dtype=F), np.full(3, -np.inf, dtype=F))

    def extend(self, other: "Aabb") -> "Aabb":
        return Aabb(np.minimum(self.min, other.min), np.maximum(self.max, other.max))

    def transform(self, m: np.ndarray) -> "Aabb":
        """Transform by a mat4; result is the AABB of the 8 transformed corners."""
        corners = np.array(
            [
                [x, y, z, 1.0]
                for x in (self.min[0], self.max[0])
                for y in (self.min[1], self.max[1])
                for z in (self.min[2], self.max[2])
            ],
            dtype=F,
        )
        world = (m @ corners.T).T[:, :3]
        return Aabb(world.min(axis=0).astype(F), world.max(axis=0).astype(F))

    def center(self) -> np.ndarray:
        return (self.min + self.max) * 0.5

    def is_valid(self) -> bool:
        return bool(np.all(self.min <= self.max))
