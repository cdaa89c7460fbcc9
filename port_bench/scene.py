"""The benchmark's scene description: plain numpy data that a
configuration builds from the seed and hands, unchanged, to both sides.

The program receives it through its public API (program.py, or a
configuration's own loader); the plain reference (reference/) renders it
directly. Nothing here imports the program.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

F = np.float32

# texture slots a material may bind (the glTF metallic-roughness set)
SLOTS = ("base", "mr", "normal", "occlusion", "emissive")


@dataclass
class Texture:
    """An 8-bit RGBA image as the asset holds it. srgb: the colour
    channels are sRGB-encoded (base colour, emissive); kind selects the
    mip filter: "color", "normal" (renormalized), "mr" (roughness
    averaged as r^2) or "scalar"."""

    image: np.ndarray
    srgb: bool
    kind: str


@dataclass
class Material:
    """kind "pbr" is glTF metallic-roughness; "unlit" shows its base
    colour; "grid" is the editor's ground grid, its base colour under a
    line alpha worked out from `grid` (spacing, major_every,
    fade_distance) in the alpha-blended layers."""

    base_color: np.ndarray
    metallic: float
    roughness: float
    emissive: np.ndarray = field(default_factory=lambda: np.zeros(3, F))
    occlusion_strength: float = 1.0
    normal_scale: float = 1.0
    alpha_mode: str = "opaque"          # "opaque" | "blend"
    textures: Dict[str, int] = field(default_factory=dict)
    kind: str = "pbr"                   # "pbr" | "unlit" | "grid"
    grid: Dict[str, float] = field(default_factory=dict)


@dataclass
class Mesh:
    """One mesh instance: model-space vertex data and its world matrix.
    hud: drawn by the HUD pass, over everything, with its own depth."""

    positions: np.ndarray               # (V, 3)
    normals: np.ndarray                 # (V, 3)
    uv0: np.ndarray                     # (V, 2)
    tangents: np.ndarray                # (V, 4), w = handedness
    indices: np.ndarray                 # (T, 3)
    world: np.ndarray                   # (4, 4)
    material: int
    transparent: bool = False
    double_sided: bool = False
    hud: bool = False


@dataclass
class Light:
    kind: str                           # "directional" | "point"
    color: np.ndarray
    intensity: float
    position: np.ndarray = field(default_factory=lambda: np.zeros(3, F))
    direction: np.ndarray = field(default_factory=lambda: np.zeros(3, F))
    range: float = 0.0


@dataclass
class Scene:
    meshes: List[Mesh]
    materials: List[Material]
    textures: List[Texture]
    lights: List[Light]
    env_equirect: np.ndarray            # (h, w, 3) linear
    env_size: int
    settings: dict                      # the configuration's "render" group
    camera: dict                        # the configuration's "camera" group
    meta: dict = field(default_factory=dict)

    def triangles(self, transparent: Optional[bool] = None) -> int:
        return sum(int(m.indices.shape[0]) for m in self.meshes
                   if transparent is None or m.transparent == transparent)

    def opaque_slots(self) -> int:
        """Texture slots bound by any opaque mesh's material."""
        used = set()
        for m in self.meshes:
            if not m.transparent:
                used |= set(self.materials[m.material].textures)
        return len(used)


def translation(t) -> np.ndarray:
    m = np.eye(4, dtype=F)
    m[:3, 3] = np.asarray(t, F)
    return m


def look_at(eye, center, up) -> np.ndarray:
    """Right-handed view matrix (f32)."""
    eye = np.asarray(eye, np.float64)
    f = np.asarray(center, np.float64) - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, np.asarray(up, np.float64))
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4, dtype=F)
    m[0, :3], m[1, :3], m[2, :3] = s, u, -f
    m[0, 3] = -np.dot(s, eye)
    m[1, 3] = -np.dot(u, eye)
    m[2, 3] = np.dot(f, eye)
    return m


def perspective(fovy: float, aspect: float, near: float,
                far: float) -> np.ndarray:
    """Right-handed perspective, depth in [0, 1] (f32)."""
    f = 1.0 / np.tan(fovy / 2.0)
    m = np.zeros((4, 4), F)
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 2] = far / (near - far)
    m[2, 3] = near * far / (near - far)
    m[3, 2] = -1.0
    return m
