"""Material store: PBR metallic-roughness (with glTF extensions) and unlit.

Mirrors reference behavior: crates/renderer/src/materials.rs (key-based
store, packed uniform bytes, alpha modes, transparency-pass routing) and
materials/pbr.rs:13-258 (full extension set). Packing here is SoA device
arrays instead of a byte-packed uniform buffer:

- ``float_data`` (cap, NUM_F32): factor/scalar parameters
- ``tex_slots``  (cap, NUM_TEX_SLOTS, 3) i32: [texture_id, uv_set, transform_id]
- ``flags``      (cap, NUM_I32) i32: kind / alpha mode / double-sided / debug
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

from ..errors import MaterialError

from ..utils.allocator import SlotAllocator

F = np.float32

# ---- float layout ----------------------------------------------------------
MF_BASE_COLOR = 0           # 4
MF_METALLIC = 4
MF_ROUGHNESS = 5
MF_NORMAL_SCALE = 6
MF_OCCLUSION_STRENGTH = 7
MF_EMISSIVE = 8             # 3
MF_EMISSIVE_STRENGTH = 11
MF_ALPHA_CUTOFF = 12
MF_IOR = 13
MF_CLEARCOAT = 14
MF_CLEARCOAT_ROUGHNESS = 15
MF_CLEARCOAT_NORMAL_SCALE = 16
MF_SHEEN_COLOR = 17         # 3
MF_SHEEN_ROUGHNESS = 20
MF_TRANSMISSION = 21
MF_THICKNESS = 22
MF_ATTENUATION_DISTANCE = 23
MF_ATTENUATION_COLOR = 24   # 3
MF_SPECULAR_COLOR = 27      # 3
MF_SPECULAR = 30
MF_IRIDESCENCE = 31
MF_IRIDESCENCE_IOR = 32
MF_IRIDESCENCE_THICKNESS_MIN = 33
MF_IRIDESCENCE_THICKNESS_MAX = 34
MF_ANISOTROPY_STRENGTH = 35
MF_ANISOTROPY_ROTATION = 36
MF_DISPERSION = 37
MF_DIFFUSE_TRANSMISSION = 38
MF_DIFFUSE_TRANSMISSION_COLOR = 39  # 3
# editor grid material params (KIND_GRID; editor/src/grid parity)
MF_GRID_SPACING = 44
MF_GRID_MAJOR_EVERY = 45
MF_GRID_FADE_DISTANCE = 46
NUM_F32 = 48

# ---- texture slots ---------------------------------------------------------
TS_BASE_COLOR = 0
TS_METALLIC_ROUGHNESS = 1
TS_NORMAL = 2
TS_OCCLUSION = 3
TS_EMISSIVE = 4
TS_CLEARCOAT = 5
TS_CLEARCOAT_ROUGHNESS = 6
TS_CLEARCOAT_NORMAL = 7
TS_SHEEN_COLOR = 8
TS_SHEEN_ROUGHNESS = 9
TS_TRANSMISSION = 10
TS_THICKNESS = 11
TS_SPECULAR = 12
TS_SPECULAR_COLOR = 13
TS_IRIDESCENCE = 14
TS_IRIDESCENCE_THICKNESS = 15
TS_ANISOTROPY = 16
TS_DIFFUSE_TRANSMISSION = 17
TS_DIFFUSE_TRANSMISSION_COLOR = 18
NUM_TEX_SLOTS = 20

# ---- int flags -------------------------------------------------------------
MI_KIND = 0          # 0 = pbr, 1 = unlit  (reference shader_id discriminant)
MI_ALPHA_MODE = 1    # 0 opaque, 1 mask, 2 blend
MI_DOUBLE_SIDED = 2
MI_DEBUG_MASK = 3    # reference: materials/pbr.rs:54-79 per-channel debug bits
NUM_I32 = 8

KIND_PBR = 0
KIND_UNLIT = 1
KIND_GRID = 2  # editor grid (crates/editor/src/grid/shaders/grid.wgsl parity)


class AlphaMode(enum.Enum):
    """Reference: materials.rs:255 MaterialAlphaMode."""

    OPAQUE = 0
    MASK = 1
    BLEND = 2


class PbrDebug(enum.IntFlag):
    """Per-material debug visualization bits for ``debug_mask``
    (reference: materials/pbr.rs:53-77 PbrMaterialDebug::bitmask;
    consumed by the shading path's ``material`` debug variant,
    pbr_material_color.wgsl:30-51 — lowest set bit wins)."""

    NONE = 0
    BASE_COLOR = 1 << 0
    METALLIC_ROUGHNESS = 1 << 1
    NORMALS = 1 << 2
    OCCLUSION = 1 << 3
    EMISSIVE = 1 << 4
    SPECULAR = 1 << 5


@dataclass
class TextureRef:
    """A bound texture: descriptor id + uv set + optional KHR_texture_transform id."""

    texture_id: int
    uv_set: int = 0
    transform_id: int = -1


@dataclass
class PbrMaterial:
    """glTF PBR metallic-roughness + extension factors.

    Reference: materials/pbr.rs:13-180.
    """

    base_color_factor: np.ndarray = field(default_factory=lambda: np.ones(4, dtype=F))
    metallic_factor: float = 1.0
    roughness_factor: float = 1.0
    normal_scale: float = 1.0
    occlusion_strength: float = 1.0
    emissive_factor: np.ndarray = field(default_factory=lambda: np.zeros(3, dtype=F))
    emissive_strength: float = 1.0
    alpha_mode: AlphaMode = AlphaMode.OPAQUE
    alpha_cutoff: float = 0.5
    double_sided: bool = False
    ior: float = 1.5
    # extensions (defaults = extension absent)
    clearcoat_factor: float = 0.0
    clearcoat_roughness: float = 0.0
    clearcoat_normal_scale: float = 1.0
    sheen_color: np.ndarray = field(default_factory=lambda: np.zeros(3, dtype=F))
    sheen_roughness: float = 0.0
    transmission_factor: float = 0.0
    thickness: float = 0.0
    attenuation_distance: float = 0.0  # 0 => +inf
    attenuation_color: np.ndarray = field(default_factory=lambda: np.ones(3, dtype=F))
    specular_factor: float = 1.0
    specular_color: np.ndarray = field(default_factory=lambda: np.ones(3, dtype=F))
    iridescence_factor: float = 0.0
    iridescence_ior: float = 1.3
    iridescence_thickness_min: float = 100.0
    iridescence_thickness_max: float = 400.0
    anisotropy_strength: float = 0.0
    anisotropy_rotation: float = 0.0
    dispersion: float = 0.0
    diffuse_transmission_factor: float = 0.0
    diffuse_transmission_color: np.ndarray = field(default_factory=lambda: np.ones(3, dtype=F))
    debug_mask: int = 0
    textures: Dict[int, TextureRef] = field(default_factory=dict)  # slot -> ref

    def pack(self):
        f = np.zeros(NUM_F32, dtype=F)
        f[MF_BASE_COLOR : MF_BASE_COLOR + 4] = self.base_color_factor
        f[MF_METALLIC] = self.metallic_factor
        f[MF_ROUGHNESS] = self.roughness_factor
        f[MF_NORMAL_SCALE] = self.normal_scale
        f[MF_OCCLUSION_STRENGTH] = self.occlusion_strength
        f[MF_EMISSIVE : MF_EMISSIVE + 3] = self.emissive_factor
        f[MF_EMISSIVE_STRENGTH] = self.emissive_strength
        f[MF_ALPHA_CUTOFF] = self.alpha_cutoff
        f[MF_IOR] = self.ior
        f[MF_CLEARCOAT] = self.clearcoat_factor
        f[MF_CLEARCOAT_ROUGHNESS] = self.clearcoat_roughness
        f[MF_CLEARCOAT_NORMAL_SCALE] = self.clearcoat_normal_scale
        f[MF_SHEEN_COLOR : MF_SHEEN_COLOR + 3] = self.sheen_color
        f[MF_SHEEN_ROUGHNESS] = self.sheen_roughness
        f[MF_TRANSMISSION] = self.transmission_factor
        f[MF_THICKNESS] = self.thickness
        f[MF_ATTENUATION_DISTANCE] = self.attenuation_distance
        f[MF_ATTENUATION_COLOR : MF_ATTENUATION_COLOR + 3] = self.attenuation_color
        f[MF_SPECULAR_COLOR : MF_SPECULAR_COLOR + 3] = self.specular_color
        f[MF_SPECULAR] = self.specular_factor
        f[MF_IRIDESCENCE] = self.iridescence_factor
        f[MF_IRIDESCENCE_IOR] = self.iridescence_ior
        f[MF_IRIDESCENCE_THICKNESS_MIN] = self.iridescence_thickness_min
        f[MF_IRIDESCENCE_THICKNESS_MAX] = self.iridescence_thickness_max
        f[MF_ANISOTROPY_STRENGTH] = self.anisotropy_strength
        f[MF_ANISOTROPY_ROTATION] = self.anisotropy_rotation
        f[MF_DISPERSION] = self.dispersion
        f[MF_DIFFUSE_TRANSMISSION] = self.diffuse_transmission_factor
        f[MF_DIFFUSE_TRANSMISSION_COLOR : MF_DIFFUSE_TRANSMISSION_COLOR + 3] = (
            self.diffuse_transmission_color
        )

        slots = np.full((NUM_TEX_SLOTS, 3), -1, dtype=np.int32)
        for slot, ref in self.textures.items():
            slots[slot] = (ref.texture_id, ref.uv_set, ref.transform_id)

        flags = np.zeros(NUM_I32, dtype=np.int32)
        flags[MI_KIND] = KIND_PBR
        flags[MI_ALPHA_MODE] = self.alpha_mode.value
        flags[MI_DOUBLE_SIDED] = int(self.double_sided)
        flags[MI_DEBUG_MASK] = self.debug_mask
        return f, slots, flags

    def is_transparency_pass(self) -> bool:
        """Reference routing: Blend AND Mask go through the forward
        transparent pass (gltf/buffers/mesh.rs:43 maps AlphaMode::Mask to
        the Transparency geometry kind — discard needs a fragment stage),
        as does transmission."""
        return self.alpha_mode != AlphaMode.OPAQUE or self.transmission_factor > 0.0


@dataclass
class UnlitMaterial:
    """Reference: materials/unlit.rs."""

    base_color_factor: np.ndarray = field(default_factory=lambda: np.ones(4, dtype=F))
    alpha_mode: AlphaMode = AlphaMode.OPAQUE
    alpha_cutoff: float = 0.5
    double_sided: bool = False
    debug_mask: int = 0
    textures: Dict[int, TextureRef] = field(default_factory=dict)

    def pack(self):
        f = np.zeros(NUM_F32, dtype=F)
        f[MF_BASE_COLOR : MF_BASE_COLOR + 4] = self.base_color_factor
        f[MF_ALPHA_CUTOFF] = self.alpha_cutoff
        slots = np.full((NUM_TEX_SLOTS, 3), -1, dtype=np.int32)
        for slot, ref in self.textures.items():
            slots[slot] = (ref.texture_id, ref.uv_set, ref.transform_id)
        flags = np.zeros(NUM_I32, dtype=np.int32)
        flags[MI_KIND] = KIND_UNLIT
        flags[MI_ALPHA_MODE] = self.alpha_mode.value
        flags[MI_DOUBLE_SIDED] = int(self.double_sided)
        flags[MI_DEBUG_MASK] = self.debug_mask
        return f, slots, flags

    def is_transparency_pass(self) -> bool:
        return self.alpha_mode != AlphaMode.OPAQUE


@dataclass
class GridMaterial:
    """Infinite editor grid (reference: crates/editor/src/grid/ — own WGSL
    pipeline drawn via a render hook; here a procedural material kind on a
    large ground plane, routed through the transparent pass so gaps show
    the scene)."""

    color: np.ndarray = field(default_factory=lambda: np.array([0.55, 0.55, 0.6, 1.0], dtype=F))
    spacing: float = 1.0
    major_every: float = 10.0
    fade_distance: float = 60.0
    double_sided: bool = True

    def pack(self):
        f = np.zeros(NUM_F32, dtype=F)
        f[MF_BASE_COLOR : MF_BASE_COLOR + 4] = self.color
        f[MF_GRID_SPACING] = self.spacing
        f[MF_GRID_MAJOR_EVERY] = self.major_every
        f[MF_GRID_FADE_DISTANCE] = self.fade_distance
        slots = np.full((NUM_TEX_SLOTS, 3), -1, dtype=np.int32)
        flags = np.zeros(NUM_I32, dtype=np.int32)
        flags[MI_KIND] = KIND_GRID
        flags[MI_ALPHA_MODE] = AlphaMode.BLEND.value
        flags[MI_DOUBLE_SIDED] = 1
        return f, slots, flags

    def is_transparency_pass(self) -> bool:
        return True


class Materials:
    """Key-based material store (reference: materials.rs:85-320)."""

    def __init__(self, initial_capacity: int = 32):
        self._alloc = SlotAllocator(initial_capacity)
        self._resize(initial_capacity)
        self._materials: Dict[int, object] = {}
        self.gpu_dirty = True

    @property
    def gpu_dirty(self) -> bool:
        return self._gpu_dirty

    @gpu_dirty.setter
    def gpu_dirty(self, v: bool) -> None:
        # monotonic version for host-side derived-state caches (renderer
        # per-frame prep memo); bumps on every dirtying mutation
        self._gpu_dirty = bool(v)
        if v:
            self.mutation_count = getattr(self, "mutation_count", 0) + 1

    def _resize(self, capacity: int) -> None:
        self.float_data = np.zeros((capacity, NUM_F32), dtype=F)
        self.tex_slots = np.full((capacity, NUM_TEX_SLOTS, 3), -1, dtype=np.int32)
        self.flags = np.zeros((capacity, NUM_I32), dtype=np.int32)

    def insert(self, material) -> int:
        key = self._alloc.insert()
        if self._alloc.take_needs_resize():
            old = (self.float_data, self.tex_slots, self.flags)
            self._resize(self._alloc.capacity)
            n = old[0].shape[0]
            self.float_data[:n], self.tex_slots[:n], self.flags[:n] = old
        self._materials[key] = material
        self._write(key)
        return key

    def update(self, key: int, material) -> None:
        self._materials[key] = material
        self._write(key)

    def get(self, key: int):
        try:
            return self._materials[key]
        except KeyError:
            raise MaterialError(
                f"unknown or removed material key {key}") from None

    def remove(self, key: int) -> None:
        del self._materials[key]
        self._alloc.remove(key)

    def row_of(self, key: int) -> int:
        return self._alloc.row_of(key)

    @property
    def capacity(self) -> int:
        return self._alloc.capacity

    def _write(self, key: int) -> None:
        row = self._alloc.row_of(key)
        f, slots, flags = self._materials[key].pack()
        self.float_data[row] = f
        self.tex_slots[row] = slots
        self.flags[row] = flags
        self.gpu_dirty = True

    def is_transparency_pass(self, key: int) -> bool:
        return self._materials[key].is_transparency_pass()
