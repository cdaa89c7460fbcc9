"""Mesh store: corner-major exploded geometry pools + per-mesh records.

Mirrors reference behavior: crates/renderer/src/meshes.rs (mesh store over
shared geometry GPU buffers with buddy allocation, refcounted MeshResource
sharing, per-mesh meta) + meshes/morphs.rs (global morph weight/value
buffers) + meshes/meta.rs (per-mesh geometry/material meta).

TPU-first redesign notes (v2):
- Geometry is stored EXPLODED per triangle corner (c_* arrays of length
  3 * triangle_capacity), the same layout the reference bakes into its
  52-byte visibility vertices (gltf/buffers/mesh/visibility.rs) — because
  on TPU an indexed gather is the slowest primitive while a contiguous
  reshape is free. The vertex stage reads corners with zero gathers.
- Morph deltas stay per-ORIGINAL-vertex in a shared pool; corners point
  at their row via c_morph_base (no delta duplication).
- MeshResource sharing keeps the CPU-side exploded arrays once; each mesh
  instance stamps its own triangle range (per-instance corner duplication
  on device, the price of gather-free vertex fetch).
- Pools are capacity-padded numpy mirrors of device arrays; growth doubles
  capacity (a recompile trigger, like the reference's buffer-resize →
  bind-group-recreate events).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..errors import InstanceError, MeshError
from ..utils.allocator import BuddyAllocator, SlotAllocator
from .bounds import Aabb

F = np.float32
I = np.int32


def _ro_view(a: np.ndarray) -> np.ndarray:
    """Read-only view: callers of world_bounds() must not (and now
    cannot) mutate the live cache that update_world patches in place."""
    v = a.view()
    v.flags.writeable = False
    return v

# mesh_info i32 columns (device-side per-mesh meta, analog of MeshMeta:
# reference meshes/meta.rs GeometryMeshMeta + MaterialMeshMeta)
MI_TRANSFORM_ROW = 0
MI_MATERIAL_ROW = 1
MI_FLAGS = 2
MI_N_MORPH_TARGETS = 3
MI_MORPH_STRIDE = 4       # vertex count of the resource (targets step by this)
MI_SKIN_SETS = 5          # number of 4-joint influence sets (0 = unskinned)
MESH_INFO_I32 = 8

# flag bits
MESH_FLAG_HIDDEN = 1
MESH_FLAG_HUD = 2
MESH_FLAG_DOUBLE_SIDED = 4
MESH_FLAG_TRANSPARENT = 8

MAX_MORPH_TARGETS = 8  # INITIAL morph bucket; the weights table widens in
                       # pow2 buckets to the scene's max target count, and
                       # the vertex stage unrolls to the table width — so
                       # arbitrary N is supported (reference morph.wgsl
                       # unrolls then loops); a width change is a shape
                       # change, which re-specializes the frame jit.
MAX_SKIN_SETS = 2      # INITIAL joint-influence-set bucket (JOINTS_0/1);
                       # like the morph bucket, the corner joint/weight
                       # pools widen in pow2 set buckets to the scene's
                       # max (reference skins.rs handles arbitrary sets),
                       # re-specializing the frame jit on change.


@dataclass
class MeshGeometry:
    """CPU-side geometry for one primitive (indexed; exploded at insert).

    The glTF pipeline produces this (analog of the reference's
    gltf/buffers.rs conversion output).
    """

    positions: np.ndarray                      # (V, 3) f32
    indices: np.ndarray                        # (T, 3) i32 (triangle list)
    normals: Optional[np.ndarray] = None       # (V, 3)
    tangents: Optional[np.ndarray] = None      # (V, 4)
    uv0: Optional[np.ndarray] = None           # (V, 2)
    uv1: Optional[np.ndarray] = None           # (V, 2)
    color0: Optional[np.ndarray] = None        # (V, 4)
    joints: Optional[np.ndarray] = None        # (V, 4*S) local joint indices
    weights: Optional[np.ndarray] = None       # (V, 4*S) f32
    # morph targets: (M, V, 3) each; tangent deltas are xyz only
    morph_positions: Optional[np.ndarray] = None
    morph_normals: Optional[np.ndarray] = None
    morph_tangents: Optional[np.ndarray] = None
    aabb: Optional[Aabb] = None

    def __post_init__(self):
        self.positions = np.ascontiguousarray(self.positions, dtype=F).reshape(-1, 3)
        self.indices = np.ascontiguousarray(self.indices, dtype=I).reshape(-1, 3)
        if self.aabb is None:
            self.aabb = Aabb.from_points(self.positions)

    @property
    def vertex_count(self) -> int:
        return self.positions.shape[0]

    @property
    def triangle_count(self) -> int:
        return self.indices.shape[0]

    @property
    def morph_target_count(self) -> int:
        return 0 if self.morph_positions is None else self.morph_positions.shape[0]


@dataclass
class _Resource:
    """Refcounted shared geometry (reference: meshes.rs:303 MeshResource).

    Keeps the CPU-side exploded corner arrays; device corner pools get a
    copy per mesh instance.

    convex: the indexed geometry was VERIFIED convex with outward-wound
    faces at insert (_is_convex) — every ray then crosses at most one
    front-facing fragment, which lets the renderer prove a static upper
    bound on transparent depth complexity (the K-layer peel clamp,
    renderer._transparent_layer_bound). False = unverified (concave,
    degenerate, or too large to test), never unsafe."""

    tri_count: int
    vertex_count: int
    n_morph_targets: int
    morph_base: int  # row into morph pool, -1 if none
    skin_sets: int
    aabb: Aabb
    corners: Dict[str, np.ndarray] = field(default_factory=dict)
    refcount: int = 0
    convex: bool = False


def _is_convex(positions: np.ndarray, indices: np.ndarray,
               budget: int = 4_000_000) -> bool:
    """True iff every vertex lies on or behind every face's plane, with
    faces wound so their geometric normal points OUTWARD — the mesh
    surface then lies on a convex body and any ray sees <= 1
    front-facing fragment (backface culling removes the rest). O(T*V);
    meshes past `budget` products return False (unverified)."""
    T = indices.shape[0]
    V = positions.shape[0]
    if T == 0 or T * V > budget:
        return False
    p = np.asarray(positions, np.float64)
    a = p[indices[:, 0]]
    n = np.cross(p[indices[:, 1]] - a, p[indices[:, 2]] - a)   # (T, 3)
    norm = np.linalg.norm(n, axis=1)
    keep = norm > 1e-12
    if not keep.any():
        return False
    ext = float(np.linalg.norm(p.max(0) - p.min(0))) or 1.0
    # signed distance of every vertex to every kept face plane
    d = p @ n[keep].T - np.sum(a[keep] * n[keep], axis=1)[None, :]
    eps = 1e-6 * ext * norm[keep][None, :]
    return bool((d <= eps).all())


@dataclass
class _Mesh:
    """Reference: meshes/mesh.rs Mesh record."""

    resource_key: int
    transform_key: int
    material_key: int
    t_base: int               # -1 for instanced-group members (no pool rows)
    t_count: int
    double_sided: bool = False
    transparent: bool = False
    hud: bool = False
    hidden: bool = False
    skin_key: Optional[int] = None
    inst_gid: Optional[int] = None   # instanced-group id, None = pooled
    world_aabb: Aabb = field(default_factory=Aabb.empty)


@dataclass
class _InstGroup:
    """Shared-geometry instanced draw (reference: instances.rs:22-203 —
    one vertex buffer of instance transforms, ONE copy of the geometry).

    TPU-first shape: the resource's corner data is stored (and uploaded)
    ONCE in component-major layout; at trace time the frame tiles it
    across instances (an XLA broadcast the consumers fuse — no
    materialized duplication in HBM) and the per-instance world matrices
    ride the normal one-hot transform fetch via per-instance mesh rows.
    Each instance keeps its own mesh record, so frustum culling, masks
    and picking stay per-instance."""

    resource_key: int
    corners: Dict[str, np.ndarray]   # component-major (3c, Tp) device layout
    livemask: np.ndarray             # (Tp,) bool — False on pad rows
    tri_count: int                   # live triangles per instance
    mesh_keys: List[int] = field(default_factory=list)
    dirty: bool = True


def _grow(arr: np.ndarray, capacity: int, fill=0) -> np.ndarray:
    out = np.full((capacity,) + arr.shape[1:], fill, dtype=arr.dtype)
    out[: arr.shape[0]] = arr
    return out


class Meshes:
    def __init__(self, triangle_capacity: int = 1 << 12,
                 mesh_capacity: int = 64, morph_capacity: int = 256):
        self._t_alloc = BuddyAllocator(triangle_capacity, min_block=64)
        self._m_alloc = BuddyAllocator(morph_capacity, min_block=64)
        self._mesh_alloc = SlotAllocator(mesh_capacity)
        self._res_alloc = SlotAllocator(16)

        self._resize_corners(self._t_alloc.capacity)
        mc = self._m_alloc.capacity
        # morph pool: rows of [dpos(3), dnorm(3), dtan(3), pad] = 10 f32
        # (reference: 10 f32/target/vtx, gltf/buffers/morph.rs)
        self.morph_deltas = np.zeros((mc, 10), dtype=F)

        meshc = self._mesh_alloc.capacity
        self.mesh_info = np.zeros((meshc, MESH_INFO_I32), dtype=I)
        self.morph_weights = np.zeros((meshc, MAX_MORPH_TARGETS), dtype=F)

        self._resources: Dict[int, _Resource] = {}
        self._meshes: Dict[int, _Mesh] = {}
        self.uses_vertex_colors = False   # static shading specialization
        self.gpu_dirty = True
        self.capacity_changed = True
        self.morph_pool_dirty = True

        # device-layout tracking for dirty-range flushes (reference:
        # buffer/helpers.rs coalesced dirty ranges). The device corner
        # pools are a compacted gather of host rows; we remember that
        # gather so later edits become range updates instead of a full
        # re-upload (see device_updates).
        self._dev_idx: Optional[np.ndarray] = None   # (extent,) host row per device row
        self._dev_dead: Optional[np.ndarray] = None  # (extent,) bool
        self._dev_spans: Dict[int, Tuple[int, int]] = {}  # mesh key -> (start, stop)
        self._dev_tail = 0          # first free device row (GROUP-aligned)
        self._dev_dead_count = 0
        self._dev_events: List[tuple] = []

        # shared-geometry instanced groups (instances.rs analog)
        self._inst_groups: Dict[int, _InstGroup] = {}
        self._inst_next_gid = 0
        self.inst_groups_changed = False   # a group was created/deleted


    @property
    def gpu_dirty(self) -> bool:
        return self._gpu_dirty

    @gpu_dirty.setter
    def gpu_dirty(self, v: bool) -> None:
        # mutation_count: monotonic version for host-side derived-state
        # caches (renderer per-frame prep memo); bumps on every dirtying
        # mutation, never resets on flush
        self._gpu_dirty = bool(v)
        if v:
            self.mutation_count = getattr(self, "mutation_count", 0) + 1

    def _resize_corners(self, tri_capacity: int) -> None:
        n = 3 * tri_capacity
        sw = (self.c_joints.shape[1] if hasattr(self, "c_joints")
              else 4 * MAX_SKIN_SETS)      # keep a widened skin bucket
        self.c_pos = np.zeros((n, 3), dtype=F)
        self.c_norm = np.zeros((n, 3), dtype=F)
        self.c_tang = np.zeros((n, 4), dtype=F)
        self.c_uv0 = np.zeros((n, 2), dtype=F)
        self.c_uv1 = np.zeros((n, 2), dtype=F)
        self.c_color = np.ones((n, 4), dtype=F)
        self.c_joints = np.zeros((n, sw), dtype=I)
        self.c_weights = np.zeros((n, sw), dtype=F)
        self.c_morph_base = np.full(n, -1, dtype=I)
        self.tri_mesh = np.full(tri_capacity, -1, dtype=I)

    def _ensure_morph_width(self, n_targets: int) -> None:
        """Widen the per-mesh weights table to the next pow2 bucket that
        fits `n_targets` (reference morph.wgsl handles arbitrary N; here
        the static unroll bound is the table width, so widening it is how
        a >bucket mesh gets full morph support)."""
        w = self.morph_weights.shape[1]
        if n_targets <= w:
            return
        new_w = max(MAX_MORPH_TARGETS, 1 << (n_targets - 1).bit_length())
        wide = np.zeros((self.morph_weights.shape[0], new_w), dtype=F)
        wide[:, :w] = self.morph_weights
        self.morph_weights = wide
        self.gpu_dirty = True

    def _ensure_skin_width(self, n_sets: int) -> None:
        """Widen the corner joint/weight pools to the next pow2 bucket of
        influence SETS that fits `n_sets` (reference skins.rs supports
        arbitrary JOINTS_n/WEIGHTS_n sets). The transposed device layout
        changes shape, so the remembered range-update plan is dropped."""
        cur = self.c_joints.shape[1] // 4
        if n_sets <= cur:
            return
        new_sets = max(MAX_SKIN_SETS, 1 << (n_sets - 1).bit_length())
        for name, dt in (("c_joints", I), ("c_weights", F)):
            old = getattr(self, name)
            wide = np.zeros((old.shape[0], 4 * new_sets), dtype=dt)
            wide[:, : old.shape[1]] = old
            setattr(self, name, wide)
        # instanced-group corner blocks are component-major (3*4*S, Tp)
        # and concatenate with the pool on the triangle axis — rebuild
        # them at the new row count (always all-zero: instanced draws
        # exclude skins, see insert_instanced)
        for grp in self._inst_groups.values():
            tp = grp.corners["c_joints"].shape[1]
            grp.corners["c_joints"] = np.zeros((3 * 4 * new_sets, tp), I)
            grp.corners["c_weights"] = np.zeros((3 * 4 * new_sets, tp), F)
        self.capacity_changed = True
        self.invalidate_device()

    def _grow_corners(self) -> None:
        tc = self._t_alloc.capacity
        old = {name: getattr(self, name) for name in (
            "c_pos", "c_norm", "c_tang", "c_uv0", "c_uv1", "c_color",
            "c_joints", "c_weights", "c_morph_base", "tri_mesh")}
        self._resize_corners(tc)
        for name, arr in old.items():
            getattr(self, name)[: arr.shape[0]] = arr
        self.capacity_changed = True

    # ---- resource management (geometry sharing) ---------------------------

    def insert_resource(self, geo: MeshGeometry) -> int:
        """Convert geometry to exploded corner arrays; returns resource key."""
        V, T = geo.vertex_count, geo.triangle_count
        idx = geo.indices.reshape(-1)                       # (3T,)

        corners: Dict[str, np.ndarray] = {"pos": geo.positions[idx]}
        corners["norm"] = (np.asarray(geo.normals, F).reshape(V, 3)[idx]
                           if geo.normals is not None else np.zeros((3 * T, 3), F))
        if geo.tangents is not None:
            corners["tang"] = np.asarray(geo.tangents, F).reshape(V, 4)[idx]
        else:
            corners["tang"] = np.tile(np.array([1, 0, 0, 1], F), (3 * T, 1))
        corners["uv0"] = (np.asarray(geo.uv0, F).reshape(V, 2)[idx]
                          if geo.uv0 is not None else np.zeros((3 * T, 2), F))
        corners["uv1"] = (np.asarray(geo.uv1, F).reshape(V, 2)[idx]
                          if geo.uv1 is not None else np.zeros((3 * T, 2), F))
        corners["color"] = (np.asarray(geo.color0, F).reshape(V, 4)[idx]
                            if geo.color0 is not None else np.ones((3 * T, 4), F))
        if geo.color0 is not None:
            self.uses_vertex_colors = True

        skin_sets = 0
        if geo.joints is not None and geo.weights is not None:
            j = np.asarray(geo.joints, I).reshape(V, -1)
            w = np.asarray(geo.weights, F).reshape(V, -1)
            # keep EVERY set at natural width; the corner pools widen to
            # fit on insert (_ensure_skin_width — reference skins.rs
            # handles arbitrary JOINTS_n/WEIGHTS_n sets)
            skin_sets = j.shape[1] // 4
            corners["joints"] = j[idx, : skin_sets * 4]
            corners["weights"] = w[idx, : skin_sets * 4]

        # morph targets: shared per-vertex pool; corners point at their row
        M = geo.morph_target_count
        morph_base = -1
        if M:
            self._ensure_morph_width(M)
            morph_base = self._m_alloc.alloc(M * V)
            if self._m_alloc.take_needs_resize():
                self.morph_deltas = _grow(self.morph_deltas, self._m_alloc.capacity)
                self.capacity_changed = True
            rows = np.zeros((M, V, 10), dtype=F)
            rows[:, :, 0:3] = geo.morph_positions[:M]
            if geo.morph_normals is not None:
                rows[:, :, 3:6] = geo.morph_normals[:M]
            if geo.morph_tangents is not None:
                rows[:, :, 6:9] = geo.morph_tangents[:M][..., :3]
            self.morph_deltas[morph_base : morph_base + M * V] = rows.reshape(M * V, 10)
            corners["morph_base"] = (morph_base + idx).astype(I)
            self.gpu_dirty = True
            self.morph_pool_dirty = True

        key = self._res_alloc.insert()
        self._res_alloc.take_needs_resize()
        self._resources[key] = _Resource(
            tri_count=T, vertex_count=V, n_morph_targets=M,
            morph_base=morph_base, skin_sets=skin_sets, aabb=geo.aabb,
            corners=corners,
            # morphed/skinned geometry deforms, so a static convexity
            # proof would not survive animation
            convex=(M == 0 and skin_sets == 0
                    and _is_convex(geo.positions, geo.indices)),
        )
        return key

    # ---- mesh records ------------------------------------------------------

    def insert(self, resource_key: int, transform_row: int, material_row: int,
               transform_key: int, material_key: int, *, double_sided: bool = False,
               transparent: bool = False, hud: bool = False, hidden: bool = False,
               skin_key: Optional[int] = None, skin_joint_rows: Optional[np.ndarray] = None,
               initial_morph_weights: Optional[np.ndarray] = None) -> int:
        """Create a renderable mesh over a resource (reference: meshes.rs:455)."""
        res = self._resources[resource_key]
        T = res.tri_count
        t_base = self._t_alloc.alloc(T)
        if self._t_alloc.take_needs_resize():
            self._grow_corners()

        key = self._mesh_alloc.insert()
        if self._mesh_alloc.take_needs_resize():
            mc = self._mesh_alloc.capacity
            self.mesh_info = _grow(self.mesh_info, mc)
            self.morph_weights = _grow(self.morph_weights, mc)
            self.capacity_changed = True
        row = self._mesh_alloc.row_of(key)

        c = slice(3 * t_base, 3 * (t_base + T))
        cr = res.corners
        self.c_pos[c] = cr["pos"]
        self.c_norm[c] = cr["norm"]
        self.c_tang[c] = cr["tang"]
        self.c_uv0[c] = cr["uv0"]
        self.c_uv1[c] = cr["uv1"]
        self.c_color[c] = cr["color"]
        if "morph_base" in cr:
            self.c_morph_base[c] = cr["morph_base"]
        else:
            self.c_morph_base[c] = -1
        if "joints" in cr:
            self._ensure_skin_width(res.skin_sets)
        if "joints" in cr and skin_joint_rows is not None and res.skin_sets:
            rows = np.asarray(skin_joint_rows, I)
            local = np.clip(cr["joints"], 0, len(rows) - 1)
            self.c_joints[c] = 0
            self.c_joints[c, : res.skin_sets * 4] = rows[local]
            self.c_weights[c] = 0.0
            self.c_weights[c, : res.skin_sets * 4] = cr["weights"]
        elif "joints" in cr:
            self.c_joints[c] = 0
            self.c_joints[c, : res.skin_sets * 4] = cr["joints"]
            self.c_weights[c] = 0.0
            self.c_weights[c, : res.skin_sets * 4] = cr["weights"]
        else:
            self.c_joints[c] = 0
            self.c_weights[c] = 0.0
        self.tri_mesh[t_base : t_base + T] = row

        flags = (
            (MESH_FLAG_HIDDEN if hidden else 0)
            | (MESH_FLAG_HUD if hud else 0)
            | (MESH_FLAG_DOUBLE_SIDED if double_sided else 0)
            | (MESH_FLAG_TRANSPARENT if transparent else 0)
        )
        self.mesh_info[row] = 0
        self.mesh_info[row, MI_TRANSFORM_ROW] = transform_row
        self.mesh_info[row, MI_MATERIAL_ROW] = material_row
        self.mesh_info[row, MI_FLAGS] = flags
        self.mesh_info[row, MI_N_MORPH_TARGETS] = res.n_morph_targets
        self.mesh_info[row, MI_MORPH_STRIDE] = res.vertex_count
        self.mesh_info[row, MI_SKIN_SETS] = res.skin_sets
        if initial_morph_weights is not None:
            self._ensure_morph_width(len(initial_morph_weights))
            w = np.zeros(self.morph_weights.shape[1], dtype=F)
            n = min(len(initial_morph_weights), w.size)
            w[:n] = initial_morph_weights[:n]
            self.morph_weights[row] = w
        else:
            self.morph_weights[row] = 0.0

        res.refcount += 1
        self._wb_cache = None
        self._meshes[key] = _Mesh(
            resource_key=resource_key, transform_key=transform_key,
            material_key=material_key, t_base=t_base, t_count=T,
            double_sided=double_sided, transparent=transparent, hud=hud,
            hidden=hidden, skin_key=skin_key,
        )
        self.gpu_dirty = True
        self._dev_events.append(("add", key))
        return key

    def insert_geometry(self, geo: MeshGeometry, transform_row: int, material_row: int,
                        transform_key: int, material_key: int, **kw) -> int:
        """Convenience: insert_resource + insert in one call."""
        rk = self.insert_resource(geo)
        return self.insert(rk, transform_row, material_row, transform_key, material_key, **kw)

    def insert_instanced(
        self, resource_key: int, instances, material_row: int,
        material_key: int, *, double_sided: bool = False,
        transparent: bool = False, hud: bool = False,
        hidden: bool = False,
    ) -> List[int]:
        """Instanced draw over shared geometry — the reference's
        EXT_mesh_gpu_instancing path (instances.rs:22-203): geometry is
        stored ONCE, each instance contributes only a transform.

        instances: iterable of (transform_row, transform_key). Returns one
        mesh key per instance (each is a full mesh record: individually
        cullable, pickable, hidable, removable). Morphs/skins are not
        supported on instanced draws (neither does the reference combine
        them with EXT_mesh_gpu_instancing)."""
        try:
            res = self._resources[resource_key]
        except KeyError:
            raise MeshError(f"unknown mesh resource {resource_key}") from None
        if res.n_morph_targets or res.skin_sets:
            raise InstanceError(
                "instanced draws do not combine with morphs/skins "
                "(EXT_mesh_gpu_instancing scope)")
        T = res.tri_count
        G = self.DEV_GROUP
        Tp = -(-T // G) * G

        def cm(arr, c):
            """corner-major (3T, c) → component-major (3c, Tp), zero-pad."""
            out = np.zeros((3 * c, Tp), arr.dtype)
            out[:, :T] = (arr.reshape(T, 3, c).transpose(1, 2, 0)
                          .reshape(3 * c, T))
            return out

        cr = res.corners
        corners = {
            "c_pos": cm(cr["pos"], 3),
            "c_norm": cm(cr["norm"], 3),
            "c_tang": cm(cr["tang"], 4),
            "c_uv0": cm(cr["uv0"], 2),
            "c_uv1": cm(cr["uv1"], 2),
            "c_color": cm(cr["color"], 4),
            "c_joints": np.zeros((3 * self.c_joints.shape[1], Tp), I),
            "c_weights": np.zeros((3 * self.c_joints.shape[1], Tp), F),
            "c_morph_base": np.full((3, Tp), -1, I),
        }
        livemask = np.zeros(Tp, bool)
        livemask[:T] = True

        gid = self._inst_next_gid
        self._inst_next_gid += 1
        grp = _InstGroup(resource_key=resource_key, corners=corners,
                         livemask=livemask, tri_count=T)
        self._inst_groups[gid] = grp

        flags = (
            (MESH_FLAG_HIDDEN if hidden else 0)
            | (MESH_FLAG_HUD if hud else 0)
            | (MESH_FLAG_DOUBLE_SIDED if double_sided else 0)
            | (MESH_FLAG_TRANSPARENT if transparent else 0)
        )
        keys = []
        for transform_row, transform_key in instances:
            key = self._mesh_alloc.insert()
            if self._mesh_alloc.take_needs_resize():
                mc = self._mesh_alloc.capacity
                self.mesh_info = _grow(self.mesh_info, mc)
                self.morph_weights = _grow(self.morph_weights, mc)
                self.capacity_changed = True
            row = self._mesh_alloc.row_of(key)
            self.mesh_info[row] = 0
            self.mesh_info[row, MI_TRANSFORM_ROW] = transform_row
            self.mesh_info[row, MI_MATERIAL_ROW] = material_row
            self.mesh_info[row, MI_FLAGS] = flags
            self.morph_weights[row] = 0.0
            res.refcount += 1
            self._wb_cache = None
            self._meshes[key] = _Mesh(
                resource_key=resource_key, transform_key=transform_key,
                material_key=material_key, t_base=-1, t_count=T,
                double_sided=double_sided, transparent=transparent,
                hud=hud, hidden=hidden, inst_gid=gid,
            )
            grp.mesh_keys.append(key)
            keys.append(key)
        self.gpu_dirty = True
        self.inst_groups_changed = True
        return keys

    def inst_group_items(self):
        """(gid, group) pairs in deterministic (gid) order — the order the
        frame concatenates instanced triangle blocks after the pool."""
        return sorted(self._inst_groups.items())

    def remove(self, key: int) -> None:
        self._wb_cache = None
        mesh = self._meshes.pop(key)
        if mesh.inst_gid is not None:
            grp = self._inst_groups[mesh.inst_gid]
            grp.mesh_keys.remove(key)
            grp.dirty = True
            if not grp.mesh_keys:
                del self._inst_groups[mesh.inst_gid]
            self.inst_groups_changed = True
        else:
            self.tri_mesh[mesh.t_base : mesh.t_base + mesh.t_count] = -1
            self._t_alloc.free(mesh.t_base)
            self._dev_events.append(("remove", key))
        row = self._mesh_alloc.row_of(key)
        self.mesh_info[row] = 0
        self._mesh_alloc.remove(key)
        res = self._resources[mesh.resource_key]
        res.refcount -= 1
        if res.refcount == 0:
            if res.morph_base >= 0:
                self._m_alloc.free(res.morph_base)
            self._res_alloc.remove(mesh.resource_key)
            del self._resources[mesh.resource_key]
        self.gpu_dirty = True

    def get(self, key: int) -> _Mesh:
        try:
            return self._meshes[key]
        except KeyError:
            raise MeshError(f"unknown or removed mesh key {key}") from None

    def row_of(self, key: int) -> int:
        return self._mesh_alloc.row_of(key)

    def set_hidden(self, key: int, hidden: bool) -> None:
        mesh = self._meshes[key]
        mesh.hidden = hidden
        row = self._mesh_alloc.row_of(key)
        if hidden:
            self.mesh_info[row, MI_FLAGS] |= MESH_FLAG_HIDDEN
        else:
            self.mesh_info[row, MI_FLAGS] &= ~MESH_FLAG_HIDDEN
        self.gpu_dirty = True

    def update_morph_weights(self, key: int, weights) -> None:
        """Reference: morphs.rs update_morph_weights_with."""
        row = self._mesh_alloc.row_of(key)
        self._ensure_morph_width(len(weights))
        w = np.zeros(self.morph_weights.shape[1], dtype=F)
        n = min(len(weights), w.size)
        w[:n] = np.asarray(weights, F)[:n]
        self.morph_weights[row] = w
        self.gpu_dirty = True

    def write_morph_weights(self, rows: np.ndarray, elem_rows: np.ndarray,
                            elem_cols: np.ndarray, values: np.ndarray) -> None:
        """Many rows of the weights table at once: each of `rows` zeroed,
        then element i of `values` to (elem_rows[i], elem_cols[i]) — an
        update_morph_weights per row, in one scatter. The columns lie
        inside the table's width (the animation table widens it when it
        is built)."""
        mw = self.morph_weights
        mw[rows] = 0.0
        mw[elem_rows, elem_cols] = values
        self.gpu_dirty = True

    @property
    def rows_version(self) -> int:
        """Changes whenever a mesh key gains or loses its row: tables of
        rows built from keys hold while it does."""
        return self._mesh_alloc.version

    def items(self):
        return self._meshes.items()

    @property
    def count(self) -> int:
        return len(self._meshes)

    # ---- per-frame world AABB update (reference: meshes.rs:872) ------------

    def update_world(self, transforms, changed_keys=None) -> None:
        """Batch-recompute world AABBs for meshes whose transform changed
        (native transform_aabbs; reference recomputes per mesh in Rust)."""
        from ..utils import native

        affected = [
            (key, mesh) for key, mesh in self._meshes.items()
            if changed_keys is None or mesh.transform_key in changed_keys
        ]
        if not affected:
            return
        rows = np.array(
            [transforms.row_of(m.transform_key) for _, m in affected], dtype=I)
        mins = np.stack([self._resources[m.resource_key].aabb.min for _, m in affected])
        maxs = np.stack([self._resources[m.resource_key].aabb.max for _, m in affected])
        omin, omax = native.transform_aabbs(
            rows, transforms.world.reshape(-1, 16), mins, maxs)
        # keep the stacked world-bounds cache coherent in place: the
        # per-frame derived state (cull masks, tile caps, crop, DoF
        # rings, layer bound) calls world_bounds() ~6x per frame, and
        # re-stacking per-mesh Aabb objects cost ~6 ms/frame host time
        # on the animated stress bench (r4)
        wb = self._wb_cache
        if wb is not None:
            kpos = wb[3]
            for i, (key, mesh) in enumerate(affected):
                mesh.world_aabb = Aabb(omin[i], omax[i])
                j = kpos.get(key)
                if j is not None:
                    wb[0][j] = omin[i]
                    wb[1][j] = omax[i]
        else:
            for i, (_, mesh) in enumerate(affected):
                mesh.world_aabb = Aabb(omin[i], omax[i])

    _wb_cache = None   # (mins (N,3), maxs (N,3), keys, {key: index})

    def world_bounds(self) -> Tuple[np.ndarray, np.ndarray, List[int]]:
        """(mins, maxs, keys) for vectorized frustum culling. Cached;
        update_world patches moved rows in place, inserts/removes
        invalidate (insert_geometry/remove set _wb_cache = None).

        The returned arrays are READ-ONLY VIEWS of the live cache:
        update_world mutates the backing store in place each frame, so a
        caller that needs a stable snapshot across frames must .copy().
        """
        wb = self._wb_cache
        if wb is not None:
            return _ro_view(wb[0]), _ro_view(wb[1]), wb[2]
        keys = list(self._meshes.keys())
        if not keys:
            return np.zeros((0, 3), F), np.zeros((0, 3), F), keys
        mins = np.stack([self._meshes[k].world_aabb.min for k in keys])
        maxs = np.stack([self._meshes[k].world_aabb.max for k in keys])
        self._wb_cache = (mins, maxs, keys,
                          {k: i for i, k in enumerate(keys)})
        return _ro_view(mins), _ro_view(maxs), keys

    def world_rows(self) -> np.ndarray:
        """(N,) mesh-info rows aligned with world_bounds()' keys —
        vectorizes the per-frame `mask[row_of(k)]` selection loops."""
        wb = self._wb_cache
        if wb is not None and len(wb) == 4 and wb[2]:
            cached = getattr(self, "_wb_rows", None)
            if cached is not None and cached[0] is wb[2]:
                return cached[1]
        _mins, _maxs, keys = self.world_bounds()
        rows = np.array([self._mesh_alloc.row_of(k) for k in keys], dtype=I)
        self._wb_rows = (keys, rows)
        return rows

    @property
    def triangle_capacity(self) -> int:
        return self._t_alloc.capacity

    def live_triangle_rows(self, bucket: int = 32768):
        """Live triangle pool rows in stable order, bucket-padded.

        The device corner pools upload only these rows — a compaction of
        the buddy-allocated pool (pow2 block rounding leaves ~2x internal
        padding). Measured: the deferred resolve's winner-row gather, the
        vertex stage and the binner all scale with the device pool
        extent (491520-row extent for 259404 live tris), so shipping
        dead pool rows to the device wastes real frame time. The bucket
        bounds retraces the same way pow2 growth does.

        Rows are padded per-MESH to a 16 multiple (the raster's GROUP
        fetch granularity): a fetch group straddling two meshes gets a
        bbox spanning both, which measured +4 ms of extra tile visits on
        the 1080p stress scene. Pad rows are DEAD — the returned mask is
        True there and the flush forces tri_mesh to -1, the same dead-row
        path buddy holes used before compaction.

        Returns (idx (tu,) int64, dead (tu,) bool)."""
        tm = self.tri_mesh
        GROUP = 16
        live = np.nonzero(tm >= 0)[0]
        if live.size == 0:
            n = min(max(self._t_alloc.capacity, 1), GROUP)
            return np.zeros(n, dtype=np.int64), np.ones(n, dtype=bool)
        # split live rows at mesh-change boundaries (stable order keeps
        # each mesh's triangles contiguous)
        mesh_of = tm[live]
        cuts = np.nonzero(np.diff(mesh_of) != 0)[0] + 1
        parts = []
        for c in np.split(live, cuts):
            parts.append(c)
            pad = (-len(c)) % GROUP
            if pad:
                parts.append(np.full(pad, -1, dtype=np.int64))
        idx = np.concatenate(parts)
        n = idx.size
        b = max(min(bucket, self._t_alloc.capacity), GROUP)
        tu = -(-n // b) * b
        out = np.full(tu, -1, dtype=np.int64)   # bucket tail rows are DEAD
        out[:n] = idx
        dead = out < 0
        out[dead] = 0
        return out, dead

    # ---- dirty-range device updates (reference: buffer/helpers.rs) ---------

    def invalidate_device(self) -> None:
        """Forget the remembered device layout: the next flush re-uploads
        the full compacted pool. Needed whenever the device dict this plan
        was built against is gone (snapshot load into a fresh renderer,
        device reset) — range updates would patch arrays that don't exist."""
        self._dev_idx = None
        self._dev_dead = None
        self._dev_spans = {}
        self._dev_tail = 0
        self._dev_dead_count = 0
        self._dev_events.clear()
        for grp in self._inst_groups.values():
            grp.dirty = True
        self.inst_groups_changed = True
        self.gpu_dirty = True
        self.morph_pool_dirty = True

    DEV_GROUP = 16             # raster fetch-group granularity
    DEV_DEAD_RECOMPACT = 0.35  # tombstone fraction that forces recompaction
    DEV_DEAD_MIN_ROWS = 2048   # below this, dead rows are cheaper than a
                               # recompaction upload

    def device_updates(self, bucket: int = 32768):
        """Plan the device corner-pool update for this flush.

        Returns ("full", idx, dead) — re-upload the whole compacted pool
        (first flush, capacity growth, headroom exhausted, or too many
        tombstones) — or ("ranges", ranges) where each range is either
          (dev_start, host_idx (cnt,), dead (cnt,))  — append a new mesh
          (dev_start, None, count)                   — tombstone a removed one
        in event order. Tombstones only rewrite tri_mesh (-1 masks the
        stale corner data, the same dead-row path buddy holes use);
        appends gather + transpose only the new mesh's rows. This is the
        analog of the reference's coalesced dirty-range uploads
        (buffer/helpers.rs, transforms.rs:255-327): an edit to one mesh
        in a large scene flushes in ~ms instead of re-uploading and
        re-transposing every pool."""
        G = self.DEV_GROUP
        if self._dev_idx is None or self.capacity_changed:
            return self._full_plan(bucket)

        ranges = []
        for ev in self._dev_events:
            if ev[0] == "remove":
                span = self._dev_spans.pop(ev[1], None)
                if span is None:       # never uploaded (added+removed)
                    continue
                s, e = span
                self._dev_dead_count += int((~self._dev_dead[s:e]).sum())
                self._dev_dead[s:e] = True
                ranges.append((s, None, e - s))
            else:
                mesh = self._meshes.get(ev[1])
                if mesh is None:       # added then removed before flush
                    continue
                T = mesh.t_count
                n = -(-T // G) * G
                if self._dev_tail + n > self._dev_idx.size:
                    return self._full_plan(bucket)   # headroom exhausted
                s = self._dev_tail
                self._dev_tail += n
                host = np.arange(mesh.t_base, mesh.t_base + T, dtype=np.int64)
                host = np.concatenate(
                    [host, np.zeros(n - T, dtype=np.int64)])
                dead = np.zeros(n, dtype=bool)
                dead[T:] = True
                self._dev_idx[s : s + n] = host
                self._dev_dead[s : s + n] = dead
                self._dev_spans[ev[1]] = (s, s + n)
                ranges.append((s, host, dead))
        self._dev_events.clear()
        if (self._dev_dead_count >= self.DEV_DEAD_MIN_ROWS
                and self._dev_dead_count
                > self.DEV_DEAD_RECOMPACT * self._dev_tail):
            return self._full_plan(bucket)
        return ("ranges", ranges)

    def _full_plan(self, bucket: int):
        idx, dead = self.live_triangle_rows(bucket)
        self._dev_idx = idx.copy()
        self._dev_dead = dead.copy()
        self._dev_events.clear()
        self.capacity_changed = False
        G = self.DEV_GROUP
        live_pos = np.nonzero(~dead)[0]
        self._dev_tail = (0 if live_pos.size == 0
                          else -(-int(live_pos[-1] + 1) // G) * G)
        # free headroom past the tail is not "dead work" — only in-use
        # rows count toward the recompaction threshold
        self._dev_dead_count = int(dead[: self._dev_tail].sum())
        # span per mesh: contiguous run of its device rows, end rounded up
        # to the group boundary (absorbing this mesh's own pad rows)
        self._dev_spans = {}
        mesh_of = np.where(dead, -1, self.tri_mesh[idx])
        for key in self._meshes:
            row = self._mesh_alloc.row_of(key)
            pos = np.nonzero(mesh_of == row)[0]
            if pos.size:
                e = -(-int(pos[-1] + 1) // G) * G
                self._dev_spans[key] = (int(pos[0]), e)
        return ("full", idx, dead)

    @property
    def mesh_capacity(self) -> int:
        return self._mesh_alloc.capacity
