"""Editor tools: transform gizmo + infinite grid.

Port of awsm_renderer_tpu/editor.py (the reference editor crate,
crates/editor/), a copy over the port's stores:
- TransformController (transform_controller.rs:14-625): gizmo handle
  meshes rendered as HUD renderables, picked via renderer.pick, dragged
  with ray-based translate / rotate / scale in world or local space.
- Grid (grid/): infinite ground grid — here a large plane with the
  procedural KIND_GRID material (core/materials.py GridMaterial) routed
  through the transparent pass instead of a custom render-hook pipeline.

Uses only the public renderer API, like the reference editor does.
"""

from __future__ import annotations

import enum
from typing import Dict, Optional, Tuple

import numpy as np

from .core.materials import GridMaterial, UnlitMaterial
from .core.transforms import Transform
from .geometry import box, cone, cylinder, plane, torus
from .utils import math3d as m3

F = np.float32

_AXIS_COLORS = {
    0: np.array([0.9, 0.15, 0.15, 1.0], F),
    1: np.array([0.15, 0.8, 0.15, 1.0], F),
    2: np.array([0.2, 0.35, 0.95, 1.0], F),
}
_AXES = {0: np.array([1, 0, 0], F), 1: np.array([0, 1, 0], F), 2: np.array([0, 0, 1], F)}


class GizmoMode(enum.Enum):
    TRANSLATE = "translate"
    ROTATE = "rotate"
    SCALE = "scale"


class GizmoSpace(enum.Enum):
    WORLD = "world"
    LOCAL = "local"


def screen_ray(renderer, x: float, y: float) -> Tuple[np.ndarray, np.ndarray]:
    """Pixel → world-space ray (origin, direction)."""
    W, H = renderer.config.width, renderer.config.height
    ndc = np.array([(x + 0.5) / W * 2 - 1, 1 - (y + 0.5) / H * 2], np.float64)
    inv_vp = np.linalg.inv(renderer.camera.view_projection.astype(np.float64))
    near = inv_vp @ np.array([ndc[0], ndc[1], 0.0, 1.0])
    far = inv_vp @ np.array([ndc[0], ndc[1], 1.0, 1.0])
    near = near[:3] / near[3]
    far = far[:3] / far[3]
    d = far - near
    return near.astype(F), (d / np.linalg.norm(d)).astype(F)


def _closest_t_on_axis(origin, axis, ro, rd) -> float:
    """Parameter t of the closest point on line origin+t*axis to ray ro+s*rd."""
    w0 = origin - ro
    a = float(axis @ axis)
    b = float(axis @ rd)
    c = float(rd @ rd)
    d = float(axis @ w0)
    e = float(rd @ w0)
    denom = a * c - b * b
    if abs(denom) < 1e-9:
        return 0.0
    return (b * e - c * d) / denom


def _ray_plane(ro, rd, p0, n) -> Optional[np.ndarray]:
    denom = float(rd @ n)
    if abs(denom) < 1e-7:
        return None
    t = float((p0 - ro) @ n) / denom
    if t < 0:
        return None
    return ro + t * rd


class TransformController:
    """Reference: editor/src/transform_controller.rs."""

    def __init__(self, renderer, mode: GizmoMode = GizmoMode.TRANSLATE,
                 space: GizmoSpace = GizmoSpace.WORLD, scale: float = 1.0):
        self.r = renderer
        self.mode = mode
        self.space = space
        self.gizmo_scale = scale
        self.target: Optional[int] = None
        self._drag: Optional[dict] = None
        self._root = renderer.transforms.insert(Transform())
        renderer.transforms.update_world()
        self._parts: Dict[int, Tuple[GizmoMode, int]] = {}  # mesh key -> (mode, axis)
        self._build_handles()
        self._set_visible(False)

    def _build_handles(self) -> None:
        r = self.r
        s = self.gizmo_scale
        for axis in range(3):
            mat = r.materials.insert(UnlitMaterial(base_color_factor=_AXIS_COLORS[axis]))
            shaft = cylinder(0.02 * s, 0.8 * s, axis=axis)
            head = cone(0.06 * s, 0.2 * s, base_y=0.8 * s, axis=axis)
            ring = torus(0.9 * s, 0.02 * s, axis=axis)
            cube_handle = box(0.1 * s)
            k1 = r.add_mesh(shaft, mat, transform_key=self._root, hud=True)
            k2 = r.add_mesh(head, mat, transform_key=self._root, hud=True)
            k3 = r.add_mesh(ring, mat, transform_key=self._root, hud=True)
            self._parts[k1] = (GizmoMode.TRANSLATE, axis)
            self._parts[k2] = (GizmoMode.TRANSLATE, axis)
            self._parts[k3] = (GizmoMode.ROTATE, axis)
            # scale handle: cube at the shaft end
            sc_tk = r.transforms.insert(Transform(
                translation=_AXES[axis] * 1.05 * s), parent=self._root)
            k4 = r.add_mesh(cube_handle, mat, transform_key=sc_tk, hud=True)
            self._parts[k4] = (GizmoMode.SCALE, axis)
        r.transforms.update_world()
        r.meshes.update_world(r.transforms)

    def _set_visible(self, visible: bool) -> None:
        for key in self._parts:
            self.r.meshes.set_hidden(key, not visible)

    def attach(self, transform_key: int) -> None:
        self.target = transform_key
        self._sync_root()
        self._set_visible(True)

    def detach(self) -> None:
        self.target = None
        self._set_visible(False)

    def _sync_root(self) -> None:
        if self.target is None:
            return
        world = self.r.transforms.world_of(self.target)
        t = Transform(translation=world[:3, 3].copy())
        if self.space == GizmoSpace.LOCAL:
            _, rot, _ = m3.mat4_decompose(world)
            t.rotation = rot
        self.r.transforms.set_local(self._root, t)
        self.r.update_all(0.0)

    def _gizmo_axis_world(self, axis: int) -> np.ndarray:
        if self.space == GizmoSpace.LOCAL and self.target is not None:
            world = self.r.transforms.world_of(self.target)
            a = world[:3, axis]
            return (a / np.linalg.norm(a)).astype(F)
        return _AXES[axis]

    # ---- pointer protocol (reference drives this from DOM events) ----------

    def on_pointer_down(self, x: int, y: int) -> bool:
        """Start a drag when a gizmo handle is under the cursor."""
        if self.target is None:
            return False
        picked = self.r.pick(x, y)
        if picked not in self._parts:
            return False
        mode, axis = self._parts[picked]
        ro, rd = screen_ray(self.r, x, y)
        center = self.r.transforms.world_of(self._root)[:3, 3].copy()
        a = self._gizmo_axis_world(axis)
        local0 = self.r.transforms.get_local(self.target)
        state = {"mode": mode, "axis": axis, "a": a, "center": center,
                 "t0": Transform(local0.translation.copy(), local0.rotation.copy(),
                                 local0.scale.copy())}
        if mode in (GizmoMode.TRANSLATE, GizmoMode.SCALE):
            state["s0"] = _closest_t_on_axis(center, a, ro, rd)
        else:
            hit = _ray_plane(ro, rd, center, a)
            if hit is None:
                return False
            v = hit - center
            state["angle0"] = float(np.arctan2(
                v @ np.cross(a, self._ref_perp(a)), v @ self._ref_perp(a)))
        self._drag = state
        return True

    @staticmethod
    def _ref_perp(a: np.ndarray) -> np.ndarray:
        ref = np.array([0, 1, 0], F) if abs(a[1]) < 0.9 else np.array([1, 0, 0], F)
        p = np.cross(a, ref)
        return (p / np.linalg.norm(p)).astype(F)

    def on_pointer_move(self, x: int, y: int) -> bool:
        if self._drag is None or self.target is None:
            return False
        d = self._drag
        ro, rd = screen_ray(self.r, x, y)
        t0: Transform = d["t0"]
        if d["mode"] == GizmoMode.TRANSLATE:
            s = _closest_t_on_axis(d["center"], d["a"], ro, rd)
            delta = (s - d["s0"]) * d["a"]
            self.r.transforms.set_translation(self.target, t0.translation + delta)
        elif d["mode"] == GizmoMode.SCALE:
            s = _closest_t_on_axis(d["center"], d["a"], ro, rd)
            factor = 1.0 + (s - d["s0"]) / max(self.gizmo_scale, 1e-6)
            scale = t0.scale.copy()
            scale[d["axis"]] = t0.scale[d["axis"]] * max(factor, 1e-3)
            self.r.transforms.set_scale(self.target, scale)
        else:  # ROTATE
            hit = _ray_plane(ro, rd, d["center"], d["a"])
            if hit is None:
                return True
            v = hit - d["center"]
            perp = self._ref_perp(d["a"])
            angle = float(np.arctan2(v @ np.cross(d["a"], perp), v @ perp))
            dq = m3.quat_from_axis_angle(d["a"], angle - d["angle0"])
            self.r.transforms.set_rotation(self.target, m3.quat_mul(dq, t0.rotation))
        self.r.update_all(0.0)
        self._sync_root()
        return True

    def on_pointer_up(self) -> None:
        self._drag = None

    @property
    def dragging(self) -> bool:
        return self._drag is not None


class Grid:
    """Infinite ground grid (reference: editor/src/grid/)."""

    def __init__(self, renderer, size: float = 200.0, spacing: float = 1.0,
                 major_every: float = 10.0, fade_distance: float = 60.0):
        mat = renderer.materials.insert(GridMaterial(
            spacing=spacing, major_every=major_every, fade_distance=fade_distance))
        self.mesh_key = renderer.add_mesh(plane(size), mat)
        self.material_key = mat

    def set_visible(self, renderer, visible: bool) -> None:
        renderer.meshes.set_hidden(self.mesh_key, not visible)
