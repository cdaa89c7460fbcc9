"""Interactive session driver: the runtime loop the reference frontend
runs in the browser, as a host-side event-driven API (port of
awsm_renderer_tpu/session.py, a copy over the port's facade).

Mirrors crates/frontend/src/pages/app/scene.rs:
- rAF loop (scene.rs:864-905 fire_raf: update_all(dt) then render)
  → `InteractiveSession.step(dt, events)`.
- Pointer routing (scene.rs:108-170): pointerdown picks; a gizmo-handle
  hit starts a gizmo drag, an object hit selects it (attaching the
  gizmo), a miss starts a camera orbit drag; pointermove routes by the
  active move action; pointerup clears it.
- Resize observer (scene.rs canvas observer) → `("resize", w, h)`.
- Sidebar runtime toggles (frontend sidebar: AA / tonemapping / bloom /
  DoF / lighting) → `("set", name, value)` events, applied through the
  renderer's public reconfiguration API (set_anti_aliasing /
  set_post_processing; the next frame runs the new variant, as the
  reference's pipeline rebuilds do).

Events are plain tuples so a test (tests/test_torch_editor.py), a notebook,
or any windowing shim can drive the same loop:

    ("pointer_down", x, y) ("pointer_move", x, y) ("pointer_up",)
    ("wheel", dy)          ("resize", w, h)       ("set", name, value)
"""

from __future__ import annotations

from dataclasses import replace
from typing import Iterable, Optional, Sequence, Tuple

import numpy as np

from .utils import math3d as m3

F = np.float32


class OrbitCamera:
    """Orbit controls + perspective projection + AABB fit (the reference
    frontend camera, frontend/src/pages/app/scene/camera/)."""

    def __init__(self, center=(0.0, 0.0, 0.0), radius: float = 5.0,
                 yaw: float = 0.6, pitch: float = 0.4,
                 fov: float = np.pi / 3, near: float = 0.05,
                 far: float = 500.0):
        self.center = np.asarray(center, F)
        self.radius = float(radius)
        self.yaw = float(yaw)
        self.pitch = float(pitch)
        self.fov = float(fov)
        self.near = float(near)
        self.far = float(far)

    def fit(self, mins, maxs, margin: float = 1.8) -> None:
        """Frame an AABB (the reference's camera AABB-fit on model load)."""
        mins = np.asarray(mins, F)
        maxs = np.asarray(maxs, F)
        self.center = (mins + maxs) * 0.5
        extent = float(np.linalg.norm(maxs - mins)) * 0.5
        self.radius = max(extent, 1e-3) * margin / np.tan(self.fov * 0.5)

    def on_pointer_move(self, dx: float, dy: float) -> None:
        self.yaw -= dx * 0.008
        self.pitch = float(np.clip(self.pitch + dy * 0.008,
                                   -1.45, 1.45))

    def on_wheel(self, dy: float) -> None:
        self.radius = float(np.clip(self.radius * (1.0 + dy * 0.1),
                                    1e-3, 1e6))

    def eye(self) -> np.ndarray:
        cp = np.cos(self.pitch)
        d = np.array([np.sin(self.yaw) * cp, np.sin(self.pitch),
                      np.cos(self.yaw) * cp], F)
        return self.center + d * self.radius

    def matrices(self, aspect: float):
        view = m3.look_at(self.eye(), self.center, [0.0, 1.0, 0.0])
        proj = m3.perspective(self.fov, aspect, self.near, self.far)
        return view, proj


class InteractiveSession:
    """update → events → render loop over a renderer (scene.rs runtime).

    step(dt, events) processes the events, advances animations, applies
    the orbit camera, renders one frame, and returns the device image.
    Pointer routing follows the reference exactly (scene.rs:108-170):
    gizmo-transforming beats camera-moving, selection attaches the
    gizmo."""

    def __init__(self, renderer, *, editor: bool = True,
                 grid: bool = False, camera: Optional[OrbitCamera] = None):
        self.r = renderer
        self.camera = camera or OrbitCamera()
        self.controller = None
        self.grid = None
        if editor:
            from .editor import TransformController

            self.controller = TransformController(renderer)
        if grid:
            from .editor import Grid

            self.grid = Grid(renderer)
        self.selected: Optional[int] = None      # selected mesh key
        self._move_action: Optional[str] = None  # "gizmo" | "camera"
        self._last_xy: Optional[Tuple[float, float]] = None
        self.frames = 0

    # ---- event handling (scene.rs:108-170) -------------------------------

    def _pointer_down(self, x: float, y: float) -> None:
        c = self.controller
        if c is not None and c.on_pointer_down(int(x), int(y)):
            self._move_action = "gizmo"           # GizmoHit
            return
        picked = self.r.pick(int(x), int(y))
        if picked is not None:
            self.selected = picked                # ObjectHit: select
            if c is not None:
                tk = self.r.meshes.get(picked).transform_key
                if c.target is None or tk != c.target:
                    c.attach(tk)
        # a non-gizmo press always starts a camera drag (scene.rs:142)
        self._move_action = "camera"
        self._last_xy = (x, y)

    def _pointer_move(self, x: float, y: float) -> None:
        if self._move_action == "gizmo" and self.controller is not None:
            self.controller.on_pointer_move(int(x), int(y))
        elif self._move_action == "camera":
            lx, ly = self._last_xy if self._last_xy else (x, y)
            self.camera.on_pointer_move(x - lx, y - ly)
            self._last_xy = (x, y)

    def _pointer_up(self) -> None:
        if self.controller is not None:
            self.controller.on_pointer_up()
        self._move_action = None
        self._last_xy = None

    def _apply_set(self, name: str, value) -> None:
        """Runtime sidebar toggles → public reconfiguration API."""
        cfg = self.r.config
        aa_fields = {"msaa", "smaa", "supersample", "mipmap", "temporal"}
        pp_fields = {"bloom", "dof"}
        if name in aa_fields:
            self.r.set_anti_aliasing(
                replace(cfg.anti_aliasing, **{name: bool(value)}))
        elif name in pp_fields:
            self.r.set_post_processing(
                replace(cfg.post_processing, **{name: bool(value)}))
        elif name == "tonemapping":
            from .config import ToneMapping

            tm = value if isinstance(value, ToneMapping) \
                else ToneMapping(value)
            self.r.set_post_processing(
                replace(cfg.post_processing, tonemapping=tm))
        elif name == "grid" and self.grid is not None:
            self.grid.set_visible(self.r, bool(value))
        elif name == "gizmo_mode" and self.controller is not None:
            from .editor import GizmoMode

            self.controller.mode = (value if isinstance(value, GizmoMode)
                                    else GizmoMode(value))
        elif name == "gizmo_space" and self.controller is not None:
            from .editor import GizmoSpace

            self.controller.space = (value if isinstance(value, GizmoSpace)
                                     else GizmoSpace(value))
        else:
            raise ValueError(f"unknown runtime setting {name!r}")

    def _resize(self, w: int, h: int) -> None:
        """Canvas resize (the reference's ResizeObserver → configure)."""
        self.r.config = replace(self.r.config, width=int(w), height=int(h))

    # ---- the loop --------------------------------------------------------

    def step(self, dt: float, events: Iterable[Sequence] = ()) :
        """One rAF tick: events → update_all(dt) → render. Returns the
        (H, W, 4) image tensor on the renderer's device (render_device —
        no host readback)."""
        for ev in events:
            kind = ev[0]
            if kind == "pointer_down":
                self._pointer_down(ev[1], ev[2])
            elif kind == "pointer_move":
                self._pointer_move(ev[1], ev[2])
            elif kind == "pointer_up":
                self._pointer_up()
            elif kind == "wheel":
                self.camera.on_wheel(ev[1])
            elif kind == "resize":
                self._resize(ev[1], ev[2])
            elif kind == "set":
                self._apply_set(ev[1], ev[2])
            else:
                raise ValueError(f"unknown event {ev!r}")
        cfg = self.r.config
        view, proj = self.camera.matrices(cfg.width / cfg.height)
        self.r.update_all(dt, view, proj)
        img = self.r.render_device()
        self.frames += 1
        return img
