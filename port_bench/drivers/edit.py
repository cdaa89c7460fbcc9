"""edit: one editor user dragging a box with the gizmo, in the program's
interactive session (InteractiveSession with its editor and grid), the
camera still. Closed loop: a frame is one session.step(dt, events).

Set-up selects the box nearest the scene's centre (a pointer_down and a
pointer_up on its centre pixel) and warms up with warmup_drags drags.
Then each period of steps is one drag: step 0 a pointer_down on the
translate handle of the horizontal axis whose shaft has the longer
screen projection (the pixel of the shaft's point at handle_at of its
length), steps 1 .. period-2 a pointer_move of move_px pixels further
along that axis's screen direction each, the last a pointer_up. The
first drag's sign is drawn from the seed; the signs alternate.

The session's orbit camera looks at the selected box from the
configuration's radius and pitch; its yaw is the configuration's plus a
seed-drawn turn of 2 pi / yaw_turns, stepped by yaw_step until the box's
centre pixel shows the box, every planned press lands on the dragged
handle and every pointer stays inside the frame.

shown(i) is worked out here alone, from the events: the box's
translation replayed with the closest point of the pointer's ray to the
axis line (float64), the gizmo's handles at the box, the grid; the
shapes are configs/_shapes.py's.
"""

from __future__ import annotations

import math
import os
import sys

import numpy as np

from port_bench.scene import (
    Material, Mesh, Scene, look_at, perspective, translation,
)

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs"))

import _shapes  # noqa: E402

F = np.float32
SHAFT, HEAD, RING, CUBE = "shaft", "head", "ring", "cube"


def _hits(ro, rd, tris):
    """Distance along the ray (ro, rd) to each triangle of tris (N, 3, 3),
    inf where it misses (either face)."""
    v0 = tris[:, 0]
    e1, e2 = tris[:, 1] - v0, tris[:, 2] - v0
    p = np.cross(rd, e2)
    det = (e1 * p).sum(1)
    ok = np.abs(det) > 1e-12
    inv = 1.0 / np.where(ok, det, 1.0)
    s = ro - v0
    u = (s * p).sum(1) * inv
    q = np.cross(s, e1)
    v = (q * rd).sum(1) * inv
    t = (e2 * q).sum(1) * inv
    hit = ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 0)
    return np.where(hit, t, np.inf)


def _closest_t(origin, axis, ro, rd) -> float:
    """Parameter t of the point of the line origin + t axis closest to
    the ray ro + s rd."""
    w0 = origin - ro
    a, b, c = axis @ axis, axis @ rd, rd @ rd
    d, e = axis @ w0, rd @ w0
    den = a * c - b * b
    return 0.0 if abs(den) < 1e-9 else (b * e - c * d) / den


def _world_tris(mesh):
    w = np.asarray(mesh.world, np.float64)
    p = np.asarray(mesh.positions, np.float64) @ w[:3, :3].T + w[:3, 3]
    return p[np.asarray(mesh.indices, np.int64)]


class _Entry:
    """The renderer as the session sees it, its render entry replaced by
    the run's (a fault or the control of faults.py)."""

    def __init__(self, r, render):
        self._r = r
        self.render_device = render

    def __getattr__(self, name):
        return getattr(self._r, name)


class Edit:
    def __init__(self, mix, scene, seed, renderer=None, render=None):
        rng = np.random.default_rng([seed, 1])
        cam, st, ed = scene.camera, scene.settings, scene.meta["editor"]
        self.scene = scene
        self.W, self.H = int(st["width"]), int(st["height"])
        self.dt = float(mix["dt"])
        self.period = int(mix["period"])
        self.move_px = float(mix["move_px"])
        self.handle_at = float(mix["handle_at"])
        self.warmup_drags = int(mix["warmup_drags"])
        self.plan_drags = int(mix["plan_drags"])
        turn = int(rng.integers(int(cam["yaw_turns"])))
        self.sign0 = 1.0 if rng.random() < 0.5 else -1.0
        self.gizmo_cfg, self.grid_cfg = ed["gizmo"], ed["grid"]
        self.scale = float(self.gizmo_cfg["scale"])

        # the box nearest the scene's centre: an opaque 12-triangle mesh
        boxes = [k for k, m in enumerate(scene.meshes)
                 if not m.transparent and m.indices.shape[0] == 12]
        self.box = min(boxes, key=lambda k: float(np.linalg.norm(
            np.asarray(scene.meshes[k].world, np.float64)[:3, 3])))
        self.p0 = np.asarray(scene.meshes[self.box].world,
                             np.float64)[:3, 3].copy()
        self._editor_meshes()
        opaque = [k for k, m in enumerate(scene.meshes) if not m.transparent]
        self._scene_tris = np.concatenate(
            [_world_tris(scene.meshes[k]) for k in opaque])
        self._scene_mesh = np.concatenate(
            [np.full(scene.meshes[k].indices.shape[0], k) for k in opaque])

        self.yaw = float(cam["yaw"]) + 2 * math.pi * turn / int(
            cam["yaw_turns"])
        for _ in range(int(round(2 * math.pi / float(cam["yaw_step"])))):
            self._camera(cam)
            if self._plan_ok():
                break
            self.yaw += float(cam["yaw_step"])
        else:
            raise RuntimeError("no yaw shows the box and its handle")
        del self._scene_tris, self._scene_mesh

        self.r, self.session = renderer, None
        if renderer is not None:
            self._open_session(renderer, render, cam)

    # ---- the editor's meshes, as the program's editor builds them ------

    def _editor_meshes(self):
        g, s = self.gizmo_cfg, self.scale
        n0 = len(self.scene.materials)
        self.materials = list(self.scene.materials) + [
            Material(base_color=np.asarray(c, F), metallic=0.0,
                     roughness=1.0, kind="unlit") for c in g["axis_colors"]]
        gr = self.grid_cfg
        self.materials.append(Material(
            base_color=np.asarray(gr["color"], F), metallic=0.0,
            roughness=1.0, alpha_mode="blend", kind="grid",
            grid={k: float(gr[k]) for k in ("spacing", "major_every",
                                             "fade_distance")}))
        self.handles = []        # (shape, offset, kind, axis)
        for axis in range(3):
            off = np.zeros(3)
            cube_off = np.eye(3)[axis] * 1.05 * s
            self.handles += [
                (_shapes.cylinder(0.02 * s, 0.8 * s, axis), off, SHAFT, axis),
                (_shapes.cone(0.06 * s, 0.2 * s, 0.8 * s, axis), off, HEAD,
                 axis),
                (_shapes.torus(0.9 * s, 0.02 * s, axis), off, RING, axis),
                (_shapes.box(0.1 * s), cube_off, CUBE, axis)]
        self.handle_mat = [n0 + h[3] for h in self.handles]
        self.grid_mesh = Mesh(**_shapes.plane(float(gr["size"])),
                              world=np.eye(4, dtype=F), material=n0 + 3,
                              transparent=True, double_sided=True)
        self._handle_tris = [np.asarray(h[0]["positions"], np.float64)[
            np.asarray(h[0]["indices"], np.int64)] + h[1]
            for h in self.handles]

    # ---- the camera and the plan ------------------------------------------

    def _camera(self, cam):
        """The session's orbit camera at self.yaw, as its matrices come out
        of the program's OrbitCamera (float32 eye)."""
        p = float(cam["pitch"])
        d = np.array([np.sin(self.yaw) * np.cos(p), np.sin(p),
                      np.cos(self.yaw) * np.cos(p)], F)
        center = self.p0.astype(F)
        eye = center + d * F(float(cam["radius"]))
        self.view = look_at(eye, center, [0.0, 1.0, 0.0])
        self.proj = perspective(float(cam["fov_y"]), self.W / self.H,
                                float(cam["near"]), float(cam["far"]))
        self.vp = (self.proj @ self.view).astype(F).astype(np.float64)
        self.inv_vp = np.linalg.inv(self.vp)
        shaft = 0.8 * self.scale
        lens = {a: np.linalg.norm(self._px(self.p0 + np.eye(3)[a] * shaft)
                                  - self._px(self.p0)) for a in (0, 2)}
        self.axis = max(lens, key=lambda a: lens[a])
        self.a = np.eye(3)[self.axis]
        self._drags = []

    def _px(self, p):
        """Screen position (x right, y down, in pixels) of world point p."""
        c = self.vp @ np.append(p, 1.0)
        return np.array([(c[0] / c[3] + 1.0) * 0.5 * self.W,
                         (1.0 - c[1] / c[3]) * 0.5 * self.H])

    def _ray(self, x, y):
        """The ray through pixel (x, y)'s centre, as the editor casts it."""
        nx = (x + 0.5) / self.W * 2 - 1
        ny = 1 - (y + 0.5) / self.H * 2
        near = self.inv_vp @ np.array([nx, ny, 0.0, 1.0])
        far = self.inv_vp @ np.array([nx, ny, 1.0, 1.0])
        near, far = near[:3] / near[3], far[:3] / far[3]
        d = far - near
        return near, d / np.linalg.norm(d)

    def _drag(self, k):
        """Drag k of the session (warm-up ones first): its press pixel,
        its moves and the box's translation after each move."""
        while len(self._drags) <= k:
            n = len(self._drags)
            start = self._drags[-1]["pos"][-1] if n else self.p0
            sign = self.sign0 * (-1) ** n
            shaft = 0.8 * self.scale
            q = self._px(start + self.a * self.handle_at * shaft)
            press = (int(math.floor(q[0])), int(math.floor(q[1])))
            u = self._px(start + self.a * shaft) - self._px(start)
            u = u / np.linalg.norm(u)
            moves = [(int(round(press[0] + sign * self.move_px * j * u[0])),
                      int(round(press[1] + sign * self.move_px * j * u[1])))
                     for j in range(1, self.period - 1)]
            s0 = _closest_t(start, self.a, *self._ray(*press))
            pos = [start + (_closest_t(start, self.a, *self._ray(*m)) - s0)
                   * self.a for m in moves]
            self._drags.append(dict(start=start, press=press, moves=moves,
                                    pos=pos))
        return self._drags[k]

    def _handle_under(self, x, y, at):
        """(kind, axis) of the nearest gizmo handle under pixel (x, y) with
        the gizmo at `at`, or None."""
        ro, rd = self._ray(x, y)
        best, hit = np.inf, None
        for tris, (_, _, kind, axis) in zip(self._handle_tris, self.handles):
            t = _hits(ro, rd, tris + at).min()
            if t < best:
                best, hit = t, (kind, axis)
        return hit

    def _plan_ok(self) -> bool:
        x, y = (int(math.floor(v)) for v in self._px(self.p0))
        t = _hits(*self._ray(x, y), self._scene_tris)
        if not np.isfinite(t.min()) or \
                self._scene_mesh[int(t.argmin())] != self.box:
            return False
        self.box_px = (x, y)
        for k in range(self.warmup_drags + self.plan_drags):
            d = self._drag(k)
            pts = [d["press"]] + d["moves"]
            if not all(2 <= px < self.W - 2 and 2 <= py < self.H - 2
                       for px, py in pts):
                return False
            if self._handle_under(*d["press"], d["start"]) not in (
                    (SHAFT, self.axis), (HEAD, self.axis)):
                return False
        return True

    # ---- the program's session --------------------------------------------

    def _open_session(self, r, render, cam):
        from awsm_renderer_tpu_torch.session import (
            InteractiveSession, OrbitCamera,
        )

        camera = OrbitCamera(center=self.p0.astype(F),
                             radius=float(cam["radius"]), yaw=self.yaw,
                             pitch=float(cam["pitch"]),
                             fov=float(cam["fov_y"]), near=float(cam["near"]),
                             far=float(cam["far"]))
        entry = r if render == r.render_device else _Entry(r, render)
        self.session = s = InteractiveSession(entry, editor=True, grid=True,
                                              camera=camera)
        c, g = s.controller, r.materials.get(s.grid.material_key)
        held = dict(mode=c.mode.value, space=c.space.value,
                    scale=c.gizmo_scale, spacing=g.spacing,
                    major_every=g.major_every, fade_distance=g.fade_distance,
                    color=[float(x) for x in g.color])
        want = dict(mode=self.gizmo_cfg["mode"],
                    space=self.gizmo_cfg["space"], scale=self.scale,
                    **{k: self.grid_cfg[k] for k in (
                        "spacing", "major_every", "fade_distance")},
                    color=[float(F(x)) for x in self.grid_cfg["color"]])
        if held != want:
            raise RuntimeError(f"the session's editor is {held}, the "
                               f"configuration's {want}")

    def _events(self, k, j):
        d = self._drag(k)
        if j == 0:
            return [("pointer_down", *d["press"])]
        if j == self.period - 1:
            return [("pointer_up",)]
        return [("pointer_move", *d["moves"][j - 1])]

    def warmup(self) -> None:
        """A first frame (the camera set), the box selected, then the
        warm-up drags: every shape the window meets."""
        s = self.session
        s.step(self.dt, [])
        s.step(self.dt, [("pointer_down", *self.box_px)])
        s.step(self.dt, [("pointer_up",)])
        tk = self.r.meshes.get(s.selected).transform_key \
            if s.selected is not None else None
        if tk is None or not np.array_equal(
                self.r.transforms.get_local(tk).translation,
                self.p0.astype(F)):
            raise RuntimeError("the pointer on the box's centre pixel did "
                               "not select the box")
        for k in range(self.warmup_drags):
            for j in range(self.period):
                s.step(self.dt, self._events(k, j))
                if k == 0 and j == 0 and not s.controller.dragging:
                    raise RuntimeError("the press on the handle started no "
                                       "drag")

    def step(self, i):
        k = self.warmup_drags + i // self.period
        return self.session.step(self.dt, self._events(k, i % self.period))

    def translation(self, i) -> np.ndarray:
        """The box's translation once frame i's events are handled."""
        d = self._drag(self.warmup_drags + i // self.period)
        j = i % self.period
        return d["start"] if j == 0 else d["pos"][min(j, self.period - 2) - 1]

    def shown(self, i):
        p = self.translation(i).astype(F)
        sc = self.scene
        meshes = list(sc.meshes)
        box = meshes[self.box]
        meshes[self.box] = Mesh(**dict(vars(box), world=translation(p)))
        for (geo, off, _, _), mat in zip(self.handles, self.handle_mat):
            meshes.append(Mesh(**geo, world=translation(p + off.astype(F)),
                               material=mat, hud=True))
        meshes.append(self.grid_mesh)
        return (Scene(**dict(vars(sc), meshes=meshes,
                             materials=self.materials)),
                self.view, self.proj)


def make(mix, scene, seed, renderer=None, render=None) -> Edit:
    return Edit(mix, scene, seed, renderer, render)
