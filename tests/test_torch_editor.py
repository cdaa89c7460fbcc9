"""PyTorch port, the editor and the interactive session (editor.py,
session.py) against the JAX package's.

tests/test_editor.py's ten tests run on both renderers: the same checks
over each package's classes. The JAX cases run in threads started by one
module fixture (XLA compiles without the GIL), in groups whose frames
share compiles. One scripted event list then goes through JAX's
InteractiveSession and the port's (the toggles and a resize, and back,
an empty-sky orbit drag, a wheel, a click that selects the box and
attaches the gizmo, a drag on a translate handle); the two must agree on
the selected key, the gizmo target's world matrix (rtol 1e-5: both
compute it in numpy from the same ray math), the camera eye (equal) and
each step's image, held at tests/test_torch_frame.py's tolerance (< 0.5%
of channel values off by more than 4/255). The handle pixel is the one JAX's
session finds; the port's pick must name the same handle there. The grid
frame is held against JAX's at the same tolerance."""

import importlib

import numpy as np
import pytest

import _torch_port as T

W, H = 128, 64
F = np.float32
PKGS = ("torch", "jax")


class _Api:
    """One package's classes, as the tests use them."""

    def __init__(self, pkg: str, device: str = "cpu"):
        root = "awsm_renderer_tpu" if pkg == "jax" else "awsm_renderer_tpu_torch"
        self.pkg = pkg
        self.device = device
        self.P = importlib.import_module(root)
        self.ed = importlib.import_module(f"{root}.editor")
        self.sess = importlib.import_module(f"{root}.session")
        self.box = importlib.import_module(f"{root}.geometry").box
        self.m3 = importlib.import_module(f"{root}.utils.math3d")

    def renderer(self):
        P = self.P
        cfg = P.RendererConfig(width=W, height=H, post_processing=(
            P.PostProcessing(tonemapping=P.ToneMapping.NONE)))
        if self.pkg == "jax":
            return P.AwsmRendererTpu(cfg)
        return P.AwsmRendererTorch(cfg, device=self.device)


def _img(x):
    return T.to_numpy(x)


def _make_renderer(a):
    r = a.renderer()
    view = a.m3.look_at([0, 1.5, 4], [0, 0, 0], [0, 1, 0])
    proj = a.m3.perspective(np.pi / 3, W / H, 0.1, 100.0)
    r.camera.update(view, proj)
    return r


# ---- tests/test_editor.py's ten checks, over either package -------------

def _screen_ray_through_center(a):
    r = _make_renderer(a)
    ro, rd = a.ed.screen_ray(r, W // 2, H // 2)
    np.testing.assert_allclose(ro, [0, 1.5, 4], atol=0.15)
    eye = np.array([0, 1.5, 4.0])
    to_origin = -eye / np.linalg.norm(eye)
    assert float(rd @ to_origin) > 0.99


def _gizmo_hidden_until_attach(a):
    r = _make_renderer(a)
    tc = a.ed.TransformController(r)
    assert not r._mesh_masks()["hud"].any()
    mat = r.materials.insert(a.P.UnlitMaterial())
    key = r.add_mesh(a.box(0.5), mat)
    tc.attach(r.meshes.get(key).transform_key)
    assert r._mesh_masks()["hud"].any()
    tc.detach()
    assert not r._mesh_masks()["hud"].any()


def _attached(a, **kw):
    r = _make_renderer(a)
    mat = r.materials.insert(a.P.UnlitMaterial())
    key = r.add_mesh(a.box(0.5), mat)
    tk = r.meshes.get(key).transform_key
    tc = a.ed.TransformController(r, **kw)
    tc.attach(tk)
    return r, tc, tk


def _translate_drag_moves_target(a):
    r, tc, tk = _attached(a)
    tc._drag = {"mode": a.ed.GizmoMode.TRANSLATE, "axis": 0,
                "a": np.array([1, 0, 0], F), "center": np.zeros(3, F),
                "t0": a.P.Transform(), "s0": 0.0}
    tc.on_pointer_move(W // 2 + 20, H // 2)
    moved = r.transforms.get_local(tk).translation
    assert moved[0] > 0.05, f"target did not move along +x: {moved}"
    assert abs(moved[1]) < 0.05 and abs(moved[2]) < 0.3


def _rotate_drag_spins_target(a):
    r, tc, tk = _attached(a, mode=a.ed.GizmoMode.ROTATE)
    tc._drag = {"mode": a.ed.GizmoMode.ROTATE, "axis": 1,
                "a": np.array([0, 1, 0], F), "center": np.zeros(3, F),
                "t0": a.P.Transform(), "angle0": 0.0}
    tc.on_pointer_move(W // 2 + 15, H // 2)
    q = r.transforms.get_local(tk).rotation
    assert abs(q[1]) > 1e-3
    np.testing.assert_allclose(np.linalg.norm(q), 1.0, atol=1e-5)


def _scale_drag(a):
    r, tc, tk = _attached(a, mode=a.ed.GizmoMode.SCALE)
    tc._drag = {"mode": a.ed.GizmoMode.SCALE, "axis": 0,
                "a": np.array([1, 0, 0], F), "center": np.zeros(3, F),
                "t0": a.P.Transform(), "s0": 0.0}
    tc.on_pointer_move(W // 2 + 20, H // 2)
    s = r.transforms.get_local(tk).scale
    assert s[0] != 1.0 and s[1] == 1.0


def _gizmo_pick_and_full_drag_cycle(a):
    r = _make_renderer(a)
    mat = r.materials.insert(a.P.UnlitMaterial(
        base_color_factor=np.array([1, 1, 0, 1], F)))
    key = r.add_mesh(a.box(0.5), mat)
    tc = a.ed.TransformController(r)
    tc.attach(r.meshes.get(key).transform_key)
    r.render()
    found = next(((x, y) for y in range(0, H, 2) for x in range(0, W, 2)
                  if r.pick(x, y) in tc._parts), None)
    assert found, "no gizmo part visible on screen"
    assert tc.on_pointer_down(*found)
    assert tc.dragging
    tc.on_pointer_move(found[0] + 4, found[1])
    tc.on_pointer_up()
    assert not tc.dragging


def _grid_renders_lines(a):
    r = _make_renderer(a)
    a.ed.Grid(r, size=50.0, spacing=1.0)
    img = _img(r.render())
    strip = img[H - 8, :, 0]
    assert strip.std() > 0.01, "grid should produce varying intensity"
    return img


def _session_scene(a):
    r = a.renderer()
    mat = r.materials.insert(a.P.UnlitMaterial(
        base_color_factor=np.array([1, 0.2, 0.2, 1], F)))
    key = r.add_mesh(a.box(0.6), mat)
    s = a.sess.InteractiveSession(r, editor=True, camera=a.sess.OrbitCamera(
        center=(0, 0, 0), radius=4.0, yaw=0.0, pitch=0.35))
    return r, s, key


def _translate_handle_px(r, s, a):
    """The first pixel (rows, then columns, step 2) showing a translate
    handle: (x, y, handle key)."""
    for y in range(0, H, 2):
        for x in range(0, W, 2):
            k = r.pick(x, y)
            if (k in s.controller._parts
                    and s.controller._parts[k][0] == a.ed.GizmoMode.TRANSLATE):
                return x, y, k
    return None


def _session_drag_end_to_end(a):
    r, s, key = _session_scene(a)
    s.step(0.0)
    s.step(0.0, [("pointer_down", W // 2, H // 2), ("pointer_up",)])
    tk = r.meshes.get(key).transform_key
    assert s.selected == key
    assert s.controller.target == tk
    assert r._mesh_masks()["hud"].any()
    s.step(0.0)
    found = _translate_handle_px(r, s, a)
    assert found is not None, "no translate handle visible"
    hx, hy, _k = found
    t0 = r.transforms.get_local(tk).translation.copy()
    img1 = _img(s.step(0.0, [("pointer_down", hx, hy)]))
    assert s.controller.dragging
    img2 = _img(s.step(0.0, [("pointer_move", hx + 14, hy + 6)]))
    s.step(0.0, [("pointer_up",)])
    assert not s.controller.dragging
    t1 = r.transforms.get_local(tk).translation
    assert np.abs(t1 - t0).max() > 1e-3, (t0, t1)
    assert np.abs(img2 - img1).max() > 0.05


def _session_orbit_and_wheel(a):
    r, s, _key = _session_scene(a)
    img0 = _img(s.step(0.0))
    eye0 = s.camera.eye().copy()
    img1 = _img(s.step(0.0, [("pointer_down", 4, 4), ("pointer_move", 34, 10),
                             ("pointer_up",)]))
    assert np.abs(s.camera.eye() - eye0).max() > 1e-2
    assert np.abs(img1 - img0).max() > 0.05
    r0 = s.camera.radius
    s.step(0.0, [("wheel", 3.0)])
    assert s.camera.radius > r0


def _session_runtime_toggles_and_resize(a):
    r, s, _key = _session_scene(a)
    s.step(0.0, [("set", "bloom", True), ("set", "smaa", True)])
    assert r.config.post_processing.bloom
    assert r.config.anti_aliasing.smaa
    s.step(0.0, [("set", "bloom", False)])
    assert not r.config.post_processing.bloom
    img = _img(s.step(0.0, [("resize", 256, 32)]))
    assert img.shape == (32, 256, 4)


CHECKS = {
    "screen_ray_through_center": _screen_ray_through_center,
    "gizmo_hidden_until_attach": _gizmo_hidden_until_attach,
    "translate_drag_moves_target": _translate_drag_moves_target,
    "rotate_drag_spins_target": _rotate_drag_spins_target,
    "scale_drag": _scale_drag,
    "gizmo_pick_and_full_drag_cycle": _gizmo_pick_and_full_drag_cycle,
    "grid_renders_lines": _grid_renders_lines,
    "session_drag_end_to_end": _session_drag_end_to_end,
    "session_orbit_and_wheel": _session_orbit_and_wheel,
    "session_runtime_toggles_and_resize": _session_runtime_toggles_and_resize,
}


# ---- the scripted session ----------------------------------------------

def _script(a, handle=None):
    """Run the scripted event list through a's InteractiveSession. handle:
    the translate-handle pixel to drag (None: find it, as JAX's run does).
    Returns a record of every step and the handle pixel used. The toggles
    come first and end at the base configuration, so JAX's frames reuse
    the compiles of the toggle and drag checks run before it."""
    r, s, key = _session_scene(a)
    tk = r.meshes.get(key).transform_key
    rec = {"imgs": [], "eye": [], "selected": [], "config": [], "key": key}

    def step(events=()):
        rec["imgs"].append(_img(s.step(0.0, events)))
        rec["eye"].append(s.camera.eye().copy())
        rec["selected"].append(s.selected)
        c = r.config
        rec["config"].append((c.width, c.height, c.post_processing.bloom,
                              c.anti_aliasing.smaa))

    step()
    step([("set", "bloom", True), ("set", "smaa", True)])
    step([("set", "bloom", False)])
    step([("resize", 256, 32)])
    step([("resize", W, H), ("set", "smaa", False)])
    step([("pointer_down", 4, 4), ("pointer_move", 34, 10), ("pointer_up",)])
    step([("wheel", -2.0)])
    step([("pointer_down", W // 2, H // 2), ("pointer_up",)])
    rec["target"] = s.controller.target
    rec["hud"] = bool(r._mesh_masks()["hud"].any())
    if handle is None:
        handle = _translate_handle_px(r, s, a)
    hx, hy, hk = handle
    rec["handle"] = handle
    rec["handle_pick"] = r.pick(hx, hy)
    rec["t0"] = r.transforms.get_local(tk).translation.copy()
    step([("pointer_down", hx, hy)])
    rec["dragging"] = s.controller.dragging
    step([("pointer_move", hx + 14, hy + 6)])
    step([("pointer_up",)])
    rec["t1"] = r.transforms.get_local(tk).translation.copy()
    rec["world"] = r.transforms.world_of(tk).copy()
    return rec


N_STEPS = 11
# JAX threads: the checks in one group run in order, so a later frame
# reuses the compiles of an earlier one with the same specialization
_GROUPS = (
    ("session_runtime_toggles_and_resize", "session_drag_end_to_end",
     "script"),
    ("grid_renders_lines",),
    ("gizmo_pick_and_full_drag_cycle",),
    ("screen_ray_through_center", "gizmo_hidden_until_attach",
     "translate_drag_moves_target", "rotate_drag_spins_target",
     "scale_drag", "session_orbit_and_wheel"),
)


def _run_group(names):
    a = _Api("jax")
    out = {}
    for n in names:
        try:
            out[n] = (None, (_script(a) if n == "script" else CHECKS[n](a)))
        except Exception as e:          # re-raised by the test that reads it
            out[n] = (e, None)
    return out


@pytest.fixture(scope="module")
def jax_runs():
    """{name: future of (exception, result)}: every JAX check and the JAX
    session script, started together in threads."""
    from concurrent.futures import ThreadPoolExecutor

    _Api("jax")                  # import the package before the threads
    ex = ThreadPoolExecutor(len(_GROUPS))
    groups = [(names, ex.submit(_run_group, names)) for names in _GROUPS]
    yield {n: fut for names, fut in groups for n in names}
    ex.shutdown(wait=True)


def _jax_result(jax_runs, name):
    err, res = jax_runs[name].result()[name]
    if err is not None:
        raise err
    return res


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("name", list(CHECKS))
def test_editor_check(jax_runs, name, pkg):
    if pkg == "jax":
        _jax_result(jax_runs, name)
    else:
        CHECKS[name](_Api("torch"))


def _hold_image(got, want):
    assert got.shape == want.shape
    diff = np.abs(np.round(got * 255) - np.round(want * 255))
    assert (diff > 4).mean() < 0.005, (diff > 4).mean()


def test_grid_frame_matches_jax(jax_runs):
    want = _jax_result(jax_runs, "grid_renders_lines")
    _hold_image(_grid_renders_lines(_Api("torch")), want)


@pytest.fixture(scope="module")
def scripted(jax_runs):
    rj = _jax_result(jax_runs, "script")
    return rj, _script(_Api("torch"), handle=rj["handle"])


def test_script_selects_and_attaches(scripted):
    rj, rt = scripted
    assert rj["selected"] == rt["selected"]
    assert rt["selected"][-1] == rt["key"] and rt["selected"][0] is None
    assert rj["target"] == rt["target"] and rt["hud"] and rj["hud"]


def test_script_drags_the_handle(scripted):
    rj, rt = scripted
    assert rt["handle_pick"] == rj["handle"][2]      # the same handle
    assert rt["dragging"] and rj["dragging"]
    np.testing.assert_array_equal(rt["t0"], rj["t0"])
    assert np.abs(rt["t1"] - rt["t0"]).max() > 1e-3
    np.testing.assert_allclose(rt["world"], rj["world"], rtol=1e-5,
                               atol=1e-6)


def test_script_orbits_and_zooms(scripted):
    rj, rt = scripted
    for ej, et in zip(rj["eye"], rt["eye"]):
        np.testing.assert_array_equal(et, ej)
    assert np.abs(rt["eye"][5] - rt["eye"][4]).max() > 1e-2   # orbit
    assert np.linalg.norm(rt["eye"][6]) < np.linalg.norm(rt["eye"][5])


def test_script_toggles_and_resize(scripted):
    rj, rt = scripted
    assert rt["config"] == rj["config"]
    assert rt["config"][:5] == [(W, H, False, False), (W, H, True, True),
                                (W, H, False, True), (256, 32, False, True),
                                (W, H, False, False)]
    assert rt["imgs"][3].shape == (32, 256, 4)
    assert rt["imgs"][4].shape == (H, W, 4)


@pytest.mark.parametrize("i", range(N_STEPS))
def test_script_step_image_matches_jax(scripted, i):
    rj, rt = scripted
    assert len(rt["imgs"]) == len(rj["imgs"]) == N_STEPS
    _hold_image(rt["imgs"][i], rj["imgs"][i])
