"""The editing session and what the harness needed for it: near-plane
clipping in the shared reference (against the program, and leaving the
orbit cells' reference images as they were), a configuration's own
reference (taken by check.render_reference and by the control), and the
colonnade-msaa-editor.edit cell run whole on the CPU: `correct` true,
the driver's replayed translation equal to the program's, and `correct`
false for each fault planted in the session (the gizmo or the grid left
out of the image, the drag's transform edit dropped), for the faults
every cell can have (a stale step, an altered answer, half the image)
and for the control."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from _small import small
from port_bench import check, faults, program, run
from port_bench.reference import editor, render
from port_bench.scene import (
    Light, Material, Mesh, Scene, Texture, look_at, perspective, translation,
)

sys.path.insert(0, os.path.join(run.HERE, "configs"))

import _shapes  # noqa: E402

F = np.float32
# the CPU comparison's allowance, as test_pb_reference.py's
CPU_MEAN_ABS = 1e-3
CPU_BAD_PX = 0.002
EDIT = "colonnade-msaa-editor.edit"


def _crossing_scene(w, h):
    """A textured ground plane whose two triangles reach behind the
    camera, seen from 6 cm above it, looking down at 45 degrees: the near
    plane cuts the ground inside the frame. A box stands on it."""
    ground = dict(_shapes.plane(40.0))
    ground["uv0"] = ground["uv0"] * 20.0
    mats = [Material(base_color=np.array([0.9, 0.8, 0.7, 1], F),
                     metallic=0.1, roughness=0.6, textures={"base": 0}),
            Material(base_color=np.array([0.3, 0.5, 0.9, 1], F),
                     metallic=0.0, roughness=0.4)]
    tex = [Texture(_shapes.checker(64, 8, (230, 200, 60), (40, 40, 90)),
                   srgb=True, kind="color")]
    meshes = [Mesh(**ground, world=np.eye(4, dtype=F), material=0),
              Mesh(**_shapes.box(0.6), world=translation([0.3, 0.3, -1.6]),
                   material=1)]
    sun = np.array([-0.3, -1.0, -0.2], F)
    st = {"width": w, "height": h, "msaa": False, "mipmap": True,
          "bloom": False, "dof": False, "tonemap": "khronos_pbr_neutral",
          "max_transparent_layers": 4}
    scene = Scene(meshes=meshes, materials=mats, textures=tex,
                  lights=[Light("directional", np.ones(3, F), 2.0,
                                direction=sun / np.linalg.norm(sun))],
                  env_equirect=_shapes.sky_equirect(), env_size=32,
                  settings=st, camera={})
    view = look_at([0, 0.06, 0], [0, -1.0, -1.0], [0, 1, 0])
    return scene, view, perspective(np.pi / 3, w / h, 0.1, 100.0)


def test_a_triangle_across_the_near_plane_matches_the_program():
    scene, view, proj = _crossing_scene(256, 128)
    ref = render.Reference(scene, "cpu")
    vp = (proj.astype(np.float64) @ view.astype(np.float64)).astype(F)
    tri, _ = ref._near_clip(ref.tri, ref._clip(ref.tri["pos"], vp))
    # one ground triangle keeps two corners in front and is cut in two,
    # the other keeps one
    assert tri["mat"].shape[0] == ref.tri["mat"].shape[0] + 1
    r = program.load(scene, "cpu")
    r.camera.update(view, proj)
    img = ref.render(view, proj)
    got = check.compare(r.render_device(), img, 4 / 255)
    assert got["bad_px"] <= CPU_BAD_PX, got
    assert got["mean_abs"] <= CPU_MEAN_ABS, got
    # the cut shows: ground in front of it, sky past it
    assert 0.05 < float(img[..., 3].mean()) < 0.95


@pytest.mark.parametrize("workload", ["colonnade-msaa.orbit",
                                      "helmet-ibl.orbit"])
def test_orbit_reference_images_are_unchanged_by_clipping(workload,
                                                          monkeypatch):
    """No triangle of the orbit cells crosses the near plane (the shared
    reference raised on one before it clipped): the clipping hands back
    the tables it was given, and the images are bit-equal to the ones
    rendered with it taken out."""
    _w, cfg, mix, mod = run.cell(workload)
    small(cfg, mix, 128, 64)
    scene = mod.build_scene(cfg, 2 ** 32 + 21)
    drv = run.driver(mix, scene, 2 ** 32 + 21)
    frames = [drv.shown(i) for i in (0, 7, 40)]
    ref = render.Reference(scene, "cpu")
    for _sc, view, proj in frames:
        vp = (np.asarray(proj, np.float64) @ np.asarray(view, np.float64)
              ).astype(F)
        clip = ref._clip(ref.tri["pos"], vp)
        assert ref._near_clip(ref.tri, clip)[0] is ref.tri
    clipped = list(check.render_reference(frames, "cpu"))
    monkeypatch.setattr(render.Reference, "_near_clip",
                        lambda self, tri, clip: (tri, clip))
    for a, b in zip(clipped, check.render_reference(frames, "cpu")):
        assert torch.equal(a, b)


class _Counting(render.Reference):
    made, rendered = [], []

    def __init__(self, scene, device, dtype=torch.float32):
        super().__init__(scene, device, dtype)
        _Counting.made.append(dtype)

    def render(self, view, proj):
        _Counting.rendered.append(np.asarray(view).copy())
        return super().render(view, proj)


def test_render_reference_takes_the_configuration_reference():
    scene, view, proj = _crossing_scene(64, 32)
    _Counting.made.clear()
    _Counting.rendered.clear()
    imgs = list(check.render_reference([(scene, view, proj)] * 2, "cpu",
                                       reference=_Counting))
    assert _Counting.made == [torch.float32] and len(_Counting.rendered) == 2
    assert torch.equal(imgs[0], next(check.render_reference(
        [(scene, view, proj)], "cpu")))
    assert run.reference_of(run.cell(EDIT)[3]) is editor.Reference
    assert run.reference_of(run.cell("helmet-ibl.orbit")[3]) \
        is render.Reference
    # the shared reference refuses what it cannot draw
    hud = Scene(**dict(vars(scene), meshes=scene.meshes + [Mesh(
        **_shapes.box(0.1), world=np.eye(4, dtype=F), material=1,
        hud=True)]))
    with pytest.raises(ValueError):
        render.Reference(hud, "cpu")
    editor.Reference(hud, "cpu")


def test_the_control_renders_the_driver_s_frame_by_the_configuration():
    """The control takes the configuration's reference, in bfloat16, and
    renders what the driver says the frame being stepped shows (an edited
    scene gets a reference of its own); outside the window the program
    renders."""
    scene, view, proj = _crossing_scene(64, 32)
    moved = Scene(**dict(vars(scene), meshes=[scene.meshes[0], Mesh(**dict(
        vars(scene.meshes[1]), world=translation([-0.3, 0.3, -1.6])))]))

    class Drv:
        def shown(self, i):
            return (moved, view, proj)

    class Program:
        device = torch.device("cpu")

        def render_device(self):
            return "program"

    frame = run.Frame(_Counting)
    frame.drv = Drv()
    _Counting.made.clear()
    # the cell's own scene has its reference built in set-up
    entry = faults.control_bf16(Program(), scene, frame=frame)
    assert _Counting.made == [torch.bfloat16]
    assert entry() == "program" and len(_Counting.made) == 1
    frame.i = 5
    img = entry()
    assert _Counting.made == [torch.bfloat16] * 2
    want = render.Reference(moved, "cpu", torch.bfloat16).render(view, proj)
    assert torch.equal(img, want)


# ---- the edit cell, whole, on the CPU ---------------------------------------

def edit_small(cfg, mix):
    """The edit cell at a CPU test's size: the 3 x 3 colonnade at 256 x
    144 (a width the program's overlay takes: a multiple of 128), the
    camera at the configuration's 5 m, drags of one move, one warm-up
    drag; the press on the translate head, which is wider than the shaft
    at this size."""
    small(cfg, mix, 256, 144)
    cfg["camera"]["radius"] = 5.0
    mix.update(period=3, move_px=3, warmup_drags=1, plan_drags=20,
               handle_at=1.1)


SEED = 2 ** 31 + 5
RUN = f"""
import json, sys
sys.path.insert(0, {run.ROOT!r})
sys.path.insert(0, {os.path.join(run.HERE, 'tests')!r})
import numpy as np
import torch
torch.set_num_threads(1)
from port_bench import faults, run
from test_pb_edit import EDIT, SEED, edit_small
what = sys.argv[1]
if what == "replay":
    _w, _c, _m, _s, r, drv = run.open_cell(EDIT, SEED, torch.device("cpu"),
                                           edit_cfg=edit_small)
    tk = r.meshes.get(drv.session.selected).transform_key
    gaps = []
    for i in range(4):
        drv.step(i)
        got = np.asarray(r.transforms.get_local(tk).translation, np.float64)
        gaps.append(float(np.abs(got - drv.translation(i)).max()))
    moved = float(np.abs(drv.translation(1) - drv.translation(0)).max())
    print(json.dumps({{"gaps": gaps, "moved": moved}}))
else:
    res = run.run_cell(EDIT, SEED, 24.0, False, device="cpu",
                       edit_cfg=edit_small,
                       wrap=None if what == "sound" else faults.WRAPS[what],
                       log=lambda msg: None)
    print(json.dumps({{"correct": res["correct"], "failed": res["failed"],
                      "check": res["check"]}}))
"""
FAULTS = ("gizmo_hidden", "grid_hidden", "drag_dropped", "stale", "altered",
          "half", "control_bf16")
RUNS = ("sound", "replay") + FAULTS


@pytest.fixture(scope="module")
def edit_runs():
    """Each run of the cell in a process of its own, side by side (a
    CPU frame of the session takes seconds)."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = {w: subprocess.Popen([sys.executable, "-c", RUN, w],
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True,
                                 cwd=run.ROOT, env=env) for w in RUNS}
    out = {}
    for w, p in procs.items():
        so, se = p.communicate(timeout=900)
        assert p.returncode == 0, (w, se[-3000:])
        out[w] = json.loads(so.strip().splitlines()[-1])
    return out


def test_a_sound_edit_run_is_correct(edit_runs):
    res = edit_runs["sound"]
    assert res["correct"], res["check"]
    for n, v in res["check"].items():
        assert v["value"] <= v["limit"], (n, v)


def test_shown_replays_the_program_s_translation(edit_runs):
    got = edit_runs["replay"]
    assert got["moved"] > 0.01, got
    assert max(got["gaps"]) <= 1e-5, got


@pytest.mark.parametrize("fault", FAULTS)
def test_an_edit_fault_is_not_correct(edit_runs, fault):
    res = edit_runs[fault]
    assert not res["correct"], res["check"]
    assert res["failed"] >= 1
