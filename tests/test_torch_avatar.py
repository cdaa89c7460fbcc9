"""PyTorch port, the avatar room (port_bench's avatar-room-msaa.animate)
at a CPU test's size: two avatars with the whole 65-joint rig, four
influences a vertex and 52 face targets, but ~1,400 triangles each and
64 x 64 maps, at 256x144 with MSAA-4x. The asset goes through the port's
load_gltf + populate_gltf and is animated by update_all, as in the cell.

- the posing reference (port_bench/reference/pose.py) against the
  port's joint matrices and its vertex stage's morph and skin branches,
  after 1, 7 and a loop-wrapping number of update_all calls;
- the cell's whole run (run.run_cell) correct, and not correct under the
  stale frame and each planted animation fault, with the window's clock
  stepped so that each run finishes the same two frames on any host;
- the spans and counters of the animated path: update_all and its
  steps, write_gpu/animation, render_frame/vertex (the morph and skin
  branches run inside its launches, with no span of their own), and the
  counts animation/channels and skins/joints, with nothing recorded and
  a bit-equal image when timings are off."""

import itertools
import os
import sys
import time
import types

import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (torch's threads under xdist)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from port_bench import faults, faults_animate, run  # noqa: E402
from port_bench.reference import pose  # noqa: E402

CELL = "avatar-room-msaa.animate"
DT = 1.0 / 60.0
J, CHANNELS = 65, 67
# the whole run's window: run.py reads perf_counter once to open it and
# three times a frame (start, host done, synchronized); at 1.25 s a read
# the second frame finishes at 7.5 s after the open, inside the 8 s
# window, and the third would start at 8.75 s, after it closes
WINDOW_S, READ_S, WINDOW_FRAMES = 8.0, 1.25, 2


def small(cfg, mix):
    """The cell at a CPU test's size: the rig, the influences, the
    targets and the clips whole; two avatars 0.4 m apart, of 64 tubes of
    6 x 1 quads and a cap (1,152 triangles) and a 10 x 12 head (240).
    The camera looks level at the heads from 0.55 m, so a face spans
    ~40 px, more than a 32 x 32 window of bad_tile, as at 1080p."""
    cfg["render"].update(width=256, height=144)
    cfg["layout"].update(rows=1, per_row=2, spacing=0.4)
    cfg["body"].update(ring=6, segments=1)
    cfg["head"].update(lat=10, lon=12)
    cfg["map_size"] = 64
    cfg["camera"].update(distance=0.55, target_height=1.6)
    cfg["check"]["frames"] = 1
    mix["warmup_frames"] = 1


def _program(seed, tmp_path, msaa=True):
    _w, cfg, mix, mod = run.cell(CELL)
    small(cfg, mix)
    cfg["render"]["msaa"] = msaa
    scene = mod.build_scene(cfg, seed)
    r = mod.load_program(scene, torch.device("cpu"), str(tmp_path))
    return scene, r


def _posed_corners(r, skin_sets):
    """World-space corners (3, 3, T) and unit normals of the device pool
    through the vertex stage's morph and skin branches (ops/vertex.py),
    and the pool's mesh rows (T,)."""
    from awsm_renderer_tpu_torch.ops import vertex as V

    ds = r._flush()
    tri_mesh = ds["tri_mesh"]
    mesh = tri_mesh.clamp(0, ds["mesh_info"].shape[0] - 1)
    minfo = V.onehot_gather(mesh, ds["mesh_info"].float())
    pos = V._corner_comps(ds["c_pos"], 3)
    nrm = V._corner_comps(ds["c_norm"], 3)
    tan = V._corner_comps(ds["c_tang"], 4)
    V._morph(pos, nrm, tan, ds["c_morph_base"], ds["morph_deltas"],
             ds["morph_weights"], minfo, mesh)
    skin = V._skin(ds["c_joints"], ds["c_weights"], ds["joint_matrices"],
                   skin_sets)
    p_out, n_out = [], []
    for c in range(3):
        p_out.append(torch.stack(V._mat4_point(skin[c], pos[c])[:3]))
        n = torch.stack(V._mat3_vec(V._upper3(skin[c]), nrm[c]))
        n_out.append(n / n.norm(dim=0, keepdim=True))
    return (torch.stack(p_out).double().numpy(),
            torch.stack(n_out).double().numpy(), tri_mesh.numpy())


@pytest.fixture(scope="module")
def avatar_program(tmp_path_factory):
    """One program advanced through the cases in turn: [scene, renderer,
    update_all calls so far, a directory]."""
    tmp = tmp_path_factory.mktemp("avatar")
    return [*_program(2 ** 31 + 77, tmp), 0, tmp]


# float32 joint chains (up to 9 joints from the armature) and the port's
# sampler, which takes a normalised lerp where consecutive keys' quaternions
# lie within arccos(0.9995) (the reference slerps): at these clips' rates
# that is under 2e-6 rad a key interval, well inside 1e-5 m at 1-2 m arms
TOL = 1e-5


@pytest.mark.parametrize("updates", [1, 7, 241])
def test_pose_reference_matches_port_skins_and_vertex_stage(avatar_program,
                                                            updates):
    """pose.py's joint matrices and posed corners against the port's
    after the same number of update_all calls (241 wraps the 4 s loop)."""
    if avatar_program[2] > updates:
        avatar_program[:3] = [*_program(2 ** 31 + 77, avatar_program[3]), 0]
    scene, r, done = avatar_program[:3]
    for _ in range(updates - done):
        r.update_all(DT)
    avatar_program[2] = updates
    rig = scene.meta["rig"]
    dur = float(rig["clips"][0]["times"][-1])
    t = pose.player_time(updates, DT, dur)
    for _, p in r.animations.items():
        assert p.time == t
    assert len(r.skins._skins) == len(rig["placements"]) == 2
    for a, skin in enumerate(r.skins._skins.values()):
        assert len(skin.joint_keys) == J
        port = r.skins.joint_matrices[skin.base:skin.base + J]
        np.testing.assert_allclose(port, pose.joint_matrices(rig, a, t),
                                   rtol=0, atol=TOL)
    posed = pose.pose_scene(scene, [(t, t)] * len(rig["placements"]))
    pc, nc, tri_mesh = _posed_corners(r, skin_sets=1)
    rows = [r.meshes._mesh_alloc.row_of(k) for k, _ in r.meshes.items()]
    assert len(rows) == len(rig["instances"])
    for (mi, _a, _part), row in zip(rig["instances"], rows):
        sel = np.nonzero(tri_mesh == row)[0]
        m = posed.meshes[mi]
        idx = np.asarray(m.indices, np.int64)
        assert sel.size == idx.shape[0]
        for c in range(3):
            np.testing.assert_allclose(pc[c][:, sel].T, m.positions[idx[:, c]],
                                       rtol=0, atol=TOL)
            np.testing.assert_allclose(nc[c][:, sel].T, m.normals[idx[:, c]],
                                       rtol=0, atol=1e-4)


@pytest.mark.parametrize("wrap", [None, "stale", "players_paused",
                                  "face_paused", "body_late"])
def test_cell_correct_and_faults_caught(monkeypatch, wrap):
    """The whole run is correct; the stale frame and each animation fault
    (every player paused: the bind pose; the face players paused; the
    body clips one frame behind) are not. run.py's window clock advances
    READ_S a read (its set-up clock stays the wall clock), so the window
    holds WINDOW_FRAMES frames however long a CPU frame takes."""
    reads = itertools.count(1)
    monkeypatch.setattr(run, "time", types.SimpleNamespace(
        time=time.time, perf_counter=lambda: next(reads) * READ_S))
    fn = None if wrap is None else {**faults.WRAPS,
                                    **faults_animate.WRAPS}[wrap]
    res = run.run_cell(CELL, 2 ** 31 + 5, WINDOW_S, False, device="cpu",
                       edit_cfg=small, wrap=fn, log=lambda m: None)
    assert res["attempted"] == WINDOW_FRAMES
    assert res["correct"] is (wrap is None), res["check"]


def test_spans_and_counts_of_the_animated_path(tmp_path):
    """With timings on a frame of update_all + render_device records the
    animated path's spans and counts 2 x 67 channels and 2 x 65 joint
    matrices; with timings off nothing is recorded and the image is
    bit-equal."""
    _scene, on = _program(3, tmp_path, msaa=False)
    _scene, off = _program(3, tmp_path, msaa=False)
    on.logging_timings = True
    for _ in range(2):
        for r in (on, off):
            r.update_all(DT)
        img_on, img_off = on.render_device(), off.render_device()
        assert torch.equal(img_on, img_off)
    assert off.timings.frames == [] and off.timings.counts == {}
    spans = set().union(*on.timings.frames)
    assert {"update_all", "update_all/animations", "update_all/transforms",
            "update_all/skins", "write_gpu/animation",
            "render_frame/vertex"} <= spans
    assert not spans & {"render_frame/vertex/morph",
                        "render_frame/vertex/skin"}
    for f in on.timings.frames:
        assert f["update_all/skins"] <= f["update_all"]
    n = len(on.timings.frames)
    assert on.timings.counts["animation/channels"] == n * 2 * CHANNELS
    assert on.timings.counts["skins/joints"] == n * 2 * J
