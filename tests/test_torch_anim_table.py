"""PyTorch port, the animation layer's row table (core/animation.py
Animations._row_table / _apply_table) against the per-channel path it
replaces for the channels it takes.

Each case builds one scene twice: one copy steps through update_all as
the program does, the other through the same update_all with its
Animations.update put together from the per-channel path alone
(_advance, _sample, _apply_channels: every channel stashed and applied
one at a time). After each step the two copies hold equal local TRS
rows, world and normal matrices, joint matrices and morph weights: the
rotation columns to float32 rounding, everything else exactly.

Cases: the avatar room (port_bench's avatar-room-msaa, twelve avatars of
67 channels and a 65-joint skin each, at small meshes), a crossfade
caught in the middle, a CUBICSPLINE channel beside LINEAR ones, two
full-weight players on one target (last writer wins), two part-weight
players on one target (blended), a finished ONCE
player beside a stopped one at time 0, and a player then a transform
removed (the table rebuilt). Also the counter animation/table_channels,
and the editor's reads and writes of one transform's TRS beside a
rotation the table wrote."""

import os
import sys

import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (torch's threads under xdist)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import awsm_renderer_tpu_torch as P  # noqa: E402
from awsm_renderer_tpu_torch.errors import AllocatorError  # noqa: E402
from awsm_renderer_tpu_torch.geometry import box  # noqa: E402
from awsm_renderer_tpu_torch.utils import math3d as m3  # noqa: E402
from awsm_renderer_tpu_torch.utils import native  # noqa: E402

F = np.float32
DT = 1.0 / 60.0
AVATAR_CHANNELS = 12 * 67


@pytest.fixture(autouse=True)
def _native():
    if native._load() is None:
        pytest.skip("the native host library could not be built here")


def per_channel(r):
    """Make r's animations step through the per-channel path alone."""
    anim = r.animations

    def update(dt, transforms, meshes):
        act = anim._advance(dt)
        if act:
            if anim._native_tables is None:
                anim._build_native_tables()
            nt = anim._native_tables
            anim._apply_channels(nt, anim._sample(nt), None, act,
                                 transforms, meshes)

    anim.update = update
    return r


def assert_same(a, b):
    ta, tb = a.transforms, b.transforms
    np.testing.assert_array_equal(ta._local_trs[:, :3], tb._local_trs[:, :3])
    np.testing.assert_array_equal(ta._local_trs[:, 7:], tb._local_trs[:, 7:])
    np.testing.assert_allclose(ta._local_trs[:, 3:7], tb._local_trs[:, 3:7],
                               rtol=1e-6, atol=0)
    for name in ("world", "normal"):
        np.testing.assert_allclose(getattr(ta, name), getattr(tb, name),
                                   rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(a.meshes.morph_weights,
                                  b.meshes.morph_weights)
    np.testing.assert_array_equal(a.skins.joint_matrices,
                                  b.skins.joint_matrices)


def _quats(rng, K):
    q = rng.standard_normal((K, 4)).astype(F)
    return (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(F)


def _sampler(rng, path, interp=P.Interpolation.LINEAR, K=9, D=4, end=2.0):
    times = np.linspace(0.0, end, K).astype(F)
    width = {P.TargetPath.TRANSLATION: 3, P.TargetPath.SCALE: 3,
             P.TargetPath.ROTATION: 4, P.TargetPath.WEIGHTS: D}[path]
    if path == P.TargetPath.ROTATION:
        values = _quats(rng, K * (3 if interp == P.Interpolation.CUBIC_SPLINE
                                  else 1))
    else:
        values = rng.uniform(0.5, 1.5, (K * (
            3 if interp == P.Interpolation.CUBIC_SPLINE else 1), width))
    if interp == P.Interpolation.CUBIC_SPLINE:
        values = values.reshape(K, 3, width)
    return P.AnimationSampler(times=times, values=values, interpolation=interp)


class Rig:
    """A chain of six joints under a root, skinned, two boxes whose morph
    weights animate, and a loose node; built from a seed, so two Rigs of
    one seed are the same scene."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        r = self.r = P.AwsmRendererTorch(P.RendererConfig(), device="cpu")
        tr = r.transforms
        self.joints = [tr.insert(P.Transform())]
        for j in range(5):
            self.joints.append(tr.insert(P.Transform(
                translation=np.array([0, 0.3, 0], F)), parent=self.joints[-1]))
        self.loose = tr.insert(P.Transform(translation=np.array([2, 0, 0], F)))
        tr.update_world()
        ibm = np.tile(np.eye(4, dtype=F), (6, 1, 1))
        ibm[:, 1, 3] = -0.3 * np.arange(6)
        self.skin = r.skins.insert(self.joints, ibm)
        mat = r.materials.insert(P.PbrMaterial())
        self.meshes = [r.add_mesh(box(0.5), mat, P.Transform(
            translation=np.array([k, 0, 1], F))) for k in range(2)]

    def clip(self, paths, interp=P.Interpolation.LINEAR, end=2.0):
        """One channel for each (path, target) of `paths`."""
        chans = []
        for path, target in paths:
            s = _sampler(self.rng, path, interp, end=end)
            if path == P.TargetPath.WEIGHTS:
                chans.append(P.AnimationChannel(s, path, mesh_key=target))
            else:
                chans.append(P.AnimationChannel(s, path, transform_key=target))
        return P.AnimationClip(chans)

    def play(self, clip, **kw):
        return self.r.animations.insert(P.AnimationPlayer(clip, **kw))


R, T, S, W = (P.TargetPath.ROTATION, P.TargetPath.TRANSLATION,
              P.TargetPath.SCALE, P.TargetPath.WEIGHTS)


def _body(rig):
    """A body clip: every joint's rotation, the root's translation and
    scale, and the first box's weights."""
    return rig.clip([(R, j) for j in rig.joints]
                    + [(T, rig.joints[0]), (S, rig.joints[0]),
                       (W, rig.meshes[0])])


def avatar():
    import tempfile

    from port_bench import run

    _w, cfg, _mix, mod = run.cell("avatar-room-msaa.animate")
    cfg["render"].update(width=256, height=144)
    cfg["body"].update(ring=6, segments=1)
    cfg["head"].update(lat=10, lon=12)
    cfg["map_size"] = 64
    scene = mod.build_scene(cfg, 3100000041)
    with tempfile.TemporaryDirectory() as tmp:
        r = mod.load_program(scene, torch.device("cpu"), tmp)
    return r, []


def crossfade():
    rig = Rig(11)
    a = rig.play(_body(rig))
    b = rig.play(_body(rig))
    rig.play(rig.clip([(T, rig.loose), (W, rig.meshes[1])]))
    rig.r.animations.get(b).playing = False

    def fade(r, i):
        if i == 3:
            r.animations.crossfade(a, b, 0.5)
    return rig.r, [fade]


def cubic():
    rig = Rig(12)
    rig.play(_body(rig))
    rig.play(rig.clip([(T, rig.loose), (R, rig.loose)],
                      P.Interpolation.CUBIC_SPLINE))
    rig.play(rig.clip([(S, rig.loose), (W, rig.meshes[1])],
                      P.Interpolation.STEP))
    return rig.r, []


def last_writer():
    rig = Rig(13)
    rig.play(_body(rig))
    rig.play(rig.clip([(R, rig.joints[2]), (T, rig.joints[0]),
                       (W, rig.meshes[0]), (T, rig.loose)]))
    return rig.r, []


def blended():
    rig = Rig(16)
    rig.play(_body(rig))
    rig.play(rig.clip([(R, rig.joints[4]), (S, rig.loose)]), weight=0.7)
    rig.play(rig.clip([(R, rig.joints[4]), (S, rig.loose)]), weight=0.3)
    return rig.r, []


def once_and_stopped():
    rig = Rig(14)
    rig.play(_body(rig), loop_style=P.LoopStyle.ONCE, speed=8.0)
    rig.play(rig.clip([(T, rig.loose), (W, rig.meshes[1])]), playing=False)
    rig.play(rig.clip([(S, rig.loose)], end=0.1),
             loop_style=P.LoopStyle.ONCE)
    return rig.r, []


def removed():
    rig = Rig(15)
    rig.play(_body(rig))
    p = rig.play(rig.clip([(T, rig.loose), (R, rig.loose),
                           (W, rig.meshes[1])]))

    def drop(r, i):
        if i == 4:
            r.animations.remove(p)
        if i == 6:
            r.transforms.remove(rig.loose)
            # the freed row taken by a node no channel drives: the
            # table, rebuilt, writes nothing into it
            rig.new = r.transforms.insert(P.Transform(
                translation=np.array([5, 6, 7], F)))
        if i == 8:
            np.testing.assert_array_equal(
                r.transforms.get_local(rig.new).translation, [5, 6, 7])
    return rig.r, [drop]


SCENES = {f.__name__: f for f in (avatar, crossfade, cubic, last_writer,
                                  blended, once_and_stopped, removed)}


@pytest.mark.parametrize("case", list(SCENES) + ["counter"])
def test_table_matches_per_channel(case):
    """The row table's copy equals the per-channel copy after each of 12
    update_all steps; the counter case reads animation/table_channels:
    804 a frame on the avatar room, and none while a crossfade runs."""
    if case == "counter":
        return _counter()
    (table, hooks), (ref, ref_hooks) = SCENES[case](), SCENES[case]()
    per_channel(ref)
    for i in range(12):
        for r, hs in ((table, hooks), (ref, ref_hooks)):
            for h in hs:
                h(r, i)
            r.update_all(DT)
        assert_same(table, ref)
    assert table.animations._native_tables["rows"] is not None


def _counter():
    r, _ = avatar()
    r.logging_timings = True
    for _ in range(3):
        r.update_all(DT)
    counts = r.timings.counts
    assert counts["animation/channels"] == 3 * AVATAR_CHANNELS
    assert counts["animation/table_channels"] == 3 * AVATAR_CHANNELS

    r, hooks = crossfade()
    r.logging_timings = True
    tc = []
    for i in range(8):
        for h in hooks:
            h(r, i)
        before = r.timings.counts.get("animation/table_channels", 0)
        r.update_all(DT)
        tc.append(r.timings.counts["animation/table_channels"] - before)
    # before the fade the first and third players' channels are the
    # table's (the second is stopped at time 0; the first and second
    # collide, so theirs never are); during it none are
    assert tc[:3] == [2] * 3 and tc[3:] == [0] * 5


def test_editor_reads_and_writes_beside_the_table():
    """set_translation after a rotation the table wrote keeps that
    rotation; get_local returns the row's TRS; set_rotation and set_scale
    write their own columns alone."""
    rig = Rig(21)
    rig.play(rig.clip([(R, rig.loose)]))
    r, tk = rig.r, rig.loose
    r.update_all(DT)
    assert r.animations._native_tables["rows"]["table"].all()
    row = r.transforms.row_of(tk)
    q = r.transforms._local_trs[row, 3:7].copy()
    assert not np.array_equal(q, m3.quat_identity())
    local = r.transforms.get_local(tk)
    np.testing.assert_array_equal(local.translation, [2, 0, 0])
    np.testing.assert_array_equal(local.rotation, q)
    np.testing.assert_array_equal(local.scale, [1, 1, 1])

    r.transforms.set_translation(tk, np.array([1, 2, 3], F))
    np.testing.assert_array_equal(r.transforms._local_trs[row],
                                  np.concatenate([[1, 2, 3], q, [1, 1, 1]]))
    r.transforms.set_scale(tk, [2, 2, 2])
    np.testing.assert_array_equal(r.transforms.get_local(tk).rotation, q)
    np.testing.assert_array_equal(r.transforms.get_local(tk).scale, [2, 2, 2])
    r.transforms.update_world()
    np.testing.assert_allclose(
        r.transforms.world_of(tk),
        m3.trs_to_mat4(np.array([1, 2, 3], F), q, np.array([2, 2, 2], F)),
        rtol=1e-6, atol=1e-6)

    # a whole-row edit, as the editor's gizmo and instancing make it
    local = r.transforms.get_local(tk)
    local.translation = np.array([0, 1.5, 0], F)
    r.transforms.set_local(tk, local)
    np.testing.assert_array_equal(r.transforms.get_local(tk).translation,
                                  [0, 1.5, 0])
    np.testing.assert_array_equal(r.transforms.get_local(tk).rotation, q)
    r.transforms.set_rotation(tk, m3.quat_identity())
    np.testing.assert_array_equal(r.transforms.get_local(tk).translation,
                                  [0, 1.5, 0])

    # a live channel whose target was removed: both paths refuse it alike
    r.transforms.remove(tk)
    with pytest.raises(AllocatorError):
        r.update_all(DT)
