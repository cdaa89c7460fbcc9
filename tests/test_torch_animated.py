"""PyTorch port, the animated vertex stage and instancing: morph targets,
skins, the animated-subset split of the vertex stage, instanced groups
(their combined geometry, picking through them, the overlay over the full
pool) — against the JAX renderer.

Setup rows are held to tests/test_torch_vertex.py's tolerance: triangle
validity agrees except on zero-area slivers; the integer-valued columns
(material row, tangent handedness, S_ORIG_ID as JAX writes it) are
equal; every other column is within 3e-5 of max(|value|, 1), the z-plane
(ZA, ZB, ZC) within 1e-4 / min(2*area in px^2, 1). Where the split runs,
the animated subset's rows carry their pool ids in S_ORIG_ID, so a
secondary clip row T + t of an animated triangle carries t, not T + t:
the S_ORIG_ID == row index property of tests/test_torch_vertex.py holds
only for unanimated scenes. Images are held to the goldens' tolerance
(< 0.5% of channel values off by more than 4/255). The JAX side's
compiles (one vertex stage a case, two frames) start in threads."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port as T

from awsm_renderer_tpu_torch.ops.vertex import (
    NSETUP, S_BB_MINX, S_MAT_ROW, S_ORIG_ID, S_TANGENT_W, S_ZA, S_ZC,
)

F = np.float32


def _pkg_mod(jax_side: bool):
    return importlib.import_module("awsm_renderer_tpu" if jax_side
                                   else "awsm_renderer_tpu_torch")


def _pkg(r):
    """(package, geometry, animation, math3d, meshes) of r's package."""
    name = type(r).__module__.split(".")[0]
    return tuple(importlib.import_module(f"{name}{sub}") for sub in (
        "", ".geometry", ".core.animation", ".utils.math3d", ".core.meshes"))


def _pair(jax_side: bool, **cfg):
    import awsm_renderer_tpu as J
    import awsm_renderer_tpu_torch as P

    if jax_side:
        return J.AwsmRendererTpu(J.RendererConfig(width=T.W, height=T.H,
                                                  **cfg))
    return P.AwsmRendererTorch(P.RendererConfig(width=T.W, height=T.H,
                                                **cfg), device="cpu")


def _skinned_strip(r):
    """A skinned strip lying along the view direction through the camera:
    16 segments from z = 3 (behind the eye) to z = -3, weights blending
    joint 0 into joint 1 along z, joint 1 swaying about x. The near plane
    cuts the strip, so the animated subset emits secondary clip rows."""
    m, _g, A, m3, meshes = _pkg(r)
    zs = np.linspace(3.0, -3.0, 17)
    pos, idx = [], []
    for i, z in enumerate(zs):
        pos += [[-0.6, 0.0, z], [0.6, 0.0, z]]
        if i:
            a = (i - 1) * 2
            idx += [[a, a + 1, a + 2], [a + 2, a + 1, a + 3]]
    pos = np.array(pos, F)
    V = len(pos)
    w1 = np.clip((3.0 - pos[:, 2]) / 6.0, 0, 1).astype(F)
    joints = np.zeros((V, 4), np.int32)
    joints[:, 1] = 1
    weights = np.zeros((V, 4), F)
    weights[:, 0] = 1 - w1
    weights[:, 1] = w1
    geo = meshes.MeshGeometry(positions=pos, indices=np.array(idx, np.int32),
                       normals=np.tile(np.array([[0, 1, 0]], F), (V, 1)),
                       joints=joints, weights=weights)
    j0 = r.transforms.insert(m.Transform())
    j1 = r.transforms.insert(m.Transform(), parent=j0)
    r.transforms.update_world()
    skin = r.skins.insert([j0, j1], np.stack([np.eye(4, dtype=F)] * 2))
    mat = r.materials.insert(m.PbrMaterial(
        base_color_factor=np.array([0.9, 0.6, 0.3, 1], F),
        double_sided=True))
    r.add_mesh(geo, mat, skin_key=skin)
    q = m3.quat_from_axis_angle([1, 0, 0], 0.2)
    r.animations.insert(A.AnimationPlayer(A.AnimationClip([
        A.AnimationChannel(A.AnimationSampler(
            times=[0, 1, 2], values=[m3.quat_identity(), q,
                                     m3.quat_identity()]),
            A.TargetPath.ROTATION, transform_key=j1)])))
    r.lights.insert(m.Light.directional([-0.5, -1, -0.3], intensity=2.5))
    r.update_all(0.35, m3.look_at([0, 0.02, 0.1], [0, 0, -2], [0, 1, 0]),
                 m3.perspective(np.pi / 3, T.W / T.H, 0.05, 500.0))


def _padded(r):
    """morph-cube with a static box appended after it: the pool's last
    live row belongs to the box (see test_pad_rows_never_written)."""
    m, g = _pkg(r)[:2]
    T.build(r, "morph-cube")
    mat = r.materials.insert(m.PbrMaterial(
        base_color_factor=np.array([0.2, 0.8, 0.3, 1], F)))
    r.add_mesh(g.box(0.3), mat, transform=m.Transform(
        translation=np.array([1.2, 0.0, 0.0], F)))
    r.update_all(0.0)


def _widened(r):
    """A box with nine morph targets, all weighted: the weights table
    widens from its initial 8 columns to 16."""
    m, g = _pkg(r)[:2]
    geo = g.box(0.8)
    rng = np.random.default_rng(7)
    geo.morph_positions = rng.uniform(-0.1, 0.1, (9, geo.vertex_count,
                                                  3)).astype(F)
    mat = r.materials.insert(m.PbrMaterial(
        base_color_factor=np.array([0.3, 0.5, 0.9, 1], F)))
    r.add_mesh(geo, mat, initial_morph_weights=np.linspace(
        0.1, 0.9, 9).astype(F))
    r.lights.insert(m.Light.directional([-0.5, -1, -0.3], intensity=2.5))
    view, proj = T.camera(None)
    r.update_all(0.0, view, proj)


def _build(jax_side: bool, case: str):
    r = _pair(jax_side)
    if case in ("morph-cube", "rigged-simple", "instanced"):
        T.build(r, case)
    elif case == "skinned-near-clip":
        _skinned_strip(r)
    elif case == "padded":
        _padded(r)
    elif case == "morph-widened":
        _widened(r)
    else:
        T.gltf_scene(r, case)
    return r


ROW_CASES = ("morph-cube", "rigged-simple", "glb-many-influences",
             "glb-morph-stress", "morph-widened", "glb-two-skins",
             "instanced", "skinned-near-clip")


def _anim(r):
    """The prep's (has_morphs, skin_sets)."""
    info = r.meshes.mesh_info
    return (bool((info[:, 3] > 0).any()),
            int(info[:, 5].max()) if r.meshes.count else 0)


def _port_ds(rt, split=True):
    """The port's flushed device dict with the animated triangle set
    shipped as render_device ships it (or withheld: split=False)."""
    ds = dict(rt._flush())
    has_morphs, skin_sets = _anim(rt)
    ds.pop("anim_tri_idx", None)
    ds.pop("anim_tri_n", None)
    anim = rt._anim_tri_idx() if (has_morphs or skin_sets) else None
    if split and anim is not None:
        ds["anim_tri_idx"], ds["anim_tri_n"] = anim
    return ds


def _port_rows(rt, ds, **kw):
    from awsm_renderer_tpu_torch.passes import frame as TF

    masks = rt._mesh_masks()
    has_morphs, skin_sets = _anim(rt)
    args = dict(rw=T.W, rh_full=T.H, needs_clip=masks["needs_clip"],
                has_morphs=has_morphs, skin_sets=skin_sets)
    args.update(kw)
    return TF._run_vertex(ds, torch.as_tensor(masks["opaque"]), **args)


def _jax_rows(rj):
    """JAX _run_vertex with the animated set shipped as its render_device
    ships it."""
    from awsm_renderer_tpu.passes import frame as JF

    ds = rj._flush()
    masks = rj._mesh_masks()
    has_morphs, skin_sets = _anim(rj)
    anim = rj._anim_tri_idx() if (has_morphs or skin_sets) else None
    if anim is not None:
        ds["anim_tri_idx"] = anim
    else:
        ds.pop("anim_tri_idx", None)
    rows, _ = JF._run_vertex(
        ds, jnp.asarray(masks["opaque"]), rw=T.W, rh_full=T.H,
        row_offset=0, shift_rows=False, has_morphs=has_morphs,
        skin_sets=skin_sets, needs_clip=masks["needs_clip"])
    return np.asarray(rows), (None if anim is None else np.asarray(anim))


def _instanced_overlay(jax_side: bool):
    """An opaque box, an instanced group of three blended boxes and an
    instanced group of two HUD boxes: every overlay mesh is instanced, so
    the overlay runs over the full combined pool (the HUD through K1 +
    K2)."""
    pkg = _pkg_mod(jax_side)
    r = _pair(jax_side, post_processing=pkg.PostProcessing(
        tonemapping=pkg.ToneMapping.NONE))
    m, g, _A, m3 = _pkg(r)[:4]
    solid = r.materials.insert(m.PbrMaterial(
        base_color_factor=np.array([0.8, 0.3, 0.2, 1], F)))
    r.add_mesh(g.box(1.0), solid)
    glass = r.materials.insert(m.UnlitMaterial(
        base_color_factor=np.array([0.1, 0.4, 1.0, 0.5], F),
        alpha_mode=m.AlphaMode.BLEND))
    r.add_instanced_mesh(g.box(0.5), glass, [
        m.Transform(translation=np.array([x, 0.1, 0.9], F))
        for x in (-0.9, 0.0, 0.9)])
    hud = r.materials.insert(m.UnlitMaterial(
        base_color_factor=np.array([0.1, 0.9, 0.2, 1], F)))
    rk = r.meshes.insert_resource(g.box(0.25))
    tks = [r.transforms.insert(m.Transform(translation=np.array(
        [x, 0.7, 1.6], F))) for x in (-1.0, 1.0)]
    r.transforms.update_world()
    r.meshes.insert_instanced(
        rk, [(r.transforms.row_of(t), t) for t in tks],
        r.materials.row_of(hud), hud, hud=True)
    r.meshes.update_world(r.transforms)
    r.lights.insert(m.Light.directional([-0.5, -1, -0.3], intensity=2.0))
    r.camera.update(m3.look_at([0, 0.6, 3.5], [0, 0, 0], [0, 1, 0]),
                    m3.perspective(np.pi / 3, T.W / T.H, 0.1, 100.0))
    return r


@pytest.fixture(scope="module")
def jax_side():
    """Every JAX computation of the module, started together in threads
    (XLA compiles without the GIL): each case's setup rows, and the
    instanced and instanced-overlay frames."""
    from concurrent.futures import ThreadPoolExecutor

    scenes = {case: _build(True, case) for case in ROW_CASES}
    frames = {"instanced": _build(True, "instanced"),
              "overlay": _instanced_overlay(True)}
    with ThreadPoolExecutor(len(scenes) + len(frames)) as ex:
        rows = {k: ex.submit(_jax_rows, rj) for k, rj in scenes.items()}
        imgs = {k: ex.submit(rj.render) for k, rj in frames.items()}
        return ({k: f.result() for k, f in rows.items()},
                {k: (frames[k], f.result()) for k, f in imgs.items()})


def _hold_rows(a, b):
    assert a.shape == b.shape and a.shape[1] == NSETUP
    area = a[:, 2] + a[:, 5] + a[:, 8]          # C0 + C1 + C2 = 2 * area
    va, vb = a[:, S_BB_MINX] < 1e37, b[:, S_BB_MINX] < 1e37
    assert va.any()
    assert np.all(area[va != vb] == 0.0), "validity differs off slivers"
    both = va & vb
    a, b, area = a[both], b[both], area[both]
    for col in (S_MAT_ROW, S_ORIG_ID, S_TANGENT_W):
        np.testing.assert_array_equal(a[:, col], b[:, col])
    err = np.abs(a - b) / np.maximum(np.abs(a), 1.0)
    zcols = slice(S_ZA, S_ZC + 1)
    rest = np.ones(NSETUP, bool)
    rest[zcols] = False
    assert err[:, rest].max() <= 3e-5
    zerr = err[:, zcols].max(axis=1) * np.minimum(np.abs(area), 1.0)
    assert zerr.max() <= 1e-4


@pytest.mark.parametrize("case", ROW_CASES)
def test_setup_rows_match_jax(jax_side, case):
    """The port's _run_vertex (split where the scene is animated) against
    JAX's on the same scene."""
    a, anim_j = jax_side[0][case]
    rt = _build(False, case)
    ds = _port_ds(rt)
    b = _port_rows(rt, ds).numpy()
    _hold_rows(a, b)
    has_morphs, skin_sets = _anim(rt)
    if case == "instanced":
        from awsm_renderer_tpu_torch.passes.frame import _total_triangles

        assert not (has_morphs or skin_sets)
        assert _total_triangles(ds) > ds["tri_mesh"].shape[0]
        assert b.shape[0] == _total_triangles(ds)
        return
    assert has_morphs or skin_sets
    idx, n = rt._anim_tri_idx()
    np.testing.assert_array_equal(idx.numpy(), anim_j)
    assert n == int((anim_j >= 0).sum()) and n < idx.shape[0]
    if case == "glb-morph-stress":       # every column of the bucket
        assert (rt.meshes.mesh_info[:, 3] == 8).any()
    if case == "morph-widened":
        assert ds["morph_weights"].shape[1] == 16      # widened from 8
    if case == "glb-many-influences":
        assert skin_sets >= 2


def test_near_clip_secondaries_carry_pool_ids(jax_side):
    """The skinned strip crosses the near plane: the split writes the
    subset's secondary pieces at T + idx, and (as JAX's) they carry the
    pool id idx in S_ORIG_ID."""
    a, anim_j = jax_side[0]["skinned-near-clip"]
    rt = _build(False, "skinned-near-clip")
    b = _port_rows(rt, _port_ds(rt)).numpy()
    Tn = b.shape[0] // 2
    live = anim_j[anim_j >= 0]
    sec = b[Tn + live]
    hit = sec[:, S_BB_MINX] < 1e37
    assert hit.any(), "no live secondary piece in the animated subset"
    np.testing.assert_array_equal(sec[hit, S_ORIG_ID], live[hit])
    np.testing.assert_array_equal(a[Tn + live][hit, S_ORIG_ID], live[hit])


@pytest.mark.parametrize("case", ("morph-cube", "rigged-simple",
                                  "glb-two-skins", "skinned-near-clip"))
def test_split_matches_unsplit(case):
    """The split's rows against the whole pool through the morph/skin
    stage (ds without the animated set): the same rows are valid, and
    every valid row is equal bit for bit, except S_ORIG_ID on the
    subset's secondary rows (pool id t at row T + t). Invalid rows differ:
    the whole-pool stage also morphs and skins the dead triangles (mesh
    row -1 reads mesh 0's tables), which no raster reads."""
    rt = _build(False, case)
    split = _port_rows(rt, _port_ds(rt)).numpy()
    whole = _port_rows(rt, _port_ds(rt, split=False)).numpy()
    assert split.shape == whole.shape
    idx, n = rt._anim_tri_idx()
    live = idx.numpy()[:n]
    if split.shape[0] == 2 * rt._device["tri_mesh"].shape[0]:
        Tn = split.shape[0] // 2
        np.testing.assert_array_equal(split[Tn + live, S_ORIG_ID], live)
        split[Tn + live, S_ORIG_ID] = whole[Tn + live, S_ORIG_ID]
    valid = split[:, S_BB_MINX] < 1e37
    np.testing.assert_array_equal(valid, whole[:, S_BB_MINX] < 1e37)
    assert valid[live].any()
    np.testing.assert_array_equal(split[valid], whole[valid])


def test_pad_rows_never_written():
    """A padded subset (12 live ids of 128) with the pool cut to end at
    the static box's last live triangle: the pads are not scattered, so
    that last row is the plain stage's, unchanged, and the animated rows
    are the morph stage's."""
    from awsm_renderer_tpu_torch.passes.frame import _CORNER_NAMES

    rt = _build(False, "padded")
    ds = _port_ds(rt)
    tm = ds["tri_mesh"]
    live_tris = torch.nonzero(tm >= 0).flatten()
    last = int(live_tris[-1])
    box_row = int(tm[last])
    assert box_row not in set(tm[ds["anim_tri_idx"][:ds["anim_tri_n"]]
                                 .long()].tolist())
    cut = dict(ds)
    for n in _CORNER_NAMES:
        cut[n] = ds[n][:, :last + 1]
    cut["tri_mesh"] = tm[:last + 1]
    assert ds["anim_tri_n"] < ds["anim_tri_idx"].shape[0]   # padded
    rows = _port_rows(rt, cut).numpy()
    plain = _port_rows(rt, cut, has_morphs=False, skin_sets=0).numpy()
    whole = dict(cut)
    del whole["anim_tri_idx"], whole["anim_tri_n"]
    morphed = _port_rows(rt, whole).numpy()
    Tn = last + 1
    for r0 in (last, Tn + last) if rows.shape[0] == 2 * Tn else (last,):
        np.testing.assert_array_equal(rows[r0], plain[r0])
    live = ds["anim_tri_idx"][:ds["anim_tri_n"]].long().numpy()
    np.testing.assert_array_equal(rows[live], morphed[live])
    assert not np.array_equal(rows[live], plain[live])


def test_pick_returns_every_instance(jax_side):
    """pick() maps tri ids past the pool through the instanced groups'
    host mirror: every visible instance's key comes back, and at every
    sampled pixel the key JAX's pick gives."""
    rj, _img = jax_side[1]["instanced"]
    rt = _build(False, "instanced")
    rt.render()
    keys_t = set()
    for y in range(0, T.H, 2):
        for x in range(0, T.W, 2):
            kt = rt.pick(x, y)
            assert kt == rj.pick(x, y), (x, y)
            if kt is not None:
                keys_t.add(kt)
    inst = {k for k, _ in rt.meshes.items()}
    assert keys_t == inst and len(inst) == 12


def test_instanced_overlay_runs_over_the_full_pool(jax_side):
    """Every overlay mesh instanced: the prep ships no compacted index,
    the blended instances peel over the full pool and the HUD instances
    take K1 + K2; the image matches JAX's and pick() finds a HUD
    instance."""
    from awsm_renderer_tpu_torch.passes import frame as TF

    rj, img_j = jax_side[1]["overlay"]
    rt = _instanced_overlay(False)
    calls = []
    orig = TF.rasterize16
    TF.rasterize16 = lambda *a, **k: calls.append(1) or orig(*a, **k)
    try:
        img_t = rt.render()
    finally:
        TF.rasterize16 = orig
    prep = rt._prep[1]
    assert prep["ov_idx"] is None
    assert prep["transparent_dev"] is not None and prep["hud_dev"] is not None
    assert calls == [1, 1]        # the opaque pass and the HUD
    assert np.isfinite(img_t).all()
    diff = np.abs(np.round(img_t * 255) - np.round(img_j * 255))
    assert (diff > 4).mean() < 0.005
    hud_keys = {k for k, msh in rt.meshes.items() if msh.hud}
    tid = rt._last_tri_id.numpy()
    found = {rt.pick(x, y) for y, x in zip(*np.nonzero(tid >= 0))}
    assert hud_keys <= found and len(hud_keys) == 2


def test_empty_overlay_skips():
    """A transparent mesh whose triangles are all dead on the device (its
    rows tombstoned): the compacted index is empty, the prep ships no
    overlay masks and the frame runs no peel."""
    from awsm_renderer_tpu_torch.ops import raster as TR

    m = _pkg_mod(False)
    rt = _pair(False, post_processing=m.PostProcessing(
        tonemapping=m.ToneMapping.NONE))
    g, m3 = _pkg(rt)[1], _pkg(rt)[3]
    rt.add_mesh(g.box(1.0), rt.materials.insert(m.UnlitMaterial(
        base_color_factor=np.array([0.8, 0.3, 0.2, 1], F))))
    glass = rt.materials.insert(m.UnlitMaterial(
        base_color_factor=np.array([0.1, 0.4, 1.0, 0.5], F),
        alpha_mode=m.AlphaMode.BLEND))
    key = rt.add_mesh(g.box(0.5), glass, transform=m.Transform(
        translation=np.array([0.0, 0.1, 0.9], F)))
    rt.camera.update(m3.look_at([0, 0.6, 3.5], [0, 0, 0], [0, 1, 0]),
                     m3.perspective(np.pi / 3, T.W / T.H, 0.1, 100.0))
    rt._flush()
    tm = rt._tri_mesh_device_order
    tm[tm == rt.meshes._mesh_alloc.row_of(key)] = -1
    masks = rt._mesh_masks()
    assert masks["transparent"].any()
    assert rt._overlay_tri_idx(masks).shape[0] == 0
    names = ("rasterize_binned", "_rasterize_binned_compact")
    originals = {n: getattr(TR, n) for n in names}
    calls = []
    for n, fn in originals.items():
        setattr(TR, n, lambda *a, _fn=fn, **k: calls.append(1) or _fn(*a,
                                                                       **k))
    try:
        img = rt.render()
    finally:
        for n, fn in originals.items():
            setattr(TR, n, fn)
    prep = rt._prep[1]
    assert prep["transparent_dev"] is None and prep["hud_dev"] is None
    assert calls == [] and np.isfinite(img).all()


def test_weight_flush_keeps_the_layout_generation():
    """A morph-weight edit flushes the mesh store but not its layout:
    the generation, the cached animated set and the overlay index stay
    as they were; an appended mesh bumps the generation."""
    m = _pkg_mod(False)
    rt = _build(False, "morph-cube")
    geo = importlib.import_module("awsm_renderer_tpu_torch.geometry")
    glass = rt.materials.insert(m.UnlitMaterial(
        base_color_factor=np.array([0.1, 0.4, 1.0, 0.5], F),
        alpha_mode=m.AlphaMode.BLEND))
    rt.add_mesh(geo.box(0.3), glass, transform=m.Transform(
        translation=np.array([0.0, 0.0, 1.0], F)))
    rt.render()
    gen = rt._mesh_flush_gen
    anim = rt._anim_tri_idx()
    ov = rt._overlay_tri_idx(rt._mesh_masks())
    cube = min(k for k, _ in rt.meshes.items())
    rt.meshes.update_morph_weights(cube, [0.8])
    assert rt.meshes.gpu_dirty
    rt.render()
    assert rt._mesh_flush_gen == gen
    assert rt._anim_tri_idx() is anim
    assert rt._overlay_tri_idx(rt._mesh_masks()) is ov
    np.testing.assert_array_equal(rt._device["morph_weights"][
        rt.meshes._mesh_alloc.row_of(cube), :1].numpy(), np.float32([0.8]))
    rt.add_mesh(geo.box(0.2), glass)
    rt.render()
    assert rt._mesh_flush_gen == gen + 1


def test_removed_group_leaves_the_device():
    """Removing every instance of a group deletes the group's device
    entries (inst{g}_*) at the next flush; the frame then renders the
    pool alone, and pick() finds nothing where the instances were."""
    rt = _build(False, "instanced")
    rt.render()
    assert any(k.startswith("inst0_") for k in rt._device)
    for k in [k for k, _ in rt.meshes.items()]:
        rt.meshes.remove(k)
    img = rt.render()
    assert not any(k.startswith("inst") for k in rt._device)
    assert rt._inst_tri_mesh == [] and np.isfinite(img).all()
    assert (rt._last_tri_id < 0).all()
