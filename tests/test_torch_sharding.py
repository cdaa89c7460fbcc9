"""PyTorch port, the multi-GPU frame (parallel/sharding.py): row bands and
2-D screen tiles, in one process (sharding._band_frame over every band,
the exchange a concatenation) and over a real gloo group of 4 spawned CPU
ranks — against the JAX package's sharded frames, its single-device
frames and the port's own; plus the AoS ops helpers (bloom,
depth_of_field, smaa, display_pass, cubemap_face_uv, sample_cubemap,
sample_prefiltered) against JAX's.

Criteria.
  - Shifted setup rows: the bboxes equal JAX's; each plane constant
    within 1e-6 of its terms (|c| + |k * offset|): XLA:CPU contracts
    c + k * y0 into an FMA, the port rounds the product first.
  - Frames against JAX: tri_id equal except at pixels whose sample center
    lies on an edge line of both candidates to within rounding (the FMA
    edge class: XLA:CPU evaluates the edge functions with FMAs; exempt,
    counted, and bounded by 0.2% of the pixels); ldr within 2e-5 off that
    class and its 8 neighbours. Depth: the port's single-device frame and
    JAX's already differ by up to ~5e-5 on the textured scene (the setup
    rows themselves: JAX's vertex stage is FMA-contracted too), so the
    band frame's depth is held within 1e-6 of the port's single-device
    frame's, and within 1e-6 more than that single frame's own distance
    from JAX's.
  - Band borders: the bands follow JAX's sharded frame, not its single
    frame: a band's mip gradients are screen differences inside the band,
    so its border rows may take another mip level. On the textured scene
    such rows differ from the single frame by more than 1e-3 and match
    JAX's sharded frame within 2e-5.
  - The gloo ranks' frames are bit-equal to the in-process assembly, and
    each rank's band pack (what it contributes to an exchange) is
    bit-equal to the in-process band of the same index.

The JAX side computes each of its frames once, all in threads (XLA
compiles without the GIL), while the gloo ranks run in their own
processes."""

import importlib
import os
import socket
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (torch's intra-op share under xdist)

F = np.float32
N_DEV = 4                          # JAX's own sharded tests use 4 devices


def _pkg(jax_side: bool):
    name = "awsm_renderer_tpu" if jax_side else "awsm_renderer_tpu_torch"
    return (importlib.import_module(name),
            importlib.import_module(f"{name}.geometry"),
            importlib.import_module(f"{name}.utils.math3d"),
            importlib.import_module(f"{name}.core.materials"))


def _renderer(jax_side: bool, w: int, h: int):
    m, _g, _m3, _mats = _pkg(jax_side)
    cfg = m.RendererConfig(width=w, height=h, post_processing=m.PostProcessing(
        tonemapping=m.ToneMapping.NONE))
    return (m.AwsmRendererTpu(cfg) if jax_side
            else m.AwsmRendererTorch(cfg, device="cpu"))


def _look(jax_side: bool, r, w, h, eye, at):
    m3 = _pkg(jax_side)[2]
    r.camera.update(m3.look_at(eye, at, [0, 1, 0]),
                    m3.perspective(np.pi / 3, w / h, 0.1, 100.0))


def textured_scene(jax_side: bool, w=128, h=64):
    """A checker-textured ground plane and box (mip-mapped base colour)
    and a PBR sphere under one light: the plane's minified texture puts
    band-border rows on mip boundaries."""
    m, g, _m3, mats = _pkg(jax_side)
    r = _renderer(jax_side, w, h)
    tex = r.textures.add_image(
        g.checker_texture(64, 16, (40, 90, 220), (230, 230, 240)), srgb=True)
    tm = r.materials.insert(m.PbrMaterial(
        base_color_factor=np.array([1, 1, 1, 1], F), metallic_factor=0.0,
        roughness_factor=0.6,
        textures={mats.TS_BASE_COLOR: m.TextureRef(r.textures.row_of(tex))}))
    pm = r.materials.insert(m.PbrMaterial(
        base_color_factor=np.array([0.7, 0.3, 0.2, 1], F),
        metallic_factor=0.3, roughness_factor=0.4))
    r.add_mesh(g.plane(6.0), tm, transform=m.Transform(
        translation=np.array([0, -0.5, 0], F)))
    r.add_mesh(g.box(0.7), tm, transform=m.Transform(
        translation=np.array([-0.6, 0.0, 0.2], F)))
    r.add_mesh(g.uv_sphere(0.45), pm, transform=m.Transform(
        translation=np.array([0.7, 0.0, 0.0], F)))
    r.lights.insert(m.Light.directional([-0.5, -1, -0.3], intensity=2.5))
    _look(jax_side, r, w, h, [0, 0.8, 2.8], [0, -0.2, 0])
    return r


def tiles_scene(jax_side: bool, w=256, h=64):
    """tests/test_sharding.py test_sharded_2d_matches_single_device's
    scene: an unlit box and a PBR sphere under one light."""
    m, g, _m3, _mats = _pkg(jax_side)
    r = _renderer(jax_side, w, h)
    r.add_mesh(g.box(), r.materials.insert(m.UnlitMaterial(
        base_color_factor=np.array([1, 0, 0, 1], F))))
    r.add_mesh(g.uv_sphere(0.45), r.materials.insert(m.PbrMaterial(
        base_color_factor=np.array([0.4, 0.7, 0.3, 1], F),
        roughness_factor=0.4, metallic_factor=0.3)),
        transform=m.Transform(translation=np.array([1.1, 0.2, 0], F)))
    r.lights.insert(m.Light.directional([-0.5, -1, -0.3], intensity=2.0))
    _look(jax_side, r, w, h, [0, 0.5, 2.5], [0, 0, 0])
    return r


def full_scene(jax_side: bool, w=128, h=32):
    """tests/test_sharding.py _build_full_scene: opaque PBR sphere,
    alpha-blended glass box, HUD box, one light."""
    m, g, _m3, mats = _pkg(jax_side)
    r = _renderer(jax_side, w, h)
    opaque = r.materials.insert(m.PbrMaterial(
        base_color_factor=np.array([0.7, 0.6, 0.3, 1], F),
        metallic_factor=0.2, roughness_factor=0.5))
    glass = r.materials.insert(m.PbrMaterial(
        base_color_factor=np.array([0.2, 0.5, 0.9, 0.45], F),
        alpha_mode=mats.AlphaMode.BLEND, roughness_factor=0.1))
    hud = r.materials.insert(m.UnlitMaterial(
        base_color_factor=np.array([0, 1, 0, 1], F)))
    r.add_mesh(g.uv_sphere(0.5), opaque, transform=m.Transform(
        translation=np.array([0.3, 0, -0.5], F)))
    r.add_mesh(g.box(0.6), glass, transform=m.Transform(
        translation=np.array([-0.2, 0, 0.6], F)))
    r.add_mesh(g.box(0.15), hud, hud=True, transform=m.Transform(
        translation=np.array([0.8, 0.45, 0], F)))
    r.lights.insert(m.Light.directional([-0.5, -1, -0.3], intensity=2.5))
    _look(jax_side, r, w, h, [0, 0.5, 2.5], [0, 0, 0])
    return r


SCENES = {"textured": textured_scene, "tiles": tiles_scene,
          "full": full_scene, "full-wide": lambda j: full_scene(j, 256, 32)}

# case: (scene, grid, JAX-style frame keywords); every case renders with
# tonemap NONE under the scenes' solid environment
CASES = {
    "textured-1d": ("textured", (N_DEV, 1), {}),
    "tiles-2d": ("tiles", (2, 2), {}),
    "supersample": ("full", (N_DEV, 1), dict(
        supersample=True, has_transparent=True, has_hud=True, bloom=True,
        n_transparent_layers=2)),
    "msaa": ("full", (N_DEV, 1), dict(
        msaa=True, has_transparent=True, has_hud=True,
        n_transparent_layers=2)),
    "full-2d": ("full-wide", (2, 2), dict(
        has_transparent=True, has_hud=True, bloom=True,
        n_transparent_layers=2)),
}


def _frame_kw(r, kw):
    """JAX-style frame keywords of a case, with the scene's size and the
    renderer's specialization of its materials (the texture slots and
    extensions they use, as the renderer's buckets pass them: the
    reference's all-slots default multiplies its CPU compile time)."""
    m = _pkg(type(r).__name__ == "AwsmRendererTpu")[0]
    masks = r._mesh_masks()
    rows = r._bucket_mat_rows(masks["opaque"] | masks["transparent"]
                              | masks["hud"])
    return dict(width=r.config.width, height=r.config.height,
                tonemap=m.ToneMapping.NONE, solid_env=True,
                slot_mask=r._slot_mask(rows), ext=r._ext_mask(rows),
                needs_clip=bool(masks["needs_clip"]), has_uv1=False,
                has_color=False, **kw)


def port_frame(r, grid=None, **kw):
    """The port's frame of renderer r: the in-process band assembly over
    `grid`, or (grid None) the single-device render_frame, with the
    reference sharded frame's defaults (every slot and extension, uv1 and
    colour planes, clipping) -> (ldr, tri_id, depth) numpy."""
    from awsm_renderer_tpu_torch.parallel.sharding import _band_frame, _bucket
    from awsm_renderer_tpu_torch.passes.frame import FrameSpec, render_frame

    kw = _frame_kw(r, kw)
    ds = r._flush()
    m = r._mesh_masks()
    om = r._tensor(m["opaque"])
    tm = _bucket(r._tensor(m["transparent"]), kw.pop("has_transparent",
                                                     False), om)
    hm = _bucket(r._tensor(m["hud"]), kw.pop("has_hud", False), om)
    spec = FrameSpec(use_mips=True, has_morphs=False, skin_sets=0,
                     has_nearest=True, light_tiles=False, **kw)
    if grid is None:
        out = render_frame(ds, om, tm, hm, spec=spec)[:3]
    else:
        out = _band_frame(ds, om, tm, hm, spec,
                          bands=range(grid[0] * grid[1]), grid=grid)
    return tuple(x.numpy() for x in out)


def _jax_job(case: str):
    """A zero-argument function computing JAX's frame of `case` (its
    sharded frame of textured-1d and tiles-2d, its single-device frame of
    the full-pass cases); the scene is built here, in the caller's
    thread."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from awsm_renderer_tpu.parallel.sharding import (
        render_frame_sharded, render_frame_sharded_2d,
    )
    from awsm_renderer_tpu.passes.frame import render_frame

    scene, grid, kw = CASES[case]
    r = SCENES[scene](True)
    ds = r._flush()
    m = {k: jnp.asarray(v) for k, v in r._mesh_masks().items()
         if k in ("opaque", "transparent", "hud")}
    kw = _frame_kw(r, kw)
    if case == "textured-1d":
        mesh = Mesh(np.array(jax.devices()[:grid[0]]), axis_names=("rows",))
        run = lambda: render_frame_sharded(  # noqa: E731
            mesh, ds, m["opaque"], **kw)
    elif case == "tiles-2d":
        mesh = Mesh(np.array(jax.devices()[:4]).reshape(grid),
                    axis_names=("rows", "cols"))
        run = lambda: render_frame_sharded_2d(  # noqa: E731
            mesh, ds, m["opaque"], **kw)
    else:
        run = lambda: render_frame(  # noqa: E731
            ds, m["opaque"], m["transparent"], m["hud"],
            supersample=kw.pop("supersample", False), use_mips=True,
            has_morphs=False, skin_sets=0, **kw)
    return lambda: tuple(np.asarray(x) for x in run())


# ---- the gloo ranks ------------------------------------------------------

GLOO_CASES = ("supersample", "full-2d")


def _rank_worker(rank: int, world: int, port: int, out_dir: str):
    """One gloo rank: build the full scene, render the 1-D full-pass frame
    and the 2-D 2x2 frame through the public functions, save each frame
    and the band packs this rank contributed to the exchanges."""
    torch.set_num_threads(1)
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from awsm_renderer_tpu_torch.parallel import sharding as S

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        sent = []
        orig = S._all_gather

        def recorded(t, group):
            sent.append(t.clone())
            return orig(t, group)

        S._all_gather = recorded
        meshes = {"supersample": DeviceMesh("cpu", list(range(world)),
                                            mesh_dim_names=("rows",)),
                  "full-2d": DeviceMesh("cpu", [[0, 1], [2, 3]],
                                        mesh_dim_names=("rows", "cols"))}
        for case in GLOO_CASES:
            scene, _grid, kw = CASES[case]
            r = SCENES[scene](False)
            ds = r._flush()
            m = {k: r._tensor(v) for k, v in r._mesh_masks().items()
                 if k in ("opaque", "transparent", "hud")}
            fn = (S.render_frame_sharded if case == "supersample"
                  else S.render_frame_sharded_2d)
            del sent[:]
            out = fn(meshes[case], ds, m["opaque"], m["transparent"],
                     m["hud"], **_frame_kw(r, kw))
            np.savez(os.path.join(out_dir, f"{case}-{rank}.npz"),
                     *(x.numpy() for x in out),
                     *(t.numpy() for t in sent))
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _start_ranks(out_dir):
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_rank_worker, args=(i, N_DEV, port, out_dir))
             for i in range(N_DEV)]
    for p in procs:
        p.start()
    return procs


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    """{case: (JAX frame, port band frame, port single frame)} and the
    gloo ranks' saved frames {case: [rank i's npz arrays]}."""
    out_dir = str(tmp_path_factory.mktemp("gloo"))
    procs = _start_ranks(out_dir)
    try:
        jobs = {c: _jax_job(c) for c in CASES}
        with ThreadPoolExecutor(len(CASES)) as ex:
            jax_out = {c: ex.submit(job) for c, job in jobs.items()}
            port = {}
            for case, (scene, grid, kw) in CASES.items():
                r = SCENES[scene](False)
                port[case] = (port_frame(r, grid, **kw), port_frame(r, **kw))
            out = {c: (jax_out[c].result(),) + port[c] for c in CASES}
    finally:
        for p in procs:
            p.join(timeout=300)
    for p in procs:
        assert not p.is_alive() and p.exitcode == 0, p.exitcode
    ranks = {}
    for case in GLOO_CASES:
        ranks[case] = []
        for i in range(N_DEV):
            with np.load(os.path.join(out_dir, f"{case}-{i}.npz")) as z:
                ranks[case].append([z[f"arr_{k}"] for k in range(len(z))])
    return out, ranks


# ---- criteria --------------------------------------------------------------


def _edge_class(r, case, tid_a, tid_b):
    """Per pixel: the sample center lies on an edge line of both
    candidates' triangles to within rounding (a pool id t is setup row t
    or, clipped, T + t), in the setup of the pass that drew it (the opaque
    raster at its scale; the HUD at 1x)."""
    from awsm_renderer_tpu_torch.passes.frame import (
        _pad_to, _run_vertex, _total_triangles,
    )

    _scene, _grid, kw = CASES[case]
    ds = r._flush()
    m = r._mesh_masks()
    w, h = r.config.width, r.config.height
    scale = 2 if (kw.get("supersample") or kw.get("msaa")) else 1
    T = _total_triangles(ds)
    sets = [(m["opaque"], scale)]
    if kw.get("has_hud"):
        sets.append((m["hud"], 1))
    ys, xs = np.mgrid[0:h, 0:w].astype(F)

    def on_edge(tid):
        hit = np.zeros(tid.shape, bool)
        for mask, s in sets:
            rows = _run_vertex(ds, r._tensor(mask),
                               rw=_pad_to(w * s, 128), rh_full=_pad_to(h, 8) * s,
                               needs_clip=True).numpy()
            px, py = s * xs + F(0.5), s * ys + F(0.5)
            for t in (tid, tid + T):
                ok = (tid >= 0) & (t < rows.shape[0])
                rr = rows[np.where(ok, t, 0)]
                for k in range(3):
                    a, b, c = rr[..., 3 * k], rr[..., 3 * k + 1], \
                        rr[..., 3 * k + 2]
                    e = a * px + (b * py + c)
                    bound = 1e-6 * (np.abs(a * px) + np.abs(b * py)
                                    + np.abs(c))
                    hit |= ok & (np.abs(e) <= bound)
        return hit

    return on_edge(tid_a) & on_edge(tid_b)


def _hold_against_jax(case, frames):
    """tri_id equal off the FMA edge class (< 0.2% of pixels), ldr within
    2e-5 off that class dilated by one pixel; returns the pixels held."""
    (lj, tj, dj), (lb, tb, db), _single = frames[0][case]
    scene = CASES[case][0]
    off = tb != tj
    if off.any():
        fma = _edge_class(SCENES[scene](False), case, tb, tj)
        assert np.all(fma[off]), f"{int((off & ~fma).sum())} unclassified"
    assert off.mean() < 0.002, off.sum()
    near = off.copy()
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            near |= np.roll(off, (dy, dx), axis=(0, 1))
    assert (tj >= 0).sum() > 50
    np.testing.assert_allclose(lb[~near], lj[~near], rtol=0, atol=2e-5)
    return ~near


def test_shift_bands_match_jax():
    import jax.numpy as jnp

    from awsm_renderer_tpu.passes import frame as JF
    from awsm_renderer_tpu_torch.ops import vertex as V
    from awsm_renderer_tpu_torch.passes import frame as TF

    rng = np.random.default_rng(14)
    rows = rng.uniform(-300, 300, (96, V.NSETUP)).astype(F)
    for jshift, tshift, o, coefs, bb in (
            (JF._shift_rows_band, TF._shift_rows_band, 360,
             (V.S_E0B, V.S_E1B, V.S_E2B, V.S_ZB),
             [V.S_BB_MINY, V.S_BB_MAXY]),
            (JF._shift_cols_band, TF._shift_cols_band, 640,
             (V.S_E0A, V.S_E1A, V.S_E2A, V.S_ZA),
             [V.S_BB_MINX, V.S_BB_MAXX])):
        want = np.asarray(jshift(jnp.asarray(rows), o))
        got = tshift(torch.as_tensor(rows), o).numpy()
        consts = [V.S_E0C, V.S_E1C, V.S_E2C, V.S_ZC]
        rest = [c for c in range(V.NSETUP) if c not in consts]
        np.testing.assert_array_equal(got[:, rest], want[:, rest])
        np.testing.assert_array_equal(got[:, bb], rows[:, bb] - F(o))
        for c, k in zip(consts, coefs):
            bound = 1e-6 * (np.abs(rows[:, c]) + np.abs(rows[:, k] * o))
            assert np.all(np.abs(got[:, c] - want[:, c]) <= bound)
            assert np.all(np.abs(got[:, c] - (rows[:, c] + rows[:, k] * o))
                          <= bound)


def test_shift_band_empties_rows_outside():
    """With the band's extent, a row whose bbox lies wholly outside the
    band gets the vertex stage's empty bbox (the binners skip it); the
    rest shift as JAX's rows do."""
    from awsm_renderer_tpu_torch.ops import vertex as V
    from awsm_renderer_tpu_torch.passes import frame as TF

    rows = np.zeros((4, V.NSETUP), F)
    # y bboxes in frame rows: above, straddling the top, inside, below the
    # band [360, 720)
    rows[:, V.S_BB_MINY] = [100, 350, 400, 720]
    rows[:, V.S_BB_MAXY] = [360, 370, 500, 900]
    rows[:, V.S_BB_MINX], rows[:, V.S_BB_MAXX] = 10, 20
    t = torch.as_tensor(rows)
    plain = TF._shift_rows_band(t, 360).numpy()
    culled = TF._shift_rows_band(t, 360, 360).numpy()
    np.testing.assert_array_equal(culled[1:3], plain[1:3])
    for i in (0, 3):
        assert culled[i, V.S_BB_MINX] > culled[i, V.S_BB_MAXX]
        assert culled[i, V.S_BB_MINY] > culled[i, V.S_BB_MAXY]
    cols = TF._shift_cols_band(torch.as_tensor(culled), 640, 640).numpy()
    assert np.all(cols[[0, 3], V.S_BB_MINX] > cols[[0, 3], V.S_BB_MAXX])
    assert np.all(cols[1:3, V.S_BB_MAXX] < 0)   # all left of the tile
    assert np.all(cols[1:3, V.S_BB_MINX] > cols[1:3, V.S_BB_MAXX])


@pytest.mark.parametrize("case", list(CASES))
def test_bands_match_jax(frames, case):
    """Row bands / screen tiles in one process against JAX's sharded frame
    (textured-1d, tiles-2d) or its single-device frame (the full-pass
    cases, which JAX's slow tests hold equal to its sharded ones)."""
    held = _hold_against_jax(case, frames)
    (_lj, _tj, dj), (lb, tb, db), (l1, t1, d1) = frames[0][case]
    # depth: the port's band frame against its single frame, and against
    # JAX no farther than the port's single frame is
    np.testing.assert_allclose(db, d1, rtol=0, atol=1e-6)
    assert np.abs(db - dj)[held].max() <= np.abs(d1 - dj)[held].max() + 1e-6
    if case != "textured-1d":
        # no textures: the bands equal the single frame up to the shift's
        # rounding
        np.testing.assert_array_equal(tb, t1)
        np.testing.assert_allclose(lb, l1, rtol=0, atol=2e-5)


def test_band_border_rows_follow_jax_sharded(frames):
    """A band's mip gradients stop at its border: the textured frame's
    border rows differ from the single frame (by > 1e-3 on some pixels,
    away from the other rows' rounding) and hold JAX's sharded frame."""
    (lj, _tj, _dj), (lb, _tb, _db), (l1, _t1, _d1) = frames[0]["textured-1d"]
    band_h = lb.shape[0] // N_DEV
    d = np.abs(lb - l1).max(axis=-1)
    border = np.zeros(d.shape[0], bool)
    for y in range(band_h, lb.shape[0], band_h):
        border[[y - 1, y]] = True
    assert d[~border].max() < 1e-4
    big = d > 1e-3
    assert big[border].sum() >= 10, big[border].sum()
    np.testing.assert_allclose(lb[big], lj[big], rtol=0, atol=2e-5)
    # JAX's own sharded frame departs from its single frame on these rows
    # too (the port's single frame stands in for JAX's: they agree)
    assert np.abs(lj - l1).max(axis=-1)[border].max() > 1e-3


@pytest.mark.parametrize("case", GLOO_CASES)
def test_gloo_ranks_bit_equal_to_assembly(frames, case):
    """4 spawned CPU ranks over gloo: every rank returns the whole frame,
    bit-equal to the in-process band assembly."""
    _jax, (lb, tb, db), _single = frames[0][case]
    for arrs in frames[1][case]:
        ldr, tid, depth = arrs[:3]
        np.testing.assert_array_equal(ldr.view(np.int32), lb.view(np.int32))
        np.testing.assert_array_equal(tid, tb)
        np.testing.assert_array_equal(depth.view(np.int32),
                                      db.view(np.int32))


def test_gloo_bands_cover_distinct_rows(frames):
    """Rank i contributes band i: its packs (one an exchange) hold the
    in-process band i's planes, bit for bit, and the ranks' packs tile the
    frame in order (the counterpart of test_sharded_bands_cover_distinct_
    rows). The 1-D frame's first exchange is the 2x opaque stage; in the
    2-D frame rank i sends its tile along its row, then the row's band."""
    import awsm_renderer_tpu_torch.parallel.sharding as S

    for case in GLOO_CASES:
        scene, grid, kw = CASES[case]
        packs = []
        orig = S._assemble

        def recorded(p, grid):
            packs.append([x.clone() for x in p])
            return orig(p, grid=grid)

        S._assemble = recorded
        try:
            port_frame(SCENES[scene](False), grid, **kw)
        finally:
            S._assemble = orig
        for i, arrs in enumerate(frames[1][case]):
            sent = arrs[3:]
            if case == "supersample":
                assert len(sent) == 2 == len(packs)
                for k in range(2):
                    np.testing.assert_array_equal(
                        sent[k].view(np.int32), packs[k][i].numpy().view(
                            np.int32))
            else:
                r_, c_ = divmod(i, grid[1])
                assert len(sent) == 2 and len(packs) == 1
                np.testing.assert_array_equal(
                    sent[0].view(np.int32),
                    packs[0][i].numpy().view(np.int32))
                row = torch.cat(packs[0][r_ * grid[1]:(r_ + 1) * grid[1]],
                                dim=2)
                np.testing.assert_array_equal(sent[1].view(np.int32),
                                              row.numpy().view(np.int32))
        h = packs[0][0].shape[1]
        assert all(p.shape[1] == h for p in packs[0])


class _Mesh:
    """A stand-in DeviceMesh of the given shape, enough for the checks
    that run before any exchange."""

    def __init__(self, *shape):
        self.shape = shape
        self.ndim = len(shape)

    def size(self, d):
        return self.shape[d]

    def get_local_rank(self, d):
        return 0

    def get_group(self, d):
        raise AssertionError("the frame must be refused before exchanging")


@pytest.mark.parametrize("fault", ["misaligned-rows", "misaligned-display",
                                   "both-aa", "2d-volume",
                                   "2d-misaligned-cols", "compacted-2d"])
def test_sharded_refusals(fault):
    from awsm_renderer_tpu_torch.parallel import sharding as S
    from awsm_renderer_tpu_torch.passes.frame import FrameSpec, _overlay_band

    r = full_scene(False)
    ds = r._flush()
    m = {k: r._tensor(v) for k, v in r._mesh_masks().items()
         if k in ("opaque", "transparent", "hud")}
    kw = _frame_kw(r, {})
    args = (ds, m["opaque"], m["transparent"], m["hud"])
    with pytest.raises(ValueError) as e:
        if fault == "misaligned-rows":       # 32 rows: 8-row bands at 4
            S.render_frame_sharded(_Mesh(8), *args, **kw)
        elif fault == "misaligned-display":  # 64 rows at 2x, 32 at 1x
            S.render_frame_sharded(_Mesh(8), *args, supersample=True, **kw)
        elif fault == "both-aa":
            S.render_frame_sharded(_Mesh(4), *args, supersample=True,
                                   msaa=True, **kw)
        elif fault == "2d-volume":
            S.render_frame_sharded_2d(_Mesh(2, 1), *args,
                                      has_transparent=True,
                                      **{**kw, "ext": S.ALL_EXT})
        elif fault == "2d-misaligned-cols":  # 128 columns: one TILE_W
            S.render_frame_sharded_2d(_Mesh(2, 2), *args, **kw)
        else:
            spec = FrameSpec(
                width=256, height=32, tonemap=kw["tonemap"], needs_clip=True,
                solid_env=True, has_color=True, has_uv1=True, use_mips=True,
                slot_mask=S.ALL_SLOTS, has_nearest=True, ext=S.ALL_EXT,
                n_transparent_layers=2)
            _overlay_band([torch.zeros(8 * 128)] * 4,
                          torch.full((8, 128), -1, dtype=torch.int32),
                          torch.ones(8, 128), ds, None, m["hud"], spec,
                          rw=128, band_h=8, rh_full=32, row_offset=8,
                          shift_rows=True, rw_full=256, col_offset=128,
                          shift_cols=True,
                          ov_tri_idx=torch.zeros(16, dtype=torch.int32))
    msg = {"misaligned-rows": "TILE_H(8)-aligned bands across 8",
           "misaligned-display": "for the 1x overlay pass",
           "both-aa": "pick one AA mode",
           "2d-volume": "cannot serve screen-space refraction",
           "2d-misaligned-cols": "TILE_W(128)-aligned",
           "compacted-2d": "compacted overlay pools are 1-D only"}[fault]
    assert msg in str(e.value)


# ---- the AoS ops helpers ---------------------------------------------------

H_OPS, W_OPS = 40, 56


def _image(seed, scale=2.0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, (H_OPS, W_OPS, 4)) * scale).astype(F)


def _dirs(seed, n=500):
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((n, 3)).astype(F)
    return d / np.linalg.norm(d, axis=1, keepdims=True)


def _packed_env(seed, lead=()):
    from awsm_renderer_tpu_torch.ops.cubemap import pack_cubemap

    rng = np.random.default_rng(seed)
    return pack_cubemap(rng.uniform(0, 1, (*lead, 6, 8, 8, 4)).astype(F))


@pytest.mark.parametrize("name", ["bloom", "depth_of_field", "smaa",
                                  "display_pass", "cubemap_face_uv",
                                  "sample_cubemap", "sample_prefiltered"])
def test_ops_helpers_match_jax(name):
    """Each helper against JAX's on the same seeded inputs, at the
    channel-plane forms' tolerances (tests/test_torch_effects.py: rtol
    1e-5, atol 1e-6; DoF atol 1e-5)."""
    import jax.numpy as jnp

    from awsm_renderer_tpu.ops import cubemap as JC, effects as JE, \
        tonemap as JT
    from awsm_renderer_tpu.config import ToneMapping as JTM
    from awsm_renderer_tpu_torch.config import ToneMapping as TTM
    from awsm_renderer_tpu_torch.ops import cubemap as TC, effects as TE, \
        tonemap as TT
    from awsm_renderer_tpu_torch.utils import math3d as m3

    atol = 1e-6
    if name in ("bloom", "smaa"):
        img = _image(1) if name == "bloom" else np.clip(_image(2, 1.0), 0, 1)
        want = [getattr(JE, name)(jnp.asarray(img))]
        got = [getattr(TE, name)(torch.as_tensor(img))]
    elif name == "depth_of_field":
        img = _image(3)
        rng = np.random.default_rng(4)
        depth = rng.uniform(0.9, 0.999, (H_OPS, W_OPS)).astype(F)
        cam = {"proj": m3.perspective(np.pi / 3, W_OPS / H_OPS, 0.1, 100.0),
               "dof": np.array([2.0, 0.4], F)}
        want = [JE.depth_of_field(jnp.asarray(img), jnp.asarray(depth),
                                  {k: jnp.asarray(v) for k, v in cam.items()})]
        got = [TE.depth_of_field(torch.as_tensor(img),
                                 torch.as_tensor(depth), cam)]
        atol = 1e-5
    elif name == "display_pass":
        img = _image(5, 3.0)
        want = [JT.display_pass(jnp.asarray(img), mode) for mode in JTM]
        got = [TT.display_pass(torch.as_tensor(img), TTM(mode.value))
               for mode in JTM]
    elif name == "cubemap_face_uv":
        d = _dirs(6)
        want = list(JC.cubemap_face_uv(jnp.asarray(d)))
        got = list(TC.cubemap_face_uv(torch.as_tensor(d)))
    elif name == "sample_cubemap":
        d, env = _dirs(7), _packed_env(8)
        want = [JC.sample_cubemap(jnp.asarray(env), jnp.asarray(d))]
        got = [TC.sample_cubemap(torch.as_tensor(env), torch.as_tensor(d))]
    else:
        d, env = _dirs(9), _packed_env(10, (5,))
        rough = np.random.default_rng(11).uniform(0, 1, 500).astype(F)
        want = [JC.sample_prefiltered(jnp.asarray(env), jnp.asarray(d),
                                      jnp.asarray(rough))]
        got = [TC.sample_prefiltered(torch.as_tensor(env),
                                     torch.as_tensor(d),
                                     torch.as_tensor(rough))]
    for a, b in zip(got, want):
        assert tuple(a.shape) == np.asarray(b).shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=atol)
    if name in ("bloom", "depth_of_field", "smaa"):
        np.testing.assert_array_equal(got[0][..., 3].numpy(), img[..., 3])
        assert float((got[0][..., :3] - torch.as_tensor(img[..., :3]))
                     .abs().max()) > 1e-3
