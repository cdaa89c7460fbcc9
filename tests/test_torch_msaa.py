"""PyTorch port, the anti-aliasing path: MSAA binning (build_bins16's
64x64 submask bins), K9 rasterize16_msaa (here its plain twin, which the
card run holds bit-equal to the CUDA kernel), K2's coord_scale and
explicit-px/py entries, the covered-tile compacted opaque shade, the
MSAA edge blend, the edge view, the MSAA and supersample frames and
picking — against the JAX renderer.

Criteria. The binner's arrays are bit-equal. K9's sample winners equal
JAX's except at samples whose center lies on an edge line of both
candidates to within rounding: JAX's CPU form of rasterize16_msaa runs
the dense raster at 2x and slices [i::2, j::2], evaluating a*(px + 1)
with XLA:CPU's FMA contraction, where the kernel (and its twin) adds a
to e00 and rounds every step; the count of such samples is asserted
below 0.2% (observed: 0 of 65,536 and of 163,840 samples). Depth equals JAX's
within 1e-6 away from those samples. K2 holds
tests/test_torch_resolve.py's tolerance. The compacted shade equals the
port's band-wide shade bit for bit when the cap covers every covered
unit, except the skipped units' sky under an image env (<= 2e-7: the
two forms of the view ray the reference uses round apart). Frames
hold the goldens' tolerance against JAX (< 0.5% of channel values off
by more than 4/255) and tri_id agrees on >= 99.5% of pixels; the edge
blend is bit-equal to JAX's on the same planes. The JAX side renders
each frame once per module."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port as T
from test_raster import make_setup

from awsm_renderer_tpu_torch.ops import raster as TR

F = np.float32
W, H = 256, 64       # 2 x 8 units of (8, 128): compaction has room
DEVICE = "cpu"       # the port's device (the card tests set "cuda")
MSAA_CAPS = dict(vis_cap=65536, stash_cap=4096)  # the reference's K9 caps
DERIVS = ("du0_dx", "dv0_dx", "du0_dy", "dv0_dy")


def _scene(jax_side: bool, image_env: bool, **aa):
    """tests/test_opaque_compact.py's scene (a textured box and a sphere
    in the lower left, several units pure sky) on either renderer, MSAA
    unless `aa` says otherwise, optionally under the env-ibl equirect."""
    import importlib

    name = "awsm_renderer_tpu" if jax_side else "awsm_renderer_tpu_torch"
    m = importlib.import_module(name)
    geo = importlib.import_module(f"{name}.geometry")
    m3 = importlib.import_module(f"{name}.utils.math3d")
    mats = importlib.import_module(f"{name}.core.materials")
    cfg = m.RendererConfig(
        width=W, height=H,
        anti_aliasing=m.AntiAliasing(**(aa or dict(msaa=True))),
        post_processing=m.PostProcessing(tonemapping=m.ToneMapping.NONE))
    r = (m.AwsmRendererTpu(cfg) if jax_side
         else m.AwsmRendererTorch(cfg, device=DEVICE))
    tex = r.textures.add_image(
        geo.checker_texture(32, 8, (40, 90, 220), (220, 220, 240)),
        srgb=True)
    pbr = r.materials.insert(m.PbrMaterial(
        base_color_factor=np.array([0.8, 0.6, 0.4, 1.0], F),
        metallic_factor=0.3, roughness_factor=0.4,
        textures={mats.TS_BASE_COLOR: m.TextureRef(r.textures.row_of(tex))}))
    plain = r.materials.insert(m.PbrMaterial(
        base_color_factor=np.array([0.2, 0.7, 0.3, 1.0], F),
        metallic_factor=0.0, roughness_factor=0.8))
    r.add_mesh(geo.box(0.6), pbr, transform=m.Transform(
        translation=np.array([-0.8, -0.4, 0.0], F)))
    r.add_mesh(geo.uv_sphere(0.4), plain, transform=m.Transform(
        translation=np.array([0.2, -0.5, 0.3], F)))
    r.lights.insert(m.Light.directional([-0.5, -1, -0.3], intensity=2.0))
    r.lights.insert(m.Light.point([2, 2, 2], intensity=6.0, range=10.0))
    if image_env:
        r.environment.set_environment_from_equirect(T.env_equirect(),
                                                    size=32)
    r.camera.update(m3.look_at([0, 0.3, 3], [0, 0, 0], [0, 1, 0]),
                    m3.perspective(np.pi / 3, W / H, 0.1, 100.0))
    return r


def _forced_cap(monkeypatch, cls, cap):
    """Make the renderer's opaque tile cap `cap` (the host bound declines
    at this size: its 64-unit step exceeds the frame's 16 units)."""
    orig = cls._bucket_tile_cap

    def patched(self, masks, bucket, **kw):
        return cap if bucket == "opaque" else orig(self, masks, bucket, **kw)

    monkeypatch.setattr(cls, "_bucket_tile_cap", patched)


def _rows2x(r):
    """The port renderer's MSAA setup rows: the vertex stage at 2x."""
    from awsm_renderer_tpu_torch.passes.frame import _pad_to, _run_vertex

    ds = r._flush()
    m = r._mesh_masks()
    rw2, rh2 = _pad_to(2 * W, 128), 2 * _pad_to(H, 8)
    rows = _run_vertex(ds, r._tensor(m["opaque"]), rw=rw2, rh_full=rh2,
                       needs_clip=m["needs_clip"], pad=True)
    return rows, rw2, rh2


def _big_rows():
    """Small random triangles over a 512x320 supersampled raster plus
    one screen-filling triangle (a big group in every tile)."""
    rng = np.random.default_rng(11)
    tris = []
    while len(tris) < 200:
        xy = (rng.uniform([0, 0], [512, 320])
              + rng.uniform(-40, 40, size=(3, 2))).astype(F)
        area2 = (xy[1, 0] - xy[0, 0]) * (xy[2, 1] - xy[0, 1]) - (
            xy[2, 0] - xy[0, 0]) * (xy[1, 1] - xy[0, 1])
        if abs(area2) < 4.0:
            continue
        if area2 < 0:
            xy = xy[[0, 2, 1]]
        tris.append({"xy": xy, "z": rng.uniform(0.1, 0.9, 3).astype(F)})
    tris.append({"xy": [[-10.0, -5.0], [1200.0, -5.0], [-10.0, 700.0]],
                 "z": [0.95, 0.95, 0.95]})
    rows = np.asarray(make_setup(tris)).T.copy()
    return TR.pad_setup_rows(torch.as_tensor(rows)).numpy(), 512, 320


@pytest.fixture(scope="module")
def raster_cases():
    """{case: (rows, width2, height2, JAX samp (4 x (H1, W1)), JAX depth1,
    JAX bins)}: the scene's own 2x setup and the big-group case."""
    import jax

    from awsm_renderer_tpu.ops import raster as JR

    # jitted: op-by-op, the binner's compiles took ~7 s a call
    jax_bins = jax.jit(JR.build_bins16, static_argnames=(
        "width", "height", "stash_cap", "tile_h", "tile_w", "pack_submask"))
    rows, w2, h2 = _rows2x(_scene(False, image_env=False))
    out = {}
    for case, (rr, ww, hh) in (("scene", (rows.cpu().numpy(), w2, h2)),
                               ("big_groups", _big_rows())):
        samp, depth1 = JR.rasterize16_msaa(jnp.asarray(rr), width2=ww,
                                           height2=hh, interpret=True)
        bins = jax_bins(jnp.asarray(rr), width=-(-ww // 64) * 64,
                        height=-(-hh // 64) * 64, stash_cap=4096,
                        tile_h=64, tile_w=64, pack_submask=True)
        out[case] = (rr, ww, hh, [np.asarray(s) for s in samp],
                     np.asarray(depth1), [np.asarray(b) for b in bins])
    return out


@pytest.mark.parametrize("case", ["scene", "big_groups"])
def test_msaa_bins_bit_equal(raster_cases, case):
    rows, w2, h2, _, _, jbins = raster_cases[case]
    tbins = TR.build_bins16(torch.as_tensor(rows), width=-(-w2 // 64) * 64,
                            height=-(-h2 // 64) * 64, tile_h=64, tile_w=64,
                            pack_submask=True, **MSAA_CAPS)
    names = ("entries", "offsets", "counts", "zmin_g", "big_packed",
             "big_ids", "n_big")
    for name, a, b in zip(names, jbins, tbins):
        np.testing.assert_array_equal(b.numpy(), a, err_msg=name)
    assert int(tbins[7]) == 0
    masks = tbins[0][:int(tbins[2].sum())] & 0xFF
    assert (masks != 0).all() and (masks != 0x11 * 15).any()
    if case == "big_groups":
        assert int(tbins[6]) > 0, "no big group binned"


def _on_an_edge_sample(rows, col, px, py):
    """Per sample: its center (px, py) lies on an edge line of winner
    `col` to within the rounding of E = a*px + (b*py + c)."""
    hit = np.zeros(col.shape, bool)
    i = np.nonzero(col >= 0)
    r = rows[col[i]]
    x, y = px[i], py[i]
    for k in range(3):
        a, b, c = r[:, 3 * k], r[:, 3 * k + 1], r[:, 3 * k + 2]
        e = a * x + (b * y + c)
        bound = 1e-6 * (np.abs(a * x) + np.abs(b * y) + np.abs(c))
        hit[i] |= np.abs(e) <= bound
    return hit


@pytest.mark.parametrize("case", ["scene", "big_groups"])
def test_k9_matches_jax_interpret(raster_cases, case):
    rows, w2, h2, jsamp, jdepth, _ = raster_cases[case]
    samp, depth, bins = TR.rasterize16_msaa(torch.as_tensor(rows),
                                            width2=w2, height2=h2,
                                            **MSAA_CAPS)
    H1, W1 = h2 // 2, w2 // 2
    assert depth.shape == (H1, W1) and len(samp) == 4
    off_any = np.zeros((H1, W1), bool)
    n_off = 0
    ys, xs = np.mgrid[0:H1, 0:W1].astype(F)
    for s, (i, j) in enumerate(TR.MSAA_SAMPLES):
        got, want = samp[s].numpy(), jsamp[s]
        px = 2 * xs + F(j) + F(0.5)
        py = 2 * ys + F(i) + F(0.5)
        off = got != want
        # flips only where both candidates' edges pass through the sample
        # center to within rounding (hazard: FMA-contracted a*(px+1) vs
        # the kernel's e00 + a)
        assert np.all(_on_an_edge_sample(rows, got, px, py)[off]
                      & _on_an_edge_sample(rows, want, px, py)[off])
        off_any |= off
        n_off += int(off.sum())
    assert n_off < 0.002 * 4 * H1 * W1, n_off
    assert (jsamp[0] >= 0).sum() > 100
    # depth: z00 (+ za) (+ zb) against XLA's FMA-contracted za*(px+1)+...:
    # within 1e-6 of the z-plane's term magnitudes at the winning samples
    # (~1 at the scene's pixel coordinates, up to ~40 for the big-group
    # case's steep random planes at 1024-px supersampled coordinates)
    mag = np.ones((H1, W1), F)
    for s, (i, j) in enumerate(TR.MSAA_SAMPLES):
        w = jsamp[s]
        r = rows[np.maximum(w, 0)]
        t = (np.abs(r[..., 9] * (2 * xs + j + 0.5))
             + np.abs(r[..., 10] * (2 * ys + i + 0.5)) + np.abs(r[..., 11]))
        mag = np.maximum(mag, np.where(w >= 0, t, 0))
    dz = np.abs(depth.numpy() - jdepth)
    assert np.all(dz[~off_any] <= 1e-6 * mag[~off_any])
    # the twin on the frame's unclipped bins gives the same winners
    free, fdepth, _ = TR.rasterize16_msaa(torch.as_tensor(rows), width2=w2,
                                          height2=h2)
    for a, b in zip(free, samp):
        assert torch.equal(a, b)
    assert torch.equal(fdepth, depth)


def test_k9_bins_walk_in_order():
    """Seventeen coincident screen-filling triangles at one depth: the
    first binned (group 0, lowest index) wins every sample, through the
    big list."""
    tri = [[-10.0, -5.0], [1200.0, -5.0], [-10.0, 700.0]]
    s = np.asarray(make_setup([{"xy": tri, "z": [0.4] * 3}] * 17)).T.copy()
    rows = TR.pad_setup_rows(torch.as_tensor(s))
    samp, depth, bins = TR.rasterize16_msaa(rows, width2=512, height2=320)
    assert int(bins[6]) >= 1
    for p in samp:
        assert bool((p == 0).all())
    assert bool((depth == 0.4).all())


@pytest.mark.parametrize("entry", ["coord_scale", "explicit_xy"])
def test_k2_msaa_entries_match_jax(raster_cases, entry):
    from awsm_renderer_tpu.ops.shade import resolve_planes_fused as jax_res
    from awsm_renderer_tpu_torch.ops.shade import (
        RESOLVE_NAMES, resolve_planes_fused,
    )

    rows, w2, h2, jsamp, _, _ = raster_cases["scene"]
    W1, H1 = w2 // 2, h2 // 2
    tid = jsamp[0].reshape(-1).astype(np.int32)
    kw = dict(width=W1, coord_scale=2)
    if entry == "explicit_xy":
        # a permuted subset of the pixels, at their supersampled centers
        rng = np.random.default_rng(3)
        sel = rng.permutation(tid.size)[:3000]
        px = (2.0 * (sel % W1) + 0.5).astype(F)
        py = (2.0 * (sel // W1) + 0.5).astype(F)
        tid = tid[sel]
        kw = dict(width=W1, px=px, py=py)
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    want = jax_res(jnp.asarray(tid), jnp.asarray(rows), height_full=H1,
                   interpret=True, **jkw)
    tkw = {k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    got = resolve_planes_fused(torch.as_tensor(tid), torch.as_tensor(rows),
                               **tkw)
    np.testing.assert_array_equal(got["tri_id"].numpy(),
                                  np.asarray(want["tri_id"]))
    np.testing.assert_array_equal(got["mat_row"].numpy(),
                                  np.asarray(want["mat_row"]))
    assert (tid >= 0).any() and (tid < 0).any()
    for name in RESOLVE_NAMES[2:]:
        a, b = got[name].numpy(), np.asarray(want[name])
        scale = max(1.0, float(np.abs(b).max()))
        rtol = 1e-3 if name in DERIVS else 1e-5
        np.testing.assert_allclose(a, b, rtol=rtol, atol=2e-5 * scale,
                                   err_msg=name)


def _port_band(r, cap, debug_mode="none"):
    """The port's MSAA opaque stage of renderer `r` with opaque tile cap
    `cap` (None: the band-wide shade)."""
    from awsm_renderer_tpu_torch.config import ToneMapping
    from awsm_renderer_tpu_torch.passes.frame import (
        FrameSpec, _opaque_band_msaa, _pad_to,
    )

    ds = r._flush()
    m = r._mesh_masks()
    rows = r._bucket_mat_rows(m["opaque"])
    spec = FrameSpec(
        width=W, height=H, tonemap=ToneMapping.NONE, msaa=True,
        needs_clip=m["needs_clip"], solid_env=r.environment.is_solid,
        use_mips=True, slot_mask=r._slot_mask(rows), has_nearest=False,
        ext=r._ext_mask(rows), debug_mode=debug_mode, opaque_tile_cap=cap)
    return _opaque_band_msaa(ds, torch.as_tensor(m["opaque"]), spec,
                             rw2=_pad_to(2 * W, 128), rh2=2 * H, rw1=W,
                             rh1=H)


@pytest.mark.parametrize("image_env, debug_mode", [
    (False, "none"), (True, "none"), (False, "normals")],
    ids=["solid", "image", "solid-normals"])
def test_compact_shade_equals_band(image_env, debug_mode):
    """Cap 8 of the 16 (8, 128) units covers every covered unit: the
    compacted shade (resolve at explicit centers, NDC planes, sky fill
    of the skipped units) gives the band-wide shade's planes bit for bit
    on the covered units, and on the skipped ones under a solid env."""
    r = _scene(False, image_env)
    band, samp, depth, _ = _port_band(r, None, debug_mode)
    comp, samp_c, depth_c, _ = _port_band(r, 8, debug_mode)
    tid = samp[0].reshape(H // 8, 8, W // 128, 128)
    covered = int((tid >= 0).any(dim=(1, 3)).sum())
    assert 0 < covered <= 8 < 16
    for a, b in zip(samp, samp_c):
        assert torch.equal(a, b)
    assert torch.equal(depth, depth_c)
    unit_cov = (tid >= 0).any(dim=(1, 3))[:, None, :, None].expand(
        -1, 8, -1, 128).reshape(-1)
    for c in range(4):
        assert torch.equal(band[c][unit_cov], comp[c][unit_cov]), c
        # the skipped units' sky: the band shade taps along -normalize(cam
        # - world), the compacted fill along (world - cam) (the
        # reference's two forms), so an image env may round 1 ulp apart
        d = (band[c] - comp[c]).abs()[~unit_cov]
        assert float(d.max()) <= (2e-7 if image_env else 0.0), c


def test_edge_blend_matches_jax():
    from awsm_renderer_tpu.passes.frame import _msaa_edge_blend as jax_blend
    from awsm_renderer_tpu_torch.passes.frame import _msaa_edge_blend

    rng = np.random.default_rng(7)
    h, w = 16, 24
    base = rng.integers(-1, 4, (h, w)).astype(np.int32)
    samp = [np.where(rng.uniform(size=(h, w)) < 0.3,
                     rng.integers(-1, 4, (h, w)), base).astype(np.int32)
            for _ in range(3)]
    samp = [base] + samp
    hdr = [rng.standard_normal(h * w).astype(F) for _ in range(4)]
    want = jax_blend([jnp.asarray(c) for c in hdr],
                     [jnp.asarray(s) for s in samp], h, w)
    got = _msaa_edge_blend([torch.as_tensor(c) for c in hdr],
                           [torch.as_tensor(s) for s in samp], h, w)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_edges_view_renders():
    r = _scene(False, image_env=False)
    img = r.render(debug_mode="edges")
    assert np.isfinite(img).all()
    vals = np.unique(np.round(img[..., 0], 3))
    assert 1.0 in vals and 0.0 in vals and len(vals) >= 3
    assert (img[..., 3] > 0.5).any() and (img[..., 3] < 0.5).any()


@pytest.fixture(scope="module")
def jax_frames():
    """The JAX renderer's frames, each rendered once: MSAA under the
    image env with the opaque cap forced to 8 (compacted), MSAA under
    the solid env with cap 8, and supersample. Each first render is an
    XLA compile of its own frame; the three compile side by side in
    threads (XLA compiles without the GIL)."""
    from concurrent.futures import ThreadPoolExecutor

    from awsm_renderer_tpu import AwsmRendererTpu

    scenes = {"msaa-image": _scene(True, True),
              "msaa-solid": _scene(True, False),
              "supersample": _scene(True, False, supersample=True)}
    with pytest.MonkeyPatch.context() as mp:
        # supersample frames ask for no opaque cap: the patch leaves it be
        _forced_cap(mp, AwsmRendererTpu, 8)
        with ThreadPoolExecutor(len(scenes)) as ex:
            imgs = {k: ex.submit(rj.render) for k, rj in scenes.items()}
            return {k: (rj, imgs[k].result(), np.asarray(rj._last_tri_id))
                    for k, rj in scenes.items()}


def _hold_frame(lt, lj, tt, tj):
    assert lt.shape == lj.shape == (H, W, 4)
    assert np.isfinite(lt).all()
    diff = np.abs(np.round(lt * 255) - np.round(lj * 255))
    assert (diff > 4).mean() < 0.005, (diff > 4).mean()
    assert (tj >= 0).sum() > 200
    assert (tt != tj).mean() < 0.005


@pytest.mark.parametrize("key", ["msaa-image", "msaa-solid", "supersample"])
def test_frame_matches_jax(jax_frames, monkeypatch, key):
    """The whole frame (compacted MSAA shade + edge blend, or the 2x
    opaque pass + box resolve) against JAX's, then pick()."""
    import awsm_renderer_tpu_torch as P

    rj, lj, tj = jax_frames[key]
    if key == "supersample":
        rt = _scene(False, False, supersample=True)
    else:
        _forced_cap(monkeypatch, P.AwsmRendererTorch, 8)
        rt = _scene(False, key == "msaa-image")
    lt = rt.render()
    tt = rt._last_tri_id.numpy()
    if key != "supersample":
        assert rt._prep[1]["op_tile_cap"] == 8
    _hold_frame(lt, lj, tt, tj)
    hits = 0
    for y in range(1, H, 3):
        for x in range(2, W, 5):
            if tj[y, x] == tt[y, x]:
                assert rj.pick(x, y) == rt.pick(x, y), (x, y)
            hits += rt.pick(x, y) is not None
    assert hits > 20


def test_opaque_tile_cap_matches_jax():
    """The host's opaque cap (8x128 units) equals the JAX renderer's on a
    frame large enough to engage it."""
    import awsm_renderer_tpu as J
    import awsm_renderer_tpu_torch as P

    caps = []
    for m, jax_side in ((J, True), (P, False)):
        r = _scene(jax_side, False)
        r.config = type(r.config)(width=1024, height=512,
                                  anti_aliasing=r.config.anti_aliasing)
        masks = r._mesh_masks()
        caps.append(r._bucket_tile_cap(masks, "opaque", tile_h=8,
                                       tile_w=128))
    assert caps[0] == caps[1] and caps[0] is not None


def test_effect_msaa_golden():
    """tests/test_parity_golden.py test_effect_golden_msaa on the port, at
    its tight tolerance (mean |diff| <= 1/255, <= 0.3% of channel values
    off by more than 2/255)."""
    import awsm_renderer_tpu_torch as P
    from awsm_renderer_tpu_torch.geometry import box
    from awsm_renderer_tpu_torch.utils import math3d as m3

    r = T.golden_renderer(anti_aliasing=P.AntiAliasing(msaa=True))
    mat = r.materials.insert(P.UnlitMaterial(
        base_color_factor=np.array([1, 1, 1, 1], F)))
    r.add_mesh(box(0.8), mat, transform=P.Transform(
        rotation=m3.quat_from_axis_angle([0, 0, 1], 0.3)))
    T.hold_tight("effect-msaa", r.render_u8())
