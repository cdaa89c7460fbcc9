"""PyTorch port, the transparent overlay: the K-layer depth peel (K7 band
route, K8 compacted route), forward shading and the back-to-front
composite, the HUD pass and picking through it, KHR transmission and
volume (screen-space refraction), and the host's per-frame overlay
specialization — against the JAX renderer.

Images. tests/test_transparency_effects.py's transparency cases are
built in both renderers and held to each other (< 0.5% of channel
values off by more than 1/255 after rounding to 8 bits, tighter than
the goldens' 4/255; on the CPU they match exactly), and the port's image
also passes that test's own assertion. The JAX side renders each scene
once per module. The `alpha-blend` and `effect-refraction` goldens pass
at their JAX tests' tolerances (tests/test_golden.py,
tests/test_parity_golden.py).

Where dense and binned may differ: the JAX renderer's band peel runs its
dense interpret-mode kernel, which walks chunks in index order, and the
port's runs K7, which walks each tile's chunks near-first; the two pick
different triangles only for fragments at exactly equal depth in
different chunks, which these scenes do not hold.

Host values (_overlay_tri_idx, _overlay_crop, _bucket_tile_cap,
_transparent_layer_bound) equal the JAX renderer's exactly."""

import functools
import importlib

import numpy as np
import pytest
import torch

import _torch_port as T

F = np.float32
W, H = 128, 32
DEVICE = "cpu"      # the port's device (the card tests set "cuda")


def _pkg(jax_side: bool):
    """(package, geometry module, math3d module) of either renderer."""
    name = "awsm_renderer_tpu" if jax_side else "awsm_renderer_tpu_torch"
    return (importlib.import_module(name),
            importlib.import_module(f"{name}.geometry"),
            importlib.import_module(f"{name}.utils.math3d"))


def _renderer(jax_side: bool, width=W, height=H):
    """tests/test_transparency_effects.py make_renderer on either side."""
    m, _g, m3 = _pkg(jax_side)
    cfg = m.RendererConfig(width=width, height=height,
                           post_processing=m.PostProcessing(
                               tonemapping=m.ToneMapping.NONE))
    r = (m.AwsmRendererTpu(cfg) if jax_side
         else m.AwsmRendererTorch(cfg, device=DEVICE))
    r.camera.update(m3.look_at([0, 0, 3], [0, 0, 0], [0, 1, 0]),
                    m3.perspective(np.pi / 3, width / height, 0.1, 100.0))
    return r


def _unlit(m, r, rgba, blend=False):
    kw = dict(alpha_mode=m.AlphaMode.BLEND) if blend else {}
    return r.materials.insert(m.UnlitMaterial(
        base_color_factor=np.array(rgba, F), **kw))


def _blend(jax_side, glass_z, glass_a):
    m, g, _ = _pkg(jax_side)
    r = _renderer(jax_side)
    r.add_mesh(g.box(), _unlit(m, r, [1, 0, 0, 1]))
    r.add_mesh(g.box(0.5), _unlit(m, r, [0, 0, 1, glass_a], blend=True),
               transform=m.Transform(translation=np.array([0, 0, glass_z],
                                                          F)))
    return r, None


def _two_layers(jax_side):
    m, g, _ = _pkg(jax_side)
    r = _renderer(jax_side)
    g1 = _unlit(m, r, [0, 0, 1, 0.5], blend=True)
    g2 = _unlit(m, r, [0, 1, 0, 0.5], blend=True)
    for mat, z in ((g1, 0.5), (g2, 0.0)):
        r.add_mesh(g.triangle(), mat, transform=m.Transform(
            translation=np.array([-0.5, -0.5, z], F)))
    return r, None


def _transmission(jax_side):
    m, g, m3 = _pkg(jax_side)
    r = _renderer(jax_side)
    r.add_mesh(g.box(), _unlit(m, r, [1, 0, 0, 1]))
    glass = r.materials.insert(m.PbrMaterial(
        base_color_factor=np.array([1, 1, 1, 1], F),
        transmission_factor=1.0, roughness_factor=0.05, metallic_factor=0.0))
    r.add_mesh(g.plane(1.5), glass, transform=m.Transform(
        translation=np.array([0, 0, 1.2], F),
        rotation=m3.quat_from_axis_angle([1, 0, 0], np.pi / 2)))
    return r, None


def _hud(jax_side):
    m, g, _ = _pkg(jax_side)
    r = _renderer(jax_side)
    r.add_mesh(g.box(), _unlit(m, r, [1, 0, 0, 1]))
    key = r.add_mesh(g.box(0.4), _unlit(m, r, [0, 1, 0, 1]),
                     transform=m.Transform(translation=np.array([0, 0, 2.0],
                                                                F)),
                     hud=True)
    return r, key


def _refraction(jax_side, thickness, magenta_env=False):
    """tests/test_transparency_effects.py _refraction_scene (and, with
    magenta_env, its offscreen-fallback variant)."""
    m, g, m3 = _pkg(jax_side)
    r = _renderer(jax_side)
    glass = r.materials.insert(m.PbrMaterial(
        base_color_factor=np.array([1, 1, 1, 1], F),
        transmission_factor=1.0, thickness=thickness, ior=1.5,
        roughness_factor=0.05, metallic_factor=0.0))
    for rgba, cx in (([1, 0, 0, 1], -4.0), ([0, 0, 1, 1], 4.0)):
        r.add_mesh(g.plane(8.0), _unlit(m, r, rgba), transform=m.Transform(
            translation=np.array([cx, 0, -1], F),
            rotation=m3.quat_from_axis_angle([1, 0, 0], np.pi / 2)))
    q = m3.quat_mul(m3.quat_from_axis_angle([0, 1, 0], np.pi / 4),
                    m3.quat_from_axis_angle([1, 0, 0], np.pi / 2))
    r.add_mesh(g.plane(2.0), glass, transform=m.Transform(
        translation=np.array([0, 0, 1.0], F), rotation=q))
    if magenta_env:
        r.environment.prefiltered = r.environment.prefiltered * 0.0 + \
            np.array([4.0, 0.0, 4.0, 1.0], F)
        r.environment.gpu_dirty = True
    return r, None


CASES = {
    "blend-over-opaque": functools.partial(_blend, glass_z=1.0, glass_a=0.5),
    "transparent-behind-opaque": functools.partial(_blend, glass_z=-1.0,
                                                   glass_a=0.8),
    "transmission": _transmission,
    "hud": _hud,
    "refraction-0": functools.partial(_refraction, thickness=0.0),
    "refraction-4": functools.partial(_refraction, thickness=4.0),
    "refraction-offscreen": functools.partial(_refraction, thickness=60.0,
                                              magenta_env=True),
}


@functools.lru_cache(maxsize=None)
def _jax_frame(case):
    r, key = CASES[case](True)
    img = r.render()
    return img, (r.pick(W // 2, H // 2) if key is not None else None)


def _lin(c):
    return np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def _assert_case(case, img, imgs):
    """tests/test_transparency_effects.py's own assertion for `case`."""
    c = img[H // 2, W // 2, :3]
    if case == "blend-over-opaque":
        np.testing.assert_allclose(_lin(c), [0.5, 0, 0.5], atol=0.02)
    elif case == "transparent-behind-opaque":
        np.testing.assert_allclose(c, [1, 0, 0], atol=1e-4)
    elif case == "two-layers":
        np.testing.assert_allclose(
            _lin(img[H // 2 + 3, W // 2 - 3, :3]),
            [0.25 * 0.1, 0.25 + 0.25 * 0.1, 0.5 + 0.25 * 0.12], atol=0.005)
    elif case == "transmission":
        assert c[0] > 0.3 and c[0] > c[2]
    elif case == "hud":
        np.testing.assert_allclose(c, [0, 1, 0], atol=1e-4)
    elif case == "refraction-0":
        c0 = img[H // 2, W // 2 + 4, :3]
        assert c0[2] > c0[0]
    elif case == "refraction-4":
        c4 = img[H // 2, W // 2 + 4, :3]
        assert c4[0] > c4[2]
        np.testing.assert_allclose(img[H // 2, 5],
                                   imgs["refraction-0"][H // 2, 5],
                                   atol=1e-3)
    elif case == "refraction-offscreen":
        c = img[H // 2, W // 2 + 4, :3]
        assert c[0] > 0.3 and c[2] > 0.3 and c[1] < min(c[0], c[2])


@pytest.mark.parametrize("case", list(CASES))
def test_overlay_case_matches_jax(case):
    r, key = CASES[case](False)
    img = r.render()
    assert np.isfinite(img).all()
    j_img, j_pick = _jax_frame(case)
    d = np.abs(np.round(img * 255) - np.round(j_img * 255))
    assert (d > 1).mean() < 0.005, f"{case}: {(d > 1).mean():.3%} off"
    imgs = {}
    if case == "refraction-4":
        imgs["refraction-0"] = CASES["refraction-0"](False)[0].render()
    _assert_case(case, img, imgs)
    if key is not None:               # pick goes through the HUD's ids
        assert r.pick(W // 2, H // 2) == key == j_pick


def test_two_transparent_layers_composite():
    """Two overlapping BLEND triangles: the two-layer peel composites back
    to front over the sky exactly as the analytic blend (the JAX test's
    own expectation; no JAX render needed)."""
    r, _ = _two_layers(False)
    img = r.render()
    assert r._prep[1]["n_layers"] == 2
    _assert_case("two-layers", img, {})


def test_hud_over_a_compacted_pool_takes_k7():
    """With a compacted overlay pool the HUD rasterizes through the fat
    binned raster (tri_id from S_ORIG_ID, i.e. pool ids), never K1 + K2
    (whose resolve needs row index == pool id)."""
    from awsm_renderer_tpu_torch.ops import raster as TR

    r, key = _hud(False)
    calls = []
    orig = TR.rasterize_binned

    def spy(*a, **k):
        calls.append(k.get("zlo", a[1] if len(a) > 1 else None))
        return orig(*a, **k)

    TR.rasterize_binned = spy
    try:
        r.render()
    finally:
        TR.rasterize_binned = orig
    assert r._prep[1]["ov_idx"] is not None and calls == [None]
    tid = int(r._last_tri_id[H // 2, W // 2])
    assert r._mesh_row_to_key[int(r._tri_mesh_device_order[tid])] == key


# ---- compact == band on the port (tests/test_transparent_compact.py) ----

def _compact_scene(jax_side: bool, pbr_glass: bool):
    """tests/test_transparent_compact.py _scene on either side."""
    m, g, m3 = _pkg(jax_side)
    TS_BASE_COLOR = importlib.import_module(
        f"{m.__name__}.core.materials").TS_BASE_COLOR
    cfg = m.RendererConfig(width=256, height=64, post_processing=(
        m.PostProcessing(tonemapping=m.ToneMapping.NONE)))
    r = (m.AwsmRendererTpu(cfg) if jax_side
         else m.AwsmRendererTorch(cfg, device="cpu"))
    red = _unlit(m, r, [1, 0.2, 0.1, 1])
    if pbr_glass:
        tex = r.textures.add_image(g.checker_texture(
            32, 8, (40, 90, 220), (220, 220, 240)), srgb=True)
        glass1 = r.materials.insert(m.PbrMaterial(
            base_color_factor=np.array([0.4, 0.6, 1.0, 0.5], F),
            alpha_mode=m.AlphaMode.BLEND, roughness_factor=0.2,
            metallic_factor=0.0, textures={TS_BASE_COLOR: m.TextureRef(
                r.textures.row_of(tex))}))
    else:
        glass1 = _unlit(m, r, [0, 0, 1, 0.5], blend=True)
    glass2 = _unlit(m, r, [0, 1, 0, 0.4], blend=True)
    r.add_mesh(g.box(), red)
    for mat, off in ((glass1, [-0.5, -0.5, 0.8]), (glass2, [-0.3, -0.4, 0.4])):
        r.add_mesh(g.triangle(), mat, transform=m.Transform(
            translation=np.array(off, F)))
    r.lights.insert(m.Light.directional([-0.5, -1, -0.3], intensity=2.0))
    r.camera.update(m3.look_at([0, 0.2, 3], [0, 0, 0], [0, 1, 0]),
                    m3.perspective(np.pi / 3, 4.0, 0.1, 100.0))
    return r


def _port_frame(r, tile_cap):
    from awsm_renderer_tpu_torch.config import ToneMapping
    from awsm_renderer_tpu_torch.passes.frame import FrameSpec, render_frame

    ds = r._flush()
    masks = r._mesh_masks()
    ov_rows = r._bucket_mat_rows(masks["transparent"])
    spec = FrameSpec(
        width=256, height=64, tonemap=ToneMapping.NONE,
        needs_clip=bool(masks["needs_clip"]),
        solid_env=r.environment.is_solid,
        has_color=r.meshes.uses_vertex_colors,
        has_uv1=bool((r.materials.tex_slots[:, :, 1] == 1).any()),
        slot_mask=r._slot_mask(r._bucket_mat_rows(masks["opaque"])),
        overlay_slot_mask=r._slot_mask(ov_rows),
        overlay_ext=r._ext_mask(ov_rows), overlay_tile_cap=tile_cap)
    return render_frame(
        ds, torch.as_tensor(masks["opaque"]),
        torch.as_tensor(masks["transparent"]), None, spec=spec,
        overlay_tri_idx=r._overlay_tri_idx(masks))


@pytest.mark.parametrize("pbr_glass", [False, True], ids=["unlit", "pbr"])
def test_compact_matches_band(pbr_glass):
    """K8's compacted peel + shade equals K7's band-wide one (cap 15 < 16
    tiles engages the compaction and still holds every covered tile)."""
    from awsm_renderer_tpu_torch.ops import kernels, raster as TR

    r = _compact_scene(False, pbr_glass)
    ldr_a, tid_a, _, _ = _port_frame(r, None)
    calls = []
    orig = TR._rasterize_binned_compact
    TR._rasterize_binned_compact = lambda *a, **k: calls.append(1) or \
        orig(*a, **k)
    try:
        ldr_b, tid_b, _, _ = _port_frame(r, 15)
    finally:
        TR._rasterize_binned_compact = orig
    assert calls, "the compacted peel did not run"
    assert all(n == 0 for n in kernels.launch_counts.values())
    np.testing.assert_array_equal(tid_a.numpy(), tid_b.numpy())
    np.testing.assert_allclose(ldr_a.numpy(), ldr_b.numpy(), atol=1e-6)


def test_tile_cap_bounds_the_covered_tiles():
    """tests/test_transparent_compact.py's safety check on the port, on
    the 1080p pane ring (where the cap engages): the host cap covers
    every 32x32 tile layer 0 touches."""
    from awsm_renderer_tpu_torch.ops.raster import rasterize_layers_rows
    from awsm_renderer_tpu_torch.passes.frame import _run_vertex

    r = _ring_scene(False)
    masks = r._mesh_masks()
    cap = r._bucket_tile_cap(masks, "transparent", tile_h=32, tile_w=32)
    rows = _run_vertex(
        r._flush(), torch.as_tensor(masks["transparent"]), rw=1920,
        rh_full=1080, needs_clip=bool(masks["needs_clip"]), pad=True)
    layers = rasterize_layers_rows(rows, torch.ones(1080, 1920), width=1920,
                                   height=1080, n_layers=1)
    tid0 = torch.nn.functional.pad(layers["tri_id"][0].reshape(1080, 1920),
                                   (0, 0, 0, 8), value=-1)
    covered = int((tid0.reshape(34, 32, 60, 32) >= 0).any(3).any(1).sum())
    assert covered > 0 and cap is not None and cap >= covered


# ---- host values against the JAX renderer --------------------------------

def _layer_scene(jax_side, offsets, width=128, height=64):
    """tests/test_transparent_compact.py TestStaticLayerClamp._scene."""
    m, g, m3 = _pkg(jax_side)
    cfg = m.RendererConfig(width=width, height=height,
                           post_processing=m.PostProcessing(
                               tonemapping=m.ToneMapping.NONE))
    r = (m.AwsmRendererTpu(cfg) if jax_side
         else m.AwsmRendererTorch(cfg, device="cpu"))
    opaque = r.materials.insert(m.PbrMaterial(
        base_color_factor=np.array([0.6, 0.5, 0.4, 1], F)))
    glass = r.materials.insert(m.PbrMaterial(
        base_color_factor=np.array([0.3, 0.5, 0.9, 0.4], F),
        alpha_mode=m.AlphaMode.BLEND, roughness_factor=0.2))
    r.add_mesh(g.box(0.5), opaque, m.Transform(
        translation=np.array([0, 0, -1.0], F)))
    for off in offsets:
        r.add_mesh(g.box(0.4), glass, m.Transform(
            translation=np.asarray(off, F)))
    r.lights.insert(m.Light.directional([-0.5, -1, -0.3], intensity=2.0))
    r.camera.update(m3.look_at([0, 0.4, 3.0], [0, 0, 0], [0, 1, 0]),
                    m3.perspective(np.pi / 3, width / height, 0.1, 50.0))
    return r


def _ring_scene(jax_side):
    """bench.py's ring of 12 glass panes (box(0.9), radius 4.5, BLEND
    glass) over one opaque box, at 1920x1080 under chip_smoke.py's first
    orbit camera: the stress scene's overlay."""
    m, g, m3 = _pkg(jax_side)
    cfg = m.RendererConfig(width=1920, height=1080)
    r = (m.AwsmRendererTpu(cfg) if jax_side
         else m.AwsmRendererTorch(cfg, device="cpu"))
    r.add_mesh(g.box(0.8), _unlit(m, r, [0.5, 0.5, 0.5, 1]))
    glass = r.materials.insert(m.PbrMaterial(
        base_color_factor=np.array([0.4, 0.7, 0.9, 0.4], F),
        alpha_mode=m.AlphaMode.BLEND, roughness_factor=0.1,
        metallic_factor=0.0))
    pane = r.meshes.insert_resource(g.box(0.9))
    for i in range(12):
        a = 2 * np.pi * i / 12
        tk = r.transforms.insert(m.Transform(translation=np.array(
            [np.cos(a) * 4.5, 1.2, np.sin(a) * 4.5], F)))
        r.transforms.update_world()
        r.meshes.insert(pane, r.transforms.row_of(tk),
                        r.materials.row_of(glass), tk, glass,
                        transparent=True)
    r.meshes.update_world(r.transforms)
    a, rad = np.pi / 4 + 0.05, float(np.hypot(10.0, 10.0))
    r.camera.update(m3.look_at([np.cos(a) * rad, 7.0, np.sin(a) * rad],
                               [0, 0, 0], [0, 1, 0]),
                    m3.perspective(np.pi / 3, 1920 / 1080, 0.1, 200.0))
    return r


HOST_SCENES = {
    "separated": lambda j: _layer_scene(j, [(-0.9, 0, 0), (0.9, 0, 0)]),
    "stacked": lambda j: _layer_scene(
        j, [(0, 0, 0.3), (0.05, 0.02, 0.9), (0.03, 0, 1.4)]),
    "compact": lambda j: _compact_scene(j, False),
    "hud": lambda j: _hud(j)[0],
    "ring-1080p": _ring_scene,
}


@pytest.mark.parametrize("scene", list(HOST_SCENES))
def test_host_overlay_values_match_jax(scene):
    rj, rp = HOST_SCENES[scene](True), HOST_SCENES[scene](False)
    rj._flush()
    rp._flush()
    mj, mp = rj._mesh_masks(), rp._mesh_masks()
    for k in ("opaque", "transparent", "hud"):
        np.testing.assert_array_equal(mp[k], mj[k], err_msg=k)
    assert rp._overlay_crop(mp) == rj._overlay_crop(mj)
    if mj["transparent"].any():
        assert rp._transparent_layer_bound(mp) == \
            rj._transparent_layer_bound(mj)
        for kw in (dict(tile_h=32, tile_w=32), {}):
            assert rp._bucket_tile_cap(mp, "transparent", **kw) == \
                rj._bucket_tile_cap(mj, "transparent", **kw)
    assert rp._bucket_tile_cap(mp, "opaque") == \
        rj._bucket_tile_cap(mj, "opaque")
    ij, ip = rj._overlay_tri_idx(mj), rp._overlay_tri_idx(mp)
    assert (ij is None) == (ip is None)
    if ip is not None:
        np.testing.assert_array_equal(ip.numpy(), np.asarray(ij))


def test_ring_specialization_engages():
    """On the stress scene's pane ring the crop, the compaction and the
    layer clamp all engage (the overlay's whole fast path)."""
    r = _ring_scene(False)
    r._flush()
    prep = r._prepare()
    assert prep["ov_tile_cap"] is not None
    assert prep["n_layers"] < r.config.max_transparent_layers
    assert prep["ov_idx"] is not None and prep["ov_idx"].shape[0] >= 12 * 12


def test_layer_clamp_is_exact():
    """tests/test_transparent_compact.py's clamped == full K on the port."""
    rc = _layer_scene(False, [(-0.9, 0, 0), (0.9, 0, 0)])
    img_c = rc.render()
    assert rc._prep[1]["n_layers"] == 1
    rf = _layer_scene(False, [(-0.9, 0, 0), (0.9, 0, 0)])
    rf._transparent_layer_bound = lambda masks: None
    img_f = rf.render()
    assert rf._prep[1]["n_layers"] == rf.config.max_transparent_layers
    np.testing.assert_allclose(img_c, img_f, atol=1e-6)


# ---- goldens --------------------------------------------------------------

def _golden(name):
    import os

    from PIL import Image

    return np.asarray(Image.open(os.path.join(
        os.path.dirname(__file__), "goldens", f"{name}.png"))).astype(np.int16)


def test_alpha_blend_golden():
    """tests/test_golden.py's tolerance: < 0.5% off by more than 4/255."""
    diff = np.abs(_golden("alpha-blend")
                  - T.torch_renderer("alpha-blend").render_u8())
    assert (diff > 4).mean() < 0.005


def _tight(name, img):
    """tests/test_parity_golden.py's tolerance: mean |diff| <= 1/255 and
    <= 0.3% of channel values off by more than 2/255."""
    diff = np.abs(_golden(name) - img.astype(np.int16))
    assert diff.mean() <= 1.0 and (diff > 2).mean() <= 0.003


def test_effect_refraction_golden():
    """tests/test_parity_golden.py test_effect_golden_refraction."""
    import awsm_renderer_tpu_torch as P
    from awsm_renderer_tpu_torch.core.materials import TS_BASE_COLOR
    from awsm_renderer_tpu_torch.geometry import (
        checker_texture, plane, uv_sphere,
    )
    from awsm_renderer_tpu_torch.utils import math3d as m3

    r = P.AwsmRendererTorch(P.RendererConfig(width=128, height=64),
                            device="cpu")
    r.camera.update(m3.look_at([0, 0.6, 3.0], [0, 0, 0], [0, 1, 0]),
                    m3.perspective(np.pi / 3, 2.0, 0.1, 100.0))
    tex = r.textures.add_image(
        checker_texture(64, 8, (230, 80, 40), (240, 235, 220)), srgb=True)
    back = r.materials.insert(P.PbrMaterial(
        base_color_factor=np.ones(4, F), roughness_factor=0.9,
        textures={TS_BASE_COLOR: P.TextureRef(r.textures.row_of(tex))}))
    glass = r.materials.insert(P.PbrMaterial(
        base_color_factor=np.array([1, 1, 1, 1], F),
        transmission_factor=1.0, thickness=0.3, ior=1.5,
        roughness_factor=0.05, metallic_factor=0.0))
    r.add_mesh(plane(3.5), back, transform=P.Transform(
        translation=np.array([0, 0, -0.8], F),
        rotation=m3.quat_from_axis_angle([1, 0, 0], np.pi / 2)))
    r.add_mesh(uv_sphere(0.55), glass)
    r.lights.insert(P.Light.directional([-0.5, -1, -0.3], intensity=2.0))
    _tight("effect-refraction", r.render_u8())


def _render_glb_512(name, tmp_path):
    """tests/test_parity_golden.py _render_glb at 512x256 on the port."""
    import awsm_renderer_tpu_torch as P
    from awsm_renderer_tpu_torch.gltf.samples import SAMPLES
    from awsm_renderer_tpu_torch.utils import math3d as m3

    glb, (eye, center) = SAMPLES[name]()
    p = tmp_path / f"{name}.glb"
    p.write_bytes(glb)
    r = P.AwsmRendererTorch(P.RendererConfig(width=512, height=256),
                            device="cpu")
    P.populate_gltf(r, P.load_gltf(str(p)))
    r.lights.insert(P.Light.directional([-0.4, -1.0, -0.35], intensity=2.5))
    r.lights.insert(P.Light.point([2.0, 1.5, 2.0], color=(1.0, 0.9, 0.8),
                                  intensity=6.0))
    r.update_all(0.0, m3.look_at(eye, center, (0, 1, 0)),
                 m3.perspective(np.pi / 3, 2.0, 0.05, 500.0))
    return r.render_u8()


@pytest.mark.parametrize("name, golden", [
    ("glb-alpha-modes", "parity-glb-alpha-modes-512"),
    ("glb-ext-transmission", "parity-ext-transmission-512"),
])
def test_parity_512_goldens(name, golden, tmp_path):
    """tests/test_parity_golden.py _render_glb at 512x256, tight."""
    _tight(golden, _render_glb_512(name, tmp_path))


@pytest.mark.slow
@pytest.mark.parametrize("name, golden", [
    ("glb-helmet", "parity-glb-helmet-512")] + [
    (f"glb-ext-{v}", f"parity-ext-{v}-512") for v in (
        "anisotropy", "clearcoat", "iridescence", "sheen", "specular",
        "unlit")])
def test_parity_512_goldens_slow(name, golden, tmp_path):
    """The other seven 512x256 parity goldens (slow on the CPU, as JAX's
    test_parity_glb_512 and test_parity_ext_512 are), tight, with their
    coverage checks."""
    img = _render_glb_512(name, tmp_path)
    _tight(golden, img)
    if name == "glb-helmet":
        assert (np.abs(np.diff(img[..., 0].astype(np.int16), axis=1))
                > 8).mean() > 0.01
    else:
        bg = img[2, 2, :3].astype(np.int16)
        cov = np.abs(img[..., :3].astype(np.int16) - bg).max(axis=-1) > 8
        assert cov.mean() > 0.05, cov.mean()
