"""PyTorch port, shading: BRDF core and extension lobes, env BRDF fit,
display pass, and the deferred opaque shade (shade_deferred_c: material
fetch K3, texture taps K4 + K5, punctual lights, IBL via K6, skybox on
miss, the opaque material extensions and the debug views) vs the JAX
functions, on identical G-buffer planes and identical scene state (the
JAX renderer's flushed `_device`, carried across with
device_scene_from_jax).

Tolerances. Elementwise formulas agree to f32 rounding (rtol 1e-5; the
thin-film and sheen lobes, whose pow/cos of large arguments amplify an
ulp, to rtol 1e-4). The untextured HDR planes agree within 1e-4 absolute
+ 1e-4 relative: XLA:CPU fuses the lighting sums into FMAs and reorders a
few products (light attenuation terms), the port rounds each step; both
sample the same bf16 env rows. The textured, extension and debug-view
planes are held to the same 1e-4 (observed: at most 2.4e-6): XLA's FMAs
move a texel coordinate by an ulp, and its log2 could floor a LOD on an
integer boundary to the other mip, but with linear mip filtering the
trilinear result is continuous there."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port as T

from awsm_renderer_tpu_torch.config import ToneMapping
from awsm_renderer_tpu_torch.ops import brdf as TB
from awsm_renderer_tpu_torch.core.materials import MI_DEBUG_MASK
from awsm_renderer_tpu_torch.ops.shade import (
    ShadeSpec, env_brdf_approx, shade_deferred_c,
)
from awsm_renderer_tpu_torch.ops.tonemap import display_pass_c

NO_SLOTS = (False,) * 20
NO_EXT = (False,) * 6
# scene -> image environment? ("lights": the spheres under directional,
# ranged and unranged point, and spot lights; "colors": a mesh with
# per-vertex colours, which switches the colour planes on)
SCENES = {"triangle": False, "box": False, "metal-rough-spheres": False,
          "env-ibl": True, "lights": False, "colors": True}


def _jax_scene(scene):
    if scene == "colors":
        from awsm_renderer_tpu import MeshGeometry, Transform
        from awsm_renderer_tpu.geometry import uv_sphere

        r = T.jax_renderer("env-ibl")
        g = uv_sphere(0.4)
        rng = np.random.default_rng(12)
        colors = rng.uniform(0.2, 1.0, (g.positions.shape[0], 4))
        geo = MeshGeometry(positions=g.positions, indices=g.indices,
                           normals=g.normals, uv0=g.uv0,
                           color0=colors.astype(np.float32))
        r.add_mesh(geo, next(iter(r.materials._materials)), Transform(
            translation=np.array([0.0, 0.55, 0.3], np.float32)))
        assert r.meshes.uses_vertex_colors
        return r
    if scene != "lights":
        return T.jax_renderer(scene)
    from awsm_renderer_tpu import Light

    r = T.jax_renderer("metal-rough-spheres")
    r.lights.insert(Light.point([1.0, 1.5, 2.0], color=(1.0, 0.6, 0.3),
                                intensity=6.0, range=5.0))
    r.lights.insert(Light.point([-2.0, -1.0, 1.5], intensity=3.0))
    r.lights.insert(Light.spot([0.0, 0.0, 4.0], [0.0, 0.2, -1.0],
                               color=(0.4, 0.7, 1.0), intensity=20.0,
                               range=12.0, inner_cone_angle=0.1,
                               outer_cone_angle=0.35))
    return r


def _rand(rng, *shape, lo=0.0, hi=1.0):
    return rng.uniform(lo, hi, shape).astype(np.float32)


def test_brdf_core_matches_jax():
    from awsm_renderer_tpu.ops import brdf as JB

    rng = np.random.default_rng(8)
    ndh, ndv, ndl, vdh = (_rand(rng, 4096) for _ in range(4))
    ar = _rand(rng, 4096, lo=0.0016, hi=1.0)
    f0 = [_rand(rng, 4096) for _ in range(3)]
    t = torch.as_tensor
    pairs = [
        (TB.d_ggx(t(ndh), t(ar)), JB.d_ggx(ndh, ar)),
        (TB.v_smith_ggx_correlated(t(ndv), t(ndl), t(ar)),
         JB.v_smith_ggx_correlated(ndv, ndl, ar)),
        (TB.specular_ggx(t(ndl), t(ndv), t(ndh), t(ar)),
         JB.specular_ggx(ndl, ndv, ndh, ar)),
        (TB.diffuse_lambert(t(f0[0])), JB.diffuse_lambert(f0[0])),
        (TB.f_schlick(t(vdh), t(f0[0])), JB.f_schlick(vdh, f0[0])),
    ]
    pairs += list(zip(TB.f_schlick3(t(vdh), [t(c) for c in f0]),
                      JB.f_schlick3(vdh, f0)))
    for a, b in pairs:
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-7)


def test_brdf_extension_lobes_match_jax():
    from awsm_renderer_tpu.ops import brdf as JB

    rng = np.random.default_rng(18)
    ndh, ndv, ndl, tdh, bdh, tdv, bdv, tdl, bdl = (
        _rand(rng, 4096, lo=-1.0, hi=1.0) for _ in range(9))
    ndh, ndv, ndl = np.abs(ndh), np.abs(ndv) + 1e-3, np.abs(ndl)
    rough, at, ab = (_rand(rng, 4096, lo=0.02, hi=1.0) for _ in range(3))
    col3 = [_rand(rng, 4096) for _ in range(3)]
    thick = _rand(rng, 4096, lo=100.0, hi=400.0)
    iior = _rand(rng, 4096, lo=1.0, hi=2.0)
    ratio = _rand(rng, 4096, lo=0.5, hi=2.5)
    t = torch.as_tensor
    tight = [
        (TB.v_ashikhmin(t(ndl), t(ndv)), JB.v_ashikhmin(ndl, ndv)),
        (TB._fresnel_dielectric(t(ndv), t(ratio)),
         JB._fresnel_dielectric(ndv, ratio)),
        (TB.d_ggx_anisotropic(t(ndh), t(tdh), t(bdh), t(at), t(ab)),
         JB.d_ggx_anisotropic(ndh, tdh, bdh, at, ab)),
        (TB.v_smith_ggx_anisotropic(t(ndv), t(ndl), t(tdv), t(bdv), t(tdl),
                                    t(bdl), t(at), t(ab)),
         JB.v_smith_ggx_anisotropic(ndv, ndl, tdv, bdv, tdl, bdl, at, ab)),
    ]
    loose = [
        (TB.d_charlie(t(ndh), t(rough)), JB.d_charlie(ndh, rough)),
        (TB.sheen_brdf(t(np.stack(col3, -1)), t(rough), t(ndl), t(ndv),
                       t(ndh)),
         JB.sheen_brdf(np.stack(col3, -1), rough, ndl, ndv, ndh)),
        (TB.sheen_albedo_scaling_c(t(ndv), [t(c) for c in col3], t(rough)),
         JB.sheen_albedo_scaling_c(ndv, col3, rough)),
    ]
    loose += list(zip(
        TB.iridescent_fresnel_c(torch.ones(4096), t(iior),
                                [t(c) for c in col3], t(thick), t(ndv)),
        JB.iridescent_fresnel_c(np.ones(4096, np.float32), iior, col3,
                                thick, ndv)))
    for a, b in tight:
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-7)
    for a, b in loose:
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-6)


def test_env_brdf_approx_matches_jax():
    from awsm_renderer_tpu.ops.shade import env_brdf_approx as jax_fit

    rng = np.random.default_rng(9)
    ndv, rough = _rand(rng, 4096), _rand(rng, 4096)
    for a, b in zip(env_brdf_approx(torch.as_tensor(ndv),
                                    torch.as_tensor(rough)),
                    jax_fit(ndv, rough)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("mode", list(ToneMapping))
def test_display_pass_matches_jax(mode):
    from awsm_renderer_tpu.config import ToneMapping as JT
    from awsm_renderer_tpu.ops.tonemap import display_pass_c as jax_display

    rng = np.random.default_rng(10)
    hdr = [_rand(rng, 8192, lo=-0.5, hi=6.0) for _ in range(4)]
    got = display_pass_c([torch.as_tensor(c) for c in hdr], mode)
    want = jax_display([jnp.asarray(c) for c in hdr], JT(mode.value))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=2e-6)


@pytest.fixture(scope="module")
def shaded():
    """{scene: (port HDR planes, JAX HDR planes)} from identical G-buffer
    planes and identical flushed scene state."""
    from awsm_renderer_tpu.ops.shade import shade_deferred_c as jax_shade
    from awsm_renderer_tpu_torch import device_scene_from_jax
    from awsm_renderer_tpu_torch.ops.raster import rasterize16
    from awsm_renderer_tpu_torch.passes.frame import _run_vertex

    out = {}
    for scene, image_env in SCENES.items():
        rj = _jax_scene(scene)
        dj = rj._flush()
        ds = device_scene_from_jax(T.to_numpy(dict(dj)), "cpu")
        masks = rj._mesh_masks()
        has_color = rj.meshes.uses_vertex_colors
        srows = _run_vertex(
            ds, torch.as_tensor(masks["opaque"]), rw=T.W, rh_full=T.H,
            needs_clip=masks["needs_clip"], pad=True)
        vis = rasterize16(srows, width=T.W, height=T.H, has_color=has_color,
                          analytic_derivs=False)
        vis.pop("bins")
        got = shade_deferred_c(vis, ds, ShadeSpec(solid_env=not image_env),
                               width=T.W, height=T.H)
        want = jax_shade(
            {k: jnp.asarray(v.numpy()) for k, v in vis.items()}, dj,
            width=T.W, height=T.H, use_mips=True, slot_mask=NO_SLOTS,
            solid_env=not image_env, has_nearest=False, ext=NO_EXT)
        out[scene] = ([c.numpy() for c in got],
                      [np.asarray(c) for c in want],
                      vis["tri_id"].numpy().reshape(-1))
    return out


@pytest.mark.parametrize("scene", list(SCENES))
def test_shade_deferred_hdr_matches_jax(shaded, scene):
    got, want, tid = shaded[scene]
    assert (tid >= 0).any() and (tid < 0).any()
    np.testing.assert_array_equal(got[3], want[3])          # coverage
    for c in range(3):
        np.testing.assert_allclose(got[c], want[c], rtol=1e-4, atol=1e-4,
                                   err_msg=f"channel {c}")
    if SCENES[scene]:            # image env: the sky varies on a miss
        assert np.ptp(got[2][tid < 0]) > 0.01


# textured / extension / debug cases: name -> (catalog or demo scene,
# image environment?, debug_mode)
TEX_CASES = {
    "box-textured": ("box-textured", False, "none"),
    "helmet-ibl": ("glb-helmet", True, "none"),
    "multi-uv": ("glb-multi-uv", False, "none"),
    "texture-transform": ("glb-texture-transform", False, "none"),
    "texture-settings": ("glb-texture-settings", False, "none"),
    "clearcoat-ibl": ("glb-ext-clearcoat", True, "none"),
    "sheen-ibl": ("glb-ext-sheen", True, "none"),
    "iridescence": ("glb-ext-iridescence", False, "none"),
    "anisotropy-ibl": ("glb-ext-anisotropy", True, "none"),
    "specular": ("glb-ext-specular", False, "none"),
    "helmet-ibl-view": ("glb-helmet", True, "ibl"),
    "helmet-punctual-view": ("glb-helmet", False, "punctual"),
    "helmet-normals": ("glb-helmet", False, "normals"),
    "helmet-channel-metallicroughness": ("glb-helmet", False,
                                         "channel:metallicroughness"),
    "helmet-material-bitmask": ("glb-helmet", False, "material"),
}


@pytest.fixture(scope="module")
def shaded_tex():
    """{case: (port HDR planes, JAX HDR planes, tri_id)} for TEX_CASES,
    shaded with the JAX renderer's own specialization (slot mask,
    extensions, has_nearest, has_uv1)."""
    from awsm_renderer_tpu import AwsmRendererTpu, RendererConfig
    from awsm_renderer_tpu.ops.shade import shade_deferred_c as jax_shade
    from awsm_renderer_tpu_torch import device_scene_from_jax
    from awsm_renderer_tpu_torch.ops.raster import rasterize16
    from awsm_renderer_tpu_torch.passes.frame import _run_vertex

    out = {}
    for case, (scene, image_env, debug) in TEX_CASES.items():
        if scene.startswith("glb-"):
            rj = T.gltf_scene(AwsmRendererTpu(RendererConfig(
                width=T.W, height=T.H)), scene, image_env)
        else:
            rj = T.jax_renderer(scene)
        if debug == "material":     # metallic/roughness view, bit 1
            rj.materials.flags[:, MI_DEBUG_MASK] = 1 << 1
            rj.materials.gpu_dirty = True
        dj = rj._flush()
        ds = device_scene_from_jax(T.to_numpy(dict(dj)), "cpu")
        masks = rj._mesh_masks()
        op_rows = rj._bucket_mat_rows(masks["opaque"])
        spec = dict(
            use_mips=True, slot_mask=rj._slot_mask(op_rows),
            solid_env=not image_env, ext=rj._ext_mask(op_rows),
            has_nearest=bool((rj.textures.descriptors[:, 5] == 0).any()),
            debug_mode=debug)
        has_uv1 = bool((rj.materials.tex_slots[:, :, 1] == 1).any())
        srows = _run_vertex(
            ds, torch.as_tensor(masks["opaque"]), rw=T.W, rh_full=T.H,
            needs_clip=masks["needs_clip"], pad=True)
        vis = rasterize16(srows, width=T.W, height=T.H, has_uv1=has_uv1,
                          has_color=rj.meshes.uses_vertex_colors,
                          analytic_derivs=False)
        vis.pop("bins")
        got = shade_deferred_c(vis, ds, ShadeSpec(**spec), width=T.W,
                               height=T.H)
        want = jax_shade({k: jnp.asarray(v.numpy()) for k, v in vis.items()},
                         dj, width=T.W, height=T.H, **spec)
        out[case] = ([c.numpy() for c in got], [np.asarray(c) for c in want],
                     vis["tri_id"].numpy().reshape(-1), spec)
    return out


@pytest.mark.parametrize("case", list(TEX_CASES))
def test_textured_shade_hdr_matches_jax(shaded_tex, case):
    got, want, tid, spec = shaded_tex[case]
    scene = TEX_CASES[case][0]
    assert (tid >= 0).sum() > 200
    if scene in ("box-textured", "glb-helmet", "glb-multi-uv",
                 "glb-texture-transform", "glb-texture-settings"):
        assert any(spec["slot_mask"])
    np.testing.assert_array_equal(got[3], want[3])          # coverage
    assert all(np.isfinite(c).all() for c in got)
    for c in range(3):
        np.testing.assert_allclose(got[c], want[c], rtol=1e-4, atol=1e-4,
                                   err_msg=f"{case} channel {c}")
