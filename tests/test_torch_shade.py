"""PyTorch port, shading: BRDF core, env BRDF fit, display pass, and the
deferred opaque shade (shade_deferred_c: material fetch K3, punctual
lights, IBL via K6, skybox on miss) vs the JAX functions, on identical
G-buffer planes and identical scene state (the JAX renderer's flushed
`_device`, carried across with device_scene_from_jax).

Tolerances. Elementwise formulas agree to f32 rounding (rtol 1e-5). The
HDR planes agree within 1e-4 absolute + 1e-4 relative: XLA:CPU fuses the
lighting sums into FMAs and reorders a few products (light attenuation
terms), the port rounds each step; both sample the same bf16 env rows."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port as T

from awsm_renderer_tpu_torch.config import ToneMapping
from awsm_renderer_tpu_torch.ops import brdf as TB
from awsm_renderer_tpu_torch.ops.shade import env_brdf_approx, shade_deferred_c
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
    from awsm_renderer_tpu_torch.passes.frame import (
        _run_vertex, prep_setup_rows,
    )

    out = {}
    for scene, image_env in SCENES.items():
        rj = _jax_scene(scene)
        dj = rj._flush()
        ds = device_scene_from_jax(T.to_numpy(dict(dj)), "cpu")
        masks = rj._mesh_masks()
        has_color = rj.meshes.uses_vertex_colors
        srows = prep_setup_rows(_run_vertex(
            ds, torch.as_tensor(masks["opaque"]), rw=T.W, rh_full=T.H,
            needs_clip=masks["needs_clip"]))
        vis = rasterize16(srows, width=T.W, height=T.H, has_color=has_color,
                          analytic_derivs=False)
        vis.pop("bins")
        got = shade_deferred_c(vis, ds, width=T.W, height=T.H,
                               solid_env=not image_env)
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
