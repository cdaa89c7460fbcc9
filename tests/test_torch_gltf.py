"""PyTorch port, glTF and KTX2 content: the port's copies of the glTF
loader / populate / sample catalog and of the KTX2 reader, the KTX2
environment loaders against the JAX package's (packed maps bit for bit),
and the whole generated glTF catalog through load_gltf -> populate_gltf
-> AwsmRendererTorch.render_u8() against the checked-in goldens.

Every catalog entry renders and matches its golden at
tests/test_gltf_golden.py's tolerance (< 0.5% of channel values off by
more than 4/255, same camera, 256x128, Khronos PBR Neutral): the skinned,
morphed and instanced entries included."""

import os

import numpy as np
import pytest

from awsm_renderer_tpu_torch.gltf.samples import SAMPLES

F = np.float32
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
W, H = 256, 128
# catalog entries the port renders (all of them); RAISES maps an entry
# the port refuses to the ROADMAP milestone its refusal names (none)
RENDERED = (
    "glb-alpha-modes", "glb-box-animated", "glb-cameras",
    "glb-ext-anisotropy", "glb-ext-clearcoat", "glb-ext-iridescence",
    "glb-ext-sheen", "glb-ext-specular", "glb-ext-transmission",
    "glb-ext-unlit", "glb-extensions-compare", "glb-fox", "glb-helmet",
    "glb-instanced", "glb-interleaved", "glb-many-influences",
    "glb-metal-rough-spheres", "glb-mirrored-tangent", "glb-morph-stress",
    "glb-morphed", "glb-multi-uv", "glb-negative-scale", "glb-non-indexed",
    "glb-normalized-attrs", "glb-npot-texture", "glb-orientation",
    "glb-recursive-skeletons", "glb-skinned", "glb-sparse-displaced",
    "glb-sponza-lite", "glb-strip-fan", "glb-texture-settings",
    "glb-texture-transform", "glb-two-skins", "glb-unlit",
)
RAISES = {}


def _golden_frac(name, img):
    from PIL import Image

    golden = np.asarray(Image.open(os.path.join(GOLDEN_DIR, f"{name}.png")))
    assert golden.shape == img.shape
    diff = np.abs(golden.astype(np.int16) - img.astype(np.int16))
    return float((diff > 4).mean())


def _port_scene(name, tmp_path):
    import awsm_renderer_tpu_torch as P
    from awsm_renderer_tpu_torch.utils import math3d as m3

    glb_bytes, (eye, center) = SAMPLES[name]()
    p = tmp_path / f"{name}.glb"
    p.write_bytes(glb_bytes)
    r = P.AwsmRendererTorch(P.RendererConfig(width=W, height=H),
                            device="cpu")
    P.populate_gltf(r, P.load_gltf(str(p)))
    r.update_all(0.35, m3.look_at(eye, center, (0, 1, 0)),
                 m3.perspective(np.pi / 3, W / H, 0.05, 100.0))
    return r


def test_catalog_partition():
    assert sorted(RENDERED + tuple(RAISES)) == sorted(SAMPLES)


@pytest.mark.parametrize("name", sorted(SAMPLES))
def test_catalog_entry_renders_or_names_its_milestone(name, tmp_path):
    r = _port_scene(name, tmp_path)
    if name in RAISES:
        with pytest.raises(NotImplementedError, match=RAISES[name]):
            r.render_device()
        return
    frac = _golden_frac(name, r.render_u8())
    assert frac < 0.005, f"{name}: {frac:.2%} of channel values off"


def test_gltf_modules_match_jax_copies():
    """The port's glTF modules are byte-for-byte copies of the JAX
    package's: they import only numpy, zlib, PIL and relative modules
    that the port has too."""
    import awsm_renderer_tpu.gltf as JG
    import awsm_renderer_tpu_torch.gltf as PG

    for mod in ("accessors", "ktx2", "loader", "populate", "samples",
                "tangents"):
        with open(os.path.join(os.path.dirname(JG.__file__),
                               f"{mod}.py")) as a, \
                open(os.path.join(os.path.dirname(PG.__file__),
                                  f"{mod}.py")) as b:
            assert a.read() == b.read(), mod


def test_loaded_document_matches_jax(tmp_path):
    """load_gltf + populate_gltf fill the port's stores exactly as the
    JAX package fills its own (the helmet: five textures, tangents)."""
    from awsm_renderer_tpu import AwsmRendererTpu, RendererConfig
    from awsm_renderer_tpu.gltf.loader import load_gltf as jax_load
    from awsm_renderer_tpu.gltf.populate import populate_gltf as jax_pop

    rt = _port_scene("glb-helmet", tmp_path)
    rj = AwsmRendererTpu(RendererConfig(width=W, height=H))
    jax_pop(rj, jax_load(str(tmp_path / "glb-helmet.glb")))
    assert rt.textures.descriptors.tolist() == rj.textures.descriptors.tolist()
    np.testing.assert_array_equal(
        rt.textures.texels_packed.view(np.uint16),
        np.asarray(rj.textures.texels_packed).view(np.uint16))
    np.testing.assert_array_equal(rt.materials.float_data,
                                  rj.materials.float_data)
    np.testing.assert_array_equal(rt.materials.tex_slots,
                                  rj.materials.tex_slots)
    for name in ("c_pos", "c_norm", "c_tang", "c_uv0", "tri_mesh"):
        np.testing.assert_array_equal(getattr(rt.meshes, name),
                                      getattr(rj.meshes, name), err_msg=name)
    assert (rt.materials.tex_slots[:, :, 0] >= 0).sum() == 5


# ---- KTX2 environments (tests/test_ktx2.py's environment cases) ----------

def _envs():
    from awsm_renderer_tpu.core.environment import Environment as JE
    from awsm_renderer_tpu_torch.core.environment import Environment as PE

    return JE(), PE()


def _assert_env_equal(ej, ep):
    assert ej.is_solid == ep.is_solid
    for name in ("skybox", "irradiance", "prefiltered"):
        a, b = np.asarray(getattr(ej, name)), np.asarray(getattr(ep, name))
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32),
                                      err_msg=name)


def _faces(value, size=8):
    return [np.full((size, size, 4), value, F) for _ in range(6)]


def test_environment_from_ktx2_cubemap_matches_jax():
    from awsm_renderer_tpu_torch.gltf.ktx2 import (
        VK_R32G32B32A32_SFLOAT, load_ktx2, write_ktx2,
    )

    img = load_ktx2(write_ktx2([_faces(0.25)], VK_R32G32B32A32_SFLOAT))
    ej, ep = _envs()
    ej.set_skybox_cubemap(img.cubemap_faces(0))
    ep.set_skybox_cubemap(img.cubemap_faces(0))
    assert not ep.is_solid
    np.testing.assert_allclose(ep.skybox[0, 0, 0, 0], 0.25)
    _assert_env_equal(ej, ep)


def test_skybox_from_ktx2_matches_jax():
    from awsm_renderer_tpu_torch.gltf.ktx2 import (
        VK_R32G32B32A32_SFLOAT, write_ktx2,
    )

    blob = write_ktx2([_faces([0.1, 0.4, 0.9, 1.0])],
                      VK_R32G32B32A32_SFLOAT)
    ej, ep = _envs()
    ej.set_skybox_from_ktx2(blob)
    ep.set_skybox_from_ktx2(blob)
    np.testing.assert_allclose(ep.skybox[0, 0, 0], [0.1, 0.4, 0.9, 1.0],
                               atol=1e-6)
    _assert_env_equal(ej, ep)


def test_set_environment_from_ktx2_synthesizes_ibl_like_jax():
    from awsm_renderer_tpu_torch.gltf.ktx2 import (
        VK_R32G32B32A32_SFLOAT, write_ktx2,
    )

    blob = write_ktx2([_faces(0.3)], VK_R32G32B32A32_SFLOAT)
    ej, ep = _envs()
    ej.set_environment_from_ktx2(blob)
    ep.set_environment_from_ktx2(blob)
    np.testing.assert_allclose(ep.prefiltered[0, 0, 4, 4, 0], 0.3,
                               atol=0.02)
    _assert_env_equal(ej, ep)


def test_non_cubemap_rejected_for_ibl():
    from awsm_renderer_tpu_torch.core.environment import Environment
    from awsm_renderer_tpu_torch.gltf.ktx2 import (
        VK_R32G32B32A32_SFLOAT, write_ktx2,
    )

    img = np.random.default_rng(0).random((8, 8, 4)).astype(F)
    blob = write_ktx2([[img]], VK_R32G32B32A32_SFLOAT)
    with pytest.raises(ValueError, match="cubemap"):
        Environment().set_ibl_from_ktx2(blob)


def test_ibl_from_ktx2_renders_like_jax():
    """A pre-baked KTX2 prefiltered chain + irradiance drive IBL in a
    rendered frame: the flushed env maps and texel pool equal the JAX
    renderer's bit for bit, and the image matches its render."""
    import awsm_renderer_tpu as J
    import awsm_renderer_tpu_torch as P
    from awsm_renderer_tpu_torch.core.environment import (
        IRRADIANCE_SIZE, N_SPEC_MIPS, SPEC_SIZE,
    )
    from awsm_renderer_tpu_torch.gltf.ktx2 import (
        VK_R32G32B32A32_SFLOAT, write_ktx2,
    )
    from awsm_renderer_tpu_torch.utils import math3d as m3

    import _torch_port as T

    levels, s = [], 16
    for m in range(4):       # increasingly dim mips
        levels.append(_faces(1.0 / (m + 1), s))
        s //= 2
    pre = write_ktx2(levels, VK_R32G32B32A32_SFLOAT)
    irr = write_ktx2([_faces(0.5)], VK_R32G32B32A32_SFLOAT)
    from awsm_renderer_tpu.geometry import uv_sphere as jax_sphere
    from awsm_renderer_tpu_torch.geometry import uv_sphere

    out = []
    for mod, sphere, r in (
            (J, jax_sphere, J.AwsmRendererTpu(J.RendererConfig(
                width=64, height=32))),
            (P, uv_sphere, P.AwsmRendererTorch(P.RendererConfig(
                width=64, height=32), device="cpu"))):
        r.environment.set_ibl_from_ktx2(pre, irr)
        mat = r.materials.insert(mod.PbrMaterial(
            base_color_factor=np.array([1, 1, 1, 1], F),
            metallic_factor=1.0, roughness_factor=0.1))
        r.add_mesh(sphere(0.8), mat,
                   transform=mod.Transform())
        r.camera.update(m3.look_at([0, 0, 2.5], [0, 0, 0], [0, 1, 0]),
                        m3.perspective(np.pi / 3, 2.0, 0.1, 50.0))
        out.append((r, T.to_numpy(dict(r._flush())), r.render()))
    (rj, dj, img_j), (rp, dp, img_p) = out
    assert rp.environment.prefiltered.shape == (N_SPEC_MIPS, 6, SPEC_SIZE,
                                                SPEC_SIZE, 4)
    assert rp.environment.irradiance.shape == (6, IRRADIANCE_SIZE,
                                               IRRADIANCE_SIZE, 4)
    np.testing.assert_allclose(rp.environment.prefiltered[3, 0, 0, 0, 0],
                               0.25)
    for name in ("skybox", "irradiance", "prefiltered", "texels"):
        np.testing.assert_array_equal(np.asarray(dj[name]).view(np.uint8),
                                      np.asarray(dp[name]).view(np.uint8),
                                      err_msg=name)
    assert np.isfinite(img_p).all() and img_p[16, 32, :3].mean() > 0.05
    diff = np.abs(np.round(img_p * 255) - np.round(img_j * 255))
    assert (diff > 4).mean() < 0.005
