"""PyTorch port, post-processing effects (ops/effects.py): bloom, depth of
field with its host ring specialization, SMAA — against the JAX
package's functions on the same seeded numpy planes, and the effect
goldens on the port's whole frame.

Tolerance. The port repeats the reference's operations in its order, on
a stacked (3, H, W) tensor instead of three planes (the same values per
element), with the camera scalars rounded to f32 as the reference
computes them: bloom and SMAA agree within rtol 1e-5, atol 1e-6
(observed: bit-equal); DoF within rtol 1e-5, atol 1e-5 (observed: 2.4e-7;
torch's and XLA's log2 in the ring hat may differ by an ulp, which the
ring weights and the renormalization carry into the blur). The host CoC
bound, the active ring sets and the renderer's ring choice are equal.
The goldens hold tests/test_parity_golden.py's tight tolerance."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port as T

from awsm_renderer_tpu_torch.ops import effects as TE

F = np.float32
H, W = 40, 56


def _planes(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.uniform(0, 2, (H, W)) * scale).astype(F) for _ in range(3)]


def _hold(got, want, atol=1e-6):
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=atol)


def test_bloom_matches_jax():
    from awsm_renderer_tpu.ops.effects import bloom_c

    rgb = _planes(1)
    got = TE.bloom_c([torch.as_tensor(p) for p in rgb])
    _hold(got, bloom_c([jnp.asarray(p) for p in rgb]))
    assert max(float((g - torch.as_tensor(p)).abs().max())
               for g, p in zip(got, rgb)) > 0.01


def test_smaa_matches_jax():
    from awsm_renderer_tpu.ops.effects import smaa_c

    rgb = [np.clip(p * 0.5, 0, 1) for p in _planes(2)]
    rgb[0][10:20, 5:30] = 1.0              # a hard edge
    got = TE.smaa_c([torch.as_tensor(p) for p in rgb])
    _hold(got, smaa_c([jnp.asarray(p) for p in rgb]))


def _camera(focus, aperture):
    from awsm_renderer_tpu_torch.utils import math3d as m3

    return {"proj": m3.perspective(np.pi / 3, W / H, 0.1, 100.0),
            "dof": np.array([focus, aperture], F)}


@pytest.mark.parametrize("rings", [(1.0, 0.5, 0.25), (0.5, 0.25), (0.25,),
                                   ()])
def test_depth_of_field_matches_jax(rings):
    from awsm_renderer_tpu.ops.effects import depth_of_field_c, dof_coc_c

    rgb = _planes(3)
    rng = np.random.default_rng(4)
    depth = np.concatenate([np.full((H, W // 2), 0.97, F),
                            rng.uniform(0.90, 0.999, (H, W - W // 2))
                            .astype(F)], axis=1)
    cam = _camera(focus=2.0, aperture=0.4)
    jcam = {k: jnp.asarray(v) for k, v in cam.items()}
    got = TE.depth_of_field_c([torch.as_tensor(p) for p in rgb],
                              torch.as_tensor(depth), cam, rings=rings)
    want = depth_of_field_c([jnp.asarray(p) for p in rgb],
                            jnp.asarray(depth), jcam, rings=rings)
    _hold(got, want, atol=1e-5)
    moved = max(float((g - torch.as_tensor(p)).abs().max())
                for g, p in zip(got, rgb))
    assert (moved > 0.01) == bool(rings)
    np.testing.assert_allclose(
        TE.dof_coc_c(torch.as_tensor(depth), cam).numpy(),
        np.asarray(dof_coc_c(jnp.asarray(depth), jcam)), rtol=1e-5,
        atol=1e-6)


def test_coc_bound_and_rings_match_jax():
    from awsm_renderer_tpu.ops import effects as JE

    rng = np.random.default_rng(5)
    for _ in range(50):
        args = ([float(rng.uniform(0.5, 30)), float(rng.uniform(0.2, 8))],
                float(rng.uniform(0.5, 3)), float(rng.uniform(0.1, 10)),
                float(rng.uniform(10, 200)), int(rng.integers(64, 2160)))
        c = TE.dof_max_coc(*args)
        assert c == JE.dof_max_coc(*args)
        assert TE.dof_active_rings(c) == JE.dof_active_rings(c)
    for c in (0.5, 1.0, 1.5, 2.5, 4.5, 8.5, 16.0):
        assert TE.dof_active_rings(c) == JE.dof_active_rings(c)
    for scale in TE.DOF_RING_SCALES:
        assert TE.dof_disk_offsets(scale) == JE.dof_disk_offsets(scale)
    proj = _camera(1, 1)["proj"]
    for d in (0.0, 0.5, 0.99, 1.0):
        assert TE.linearize_depth_host(d, proj) == \
            JE.linearize_depth_host(d, proj)


def _dof_scene(r, m, geo):
    """tests/test_parity_golden.py test_effect_golden_dof's content."""
    r.camera.dof.focus_distance = 3.0
    r.camera.dof.aperture = 0.1
    mat_n = r.materials.insert(m.UnlitMaterial(
        base_color_factor=np.array([0.9, 0.3, 0.2, 1], F)))
    mat_f = r.materials.insert(m.UnlitMaterial(
        base_color_factor=np.array([0.2, 0.6, 0.9, 1], F)))
    r.add_mesh(geo.box(0.5), mat_n)
    r.add_mesh(geo.box(2.0), mat_f, transform=m.Transform(
        translation=np.array([0.8, 0, -14.0], F)))


def test_dof_ring_set_matches_jax_renderer():
    """The host ring choice on the DoF golden scene, and as the focus and
    aperture move (the prep is re-derived: they are in the scene
    signature)."""
    import awsm_renderer_tpu as J
    import awsm_renderer_tpu.geometry as JG
    import awsm_renderer_tpu_torch as P
    import awsm_renderer_tpu_torch.geometry as PG
    from awsm_renderer_tpu.utils import math3d as m3

    rj = J.AwsmRendererTpu(J.RendererConfig(
        width=128, height=64, post_processing=J.PostProcessing(dof=True)))
    rj.camera.update(m3.look_at([0, 0.6, 3.0], [0, 0, 0], [0, 1, 0]),
                     m3.perspective(np.pi / 3, 2.0, 0.1, 100.0))
    rt = T.golden_renderer(post_processing=P.PostProcessing(dof=True))
    _dof_scene(rj, J, JG)
    _dof_scene(rt, P, PG)
    seen = set()
    for focus, aperture in ((3.0, 0.1), (3.0, 4.0), (14.0, 1.0),
                            (1.0, 0.02), (50.0, 16.0)):
        for r in (rj, rt):
            r.camera.dof.focus_distance = focus
            r.camera.dof.aperture = aperture
        want = rj._dof_ring_set(rj._mesh_masks())
        assert rt._dof_ring_set(rt._mesh_masks()) == want
        assert rt._scene_signature()[-3:-1] == (focus, aperture)
        seen.add(want)
    assert len(seen) >= 3
    # the DoF parameters reach both packages' device camera
    np.testing.assert_array_equal(rt._flush()["camera"]["dof"],
                                  np.asarray(rj._flush()["camera"]["dof"]))
    assert float(rt._flush()["camera"]["dof"][1]) == 16.0


def test_dof_edit_without_a_camera_move_takes_effect():
    """Refocusing repacks the port's camera uniform; the JAX renderer keeps
    the old focus until the camera moves (a reference fault, not
    copied)."""
    import awsm_renderer_tpu_torch as P
    import awsm_renderer_tpu_torch.geometry as PG

    r = T.golden_renderer(post_processing=P.PostProcessing(dof=True))
    _dof_scene(r, P, PG)
    near = r.render()
    r.camera.dof.focus_distance = 14.0          # focus on the far box
    far = r.render()
    assert float(r._device["camera"]["dof"][0]) == 14.0
    assert np.abs(far - near).max() > 0.05


def test_effect_bloom_golden():
    import awsm_renderer_tpu_torch as P
    from awsm_renderer_tpu_torch.geometry import box, uv_sphere

    r = T.golden_renderer(post_processing=P.PostProcessing(
        tonemapping=P.ToneMapping.ACES, bloom=True))
    glow = r.materials.insert(P.PbrMaterial(
        base_color_factor=np.array([0.1, 0.1, 0.1, 1], F),
        emissive_factor=np.array([4.0, 3.2, 1.2], F), roughness_factor=0.8))
    dark = r.materials.insert(P.PbrMaterial(
        base_color_factor=np.array([0.2, 0.2, 0.25, 1], F)))
    r.add_mesh(uv_sphere(0.45), glow)
    r.add_mesh(box(0.5), dark, transform=P.Transform(
        translation=np.array([-1.1, 0, 0], F)))
    r.lights.insert(P.Light.directional([-0.5, -1, -0.3], intensity=1.0))
    T.hold_tight("effect-bloom", r.render_u8())


def test_effect_dof_golden():
    import awsm_renderer_tpu_torch as P
    import awsm_renderer_tpu_torch.geometry as PG

    r = T.golden_renderer(post_processing=P.PostProcessing(
        tonemapping=P.ToneMapping.KHRONOS_PBR_NEUTRAL, dof=True))
    _dof_scene(r, P, PG)
    img = r.render_u8()
    assert r._prep[1]["dof_rings"] != ()
    T.hold_tight("effect-dof", img)


def test_effect_smaa_golden():
    import awsm_renderer_tpu_torch as P
    from awsm_renderer_tpu_torch.geometry import box
    from awsm_renderer_tpu_torch.utils import math3d as m3

    r = T.golden_renderer(anti_aliasing=P.AntiAliasing(smaa=True))
    mat = r.materials.insert(P.UnlitMaterial(
        base_color_factor=np.array([1, 1, 1, 1], F)))
    r.add_mesh(box(0.8), mat, transform=P.Transform(
        rotation=m3.quat_from_axis_angle([0, 0, 1], 0.3)))
    T.hold_tight("effect-smaa", r.render_u8())
