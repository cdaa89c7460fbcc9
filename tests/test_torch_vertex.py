"""PyTorch port, vertex stage: setup rows of the port's vertex_stage vs
the JAX vertex_stage (via passes/frame.py _run_vertex) on the same
flushed scene, including a near-plane-clipped (2T rows) scene.

Tolerances. XLA:CPU contracts products and sums into FMAs; the port
rounds each product and sum separately (as its CUDA kernels must). So:
  - triangle validity agrees except on zero-area triangles (sphere-pole
    slivers whose FMA area is a few ulps off 0; they cover no pixel);
  - integer-valued rows (material row, original id, tangent handedness)
    are equal;
  - every other row is within 3e-5 of max(|value|, 1), except the
    z-plane (ZA, ZB, ZC), whose inverse-area scaling amplifies rounding
    on sub-pixel triangles: 1e-4 / min(2*area in px^2, 1) there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port as T

from awsm_renderer_tpu_torch.ops.vertex import (
    NSETUP, S_BB_MINX, S_MAT_ROW, S_ORIG_ID, S_TANGENT_W, S_ZA, S_ZC,
    onehot_gather,
)

SCENES = ("triangle", "box", "metal-rough-spheres", "env-ibl", "clip")


def _clip_scene(r):
    """A ground plane running behind the camera: the near plane clips it,
    so the vertex stage emits primary + secondary pieces (2T rows)."""
    if type(r).__module__.startswith("awsm_renderer_tpu_torch"):
        import awsm_renderer_tpu_torch as P
        from awsm_renderer_tpu_torch.geometry import box, plane
    else:
        import awsm_renderer_tpu as P
        from awsm_renderer_tpu.geometry import box, plane
    F = np.float32
    g = r.materials.insert(P.PbrMaterial(
        base_color_factor=np.array([0.3, 0.6, 0.3, 1], F)))
    r.add_mesh(plane(6), g)
    b = r.materials.insert(P.UnlitMaterial(
        base_color_factor=np.array([0.8, 0.3, 0.2, 1], F)))
    r.add_mesh(box(0.6), b, transform=P.Transform(
        translation=np.array([0.2, 0.3, 0.0], F)))
    r.lights.insert(P.Light.directional([-0.5, -1, -0.3], intensity=2.5))
    return {"camera": ([0.0, 0.6, 2.0], [0.0, 0.2, 0.0])}


def _renderers(scene):
    if scene != "clip":
        return T.jax_renderer(scene), T.torch_renderer(scene)
    from awsm_renderer_tpu import AwsmRendererTpu, RendererConfig
    import awsm_renderer_tpu_torch as P

    out = []
    for r in (AwsmRendererTpu(RendererConfig(width=T.W, height=T.H)),
              P.AwsmRendererTorch(P.RendererConfig(width=T.W, height=T.H),
                                  device="cpu")):
        view, proj = T.camera(_clip_scene(r))
        r.update_all(0.0, view, proj)
        out.append(r)
    return out


@pytest.fixture(scope="module")
def rows():
    """{scene: (JAX setup rows, port setup rows, needs_clip)}"""
    from awsm_renderer_tpu.passes import frame as JF
    from awsm_renderer_tpu_torch.passes import frame as TF

    out = {}
    for scene in SCENES:
        rj, rt = _renderers(scene)
        dj, dt = rj._flush(), rt._flush()
        masks = rj._mesh_masks()
        a, _ = JF._run_vertex(
            dj, jnp.asarray(masks["opaque"]), rw=T.W, rh_full=T.H,
            row_offset=0, shift_rows=False, has_morphs=False, skin_sets=0,
            needs_clip=masks["needs_clip"])
        b = TF._run_vertex(dt, torch.as_tensor(masks["opaque"]), rw=T.W,
                           rh_full=T.H, needs_clip=masks["needs_clip"])
        out[scene] = (np.asarray(a), b.numpy(), masks["needs_clip"])
    return out


@pytest.mark.parametrize("scene", SCENES)
def test_setup_rows_match_jax(rows, scene):
    a, b, needs_clip = rows[scene]
    assert a.shape == b.shape and a.shape[1] == NSETUP
    assert needs_clip == (scene == "clip")
    area = a[:, 2] + a[:, 5] + a[:, 8]          # C0 + C1 + C2 = 2 * area
    va, vb = a[:, S_BB_MINX] < 1e37, b[:, S_BB_MINX] < 1e37
    assert va.any()
    assert np.all(area[va != vb] == 0.0), "validity differs off slivers"
    both = va & vb
    a, b, area = a[both], b[both], area[both]
    for col in (S_MAT_ROW, S_ORIG_ID, S_TANGENT_W):
        np.testing.assert_array_equal(a[:, col], b[:, col])
    scale = np.maximum(np.abs(a), 1.0)
    err = np.abs(a - b) / scale
    zcols = slice(S_ZA, S_ZC + 1)
    rest = np.ones(NSETUP, bool)
    rest[zcols] = False
    assert err[:, rest].max() <= 3e-5
    # z-plane rows carry 1/area: their rounding error scales with it
    zerr = err[:, zcols].max(axis=1) * np.minimum(np.abs(area), 1.0)
    assert zerr.max() <= 1e-4


def test_clip_doubles_rows_with_secondary_ids(rows):
    a, b, _ = rows["clip"]
    T2 = b.shape[0]
    # row j carries S_ORIG_ID == j: the resolve's tri_id == raster column
    np.testing.assert_array_equal(b[:, S_ORIG_ID], np.arange(T2))
    second = b[T2 // 2:]
    assert (second[:, S_BB_MINX] < 1e37).any(), "no secondary clip piece"


def test_onehot_gather_zero_rows_out_of_range():
    from awsm_renderer_tpu.ops.vertex import onehot_gather as jax_gather

    rng = np.random.default_rng(0)
    table = rng.standard_normal((7, 5)).astype(np.float32)
    rows_ = np.array([0, 3, 6, -1, 7, 100, 2], np.int32)
    want = np.asarray(jax_gather(jnp.asarray(rows_), jnp.asarray(table)))
    got = onehot_gather(torch.as_tensor(rows_), torch.as_tensor(table))
    np.testing.assert_array_equal(got.numpy(), want)
