"""PyTorch port, K2 attribute resolve: resolve_planes_fused (here its plain
twin, which the card run holds against the CUDA kernel) vs the JAX CPU
resolve (ops/shade.py resolve_gbuffer, what resolve_planes_fused runs in
interpret mode) on identical setup rows and winner ids.

tri_id and mat_row are equal. Every float plane is within rtol 1e-5 and
an absolute 2e-5 of max(1, plane magnitude): XLA:CPU contracts the edge
and interpolation products into FMAs, the port rounds each step; the
uv0 derivative planes divide by the barycentric denominator, which
amplifies that rounding near silhouettes, so they get 1e-3 relative."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port as T

from awsm_renderer_tpu_torch.ops.shade import (
    RESOLVE_NAMES, resolve_planes_fused, resolve_planes_reference,
)

CASES = ("box", "metal-rough-spheres", "clip", "random")
DERIVS = ("du0_dx", "dv0_dx", "du0_dy", "dv0_dy")


def _case(case, rng):
    """(setup rows (T', 64), winner ids (P,), width, row_offset)."""
    from awsm_renderer_tpu.ops import raster as JR
    from awsm_renderer_tpu_torch.passes.frame import _run_vertex

    if case == "clip":
        from test_torch_vertex import _renderers

        r = _renderers("clip")[1]
    else:
        r = T.torch_renderer("box" if case == "random" else case)
    ds = r._flush()
    m = r._mesh_masks()
    rows = _run_vertex(ds, torch.as_tensor(m["opaque"]), rw=T.W,
                       rh_full=T.H, needs_clip=m["needs_clip"],
                       pad=True).numpy()
    if case == "random":
        # arbitrary winners over valid rows, misses mixed in, evaluated
        # in a band starting at row 8 (row_offset)
        valid = np.nonzero(rows[:, 15] < 1e37)[0]
        tid = rng.choice(valid, T.W * T.H).astype(np.int32)
        tid[rng.uniform(size=tid.size) < 0.2] = -1
        return rows, tid, T.W, 8
    col, _ = JR.rasterize16_slim(jnp.asarray(rows), width=T.W, height=T.H,
                                 interpret=True)
    return rows, np.asarray(col), T.W, 0


@pytest.fixture(scope="module")
def resolved():
    from awsm_renderer_tpu.ops.shade import resolve_gbuffer

    rng = np.random.default_rng(5)
    out = {}
    for case in CASES:
        rows, tid, w, off = _case(case, rng)
        j = resolve_gbuffer({"tri_id": jnp.asarray(tid)}, jnp.asarray(rows),
                            width=w, height_full=T.H, row_offset=off)
        out[case] = (rows, tid, w, off,
                     {k: np.asarray(j[k]) for k in RESOLVE_NAMES})
    return out


@pytest.mark.parametrize("case", CASES)
def test_resolve_planes_match_jax(resolved, case):
    rows, tid, w, off, want = resolved[case]
    got = resolve_planes_fused(torch.tensor(tid), torch.tensor(rows),
                               width=w, row_offset=off)
    assert set(got) == set(RESOLVE_NAMES)
    np.testing.assert_array_equal(got["tri_id"].numpy(), want["tri_id"])
    np.testing.assert_array_equal(got["mat_row"].numpy(), want["mat_row"])
    assert (tid >= 0).any() and (tid < 0).any()
    for name in RESOLVE_NAMES[2:]:
        a, b = got[name].numpy(), want[name]
        assert np.all(a[tid < 0] == 0.0), name
        scale = max(1.0, float(np.abs(b).max()))
        rtol = 1e-3 if name in DERIVS else 1e-5
        np.testing.assert_allclose(a, b, rtol=rtol, atol=2e-5 * scale,
                                   err_msg=name)


def test_cpu_wrapper_is_the_twin(resolved):
    rows, tid, w, off, _ = resolved["random"]
    a = resolve_planes_fused(torch.tensor(tid), torch.tensor(rows),
                             width=w, row_offset=off)
    b = resolve_planes_reference(torch.tensor(tid), torch.tensor(rows),
                                 width=w, row_offset=off)
    for k in RESOLVE_NAMES:
        assert torch.equal(a[k], b[k]), k
