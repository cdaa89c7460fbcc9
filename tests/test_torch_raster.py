"""PyTorch port, binned raster: pad_setup_rows, _group_zmin, build_bins16
and K1 (rasterize16_slim, here its plain twin, which the card run holds
bit-equal to the CUDA kernel) vs the JAX v5 path in interpret mode.

Equality. Padding, group z-mins and every bin array are bit-equal. K1's
winner columns are equal on the reference's raster cases
(tests/test_raster.py: big groups :299, depth ties :149, the watertight
shared edge :342) and on a near-plane-clipped scene, except at pixel
centers lying on a shared edge to within rounding (see
test_k1_matches_jax_interpret). Depth is bit-equal
where the z-plane is constant; elsewhere within 1e-6 (a few ulps), since
XLA:CPU contracts z = za*px + (zb*py + zc) into FMAs and the port (like
its CUDA kernel, built with -fmad=false) rounds each step."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port as T
from test_raster import H as RH, W as RW, make_setup

from awsm_renderer_tpu_torch.ops import raster as TR

REF_CAPS = dict(vis_cap=65536, stash_cap=128)   # the reference's bin caps


def _random_tris(seed, n, big):
    rng = np.random.default_rng(seed)
    tris = []
    for _ in range(n):
        xy = rng.uniform([0, 0], [RW, RH], size=(3, 2)).astype(np.float32)
        area2 = (xy[1, 0] - xy[0, 0]) * (xy[2, 1] - xy[0, 1]) - (
            xy[2, 0] - xy[0, 0]) * (xy[1, 1] - xy[0, 1])
        if abs(area2) < 1.0:
            continue
        if area2 < 0:
            xy = xy[[0, 2, 1]]
        tris.append({"xy": xy,
                     "z": rng.uniform(0.1, 0.9, 3).astype(np.float32)})
    if big:       # screen-filling: exercises the big-group list
        tris.append({"xy": [[-10.0, -5.0], [600.0, -5.0], [-10.0, 300.0]],
                     "z": [0.95, 0.95, 0.95]})
    return tris


BIG_W, BIG_H = 256, 160    # > K_SLOTS (32) coarse tiles: big groups bin


def _case_rows(case):
    """(row-major setup (T', 64) f32, width, height) per test case."""
    if case == "big_groups":
        s = make_setup(_random_tris(11, 60, big=True))
        return np.asarray(s).T.copy(), BIG_W, BIG_H
    if case == "depth_ties":
        tri = [[10, 2], [110, 2], [60, 30]]
        s = make_setup([{"xy": tri, "z": [0.5] * 3}] * 2)
        return np.asarray(s).T.copy(), RW, RH
    from awsm_renderer_tpu_torch.passes.frame import (
        _run_vertex, prep_setup_rows,
    )
    if case == "shared_edge":
        r = _box_renderer()
    else:                                  # clip: 2T rows
        from test_torch_vertex import _renderers

        r = _renderers("clip")[1]
    ds = r._flush()
    m = r._mesh_masks()
    rows = prep_setup_rows(_run_vertex(ds, torch.as_tensor(m["opaque"]),
                                       rw=T.W, rh_full=T.H,
                                       needs_clip=m["needs_clip"]))
    return rows.numpy(), T.W, T.H


def _box_renderer():
    """tests/test_raster.py:342's scene on the port: an unlit box(0.8)
    face-on, whose diagonal is a shared edge."""
    import awsm_renderer_tpu_torch as P
    from awsm_renderer_tpu_torch.geometry import box
    from awsm_renderer_tpu_torch.utils import math3d as m3

    r = P.AwsmRendererTorch(P.RendererConfig(
        width=128, height=64, post_processing=P.PostProcessing(
            tonemapping=P.ToneMapping.NONE)), device="cpu")
    mat = r.materials.insert(P.UnlitMaterial(
        base_color_factor=np.array([1, 1, 1, 1], np.float32)))
    r.add_mesh(box(0.8), mat)
    r.camera.update(m3.look_at([0, 0, 3], [0, 0, 0], [0, 1, 0]),
                    m3.perspective(np.pi / 3, 2.0, 0.1, 100.0))
    return r


CASES = ("big_groups", "depth_ties", "shared_edge", "clip")


@pytest.fixture(scope="module")
def raster_cases():
    """{case: (rows, w, h, JAX (col, depth) from rasterize16_slim in
    interpret mode, JAX bins)}"""
    from awsm_renderer_tpu.ops import raster as JR

    out = {}
    for case in CASES:
        rows, w, h = _case_rows(case)
        col, depth = JR.rasterize16_slim(jnp.asarray(rows), width=w,
                                         height=h, interpret=True)
        bins = JR.build_bins16(jnp.asarray(rows), width=-(-w // 32) * 32,
                               height=-(-h // 32) * 32)
        out[case] = (rows, w, h, np.asarray(col), np.asarray(depth),
                     [np.asarray(b) for b in bins])
    return out


def test_pad_setup_rows_bit_equal():
    from awsm_renderer_tpu.ops.raster import pad_setup_rows as jax_pad

    rng = np.random.default_rng(1)
    rows = rng.standard_normal((77, 64)).astype(np.float32)
    want = np.asarray(jax_pad(jnp.asarray(rows)))
    got = TR.pad_setup_rows(torch.as_tensor(rows)).numpy()
    assert got.shape == (128, 64)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", CASES)
def test_bins_bit_equal(raster_cases, case):
    from awsm_renderer_tpu.ops.raster import _group_zmin

    rows, w, h, _, _, jbins = raster_cases[case]
    t = torch.as_tensor(rows)
    tbins = TR.build_bins16(t, width=-(-w // 32) * 32,
                            height=-(-h // 32) * 32, **REF_CAPS)
    names = ("entries", "offsets", "counts", "zmin_g", "big_packed",
             "big_ids", "n_big")
    for name, a, b in zip(names, jbins, tbins):
        np.testing.assert_array_equal(b.numpy(), a, err_msg=name)
    G = rows.shape[0] // TR.GROUP
    np.testing.assert_array_equal(
        TR._group_zmin(t, G).numpy(),
        np.asarray(_group_zmin(jnp.asarray(rows), G)))
    assert int(tbins[7]) == 0
    if case == "big_groups":
        assert int(tbins[6]) > 0, "no big group binned"


def test_bins_clip_like_the_reference():
    """A tile with more groups than the reference's TPU stash holds: the
    reference caps clip it (and n_clipped counts it); the port's frame
    default bins everything."""
    from awsm_renderer_tpu.ops.raster import build_bins16 as jax_bins

    rows = np.zeros((16 * 300, 64), np.float32)
    rows[:, 15:19] = [40.0, 10.0, 50.0, 20.0]     # all in tile (1, 0)
    rows[:, 11] = np.linspace(0.1, 0.9, rows.shape[0])
    t = torch.as_tensor(rows)
    clipped = TR.build_bins16(t, width=128, height=64, **REF_CAPS)
    want = jax_bins(jnp.asarray(rows), width=128, height=64)
    for a, b in zip(want, clipped):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert int(clipped[2][1]) == 127 and int(clipped[7]) == 1
    free = TR.build_bins16(t, width=128, height=64, vis_cap=300 * 32,
                           stash_cap=300 * 32 + 1)
    assert int(free[2][1]) == 300 and int(free[7]) == 0


def _on_an_edge(rows, col, w):
    """Per pixel: its center lies on an edge line of winner `col` to
    within the rounding of E = a*px + (b*py + c) — |E| no larger than a
    few ulps of its terms. There an FMA-rounded E (XLA:CPU) and the
    port's separately rounded E can take different signs, and with an
    exact zero the top-left rule, not the sign, decides ownership."""
    i = np.nonzero(col >= 0)[0]
    px = (i % w).astype(np.float32) + np.float32(0.5)
    py = (i // w).astype(np.float32) + np.float32(0.5)
    r = rows[col[i]]
    hit = np.zeros(col.shape, bool)
    for k in range(3):
        a, b, c = r[:, 3 * k], r[:, 3 * k + 1], r[:, 3 * k + 2]
        e = a * px + (b * py + c)
        bound = 1e-6 * (np.abs(a * px) + np.abs(b * py) + np.abs(c))
        hit[i] |= np.abs(e) <= bound
    return hit


@pytest.mark.parametrize("case", CASES)
def test_k1_matches_jax_interpret(raster_cases, case):
    rows, w, h, jcol, jdepth, _ = raster_cases[case]
    col, depth, _ = TR.rasterize16_slim(torch.as_tensor(rows), width=w,
                                        height=h, **REF_CAPS)
    col = col.numpy()
    # winners agree except where a pixel center lies on the shared edge
    # of both candidates to within rounding (the box-face diagonal runs
    # through pixel centers): there XLA's FMA-rounded edge value and the
    # port's picks the side. Both stay watertight.
    off = col != jcol
    assert np.all(_on_an_edge(rows, col, w)[off]
                  & _on_an_edge(rows, jcol, w)[off])
    assert off.mean() < 0.002
    assert (jcol >= 0).any()
    if case == "depth_ties":
        np.testing.assert_array_equal(depth.numpy(), jdepth)
        assert np.all(jcol[jcol >= 0] == 0), "first triangle wins a tie"
    else:
        np.testing.assert_allclose(depth.numpy()[~off], jdepth[~off],
                                   rtol=0, atol=1e-6)


def test_shared_edge_watertight_no_pinholes():
    """tests/test_raster.py:342 on the port's whole frame path."""
    r = _box_renderer()
    r.render()
    tid = r._last_tri_id.numpy()
    ys, xs = np.where(tid >= 0)
    sub = tid[ys.min() + 1:ys.max(), xs.min() + 1:xs.max()]
    assert not (sub < 0).any(), f"pinholes at {np.argwhere(sub < 0)}"


def test_reference_twin_walks_bins_in_order():
    """Two coincident groups at equal depth: the group binned first (lower
    id, equal zmin rank order) wins every pixel, big list included."""
    tri = [[-10.0, -5.0], [600.0, -5.0], [-10.0, 300.0]]   # big group
    s = np.asarray(make_setup([{"xy": tri, "z": [0.4] * 3}] * 17)).T.copy()
    col, depth, bins = TR.rasterize16_slim(torch.as_tensor(s), width=BIG_W,
                                           height=BIG_H)
    assert int(bins[6]) >= 1
    covered = col.numpy() >= 0
    assert covered.all() and np.all(col.numpy() == 0)
