"""PyTorch port, the overlay's binned fat raster: build_bins, K7
(rasterize_binned) and K8 (_rasterize_binned_compact, through
rasterize_layers_compact) as their plain twins, which the card run holds
bit-equal to the CUDA kernels, against the JAX package's binned kernel in
interpret mode; and K6's f32 entry against split_channels.

Equality. Bins, counts, B and chunk z-mins are bit-equal when the port is
given the reference's bin cap. tri_id and the compact tile list are equal
except at pixel centres lying on a triangle edge to within rounding
(tests/test_torch_raster.py's criterion: XLA:CPU contracts the edge
function into an FMA, the port rounds each step). Depth is within 2e-5
(the z-plane terms za*px of the steepest small triangles here reach
~1e2, and the contraction moves their sum by a few ulps of them; 6e-6 is
the largest difference seen) and the interpolated attribute planes
(random attributes of magnitude ~3) within rtol 1e-4, atol 1e-4: the
same contraction moves the barycentric products by a few ulps, and the
perspective divide of the scene's sliver triangles amplifies that (the
largest difference seen is 3.2e-5, on one pixel of 12,288)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (torch's share of the cores under xdist)

from test_raster import make_setup
from test_torch_raster import _on_an_edge

from awsm_renderer_tpu_torch.ops import raster as TR
from awsm_renderer_tpu_torch.ops.relayout import (
    gather_split_channels_f32, gather_split_channels_f32_reference,
)
from awsm_renderer_tpu_torch.ops.vertex import S_ORIG_ID

W, H = 128, 64
# the plane-layout variants: (has_uv1, has_color, analytic_derivs)
LAYOUTS = [(True, True, True), (False, True, True), (True, False, True),
           (True, True, False), (False, False, False)]


def _tris(seed, n, w, h, x0=0.0, y0=0.0):
    rng = np.random.default_rng(seed)
    tris = []
    while len(tris) < n:
        xy = rng.uniform([x0, y0], [w, h], size=(3, 2)).astype(np.float32)
        a = (xy[1, 0] - xy[0, 0]) * (xy[2, 1] - xy[0, 1]) - (
            xy[2, 0] - xy[0, 0]) * (xy[1, 1] - xy[0, 1])
        if abs(a) < 1.0:
            continue
        if a < 0:
            xy = xy[[0, 2, 1]]
        tris.append({"xy": xy, "z": rng.uniform(0.1, 0.9, 3).astype(
            np.float32), "iw": rng.uniform(0.5, 2.0, 3).astype(np.float32)})
    return tris


def _setup(tris, seed=1):
    """Column-major JAX setup (64, T') with random attribute rows (uv,
    colour, normal, tangent, tangent_w, mat_row) and the row-major port
    copy."""
    s = np.array(make_setup(tris))
    rng = np.random.default_rng(seed)
    s[21:S_ORIG_ID] = rng.standard_normal(
        (S_ORIG_ID - 21, s.shape[1])).astype(np.float32)
    return s, s.T.copy()


@pytest.fixture(scope="module")
def scene():
    """300 overlapping triangles over 128x64 (several 128-triangle chunks
    per tile) and random peel bounds."""
    s, rows = _setup(_tris(5, 300, W, H))
    rng = np.random.default_rng(2)
    zlo = rng.uniform(0.0, 0.3, (H, W)).astype(np.float32)
    zhi = rng.uniform(0.6, 1.0, (H, W)).astype(np.float32)
    return s, rows, zlo, zhi


@functools.lru_cache(maxsize=None)
def _jax_k7(layout, peel):
    """JAX rasterize_binned in interpret mode on the module scene, once
    per case (the fixture's arrays are rebuilt identically here)."""
    from awsm_renderer_tpu.ops import raster as JR

    s, _rows = _setup(_tris(5, 300, W, H))
    rng = np.random.default_rng(2)
    zlo = rng.uniform(0.0, 0.3, (H, W)).astype(np.float32)
    zhi = rng.uniform(0.6, 1.0, (H, W)).astype(np.float32)
    has_uv1, has_color, derivs = layout
    args = (jnp.asarray(zlo), jnp.asarray(zhi)) if peel else ()
    out = JR.rasterize_binned(jnp.asarray(s), *args, width=W, height=H,
                              interpret=True, has_uv1=has_uv1,
                              has_color=has_color, analytic_derivs=derivs)
    return {k: np.asarray(v) for k, v in out.items()}


def _assert_planes_match(rows, got, want, w, edge_ok=None):
    """tri_id equal off edge-rounding pixels, floats within tolerance
    where the winners agree; returns the pixels whose winners differ."""
    assert sorted(got) == sorted(want)
    jt, tt = want["tri_id"].reshape(-1), got["tri_id"].reshape(-1)
    off = jt != tt
    if edge_ok is None:
        edge_ok = _on_an_edge(rows, tt, w) & _on_an_edge(rows, jt, w)
    assert np.all(edge_ok[off])
    assert off.mean() < 0.002
    assert (jt >= 0).any()
    for k, v in want.items():
        if k == "tri_id":
            continue
        a, b = got[k].reshape(-1)[~off], v.reshape(-1)[~off]
        if k == "depth":
            np.testing.assert_allclose(a, b, rtol=0, atol=2e-5, err_msg=k)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4,
                                       err_msg=k)
    return off


@pytest.mark.parametrize("peel", [False, True], ids=["nopeel", "peel"])
@pytest.mark.parametrize("layout", LAYOUTS,
                         ids=["full", "no-uv1", "no-color", "no-derivs",
                              "slim"])
def test_k7_twin_matches_jax_binned(scene, layout, peel):
    s, rows, zlo, zhi = scene
    has_uv1, has_color, derivs = layout
    targs = (torch.as_tensor(zlo), torch.as_tensor(zhi)) if peel else ()
    got = TR.rasterize_binned(torch.as_tensor(rows), *targs, width=W,
                              height=H, has_uv1=has_uv1, has_color=has_color,
                              analytic_derivs=derivs)
    got = {k: v.numpy() for k, v in got.items()}
    assert list(got) == list(TR.plane_layout(has_uv1, has_color, derivs))
    _assert_planes_match(rows, got, _jax_k7(layout, peel), W)
    if peel:     # every fragment lies strictly inside its bounds
        hit = got["tri_id"] >= 0
        d = got["depth"][hit]
        assert np.all((d > zlo[hit]) & (d < zhi[hit]))


def test_build_bins_bit_equal_with_the_reference_cap(scene):
    from awsm_renderer_tpu.ops.raster import build_bins as jax_bins

    s, rows, _, _ = scene
    t = torch.as_tensor(rows)
    for max_bins in (128, 2):          # 2 < the chunks of a tile: clipped
        want = jax_bins(jnp.asarray(s), width=W, height=H,
                        max_bins=max_bins, tile_w=32, tile_h=32)
        got = TR.build_bins(t, width=W, height=H, max_bins=max_bins)
        assert got[2] == want[2]
        for name, a, b in zip(("bins", "counts", "B", "zmin"), want, got):
            if name != "B":
                np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                              err_msg=name)
    n_chunks = rows.shape[0] // TR.CHUNK
    free = TR.build_bins(t, width=W, height=H)
    assert free[2] == n_chunks and int(free[1].max()) == n_chunks


def test_reference_cap_drops_far_chunks_like_jax(scene):
    """With the reference's B = 2 each tile walks only its two nearest
    chunks; the twin reproduces the JAX kernel's output bit for bit
    (same cap) but for edge rounding, while the port's default bins every
    chunk."""
    from awsm_renderer_tpu.ops import raster as JR

    s, rows, _, _ = scene
    want = JR.rasterize_binned(jnp.asarray(s), width=W, height=H,
                               interpret=True, max_bins=2)
    got = TR.rasterize_binned(torch.as_tensor(rows), width=W, height=H,
                              max_bins=2)
    _assert_planes_match(rows, {k: v.numpy() for k, v in got.items()},
                         {k: np.asarray(v) for k, v in want.items()}, W)
    full = TR.rasterize_binned(torch.as_tensor(rows), width=W, height=H)
    assert (full["tri_id"] != got["tri_id"]).any(), "cap dropped nothing"


def test_reference_b_at_1080p():
    """The reference sizes B for the TPU's scalar memory: 104 chunks per
    tile over a 1920x1088 band (2040 tiles), with or without geometry."""
    from awsm_renderer_tpu.ops.raster import build_bins as jax_bins

    rows = TR.pad_setup_rows(torch.zeros((110 * TR.CHUNK - 5, 64)))
    got = TR.build_bins(rows, width=1920, height=1088, max_bins=128)
    want = jax_bins(jnp.asarray(rows.numpy().T), width=1920, height=1088,
                    max_bins=128, tile_w=32, tile_h=32)
    assert got[2] == want[2] == 104
    assert int(got[1].sum()) == 0


def test_z_tie_across_chunks_follows_the_zmin_walk():
    """Two coincident full-tile triangles at z = 0.5 in chunks 0 and 1;
    chunk 1 also holds a small near triangle, so its z-min ranks first
    and every tile walks it first: its triangle wins the tie (a dense
    index-order walk would pick chunk 0's). Held against the JAX binned
    kernel."""
    from awsm_renderer_tpu.ops import raster as JR

    quad = [{"xy": [[0, 0], [W, 0], [0, H]], "z": [0.5] * 3},
            {"xy": [[W, 0], [W, H], [0, H]], "z": [0.5] * 3}]
    dead = {"xy": [[0, 0], [1, 0], [0, 1]]}
    near = {"xy": [[1, 1], [3, 1], [1, 3]], "z": [0.1] * 3}
    tris = quad + [dead] * 126 + quad + [near] + [dead] * 125
    valid = np.array([i in (0, 1, 128, 129, 130) for i in range(256)])
    s = np.array(make_setup(tris, valid=valid))
    rows = s.T.copy()
    got = TR.rasterize_binned(torch.as_tensor(rows), width=W, height=H)
    want = JR.rasterize_binned(jnp.asarray(s), width=W, height=H,
                               interpret=True)
    tid = got["tri_id"].numpy()
    np.testing.assert_array_equal(tid, np.asarray(want["tri_id"]))
    inside = tid != 130
    assert set(np.unique(tid[inside])) == {128, 129}


@pytest.fixture(scope="module")
def compact_case():
    """Two triangle clusters in the corners of a 256x128 frame (32 tiles
    of 32x32) over a random opaque depth, and JAX's 3-layer compacted
    peel in interpret mode with a cap of 12 tiles."""
    from awsm_renderer_tpu.ops import raster as JR

    Wc, Hc = 256, 128
    tris = (_tris(7, 90, 70, 60, 4.0, 4.0)
            + _tris(8, 90, 250, 124, 180.0, 60.0))
    s, rows = _setup(tris, seed=3)
    depth = np.random.default_rng(4).uniform(0.7, 1.0, (Hc, Wc)).astype(
        np.float32)
    layers, tidx, n_tx = JR.rasterize_layers_compact(
        jnp.asarray(rows), jnp.asarray(depth), width=Wc, height=Hc,
        n_layers=3, tile_cap32=12, interpret=True)
    want = ({k: np.asarray(v) for k, v in layers.items()}, np.asarray(tidx),
            n_tx)
    return rows, depth, Wc, Hc, want


def test_k8_compact_peel_matches_jax(compact_case):
    rows, depth, Wc, Hc, (jl, jidx, jntx) = compact_case
    layers, tidx, n_tx = TR.rasterize_layers_compact(
        torch.as_tensor(rows), torch.as_tensor(depth), width=Wc, height=Hc,
        n_layers=3, tile_cap32=12)
    assert n_tx == jntx
    np.testing.assert_array_equal(tidx.numpy(), jidx)
    assert tidx.dtype == torch.int32 and tidx.shape == (12,)
    # the compact pixels' frame positions, for the edge criterion
    t = jidx.astype(np.int64)
    q = np.arange(1024)
    gx = (t % n_tx)[:, None] * 32 + q % 32
    gy = (t // n_tx)[:, None] * 32 + q // 32
    flat_w = Wc
    got = {k: v.numpy() for k, v in layers.items()}
    n_hit = 0
    for k in range(3):
        lay_t = {n: v[k] for n, v in got.items()}
        lay_j = {n: v[k] for n, v in jl.items()}
        # map each compact pixel to its frame index to reuse the criterion
        order = (gy * flat_w + gx).reshape(-1)
        tt = np.full(Wc * Hc, -1, np.int32)
        jt = np.full(Wc * Hc, -1, np.int32)
        tt[order], jt[order] = lay_t["tri_id"], lay_j["tri_id"]
        ok = (_on_an_edge(rows, tt, Wc) & _on_an_edge(rows, jt, Wc))[order]
        _assert_planes_match(rows, lay_t, lay_j, Wc, edge_ok=ok)
        n_hit += int((lay_t["tri_id"] >= 0).sum())
    assert n_hit > 0 and (got["tri_id"][1] >= 0).any()


def test_k8_padding_tiles_take_no_fragment(compact_case):
    """Tiles past the covered ones (cap above the coverage) and pixels
    below the frame in a partial tile row see zhi = 0: no fragment."""
    rows, depth, Wc, Hc, _ = compact_case
    hc = Hc - 16            # the last tile row is half outside the frame
    layers, tidx, n_tx = TR.rasterize_layers_compact(
        torch.as_tensor(rows), torch.as_tensor(depth[:hc]), width=Wc,
        height=hc, n_layers=2, tile_cap32=28)
    tid = layers["tri_id"][0].reshape(28, 32, 32).numpy()
    ty = (tidx.numpy() // n_tx)[:, None, None] * 32 + np.arange(32)[:, None]
    assert not (tid[np.broadcast_to(ty >= hc, tid.shape)] >= 0).any()
    assert (tid >= 0).any()


def test_k6_f32_twin_matches_split_channels(monkeypatch):
    """K6's f32 entry (the volume background gather) against JAX's
    split_channels of the gathered rows, its Pallas kernel in interpret
    mode; out-of-range indices clamp."""
    from jax.experimental import pallas as pl

    from awsm_renderer_tpu.ops.relayout import split_channels

    call = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        lambda *a, **k: call(*a, **{**k, "interpret": True}))
    rng = np.random.default_rng(9)
    table = rng.standard_normal((5000, 4)).astype(np.float32)
    idx = rng.integers(-20, 5020, 3 * 4096).astype(np.int32)
    safe = np.clip(idx, 0, table.shape[0] - 1)
    want = np.stack([np.asarray(c) for c in split_channels(
        jnp.asarray(table[safe]), interpret=False)])
    got = gather_split_channels_f32(torch.as_tensor(table),
                                    torch.as_tensor(idx), 4)
    assert got.shape == (4, idx.size) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))
    assert torch.equal(got[:3], gather_split_channels_f32_reference(
        torch.as_tensor(table), torch.as_tensor(idx), 3))
