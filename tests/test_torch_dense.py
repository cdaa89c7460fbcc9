"""PyTorch port, the dense raster route: K11a (rasterize(binned=False)) and
K11b (rasterize_peel(binned=False)) as their plain twins, which the card
run holds bit-equal to the CUDA kernel (csrc/dense.cu), against the JAX
package's dense kernels in interpret mode; and the CPU rehearsal of
chip_smoke.py's oracle phase: the dense twin against the port's K1 + K2,
K7, K8 and K9 twins on the same inputs, every tri_id mismatch classified.

Criteria. Against JAX (rasterize(binned=False), _rasterize_peel_dense):
tri_id equal except at pixel centres lying on an edge of both candidates
to within rounding (tests/test_torch_raster.py's criterion: XLA:CPU
contracts the edge functions into FMAs, the port rounds each step), and
where the winners agree depth within 2e-5 and the attribute planes within
rtol 1e-4, atol 1e-4 (tests/test_torch_binned.py's tolerances, for the
same contraction; depth is bit-equal where the z-plane is constant).
Against the port's binned twins, which round exactly as the dense one
does: a tri_id may differ only at an exact depth tie (both winners cover
the pixel with bit-equal z; the walk order picks), or against K9 where an
edge value or the candidates' z lie within 4 ulps (K9 adds a and b to
its top-left sample); where the ids agree depth is bit-equal (against
K9 within 4 ulps of the z-plane terms) and the fat planes within 1e-4
(test_v5_matches_dense_with_big_groups's tolerance)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (torch's share of the cores under xdist)

import chip_smoke as CS
from test_torch_binned import _assert_planes_match, _setup, _tris

from awsm_renderer_tpu_torch.ops import raster as TR

W, H = 128, 64
FLAT = [20.0, 10.0], [70.0, 12.0], [40.0, 50.0]     # the tie triangle


def _scene_tris():
    """~250 random triangles over 128x64 (z in [0.1, 0.9]; three
    128-triangle chunks); one flat triangle at z 0.08, in front of them,
    three times: at indices 10 and 11 (one subgroup) and 132 (the next
    chunk), whose 16-triangle group 8 also holds a flat sliver at z 0.05
    elsewhere, so near-first walks (K1, K7, K9) meet it before group 0;
    a screen-filling triangle at z 0.95 last. Group 0 is otherwise flat
    at z 0.9, so its z-min is 0.08."""
    rnd = _tris(5, 246, W, H)
    flat = {"xy": FLAT, "z": [0.08] * 3, "iw": [1.0, 1.0, 1.0]}
    far = [{"xy": [[100.0 + k, 2.0], [104.0 + k, 2.0], [102.0 + k, 5.0]],
            "z": [0.9] * 3} for k in range(14)]
    sliver = {"xy": [[120.0, 58.0], [127.0, 58.0], [124.0, 63.0]],
              "z": [0.05] * 3}
    tris = far[:10] + [flat, flat] + far[10:] + rnd[:116]
    tris += [flat, sliver] + rnd[116:]
    tris.append({"xy": [[-10.0, -5.0], [300.0, -5.0], [-10.0, 200.0]],
                 "z": [0.95] * 3})
    return tris


@functools.lru_cache(maxsize=None)
def _scene():
    """(JAX column-major setup, port rows, zlo, zhi)."""
    s, rows = _setup(_scene_tris(), seed=4)
    rng = np.random.default_rng(6)
    zlo = rng.uniform(0.0, 0.3, (H, W)).astype(np.float32)
    zhi = rng.uniform(0.6, 1.0, (H, W)).astype(np.float32)
    return s, rows, zlo, zhi


@functools.lru_cache(maxsize=None)
def _jax_dense(peel: bool, slim: bool, derivs: bool):
    from awsm_renderer_tpu.ops import raster as JR

    s, _rows, zlo, zhi = _scene()
    if peel:
        out = JR._rasterize_peel_dense(
            jnp.asarray(s), jnp.asarray(zlo), jnp.asarray(zhi), width=W,
            height=H, interpret=True, slim=slim, analytic_derivs=derivs)
    else:
        out = JR.rasterize(jnp.asarray(s), width=W, height=H, binned=False,
                           slim=slim, analytic_derivs=derivs)
    return {k: np.asarray(v) for k, v in out.items()}


VARIANTS = [(False, True), (False, False), (True, True)]   # (slim, derivs)
VARIANT_IDS = ["fat", "fat-noderivs", "slim"]


def _port_dense(peel: bool, slim: bool, derivs: bool):
    _s, rows, zlo, zhi = _scene()
    t = torch.as_tensor(rows)
    if peel:
        return TR.rasterize_peel(t, torch.as_tensor(zlo),
                                 torch.as_tensor(zhi), width=W, height=H,
                                 binned=False, slim=slim,
                                 analytic_derivs=derivs)
    return TR.rasterize(t, width=W, height=H, binned=False, slim=slim,
                        analytic_derivs=derivs)


@pytest.mark.parametrize("peel", [False, True], ids=["raster", "peel"])
@pytest.mark.parametrize("slim, derivs", VARIANTS, ids=VARIANT_IDS)
def test_dense_twin_matches_jax(peel, slim, derivs):
    _s, rows, _zlo, _zhi = _scene()
    want = _jax_dense(peel, slim, derivs)
    got = {k: v.numpy() for k, v in _port_dense(peel, slim, derivs).items()}
    assert got["tri_id"].dtype == np.int32 and got["tri_id"].shape == (H, W)
    _assert_planes_match(rows, got, want, W)
    if not peel:
        # the flat triangle's first copy wins its pixels (lowest index on
        # a tie), in both
        tid = got["tri_id"]
        assert (tid == 10).sum() > 500
        assert not ((tid == 11) | (tid == 132)).any()


def test_dense_reference_entry_points():
    """rasterize(binned=False) on a CPU tensor is the named twin; the
    default route is K7's (rasterize_binned), which has no slim form here
    and no binned peel beside rasterize_binned; the dense grid refuses
    sizes off its 128 x 8 tiles and setup off whole chunks."""
    _s, rows, zlo, zhi = _scene()
    t = torch.as_tensor(rows)
    a = TR.rasterize(t, width=W, height=H, binned=False)
    b = TR.rasterize_dense_reference(t, width=W, height=H)
    assert sorted(a) == sorted(b)
    assert all(torch.equal(a[k], b[k]) for k in a)
    zl, zh = torch.as_tensor(zlo), torch.as_tensor(zhi)
    a = TR.rasterize_peel(t, zl, zh, width=W, height=H, binned=False,
                          slim=True)
    b = TR.rasterize_peel_dense_reference(t, zl, zh, width=W, height=H,
                                          slim=True)
    assert sorted(a) == ["depth", "tri_id"]
    assert all(torch.equal(a[k], b[k]) for k in a)
    binned = TR.rasterize(t, width=W, height=H)
    want = TR.rasterize_binned(t, width=W, height=H)
    assert all(torch.equal(binned[k], want[k]) for k in want)
    with pytest.raises(ValueError, match="dense route"):
        TR.rasterize(t, width=W, height=H, slim=True)
    with pytest.raises(ValueError, match="rasterize_binned"):
        TR.rasterize_peel(t, zl, zh, width=W, height=H, binned=True)
    with pytest.raises(ValueError, match="multiple"):
        TR.rasterize(t, width=W - 32, height=H, binned=False)
    with pytest.raises(ValueError, match="multiple"):
        TR.rasterize(t[:100], width=W, height=H, binned=False)


def test_oracle_against_k1_classifies_ties():
    """chip_smoke's K11a-vs-K1 + K2 comparison: K1 walks group 8 (z-min
    at most 0.05) before group 0 (0.08) and keeps the flat triangle's
    index-132 copy; the dense walk keeps index 10. Those pixels, and only
    those, differ, each an exact depth tie."""
    _s, rows, _zlo, _zhi = _scene()
    t = torch.as_tensor(rows)
    c = CS.oracle_k1(t, W, H, torch)
    assert c["unclassified"] == 0
    assert c["ties"] == c["mismatches"] > 500
    col, _depth, _bins = TR.rasterize16_slim(t, width=W, height=H)
    dense = TR.rasterize(t, width=W, height=H, binned=False, slim=True)
    off = col.reshape(H, W) != dense["tri_id"]
    assert bool((col.reshape(H, W)[off] == 132).all())
    assert bool((dense["tri_id"][off] == 10).all())


def test_oracle_against_k7_and_k8():
    """chip_smoke's K11b-vs-K7 and K11b-vs-K8 comparisons on the scene's
    peel bounds; K8 on a subset of the 32x32 tiles, as the compacted peel
    runs it."""
    _s, rows, zlo, zhi = _scene()
    t = torch.as_tensor(rows)
    zl, zh = torch.as_tensor(zlo), torch.as_tensor(zhi)
    kw7 = dict(width=W, height=H, has_uv1=True, has_color=False,
               analytic_derivs=True,
               bins=TR.build_bins(t, width=W, height=H))
    c = CS.oracle_k7(t, zl, zh, kw7, torch, "scene")
    assert c["unclassified"] == 0 and c["n"] == W * H and c["ties"] > 0
    tile_idx = torch.tensor([0, 2, 3, 5, 6], dtype=torch.int32)
    zl_c = TR._pad_swizzle32(zl, H, W).index_select(0, tile_idx.long())
    zh_c = TR._pad_swizzle32(zh, H, W).index_select(0, tile_idx.long())
    kw8 = dict(bins=kw7["bins"], tile_idx=tile_idx, n_tx=W // 32,
               has_uv1=False, has_color=True)
    c = CS.oracle_k8(t, zl_c, zh_c, kw8, torch, "scene")
    assert c["unclassified"] == 0 and c["n"] == 5 * 1024


def test_oracle_against_k9_at_2x():
    """chip_smoke's K11a-slim-vs-K9 comparison: the scene's setup read as
    a 256x128 supersampled raster (K9's 64x64 bins, a big group)."""
    _s, rows, _zlo, _zhi = _scene()
    big = rows.copy()
    live = big[:, 15] <= big[:, 17]       # padding keeps its empty bbox
    # stretch the scene over 2W x 2H: every plane equation and bbox
    for ra in (0, 3, 6, 9):
        big[:, ra] *= 0.5
        big[:, ra + 1] *= 0.5
    big[live, 15:19] *= 2.0
    t = TR.pad_setup_rows(torch.as_tensor(big))
    c = CS.oracle_k9(t, 2 * W, 2 * H, torch, "scene at 2x")
    assert c["unclassified"] == 0 and c["n"] == 4 * W * H and c["ties"] > 0


def test_oracle_flags_a_wrong_winner():
    """The oracle fails on a winner that is no tie: K1's id at one pixel
    of the flat triangle replaced by the screen-filling triangle's (which
    covers it, farther)."""
    _s, rows, _zlo, _zhi = _scene()
    t = torch.as_tensor(rows)
    a = TR.rasterize(t, width=W, height=H, binned=False)
    b = TR.rasterize16(t, width=W, height=H)
    b.pop("bins")
    y, x = 20, 40                                  # inside FLAT
    assert int(a["tri_id"][y, x]) == 10
    b["tri_id"][y, x] = len(_scene_tris()) - 1
    px, py = CS.pixel_centres(H, W, t.device, torch)
    with pytest.raises(CS.CheckFailed, match="classified"):
        CS.hold_oracle("a wrong winner", t, a, b, torch, px, py)
