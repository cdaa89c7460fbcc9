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
import chip_smoke as CS
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
    from awsm_renderer_tpu_torch.passes.frame import _run_vertex
    if case == "shared_edge":
        r = _box_renderer()
    else:                                  # clip: 2T rows
        from test_torch_vertex import _renderers

        r = _renderers("clip")[1]
    ds = r._flush()
    m = r._mesh_masks()
    rows = _run_vertex(ds, torch.as_tensor(m["opaque"]), rw=T.W,
                       rh_full=T.H, needs_clip=m["needs_clip"], pad=True)
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


# ---- K1's slice decomposition (csrc/raster16.cu) --------------------------
#
# The kernel cuts each tile's walk into slices of at most K1_SLICE groups
# (the plan, k1_slices here), walks each slice on its own with a per-warp
# bbox cull, writes a tile of one slice directly and merges the slices of a
# split tile by the least (|z|'s bits, walk position), turning the position
# back into the winner's column and recomputing its z. Done here with the
# plain walk at S = 2, so the 128x64 tiles split, it must be bit-equal to
# the sequential twin.

PLANTED = ("tie_across_slices", "neg_zero", "z_one", "big_ties", "empty",
           "sliver")


def _alone(tris):
    """Each triangle in a group of its own (15 invalid rows after it)."""
    out, valid = [], []
    dummy = {"xy": [[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]]}
    for tri in tris:
        out += [tri] + [dummy] * 15
        valid += [True] + [False] * 15
    return out, valid


def planted_rows(case, copies=7):
    """(row-major setup (T, 64) f32, width, height) of a K1 case built to
    test the slice merge: `copies` exact depth ties in groups of their own
    (they cross slice boundaries), a -0.0 z plane against +0.0, a z = 1.0
    plane (never wins), big groups that all tie, mostly empty tiles, and
    slivers whose covered centres lie on their bbox's edge."""
    big = [[-10.0, -5.0], [600.0, -5.0], [-10.0, 300.0]]
    w, h = RW, RH
    z_planes = {}
    if case == "tie_across_slices":
        tri = {"xy": [[4.0, 4.0], [60.0, 4.0], [4.0, 60.0]], "z": [0.5] * 3}
        sloped = {"xy": [[2.0, 2.0], [70.0, 2.0], [2.0, 62.0]],
                  "z": [0.3, 0.7, 0.5]}
        tris, valid = _alone([tri] * copies + [sloped])
    elif case == "neg_zero":
        a = [[4.0, 4.0], [60.0, 4.0], [4.0, 60.0]]
        b = [[68.0, 4.0], [124.0, 4.0], [68.0, 60.0]]
        far = {"xy": [[0.0, 0.0], [128.0, 0.0], [0.0, 64.0]], "z": [0.9] * 3}
        tris, valid = _alone([{"xy": a}, {"xy": a}, {"xy": b}, {"xy": b}]
                             + [far] * copies)
        # groups 0 and 3 at -0.0, 1 and 2 at +0.0 (group g is row 16 g)
        z_planes = {0: -0.0, 1: 0.0, 2: 0.0, 3: -0.0}
    elif case == "z_one":
        one = {"xy": [[0.0, 0.0], [128.0, 0.0], [0.0, 64.0]]}
        near = {"xy": [[10.0, 10.0], [40.0, 10.0], [10.0, 40.0]],
                "z": [0.5] * 3}
        tris, valid = _alone([one] * copies + [near])
        z_planes = {g: 1.0 for g in range(copies)}
    elif case == "big_ties":
        tris, valid = _alone([{"xy": big, "z": [0.4] * 3}] * (copies + 10))
        w, h = BIG_W, BIG_H
    elif case == "empty":
        tris, valid = _alone([
            {"xy": [[2.0, 2.0], [20.0, 2.0], [2.0, 20.0]], "z": [0.3] * 3},
            {"xy": [[5.0, 5.0], [30.0, 5.0], [5.0, 30.0]], "z": [0.2] * 3},
            {"xy": [[1.0, 9.0], [25.0, 3.0], [9.0, 28.0]], "z": [0.1] * 3}])
    else:                                  # sliver
        # a left edge at x = 15.5 and a top edge at y = 8.5: each covers
        # pixel centres on its bbox's edge, at a warp block's border
        tris, valid = _alone([
            {"xy": [[15.5, 2.0], [15.9, 2.0], [15.5, 30.0]], "z": [0.5] * 3},
            {"xy": [[40.0, 8.5], [70.0, 8.5], [40.0, 8.9]], "z": [0.5] * 3},
        ] * copies)
    rows = np.asarray(make_setup(tris, valid)).T.copy()
    for g, z in z_planes.items():          # a flat plane: 0*px + (0*py + z)
        rows[16 * g, 9:11] = np.copysign(np.float32(0.0), np.float32(z))
        rows[16 * g, 11] = z
    return rows, w, h


def k1_slices(bins, *, n_tiles: int, n_tx: int, slice_groups: int):
    """Plain form of raster16.cu's plan over `bins` (build_bins16's
    output): (slices (n_slices, 6) int64 rows (tile, p0, off, cnt, n, ns)
    in tile order, a slice walking positions p0 .. p0 + n - 1 of its
    tile's walk, ns slices to the tile, none for a tile with an empty
    walk (the plan writes its pixels); tile_big (n_tiles, n_big) int32,
    each tile's big groups in big-list order, -1 after). Walk position b
    of tile t is entries[off + b] for b < cnt, else tile_big[t, b - cnt]."""
    _e, offsets, counts, _z, _bp, big_ids, _nb, _c = bins
    touch = CS.k1_big_touch(bins, n_tx, torch)             # (n_tiles, nb)
    t = torch.arange(n_tiles)
    L = counts.long() + touch.sum(dim=1)
    ns = (L + slice_groups - 1) // slice_groups
    tile = torch.repeat_interleave(t, ns)
    p0 = (torch.arange(tile.numel()) - (torch.cumsum(ns, 0) - ns)[tile]
          ) * slice_groups
    slices = torch.stack([tile, p0, offsets.long()[tile], counts.long()[tile],
                          (L[tile] - p0).clamp(max=slice_groups), ns[tile]],
                         dim=1)
    tile_big = torch.full(touch.shape, -1, dtype=torch.int32)
    rank = touch.long().cumsum(dim=1) - 1
    ti, bi = touch.nonzero(as_tuple=True)
    tile_big[ti, rank[ti, bi]] = big_ids[bi]
    return slices, tile_big


def _warp_masks(P16, tile, n_tx, scale=1, rows=8):
    """raster16.cu stage_raw's cull rule for triangles P16 (..., 64) of
    tiles `tile`: bit w is set iff the triangle's bbox, widened by one
    pixel, reaches a pixel centre of warp w's 16 x `rows` block (w % 2,
    w // 2). scale 2 is raster_msaa.cu's rule: setup and bbox in
    supersampled pixels, a block's sample centres from 2x + 0.5 to 2x +
    1.5 (its blocks 16x2 display pixels, rows 2)."""
    X = ((tile % n_tx) * 32 * scale).float()
    Y = (torch.div(tile, n_tx, rounding_mode="floor") * 32 * scale).float()
    x0, y0 = P16[..., 15] - 1.0, P16[..., 16] - 1.0
    x1, y1 = P16[..., 17] + 1.0, P16[..., 18] + 1.0
    mask = torch.zeros(P16.shape[:-1], dtype=torch.int64)
    for w in range(2 * (32 // rows)):
        bx, by = X + 16 * scale * (w % 2), Y + rows * scale * (w // 2)
        hit = ((x0 <= bx + 16 * scale - 0.5) & (x1 >= bx + 0.5)
               & (y0 <= by + rows * scale - 0.5) & (y1 >= by + 0.5))
        mask |= hit.long() << w
    return mask


def k1_sliced(rows, bins, w, h, S):
    """K1 as raster16.cu decomposes it, with the plain walk: returns (col,
    depth (h*w,), the plan's slices). Asserts on the way that every pixel
    centre a triangle's edge test covers lies in a warp block its mask
    names (so the cull skips nothing the walk would take)."""
    rows = torch.as_tensor(rows)
    W32, H32 = -(-w // 32) * 32, -(-h // 32) * 32
    n_tx = W32 // 32
    n_tiles = n_tx * (H32 // 32)
    slices, tile_big = k1_slices(bins, n_tiles=n_tiles, n_tx=n_tx,
                                 slice_groups=S)
    tile, p0, off, cnt, n, ns = slices.T
    entries = bins[0].long()
    nb = tile_big.shape[1]

    def walk_group(t, o, c, b):
        binned = entries[(o + b).clamp(0, entries.numel() - 1)]
        big = (tile_big[t, (b - c).clamp(0, nb - 1)].long() if nb
               else torch.zeros_like(binned))
        return torch.where(b < c, binned, big)

    groups = rows.reshape(-1, TR.GROUP, rows.shape[1])
    px, py = TR._tile_pixels(tile, n_tx)
    flat = torch.arange(1024)
    block = (flat // 32 // 8) * 2 + (flat % 32) // 16
    best_z = torch.ones((tile.numel(), 1024))
    best_col = torch.full((tile.numel(), 1024), -1, dtype=torch.int32)
    pos = torch.full((tile.numel(), 1024), -1, dtype=torch.int64)
    for b in range(S):
        live = b < n
        g = torch.where(live, walk_group(tile, off, cnt, p0 + b), 0)
        P16 = groups[g]
        masks = _warp_masks(P16, tile[:, None], n_tx)
        for k in range(TR.GROUP):
            r = P16[:, k]
            cover = live[:, None]
            for ra in (0, 3, 6):
                a, bb, c = r[:, ra:ra + 1], r[:, ra + 1:ra + 2], \
                    r[:, ra + 2:ra + 3]
                tl = (a > 0) | ((a == 0) & (bb > 0))
                cover = cover & (a * px + (bb * py + c)
                                 >= torch.where(tl, 0.0, TR._FMIN))
            named = ((masks[:, k:k + 1] >> block[None]) & 1) == 1
            assert not (cover & ~named).any(), "the cull skips a covered pixel"
        z, col = TR._merge_groups(P16, (g * TR.GROUP).int(), px, py, best_z,
                                  best_col, live)
        took = col != best_col
        pos = torch.where(took, ((p0 + b) * TR.GROUP)[:, None]
                          + (col - (g * TR.GROUP)[:, None].int()).long(), pos)
        best_z, best_col = z, col

    # split tiles: the least (|z| bits, walk position) over their slices;
    # a tile with no slice (an empty walk) keeps no key: -1 and 1.0, as
    # the plan writes it
    none = torch.iinfo(torch.int64).max
    key = torch.where(best_col >= 0,
                      best_z.abs().view(torch.int32).long() << 32 | pos, none)
    tkey = torch.full((n_tiles, 1024), none, dtype=torch.int64).scatter_reduce(
        0, tile[:, None].expand(-1, 1024), key, "amin")
    hit = tkey != none
    b = (tkey & 0xFFFFFFFF) // TR.GROUP
    t_all = torch.arange(n_tiles)[:, None]
    g = walk_group(t_all, bins[1].long()[:, None], bins[2].long()[:, None],
                   torch.where(hit, b, 0))
    col = (g * TR.GROUP + (tkey & 0xFFFFFFFF) % TR.GROUP).clamp(min=0)
    tpx, tpy = TR._tile_pixels(torch.arange(n_tiles), n_tx)
    zr = rows[:, 9:12][col]
    depth = zr[..., 0] * tpx + (zr[..., 1] * tpy + zr[..., 2])
    col = torch.where(hit, col, -1).int()
    depth = torch.where(hit, depth, 1.0)
    # tiles of one slice write the slice's own state
    one = ns == 1
    col[tile[one]] = best_col[one]
    depth[tile[one]] = best_z[one]

    def deswizzle(x):
        x = x.reshape(H32 // 32, n_tx, 32, 32).transpose(1, 2)
        return x.reshape(H32, W32)[:h, :w].reshape(-1)

    return deswizzle(col), deswizzle(depth), slices


@pytest.mark.parametrize("case", CASES + PLANTED)
def test_k1_slices_merge_bit_equal_to_twin(raster_cases, case):
    if case in CASES:
        rows, w, h = raster_cases[case][:3]
    else:
        rows, w, h = planted_rows(case)
    t = torch.as_tensor(rows)
    bins = TR.build_bins16(t, width=-(-w // 32) * 32, height=-(-h // 32) * 32,
                           vis_cap=max(t.shape[0] // 16 * TR.K_SLOTS, 1),
                           stash_cap=t.shape[0] // 16 * TR.K_SLOTS + 1)
    col, depth, slices = k1_sliced(rows, bins, w, h, S=2)
    ccol, cdep = TR.rasterize16_slim_reference(t, bins, width=w, height=h)
    assert torch.equal(col, ccol)
    assert torch.equal(depth.view(torch.int32), cdep.view(torch.int32))
    walk = torch.zeros(bins[2].numel(), dtype=torch.int64)
    walk.index_add_(0, slices[:, 0], slices[:, 4])
    assert int(slices[:, 5].max()) > 1 or int(walk.max()) <= 2, \
        "a tile of more than S groups did not split"
    if case == "neg_zero":
        assert int((cdep.view(torch.int32) == -2 ** 31).sum()) > 0
    if case == "z_one":
        assert bool((cdep[ccol >= 0] < 1.0).all()) and int((ccol < 0).sum())
    if case in PLANTED:
        assert int(slices[:, 5].max()) > 1, "no tile split"
    if case == "empty":                   # empty tiles take no slice
        assert int((walk == 0).sum()) > 0, "no empty tile"
        assert walk.numel() - torch.unique(slices[:, 0]).numel() \
            == int((walk == 0).sum())
    if case == "sliver":
        hits = torch.unique(ccol[ccol >= 0])
        assert hits.numel() >= 2, "a sliver covers nothing"
