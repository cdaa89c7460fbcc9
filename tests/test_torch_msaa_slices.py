"""PyTorch port, K9's planned slice walk (csrc/raster_msaa.cu on K1's plan,
csrc/tile_walk.cuh), done with the plain walk on the CPU.

The kernel cuts each display tile's walk (its packed binned entries, then
the big groups whose tile box holds it) into slices of at most K9_SLICE
groups. Each warp tests only the triangles whose entry's quadrant gate
names its 16x2 display block's quadrant and whose bbox, widened by one
supersampled pixel, reaches one of the block's sample centres. A tile of
one slice writes its four sample planes directly; the slices of a split
tile meet in the least (|z|'s bits, walk position * 16 + triangle) key a
sample, which the last slice turns back into the winner's column and
whose z it recomputes with the sample's rounding. Done here with the plain
walk at slice size 2, so the tiles split, it must be bit-equal to the
sequential twin rasterize16_msaa_reference, on tests/test_torch_msaa.py's
two raster cases and on cases planted to test the merge; on the way it
asserts that no covered sample centre lies outside a warp block the cull
names."""

import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (torch's threads: each worker's share)
from test_raster import make_setup
from test_torch_raster import _warp_masks, k1_slices, planted_rows

from awsm_renderer_tpu_torch.ops import raster as TR

BT = 32
BLOCK_ROWS = 2   # raster_msaa.cu: a warp's 16x2 display block (PX = 1)


def _walk_entry(entries, tile_big, t, off, cnt, b):
    """Walk position b of tile t -> (group, quadrant gate): a binned
    entry unpacks to (e >> 8, e & 0xFF), a big group gates no quadrant
    out (0xFF)."""
    binned = entries[(off + b).clamp(0, entries.numel() - 1)]
    nb = tile_big.shape[1]
    big = (tile_big[t, (b - cnt).clamp(0, nb - 1)].long() if nb
           else torch.zeros_like(binned))
    is_binned = b < cnt
    return (torch.where(is_binned, binned >> 8, big),
            torch.where(is_binned, binned & 0xFF, 0xFF))


def _samples(v, a, b):
    """v at the four samples (tl, tr, bl, br): + a if j, then + b if i."""
    va = v + a
    return (v, va, v + b, va + b)


def k9_sliced(rows, bins, w2, h2, S):
    """K9 as raster_msaa.cu decomposes it, with the plain walk: returns
    ([tl, tr, bl, br] (H1, W1) int32, depth1 (H1, W1) f32, the plan's
    slices)."""
    rows = torch.as_tensor(rows)
    n_tx, n_ty = -(-w2 // (2 * BT)), -(-h2 // (2 * BT))
    n_tiles = n_tx * n_ty
    slices, tile_big = k1_slices(bins, n_tiles=n_tiles, n_tx=n_tx,
                                 slice_groups=S)
    tile, p0, off, cnt, n, ns = slices.T
    entries = bins[0].long()
    groups = rows.reshape(-1, TR.GROUP, rows.shape[1])
    flat = torch.arange(BT * BT)
    lx, ly = flat % BT, flat // BT
    quad = ((ly >= BT // 2).long() * 2 + (lx >= BT // 2).long())[None]
    block = ((ly // BLOCK_ROWS) * 2 + lx // 16)[None]

    def centres(t):          # the top-left sample centres, as the twin
        px = 2.0 * ((t % n_tx) * BT)[:, None].add(lx[None]).float() + 0.5
        py = 2.0 * (torch.div(t, n_tx, rounding_mode="floor") * BT
                    )[:, None].add(ly[None]).float() + 0.5
        return px, py

    px, py = centres(tile)
    n_sl = tile.numel()
    zs = [torch.ones((n_sl, BT * BT)) for _ in range(4)]
    cs = [torch.full((n_sl, BT * BT), -1, dtype=torch.int32)
          for _ in range(4)]
    pos = [torch.full((n_sl, BT * BT), -1, dtype=torch.int64)
           for _ in range(4)]
    for b in range(S):
        live = (b < n)[:, None]
        g, gate = _walk_entry(entries, tile_big, tile, off, cnt, p0 + b)
        g = torch.where(b < n, g, 0)
        P16 = groups[g]
        masks = _warp_masks(P16, tile[:, None], n_tx, scale=2,
                            rows=BLOCK_ROWS)
        gated = live & (((gate[:, None] >> quad) & 0x11) != 0)
        for k in range(TR.GROUP):
            r = P16[:, k]
            named = ((masks[:, k:k + 1] >> block) & 1) == 1
            edges = []
            for ra in (0, 3, 6):
                a, bb, c = (r[:, ra + i:ra + i + 1] for i in range(3))
                tl = (a > 0) | ((a == 0) & (bb > 0))
                edges.append((_samples(a * px + (bb * py + c), a, bb),
                              torch.where(tl, 0.0, TR._FMIN)))
            za, zb = r[:, 9:10], r[:, 10:11]
            z4 = _samples(za * px + (zb * py + r[:, 11:12]), za, zb)
            for s in range(4):
                cover = gated
                for vals, thr in edges:
                    cover = cover & (vals[s] >= thr)
                assert not (cover & ~named).any(), \
                    "the cull skips a covered sample"
                take = cover & named & (z4[s] >= 0.0) & (z4[s] < zs[s])
                zs[s] = torch.where(take, z4[s], zs[s])
                cs[s] = torch.where(take, (g * TR.GROUP + k).int()[:, None],
                                    cs[s])
                pos[s] = torch.where(take, ((p0 + b) * TR.GROUP + k)[:, None],
                                     pos[s])

    # split tiles: the least (|z| bits, walk position) a sample over their
    # slices; a tile with no slice (an empty walk) keeps no key: -1 and
    # 1.0, as the plan writes it
    none = torch.iinfo(torch.int64).max
    t_all = torch.arange(n_tiles)
    tpx, tpy = centres(t_all)
    one = ns == 1
    samp, zfin = [], []
    for s, (i, j) in enumerate(TR.MSAA_SAMPLES):
        key = torch.where(cs[s] >= 0,
                          zs[s].abs().view(torch.int32).long() << 32 | pos[s],
                          none)
        tkey = torch.full((n_tiles, BT * BT), none).scatter_reduce(
            0, tile[:, None].expand(-1, BT * BT), key, "amin")
        hit = tkey != none
        p = tkey & 0xFFFFFFFF
        g, _ = _walk_entry(entries, tile_big, t_all[:, None],
                           bins[1].long()[:, None], bins[2].long()[:, None],
                           torch.where(hit, p // TR.GROUP, 0))
        col = (g * TR.GROUP + p % TR.GROUP).clamp(min=0)
        zr = rows[:, 9:12][col]
        z = zr[..., 0] * tpx + (zr[..., 1] * tpy + zr[..., 2])
        z = z + zr[..., 0] if j else z
        z = z + zr[..., 1] if i else z
        col = torch.where(hit, col, -1).int()
        z = torch.where(hit, z, 1.0)
        # tiles of one slice write the slice's own states
        col[tile[one]] = cs[s][one]
        z[tile[one]] = zs[s][one]
        samp.append(col)
        zfin.append(z)
    depth = torch.minimum(torch.minimum(zfin[0], zfin[1]),
                          torch.minimum(zfin[2], zfin[3]))

    def deswizzle(x):
        x = x.reshape(n_ty, n_tx, BT, BT).transpose(1, 2)
        return x.reshape(n_ty * BT, n_tx * BT)[:h2 // 2, :w2 // 2]

    return [deswizzle(c) for c in samp], deswizzle(depth), slices


def _msaa_planted(case, copies=7):
    """Setup rows in supersampled pixels for the cases K1's planted_rows
    has no form of: slivers whose covered samples lie on a warp block's
    border, and entries whose two subgroups name different quadrants."""
    dummy = {"xy": [[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]]}
    tris, valid = [], []
    if case == "sliver":
        # a left edge at x = 31.5 (the last sample column of block 0), top
        # edges at y = 15.5 and 16.5 (the last sample row of block row 0,
        # the first of block row 1)
        for tri in ({"xy": [[31.5, 2.0], [31.9, 2.0], [31.5, 60.0]]},
                    {"xy": [[80.0, 15.5], [110.0, 15.5], [80.0, 15.9]]},
                    {"xy": [[40.0, 16.5], [70.0, 16.5], [40.0, 16.9]]}
                    ) * copies:
            tris += [tri] + [dummy] * 15
            valid += [True] + [False] * 15
    else:                                  # quadrants
        # subgroup 0 in quadrant 0 and subgroup 1 in quadrant 3 of tile 0,
        # at one depth: the gate passes both quadrants, no other
        q0 = {"xy": [[4.0, 4.0], [28.0, 4.0], [4.0, 28.0]], "z": [0.5] * 3}
        q3 = {"xy": [[36.0, 36.0], [60.0, 36.0], [36.0, 60.0]],
              "z": [0.5] * 3}
        for _ in range(copies):
            tris += [q0] + [dummy] * 7 + [q3] + [dummy] * 7
            valid += [True] + [False] * 7 + [True] + [False] * 7
    return np.asarray(make_setup(tris, valid)).T.copy()


PLANTED = ("tie_across_slices", "neg_zero", "z_one", "big_ties", "empty",
           "sliver", "quadrants")


def msaa_rows(case, copies=7):
    """(row-major setup in supersampled pixels, width2, height2) of a
    case: tests/test_torch_msaa.py's two raster cases or a planted one
    (`copies` groups of the planted triangles)."""
    if case in ("scene", "big_groups"):
        import test_torch_msaa as TM

        if case == "big_groups":
            return TM._big_rows()
        rows, w2, h2 = TM._rows2x(TM._scene(False, False))
        return rows.numpy(), w2, h2
    if case in ("sliver", "quadrants"):
        return _msaa_planted(case, copies), 128, 64
    rows = planted_rows(case, copies)[0]
    # big groups span more than K_SLOTS (32) of the 64x64 tiles
    return (rows, 512, 320) if case == "big_ties" else (rows, 128, 64)


@pytest.mark.parametrize("case", ("scene", "big_groups") + PLANTED)
def test_k9_slices_merge_bit_equal_to_twin(case):
    rows, w2, h2 = msaa_rows(case)
    t = torch.as_tensor(rows)
    G = t.shape[0] // TR.GROUP
    bins = TR.build_bins16(t, width=-(-w2 // 64) * 64,
                           height=-(-h2 // 64) * 64, vis_cap=G * TR.K_SLOTS,
                           stash_cap=G * TR.K_SLOTS + 1, tile_h=64, tile_w=64,
                           pack_submask=True)
    samp, depth, slices = k9_sliced(rows, bins, w2, h2, S=2)
    rsamp, rdepth = TR.rasterize16_msaa_reference(t, bins, width2=w2,
                                                  height2=h2)
    for a, b in zip(samp, rsamp):
        assert torch.equal(a, b)
    assert torch.equal(depth.view(torch.int32), rdepth.view(torch.int32))
    assert int((rsamp[0] >= 0).sum()) > 0, "nothing covered"
    assert int(slices[:, 5].max()) > 1, "no tile split"
    walk = torch.zeros(bins[2].numel(), dtype=torch.int64)
    walk.index_add_(0, slices[:, 0], slices[:, 4])
    if case == "big_ties":
        assert int(bins[6]) > 1, "no big groups"
    if case == "neg_zero":
        assert int((rdepth.view(torch.int32) == -2 ** 31).sum()) > 0
    if case == "z_one":
        assert bool((rdepth[rsamp[0] >= 0] < 1.0).all())
        assert int((rsamp[0] < 0).sum()) > 0
    if case == "empty":                   # empty tiles take no slice
        assert int((walk == 0).sum()) > 0, "no empty tile"
        assert walk.numel() - torch.unique(slices[:, 0]).numel() \
            == int((walk == 0).sum())
    if case == "sliver":
        hits = torch.unique(torch.cat([c[c >= 0] for c in rsamp]))
        assert hits.numel() >= 3, "a sliver covers nothing"
    if case == "quadrants":
        e = bins[0][:int(bins[2].sum())] & 0xFF
        assert bool((e == 0x81).any()), "no entry naming quadrants 0 and 3"
        won = torch.unique(torch.cat([c[c >= 0] for c in rsamp]) % TR.GROUP)
        assert set(won.tolist()) == {0, 8}
