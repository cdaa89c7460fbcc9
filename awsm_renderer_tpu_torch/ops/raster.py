"""Binned tile rasterizer -> (winner setup column, depth) per pixel.

Port of the production (v5) path of awsm_renderer_tpu/ops/raster.py:
pad_setup_rows, _group_zmin, build_bins16 (sort-based (tile, group) pair
binning, plain PyTorch here as it is XLA code there), K1
rasterize16_slim (hand-written CUDA, csrc/raster16.cu) with its plain
twin rasterize16_slim_reference, and rasterize16 (K1 then the K2
attribute resolve).

Fill convention: top-left rule with pixel centers at +0.5; depth is NDC z
in [0, 1], cleared to 1.0, LESS compare.
"""

from __future__ import annotations

import torch

from . import kernels
from .vertex import (
    NSETUP, S_BB_MAXX, S_BB_MAXY, S_BB_MINX, S_BB_MINY,
    S_E0A, S_E1A, S_E2A, S_ZA, S_ZB, S_ZC,
)

# smallest normal f32: E >= _FMIN <=> E > 0 for any non-degenerate edge
_FMIN = 1.1754943508222875e-38
TILE_H = 8
TILE_W = 128
BT_H = 32
BT_W = 32
CHUNK = 128
_BIG = 3.0e38
GROUP = 16            # triangles per binned fetch group
K_SLOTS = 32          # max coarse tiles a group may bin to before it is "big"
NBIG_CAP = 512        # capacity of the global big-group list


def plane_layout(has_uv1: bool = True, has_color: bool = True,
                 analytic_derivs: bool = True):
    """Plane names a rasterize16 call returns (the reference's fat
    G-buffer layout; untaken uv1/colour/derivative planes are elided)."""
    names = ["tri_id", "depth", "mat_row", "uv0_u", "uv0_v"]
    if has_uv1:
        names += ["uv1_u", "uv1_v"]
    if has_color:
        names += ["color_r", "color_g", "color_b", "color_a"]
    names += ["normal_x", "normal_y", "normal_z",
              "tangent_x", "tangent_y", "tangent_z", "tangent_w"]
    if analytic_derivs:
        names += ["du0_dx", "dv0_dx", "du0_dy", "dv0_dy"]
    return tuple(names)


def pad_setup_rows(rows: torch.Tensor) -> torch.Tensor:
    """Pad row-major setup (T, NSETUP) to a CHUNK multiple with invalid
    triangles (empty bboxes; their edge constant 0 with zero A/B covers
    nothing once the bbox test drops them from every bin)."""
    T = rows.shape[0]
    pad = (-T) % CHUNK
    if pad == 0:
        return rows
    tail = torch.zeros((pad, rows.shape[1]), dtype=rows.dtype,
                       device=rows.device)
    tail[:, S_BB_MINX] = _BIG
    tail[:, S_BB_MINY] = _BIG
    tail[:, S_BB_MAXX] = -_BIG
    tail[:, S_BB_MAXY] = -_BIG
    return torch.cat([rows, tail], dim=0)


def _ceil_log2(n: int) -> int:
    b = 0
    while (1 << b) < n:
        b += 1
    return b


def _group_zmin(setup_rows: torch.Tensor, n_groups: int) -> torch.Tensor:
    """Conservative per-group min NDC z (n_groups,) from row-major setup."""
    za, zb, zc = setup_rows[:, S_ZA], setup_rows[:, S_ZB], setup_rows[:, S_ZC]
    minx, maxx = setup_rows[:, S_BB_MINX], setup_rows[:, S_BB_MAXX]
    miny, maxy = setup_rows[:, S_BB_MINY], setup_rows[:, S_BB_MAXY]
    zx = torch.minimum(za * minx, za * maxx)
    zy = torch.minimum(zb * miny, zb * maxy)
    z = torch.where(minx <= maxx, zc + zx + zy, torch.full_like(zc, _BIG))
    return z.reshape(n_groups, GROUP).amin(dim=1)


def _f2i(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 saturating, NaN -> 0 (XLA's conversion, so the
    empty-bbox sentinels bin exactly as in the reference)."""
    lim = 2147483520.0          # largest f32 below 2**31
    i = torch.nan_to_num(x, nan=0.0).clamp(-2147483648.0, lim).to(torch.int32)
    return torch.where(x > lim, torch.iinfo(torch.int32).max, i)


def build_bins16(setup_rows: torch.Tensor, *, width: int, height: int,
                 vis_cap: int = 65536, stash_cap: int = 128):
    """Sort-based (tile, group) pair binning (reference: raster.py
    build_bins16 without the MSAA submask packing).

    setup_rows (T, NSETUP), T a GROUP multiple; 32x32 coarse tiles over
    (height, width), both 32-multiples. Groups spanning <= K_SLOTS tiles
    emit one pair per spanned tile keyed (tile << rank_bits) | zmin_rank,
    so each tile's list comes out near-to-far, ties in group order; wider
    groups go to the big list. Returns (entries (vis_cap,), offsets,
    counts (n_tiles,), zmin_g (G,), big_packed, big_ids (NBIG_CAP,),
    n_big (1,), n_clipped (1,)) — all int32 except zmin_g; n_clipped
    counts tiles whose bin was cut to stash_cap - 1 entries or by vis_cap."""
    dev = setup_rows.device
    T = setup_rows.shape[0]
    if T % GROUP:
        raise ValueError(f"setup rows {T} not a multiple of {GROUP}")
    G = T // GROUP
    n_ty, n_tx = height // BT_H, width // BT_W
    n_tiles = n_ty * n_tx
    rank_bits = _ceil_log2(G)
    if _ceil_log2(n_tiles) + rank_bits > 30:
        raise ValueError(f"bin key overflow: {n_tiles} tiles x {G} groups")

    minx = setup_rows[:, S_BB_MINX].reshape(G, GROUP).amin(dim=1)
    miny = setup_rows[:, S_BB_MINY].reshape(G, GROUP).amin(dim=1)
    maxx = setup_rows[:, S_BB_MAXX].reshape(G, GROUP).amax(dim=1)
    maxy = setup_rows[:, S_BB_MAXY].reshape(G, GROUP).amax(dim=1)
    zmin_g = _group_zmin(setup_rows, G)
    nonempty = minx <= maxx

    i32 = torch.int32
    tx0 = _f2i(torch.floor(minx / BT_W)).clamp(0, n_tx - 1)
    ty0 = _f2i(torch.floor(miny / BT_H)).clamp(0, n_ty - 1)
    # a bbox max exactly on a tile boundary belongs to the lower tile only
    tx1 = (_f2i(torch.ceil(maxx / BT_W)) - 1).clamp(0, n_tx - 1)
    ty1 = (_f2i(torch.ceil(maxy / BT_H)) - 1).clamp(0, n_ty - 1)
    tx1 = torch.maximum(tx1, tx0)
    ty1 = torch.maximum(ty1, ty0)
    sw = tx1 - tx0 + 1
    span = sw * (ty1 - ty0 + 1)
    small = nonempty & (span <= K_SLOTS)
    big = nonempty & (span > K_SLOTS)

    # near-first ranks; stable, so equal zmin keeps group order (the
    # first-wins depth-tie rule)
    order = torch.argsort(zmin_g, stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(G, device=dev)
    rank = rank.to(i32)

    j = torch.arange(K_SLOTS, dtype=i32, device=dev)[None, :]
    tilex = tx0[:, None] + j % sw[:, None]
    tiley = ty0[:, None] + torch.div(j, sw[:, None], rounding_mode="floor")
    slot_ok = small[:, None] & (j < span[:, None])
    tile = tiley * n_tx + tilex
    inval = n_tiles << rank_bits
    keys = torch.where(slot_ok, (tile << rank_bits) | rank[:, None],
                       torch.full_like(tile, inval))
    vals = torch.arange(G, dtype=i32, device=dev)[:, None].expand(G, K_SLOTS)
    keys_s, perm = torch.sort(keys.reshape(-1), stable=True)
    vals_s = vals.reshape(-1)[perm]

    bounds = torch.arange(n_tiles + 1, dtype=i32, device=dev) << rank_bits
    offs = torch.searchsorted(keys_s, bounds).to(i32)
    raw = offs[1:] - offs[:-1]
    offsets = offs[:-1].clamp(max=vis_cap)
    counts = torch.minimum(torch.minimum(raw, vis_cap - offsets),
                           torch.full_like(raw, stash_cap - 1))
    n_clipped = (counts < raw).sum().to(i32).reshape(1)
    entries = torch.zeros(vis_cap, dtype=i32, device=dev)
    n = min(vis_cap, vals_s.numel())
    entries[:n] = vals_s[:n]

    # big list: compact near-first
    bigkey = torch.where(big, rank, torch.full_like(rank, 0x7FFFFFFF))
    _, bid_s = torch.sort(bigkey, stable=True)
    bid_s = bid_s.to(i32)
    nb = min(G, NBIG_CAP)
    big_ids = torch.zeros(NBIG_CAP, dtype=i32, device=dev)
    big_ids[:nb] = bid_s[:nb]
    n_big = big.sum().clamp(max=NBIG_CAP).to(i32).reshape(1)
    bp = (tx0.clamp(0, 255) | (ty0.clamp(0, 255) << 8)
          | (tx1.clamp(0, 255) << 16) | (ty1.clamp(0, 255) << 24))
    big_packed = torch.zeros(NBIG_CAP, dtype=i32, device=dev)
    big_packed[:nb] = bp[bid_s[:nb].long()]
    return (entries, offsets, counts, zmin_g, big_packed, big_ids, n_big,
            n_clipped)


def _merge_groups(P16, col_base, px, py, best_z, best_col, live):
    """Merge one 16-triangle group per tile into the per-pixel state, in
    triangle order, strict z < best (the kernel's rule).

    P16 (n, GROUP, NSETUP) the tiles' group setup; col_base (n,) int;
    px/py (1, 1024); best_z/best_col (n, 1024); live (n,) bool — tiles
    whose walk reached this group."""
    for k in range(GROUP):
        r = P16[:, k, :]
        cover = live[:, None]
        for ra in (S_E0A, S_E1A, S_E2A):
            a, b, c = r[:, ra:ra + 1], r[:, ra + 1:ra + 2], r[:, ra + 2:ra + 3]
            e = a * px + (b * py + c)
            tl = (a > 0) | ((a == 0) & (b > 0))
            thr = torch.where(tl, 0.0, _FMIN)
            cover = cover & (e >= thr)
        z = r[:, S_ZA:S_ZA + 1] * px + (r[:, S_ZB:S_ZB + 1] * py
                                        + r[:, S_ZC:S_ZC + 1])
        take = cover & (z >= 0.0) & (z <= 1.0) & (z < best_z)
        best_z = torch.where(take, z, best_z)
        best_col = torch.where(take, (col_base + k)[:, None], best_col)
    return best_z, best_col


def rasterize16_slim_reference(setup_rows, bins, *, width: int,
                               height: int):
    """Plain PyTorch twin of K1: walks the same bins in the same order
    (all tiles in parallel, one entry index at a time), so col and depth
    are bit-equal to the kernel. Works on any device."""
    entries, offsets, counts, _zmin, big_packed, big_ids, n_big, _ = bins
    dev = setup_rows.device
    W32 = -(-width // BT_W) * BT_W
    H32 = -(-height // BT_H) * BT_H
    n_tx = W32 // BT_W
    n_tiles = (H32 // BT_H) * n_tx
    groups = setup_rows.reshape(-1, GROUP, NSETUP)
    t = torch.arange(n_tiles, device=dev)
    tile_x, tile_y = t % n_tx, torch.div(t, n_tx, rounding_mode="floor")
    flat = torch.arange(BT_H * BT_W, device=dev)
    lx = (flat % BT_W).float()[None, :]
    ly = torch.div(flat, BT_W, rounding_mode="floor").float()[None, :]
    px = (tile_x * BT_W).float()[:, None] + lx + 0.5          # (n_tiles, 1024)
    py = (tile_y * BT_H).float()[:, None] + ly + 0.5
    best_z = torch.ones((n_tiles, BT_H * BT_W), device=dev)
    best_col = torch.full((n_tiles, BT_H * BT_W), -1, dtype=torch.int32,
                          device=dev)
    counts_l = counts.long()
    offsets_l = offsets.long()
    for b in range(int(counts_l.max().item()) if n_tiles else 0):
        live = b < counts_l
        g = entries[(offsets_l + b).clamp(max=entries.numel() - 1)].long()
        g = torch.where(live, g, torch.zeros_like(g))
        best_z, best_col = _merge_groups(groups[g], (g * GROUP).int(), px, py,
                                         best_z, best_col, live)
    for i in range(int(n_big.item())):
        bb = int(big_packed[i].item())
        gx0, gy0 = bb & 255, (bb >> 8) & 255
        gx1, gy1 = (bb >> 16) & 255, (bb >> 24) & 255
        live = ((gx0 <= tile_x) & (tile_x <= gx1)
                & (gy0 <= tile_y) & (tile_y <= gy1))
        g = big_ids[i].long().expand(n_tiles)
        best_z, best_col = _merge_groups(groups[g], (g * GROUP).int(), px, py,
                                         best_z, best_col, live)
    n_ty = H32 // BT_H

    def deswizzle(x):
        x = x.reshape(n_ty, n_tx, BT_H, BT_W).transpose(1, 2)
        return x.reshape(H32, W32)[:height, :width].reshape(-1)

    return deswizzle(best_col), deswizzle(best_z)


def rasterize16_slim(setup_rows: torch.Tensor, bins=None, *, width: int,
                     height: int, vis_cap: int | None = None,
                     stash_cap: int | None = None):
    """K1: coverage raster over row-major setup (T, NSETUP) f32, T a GROUP
    multiple. Returns (col (H*W,) int32 winner setup row, -1 = miss;
    depth (H*W,) f32, 1.0 where missed), plus the bins it used.

    vis_cap / stash_cap None bin without clipping: every (tile, group)
    pair fits and no per-tile count is cut. The reference's caps (65536
    entries, stash_cap 128 -> at most 127 groups per tile) size its TPU
    VMEM stash, and a tile holding more groups silently drops geometry
    (metal-rough-spheres at 128x64 loses ~6% of its pixels); this kernel
    streams groups and needs no such bound. Pass the reference's caps to
    reproduce its bins exactly.

    A CUDA tensor launches the hand-written kernel (csrc/raster16.cu); a
    CPU tensor takes the plain twin."""
    W32 = -(-width // BT_W) * BT_W
    H32 = -(-height // BT_H) * BT_H
    if vis_cap is None:
        vis_cap = max(setup_rows.shape[0] // GROUP * K_SLOTS, 1)
    if stash_cap is None:
        stash_cap = vis_cap + 1
    if bins is None:
        bins = build_bins16(setup_rows, width=W32, height=H32,
                            vis_cap=vis_cap, stash_cap=stash_cap)
    if setup_rows.device.type == "cpu":
        return (*rasterize16_slim_reference(setup_rows, bins, width=width,
                                            height=height), bins)
    if setup_rows.dtype != torch.float32 or setup_rows.shape[1] != NSETUP:
        raise ValueError(f"setup rows must be (T, {NSETUP}) f32")
    if setup_rows.shape[0] % GROUP:
        raise ValueError(f"setup rows {setup_rows.shape[0]} not a multiple "
                         f"of {GROUP}")
    entries, offsets, counts, _zmin, big_packed, big_ids, n_big, _ = bins
    kernels.check_cuda(setup_rows, entries, offsets, counts, big_packed,
                       big_ids, n_big)
    for b in (entries, offsets, counts, big_packed, big_ids, n_big):
        if b.dtype != torch.int32:
            raise ValueError("bins must be int32")
    n_tx = W32 // BT_W
    n_tiles = (H32 // BT_H) * n_tx
    if counts.numel() != n_tiles or offsets.numel() != n_tiles:
        raise ValueError(f"bins hold {counts.numel()} tiles, not {n_tiles}")
    col = torch.empty(height * width, dtype=torch.int32,
                      device=setup_rows.device)
    depth = torch.empty(height * width, dtype=torch.float32,
                        device=setup_rows.device)
    ptrs = [t.data_ptr() for t in (setup_rows, entries, offsets, counts,
                                   big_packed, big_ids, n_big)]
    kernels.launch("rasterize16_slim", "awsm_raster16", *ptrs, n_tiles,
                   n_tx, width, height, col.data_ptr(), depth.data_ptr())
    return col, depth, bins


def rasterize16(setup_rows, *, width: int, height: int,
                has_uv1: bool = True, has_color: bool = True,
                analytic_derivs: bool = True):
    """K1 coverage (unclipped bins) + K2 attribute resolve ->
    {name: (height, width)} planes (plane_layout names) plus "bins" (the
    binner output, for diagnostics)."""
    from .shade import resolve_planes_fused

    names = plane_layout(has_uv1, has_color, analytic_derivs)
    col, depth, bins = rasterize16_slim(setup_rows, width=width,
                                        height=height)
    resolved = resolve_planes_fused(col, setup_rows, width=width)
    resolved["depth"] = depth
    out = {k: resolved[k].reshape(height, width) for k in names}
    out["bins"] = bins
    return out
