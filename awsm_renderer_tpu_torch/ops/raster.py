"""Binned tile rasterizers, and the dense raster.

Port of four paths of awsm_renderer_tpu/ops/raster.py. The opaque (v5)
path: pad_setup_rows, _group_zmin, build_bins16 (sort-based (tile,
group) pair binning, plain PyTorch here as it is XLA code there), K1
rasterize16_slim (hand-written CUDA, csrc/raster16.cu) with its plain
twin rasterize16_slim_reference, and rasterize16 (K1 then the K2
attribute resolve). The MSAA path: K9 rasterize16_msaa (csrc/
raster_msaa.cu, twin rasterize16_msaa_reference) over build_bins16's
64x64 submask bins. The overlay's (v4) fat path: _chunk_bboxes,
_chunk_zmin, build_bins, K7 rasterize_binned and K8
_rasterize_binned_compact (csrc/binned.cu, twins *_reference), the
K-layer peels rasterize_layers_rows and rasterize_layers_compact. The
dense route: K11a / K11b (csrc/dense.cu, twins rasterize_dense_reference
and rasterize_peel_dense_reference) behind rasterize(binned=False) and
rasterize_peel(binned=False), which no frame path takes (the reference's
interpret-mode route; here the on-card oracle for the binned kernels,
chip_smoke.py's oracle phase). The port's setup is row-major (T,
NSETUP) everywhere, so the reference's column-major pad_setup is
pad_setup_rows here.

Fill convention: top-left rule with pixel centers at +0.5; depth is NDC z
in [0, 1], cleared to 1.0, LESS compare.
"""

from __future__ import annotations

import torch

from . import kernels
from .vertex import (
    NSETUP, S_BB_MAXX, S_BB_MAXY, S_BB_MINX, S_BB_MINY,
    S_E0A, S_E1A, S_E2A, S_ORIG_ID, S_ZA, S_ZB, S_ZC,
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
SUB = 8               # triangles per subgroup (K9's quadrant masks)
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


def _zmin_blocks(setup_rows: torch.Tensor, n: int, size: int) -> torch.Tensor:
    """Conservative min NDC z of each of `n` blocks of `size` rows: the
    affine z-plane's minimum over a triangle's screen bbox sits at a bbox
    corner, and the bbox holds the triangle."""
    za, zb, zc = setup_rows[:, S_ZA], setup_rows[:, S_ZB], setup_rows[:, S_ZC]
    minx, maxx = setup_rows[:, S_BB_MINX], setup_rows[:, S_BB_MAXX]
    miny, maxy = setup_rows[:, S_BB_MINY], setup_rows[:, S_BB_MAXY]
    zx = torch.minimum(za * minx, za * maxx)
    zy = torch.minimum(zb * miny, zb * maxy)
    z = torch.where(minx <= maxx, zc + zx + zy, torch.full_like(zc, _BIG))
    return z.reshape(n, size).amin(dim=1)


def _group_zmin(setup_rows: torch.Tensor, n_groups: int) -> torch.Tensor:
    """Conservative per-group min NDC z (n_groups,) from row-major setup."""
    return _zmin_blocks(setup_rows, n_groups, GROUP)


def _f2i(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 saturating, NaN -> 0 (XLA's conversion, so the
    empty-bbox sentinels bin exactly as in the reference)."""
    lim = 2147483520.0          # largest f32 below 2**31
    i = torch.nan_to_num(x, nan=0.0).clamp(-2147483648.0, lim).to(torch.int32)
    return torch.where(x > lim, torch.iinfo(torch.int32).max, i)


def build_bins16(setup_rows: torch.Tensor, *, width: int, height: int,
                 vis_cap: int = 65536, stash_cap: int = 128,
                 tile_h: int = BT_H, tile_w: int = BT_W,
                 pack_submask: bool = False):
    """Sort-based (tile, group) pair binning (reference: raster.py
    build_bins16).

    setup_rows (T, NSETUP), T a GROUP multiple; tile_h x tile_w coarse
    tiles over (height, width), multiples of them (32x32 for K1; K9 bins
    64x64 supersampled tiles = 32x32 display tiles). Groups spanning <=
    K_SLOTS tiles emit one pair per spanned tile keyed (tile << rank_bits)
    | zmin_rank, so each tile's list comes out near-to-far, ties in group
    order; wider groups go to the big list.

    pack_submask (K9): entries become (group << 8) | (mask1 << 4) | mask0,
    where bit q = qy*2 + qx of mask{h} is set iff SUBGROUP h's bbox (its 8
    consecutive triangles) overlaps the tile's quadrant q, half-open like
    the tile span; pairs no subgroup touches are dropped.

    Returns (entries (vis_cap,), offsets, counts (n_tiles,), zmin_g (G,),
    big_packed, big_ids (NBIG_CAP,), n_big (1,), n_clipped (1,)) — all
    int32 except zmin_g; n_clipped counts tiles whose bin was cut to
    stash_cap - 1 entries or by vis_cap."""
    dev = setup_rows.device
    T = setup_rows.shape[0]
    if T % GROUP:
        raise ValueError(f"setup rows {T} not a multiple of {GROUP}")
    G = T // GROUP
    n_ty, n_tx = height // tile_h, width // tile_w
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
    tx0 = _f2i(torch.floor(minx / tile_w)).clamp(0, n_tx - 1)
    ty0 = _f2i(torch.floor(miny / tile_h)).clamp(0, n_ty - 1)
    # a bbox max exactly on a tile boundary belongs to the lower tile only
    tx1 = (_f2i(torch.ceil(maxx / tile_w)) - 1).clamp(0, n_tx - 1)
    ty1 = (_f2i(torch.ceil(maxy / tile_h)) - 1).clamp(0, n_ty - 1)
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
    gids = torch.arange(G, dtype=i32, device=dev)[:, None]
    if pack_submask:
        if _ceil_log2(G) + 8 > 31:
            raise ValueError(f"{G} groups overflow the packed entries")
        n_sub = GROUP // SUB

        def sub(col, red):
            return red(setup_rows[:, col].reshape(G, n_sub, SUB), dim=2)

        sx0 = sub(S_BB_MINX, torch.amin)[:, None, :]          # (G, 1, S)
        sy0 = sub(S_BB_MINY, torch.amin)[:, None, :]
        sx1 = sub(S_BB_MAXX, torch.amax)[:, None, :]
        sy1 = sub(S_BB_MAXY, torch.amax)[:, None, :]
        tile_x0 = (tilex * tile_w).float()[:, :, None]         # (G, K, 1)
        tile_y0 = (tiley * tile_h).float()[:, :, None]
        mid_x = tile_x0 + tile_w // 2
        mid_y = tile_y0 + tile_h // 2
        lx = (sx0 < mid_x) & (sx1 > tile_x0)
        rx = (sx1 > mid_x) & (sx0 < tile_x0 + tile_w)
        top = (sy0 < mid_y) & (sy1 > tile_y0)
        bot = (sy1 > mid_y) & (sy0 < tile_y0 + tile_h)
        mask = ((lx & top).to(i32) | (rx & top).to(i32) << 1
                | (lx & bot).to(i32) << 2 | (rx & bot).to(i32) << 3)
        mask = torch.where(sx0 <= sx1, mask, 0)                # (G, K, S)
        packed = mask[:, :, 0]
        for h in range(1, n_sub):
            packed = packed | (mask[:, :, h] << (4 * h))
        # pairs where no subgroup touches the tile carry no work: drop
        slot_ok = slot_ok & (packed != 0)
        vals = (gids << 8) | packed
    else:
        vals = gids.expand(G, K_SLOTS)
    inval = n_tiles << rank_bits
    keys = torch.where(slot_ok, (tile << rank_bits) | rank[:, None],
                       torch.full_like(tile, inval))
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


def _merge_groups(P16, col_base, px, py, best_z, best_col, live,
                  zbounds=None):
    """Merge one block of triangles per tile into the per-pixel state, in
    triangle order, strict z < best (the kernels' rule).

    P16 (n, G, NSETUP) the tiles' block setup (a 16-triangle group for
    K1, a 128-triangle chunk for K7/K8); col_base (n,) int; px/py (n or
    1, 1024); best_z/best_col (n, 1024); live (n,) bool — tiles whose
    walk reached this block; zbounds: optional (zlo, zhi) (n, 1024)
    peel planes, a fragment must satisfy zlo < z < zhi."""
    for k in range(P16.shape[1]):
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
        if zbounds is not None:
            take = take & (z > zbounds[0]) & (z < zbounds[1])
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


# ---- K9: the MSAA-4x coverage raster ----------------------------------
#
# Coverage and depth at 2x2 samples per display pixel from setup in
# SUPERSAMPLED coordinates (twice the display resolution), binned to
# 64x64 supersampled tiles = 32x32 display tiles with per-subgroup
# quadrant masks (build_bins16 pack_submask). Shading happens once per
# display pixel afterwards (passes/frame.py _opaque_band_msaa).

MSAA_SAMPLES = ((0, 0), (0, 1), (1, 0), (1, 1))   # (i, j): tl, tr, bl, br


def _merge_groups_msaa(P16, col_base, px, py, zs, cs, live):
    """Merge one 16-triangle group per tile into the 4 per-sample states,
    in triangle order, strict z < best (the reference's per-subgroup "min
    z, lowest index" then strict < across subgroups).

    P16 (n, 16, NSETUP); px/py (n, 1024) supersampled coordinates of each
    display pixel's top-left sample center; zs/cs lists of 4 (n, 1024)
    sample states (tl, tr, bl, br), updated in place; live (n, 1024)
    bool. Sample (i, j) evaluates e00 = a*px + (b*py + c), then + a if j,
    then + b if i, the reference's _msaa_sample_winners rounding. Its
    missing z <= 1 test is implied: states start at 1.0 under strict <."""
    for k in range(P16.shape[1]):
        r = P16[:, k, :]
        edges = []
        for ra in (S_E0A, S_E1A, S_E2A):
            a, b, c = r[:, ra:ra + 1], r[:, ra + 1:ra + 2], r[:, ra + 2:ra + 3]
            tl = (a > 0) | ((a == 0) & (b > 0))
            edges.append((a * px + (b * py + c), a, b,
                          torch.where(tl, 0.0, _FMIN)))
        za, zb = r[:, S_ZA:S_ZA + 1], r[:, S_ZB:S_ZB + 1]
        z00 = za * px + (zb * py + r[:, S_ZC:S_ZC + 1])
        for s, (i, j) in enumerate(MSAA_SAMPLES):
            cover = live
            for e00, a, b, thr in edges:
                e = e00 + a if j else e00
                e = e + b if i else e
                cover = cover & (e >= thr)
            z = z00 + za if j else z00
            z = z + zb if i else z
            take = cover & (z >= 0.0) & (z < zs[s])
            zs[s] = torch.where(take, z, zs[s])
            cs[s] = torch.where(take, (col_base + k)[:, None], cs[s])


def rasterize16_msaa_reference(setup_rows, bins, *, width2: int,
                               height2: int):
    """Plain PyTorch twin of K9: walks the same bins in the same order as
    the kernel (all display tiles at once, one entry index at a time, an
    entry merged only in the quadrants its mask names; then the big
    groups in every quadrant), so the sample ids and the depth are
    bit-equal to it. Works on any device. Returns ([tl, tr, bl, br]
    (H1, W1) int32 winner setup rows, -1 = miss; depth1 (H1, W1) f32, the
    min of the 4 samples' z, 1.0 where all missed) at H1 = height2 // 2,
    W1 = width2 // 2."""
    entries, offsets, counts, _zmin, big_packed, big_ids, n_big, _ = bins
    dev = setup_rows.device
    H1, W1 = height2 // 2, width2 // 2
    n_tx = -(-width2 // (2 * BT_W))
    n_ty = -(-height2 // (2 * BT_H))
    n_tiles = n_ty * n_tx
    groups = setup_rows.reshape(-1, GROUP, NSETUP)
    t = torch.arange(n_tiles, device=dev)
    tile_x, tile_y = t % n_tx, torch.div(t, n_tx, rounding_mode="floor")
    flat = torch.arange(BT_H * BT_W, device=dev)
    lx = flat % BT_W
    ly = torch.div(flat, BT_W, rounding_mode="floor")
    quad = ((ly >= BT_H // 2).int() * 2 + (lx >= BT_W // 2).int())[None, :]
    px = 2.0 * ((tile_x * BT_W)[:, None] + lx[None, :]).float() + 0.5
    py = 2.0 * ((tile_y * BT_H)[:, None] + ly[None, :]).float() + 0.5
    zs = [torch.ones((n_tiles, BT_H * BT_W), device=dev) for _ in range(4)]
    cs = [torch.full((n_tiles, BT_H * BT_W), -1, dtype=torch.int32,
                     device=dev) for _ in range(4)]
    counts_l = counts.long()
    offsets_l = offsets.long()
    for b in range(int(counts_l.max().item()) if n_tiles else 0):
        live = b < counts_l
        e = entries[(offsets_l + b).clamp(max=entries.numel() - 1)]
        e = torch.where(live, e, torch.zeros_like(e))
        g = (e >> 8).long()
        gate = ((e[:, None] >> quad) & 0x11) != 0
        _merge_groups_msaa(groups[g], (g * GROUP).int(), px, py, zs, cs,
                           live[:, None] & gate)
    for i in range(int(n_big.item())):
        bb = int(big_packed[i].item())
        gx0, gy0 = bb & 255, (bb >> 8) & 255
        gx1, gy1 = (bb >> 16) & 255, (bb >> 24) & 255
        live = ((gx0 <= tile_x) & (tile_x <= gx1)
                & (gy0 <= tile_y) & (tile_y <= gy1))
        g = big_ids[i].long().expand(n_tiles)
        _merge_groups_msaa(groups[g], (g * GROUP).int(), px, py, zs, cs,
                           live[:, None].expand(-1, BT_H * BT_W))

    def deswizzle(x):
        x = x.reshape(n_ty, n_tx, BT_H, BT_W).transpose(1, 2)
        return x.reshape(n_ty * BT_H, n_tx * BT_W)[:H1, :W1]

    depth = torch.minimum(torch.minimum(zs[0], zs[1]),
                          torch.minimum(zs[2], zs[3]))
    return [deswizzle(c) for c in cs], deswizzle(depth)


def rasterize16_msaa(setup_rows: torch.Tensor, bins=None, *, width2: int,
                     height2: int, vis_cap: int | None = None,
                     stash_cap: int | None = None):
    """K9: MSAA-4x coverage raster from row-major setup (T, NSETUP) f32 in
    supersampled coordinates (width2 x height2, twice the display size),
    T a GROUP multiple. Returns ([tl, tr, bl, br] (H1, W1) int32 sample
    winners, depth1 (H1, W1) f32 min-sample depth, bins) at H1 =
    height2 // 2, W1 = width2 // 2; ids are setup-row indices.

    vis_cap / stash_cap None bin without clipping (the kernel streams
    groups); the reference's caps (65536 entries, stash_cap 4096,
    raster.py:1936-1938) reproduce its bins exactly. A CUDA tensor
    launches the hand-written kernel (csrc/raster_msaa.cu); a CPU tensor
    takes the plain twin."""
    W64 = -(-width2 // (2 * BT_W)) * (2 * BT_W)
    H64 = -(-height2 // (2 * BT_H)) * (2 * BT_H)
    if vis_cap is None:
        vis_cap = max(setup_rows.shape[0] // GROUP * K_SLOTS, 1)
    if stash_cap is None:
        stash_cap = vis_cap + 1
    if bins is None:
        bins = build_bins16(setup_rows, width=W64, height=H64,
                            vis_cap=vis_cap, stash_cap=stash_cap,
                            tile_h=2 * BT_H, tile_w=2 * BT_W,
                            pack_submask=True)
    if setup_rows.device.type == "cpu":
        return (*rasterize16_msaa_reference(setup_rows, bins, width2=width2,
                                            height2=height2), bins)
    if setup_rows.dtype != torch.float32 or setup_rows.dim() != 2 \
            or setup_rows.shape[1] != NSETUP:
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
    n_tx = W64 // (2 * BT_W)
    n_tiles = (H64 // (2 * BT_H)) * n_tx
    if counts.numel() != n_tiles or offsets.numel() != n_tiles:
        raise ValueError(f"bins hold {counts.numel()} tiles, not {n_tiles}")
    H1, W1 = height2 // 2, width2 // 2
    samp = torch.empty((4, H1, W1), dtype=torch.int32,
                       device=setup_rows.device)
    depth = torch.empty((H1, W1), dtype=torch.float32,
                        device=setup_rows.device)
    ptrs = [t.data_ptr() for t in (setup_rows, entries, offsets, counts,
                                   big_packed, big_ids, n_big)]
    kernels.launch("rasterize16_msaa", "awsm_raster_msaa", *ptrs, n_tiles,
                   n_tx, W1, H1, samp.data_ptr(), depth.data_ptr())
    return list(samp), depth, bins


# ---- v4 binned fat raster: K7 rasterize_binned, K8 the compacted peel ----
#
# 128-triangle chunks binned to 32x32 tiles near-first; each tile keeps
# the nearest fragment per pixel (optionally only zlo < z < zhi: a depth
# peel) and interpolates its winner's attributes once at the end. The
# overlay's passes run it: the transparent K-layer peel (band-wide, or
# over the covered tiles only) and the HUD over a compacted pool.


def _chunk_bboxes(setup_rows: torch.Tensor, n_chunks: int):
    """Conservative per-chunk screen bboxes (minx, miny, maxx, maxy), each
    (n_chunks,); invalid triangles carry empty boxes and drop out."""
    def col(c):
        return setup_rows[:, c].reshape(n_chunks, CHUNK)

    return (col(S_BB_MINX).amin(dim=1), col(S_BB_MINY).amin(dim=1),
            col(S_BB_MAXX).amax(dim=1), col(S_BB_MAXY).amax(dim=1))


def _chunk_zmin(setup_rows: torch.Tensor, n_chunks: int) -> torch.Tensor:
    """Conservative per-chunk min NDC z (n_chunks,), for the hi-Z skip."""
    return _zmin_blocks(setup_rows, n_chunks, CHUNK)


# the reference sizes its per-tile chunk list for the TPU's scalar memory
# (a ~0.85 MiB budget of int32 entries, raster.py build_bins)
_SMEM_BIN_ENTRIES = 850_000 // 4


def build_bins(setup_rows: torch.Tensor, *, width: int, height: int,
               max_bins: int | None = None):
    """Per-tile chunk lists for K7/K8 (reference: raster.py build_bins).

    setup_rows (T, NSETUP), T a CHUNK multiple; 32x32 tiles over (height,
    width), both 32-multiples. Each tile lists the chunks whose bbox
    overlaps it, ordered by the rank of their z-min (a stable sort, so an
    exact z-min tie keeps chunk order): near first, for the hi-Z skip.
    Returns (bins (n_tiles*B,) int32, counts (n_tiles,) int32, B, zmin
    (n_chunks,) f32); pad slots repeat a tile's last chunk, an empty
    tile's slots hold 0.

    max_bins None lists every overlapping chunk (B = n_chunks). The
    reference caps B at min(max_bins, its scalar-memory budget / n_tiles,
    n_chunks) and silently drops each tile's farthest chunks beyond it (a
    TPU sizing fault; 104 chunks at 1080p); pass its max_bins to
    reproduce its bins exactly."""
    dev = setup_rows.device
    T = setup_rows.shape[0]
    if T % CHUNK:
        raise ValueError(f"setup rows {T} not a multiple of {CHUNK}")
    n_chunks = T // CHUNK
    n_ty, n_tx = height // BT_H, width // BT_W
    n_tiles = n_ty * n_tx
    if max_bins is None:
        B = n_chunks
    else:
        B = min(max_bins, max(8, _SMEM_BIN_ENTRIES // n_tiles), n_chunks)
    minx, miny, maxx, maxy = _chunk_bboxes(setup_rows, n_chunks)
    zmin = _chunk_zmin(setup_rows, n_chunks)

    tx0 = torch.arange(n_tx, dtype=torch.float32, device=dev) * BT_W
    ty0 = torch.arange(n_ty, dtype=torch.float32, device=dev) * BT_H
    ox = (minx[None, :] < (tx0 + BT_W)[:, None]) & (maxx[None, :] > tx0[:, None])
    oy = (miny[None, :] < (ty0 + BT_H)[:, None]) & (maxy[None, :] > ty0[:, None])
    overlap = (oy[:, None, :] & ox[None, :, :]).reshape(n_tiles, n_chunks)

    counts = overlap.sum(dim=1).clamp(max=B).to(torch.int32)
    order = torch.argsort(zmin, stable=True)              # rank -> chunk id
    rank = torch.empty_like(order)
    rank[order] = torch.arange(n_chunks, device=dev)
    key = torch.where(overlap, rank[None, :],
                      torch.full_like(rank, n_chunks)[None, :])
    ranks_sel = torch.sort(key, dim=1).values[:, :B]     # B nearest ranks
    bins = order[ranks_sel.clamp(0, n_chunks - 1)].to(torch.int32)
    last = bins.gather(1, (counts.long() - 1).clamp(min=0)[:, None])
    bins = torch.where(ranks_sel < n_chunks, bins, last)
    bins = torch.where(counts[:, None] == 0, torch.zeros_like(bins), bins)
    return bins.reshape(-1), counts, B, zmin


def _tile_pixels(tiles: torch.Tensor, n_tx: int):
    """Pixel centres px, py (n, 1024) of 32x32 logical tiles `tiles`."""
    flat = torch.arange(BT_H * BT_W, device=tiles.device)
    lx = (flat % BT_W).float()[None, :]
    ly = torch.div(flat, BT_W, rounding_mode="floor").float()[None, :]
    tx = tiles % n_tx
    ty = torch.div(tiles, n_tx, rounding_mode="floor")
    return ((tx * BT_W).float()[:, None] + lx + 0.5,
            (ty * BT_H).float()[:, None] + ly + 0.5)


def _pad_swizzle32(img: torch.Tensor, H32: int, W32: int) -> torch.Tensor:
    """(h, w) plane -> (n_tiles, 1024) row-major 32x32 tile blocks, padded
    with 0.0 to (H32, W32) (a peel bound of 0 admits no fragment)."""
    h, w = img.shape
    full = torch.zeros((H32, W32), dtype=img.dtype, device=img.device)
    full[:h, :w] = img
    return (full.reshape(H32 // BT_H, BT_H, W32 // BT_W, BT_W)
            .transpose(1, 2).reshape(-1, BT_H * BT_W))


def _deswizzle32(tiles: torch.Tensor, H32: int, W32: int) -> torch.Tensor:
    """(n_tiles, 1024) tile blocks -> (H32, W32)."""
    return (tiles.reshape(H32 // BT_H, W32 // BT_W, BT_H, BT_W)
            .transpose(1, 2).reshape(H32, W32))


def _binned_walk(setup_rows, bins, tiles, n_tx: int, zbounds=None):
    """The K7/K8 merge, for the logical tiles `tiles` (n,) all at once:
    each tile walks its chunk list in order, skips a chunk whose z-min
    cannot beat the tile's worst depth (hi-Z; exact under the strict <),
    and merges the chunk's triangles in index order. zbounds: optional
    (zlo, zhi) (n, 1024) peel planes. Returns (best_z, best_col (n,
    1024), px, py, merged chunk visits (0-d tensor))."""
    bin_idx, counts, B, zmin = bins
    dev = setup_rows.device
    chunks = setup_rows.reshape(-1, CHUNK, NSETUP)
    px, py = _tile_pixels(tiles, n_tx)
    n = tiles.shape[0]
    best_z = torch.ones((n, BT_H * BT_W), device=dev)
    best_col = torch.full((n, BT_H * BT_W), -1, dtype=torch.int32,
                          device=dev)
    cnt = counts.index_select(0, tiles).long()
    base = tiles.long() * B
    visits = torch.zeros((), dtype=torch.int64, device=dev)
    for b in range(int(cnt.max().item()) if n else 0):
        live = b < cnt
        c = bin_idx[(base + b).clamp(max=bin_idx.numel() - 1)].long()
        c = torch.where(live, c, torch.zeros_like(c))
        live = live & (zmin[c] < best_z.amax(dim=1))
        visits = visits + live.sum()
        best_z, best_col = _merge_groups(chunks[c], (c * CHUNK).int(), px, py,
                                         best_z, best_col, live, zbounds)
    return best_z, best_col, px, py, visits


def _flush_planes(setup_rows, best_z, best_col, px, py, names):
    """Winner state -> the named planes, shaped like best_z (reference
    _flush_planes: K2's _resolve_math on the winner's setup row at the
    pixel centre; tri_id is the winner row's S_ORIG_ID). A miss gives
    tri_id -1, depth 1.0 and zero attribute planes."""
    from .shade import _resolve_math

    shape = best_z.shape
    miss = (best_col < 0).reshape(-1)
    S = setup_rows.index_select(0, best_col.reshape(-1).clamp(min=0).long())
    S = torch.where(miss[:, None], torch.zeros((), device=S.device), S)
    ch = S.T
    res = _resolve_math(ch, px.expand(shape).reshape(-1),
                        py.expand(shape).reshape(-1))
    tid = torch.where(miss, torch.full_like(miss, -1, dtype=torch.int32),
                      ch[S_ORIG_ID].to(torch.int32))
    out = {"tri_id": tid.reshape(shape), "depth": best_z}
    for name in names[2:]:
        out[name] = res[name].reshape(shape)
    return out


def _binned_kernel(name: str, setup_rows, bins, *, tile_idx, n_tx: int,
                   width: int, height: int, zlo, zhi, names, out_shape):
    """Launch csrc/binned.cu (K7 with tile_idx None, K8 otherwise)."""
    bin_idx, counts, B, zmin = bins
    if setup_rows.dtype != torch.float32 or setup_rows.dim() != 2 \
            or setup_rows.shape[1] != NSETUP:
        raise ValueError(f"setup rows must be (T, {NSETUP}) f32")
    if setup_rows.shape[0] % CHUNK:
        raise ValueError(f"setup rows {setup_rows.shape[0]} not a multiple "
                         f"of {CHUNK}")
    for b in (bin_idx, counts) + (() if tile_idx is None else (tile_idx,)):
        if b.dtype != torch.int32:
            raise ValueError("bins, counts and tile_idx must be int32")
    if zmin.dtype != torch.float32:
        raise ValueError("zmin must be f32")
    P_out = 1
    for s in out_shape:
        P_out *= s
    peel = zlo is not None
    if peel:
        zlo, zhi = zlo.contiguous(), zhi.contiguous()
        if zlo.dtype != torch.float32 or zhi.dtype != torch.float32 \
                or zlo.numel() != P_out or zhi.numel() != P_out:
            raise ValueError(f"zlo/zhi must be f32 of {P_out} values")
    extra = (() if tile_idx is None else (tile_idx,)) + \
        ((zlo, zhi) if peel else ())
    kernels.check_cuda(setup_rows, bin_idx, counts, zmin, *extra)
    n_blocks = (tile_idx.numel() if tile_idx is not None
                else -(-height // BT_H) * n_tx)
    dev = setup_rows.device
    tid = torch.empty(P_out, dtype=torch.int32, device=dev)
    planes = torch.empty((len(names) - 1, P_out), dtype=torch.float32,
                         device=dev)
    flags = ((1 if "uv1_u" in names else 0) | (2 if "color_r" in names else 0)
             | (4 if "du0_dx" in names else 0))
    kernels.launch(
        name, "awsm_binned", setup_rows.data_ptr(), bin_idx.data_ptr(),
        counts.data_ptr(), zmin.data_ptr(), B,
        None if tile_idx is None else tile_idx.data_ptr(), n_blocks, n_tx,
        width, height, zlo.data_ptr() if peel else None,
        zhi.data_ptr() if peel else None, flags, P_out, tid.data_ptr(),
        planes.data_ptr())
    out = {"tri_id": tid.reshape(out_shape)}
    out.update((k, p.reshape(out_shape)) for k, p in zip(names[1:], planes))
    return out


def rasterize_binned(setup_rows, zlo=None, zhi=None, *, width: int,
                     height: int, has_uv1: bool = True, has_color: bool = True,
                     analytic_derivs: bool = True, max_bins: int | None = None,
                     bins=None):
    """K7: binned fat raster of row-major setup (T, NSETUP) f32, T a CHUNK
    multiple -> {name: (height, width)} planes (plane_layout names; tri_id
    int32 from the winners' S_ORIG_ID, -1 = miss). zlo/zhi (height, width)
    f32 make it one depth peel: a fragment must satisfy zlo < z < zhi.
    bins: a prebuilt build_bins result (the K-layer peel bins once).

    The reference's rasterize() dispatches here on hardware (and to the
    dense K11 kernel in interpret mode); the port's HUD pass calls this
    directly. A CUDA tensor launches csrc/binned.cu; a CPU tensor takes
    the plain twin (rasterize_binned_reference)."""
    W32 = -(-width // BT_W) * BT_W
    H32 = -(-height // BT_H) * BT_H
    if bins is None:
        bins = build_bins(setup_rows, width=W32, height=H32,
                          max_bins=max_bins)
    names = plane_layout(has_uv1, has_color, analytic_derivs)
    if setup_rows.device.type == "cpu":
        return rasterize_binned_reference(setup_rows, zlo, zhi, bins=bins,
                                          width=width, height=height,
                                          names=names)
    return _binned_kernel("rasterize_binned", setup_rows, bins,
                          tile_idx=None, n_tx=W32 // BT_W, width=width,
                          height=height, zlo=zlo, zhi=zhi, names=names,
                          out_shape=(height, width))


def rasterize_binned_reference(setup_rows, zlo, zhi, *, bins, width: int,
                               height: int, names):
    """Plain PyTorch twin of K7: walks the same bins in the same order for
    all tiles at once, so tri_id and every plane are bit-equal to the
    kernel. Works on any device."""
    W32 = -(-width // BT_W) * BT_W
    H32 = -(-height // BT_H) * BT_H
    n_tx = W32 // BT_W
    tiles = torch.arange((H32 // BT_H) * n_tx, device=setup_rows.device)
    zb = None
    if zlo is not None:
        zb = (_pad_swizzle32(zlo, H32, W32), _pad_swizzle32(zhi, H32, W32))
    best_z, best_col, px, py, _ = _binned_walk(setup_rows, bins, tiles, n_tx,
                                               zb)
    planes = _flush_planes(setup_rows, best_z, best_col, px, py, names)
    return {k: _deswizzle32(v, H32, W32)[:height, :width]
            for k, v in planes.items()}


def _rasterize_binned_compact(setup_rows, zlo_c, zhi_c, *, bins, tile_idx,
                              n_tx: int, has_uv1: bool, has_color: bool,
                              analytic_derivs: bool = True):
    """K8: one peel of the covered-tile-compacted K-layer raster. Block i
    of every (C, 1024) input and output plane is logical tile
    tile_idx[i] (32x32 row-major); zlo_c/zhi_c (C, 1024) f32. Returns
    {name: (C, 1024)}. A CUDA tensor launches csrc/binned.cu; a CPU
    tensor takes the plain twin."""
    names = plane_layout(has_uv1, has_color, analytic_derivs)
    if setup_rows.device.type == "cpu":
        return rasterize_binned_compact_reference(
            setup_rows, zlo_c, zhi_c, bins=bins, tile_idx=tile_idx,
            n_tx=n_tx, names=names)
    return _binned_kernel("rasterize_binned_compact", setup_rows, bins,
                          tile_idx=tile_idx, n_tx=n_tx, width=0, height=0,
                          zlo=zlo_c, zhi=zhi_c, names=names,
                          out_shape=tuple(zlo_c.shape))


def rasterize_binned_compact_reference(setup_rows, zlo_c, zhi_c, *, bins,
                                       tile_idx, n_tx: int, names):
    """Plain PyTorch twin of K8 (bit-equal). Works on any device."""
    best_z, best_col, px, py, _ = _binned_walk(
        setup_rows, bins, tile_idx.long(), n_tx, (zlo_c, zhi_c))
    return _flush_planes(setup_rows, best_z, best_col, px, py, names)


def _empty_layer(layer):
    """A peel the runtime skip proved empty: tri_id -1, zero planes (the
    reference's skip fills zeros, depth included)."""
    return {k: (torch.full_like(v, -1) if k == "tri_id"
                else torch.zeros_like(v)) for k, v in layer.items()}


def _peel_layers(peel, zlo, n_layers: int):
    """Run `peel(zlo)` front to back, chaining zlo to each layer's depth
    (2.0 where it missed). Runtime peel skip: once layer k-1 holds no
    fragment every deeper peel is empty, so the kernel is not launched
    (one host sync per layer after the first). Returns {name: (K, N)}."""
    per_layer = []
    for k in range(n_layers):
        if k and not bool((per_layer[-1]["tri_id"] >= 0).any()):
            per_layer += [_empty_layer(per_layer[-1])] * (n_layers - k)
            break
        layer = peel(zlo)
        zlo = torch.where(layer["tri_id"] >= 0, layer["depth"],
                          torch.full_like(layer["depth"], 2.0))
        per_layer.append({n: v.reshape(-1) for n, v in layer.items()})
    return {n: torch.stack([lay[n] for lay in per_layer])
            for n in per_layer[0]}


def rasterize(setup_rows, *, width: int, height: int, binned: bool = True,
              slim: bool = False, has_uv1: bool = True,
              has_color: bool = True, analytic_derivs: bool = True):
    """One raster of row-major setup (T, NSETUP) f32 without a peel ->
    {name: (height, width)} (reference: rasterize). binned=True (the
    default, the reference's hardware route) is a fat K7 raster; the HUD
    pass takes it over a compacted overlay pool, where tri_id must come
    from S_ORIG_ID. binned=False takes the dense route K11a (the
    reference's interpret-mode route; the port's on-card oracle for K1,
    K7, K8 and K9), where slim=True returns only tri_id and depth."""
    if not binned:
        return _rasterize_dense(setup_rows, None, None, width=width,
                                height=height, slim=slim, has_uv1=has_uv1,
                                has_color=has_color,
                                analytic_derivs=analytic_derivs)
    if slim:
        raise ValueError("slim is the dense route's (binned=False); the "
                         "slim binned raster is rasterize16_slim")
    return rasterize_binned(setup_rows, width=width, height=height,
                            has_uv1=has_uv1, has_color=has_color,
                            analytic_derivs=analytic_derivs)


def rasterize_peel(setup_rows, zlo, zhi, *, width: int, height: int,
                   binned: bool = False, slim: bool = False,
                   has_uv1: bool = True, has_color: bool = True,
                   analytic_derivs: bool = True):
    """One dense depth peel K11b: the nearest fragment with zlo < z < zhi
    per pixel (reference: rasterize_peel(binned=False)); zlo/zhi (height,
    width) f32. The binned peel is rasterize_binned(setup_rows, zlo,
    zhi), which the frame's passes call; binned=True is refused."""
    if binned:
        raise ValueError("the binned peel is rasterize_binned(setup_rows, "
                         "zlo, zhi)")
    return _rasterize_dense(setup_rows, zlo, zhi, width=width, height=height,
                            slim=slim, has_uv1=has_uv1, has_color=has_color,
                            analytic_derivs=analytic_derivs)


# ---- K11a / K11b: the dense raster and the dense peel -------------------
#
# Every 8x128 tile tests every 128-triangle chunk's bbox and merges the
# chunks that overlap it in index order: no bins, no near-first order, no
# hi-Z. Its walk is its own code (not _merge_groups), so it checks the
# binned kernels' walks rather than repeating them.


def _dense_tiles(plane: torch.Tensor, n_ty: int, n_tx: int) -> torch.Tensor:
    """(H, W) -> (n_tiles, 1024) row-major 8x128 tile blocks."""
    return (plane.reshape(n_ty, TILE_H, n_tx, TILE_W).transpose(1, 2)
            .reshape(n_ty * n_tx, TILE_H * TILE_W))


def _dense_untile(tiles: torch.Tensor, n_ty: int, n_tx: int) -> torch.Tensor:
    """(n_tiles, 1024) 8x128 tile blocks -> (H, W)."""
    return (tiles.reshape(n_ty, n_tx, TILE_H, TILE_W).transpose(1, 2)
            .reshape(n_ty * TILE_H, n_tx * TILE_W))


# tiles merged at once by the twin: bounds its (tiles, 128, 1024)
# temporaries near 0.5 GiB each, for a chunk that spans a 3840x2160 frame
_DENSE_BATCH = 1024


def _dense_walk(setup_rows, width: int, height: int, zbounds=None):
    """The K11 merge for every 8x128 tile: each tile takes, over the chunks
    whose bbox overlaps it and within them the 8-triangle subgroups whose
    bbox does, the covering fragment of least z (0 <= z <= 1, zlo < z <
    zhi under a peel), the lowest triangle index on ties, and keeps it
    only if strictly nearer than what it holds (the reference's subgroup
    merge, here one chunk at a time). Returns (best_z, best_col (n_tiles,
    1024), px, py)."""
    dev = setup_rows.device
    n_chunks = setup_rows.shape[0] // CHUNK
    n_ty, n_tx = height // TILE_H, width // TILE_W
    n_tiles = n_ty * n_tx
    chunks = setup_rows.reshape(n_chunks, CHUNK, NSETUP)
    subs = chunks.reshape(n_chunks, CHUNK // SUB, SUB, NSETUP)
    sminx = subs[..., S_BB_MINX].amin(dim=2)       # (n_chunks, 16) each
    sminy = subs[..., S_BB_MINY].amin(dim=2)
    smaxx = subs[..., S_BB_MAXX].amax(dim=2)
    smaxy = subs[..., S_BB_MAXY].amax(dim=2)
    tx0 = torch.arange(n_tx, device=dev).float() * TILE_W
    ty0 = torch.arange(n_ty, device=dev).float() * TILE_H
    ox = (sminx.amin(dim=1)[None, :] < (tx0 + TILE_W)[:, None]) \
        & (smaxx.amax(dim=1)[None, :] > tx0[:, None])
    oy = (sminy.amin(dim=1)[None, :] < (ty0 + TILE_H)[:, None]) \
        & (smaxy.amax(dim=1)[None, :] > ty0[:, None])
    overlap = (oy[:, None, :] & ox[None, :, :]).reshape(n_tiles, n_chunks)
    # (chunk, tile) pairs in chunk order, one host read for the whole walk
    pairs = overlap.T.nonzero().cpu()
    splits = torch.bincount(pairs[:, 0], minlength=n_chunks).tolist()
    tiles_of = torch.split(pairs[:, 1], splits)

    flat = torch.arange(TILE_H * TILE_W, device=dev)
    t = torch.arange(n_tiles, device=dev)
    tx = ((t % n_tx) * TILE_W).float()
    ty = (torch.div(t, n_tx, rounding_mode="floor") * TILE_H).float()
    px = tx[:, None] + (flat % TILE_W).float() + 0.5
    py = ty[:, None] + torch.div(flat, TILE_W,
                                 rounding_mode="floor").float() + 0.5
    zb = None
    if zbounds is not None:
        zb = tuple(_dense_tiles(z, n_ty, n_tx) for z in zbounds)
    best_z = torch.ones((n_tiles, TILE_H * TILE_W), device=dev)
    best_col = torch.full((n_tiles, TILE_H * TILE_W), -1, dtype=torch.int32,
                          device=dev)
    lane = torch.arange(CHUNK, device=dev)[None, :, None]
    for c, tiles in enumerate(tiles_of):
        if tiles.numel() == 0:
            continue
        P = chunks[c].T[:, None, :, None]                 # (64, 1, 128, 1)
        for tl in tiles.to(dev).split(_DENSE_BATCH):
            x, y = px[tl][:, None, :], py[tl][:, None, :]  # (n, 1, 1024)
            # the subgroups whose bbox overlaps each tile, per triangle
            sx, sy = tx[tl][:, None], ty[tl][:, None]
            hit = ((sminx[c] < sx + TILE_W) & (smaxx[c] > sx)
                   & (sminy[c] < sy + TILE_H) & (smaxy[c] > sy))
            cover = hit.repeat_interleave(SUB, dim=1)[:, :, None]
            for ra in (S_E0A, S_E1A, S_E2A):
                a, b, cc = P[ra], P[ra + 1], P[ra + 2]
                e = a * x + (b * y + cc)
                top_left = (a > 0) | ((a == 0) & (b > 0))
                cover = cover & (e >= torch.where(top_left, 0.0, _FMIN))
            z = P[S_ZA] * x + (P[S_ZB] * y + P[S_ZC])     # (n, 128, 1024)
            cover = cover & (z >= 0.0) & (z <= 1.0)
            if zb is not None:
                cover = cover & (z > zb[0][tl][:, None, :]) \
                    & (z < zb[1][tl][:, None, :])
            zc = torch.where(cover, z, torch.full_like(z, _BIG))
            zmin = zc.amin(dim=1, keepdim=True)
            win = torch.where(zc == zmin, lane, CHUNK).amin(dim=1,
                                                            keepdim=True)
            zwin = zc.gather(1, win.clamp(max=CHUNK - 1))[:, 0]
            cur_z, cur_c = best_z[tl], best_col[tl]
            take = zwin < cur_z
            best_z[tl] = torch.where(take, zwin, cur_z)
            best_col[tl] = torch.where(take, (c * CHUNK + win[:, 0]).int(),
                                       cur_c)
    return best_z, best_col, px, py


def _dense_reference(setup_rows, zlo, zhi, *, width: int, height: int,
                     names):
    n_ty, n_tx = height // TILE_H, width // TILE_W
    zb = None if zlo is None else (zlo, zhi)
    best_z, best_col, px, py = _dense_walk(setup_rows, width, height, zb)
    if names == ("tri_id", "depth"):
        ids = setup_rows[:, S_ORIG_ID].index_select(
            0, best_col.reshape(-1).clamp(min=0).long()).to(torch.int32)
        tid = torch.where(best_col.reshape(-1) < 0, -1, ids)
        planes = {"tri_id": tid.reshape(best_z.shape), "depth": best_z}
    else:
        planes = _flush_planes(setup_rows, best_z, best_col, px, py, names)
    return {k: _dense_untile(v, n_ty, n_tx) for k, v in planes.items()}


def rasterize_dense_reference(setup_rows, *, width: int, height: int,
                              slim: bool = False, has_uv1: bool = True,
                              has_color: bool = True,
                              analytic_derivs: bool = True):
    """Plain PyTorch twin of K11a (bit-equal to the kernel). Works on any
    device."""
    return _dense_reference(setup_rows, None, None, width=width,
                            height=height, names=_dense_names(
                                slim, has_uv1, has_color, analytic_derivs))


def rasterize_peel_dense_reference(setup_rows, zlo, zhi, *, width: int,
                                   height: int, slim: bool = False,
                                   has_uv1: bool = True,
                                   has_color: bool = True,
                                   analytic_derivs: bool = True):
    """Plain PyTorch twin of K11b (bit-equal to the kernel). Works on any
    device."""
    return _dense_reference(setup_rows, zlo, zhi, width=width,
                            height=height, names=_dense_names(
                                slim, has_uv1, has_color, analytic_derivs))


def _dense_names(slim, has_uv1, has_color, analytic_derivs):
    if slim:
        return ("tri_id", "depth")
    return plane_layout(has_uv1, has_color, analytic_derivs)


def _rasterize_dense(setup_rows, zlo, zhi, *, width: int, height: int,
                     slim: bool, has_uv1: bool, has_color: bool,
                     analytic_derivs: bool):
    """K11a (zlo None) / K11b: the dense raster of row-major setup (T,
    NSETUP) f32, T a CHUNK multiple, width a TILE_W and height a TILE_H
    multiple (the reference asserts the same). tri_id is the winner's
    S_ORIG_ID (-1 on a miss), depth 1.0 where nothing wins; the fat
    planes are the winner's attributes at the pixel centre. A CUDA
    tensor launches csrc/dense.cu; a CPU tensor takes the plain twin."""
    if setup_rows.shape[0] % CHUNK:
        raise ValueError(f"setup rows {setup_rows.shape[0]} not a multiple "
                         f"of {CHUNK}")
    if width % TILE_W or height % TILE_H:
        raise ValueError(f"{width}x{height} is not a multiple of "
                         f"{TILE_W}x{TILE_H}")
    names = _dense_names(slim, has_uv1, has_color, analytic_derivs)
    if setup_rows.device.type == "cpu":
        return _dense_reference(setup_rows, zlo, zhi, width=width,
                                height=height, names=names)
    if setup_rows.dtype != torch.float32 or setup_rows.dim() != 2 \
            or setup_rows.shape[1] != NSETUP:
        raise ValueError(f"setup rows must be (T, {NSETUP}) f32")
    peel = zlo is not None
    P = width * height
    if peel:
        zlo, zhi = zlo.contiguous(), zhi.contiguous()
        if zlo.dtype != torch.float32 or zhi.dtype != torch.float32 \
                or zlo.numel() != P or zhi.numel() != P:
            raise ValueError(f"zlo/zhi must be f32 of {P} values")
    kernels.check_cuda(setup_rows, *((zlo, zhi) if peel else ()))
    dev = setup_rows.device
    n_chunks = setup_rows.shape[0] // CHUNK
    bbox = torch.empty((n_chunks, 4), dtype=torch.float32, device=dev)
    tid = torch.empty(P, dtype=torch.int32, device=dev)
    planes = torch.empty((len(names) - 1, P), dtype=torch.float32,
                         device=dev)
    flags = ((1 if "uv1_u" in names else 0) | (2 if "color_r" in names else 0)
             | (4 if "du0_dx" in names else 0) | (8 if slim else 0))
    kernels.launch("rasterize_peel_dense" if peel else "rasterize_dense",
                   "awsm_dense", setup_rows.data_ptr(), n_chunks,
                   bbox.data_ptr(), width, height,
                   zlo.data_ptr() if peel else None,
                   zhi.data_ptr() if peel else None, flags, tid.data_ptr(),
                   planes.data_ptr())
    out = {"tri_id": tid.reshape(height, width)}
    out.update((k, p.reshape(height, width)) for k, p in zip(names[1:],
                                                             planes))
    return out


def rasterize_layers(rows, opaque_depth, *, width: int, height: int,
                     n_layers: int, has_uv1: bool = True,
                     has_color: bool = True, analytic_derivs: bool = True):
    """Depth-peel K transparent layers front to back over the band
    (reference: rasterize_layers, binned route): bins built once, K K7
    peels with zlo chained to the previous layer's depth and zhi the
    opaque depth (shared, read-only), with the runtime peel skip. Returns
    {name: (K, height*width)}."""
    W32 = -(-width // BT_W) * BT_W
    H32 = -(-height // BT_H) * BT_H
    bins = build_bins(rows, width=W32, height=H32)
    zhi = opaque_depth.contiguous()

    def peel(zlo):
        return rasterize_binned(rows, zlo, zhi, width=width, height=height,
                                has_uv1=has_uv1, has_color=has_color,
                                analytic_derivs=analytic_derivs, bins=bins)

    zlo = torch.full((height, width), -1.0, device=rows.device)
    return _peel_layers(peel, zlo, n_layers)


# the reference's row-major entry transposes to its column-major setup;
# the port's setup is row-major throughout, so the two are one function
rasterize_layers_rows = rasterize_layers


def rasterize_layers_compact(rows, opaque_depth, *, width: int, height: int,
                             n_layers: int, tile_cap32: int,
                             has_uv1: bool = True, has_color: bool = True):
    """Covered-tile-compacted depth peel: K K8 peels over only the 32x32
    tiles the transparent triangles' bboxes touch (reference:
    rasterize_layers_compact). Per-triangle coverage comes from a
    difference grid (each live bbox's tile rectangle, +1/-1 at its
    corners, 2-D prefix sum); the tile list is covered first (a stable
    sort), cut to C = min(tile_cap32, n_tiles) (a host bound,
    renderer._bucket_tile_cap). The opaque depth compacts once; padding
    pixels get depth 0.0, so no fragment lands past the viewport.
    Analytic uv-derivative planes ride along.

    Returns (layers {name: (K, C*1024)} in compact 32x32 order, tile_idx
    (C,) int32 logical tile ids, n_tx)."""
    dev = rows.device
    W32 = -(-width // BT_W) * BT_W
    H32 = -(-height // BT_H) * BT_H
    n_ty, n_tx = H32 // BT_H, W32 // BT_W
    n_tiles = n_ty * n_tx
    C = min(tile_cap32, n_tiles)
    bins = build_bins(rows, width=W32, height=H32)

    minx, maxx = rows[:, S_BB_MINX], rows[:, S_BB_MAXX]
    miny, maxy = rows[:, S_BB_MINY], rows[:, S_BB_MAXY]
    live = ((minx <= maxx) & (maxx > 0.0) & (minx < W32)
            & (maxy > 0.0) & (miny < H32))
    w1 = live.to(torch.int32)

    def tile_of(v, lo_edge: bool, n: int, size: int):
        t = torch.floor(v / size) if lo_edge else torch.ceil(v / size) - 1
        return torch.nan_to_num(t).clamp(0, n - 1).long()

    txa, txb = tile_of(minx, True, n_tx, BT_W), tile_of(maxx, False, n_tx, BT_W)
    tya, tyb = tile_of(miny, True, n_ty, BT_H), tile_of(maxy, False, n_ty, BT_H)
    acc = torch.zeros((n_ty + 1) * (n_tx + 1), dtype=torch.int32, device=dev)
    stride = n_tx + 1
    for yi, xi, w in ((tya, txa, w1), (tya, txb + 1, -w1),
                      (tyb + 1, txa, -w1), (tyb + 1, txb + 1, w1)):
        acc.index_add_(0, yi * stride + xi, w)
    cov = (acc.reshape(n_ty + 1, n_tx + 1).cumsum(0).cumsum(1)[:-1, :-1]
           > 0).reshape(n_tiles)
    tile_idx = torch.argsort((~cov).to(torch.int32), stable=True)[:C]
    tile_idx = tile_idx.to(torch.int32)

    zhi_c = _pad_swizzle32(opaque_depth, H32, W32).index_select(
        0, tile_idx.long()).contiguous()

    def peel(zlo):
        return _rasterize_binned_compact(
            rows, zlo, zhi_c, bins=bins, tile_idx=tile_idx, n_tx=n_tx,
            has_uv1=has_uv1, has_color=has_color)

    zlo = torch.full((C, BT_H * BT_W), -1.0, device=dev)
    return _peel_layers(peel, zlo, n_layers), tile_idx, n_tx
