"""PyTorch port, K11a and K11b's walk as csrc/dense.cu runs it, done with
plain tensors on the CPU.

Per 8x128 tile (a CTA owns ROWS of its rows and makes the tile's skips)
the kernel scans the chunk bboxes one window of SCAN chunks at a time (one
chunk a thread: SCAN is the CTA's width, ROWS * 128 / PX threads; PX and
ROWS read from csrc/dense.cu). A thread whose chunk overlaps the
tile tests the chunk's sixteen 8-triangle subgroup bboxes, built once a call
by the pre-pass, and a prefix sum lists the window's overlapping subgroups
in index order. Every pixel then walks the listed subgroups' triangles in
list order, strict < on z. The flush writes the zero planes of a thread's
PX pixels at once where they all miss. Done here with plain tensors and the
twins' flush, the walk must be bit-equal to rasterize_dense_reference and
rasterize_peel_dense_reference on planted cases: more chunks than three
windows; a tile that no chunk overlaps; exact z ties between triangles of
different chunks, subgroups and windows (the lowest index must win); slivers
that cover a centre just outside their bbox, and triangles whose bbox ends
at a tile border while their edges cover centres beyond it, which the
reference skips there at the chunk's or the subgroup's grain; peel bounds;
slim and fat planes.

A mutation of the model that lists each window's subgroups out of index
order (reversed) fails the tie case: test_out_of_order_list_breaks_ties
holds it so."""

import functools
import os
import re

import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (torch's threads: each worker's share)

from awsm_renderer_tpu_torch.ops import kernels
from awsm_renderer_tpu_torch.ops import raster as TR
from awsm_renderer_tpu_torch.ops.vertex import NSETUP, S_ORIG_ID

with open(os.path.join(kernels.CSRC, "dense.cu")) as _f:
    _SRC = _f.read()
PX, ROWS = (int(re.search(rf"constexpr int {k} = (\d+);", _SRC).group(1))
            for k in ("PX", "ROWS"))
assert re.search(r"constexpr int SCAN = THREADS;", _SRC)
SCAN = ROWS * 128 // PX                   # chunks a window, one a thread
NSUB = TR.CHUNK // TR.SUB
W, H = 256, 64                            # 2 x 8 tiles of 8x128
N_CHUNKS = 3 * SCAN + 3                   # four windows


def setup_rows(xy, z, valid=None, seed=0):
    """Row-major setup (T, NSETUP) f32 of triangles xy (T, 3, 2) (positively
    oriented), z (T, 3): edge functions a*px + (b*py + c), the affine z
    plane, the exact bbox; random iw and attributes; S_ORIG_ID the row.
    valid False: an invalid triangle (empty bbox, edge constant -3e38)."""
    xy = np.asarray(xy, np.float32)
    z = np.asarray(z, np.float32)
    T = xy.shape[0]
    sx, sy = xy[..., 0], xy[..., 1]
    ea = [sy[:, 1] - sy[:, 2], sy[:, 2] - sy[:, 0], sy[:, 0] - sy[:, 1]]
    eb = [sx[:, 2] - sx[:, 1], sx[:, 0] - sx[:, 2], sx[:, 1] - sx[:, 0]]
    ec = [sx[:, 1] * sy[:, 2] - sx[:, 2] * sy[:, 1],
          sx[:, 2] * sy[:, 0] - sx[:, 0] * sy[:, 2],
          sx[:, 0] * sy[:, 1] - sx[:, 1] * sy[:, 0]]
    area2 = (sx[:, 1] - sx[:, 0]) * (sy[:, 2] - sy[:, 0]) \
        - (sx[:, 2] - sx[:, 0]) * (sy[:, 1] - sy[:, 0])
    valid = np.ones(T, bool) if valid is None else np.asarray(valid)
    assert (area2[valid] > 0).all(), "triangles must be positively oriented"
    inv = np.float32(1.0) / np.where(valid, area2, np.float32(1.0))
    rng = np.random.default_rng(seed)
    rows = rng.standard_normal((T, NSETUP)).astype(np.float32)
    for e in range(3):
        rows[:, 3 * e], rows[:, 3 * e + 1], rows[:, 3 * e + 2] = \
            ea[e], eb[e], ec[e]
    for r, coef in ((9, ea), (10, eb), (11, ec)):
        rows[:, r] = (z[:, 0] * coef[0] + z[:, 1] * coef[1]
                      + z[:, 2] * coef[2]) * inv
    rows[:, 12:15] = rng.uniform(0.5, 2.0, (T, 3))
    rows[:, 15], rows[:, 16] = sx.min(1), sy.min(1)
    rows[:, 17], rows[:, 18] = sx.max(1), sy.max(1)
    rows[~valid, 2] = -3.0e38
    rows[~valid, 15:17] = 3.0e38
    rows[~valid, 17:19] = -3.0e38
    rows[:, S_ORIG_ID] = np.arange(T, dtype=np.float32)
    return rows


def random_tris(seed, n, x0, y0, x1, y1, size=None):
    """n positively oriented triangles inside [x0, x1) x [y0, y1) (within
    `size` pixels of a random centre where given), z in [0.1, 0.9]."""
    rng = np.random.default_rng(seed)
    if size is None:
        xy = rng.uniform([x0, y0], [x1, y1], (n, 3, 2))
    else:
        c = rng.uniform([x0, y0], [x1, y1], (n, 1, 2))
        xy = np.clip(c + rng.uniform(-size, size, (n, 3, 2)), [x0, y0],
                     [x1, y1])
    xy = xy.astype(np.float32)
    a = (xy[:, 1, 0] - xy[:, 0, 0]) * (xy[:, 2, 1] - xy[:, 0, 1]) \
        - (xy[:, 2, 0] - xy[:, 0, 0]) * (xy[:, 1, 1] - xy[:, 0, 1])
    xy = xy[np.abs(a) >= 1.0]
    a = a[np.abs(a) >= 1.0]
    xy[a < 0] = xy[a < 0][:, [0, 2, 1]]
    z = rng.uniform(0.1, 0.9, (xy.shape[0], 3)).astype(np.float32)
    return xy, z


def _up(v, k=1):
    """v moved k float32 ulps up."""
    x = np.float32(v)
    for _ in range(k):
        x = np.nextafter(x, np.float32(1e9))
    return float(x)


def _flat(rows, r, z):
    """Give row r the z plane 0*px + (0*py + z)."""
    rows[r, 9:11] = 0.0
    rows[r, 11] = z


def _frame(n_chunks, placed):
    """(n_chunks * 128, NSETUP) setup of invalid triangles with `placed`
    {first row: (xy, z)} written at those rows; S_ORIG_ID the row."""
    xy = np.tile(np.float32([[0, 0], [1, 0], [0, 1]]),
                 (n_chunks * TR.CHUNK, 1, 1))
    z = np.full((n_chunks * TR.CHUNK, 3), 0.5, np.float32)
    valid = np.zeros(n_chunks * TR.CHUNK, bool)
    for r, (txy, tz) in placed.items():
        xy[r:r + len(txy)], z[r:r + len(txy)] = txy, tz
        valid[r:r + len(txy)] = True
    return setup_rows(xy, z, valid, seed=len(placed))


TIE = np.float32([[[20.0, 3.0], [200.0, 6.0], [60.0, 28.0]]])


def planted(case):
    """(rows, notes): a planted case over W x H."""
    notes = {}
    if case == "windows":
        # live chunks in every window, at window borders; random
        # triangles spread over the frame, each chunk over part of it
        placed = {}
        for i, c in enumerate((0, SCAN - 1, SCAN, 2 * SCAN + 1, 3 * SCAN,
                               N_CHUNKS - 1)):
            xy, z = random_tris(10 + i, 128, 0, 0, W, H, size=30.0)
            placed[c * TR.CHUNK] = (xy[:TR.CHUNK], z[:TR.CHUNK])
        rows = _frame(N_CHUNKS, placed)
    elif case == "empty_tile":
        # every chunk left of x = 128 or in the top tile row: the tiles
        # right of x = 128 below y = 8 list no chunk
        placed = {}
        for i, c in enumerate((2, SCAN + 5, 2 * SCAN + 7)):
            xy, z = random_tris(20 + i, 128, 0, 0, 128, H, size=20.0)
            placed[c * TR.CHUNK] = (xy[:TR.CHUNK], z[:TR.CHUNK])
        xy, z = random_tris(30, 40, 128, 0, W, 8, size=10.0)
        placed[5 * TR.CHUNK] = (xy, z)
        rows = _frame(N_CHUNKS, placed)
        notes["empty"] = (slice(8, H), slice(128, W))
    elif case == "ties":
        # the flat TIE triangle at z 0.3: rows 3*128 + 40 (subgroup 5 of
        # chunk 3), 3*128 + 17 (subgroup 2: the lowest index, must win),
        # 3*128 + 18 (the same subgroup), 9*128 + 0 (another chunk of the
        # window) and (SCAN + 1)*128 + 64 (the next window); random
        # triangles behind them (z 0.4-0.9) in chunks 1 and SCAN + 2
        copies = [3 * 128 + 40, 3 * 128 + 17, 3 * 128 + 18, 9 * 128,
                  (SCAN + 1) * 128 + 64]
        placed = {r: (TIE, np.full((1, 3), 0.3, np.float32))
                  for r in copies}
        for i, c in enumerate((1, SCAN + 2)):
            xy, z = random_tris(40 + i, 128, 0, 0, W, H, size=40.0)
            placed[c * TR.CHUNK] = (xy[:TR.CHUNK],
                                    0.4 + 0.5 * z[:TR.CHUNK] / 0.9)
        rows = _frame(N_CHUNKS, placed)
        for r in copies:
            _flat(rows, r, 0.3)
        notes["tie"] = (3 * 128 + 17, copies)
    elif case == "slivers":
        # rounded: a vertex an ulp right of / below a pixel centre whose
        # rounded edge test still covers that centre (outside the bbox);
        # planted: a triangle whose bbox (moved by hand) ends at y = 8.0
        # (chunk 6: the chunk's bbox misses tile row 1 too) and one that
        # ends at x = 128.0 (row 7*128 + 8, alone in its subgroup: the
        # subgroup misses tile column 1, its chunk does not), though both
        # cover pixels beyond
        thin = np.float32([
            [[_up(15.5), 40.5], [100.7, 30.2], [99.3, 60.9]],
            [[70.5, _up(31.5)], [80.52584339708278, 63.08943191334834],
             [46.734101535338056, 52.81869099462787]],
            [[102.5, _up(7.5, 5)], [2.115537347651724, 57.18436373080994],
             [34.5326993617754, 28.995533623671108]]])
        big, bz = random_tris(50, 128, 128, 0, W, H, size=30.0)
        placed = {0: (thin, np.full((3, 3), 0.5, np.float32)),
                  6 * TR.CHUNK: (np.float32([[[140.0, 2.0], [250.0, 2.0],
                                              [190.0, 30.0]]]),
                                 np.full((1, 3), 0.05, np.float32)),
                  7 * TR.CHUNK: (big[:8], bz[:8]),
                  7 * TR.CHUNK + 8: (np.float32([[[110.0, 44.0],
                                                  [200.0, 46.0],
                                                  [115.0, 60.0]]]),
                                     np.full((1, 3), 0.05, np.float32)),
                  7 * TR.CHUNK + 16: (big[8:120], bz[8:120])}
        rows = _frame(N_CHUNKS, placed)
        rows[6 * TR.CHUNK, 18] = 8.0
        rows[7 * TR.CHUNK + 8, 17] = 128.0
        notes["skipped"] = ((6 * TR.CHUNK, slice(8, H), slice(0, W)),
                            (7 * TR.CHUNK + 8, slice(0, H),
                             slice(128, W)))
    else:
        raise ValueError(case)
    return rows, notes


def peel_bounds(seed):
    """zlo, zhi (H, W): random, and equal to a flat z of the rows
    (0.3, 0.05, 0.5) at some pixels."""
    rng = np.random.default_rng(seed)
    zlo = rng.choice(np.float32([0.0, 0.05, 0.3, 0.2, -0.1]), (H, W))
    zhi = rng.choice(np.float32([0.3, 0.5, 0.9, 1.5, 0.6]), (H, W))
    return torch.as_tensor(zlo), torch.as_tensor(zhi)


def _overlaps(b, tx0, ty0):
    return ((b[..., 0] < tx0 + TR.TILE_W) & (b[..., 2] > tx0)
            & (b[..., 1] < ty0 + TR.TILE_H) & (b[..., 3] > ty0))


def dense_list_walk(rows, width, height, zb=None, reverse=False,
                    skip=True):
    """dense.cu's walk of every 8x128 tile: (best_z, best_col (n_tiles,
    1024), px, py, the listed subgroups a window (list of (n_tiles,)
    counts)). reverse lists each window's subgroups backwards (a
    mutation); skip=False walks every subgroup that holds a valid
    triangle, in every tile (no tile skips: not the reference)."""
    rows = torch.as_tensor(rows)
    n_chunks = rows.shape[0] // TR.CHUNK
    n_ty, n_tx = height // TR.TILE_H, width // TR.TILE_W
    n_tiles = n_ty * n_tx
    # the pre-pass: subgroup bboxes, and the chunks' from them (exact)
    g = rows.reshape(n_chunks, NSUB, TR.SUB, NSETUP)
    sb = torch.stack([g[..., 15].amin(2), g[..., 16].amin(2),
                      g[..., 17].amax(2), g[..., 18].amax(2)], -1)
    cb = torch.stack([sb[..., 0].amin(1), sb[..., 1].amin(1),
                      sb[..., 2].amax(1), sb[..., 3].amax(1)], -1)
    t = torch.arange(n_tiles)
    tx0 = (t % n_tx * TR.TILE_W).float()
    ty0 = (t // n_tx * TR.TILE_H).float()
    flat = torch.arange(TR.TILE_H * TR.TILE_W)
    px = tx0[:, None] + (flat % TR.TILE_W).float() + 0.5
    py = ty0[:, None] + (flat // TR.TILE_W).float() + 0.5
    zt = None if zb is None else tuple(TR._dense_tiles(v, n_ty, n_tx)
                                       for v in zb)
    best_z = torch.ones((n_tiles, 1024))
    best_col = torch.full((n_tiles, 1024), -1, dtype=torch.int32)
    counts = []
    for base in range(0, n_chunks, SCAN):
        c = torch.arange(base, min(base + SCAN, n_chunks))
        hit = _overlaps(cb[c][None], tx0[:, None], ty0[:, None])
        m = hit[..., None] & _overlaps(sb[c][None], tx0[:, None, None],
                                       ty0[:, None, None])
        if not skip:
            m = (sb[c][..., 0] <= sb[c][..., 2])[None].expand_as(m)
        m = m.reshape(n_tiles, -1)          # local ids t * NSUB + g
        n = m.sum(1)
        counts.append(n)
        L = int(n.max())
        if L == 0:
            continue
        # the list: each tile's set local ids in ascending order
        ids = torch.argsort((~m).to(torch.int8), dim=1, stable=True)[:, :L]
        pos = torch.arange(L)[None]
        if reverse:
            ids = ids.gather(1, (n[:, None] - 1 - pos).clamp(min=0))
        live = pos < n[:, None]
        for p in range(L):
            s = ids[:, p]
            for j in range(TR.SUB):
                k = (base + s // NSUB) * TR.CHUNK + s % NSUB * TR.SUB + j
                r = rows[k]                                  # (n_tiles, 64)
                cover = live[:, p:p + 1]
                for e in range(3):
                    a, b, cc = (r[:, 3 * e + i:3 * e + i + 1]
                                for i in range(3))
                    thr = torch.where((a > 0) | ((a == 0) & (b > 0)), 0.0,
                                      TR._FMIN)
                    cover = cover & (a * px + (b * py + cc) >= thr)
                z = r[:, 9:10] * px + (r[:, 10:11] * py + r[:, 11:12])
                # z < best <= 1 implies the twin's z <= 1
                take = cover & (z >= 0.0) & (z < best_z)
                if zt is not None:
                    take = take & (z > zt[0]) & (z < zt[1])
                best_z = torch.where(take, z, best_z)
                best_col = torch.where(take, k.int()[:, None], best_col)
    return best_z, best_col, px, py, counts


def dense_model(rows, zlo, zhi, *, width, height, names, **kw):
    """K11a / K11b by the model: the walk, then the flush (the PX pixels of
    a thread that all miss take the zero planes at once)."""
    rows = torch.as_tensor(rows)
    zb = None if zlo is None else (zlo, zhi)
    z, col, px, py, counts = dense_list_walk(rows, width, height, zb, **kw)
    if names == ("tri_id", "depth"):
        ids = rows[:, S_ORIG_ID][col.clamp(min=0).long()].to(torch.int32)
        planes = {"tri_id": torch.where(col < 0, -1, ids), "depth": z}
    else:
        planes = TR._flush_planes(rows, z, col, px, py, names)
        group_miss = (col.reshape(col.shape[0], -1, PX) < 0).all(2)
        zero = group_miss.repeat_interleave(PX, dim=1)
        for k in names[2:]:
            planes[k] = torch.where(zero, 0.0, planes[k])
    n_ty, n_tx = height // TR.TILE_H, width // TR.TILE_W
    got = {k: TR._dense_untile(v, n_ty, n_tx) for k, v in planes.items()}
    return got, counts


def _assert_bit_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        a, b = got[k].contiguous(), want[k].contiguous()
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), k


CASES = ("windows", "empty_tile", "ties", "slivers")
MODES = {"fat": (False, False), "slim": (True, False),
         "peel-fat": (False, True), "peel-slim": (True, True)}


@functools.lru_cache(maxsize=None)
def case_inputs(case, mode):
    """(rows, zlo, zhi, names, notes) of a planted case in a mode."""
    slim, peel = MODES[mode]
    rows, notes = planted(case)
    zlo = zhi = None
    if peel:
        zlo, zhi = peel_bounds(CASES.index(case))
    names = TR._dense_names(slim, True, True, True)
    return rows, zlo, zhi, names, notes


def reference(rows, zlo, zhi, names):
    t = torch.as_tensor(rows)
    slim = names == ("tri_id", "depth")
    if zlo is None:
        return TR.rasterize_dense_reference(t, width=W, height=H, slim=slim)
    return TR.rasterize_peel_dense_reference(t, zlo, zhi, width=W, height=H,
                                             slim=slim)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("case", CASES)
def test_list_walk_bit_equal_on_planted_cases(case, mode):
    rows, zlo, zhi, names, notes = case_inputs(case, mode)
    got, counts = dense_model(rows, zlo, zhi, width=W, height=H,
                              names=names)
    want = reference(rows, zlo, zhi, names)
    _assert_bit_equal(got, want)
    tid = want["tri_id"]
    assert int((tid >= 0).sum()) > 0, "nothing covered"
    assert len(counts) == -(-(rows.shape[0] // TR.CHUNK) // SCAN) >= 4
    if case == "windows":
        # the compaction lists subgroups in at least three windows
        assert sum(int(n.max()) > 0 for n in counts) >= 3
    if case == "empty_tile":
        ys, xs = notes["empty"]
        assert bool((tid[ys, xs] < 0).all())
        assert sum(int(n.view(H // 8, W // 128)[1:, 1].sum())
                   for n in counts) == 0
    if case == "ties" and zlo is None:
        first, copies = notes["tie"]
        ids = set(torch.unique(tid).tolist())
        assert first in ids and not ids & (set(copies) - {first})
    if case == "slivers":
        assert set(torch.unique(tid[tid >= 0]).tolist()) >= {0, 1, 2}
        for row, ys, xs in notes["skipped"]:
            assert not bool((tid[ys, xs] == row).any())


def test_slivers_cover_centres_the_reference_skips():
    """The planted slivers' rounded or moved bboxes matter: a walk without
    skips differs from the reference exactly there; the rounded slivers
    cover a centre outside their own bbox."""
    rows, zlo, zhi, names, notes = case_inputs("slivers", "slim")
    noskip, _ = dense_model(rows, zlo, zhi, width=W, height=H, names=names,
                            skip=False)
    for row, ys, xs in notes["skipped"]:
        assert bool((noskip["tri_id"][ys, xs] == row).any())
    r = torch.as_tensor(rows)
    tid = reference(rows, zlo, zhi, names)["tri_id"]
    yy, xx = torch.meshgrid(torch.arange(H).float() + 0.5,
                            torch.arange(W).float() + 0.5, indexing="ij")
    outside = 0
    for k in (0, 1, 2):
        on = tid == k
        outside += int((on & ((xx < r[k, 15]) | (xx > r[k, 17])
                              | (yy < r[k, 16]) | (yy > r[k, 18]))).sum())
    assert outside > 0, "no centre covered outside its bbox"


def test_out_of_order_list_breaks_ties():
    """The mutation: each window's list compacted in reverse index order.
    It keeps a higher-index copy of the tie triangle, so the model then
    differs from the reference: the tie case can tell the order."""
    rows, zlo, zhi, names, notes = case_inputs("ties", "slim")
    got, _ = dense_model(rows, zlo, zhi, width=W, height=H, names=names,
                         reverse=True)
    want = reference(rows, zlo, zhi, names)
    assert not torch.equal(got["tri_id"], want["tri_id"])
    first, _copies = notes["tie"]
    assert not bool((got["tri_id"] == first).any())
