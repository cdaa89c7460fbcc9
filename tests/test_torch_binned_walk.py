"""PyTorch port, K7 and K8's walk as csrc/binned.cu runs it, done with the
plain walk on the CPU.

Each warp of the kernel owns a 16 x BH block of a 32x32 tile (BH = 2 PX
rows, PX read from csrc/binned.cu). When a tile merges a chunk (hi-Z at
the tile's grain, as in the twin: some pixel's depth must exceed the
chunk's z-min), a warp tests only the chunk's triangles whose bbox,
widened by one pixel, reaches its block, in index order; the winners are
then flushed. Done here with plain tensors and the twins' flush, it must
be bit-equal to rasterize_binned_reference (K7, peel or not) and
rasterize_binned_compact_reference (K8), which test every triangle of
every merged chunk, on tests/test_torch_binned.py's fixtures and on
planted cases: exact z ties inside and across chunks and across warp
blocks, a chunk z-min equal to the tile's worst depth, peel bounds equal
to z, -0.0 against +0.0, z = 1.0, slivers on block borders and triangles
whose rounded edge test covers a centre just outside their bbox, bboxes
that reach a block only by the widening, K8's padding tiles (zhi = 0),
and tiles whose every listed chunk the cull leaves to no warp. On the way
it asserts that no covered pixel centre lies outside a warp block the
cull names."""

import os
import re

import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (torch's threads: each worker's share)
from test_raster import make_setup
from test_torch_binned import _setup, _tris
from test_torch_raster import _warp_masks

from awsm_renderer_tpu_torch.ops import kernels
from awsm_renderer_tpu_torch.ops import raster as TR
from awsm_renderer_tpu_torch.ops.vertex import S_ORIG_ID

with open(os.path.join(kernels.CSRC, "binned.cu")) as _f:
    PX = int(re.search(r"constexpr int PX = (\d+);", _f.read()).group(1))
BH = 2 * PX            # rows of a warp's 16-pixel-wide block
W, H = 128, 64
DEAD = {"xy": [[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]]}


def binned_cull_walk(rows, bins, tiles, n_tx, zb=None, block_rows=BH):
    """binned.cu's walk of logical tiles `tiles` (n,): (best_z, best_col
    (n, 1024), px, py, the pixels covered outside their exact bbox)."""
    bin_idx, counts, B, zmin = bins
    chunks = rows.reshape(-1, TR.CHUNK, rows.shape[1])
    px, py = TR._tile_pixels(tiles, n_tx)
    n = tiles.numel()
    flat = torch.arange(1024)
    block = ((flat // 32) // block_rows) * 2 + (flat % 32) // 16
    best_z = torch.ones((n, 1024))
    best_col = torch.full((n, 1024), -1, dtype=torch.int32)
    cnt = counts.long()[tiles]
    outside = 0
    for b in range(int(cnt.max()) if n else 0):
        live = b < cnt
        c = bin_idx.long()[(tiles * B + b).clamp(max=bin_idx.numel() - 1)]
        c = torch.where(live, c, 0)
        live = live & (zmin[c] < best_z.amax(dim=1))
        P = chunks[c]                                   # (n, 128, 64)
        masks = _warp_masks(P, tiles[:, None], n_tx, rows=block_rows)
        for k in range(TR.CHUNK):
            r = P[:, k]
            cover = live[:, None]
            for ra in (0, 3, 6):
                a, bb, cc = (r[:, ra + i:ra + i + 1] for i in range(3))
                tl = (a > 0) | ((a == 0) & (bb > 0))
                cover = cover & (a * px + (bb * py + cc)
                                 >= torch.where(tl, 0.0, TR._FMIN))
            named = ((masks[:, k:k + 1] >> block) & 1) == 1
            assert not (cover & ~named).any(), \
                "the cull skips a covered pixel"
            outside += int((cover & ((px < r[:, 15:16]) | (px > r[:, 17:18])
                                     | (py < r[:, 16:17])
                                     | (py > r[:, 18:19]))).sum())
            z = r[:, 9:10] * px + (r[:, 10:11] * py + r[:, 11:12])
            # z < best <= 1 implies the twin's z <= 1
            take = cover & named & (z >= 0.0) & (z < best_z)
            if zb is not None:
                take = take & (z > zb[0]) & (z < zb[1])
            best_z = torch.where(take, z, best_z)
            best_col = torch.where(take, (c * TR.CHUNK + k).int()[:, None],
                                   best_col)
    return best_z, best_col, px, py, outside


def k7_model(rows, zlo, zhi, *, width, height, names):
    """K7 (rasterize_binned) by the model: (planes, outside)."""
    rows = torch.as_tensor(rows)
    W32, H32 = -(-width // 32) * 32, -(-height // 32) * 32
    bins = TR.build_bins(rows, width=W32, height=H32)
    n_tx = W32 // 32
    zb = None
    if zlo is not None:
        zb = (TR._pad_swizzle32(zlo, H32, W32),
              TR._pad_swizzle32(zhi, H32, W32))
    z, col, px, py, outside = binned_cull_walk(
        rows, bins, torch.arange((H32 // 32) * n_tx), n_tx, zb)
    planes = TR._flush_planes(rows, z, col, px, py, names)
    got = {k: TR._deswizzle32(v, H32, W32)[:height, :width]
           for k, v in planes.items()}
    want = TR.rasterize_binned_reference(rows, zlo, zhi, bins=bins,
                                         width=width, height=height,
                                         names=names)
    return got, want, outside


def k8_model(rows, zlo_c, zhi_c, *, tile_idx, n_tx, width, height, names):
    rows = torch.as_tensor(rows)
    bins = TR.build_bins(rows, width=width, height=height)
    z, col, px, py, outside = binned_cull_walk(
        rows, bins, tile_idx.long(), n_tx, (zlo_c, zhi_c))
    got = TR._flush_planes(rows, z, col, px, py, names)
    want = TR.rasterize_binned_compact_reference(
        rows, zlo_c, zhi_c, bins=bins, tile_idx=tile_idx, n_tx=n_tx,
        names=names)
    return got, want, outside


def _assert_bit_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        a, b = got[k].contiguous(), want[k].contiguous()
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), k


# ---- planted cases ----------------------------------------------------------

def _quad(z=0.5):
    """Two triangles covering the whole W x H frame."""
    return [{"xy": [[0.0, 0.0], [W, 0.0], [0.0, H]], "z": [z] * 3},
            {"xy": [[W, 0.0], [W, H], [0.0, H]], "z": [z] * 3}]


def _chunks(*chunk_tris, flat=None, seed=3):
    """Row-major setup: chunk i holds chunk_tris[i] first, invalid
    triangles after; random attributes; flat: {row: z} gives row the z
    plane 0*px + (0*py + z) (z's sign kept)."""
    tris, valid = [], []
    for ct in chunk_tris:
        tris += list(ct) + [DEAD] * (TR.CHUNK - len(ct))
        valid += [True] * len(ct) + [False] * (TR.CHUNK - len(ct))
    rows = np.asarray(make_setup(tris, valid)).T.copy()
    rng = np.random.default_rng(seed)
    rows[:, 21:S_ORIG_ID] = rng.standard_normal(
        (rows.shape[0], S_ORIG_ID - 21)).astype(np.float32)
    for r, z in (flat or {}).items():
        rows[r, 9:11] = np.copysign(np.float32(0.0), np.float32(z))
        rows[r, 11] = z
    return rows


def _up(v, k=1):
    """v moved k float32 ulps up."""
    x = np.float32(v)
    for _ in range(k):
        x = np.nextafter(x, np.float32(1e9))
    return float(x)


def planted(case):
    """(rows, zlo, zhi): a planted K7 case over W x H (zlo/zhi None
    without a peel)."""
    zlo = zhi = None
    if case == "ties":
        # exact ties across warp blocks, inside a chunk (rows 128 / 130
        # and 129 / 131: the lower index wins) and across chunks: chunk 1
        # also holds a small near triangle (row 132), so its z-min ranks
        # first and it wins the tie with chunk 0 (hi-Z then skips chunk 0)
        near = {"xy": [[1.0, 1.0], [3.0, 1.0], [1.0, 3.0]], "z": [0.1] * 3}
        rows = _chunks(_quad(), _quad() + _quad() + [near],
                       flat={0: 0.5, 1: 0.5, 128: 0.5, 129: 0.5, 130: 0.5,
                             131: 0.5})
    elif case == "zmin_at_worst_depth":
        # chunk 0 sets every pixel left of x = 112 to 0.5; chunks 1 and 2
        # have z-min 0.5 exactly: hi-Z skips chunk 1 (inside x < 96) in
        # every tile it is listed in, and merges chunk 2 (to x = 125) in
        # the tiles that keep pixels at 1.0, where it wins beyond x = 112
        left = [{"xy": [[0.0, 0.0], [112.0, 0.0], [0.0, H]]},
                {"xy": [[112.0, 0.0], [112.0, H], [0.0, H]]}]
        rows = _chunks(left, [{"xy": [[2.0, 2.0], [90.0, 2.0],
                                      [2.0, 60.0]]}],
                       [{"xy": [[2.0, 3.0], [125.0, 3.0], [2.0, 61.0]]}],
                       flat={0: 0.5, 1: 0.5, 128: 0.5, 256: 0.5})
    elif case == "peel_bounds_at_z":
        rows = _chunks(_quad(0.5), _quad(0.25),
                       flat={0: 0.5, 1: 0.5, 128: 0.25, 129: 0.25})
        rng = np.random.default_rng(7)
        zlo = rng.choice(np.float32([0.25, 0.5, 0.1, 0.3]), (H, W))
        zhi = rng.choice(np.float32([0.5, 0.25, 0.9, 0.3]), (H, W))
    elif case == "neg_zero":
        # rows 0 (-0.0) and 1 (+0.0) tie in chunk 0, rows 128 (+0.0) and
        # 129 (-0.0) in chunk 1, overlapping chunk 0 across the middle
        a = {"xy": [[0.0, 0.0], [90.0, 0.0], [0.0, H]]}
        b = {"xy": [[30.0, 0.0], [W, 0.0], [W, H]]}
        rows = _chunks([a, a], [b, b],
                       flat={0: -0.0, 1: 0.0, 128: 0.0, 129: -0.0})
    elif case == "z_one":
        small = {"xy": [[10.0, 10.0], [40.0, 10.0], [10.0, 40.0]],
                 "z": [0.5] * 3}
        rows = _chunks(_quad(1.0) + [small], flat={0: 1.0, 1: 1.0})
    elif case == "slivers":
        # exact: a left edge at x = 15.5 and x = 16.5 (the last / first
        # centre column of a block), top edges at a block row border;
        # rounded: a vertex an ulp right of / below a pixel centre whose
        # rounded edge test still covers that centre (outside the bbox)
        tris = [{"xy": [[15.5, 2.0], [15.9, 2.0], [15.5, 30.0]]},
                {"xy": [[16.5, 34.0], [16.9, 34.0], [16.5, 60.0]]},
                {"xy": [[40.0, BH - 0.5], [70.0, BH - 0.5],
                        [40.0, BH - 0.1]]},
                {"xy": [[72.0, BH + 0.5], [100.0, BH + 0.5],
                        [72.0, BH + 0.9]]},
                {"xy": [[_up(15.5), 40.5], [100.7, 30.2], [99.3, 60.9]]},
                {"xy": [[70.5, _up(31.5)], [80.52584339708278,
                                             63.08943191334834],
                        [46.734101535338056, 52.81869099462787]]},
                {"xy": [[102.5, _up(7.5, 5)], [2.115537347651724,
                                                57.18436373080994],
                        [34.5326993617754, 28.995533623671108]]}]
        rows = _chunks(tris)
    elif case == "touching":
        # bboxes that reach a neighbouring block only by the widening:
        # max x = 15.5 (block column 1's first centre is 16.5), min y
        # one pixel below a block row's last centre
        tris = [{"xy": [[4.0, 4.0], [15.5, 4.0], [4.0, 20.0]]},
                {"xy": [[40.0, BH + 0.5], [60.0, BH + 0.5],
                        [40.0, 20.0]]},
                {"xy": [[80.0, 40.0], [111.5, 40.0], [80.0, 55.5]]}]
        rows = _chunks(tris)
    elif case == "all_culled":
        # one chunk, two small triangles in opposite corners: the chunk's
        # bbox lists it in the middle tiles, where no warp keeps either
        tris = [{"xy": [[2.0, 2.0], [6.0, 2.0], [2.0, 6.0]]},
                {"xy": [[W - 6.0, H - 6.0], [W - 2.0, H - 6.0],
                        [W - 2.0, H - 2.0]]}]
        rows = _chunks(tris)
    else:
        raise ValueError(case)
    if zlo is not None:
        zlo, zhi = torch.as_tensor(zlo), torch.as_tensor(zhi)
    return rows, zlo, zhi


PLANTED = ("ties", "zmin_at_worst_depth", "peel_bounds_at_z", "neg_zero",
           "z_one", "slivers", "touching", "all_culled")
NAMES = TR.plane_layout(True, True, True)


@pytest.mark.parametrize("case", PLANTED)
def test_k7_cull_walk_bit_equal_on_planted_cases(case):
    rows, zlo, zhi = planted(case)
    got, want, outside = k7_model(rows, zlo, zhi, width=W, height=H,
                                  names=NAMES)
    _assert_bit_equal(got, want)
    tid, depth = want["tri_id"], want["depth"]
    assert int((tid >= 0).sum()) > 0, "nothing covered"
    if case == "ties":
        assert set(torch.unique(tid[tid != 132]).tolist()) == {128, 129}
    if case == "zmin_at_worst_depth":
        assert set(torch.unique(tid[:, :96]).tolist()) == {0, 1}
        assert bool((tid[:, 112:] == 256).any())
    if case == "neg_zero":
        bits = depth.view(torch.int32)
        assert int((bits == -2 ** 31).sum()) > 0 and int((bits == 0).sum()) > 0
    if case == "z_one":
        assert bool((depth[tid >= 0] < 1.0).all()) and (tid < 0).any()
    if case == "slivers":
        assert outside > 0, "no centre covered outside its bbox"
        assert set(torch.unique(tid[tid >= 0]).tolist()) >= {0, 1, 4, 5, 6}
    if case == "all_culled":
        assert bool((tid[:, 32:96] < 0).all())


def planted_compact(case):
    """(rows, zlo_c, zhi_c, tile_idx): a planted case as K8 sees it: every
    tile, tile 5 twice and two padding tiles (blocks 8 and 9, zhi = 0:
    nothing is admitted); a case without peel bounds gets zlo in [-0.5,
    -0.2) (so -0.0 and +0.0 pass) and zhi 0.9."""
    rows, zlo, zhi = planted(case)
    if zlo is None:
        rng = np.random.default_rng(5)
        zlo = torch.as_tensor(rng.uniform(-0.5, -0.2, (H, W)).astype(
            np.float32))
        zhi = torch.full((H, W), 0.9)
    tile_idx = torch.tensor([0, 1, 2, 3, 4, 5, 6, 7, 0, 0, 5],
                            dtype=torch.int32)
    zlo_c = TR._pad_swizzle32(zlo, H, W)[tile_idx.long()]
    zhi_c = TR._pad_swizzle32(zhi, H, W)[tile_idx.long()]
    zhi_c[8:10] = 0.0
    return rows, zlo_c, zhi_c, tile_idx


@pytest.mark.parametrize("case", ("peel_bounds_at_z", "neg_zero", "slivers",
                                  "all_culled"))
def test_k8_cull_walk_bit_equal_on_planted_cases(case):
    rows, zlo_c, zhi_c, tile_idx = planted_compact(case)
    got, want, _ = k8_model(rows, zlo_c, zhi_c, tile_idx=tile_idx,
                            n_tx=W // 32, width=W, height=H, names=NAMES)
    _assert_bit_equal(got, want)
    assert int((want["tri_id"] >= 0).sum()) > 0
    assert not (want["tri_id"][8:10] >= 0).any()


@pytest.mark.parametrize("peel", [False, True], ids=["nopeel", "peel"])
def test_k7_cull_walk_bit_equal_on_the_binned_scene(peel):
    """tests/test_torch_binned.py's scene: 300 overlapping triangles, its
    random peel bounds; a 100x50 crop takes the partial tiles."""
    _s, rows = _setup(_tris(5, 300, W, H))
    rng = np.random.default_rng(2)
    zlo = torch.as_tensor(rng.uniform(0.0, 0.3, (H, W)).astype(np.float32))
    zhi = torch.as_tensor(rng.uniform(0.6, 1.0, (H, W)).astype(np.float32))
    for w, h in ((W, H), (100, 50)):
        zb = (zlo[:h, :w], zhi[:h, :w]) if peel else (None, None)
        names = TR.plane_layout(*((True, True, True) if peel
                                  else (False, False, False)))
        got, want, _ = k7_model(rows, *zb, width=w, height=h, names=names)
        _assert_bit_equal(got, want)
        assert int((want["tri_id"] >= 0).sum()) > 1000


def test_k8_cull_walk_bit_equal_on_the_compact_case():
    """tests/test_torch_cuda.py's K8 case: two clusters over 256x128, 13
    of its 32 tiles, random peel bounds."""
    tris = (_tris(7, 90, 70, 60, 4.0, 4.0)
            + _tris(8, 90, 250, 124, 180.0, 60.0))
    rows = _setup(tris, seed=3)[1]
    tile_idx = torch.tensor([0, 1, 2, 8, 9, 10, 13, 14, 15, 21, 22, 23, 31],
                            dtype=torch.int32)
    g = torch.Generator().manual_seed(4)
    zlo = torch.rand(13, 1024, generator=g) * 0.3
    zhi = 0.6 + torch.rand(13, 1024, generator=g) * 0.4
    got, want, _ = k8_model(rows, zlo, zhi, tile_idx=tile_idx, n_tx=8,
                            width=256, height=128, names=NAMES)
    _assert_bit_equal(got, want)
    assert int((want["tri_id"] >= 0).sum()) > 1000
