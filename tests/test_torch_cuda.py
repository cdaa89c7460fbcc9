"""PyTorch port on the card: each hand-written CUDA kernel against its
plain PyTorch twin on the same CUDA tensors, and the whole frame on the
card against the same frame on the CPU.

Every test here is marked `cuda` and skips (inside the fixture) on a host
without a CUDA device. Run on the card with:

    python -m pytest tests/test_torch_cuda.py -q

K1 (on split tiles too), K3, K5 (on warp tails and clipped rows too),
K6 (both entries), K7, K8, K9 (on split tiles too), K11a, K11b (on
tests/test_torch_dense_walk.py's planted cases and at 1920x1080 with 1,100
chunks too), K12 (on tails and unaligned views too) and K13 are bit-equal
to their twins; K2's
ints are equal and its floats within rtol 1e-5, atol 1e-6 (both round
every product and sum separately, so they agree exactly in practice).
K10 is bit-equal to its twin on the same unit scalars. K4's row indices equal
the twin's and its weights are within 1e-6, except at taps whose LOD lies
within 1e-5 of an integer (log2f vs torch.log2 may floor to the other
mip). The card frame's tri_id plane equals the CPU frame's, and its LDR
image is within 1e-5 (torch's CUDA pow/exp2 may differ from the CPU's by
an ulp; a textured frame within 1e-4, for the same reason in its LOD;
the MSAA / supersample / effects frames within 1e-4). The temporal
card frames choose the same units as the CPU frames, and their images
and history colours agree within 1e-4. The 12-light frame's tiled lists
on the card equal the CPU's, its image is within 1e-4 of the CPU's and
within 1e-5 of the card's dense loop (12 lights summed in two orders);
the hook frames (a world-space extra pass, a display overlay, host and
first_pass hooks) are within 1e-4 of the CPU's and fire the host hooks
once. An interactive session's steps (a click that selects and attaches
the gizmo, a pointer-free step) select the same mesh as on the CPU and
their images are within 1e-4; a frame with timings on waits on the
device as often as with them off and resolves each span's device time,
and with them off makes no CUDA event; a scene saved and loaded back
onto the card renders bit-equal. K14 matches its twin on the benchmark
cells' 1080p frames; K15 is bit-equal to its twin there, NaN for NaN,
and where it takes a morph or skin sum within
tests/test_torch_vertex_fused.py's tolerance; each is one kernel a call
with no wait on the device, one launch a call of its wrapper, and every
frame above counts K15 once a vertex_stage call."""

import dataclasses

import numpy as np
import pytest
import torch

import _torch_port as T

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from awsm_renderer_tpu_torch.ops import kernels

    kernels.lib()          # builds the kernels from csrc/ at first use
    return torch.device("cuda")


@pytest.fixture(scope="module")
def scene_rows(dev):
    """Setup rows of the clipped test scene and of the metal-rough
    spheres (tiles with hundreds of groups) on the card."""
    from awsm_renderer_tpu_torch.passes.frame import _run_vertex
    from test_torch_vertex import _renderers

    out = {}
    for name, r in (("clip", _renderers("clip")[1]),
                    ("spheres", T.torch_renderer("metal-rough-spheres"))):
        ds = r._flush()
        m = r._mesh_masks()
        rows = _run_vertex(
            ds, torch.as_tensor(m["opaque"]), rw=T.W, rh_full=T.H,
            needs_clip=m["needs_clip"], pad=True)
        out[name] = rows.to(dev)
    return out


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.parametrize("name", ["clip", "spheres"])
def test_k1_kernel_bit_equal_to_twin(dev, scene_rows, name):
    from awsm_renderer_tpu_torch.ops import kernels
    from awsm_renderer_tpu_torch.ops.raster import (
        rasterize16_slim, rasterize16_slim_reference,
    )

    rows = scene_rows[name]
    n0 = kernels.launch_counts["rasterize16_slim"]
    col, depth, bins = rasterize16_slim(rows, width=T.W, height=T.H)
    assert kernels.launch_counts["rasterize16_slim"] == n0 + 1
    rcol, rdepth = rasterize16_slim_reference(rows, bins, width=T.W,
                                              height=T.H)
    torch.cuda.synchronize()
    assert torch.equal(col, rcol)
    assert torch.equal(_bits(depth), _bits(rdepth))
    assert int((col >= 0).sum()) > 100


@pytest.mark.parametrize("case", ["tie_across_slices", "neg_zero", "z_one",
                                  "big_ties", "sliver"])
def test_k1_split_tiles_bit_equal_to_twin(dev, case):
    """tests/test_torch_raster.py's planted cases with more groups a tile
    than a slice holds (exact depth ties across slices, -0.0 against
    +0.0, a z = 1.0 plane, big groups): the slices of each split tile
    merge bit-equal to the sequential twin, and a second call on the same
    bins (the same scratch memory, likely) agrees."""
    from awsm_renderer_tpu_torch.ops import kernels
    from awsm_renderer_tpu_torch.ops import raster as TR
    from test_torch_raster import planted_rows

    slice_groups = TR.K1_SLICE
    rows, w, h = planted_rows(case, copies=2 * slice_groups + 3)
    rows = torch.as_tensor(rows).to(dev)
    n0 = kernels.launch_counts["rasterize16_slim"]
    col, depth, bins = TR.rasterize16_slim(rows, width=w, height=h)
    assert kernels.launch_counts["rasterize16_slim"] == n0 + 1
    rcol, rdepth = TR.rasterize16_slim_reference(rows, bins, width=w,
                                                 height=h)
    col2, depth2, _ = TR.rasterize16_slim(rows, bins, width=w, height=h)
    torch.cuda.synchronize()
    assert int(bins[2].max()) + int(bins[6]) > slice_groups
    for c, d in ((col, depth), (col2, depth2)):
        assert torch.equal(c, rcol)
        assert torch.equal(_bits(d), _bits(rdepth))
    # the slivers are 0.4 pixels wide
    assert int((rcol >= 0).sum()) > (20 if case == "sliver" else 100)


def test_k2_kernel_matches_twin(dev, scene_rows):
    from awsm_renderer_tpu_torch.ops.raster import rasterize16_slim
    from awsm_renderer_tpu_torch.ops.shade import (
        RESOLVE_NAMES, resolve_planes_fused, resolve_planes_reference,
    )

    rows = scene_rows["clip"]
    col, _, _ = rasterize16_slim(rows, width=T.W, height=T.H)
    a = resolve_planes_fused(col, rows, width=T.W, row_offset=3)
    b = resolve_planes_reference(col, rows, width=T.W, row_offset=3)
    torch.cuda.synchronize()
    assert torch.equal(a["tri_id"], b["tri_id"])
    for k in RESOLVE_NAMES[1:]:
        torch.testing.assert_close(a[k], b[k], rtol=1e-5, atol=1e-6,
                                   msg=k)


def test_k3_k6_kernels_bit_equal_to_twins(dev):
    from awsm_renderer_tpu_torch.ops.relayout import (
        gather_split_channels, gather_split_channels_reference,
        onehot_split_rows, onehot_split_rows_reference,
    )

    g = torch.Generator().manual_seed(0)
    table = torch.randn(32, 50, generator=g).to(dev)
    rows = torch.randint(-4, 36, (70001,), generator=g,
                         dtype=torch.int32).to(dev)
    assert torch.equal(_bits(onehot_split_rows(rows, table)),
                       _bits(onehot_split_rows_reference(rows, table)))
    texels = torch.randn(5000, 64, generator=g).to(torch.bfloat16).to(dev)
    idx = torch.randint(-10, 5010, (90001,), generator=g,
                        dtype=torch.int32).to(dev)
    assert torch.equal(
        _bits(gather_split_channels(texels, idx, 16)),
        _bits(gather_split_channels_reference(texels, idx, 16)))


@pytest.mark.parametrize("mips, tform, nearest", [
    (False, False, True), (True, True, True), (True, False, False)])
def test_k4_k5_kernels_match_twins(dev, mips, tform, nearest):
    from awsm_renderer_tpu_torch.ops import texsample as TS
    from test_torch_texsample import _near_integer_lod, _taps, make_store

    st = make_store()
    tex_id, u, v, duv, tf = _taps(3)
    t = lambda a: torch.as_tensor(a).to(dev)  # noqa: E731
    args = (t(tex_id), t(u), t(v),
            tuple(t(c) for c in duv) if mips else None, t(st.descriptors))
    kw = dict(has_nearest=nearest, tform_id=t(tf) if tform else None,
              tex_transforms=t(st.tex_transforms) if tform else None)
    idx, w = TS.tap_plan_fused(*args, **kw)
    ridx, rw = TS.tap_plan_reference(*args, **kw)
    torch.cuda.synchronize()
    ok = np.ones(len(tex_id), bool)
    if mips:
        ok = ~_near_integer_lod(st, tex_id, u, v, duv,
                                tf if tform else np.full_like(tf, -1))
    ok = torch.as_tensor(ok, device=dev)
    assert torch.equal(idx[ok], ridx[ok])
    torch.testing.assert_close(w[:, ok], rw[:, ok], rtol=0, atol=1e-6)
    pool = torch.from_numpy(st.texels_packed.view(np.int16).copy()).view(
        torch.bfloat16).to(dev)
    a = TS.filter_taps_fused(pool, idx, w, mips=mips)
    b = TS.filter_taps_reference(pool, idx, w, mips=mips)
    torch.cuda.synchronize()
    assert torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("mips", [False, True], ids=["nomips", "mips"])
@pytest.mark.parametrize("N", [1, 31, 33, 264])
def test_k5_tails_and_clipped_rows_bit_equal(dev, N, mips):
    """K5 on warp tails (N not a multiple of 32) and on row indices below
    0 and at or above the pool (clipped): bit-equal to the twin."""
    from awsm_renderer_tpu_torch.ops import kernels
    from awsm_renderer_tpu_torch.ops import texsample as TS

    g = torch.Generator().manual_seed(N)
    R = 700
    pool = torch.randn(R, 64, generator=g).to(torch.bfloat16).to(dev)
    idx = torch.randint(-5, R + 5, (N,), generator=g, dtype=torch.int32)
    idx[0] = -3 if N % 2 else R
    idx[-1] = R + 2 if N % 2 else -1
    w = torch.rand(TS.N_WEIGHTS, N, generator=g).to(dev)
    idx = idx.to(dev)
    n0 = kernels.launch_counts["filter_taps_fused"]
    a = TS.filter_taps_fused(pool, idx, w, mips=mips)
    assert kernels.launch_counts["filter_taps_fused"] == n0 + 1
    b = TS.filter_taps_reference(pool, idx, w, mips=mips)
    torch.cuda.synchronize()
    assert a.shape == (4, N)
    assert torch.equal(_bits(a), _bits(b))


def test_wrappers_reject_bad_inputs(dev):
    from awsm_renderer_tpu_torch.ops import texsample as TS
    from awsm_renderer_tpu_torch.ops.relayout import onehot_split_rows

    table = torch.zeros(4, 3, device=dev)
    with pytest.raises(ValueError):
        onehot_split_rows(torch.zeros(8, dtype=torch.int64, device=dev),
                          table)
    with pytest.raises(ValueError):
        onehot_split_rows(torch.zeros(8, dtype=torch.int32, device=dev),
                          table.double())
    # K5 reads whole 128-byte rows as 16-byte vectors: a column-sliced
    # pool, one of 52 columns and one off 16-byte alignment are refused
    idx = torch.zeros(8, dtype=torch.int32, device=dev)
    w = torch.zeros(TS.N_WEIGHTS, 8, device=dev)
    wide = torch.zeros(100, 128, dtype=torch.bfloat16, device=dev)
    flat = torch.zeros(100 * 64 + 1, dtype=torch.bfloat16, device=dev)
    for pool in (wide[:, :64], wide[:, :52].contiguous(),
                 flat[1:].view(100, 64)):
        with pytest.raises(ValueError):
            TS.filter_taps_fused(pool, idx, w, mips=True)


@pytest.mark.parametrize("scene", ["box", "env-ibl", "box-textured"])
def test_card_frame_matches_cpu_frame(dev, scene):
    import awsm_renderer_tpu_torch as P
    from awsm_renderer_tpu_torch.ops import kernels

    cpu = T.torch_renderer(scene)
    card = T.build(P.AwsmRendererTorch(
        P.RendererConfig(width=T.W, height=T.H), device="cuda"), scene)
    kernels.reset_launch_counts()
    img_card = card.render()
    # K14 shades, the image environment's taps included (K6 serves only
    # the chain); K3 fetches the tapped slots' columns and K4 + K5 take
    # the texture taps; an untextured frame has none
    want = dict.fromkeys(kernels.launch_counts, 1)
    want["gather_split_channels"] = 0
    textured = scene == "box-textured"
    for name in ("onehot_split_rows", "tap_plan_fused", "filter_taps_fused"):
        want[name] = int(textured)
    # K15 once: the opaque pass's vertex stage. The overlay's kernels:
    # no transparent or HUD content here; K9 only with MSAA; K11-K13 on
    # no frame path
    want["vertex_stage"] = 1
    for name in ("rasterize_binned", "rasterize_binned_compact",
                 "gather_split_channels_f32", "rasterize16_msaa",
                 "reproject_history", "rasterize_dense",
                 "rasterize_peel_dense", "split_rows", "channel_rows"):
        want[name] = 0
    assert kernels.launch_counts == want
    img_cpu = cpu.render()
    np.testing.assert_array_equal(card._last_tri_id.cpu().numpy(),
                                  cpu._last_tri_id.numpy())
    np.testing.assert_allclose(img_card, img_cpu, rtol=0,
                               atol=1e-4 if textured else 1e-5)
    assert card.pick(T.W // 2, T.H // 2) == cpu.pick(T.W // 2, T.H // 2)


def _all_bits_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(_bits(a[k]), _bits(b[k])), k


@pytest.mark.parametrize("layout", [(True, True, True), (False, False,
                                                         False)],
                         ids=["full", "slim"])
@pytest.mark.parametrize("peel", [False, True], ids=["nopeel", "peel"])
def test_k7_kernel_bit_equal_to_twin(dev, layout, peel):
    from awsm_renderer_tpu_torch.ops import kernels
    from awsm_renderer_tpu_torch.ops import raster as TR
    from test_torch_binned import _setup, _tris

    _s, rows = _setup(_tris(5, 300, T.W, T.H))
    rows = torch.as_tensor(rows).to(dev)
    g = torch.Generator().manual_seed(2)
    zb = ((torch.rand(T.H, T.W, generator=g) * 0.3).to(dev),
          (0.6 + torch.rand(T.H, T.W, generator=g) * 0.4).to(dev)) \
        if peel else (None, None)
    has_uv1, has_color, derivs = layout
    names = TR.plane_layout(has_uv1, has_color, derivs)
    bins = TR.build_bins(rows, width=T.W, height=T.H)
    n0 = kernels.launch_counts["rasterize_binned"]
    a = TR.rasterize_binned(rows, *zb, width=T.W, height=T.H, bins=bins,
                            has_uv1=has_uv1, has_color=has_color,
                            analytic_derivs=derivs)
    assert kernels.launch_counts["rasterize_binned"] == n0 + 1
    b = TR.rasterize_binned_reference(rows, *zb, bins=bins, width=T.W,
                                      height=T.H, names=names)
    torch.cuda.synchronize()
    _all_bits_equal(a, b)
    assert int((a["tri_id"] >= 0).sum()) > 1000


def test_k8_kernel_bit_equal_to_twin(dev):
    from awsm_renderer_tpu_torch.ops import kernels
    from awsm_renderer_tpu_torch.ops import raster as TR
    from test_torch_binned import _setup, _tris

    tris = (_tris(7, 90, 70, 60, 4.0, 4.0)
            + _tris(8, 90, 250, 124, 180.0, 60.0))
    rows = torch.as_tensor(_setup(tris, seed=3)[1]).to(dev)
    bins = TR.build_bins(rows, width=256, height=128)
    tile_idx = torch.tensor([0, 1, 2, 8, 9, 10, 13, 14, 15, 21, 22, 23, 31],
                            dtype=torch.int32, device=dev)
    g = torch.Generator().manual_seed(4)
    zlo = (torch.rand(13, 1024, generator=g) * 0.3).to(dev)
    zhi = (0.6 + torch.rand(13, 1024, generator=g) * 0.4).to(dev)
    n0 = kernels.launch_counts["rasterize_binned_compact"]
    a = TR._rasterize_binned_compact(rows, zlo, zhi, bins=bins,
                                     tile_idx=tile_idx, n_tx=8,
                                     has_uv1=True, has_color=True)
    assert kernels.launch_counts["rasterize_binned_compact"] == n0 + 1
    b = TR.rasterize_binned_compact_reference(
        rows, zlo, zhi, bins=bins, tile_idx=tile_idx, n_tx=8,
        names=TR.plane_layout(True, True, True))
    torch.cuda.synchronize()
    _all_bits_equal(a, b)
    assert int((a["tri_id"] >= 0).sum()) > 1000


@pytest.mark.parametrize("case", ["ties", "zmin_at_worst_depth",
                                  "peel_bounds_at_z", "neg_zero", "z_one",
                                  "slivers", "touching", "all_culled"])
def test_k7_planted_bit_equal_to_twin(dev, case):
    """tests/test_torch_binned_walk.py's planted cases (exact ties inside
    and across chunks and warp blocks, a z-min at the tile's worst depth,
    peel bounds equal to z, -0.0 / +0.0, z = 1.0, block-border and
    rounded slivers, bboxes touching a block, fully culled tiles): K7
    bit-equal to its twin, launched twice on the same bins."""
    from awsm_renderer_tpu_torch.ops import kernels
    from awsm_renderer_tpu_torch.ops import raster as TR
    from test_torch_binned_walk import NAMES, W, H, planted

    rows, zlo, zhi = planted(case)
    rows = torch.as_tensor(rows).to(dev)
    zb = (zlo.to(dev), zhi.to(dev)) if zlo is not None else (None, None)
    bins = TR.build_bins(rows, width=W, height=H)
    n0 = kernels.launch_counts["rasterize_binned"]
    outs = [TR.rasterize_binned(rows, *zb, width=W, height=H, bins=bins)
            for _ in range(2)]
    assert kernels.launch_counts["rasterize_binned"] == n0 + 2
    b = TR.rasterize_binned_reference(rows, *zb, bins=bins, width=W,
                                      height=H, names=NAMES)
    torch.cuda.synchronize()
    for a in outs:
        _all_bits_equal(a, b)
    assert int((b["tri_id"] >= 0).sum()) > 0


@pytest.mark.parametrize("case", ["peel_bounds_at_z", "neg_zero", "slivers",
                                  "all_culled"])
def test_k8_planted_bit_equal_to_twin(dev, case):
    """K8 on the planted cases over every tile, a tile listed twice and
    two padding tiles (zhi = 0 admits nothing: planted_compact), launched
    twice."""
    from awsm_renderer_tpu_torch.ops import kernels
    from awsm_renderer_tpu_torch.ops import raster as TR
    from test_torch_binned_walk import NAMES, W, H, planted_compact

    rows, zlo_c, zhi_c, tile_idx = (
        torch.as_tensor(v).to(dev) for v in planted_compact(case))
    bins = TR.build_bins(rows, width=W, height=H)
    kw = dict(bins=bins, tile_idx=tile_idx, n_tx=W // 32)
    n0 = kernels.launch_counts["rasterize_binned_compact"]
    outs = [TR._rasterize_binned_compact(rows, zlo_c, zhi_c, has_uv1=True,
                                         has_color=True, **kw)
            for _ in range(2)]
    assert kernels.launch_counts["rasterize_binned_compact"] == n0 + 2
    b = TR.rasterize_binned_compact_reference(rows, zlo_c, zhi_c,
                                              names=NAMES, **kw)
    torch.cuda.synchronize()
    for a in outs:
        _all_bits_equal(a, b)
    assert int((b["tri_id"] >= 0).sum()) > 0
    assert not (b["tri_id"][8:10] >= 0).any()


@pytest.mark.parametrize("width", [1920, 1918])
@pytest.mark.parametrize("peel", [False, True], ids=["nopeel", "peel"])
def test_k7_1080p_bit_equal_to_twin(dev, width, peel):
    """K7 over a 1080-row band (a partial last tile row) whose triangles
    sit in two clusters, so most tiles are empty: width 1920 takes the
    16-byte stores of empty tiles, 1918 the plain ones."""
    from awsm_renderer_tpu_torch.ops import raster as TR
    from test_torch_binned import _setup, _tris

    h = 1080
    # one 128-triangle chunk a cluster
    tris = (_tris(21, 128, 700, 400, 100.0, 80.0)
            + _tris(22, 128, 1910, 1079, 1500.0, 900.0))
    rows = torch.as_tensor(_setup(tris, seed=6)[1]).to(dev)
    g = torch.Generator().manual_seed(7)
    zb = ((torch.rand(h, width, generator=g) * 0.3).to(dev),
          (0.6 + torch.rand(h, width, generator=g) * 0.4).to(dev)) \
        if peel else (None, None)
    layout = (True, True, True) if peel else (False, True, False)
    names = TR.plane_layout(*layout)
    bins = TR.build_bins(rows, width=1920, height=1088)
    outs = [TR.rasterize_binned(rows, *zb, width=width, height=h, bins=bins,
                                has_uv1=layout[0], has_color=layout[1],
                                analytic_derivs=layout[2])
            for _ in range(2)]
    b = TR.rasterize_binned_reference(rows, *zb, bins=bins, width=width,
                                      height=h, names=names)
    torch.cuda.synchronize()
    for a in outs:
        _all_bits_equal(a, b)
    hit = b["tri_id"] >= 0
    assert int(hit.sum()) > 10000 and int(hit[1056:].sum()) > 0
    assert int((bins[1] == 0).sum()) > 1000          # empty tiles


def test_k6_f32_kernel_bit_equal_to_twin(dev):
    from awsm_renderer_tpu_torch.ops.relayout import (
        gather_split_channels_f32, gather_split_channels_f32_reference,
    )

    g = torch.Generator().manual_seed(5)
    table = torch.randn(70000, 4, generator=g).to(dev)
    idx = torch.randint(-10, 70010, (90001,), generator=g,
                        dtype=torch.int32).to(dev)
    for n in (4, 3):
        assert torch.equal(
            _bits(gather_split_channels_f32(table, idx, n)),
            _bits(gather_split_channels_f32_reference(table, idx, n)))


@pytest.mark.parametrize("case", ["blend-over-opaque", "hud",
                                  "refraction-4"])
def test_card_overlay_frame_matches_cpu_frame(dev, case, monkeypatch):
    """The overlay on the card (K7 peel or non-peel, K6's f32 entry for
    refraction) against the same frame on the CPU."""
    import test_torch_overlay as TO
    from awsm_renderer_tpu_torch.ops import kernels
    from test_torch_overlay import CASES, H, W

    cpu, key = CASES[case](False)
    monkeypatch.setattr(TO, "DEVICE", "cuda")
    card, _ = CASES[case](False)
    kernels.reset_launch_counts()
    img_card = card.render()
    assert kernels.launch_counts["rasterize_binned"] >= 1
    # K15: the opaque pass's vertex stage and the overlay pass's
    assert kernels.launch_counts["vertex_stage"] == 2
    if case == "refraction-4":
        assert kernels.launch_counts["gather_split_channels_f32"] >= 1
    img_cpu = cpu.render()
    np.testing.assert_array_equal(card._last_tri_id.cpu().numpy(),
                                  cpu._last_tri_id.numpy())
    np.testing.assert_allclose(img_card, img_cpu, rtol=0, atol=1e-4)
    if key is not None:
        assert card.pick(W // 2, H // 2) == cpu.pick(W // 2, H // 2)


def _msaa_rows(dev, case, monkeypatch):
    """(setup rows on the card, width2, height2) of tests/test_torch_msaa.py
    cases: the MSAA scene's own 2x setup, the big-group triangles, and
    the same at a raster that is no 64-multiple (K9 crops its tiles)."""
    import test_torch_msaa as TM

    if case == "scene":
        monkeypatch.setattr(TM, "DEVICE", "cuda")
        return TM._rows2x(TM._scene(False, False))
    rows, w2, h2 = TM._big_rows()
    if case == "crop":
        w2, h2 = 456, 296
    return torch.as_tensor(rows).to(dev), w2, h2


@pytest.mark.parametrize("case", ["tie_across_slices", "neg_zero", "z_one",
                                  "big_ties", "sliver", "quadrants"])
def test_k9_split_tiles_bit_equal_to_twin(dev, case):
    """tests/test_torch_msaa_slices.py's planted cases with more groups a
    tile than a slice holds (exact depth ties across slices, -0.0 against
    +0.0, a z = 1.0 plane, big groups, slivers on warp-block borders,
    entries gating two quadrants): the four sample keys of each split
    tile merge bit-equal to the sequential twin, and a second call on
    the same bins agrees."""
    from awsm_renderer_tpu_torch.ops import kernels
    from awsm_renderer_tpu_torch.ops import raster as TR
    from test_torch_msaa_slices import msaa_rows

    slice_groups = TR.K9_SLICE
    rows, w2, h2 = msaa_rows(case, copies=2 * slice_groups + 3)
    rows = torch.as_tensor(rows).to(dev)
    n0 = kernels.launch_counts["rasterize16_msaa"]
    samp, depth, bins = TR.rasterize16_msaa(rows, width2=w2, height2=h2)
    assert kernels.launch_counts["rasterize16_msaa"] == n0 + 1
    rsamp, rdepth = TR.rasterize16_msaa_reference(rows, bins, width2=w2,
                                                  height2=h2)
    samp2, depth2, _ = TR.rasterize16_msaa(rows, bins, width2=w2, height2=h2)
    torch.cuda.synchronize()
    assert int(bins[2].max()) + int(bins[6]) > slice_groups
    for s, d in ((samp, depth), (samp2, depth2)):
        for a, b in zip(s, rsamp):
            assert torch.equal(a, b)
        assert torch.equal(_bits(d), _bits(rdepth))
    assert int((rsamp[0] >= 0).sum()) > (5 if case == "sliver" else 50)


@pytest.mark.parametrize("case", ["scene", "big_groups", "crop"])
def test_k9_kernel_bit_equal_to_twin(dev, case, monkeypatch):
    from awsm_renderer_tpu_torch.ops import kernels
    from awsm_renderer_tpu_torch.ops import raster as TR
    from test_torch_msaa import MSAA_CAPS

    rows, w2, h2 = _msaa_rows(dev, case, monkeypatch)
    for caps in ({}, MSAA_CAPS):
        n0 = kernels.launch_counts["rasterize16_msaa"]
        samp, depth, bins = TR.rasterize16_msaa(rows, width2=w2, height2=h2,
                                                **caps)
        assert kernels.launch_counts["rasterize16_msaa"] == n0 + 1
        rsamp, rdepth = TR.rasterize16_msaa_reference(rows, bins, width2=w2,
                                                      height2=h2)
        torch.cuda.synchronize()
        assert depth.shape == (h2 // 2, w2 // 2)
        for a, b in zip(samp, rsamp):
            assert torch.equal(a, b)
        assert torch.equal(_bits(depth), _bits(rdepth))
        assert int((samp[0] >= 0).sum()) > 100


def test_k2_msaa_entries_match_twin(dev, monkeypatch):
    from awsm_renderer_tpu_torch.ops import kernels
    from awsm_renderer_tpu_torch.ops.raster import rasterize16_msaa
    from awsm_renderer_tpu_torch.ops.shade import (
        RESOLVE_NAMES, resolve_planes_fused, resolve_planes_reference,
    )

    rows, w2, h2 = _msaa_rows(dev, "scene", monkeypatch)
    samp, _, _ = rasterize16_msaa(rows, width2=w2, height2=h2)
    W1 = w2 // 2
    tid = samp[0].reshape(-1).contiguous()
    g = torch.Generator().manual_seed(6)
    sel = torch.randperm(tid.numel(), generator=g)[:5000].to(dev)
    px = 2.0 * (sel % W1).float() + 0.5
    py = 2.0 * torch.div(sel, W1, rounding_mode="floor").float() + 0.5
    for t, kw in ((tid, dict(width=W1, coord_scale=2)),
                  (tid[sel].contiguous(), dict(width=W1, px=px, py=py))):
        n0 = kernels.launch_counts["resolve_planes_fused"]
        a = resolve_planes_fused(t, rows, **kw)
        assert kernels.launch_counts["resolve_planes_fused"] == n0 + 1
        b = resolve_planes_reference(t, rows, **kw)
        torch.cuda.synchronize()
        assert torch.equal(a["tri_id"], b["tri_id"])
        for k in RESOLVE_NAMES[1:]:
            torch.testing.assert_close(a[k], b[k], rtol=1e-5, atol=1e-6,
                                       msg=k)


@pytest.mark.parametrize("key", ["msaa-image", "msaa-solid", "supersample",
                                 "effects"])
def test_card_aa_frame_matches_cpu_frame(dev, key, monkeypatch):
    """The MSAA frame (K9, K2's coord_scale and explicit-px/py entries
    through the compacted shade, the edge blend), the supersample frame
    and an MSAA + SMAA + bloom + DoF frame on the card against the same
    frames on the CPU."""
    from dataclasses import replace

    import awsm_renderer_tpu_torch as P
    import test_torch_msaa as TM
    from awsm_renderer_tpu_torch.ops import kernels

    TM._forced_cap(monkeypatch, P.AwsmRendererTorch, 8)
    aa = dict(supersample=True) if key == "supersample" else {}

    def build():
        r = TM._scene(False, key == "msaa-image", **aa)
        if key == "effects":
            r.config = replace(
                r.config, anti_aliasing=P.AntiAliasing(msaa=True, smaa=True),
                post_processing=P.PostProcessing(bloom=True, dof=True))
            r.camera.dof.focus_distance = 1.0
            r.camera.dof.aperture = 0.05
        return r

    cpu = build()
    monkeypatch.setattr(TM, "DEVICE", "cuda")
    card = build()
    kernels.reset_launch_counts()
    img_card = card.render()
    msaa = key != "supersample"
    assert kernels.launch_counts["rasterize16_msaa"] == int(msaa)
    assert kernels.launch_counts["rasterize16_slim"] == int(not msaa)
    assert kernels.launch_counts["vertex_stage"] == 1
    img_cpu = cpu.render()
    np.testing.assert_array_equal(card._last_tri_id.cpu().numpy(),
                                  cpu._last_tri_id.numpy())
    np.testing.assert_allclose(img_card, img_cpu, rtol=0, atol=1e-4)
    if key == "effects":
        assert card._prep[1]["dof_rings"] != ()
    assert card.pick(TM.W // 4, 3 * TM.H // 4) == cpu.pick(TM.W // 4,
                                                          3 * TM.H // 4)


@pytest.mark.parametrize("case", ["narrow", "border", "special"])
def test_k10_kernel_bit_equal_to_twin(dev, case):
    """K10 at 1080x1920 on random histories and unit-varying offsets
    (outward motion at the borders; 1e6, +-inf and NaN pixels)."""
    from awsm_renderer_tpu_torch.ops import kernels
    from awsm_renderer_tpu_torch.ops import temporal as TT
    from test_torch_temporal import _k10_case

    args = [torch.from_numpy(np.array(a)).to(dev)
            for a in _k10_case(case, size=(1920, 1080))]
    scal = TT._unit_scalars(args[1], args[2], width=1920, height=1080)
    n0 = kernels.launch_counts["reproject_history"]
    a = TT.reproject_history_planes(*args, scal)
    assert kernels.launch_counts["reproject_history"] == n0 + 1
    b = TT.reproject_history_reference(*args, scal)
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert torch.equal(_bits(x), _bits(y))
    v = a[3]
    assert 0 < int(((v & 1) > 0).sum()) < int(((v & 2) > 0).sum())


def test_card_temporal_frame_matches_cpu_frame(dev):
    """A reset frame and three orbit frames of the temporal box on the
    card (K1, K10, K2's explicit px/py entry, K14) against the same frames
    on the CPU."""
    import awsm_renderer_tpu_torch as P
    from awsm_renderer_tpu_torch.ops import kernels
    from test_torch_temporal import _orbit

    aa = P.AntiAliasing(temporal=True)
    cpu = T.torch_renderer("box", anti_aliasing=aa)
    card = T.build(P.AwsmRendererTorch(P.RendererConfig(
        width=T.W, height=T.H, anti_aliasing=aa), device="cuda"), "box")
    for i in range(4):
        _orbit(cpu, i)
        _orbit(card, i)
        kernels.reset_launch_counts()
        img_card = card.render()
        for name in ("rasterize16_slim", "reproject_history",
                     "resolve_planes_fused", "shade_surface_fused",
                     "vertex_stage"):
            assert kernels.launch_counts[name] == 1, name
        img_cpu = cpu.render()
        st_card, st_cpu = card._temporal, cpu._temporal
        np.testing.assert_array_equal(st_card["age"].cpu().numpy(),
                                      st_cpu["age"].numpy())
        np.testing.assert_array_equal(card._last_tri_id.cpu().numpy(),
                                      cpu._last_tri_id.numpy())
        np.testing.assert_allclose(img_card, img_cpu, rtol=0, atol=1e-4)
        h_card, h_cpu = st_card["hist"].cpu(), st_cpu["hist"]
        assert torch.equal(_bits(h_card[3]), _bits(h_cpu[3]))
        torch.testing.assert_close(h_card[:3], h_cpu[:3], rtol=0, atol=1e-4)
    assert card.pick(T.W // 2, T.H // 2) == cpu.pick(T.W // 2, T.H // 2)


def _dense_scene(dev):
    """tests/test_torch_dense.py's scene (random triangles, three copies
    of one flat triangle, a screen-filling one) on the card, with peel
    bounds; and 2048 random triangles over 1024x512 (16 chunks)."""
    from test_torch_binned import _setup, _tris
    from test_torch_dense import _scene

    _s, rows, zlo, zhi = _scene()
    big = _setup(_tris(9, 2048, 1024, 512), seed=7)[1]
    return ([torch.as_tensor(a).to(dev) for a in (rows, zlo, zhi)],
            torch.as_tensor(big).to(dev))


@pytest.mark.parametrize("slim, derivs", [(False, True), (False, False),
                                          (True, True)],
                         ids=["fat", "fat-noderivs", "slim"])
def test_k11a_kernel_bit_equal_to_twin(dev, slim, derivs):
    from awsm_renderer_tpu_torch.ops import kernels
    from awsm_renderer_tpu_torch.ops import raster as TR

    (rows, _zlo, _zhi), big = _dense_scene(dev)
    for r, w, h in ((rows, T.W, T.H), (big, 1024, 512)):
        kw = dict(width=w, height=h, slim=slim, analytic_derivs=derivs,
                  has_uv1=not derivs)
        n0 = kernels.launch_counts["rasterize_dense"]
        a = TR.rasterize(r, binned=False, **kw)
        assert kernels.launch_counts["rasterize_dense"] == n0 + 1
        b = TR.rasterize_dense_reference(r, **kw)
        torch.cuda.synchronize()
        _all_bits_equal(a, b)
        assert int((a["tri_id"] >= 0).sum()) > 1000


@pytest.mark.parametrize("slim", [False, True], ids=["fat", "slim"])
def test_k11b_kernel_bit_equal_to_twin(dev, slim):
    from awsm_renderer_tpu_torch.ops import kernels
    from awsm_renderer_tpu_torch.ops import raster as TR

    (rows, zlo, zhi), big = _dense_scene(dev)
    g = torch.Generator().manual_seed(8)
    blo = (torch.rand(512, 1024, generator=g) * 0.3).to(dev)
    bhi = (0.6 + torch.rand(512, 1024, generator=g) * 0.4).to(dev)
    for r, zl, zh in ((rows, zlo, zhi), (big, blo, bhi)):
        h, w = zl.shape
        kw = dict(width=w, height=h, slim=slim, has_color=False)
        n0 = kernels.launch_counts["rasterize_peel_dense"]
        a = TR.rasterize_peel(r, zl, zh, binned=False, **kw)
        assert kernels.launch_counts["rasterize_peel_dense"] == n0 + 1
        b = TR.rasterize_peel_dense_reference(r, zl, zh, **kw)
        torch.cuda.synchronize()
        _all_bits_equal(a, b)
        assert int((a["tri_id"] >= 0).sum()) > 1000


K11_MODES = {"fat": dict(slim=False, analytic_derivs=True),
             "fat-noderivs": dict(slim=False, analytic_derivs=False,
                                  has_uv1=False),
             "slim": dict(slim=True), "peel-fat": dict(slim=False),
             "peel-slim": dict(slim=True)}


def _k11(dev, rows, zlo, zhi, w, h, kw):
    """K11a (zlo None) or K11b on the card and its twin: (kernel, twin)."""
    from awsm_renderer_tpu_torch.ops import kernels
    from awsm_renderer_tpu_torch.ops import raster as TR

    name = "rasterize_dense" if zlo is None else "rasterize_peel_dense"
    n0 = kernels.launch_counts[name]
    if zlo is None:
        a = TR.rasterize(rows, width=w, height=h, binned=False, **kw)
        b = TR.rasterize_dense_reference(rows, width=w, height=h, **kw)
    else:
        a = TR.rasterize_peel(rows, zlo, zhi, width=w, height=h,
                              binned=False, **kw)
        b = TR.rasterize_peel_dense_reference(rows, zlo, zhi, width=w,
                                              height=h, **kw)
    assert kernels.launch_counts[name] == n0 + 1
    torch.cuda.synchronize()
    return a, b


@pytest.mark.parametrize("mode", list(K11_MODES))
@pytest.mark.parametrize("case", ["windows", "empty_tile", "ties",
                                  "slivers"])
def test_k11_planted_bit_equal_to_twin(dev, case, mode):
    """tests/test_torch_dense_walk.py's planted cases (more chunks than
    three scan windows, a tile no chunk overlaps, exact ties across
    chunks, subgroups and windows, slivers and bboxes ending at a tile
    border): K11a fat, fat without derivatives and slim, K11b fat and slim
    (its peel bounds), bit-equal to the twins."""
    from test_torch_dense_walk import CASES, W, H, peel_bounds, planted

    rows, _notes = planted(case)
    zb = (None, None)
    if mode.startswith("peel"):
        zb = tuple(z.to(dev) for z in peel_bounds(CASES.index(case)))
    a, b = _k11(dev, torch.as_tensor(rows).to(dev), *zb, W, H,
                K11_MODES[mode])
    _all_bits_equal(a, b)
    assert int((b["tri_id"] >= 0).sum()) > 0


def test_k11_1080p_many_chunks_bit_equal_to_twin(dev):
    """1920x1080 with 1,100 chunks, each 128 small triangles around one
    point, so the scan takes more than one window of even the widest CTA:
    K11a fat and slim, K11b fat."""
    from test_torch_dense_walk import random_tris, setup_rows

    w, h, n_chunks = 1920, 1080, 1100
    xy, z = [], []
    rng = np.random.default_rng(31)
    for c in range(n_chunks):
        cx, cy = rng.uniform(0, w), rng.uniform(0, h)
        txy, tz = random_tris(100 + c, 160, max(cx - 40, 0), max(cy - 30, 0),
                              min(cx + 40, w), min(cy + 30, h), size=12.0)
        xy.append(txy[:128])
        z.append(tz[:128])
    assert all(len(t) == 128 for t in xy)
    rows = torch.as_tensor(setup_rows(np.concatenate(xy),
                                      np.concatenate(z), seed=5)).to(dev)
    g = torch.Generator().manual_seed(9)
    zlo = (torch.rand(h, w, generator=g) * 0.3).to(dev)
    zhi = (0.6 + torch.rand(h, w, generator=g) * 0.4).to(dev)
    for zb, kw in (((None, None), dict(slim=False)),
                   ((None, None), dict(slim=True)),
                   ((zlo, zhi), dict(slim=False))):
        a, b = _k11(dev, rows, *zb, w, h, kw)
        _all_bits_equal(a, b)
        assert int((b["tri_id"] >= 0).sum()) > 100000


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_k12_tails_and_unaligned_views_bit_equal(dev, dt):
    """K12 at lengths that are no multiple of a 16-byte vector, on an
    aligned view and on one offset by a value (the one-by-one path)."""
    from awsm_renderer_tpu_torch.ops import kernels
    from awsm_renderer_tpu_torch.ops.relayout import (
        split_rows, split_rows_reference,
    )

    g = torch.Generator().manual_seed(13)
    for C, P in ((8, 70001), (3, 5), (1, 7), (8, 1920 * 1080 // 8 + 3)):
        buf = torch.randn(C * P + 1, generator=g).to(dt).to(dev)
        for x in (buf[:C * P].view(C, P), buf[1:].view(C, P)):
            n0 = kernels.launch_counts["split_rows"]
            got = split_rows(x)
            assert kernels.launch_counts["split_rows"] == n0 + 1
            want = split_rows_reference(x)
            assert len(got) == C
            for a, b in zip(got, want):
                assert a.dtype == torch.float32
                assert torch.equal(_bits(a), _bits(b))


def test_k12_k13_kernels_bit_equal_to_twins(dev):
    from awsm_renderer_tpu_torch.ops import kernels
    from awsm_renderer_tpu_torch.ops.relayout import (
        channel_rows, channel_rows_reference, split_rows,
        split_rows_reference,
    )

    g = torch.Generator().manual_seed(12)
    for dt in (torch.float32, torch.bfloat16):
        x = torch.randn(8, 70001, generator=g).to(dt).to(dev)
        n0 = kernels.launch_counts["split_rows"]
        got = split_rows(x)
        assert kernels.launch_counts["split_rows"] == n0 + 1
        want = split_rows_reference(x)
        assert len(got) == 8
        for a, b in zip(got, want):
            assert a.dtype == torch.float32 and torch.equal(_bits(a),
                                                            _bits(b))
        for C in (4, 1, 37, 1024):
            x = torch.randn(70001 if C < 1024 else 3001, C,
                            generator=g).to(dt).to(dev)
            n0 = kernels.launch_counts["channel_rows"]
            a = channel_rows(x)
            assert kernels.launch_counts["channel_rows"] == n0 + 1
            assert torch.equal(_bits(a), _bits(channel_rows_reference(x)))
    with pytest.raises(ValueError):
        split_rows(torch.zeros(3, 5, dtype=torch.float64, device=dev))
    with pytest.raises(ValueError):
        channel_rows(torch.zeros(5, 1025, device=dev))


def test_card_tiled_lights_frame(dev, monkeypatch):
    """tests/test_torch_lights.py's 12-light scene on the card: the tiled
    lists equal the CPU's, the image is within 1e-4 of the CPU frame's
    and within 1e-5 of the card's dense loop."""
    from awsm_renderer_tpu_torch.passes import light_culling as LC
    from test_torch_lights import _scene

    logs = {"cpu": [], "cuda": []}
    orig = LC.light_lists_from_bounds
    where = []

    def logged(*args):
        out = orig(*args)
        logs[where[-1]].append([t.cpu() for t in out])
        return out

    monkeypatch.setattr(LC, "light_lists_from_bounds", logged)
    imgs = {}
    for device in ("cpu", "cuda"):
        where.append(device)
        imgs[device] = _scene(False, 12, device=device).render()
    assert len(logs["cuda"]) == len(logs["cpu"]) == 1
    for (ci, cv), (gi, gv) in zip(logs["cpu"], logs["cuda"]):
        assert torch.equal(cv, gv)
        assert torch.equal(torch.where(cv, ci, -1), torch.where(gv, gi, -1))
    np.testing.assert_allclose(imgs["cuda"], imgs["cpu"], rtol=0, atol=1e-4)
    card = _scene(False, 12, device="cuda")
    card.config = dataclasses.replace(card.config, light_tiles=False)
    np.testing.assert_allclose(card.render(), imgs["cuda"], rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("name", ["world_pass", "display_overlay",
                                  "host_first_pass"])
def test_card_hook_frame(dev, name):
    """tests/test_torch_hooks.py's hook frames on the card against the
    same frames on the CPU."""
    from test_torch_hooks import _case

    out = {}
    for device in ("cpu", "cuda"):
        r, hooks, calls = _case(False, name, device)
        out[device] = (r.render(hooks=hooks), calls)
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=0,
                               atol=1e-4)
    assert out["cuda"][1] == out["cpu"][1]
    if name == "host_first_pass":
        assert out["cuda"][1] == {"pre": 1, "post": 1}


def test_card_session_step(dev):
    """tests/test_torch_editor.py's session scene on the card: a click
    selects the box and attaches the gizmo (its HUD handles through the
    overlay), a pointer-free step after it; both against the CPU."""
    from awsm_renderer_tpu_torch.ops import kernels
    from test_torch_editor import H, W, _Api, _session_scene

    out = {}
    for device in ("cpu", "cuda"):
        r, s, key = _session_scene(_Api("torch", device))
        imgs = [s.step(0.0, [("pointer_down", W // 2, H // 2),
                             ("pointer_up",)])]
        kernels.reset_launch_counts()
        imgs.append(s.step(0.0))
        out[device] = ([i.cpu().numpy() for i in imgs], s.selected,
                       s.controller.target, key,
                       dict(kernels.launch_counts))
    (ci, csel, ctk, ckey, _), (gi, gsel, gtk, gkey, n) = (out["cpu"],
                                                          out["cuda"])
    assert gsel == csel == gkey == ckey and gtk == ctk
    assert n["rasterize16_slim"] >= 1 and n["resolve_planes_fused"] >= 1
    assert n["vertex_stage"] == 2      # the opaque pass and the gizmo's HUD
    for a, b in zip(gi, ci):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)


def _syncs(fn):
    """Host syncs (torch's sync debug mode warnings) while fn() runs."""
    import warnings

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sum("synchroniz" in str(w.message) for w in caught)


def test_card_timings_frame_adds_no_sync(dev):
    """tests/test_torch_tools.py's warmup scene on the card: a frame on a
    moved camera with timings on waits on the device as often as the same
    frame with them off; summary() then resolves the spans' device times."""
    from awsm_renderer_tpu_torch.utils import math3d as m3
    from test_torch_tools import _aux_scene

    r = _aux_scene(False, "cuda")
    r.render_device()
    counts = []
    for on, z in ((False, 3.1), (True, 3.2)):
        r.logging_timings = on
        r.camera.update(m3.look_at([0, 0, z], [0, 0, 0], [0, 1, 0]),
                        r.camera.projection)
        counts.append(_syncs(r.render_device))
    assert counts[1] == counts[0]
    host = r.timings.summary()
    dev_s = r.timings.device_summary()
    assert set(dev_s) == {"write_gpu", "collect_renderables",
                          "render_frame/dispatch", "render_device",
                          "prepare", "render_frame/vertex",
                          "render_frame/raster", "render_frame/shade",
                          "render_frame/display"} == set(host)
    assert all(v > 0 for v in dev_s.values())
    assert r.timings.counts == {"prepare/rerun": 1}   # the moved camera


def test_card_timings_off_records_no_event(dev, monkeypatch):
    """With timings off a frame on the card makes no CUDA event (and, the
    span being the shared no-op, no profiler range); with them on, two a
    span opened."""
    from awsm_renderer_tpu_torch.utils import math3d as m3
    from test_torch_tools import _aux_scene

    made, real = [], torch.cuda.Event

    def event(*args, **kwargs):
        made.append(1)
        return real(*args, **kwargs)

    r = _aux_scene(False, "cuda")
    r.render_device()
    monkeypatch.setattr(torch.cuda, "Event", event)
    for on, z in ((False, 3.1), (True, 3.2)):
        made.clear()
        r.logging_timings = on
        r.camera.update(m3.look_at([0, 0, z], [0, 0, 0], [0, 1, 0]),
                        r.camera.projection)
        r.render_device()
        if not on:
            assert made == [] and r.timings.counts == {}
            assert r.timings.frames == []
    pairs = sum(len(p) for p in r.timings._pending[-1].values())
    assert len(made) == 2 * pairs > 0


def test_card_snapshot_roundtrip(dev, tmp_path):
    """A scene saved from the card and loaded back onto it with
    load_scene(device="cuda") renders bit-equal."""
    from awsm_renderer_tpu_torch.core.snapshot import load_scene, save_scene
    from test_torch_tools import _aux_scene

    r = _aux_scene(False, "cuda")
    img1 = r.render_device()
    save_scene(r, str(tmp_path / "s.awsm"))
    r2 = load_scene(str(tmp_path / "s.awsm"), device="cuda")
    assert r2.device.type == "cuda"
    img2 = r2.render_device()
    assert img2.device.type == "cuda" and torch.equal(img1, img2)


# ---- K14 and K15 on the benchmark cells' 1080p frames ------------------

K14_CELLS = ("helmet-ibl.orbit", "colonnade-msaa.orbit")
# K15 launches a frame: a vertex_stage call each (the helmet's opaque
# pass; the colonnade's and its panes'; the edit cell's opaque, panes +
# grid and HUD passes; the avatar room's whole pool and animated subset)
K15_CELLS = {"helmet-ibl.orbit": 1, "colonnade-msaa.orbit": 2,
             "colonnade-msaa-editor.edit": 3, "avatar-room-msaa.animate": 2}


@pytest.fixture(scope="module")
def cell_frames(dev):
    """Each benchmark cell opened on the card at its real size (port_bench
    open_cell: the 1080p scene from a seed, warmed up), with the K14 and
    K15 calls of one frame: {cell: (renderer, driver, K14 calls, K15
    calls)}."""
    from awsm_renderer_tpu_torch.ops import shade as S
    from awsm_renderer_tpu_torch.passes import frame as TF
    from port_bench import run

    run._caches_in_checkout()
    out = {}
    for cell in K15_CELLS:
        _w, _c, _m, _scene, r, drv = run.open_cell(cell, 4100001801, dev)
        calls, vcalls = [], []
        real, vreal = S.shade_surface_fused, TF.vertex_stage

        def record(*args, **kwargs):
            calls.append((args, kwargs))
            return real(*args, **kwargs)

        def vrecord(*args, **kwargs):
            vcalls.append((args, kwargs))
            return vreal(*args, **kwargs)

        S.shade_surface_fused, TF.vertex_stage = record, vrecord
        try:
            drv.step(0)
        finally:
            S.shade_surface_fused, TF.vertex_stage = real, vreal
        torch.cuda.synchronize()
        out[cell] = (r, drv, calls, vcalls)
    return out


@pytest.mark.parametrize("cell", K14_CELLS)
def test_k14_matches_twin_on_cell_frames(cell_frames, cell):
    """K14 against its twin on the frame's own inputs (the helmet's
    opaque shade, five texture slots and image IBL; the colonnade's
    compacted MSAA opaque shade, 7 lights, and its panes' transparent
    shade). Tolerance 1e-5 absolute and relative (observed 2.4e-7): the
    twin's PyTorch multiplies by the reciprocal of a light's range and
    spot width where K14 divides, and the two may round exp2f / expf /
    logf / powf an ulp apart; alpha and every index are exact, so no tap,
    texel or branch differs. (The twin runs on the card: PyTorch's sqrt
    on the CPU is not IEEE, K14's and the card's are, and a GGX peak
    turns an ulp of sqrt into ~1e-3.)"""
    from awsm_renderer_tpu_torch.ops import shade as S

    _r, _drv, calls, _v = cell_frames[cell]
    assert len(calls) == (1 if cell.startswith("helmet") else 2)
    for args, kwargs in calls:
        got = S.shade_surface_fused(*args, **kwargs)
        ref = S.shade_surface_fused_reference(*args, **kwargs)
        pairs = list(zip(got[0], ref[0])) + [(got[1], ref[1])]
        if kwargs["transparent_pass"]:
            pairs += list(zip(got[2], ref[2]))
        for a, b in pairs:
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5,
                                       equal_nan=True)
        assert torch.equal(got[1], ref[1])


@pytest.mark.parametrize("cell", K14_CELLS)
def test_k14_launches_one_kernel_and_copies_nothing(cell_frames, cell):
    """One K14 call on a cell's frame inputs is one kernel on the device,
    with no host-to-device copy and no wait on the device (the camera and
    the environment's colours travel as kernel arguments); a frame waits
    on the device as often as before K14 (the colonnade's one peel
    check, none on the helmet)."""
    from torch.profiler import ProfilerActivity, profile

    from awsm_renderer_tpu_torch.ops import shade as S

    r, drv, calls, _v = cell_frames[cell]
    args, kwargs = calls[0]
    S.shade_surface_fused(*args, **kwargs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.set_sync_debug_mode("error")
        try:
            S.shade_surface_fused(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    on_card = [(e.key, e.count) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(on_card) == 1 and on_card[0][1] == 1, on_card
    assert "shade_surface_kernel" in on_card[0][0], on_card
    assert _syncs(lambda: drv.step(1)) == (0 if cell.startswith("helmet")
                                           else 1)


@pytest.mark.parametrize("cell", K14_CELLS)
def test_k14_launches_once_per_shade_call(dev, cell_frames, cell):
    """Over three frames every shade call is in K14's scope: one K14
    launch each, and the chain's count shade/chain stays 0."""
    from awsm_renderer_tpu_torch.ops import kernels
    from awsm_renderer_tpu_torch.ops import shade as S
    from awsm_renderer_tpu_torch.utils.profiling import RenderTimings

    r, drv, _calls, _v = cell_frames[cell]
    n_calls, real = [], S.shade_surface

    def counted(*args, **kwargs):
        n_calls.append(1)
        return real(*args, **kwargs)

    r.timings = RenderTimings(enabled=True, device=dev)
    r.logging_timings = True
    n0 = kernels.launch_counts["shade_surface_fused"]
    S.shade_surface = counted
    try:
        for i in range(2, 5):
            drv.step(i)
    finally:
        S.shade_surface = real
        r.logging_timings = False
    torch.cuda.synchronize()
    assert kernels.launch_counts["shade_surface_fused"] - n0 == len(n_calls)
    assert len(n_calls) == 3 * (1 if cell.startswith("helmet") else 2)
    assert r.timings.counts.get("shade/chain", 0) == 0


def _k15_pair(args, kwargs):
    """K15 and its twin on one recorded call; a call that writes into the
    pool's rows (the animated subset) gets a copy of them each."""
    from awsm_renderer_tpu_torch.ops import vertex as V

    out = kwargs.get("out")
    kw = [dict(kwargs, out=None if out is None else out.clone())
          for _ in range(2)]
    return (V.vertex_stage(*args, **kw[0]),
            V.vertex_stage_reference(*args, **kw[1]))


@pytest.mark.parametrize("cell", list(K15_CELLS))
def test_k15_matches_twin_on_cell_frames(cell_frames, cell):
    """K15 against its twin on each vertex_stage call of the frame (the
    cells' pools at 1080p: the helmet's plain pass, the colonnade's and
    its compacted panes', the edit cell's three clipped passes, the
    avatar room's whole pool and its morphed and skinned subset):
    bit-equal, NaN for NaN, where no morph or skin sum is taken; else
    within tests/test_torch_vertex_fused.py's tolerance (the twin sums
    in K15's order, so it is bit-equal there in practice too)."""
    import test_torch_vertex_fused as VF

    _r, _drv, _calls, vcalls = cell_frames[cell]
    assert len(vcalls) == K15_CELLS[cell]
    for args, kwargs in vcalls:
        got, ref = _k15_pair(args, kwargs)
        torch.cuda.synchronize()
        assert got.shape == ref.shape
        if kwargs.get("has_morphs") or kwargs.get("skin_sets"):
            VF._close(got.cpu(), ref.cpu(), cell)
            continue
        nan = torch.isnan(got) & torch.isnan(ref)
        assert torch.equal(_bits(torch.where(nan, 0.0, got)),
                           _bits(torch.where(nan, 0.0, ref)))
        assert torch.equal(nan, torch.isnan(got))


@pytest.mark.parametrize("cell", list(K15_CELLS))
def test_k15_launches_one_kernel_and_waits_on_nothing(cell_frames, cell):
    """Each K15 call of a cell's frame is one kernel on the device, with
    no host-to-device copy and no wait on the device (the camera travels
    as kernel arguments)."""
    from torch.profiler import ProfilerActivity, profile

    from awsm_renderer_tpu_torch.ops import vertex as V

    _r, _drv, _calls, vcalls = cell_frames[cell]
    for args, kwargs in vcalls:
        V.vertex_stage(*args, **kwargs)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.set_sync_debug_mode("error")
            try:
                V.vertex_stage(*args, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
        on_card = [(e.key, e.count) for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        assert len(on_card) == 1 and on_card[0][1] == 1, on_card
        assert "vertex_kernel" in on_card[0][0], on_card


@pytest.mark.parametrize("cell", list(K15_CELLS))
def test_k15_launches_once_per_vertex_stage_call(dev, cell_frames, cell):
    """Over three frames (the driver's next three: the animation driver
    takes its frames in order) every vertex_stage call launches K15
    once: the cell's calls a frame, three times."""
    from awsm_renderer_tpu_torch.ops import kernels
    from awsm_renderer_tpu_torch.passes import frame as TF

    _r, drv, _calls, _v = cell_frames[cell]
    n_calls, real = [], TF.vertex_stage

    def counted(*args, **kwargs):
        n_calls.append(1)
        return real(*args, **kwargs)

    n0 = kernels.launch_counts["vertex_stage"]
    TF.vertex_stage = counted
    try:
        for i in range(1, 4):
            drv.step(i)
    finally:
        TF.vertex_stage = real
    torch.cuda.synchronize()
    assert kernels.launch_counts["vertex_stage"] - n0 == len(n_calls)
    assert len(n_calls) == 3 * K15_CELLS[cell]
