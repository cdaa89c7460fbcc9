"""PyTorch port on the card: each hand-written CUDA kernel against its
plain PyTorch twin on the same CUDA tensors, and the whole frame on the
card against the same frame on the CPU.

Every test here is marked `cuda` and skips (inside the fixture) on a host
without a CUDA device. Run on the card with:

    python -m pytest tests/test_torch_cuda.py -q

K1, K3, K5, K6 (both entries), K7, K8, K9, K11a, K11b, K12 and K13 are
bit-equal to their twins; K2's ints are equal and
its floats within rtol 1e-5, atol 1e-6 (both round every product and sum
separately, so they agree exactly in practice). K10 is bit-equal to its
twin on the same unit scalars. K4's row indices equal
the twin's and its weights are within 1e-6, except at taps whose LOD lies
within 1e-5 of an integer (log2f vs torch.log2 may floor to the other
mip). The card frame's tri_id plane equals the CPU frame's, and its LDR
image is within 1e-5 (torch's CUDA pow/exp2 may differ from the CPU's by
an ulp; a textured frame within 1e-4, for the same reason in its LOD;
the MSAA / supersample / effects frames within 1e-4). The temporal
card frames choose the same units as the CPU frames, and their images
and history colours agree within 1e-4."""

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
    from awsm_renderer_tpu_torch.passes.frame import (
        _run_vertex, prep_setup_rows,
    )
    from test_torch_vertex import _renderers

    out = {}
    for name, r in (("clip", _renderers("clip")[1]),
                    ("spheres", T.torch_renderer("metal-rough-spheres"))):
        ds = r._flush()
        m = r._mesh_masks()
        rows = prep_setup_rows(_run_vertex(
            ds, torch.as_tensor(m["opaque"]), rw=T.W, rh_full=T.H,
            needs_clip=m["needs_clip"]))
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


def test_wrappers_reject_bad_inputs(dev):
    from awsm_renderer_tpu_torch.ops.relayout import onehot_split_rows

    table = torch.zeros(4, 3, device=dev)
    with pytest.raises(ValueError):
        onehot_split_rows(torch.zeros(8, dtype=torch.int64, device=dev),
                          table)
    with pytest.raises(ValueError):
        onehot_split_rows(torch.zeros(8, dtype=torch.int32, device=dev),
                          table.double())


@pytest.mark.parametrize("scene", ["box", "env-ibl", "box-textured"])
def test_card_frame_matches_cpu_frame(dev, scene):
    import awsm_renderer_tpu_torch as P
    from awsm_renderer_tpu_torch.ops import kernels

    cpu = T.torch_renderer(scene)
    card = T.build(P.AwsmRendererTorch(
        P.RendererConfig(width=T.W, height=T.H), device="cuda"), scene)
    kernels.reset_launch_counts()
    img_card = card.render()
    # K6 serves the image environment's taps; a solid env has none
    # and K4 + K5 the texture taps; an untextured frame has none
    want = dict.fromkeys(kernels.launch_counts, 1)
    want["gather_split_channels"] = int(not card.environment.is_solid)
    textured = scene == "box-textured"
    want["tap_plan_fused"] = want["filter_taps_fused"] = int(textured)
    # the overlay's kernels: no transparent or HUD content here; K9
    # only with MSAA; K11-K13 on no frame path
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
    card (K1, K10, K2's explicit px/py entry, K3) against the same frames
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
                     "resolve_planes_fused"):
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
