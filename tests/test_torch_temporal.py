"""PyTorch port, temporal reuse (TAA): the history packing, reprojection
offsets, unit anchors, K10 (here its plain twin, which the card run holds
bit-equal to the CUDA kernel), the unit choice, the temporal resolve, the
compacted shade at coord_scale 1 and the temporal renderer — against the
JAX package (its K10 in interpret mode).

Criteria. pack_history / reset_history are bit-equal (the tid plane
holds int32 bits: the -2 sentinel is a NaN pattern, small ids are float
denormals). temporal_offsets within 2e-4 px / 1e-6 in exp_z relative to
the terms' magnitude: XLA:CPU contracts the matrix products into FMAs.
_unit_scalars equal except at units whose mean offset lies within
rounding of a half-integer (XLA and torch sum the 1,024 pixels in other
orders, and the mean then rounds the other way). The K10 twin is
bit-equal to JAX's kernel on inputs whose unit means lie away from x.5,
in both window regimes (128 px wide: the reference's roll branch; >= 384
px: the rotated window), at clamped border units and with 1e6, +-inf and
NaN offsets. select_units' indices are equal. temporal_merge's colours
are within 1e-6 (XLA:CPU FMA-contracts the blend), its history tid and
depth planes and coverage bit-equal. shade_units_c at coord_scale 1
holds tests/test_torch_shade.py's 1e-4. The temporal renderers choose
the same units on every frame of a reset plus 4 orbit frames, their
images agree within the goldens' tolerance (< 0.5% of channel values off
by more than 4/255), their histories' tid planes on >= 99.5% of pixels
and colours within 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port as T

from awsm_renderer_tpu_torch.ops import temporal as TT

F = np.float32


def _t(a):
    return torch.from_numpy(np.array(a))


def _bits(a):
    return np.asarray(a).view(np.uint32)


def _jax_history(r, g, b, tid, depth):
    from awsm_renderer_tpu.ops.temporal import pack_history

    H, W = tid.shape
    return np.asarray(pack_history(*(jnp.asarray(x) for x in
                                     (r, g, b, tid, depth)), H, W))


def test_pack_and_reset_history_bit_equal():
    from awsm_renderer_tpu.ops.temporal import reset_history

    rng = np.random.default_rng(1)
    H, W = 16, 128
    r, g, b, depth = (rng.random((H, W)).astype(F) for _ in range(4))
    # the -2 sentinel (a NaN pattern), the -1 miss, denormal-pattern ids,
    # ids near the int32 limits
    tid = rng.choice(np.array([-2, -1, 0, 1, 7, 4095, 2 ** 23 + 5,
                               2 ** 31 - 1, -2 ** 31], np.int64),
                     (H, W)).astype(np.int32)
    want = _jax_history(r, g, b, tid, depth)
    got = TT.pack_history(_t(r), _t(g), _t(b), _t(tid), _t(depth), H, W)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    np.testing.assert_array_equal(got.numpy()[3].view(np.int32), tid)
    np.testing.assert_array_equal(
        _bits(TT.reset_history(H, W, "cpu").numpy()),
        _bits(reset_history(H, W)))


def _cam(eye0, eye1, W, H):
    """The camera entries temporal_offsets reads: the current unjittered
    inverse view-projection (eye1) and the previous one (eye0)."""
    from awsm_renderer_tpu.utils import math3d as m3

    proj = m3.perspective(np.pi / 3, W / H, 0.1, 100.0)
    vp0 = (proj @ m3.look_at(eye0, [0, 0, 0], [0, 1, 0])).astype(F)
    vp1 = (proj @ m3.look_at(eye1, [0, 0, 0], [0, 1, 0])).astype(F)
    return {"inv_view_proj_nj": np.linalg.inv(vp1.astype(np.float64))
            .astype(F), "prev_view_proj": vp0}


@pytest.mark.parametrize("move", ["orbit", "behind"])
def test_temporal_offsets_match_jax(move):
    from awsm_renderer_tpu.ops.temporal import temporal_offsets

    W, H = 256, 64
    rng = np.random.default_rng(2)
    # "behind": the previous camera sits on the far side of the scene,
    # so some points lie behind it (offsets of 1e6)
    eye0 = [0.4, 0.6, 3.0] if move == "orbit" else [0.3, 0.5, -3.0]
    cam = _cam(eye0, [0.0, 0.5, 3.0], W, H)
    depth = rng.uniform(0.2, 1.0, (H, W)).astype(F)
    depth[:4] = 1.0
    want = temporal_offsets({k: jnp.asarray(v) for k, v in cam.items()},
                            jnp.asarray(depth), width=W, height=H)
    got = TT.temporal_offsets(cam, _t(depth), width=W, height=H)
    big = [np.asarray(w) == 1e6 for w in want[:2]]
    for a, w, bb in zip(got[:2], want[:2], big):
        np.testing.assert_array_equal(a.numpy() == 1e6, bb)
        np.testing.assert_allclose(a.numpy()[~bb], np.asarray(w)[~bb],
                                   rtol=0, atol=2e-4)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=1e-5, atol=1e-6)
    if move == "behind":
        assert big[0].any() and (~big[0]).any()
    else:
        assert np.abs(np.asarray(want[0])).max() > 0.5


def _unit_means(p, H, W):
    return p.astype(np.float64).reshape(H // 8, 8, W // 128, 128).mean(
        axis=(1, 3)).reshape(-1)


def _near_half(p, H, W):
    """Units whose f64 mean offset lies within summation rounding of a
    half-integer (hazard: the mean may round either way)."""
    m = _unit_means(p, H, W)
    mag = np.abs(p).astype(np.float64).reshape(H // 8, 8, W // 128, 128)
    tol = 2e-6 * np.maximum(1.0, mag.mean(axis=(1, 3)).reshape(-1))
    with np.errstate(invalid="ignore"):
        return np.abs(m - np.floor(m) - 0.5) < tol


def _special_offsets(rng, H, W, base):
    """Per-unit offsets `base` (n_ty, n_tx) + per-pixel noise, with
    special pixels: one unit's pixel at 1e6, one at +inf, one at -inf,
    one NaN, one unit whose mean is 5e4 (ok) and one at 2e5 (not ok)."""
    n_ty, n_tx = H // 8, W // 128
    o = (np.repeat(np.repeat(base, 8, 0), 128, 1)
         + rng.uniform(-1.2, 1.2, (H, W))).astype(F)
    units = rng.permutation(n_ty * n_tx)[:6]
    for u, val in zip(units, (1e6, np.inf, -np.inf, np.nan, None, None)):
        y0, x0 = (u // n_tx) * 8, (u % n_tx) * 128
        if val is None:
            continue
        o[y0 + 3, x0 + 17] = val
    for u, val in zip(units[4:], (5e4, 2e5)):
        y0, x0 = (u // n_tx) * 8, (u % n_tx) * 128
        o[y0:y0 + 8, x0:x0 + 128] = val
    return o


def _k10_case(case, size=None):
    """(hist, off_x, off_y, exp_z, cur_tid) numpy inputs of a K10 case, at
    its own (W, H) or at `size`."""
    rng = np.random.default_rng(K10_CASES.index(case))
    W, H = size or ((512, 64) if case in ("wide", "border", "special")
                    else (128, 32))
    tids = rng.integers(0, 50, (H, W)).astype(np.int32)
    r, g, b = (rng.random((H, W)).astype(F) for _ in range(3))
    depth = (rng.random((H, W)) * 0.5 + 0.25).astype(F)
    zeros = np.zeros((H, W), F)
    if case == "identity":
        return _jax_history(r, g, b, tids, depth), zeros, zeros, depth, tids
    if case == "shift":
        ys = np.clip(np.arange(H)[:, None] + 1, 0, H - 1)
        xs = np.clip(np.arange(W)[None, :] + 1, 0, W - 1)
        ones = np.ones((H, W), F)
        return (_jax_history(r, g, b, tids, depth), ones, ones,
                depth[ys, xs], tids[ys, xs])
    if case == "mismatch":
        return (_jax_history(r, g, b, tids, depth), zeros, zeros, depth,
                tids + 1)
    if case == "reset":
        from awsm_renderer_tpu.ops.temporal import reset_history

        return (np.asarray(reset_history(H, W)), zeros, zeros, zeros,
                np.zeros((H, W), np.int32))
    # random unit-varying offsets; history ids include the -2 sentinel
    # and the -1 miss
    tids[rng.uniform(size=(H, W)) < 0.1] = -2
    tids[rng.uniform(size=(H, W)) < 0.1] = -1
    n_ty, n_tx = H // 8, W // 128
    base_y = rng.integers(-4, 5, (n_ty, n_tx)) + rng.uniform(-0.3, 0.3,
                                                             (n_ty, n_tx))
    base_x = rng.integers(-4, 5, (n_ty, n_tx)) + rng.uniform(-0.3, 0.3,
                                                             (n_ty, n_tx))
    if case == "border":       # outward motion at every image border
        base_y[0], base_y[-1] = -7.2, 6.8
        base_x[:, 0], base_x[:, -1] = -6.9, 7.1
    if case == "special":
        off_x = _special_offsets(rng, H, W, base_x)
        off_y = _special_offsets(rng, H, W, base_y)
    else:
        off_x = (np.repeat(np.repeat(base_x, 8, 0), 128, 1)
                 + rng.uniform(-1.2, 1.2, (H, W))).astype(F)
        off_y = (np.repeat(np.repeat(base_y, 8, 0), 128, 1)
                 + rng.uniform(-1.2, 1.2, (H, W))).astype(F)
    ry = np.clip(np.floor(np.arange(H)[:, None] + off_y + 0.5), 0, H - 1)
    rx = np.clip(np.floor(np.arange(W)[None, :] + off_x + 0.5), 0, W - 1)
    ry = np.nan_to_num(ry).astype(np.int64)
    rx = np.nan_to_num(rx).astype(np.int64)
    # 80% of pixels find their own id and a depth within tolerance
    exp_z = (depth[ry, rx] + rng.uniform(-3e-4, 3e-4, (H, W))).astype(F)
    cur = np.where(rng.uniform(size=(H, W)) < 0.8, tids[ry, rx],
                   rng.integers(0, 50, (H, W))).astype(np.int32)
    return _jax_history(r, g, b, tids, depth), off_x, off_y, exp_z, cur


K10_CASES = ("identity", "shift", "mismatch", "reset", "narrow", "wide",
             "border", "special")
PARITY_SCENES = ("box", "alpha-blend")
N_ORBIT = 4
UNITS_SCENE = "box-textured"


def _jax_k10():
    """{case: (inputs, JAX reproject_history outputs, JAX scalars)}."""
    from awsm_renderer_tpu.ops.temporal import (
        _unit_scalars, reproject_history,
    )

    out = {}
    for case in K10_CASES:
        args = _k10_case(case)
        H, W = args[4].shape
        res = reproject_history(*(jnp.asarray(a) for a in args), width=W,
                                height=H, interpret=True)
        scal = _unit_scalars(jnp.asarray(args[1]), jnp.asarray(args[2]),
                             width=W, height=H, win_h=min(24, H),
                             win_w=min(384, W))
        out[case] = (args, [np.asarray(x) for x in res], np.asarray(scal))
    return out


def _units_inputs(scene):
    """shade_units_c's inputs on the JAX renderer's flushed scene state:
    (JAX device dict, the port's copy of it, shading specialization,
    setup rows, tid_c, dep_c, idx) over six of the 8 x 1 (8, 128) units,
    ids and depths from the port's K1 twin."""
    from awsm_renderer_tpu_torch import device_scene_from_jax
    from awsm_renderer_tpu_torch.ops.raster import rasterize16_slim
    from awsm_renderer_tpu_torch.ops.shade import _tile_swizzle
    from awsm_renderer_tpu_torch.passes.frame import _run_vertex

    rj = T.jax_renderer(scene)
    dj = rj._flush()
    ds = device_scene_from_jax(T.to_numpy(dict(dj)), "cpu")
    masks = rj._mesh_masks()
    op_rows = rj._bucket_mat_rows(masks["opaque"])
    spec = dict(use_mips=True, slot_mask=rj._slot_mask(op_rows),
                solid_env=rj.environment.is_solid,
                ext=rj._ext_mask(op_rows), has_nearest=False,
                debug_mode="none")
    srows = _run_vertex(ds, torch.as_tensor(masks["opaque"]), rw=T.W,
                        rh_full=T.H, needs_clip=masks["needs_clip"], pad=True)
    col, depth, _ = rasterize16_slim(srows, width=T.W, height=T.H)
    idx = torch.tensor([3, 0, 4, 2, 5, 7])
    n = idx.shape[0] * 1024
    tid_c = _tile_swizzle(col, T.H, T.W).index_select(0, idx).reshape(n)
    dep_c = _tile_swizzle(depth, T.H, T.W).index_select(0, idx).reshape(n)
    return dj, ds, spec, srows, tid_c, dep_c, idx


def _jax_units(inputs):
    from awsm_renderer_tpu.ops.shade import shade_units_c

    dj, _ds, spec, srows, tid_c, dep_c, idx = inputs
    fn = jax.jit(shade_units_c, static_argnames=(
        "width", "height_full", "row_offset", "resolve_row_offset",
        "coord_scale", "th", "use_mips", "slot_mask", "solid_env",
        "has_nearest", "ext", "debug_mode", "interpret"))
    out, valid = fn(jnp.asarray(tid_c.numpy()), jnp.asarray(dep_c.numpy()),
                    jnp.asarray(idx.numpy().astype(np.int32)),
                    jnp.asarray(srows.numpy()), dj, width=T.W,
                    height_full=T.H, row_offset=0, resolve_row_offset=0,
                    coord_scale=1, th=8, interpret=True, **spec)
    return [np.asarray(c) for c in out], np.asarray(valid)


def _orbit(r, i):
    from awsm_renderer_tpu.utils import math3d as m3

    a = 0.6 + 0.03 * i
    r.camera.update(m3.look_at([3.5 * np.sin(a), 1.8, 3.5 * np.cos(a)],
                               [0, 0, 0], [0, 1, 0]),
                    m3.perspective(np.pi / 3, T.W / T.H, 0.05, 500.0))


def _run_orbit(r):
    """A reset frame and N_ORBIT orbit frames: per frame (image, unit
    ages, history as numpy, tri_id)."""
    out = []
    for i in range(N_ORBIT + 1):
        _orbit(r, i)
        img = r.render()
        st = r._temporal
        out.append((img, T.to_numpy(st["age"]), T.to_numpy(st["hist"]),
                    T.to_numpy(r._last_tri_id)))
    return out


@pytest.fixture(scope="module")
def jax_side():
    """Every JAX result the module compares with, computed in threads
    started together (XLA compiles without the GIL; the temporal
    renderers' reset and steady frame compiles take most of the time).
    Yields get(key) for key "orbit/<scene>", "k10" or "units"."""
    from concurrent.futures import ThreadPoolExecutor

    from awsm_renderer_tpu import AntiAliasing

    renderers = {s: T.jax_renderer(s, anti_aliasing=AntiAliasing(
        temporal=True)) for s in PARITY_SCENES}
    with ThreadPoolExecutor(len(PARITY_SCENES) + 2) as ex:
        futs = {f"orbit/{s}": ex.submit(_run_orbit, r)
                for s, r in renderers.items()}
        futs["k10"] = ex.submit(_jax_k10)
        futs["units"] = ex.submit(_jax_units, _units_inputs(UNITS_SCENE))
        yield lambda key: futs[key].result()


@pytest.mark.parametrize("case", K10_CASES)
def test_unit_scalars_match_jax(jax_side, case):
    args, _res, want = jax_side("k10")[case]
    H, W = args[4].shape
    got = TT._unit_scalars(_t(args[1]), _t(args[2]), width=W, height=H,
                           win_h=min(24, H), win_w=min(384, W)).numpy()
    assert got.dtype == np.int32 and got.shape == want.shape
    exempt = _near_half(args[1], H, W) | _near_half(args[2], H, W)
    np.testing.assert_array_equal(got[~exempt], want[~exempt])
    assert exempt.mean() < 0.05
    if case == "special":
        assert (want[:, 4] == 0).sum() >= 5 and (want[:, 4] == 1).any()
    if case == "border":      # the clamps bind at the borders
        assert (want[:, 0] == 0).any() and (want[:, 2] == 0).any()


@pytest.mark.parametrize("case", K10_CASES)
def test_k10_twin_bit_equal_to_jax(jax_side, case):
    """The twin on the port's own scalars against JAX's kernel; the
    cases' unit means lie away from x.5, so the scalars agree."""
    args, want, _ = jax_side("k10")[case]
    H, W = args[4].shape
    for p in args[1:3]:
        assert not _near_half(p, H, W).any()
    got = TT.reproject_history(*(_t(a) for a in args), width=W, height=H)
    for k in range(3):
        np.testing.assert_array_equal(_bits(got[k].numpy()), _bits(want[k]),
                                      err_msg=f"rep {k}")
    np.testing.assert_array_equal(got[3].numpy(), want[3], "valid")
    np.testing.assert_array_equal(got[4].numpy(), want[4], "blendable")
    valid, blend = want[3], want[4]
    if case in ("identity", "shift"):
        assert valid.mean() > 0.7
    if case in ("mismatch", "reset"):
        assert not valid.any()
        assert blend.all() == (case == "mismatch")
    if case in ("narrow", "wide", "border", "special"):
        assert 0.1 < valid.mean() < blend.mean() < 1.0


def test_k10_wrapper_planes_equal_twin():
    """On CPU tensors the kernel wrapper is the twin."""
    args = [_t(a) for a in _k10_case("wide")]
    H, W = args[4].shape
    scal = TT._unit_scalars(args[1], args[2], width=W, height=H)
    a = TT.reproject_history_planes(*args, scal)
    b = TT.reproject_history_reference(*args, scal)
    for x, y in zip(a, b):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))


@pytest.mark.parametrize("case", ["reset", "mixed", "ties"])
def test_select_units_equal_jax(case):
    from awsm_renderer_tpu.ops.temporal import select_units

    rng = np.random.default_rng(5)
    H, W = 64, 512
    n = (H // 8) * (W // 128)
    valid = rng.uniform(size=H * W) < 0.9997     # a few invalid units
    if case == "reset":
        age = np.full(n, 1 << 20, np.int32)
        valid[:] = False
    elif case == "mixed":
        age = rng.integers(0, 40, n).astype(np.int32)
        age[:3] = 0
    else:
        age = rng.integers(0, 3, n).astype(np.int32)
    for cap in (1, 7, n, n + 5):
        ji, js = select_units(jnp.asarray(valid), jnp.asarray(age),
                              width=W, height=H, shade_cap=cap)
        ti, ts = TT.select_units(_t(valid), _t(age), width=W, height=H,
                                 shade_cap=cap)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_temporal_merge_matches_jax():
    from awsm_renderer_tpu.ops.temporal import temporal_merge

    rng = np.random.default_rng(9)
    H, W = 32, 256
    P = H * W
    new_c = [rng.random(P).astype(F) for _ in range(3)]
    rep_c = [rng.random(P).astype(F) * 1.5 for _ in range(3)]
    # shaded (8, 128) units, as the frame's
    unit = rng.uniform(size=(H // 8, W // 128)) < 0.5
    shaded = np.repeat(np.repeat(unit, 8, 0), 128, 1).reshape(P)
    valid = rng.uniform(size=P) < 0.6
    blend = valid | (rng.uniform(size=P) < 0.3)
    tid = rng.integers(-1, 30, (H, W)).astype(np.int32)
    hist = _jax_history(*(rng.random((H, W)).astype(F) for _ in range(3)),
                        tid, rng.random((H, W)).astype(F))
    cur = rng.integers(-1, 30, P).astype(np.int32)
    depth = rng.random(P).astype(F)
    kw = dict(width=W, height=H, alpha=0.12)
    jo, jh, jc = temporal_merge(
        [jnp.asarray(c) for c in new_c], jnp.asarray(shaded),
        [jnp.asarray(c) for c in rep_c], jnp.asarray(valid),
        jnp.asarray(blend), jnp.asarray(hist), jnp.asarray(cur),
        jnp.asarray(depth), **kw)
    to, th, tc = TT.temporal_merge(
        [_t(c) for c in new_c], _t(shaded), [_t(c) for c in rep_c],
        _t(valid), _t(blend), _t(hist), _t(cur), _t(depth), **kw)
    jh = np.asarray(jh)
    for c in range(3):
        np.testing.assert_allclose(to[c].numpy(), np.asarray(jo[c]), rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(th.numpy()[c], jh[c], rtol=0, atol=1e-6)
    for c in (3, 4):
        np.testing.assert_array_equal(_bits(th.numpy()[c]), _bits(jh[c]))
    np.testing.assert_array_equal(_bits(tc.numpy()), _bits(jc))
    assert (th.numpy()[3].view(np.int32) == -2).any()


def test_shade_units_coord_scale_1_matches_jax(jax_side):
    """shade_units_c at display resolution (the temporal frame's) on
    identical winner / depth planes and scene state (a textured box)."""
    from awsm_renderer_tpu_torch.ops.shade import ShadeSpec, shade_units_c

    want, wvalid = jax_side("units")
    _dj, ds, spec, srows, tid_c, dep_c, idx = _units_inputs(UNITS_SCENE)
    got, gvalid = shade_units_c(tid_c, dep_c, idx, srows, ds,
                                ShadeSpec(**spec), width=T.W, height=T.H,
                                coord_scale=1)
    np.testing.assert_array_equal(gvalid.numpy(), wvalid)
    assert gvalid.numpy().sum() > 300 and (~gvalid.numpy()).sum() > 300
    assert any(spec["slot_mask"])
    for c in range(3):
        np.testing.assert_allclose(got[c].numpy(), want[c], rtol=1e-4,
                                   atol=1e-4, err_msg=f"channel {c}")


@pytest.mark.parametrize("scene", PARITY_SCENES)
def test_temporal_renderer_matches_jax(jax_side, scene):
    import awsm_renderer_tpu_torch as P

    rt = T.torch_renderer(scene, anti_aliasing=P.AntiAliasing(temporal=True))
    n_units = (T.H // 8) * (T.W // 128)
    frames = zip(jax_side(f"orbit/{scene}"), _run_orbit(rt))
    for i, ((lj, aj, hj, tj), (lt, at, ht, tt)) in enumerate(frames):
        # the same units chosen: equal ages (0 = shaded this frame)
        np.testing.assert_array_equal(at, aj, f"frame {i}")
        assert (at == 0).sum() == (n_units if i == 0 else 1)
        assert np.isfinite(lt).all()
        diff = np.abs(np.round(lt * 255) - np.round(lj * 255))
        assert (diff > 4).mean() < 0.005, (i, (diff > 4).mean())
        assert (tt != tj).mean() < 0.005
        assert (ht[3].view(np.int32) != hj[3].view(np.int32)).mean() < 0.005
        np.testing.assert_allclose(ht[:3], hj[:3], rtol=0, atol=1e-4)
        assert (tj >= 0).sum() > 200


# ---- JAX's renderer tests (tests/test_temporal.py) on the port -----------

W2, H2 = 128, 32


def _make(temporal, **kw):
    import awsm_renderer_tpu_torch as P
    from awsm_renderer_tpu_torch.utils import math3d as m3

    cfg = P.RendererConfig(
        width=W2, height=H2, anti_aliasing=P.AntiAliasing(temporal=temporal),
        post_processing=P.PostProcessing(tonemapping=P.ToneMapping.NONE),
        **kw)
    r = P.AwsmRendererTorch(cfg, device="cpu")
    r.camera.update(m3.look_at([0, 0.5, 3], [0, 0, 0], [0, 1, 0]),
                    m3.perspective(np.pi / 3, W2 / H2, 0.1, 100.0))
    return r


def _unlit(P, rgb):
    return P.UnlitMaterial(base_color_factor=np.array([*rgb, 1], F))


def test_temporal_offsets_static_camera_zero():
    from awsm_renderer_tpu_torch.utils import math3d as m3

    view = m3.look_at([0, 0.5, 3], [0, 0, 0], [0, 1, 0])
    proj = m3.perspective(np.pi / 3, W2 / H2, 0.1, 100.0)
    vp = (proj @ view).astype(F)
    cam = {"inv_view_proj_nj": np.linalg.inv(vp.astype(np.float64))
           .astype(F), "prev_view_proj": vp}
    off_x, off_y, exp_z = TT.temporal_offsets(
        cam, torch.full((H2, W2), 0.5), width=W2, height=H2)
    assert float(off_x.abs().max()) < 1e-2
    assert float(off_y.abs().max()) < 1e-2
    np.testing.assert_allclose(exp_z.numpy(), 0.5, atol=1e-4)


def test_temporal_static_converges_to_plain():
    """A static converged temporal frame equals the non-temporal frame
    away from silhouettes."""
    import awsm_renderer_tpu_torch as P
    from awsm_renderer_tpu_torch.geometry import box

    rt = _make(True)
    rt.add_mesh(box(), rt.materials.insert(P.PbrMaterial()))
    for _ in range(8):
        img = rt.render()
    rp = _make(False)
    rp.add_mesh(box(), rp.materials.insert(P.PbrMaterial()))
    ref = rp.render()
    err = np.abs(img[..., :3] - ref[..., :3])
    assert np.isfinite(img).all()
    assert err.mean() < 2e-3
    assert np.percentile(err, 95) < 1e-2
    assert err.max() < 0.6


def test_temporal_camera_motion_stays_correct():
    """Orbiting keeps the temporal frame close to a fresh non-temporal
    render of the same view (reprojection + invalid-unit reshading)."""
    import awsm_renderer_tpu_torch as P
    from awsm_renderer_tpu_torch.geometry import box
    from awsm_renderer_tpu_torch.utils import math3d as m3

    rt = _make(True)
    rt.add_mesh(box(), rt.materials.insert(_unlit(P, (1, 0, 0))))
    rt.render()
    proj = m3.perspective(np.pi / 3, W2 / H2, 0.1, 100.0)
    for i in range(1, 5):
        ang = 0.03 * i
        eye = [3 * np.sin(ang), 0.5, 3 * np.cos(ang)]
        rt.camera.update(m3.look_at(eye, [0, 0, 0], [0, 1, 0]), proj)
        img = rt.render()
    rp = _make(False)
    rp.add_mesh(box(), rp.materials.insert(_unlit(P, (1, 0, 0))))
    rp.camera.update(m3.look_at(eye, [0, 0, 0], [0, 1, 0]), proj)
    ref = rp.render()
    err = np.abs(img[..., :3] - ref[..., :3])
    assert np.isfinite(img).all()
    assert err.mean() < 5e-3
    assert (err.max(axis=-1) > 0.25).mean() < 0.03


def test_temporal_content_change_resets_history():
    """A material edit resets the history: the next frame shows the new
    material everywhere at once, with no red left anywhere."""
    import awsm_renderer_tpu_torch as P
    from awsm_renderer_tpu_torch.geometry import box

    rt = _make(True)
    mat = rt.materials.insert(_unlit(P, (1, 0, 0)))
    rt.add_mesh(box(), mat)
    for _ in range(3):
        rt.render()
    epoch = rt._temporal["epoch"]
    rt.materials.update(mat, _unlit(P, (0, 1, 0)))
    img = rt.render()
    assert rt._temporal["epoch"] == epoch + 1
    np.testing.assert_allclose(img[H2 // 2, W2 // 2, :3], [0, 1, 0],
                               atol=1e-5)
    assert (img[..., 0] > 0.5).sum() == 0 and img[..., 1].max() > 0.9


def test_temporal_pick_still_works():
    import awsm_renderer_tpu_torch as P
    from awsm_renderer_tpu_torch.geometry import box

    rt = _make(True)
    key = rt.add_mesh(box(), rt.materials.insert(P.UnlitMaterial()))
    rt.render()
    assert rt._temporal is not None
    assert rt.pick(W2 // 2, H2 // 2) == key
    assert rt.pick(2, 2) is None
