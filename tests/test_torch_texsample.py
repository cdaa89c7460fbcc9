"""PyTorch port, texture sampling: the plain twins of K4 (tap planner) and
K5 (texel filter) against the JAX Pallas kernels themselves, and the
batched sampler against the JAX sampler, on identical numpy-seeded taps.

The JAX kernels run in Pallas interpret mode: inside each test,
``jax.experimental.pallas.pallas_call`` is wrapped with
``interpret=True`` (the JAX package is not touched).

The taps cover repeat, clamp and mirror wrap, nearest and linear
filtering, nearest and linear mip filtering, anisotropy 1 and 4, NPOT
sizes, a single-level texture, negative and out-of-range uv up to
|uv| = 1e4, KHR_texture_transform rows (scale, offset, an axis swap, one
in the wrap-first atlas mode), unbound transform ids and tex_id < 0.

The uv are dyadic (multiples of 1/1024) and the transforms dyadic, so
every texel coordinate u*n - 0.5 is exact in f32: XLA:CPU contracts
products and sums into FMAs where the twins round each step, and on
inexact coordinates that alone moves weights by an ulp of the texel
coordinate (1e-5 at 256 texels). The gradients are arbitrary floats.

Tolerances. Row indices are equal except at taps whose LOD lies within
1e-5 of an integer, where XLA:CPU's log2 and torch.log2 may floor to
different mips. Weights and filtered rgba agree within 1e-6 absolute."""

import functools

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (torch's share of the cores under xdist)

from awsm_renderer_tpu_torch.core.textures import (
    Sampler, Textures, WRAP_CLAMP, WRAP_MIRROR, WRAP_REPEAT,
)
from awsm_renderer_tpu_torch.ops import texsample as TS

N = 4096


@pytest.fixture
def interpret_pallas(monkeypatch):
    from jax.experimental import pallas as pl

    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


@pytest.fixture(scope="module")
def store():
    return make_store()


def make_store():
    """A texture store with five textures of different sizes, samplers
    and mip counts, plus four texture transforms."""
    rng = np.random.default_rng(21)
    tx = Textures()

    def img(h, w):
        return rng.integers(0, 256, (h, w, 4)).astype(np.uint8)

    tx.add_image(img(64, 64), sampler=Sampler(max_anisotropy=4))
    tx.add_image(img(20, 48), srgb=False, sampler=Sampler(
        wrap_s=WRAP_CLAMP, wrap_t=WRAP_MIRROR, mip_filter_linear=False))
    tx.add_image(img(33, 17), sampler=Sampler(
        wrap_s=WRAP_MIRROR, wrap_t=WRAP_REPEAT, filter_linear=False))
    tx.add_image(img(8, 8), sampler=Sampler(wrap_s=WRAP_CLAMP,
                                            wrap_t=WRAP_CLAMP),
                 generate_mips=False)
    tx.add_image(img(128, 96), sampler=Sampler(wrap_s=WRAP_REPEAT,
                                               wrap_t=WRAP_CLAMP))
    tx.add_texture_transform(offset=(0.25, -0.5), scale=(2.0, 0.5))
    tx.add_texture_transform(scale=(1 / 64, 1 / 64))
    k = tx.add_texture_transform(offset=(0.5, 0.25), scale=(0.25, 0.25))
    tx.tex_transforms[tx.transform_row_of(k), 6] = 1.0     # wrap first
    k = tx.add_texture_transform()
    tx.tex_transforms[tx.transform_row_of(k), :6] = [0, 1, -1, 0, 0.125,
                                                     0.75]  # axis swap
    return tx


def _taps(seed):
    """numpy taps: tex_id in [-1, 4], dyadic uv over [-3, 4] with
    boundary values and a few |uv| up to 1e4, gradients over six decades,
    tform ids in [-1, 3]."""
    rng = np.random.default_rng(seed)
    tex_id = rng.integers(-1, 5, N).astype(np.int32)
    u = (rng.integers(-3 * 1024, 4 * 1024, N) / 1024).astype(np.float32)
    v = (rng.integers(-3 * 1024, 4 * 1024, N) / 1024).astype(np.float32)
    edge = np.array([0.0, 1.0, 0.5, -1.0, 2.0, -0.25, 1e4, -1e4, 9999.5],
                    np.float32)
    u[:edge.size] = edge
    v[:edge.size] = edge[::-1]
    u[edge.size:40] = rng.integers(-10000, 10000, 40 - edge.size) + 0.25
    mag = 10.0 ** rng.uniform(-6.0, 0.0, (4, N))
    duv = (mag * rng.choice([-1.0, 1.0], (4, N))).astype(np.float32)
    duv[:, 40:60] = 0.0
    tform = rng.integers(-1, 4, N).astype(np.int32)
    return tex_id, u, v, duv, tform


def _jax_pool(store):
    return jnp.asarray(store.texels_packed.view(ml_dtypes.bfloat16))


def _port_pool(store):
    return torch.from_numpy(store.texels_packed.view(np.int16).copy()).view(
        torch.bfloat16)


def _near_integer_lod(store, tex_id, u, v, duv, tform):
    """Taps whose LOD (after the transform) lies within 1e-5 of an
    integer."""
    t = torch.as_tensor
    uu, vv, d = TS.apply_texture_transform_with_grads_c(
        t(store.tex_transforms), t(tform), t(u), t(v),
        tuple(t(c) for c in duv))
    desc = t(store.descriptors).index_select(
        0, t(tex_id).clamp(0, store.descriptors.shape[0] - 1).long())
    lv = TS._mip_level(desc, d).numpy()
    return np.abs(lv - np.round(lv)) < 1e-5


@pytest.mark.parametrize("mips, tform, nearest", [
    (False, False, True), (True, False, False), (True, True, True),
    (False, True, False)])
def test_tap_plan_twin_matches_jax_kernel(interpret_pallas, store, mips,
                                          tform, nearest):
    from awsm_renderer_tpu.ops.texsample import _tap_plan_fused

    tex_id, u, v, duv, tf = _taps(1 + 2 * mips + tform)
    j_idx, j_w = _tap_plan_fused(
        jnp.asarray(tex_id), jnp.asarray(u), jnp.asarray(v),
        tuple(jnp.asarray(c) for c in duv) if mips else None,
        jnp.asarray(store.descriptors), has_nearest=nearest,
        tform_id=jnp.asarray(tf) if tform else None,
        tex_transforms=jnp.asarray(store.tex_transforms) if tform else None)
    t = torch.as_tensor
    p_idx, p_w = TS.tap_plan_fused(
        t(tex_id), t(u), t(v), tuple(t(c) for c in duv) if mips else None,
        t(store.descriptors), has_nearest=nearest,
        tform_id=t(tf) if tform else None,
        tex_transforms=t(store.tex_transforms) if tform else None)
    j_idx = np.asarray(j_idx)
    j_w = np.stack([np.asarray(w) for w in j_w])
    assert p_idx.dtype == torch.int32 and p_w.shape == (11, N)
    diff = p_idx.numpy() != j_idx
    if mips:
        boundary = _near_integer_lod(store, tex_id, u, v, duv,
                                     tf if tform else np.full(N, -1,
                                                              np.int32))
        assert not (diff & ~boundary).any(), np.nonzero(diff & ~boundary)
        ok = ~boundary
    else:
        assert not diff.any()
        ok = np.ones(N, bool)
    np.testing.assert_allclose(p_w.numpy()[:, ok], j_w[:, ok], rtol=0,
                               atol=1e-6)
    # the taps exercise what they claim to
    assert (j_w[10] > 0).any() == mips
    if nearest:
        snapped = np.isin(j_w[:4][:, tex_id == 2], (0.0, 1.0)).all()
        assert snapped


@pytest.mark.parametrize("mips", [False, True])
def test_filter_taps_twin_matches_jax_kernel(interpret_pallas, store, mips):
    from awsm_renderer_tpu.ops.texsample import _filter_taps_fused

    rng = np.random.default_rng(5 + mips)
    R = store.texels_packed.shape[0]
    idx = rng.integers(-8, R + 8, N).astype(np.int32)
    w = rng.uniform(0.0, 1.0, (11, N)).astype(np.float32)
    q = _jax_pool(store)[jnp.clip(jnp.asarray(idx), 0, R - 1)]
    want = _filter_taps_fused(q, [jnp.asarray(c) for c in w], mips=mips)
    got = TS.filter_taps_fused(_port_pool(store), torch.as_tensor(idx),
                               torch.as_tensor(w), mips=mips)
    assert got.shape == (4, N)
    np.testing.assert_allclose(got.numpy(), np.stack(
        [np.asarray(c) for c in want]), rtol=0, atol=1e-6)


@pytest.mark.parametrize("mips", [False, True])
def test_sample_texture_batch_matches_jax(store, mips):
    """Three taps per pixel (one with transforms) through the port's one
    plan + one filter against the JAX sampler (its interpret-mode path);
    tex_id < 0 gives white."""
    from awsm_renderer_tpu.ops.texsample import sample_texture_batch_c

    P = N // 4
    taps_np = [_taps(40 + k) for k in range(3)]
    t = torch.as_tensor

    def taps(conv):
        out = []
        for k, (tid, u, v, duv, tf) in enumerate(taps_np):
            d = tuple(conv(c[:P]) for c in duv) if mips else None
            out.append((conv(tid[:P]), (conv(u[:P]), conv(v[:P])), d,
                        conv(tf[:P]) if k == 1 else None))
        return out

    want = sample_texture_batch_c(
        _jax_pool(store), jnp.asarray(store.descriptors), taps(jnp.asarray),
        has_nearest=True, tex_transforms=jnp.asarray(store.tex_transforms))
    got = TS.sample_texture_batch_c(
        _port_pool(store), t(store.descriptors), taps(t), has_nearest=True,
        tex_transforms=t(store.tex_transforms))
    for k, (g, w) in enumerate(zip(got, want)):
        g = np.stack([c.numpy() for c in g])
        w = np.stack([np.asarray(c) for c in w])
        unbound = taps_np[k][0][:P] < 0
        assert (g[:, unbound] == 1.0).all()
        ok = ~unbound
        if mips:
            tf = taps_np[k][4][:P] if k == 1 else np.full(P, -1, np.int32)
            ok &= ~_near_integer_lod(store, *[a[:P] for a in taps_np[k][:3]],
                                     taps_np[k][3][:, :P], tf)
        np.testing.assert_allclose(g[:, ok], w[:, ok], rtol=0, atol=1e-6,
                                   err_msg=f"tap {k}")


def test_mixed_mip_taps_refused(store):
    t = torch.as_tensor
    tid, u, v, duv, _ = _taps(9)
    taps = [(t(tid), (t(u), t(v)), None),
            (t(tid), (t(u), t(v)), tuple(t(c) for c in duv))]
    with pytest.raises(ValueError, match="gradients"):
        TS.sample_texture_batch_c(_port_pool(store), t(store.descriptors),
                                  taps)


def test_sample_texture_aos_matches_jax(store):
    """The AoS wrappers: base level, and an explicit mip level."""
    from awsm_renderer_tpu.ops import texsample as JT

    tid, u, v, _, _ = _taps(13)
    uv = np.stack([u, v], -1)
    level = np.random.default_rng(2).uniform(-1.0, 8.0, N).astype(
        np.float32)
    t = torch.as_tensor
    for lv in (None, level):
        want = np.asarray(JT.sample_texture(
            _jax_pool(store), jnp.asarray(store.descriptors),
            jnp.asarray(tid), jnp.asarray(uv),
            None if lv is None else jnp.asarray(lv)))
        got = TS.sample_texture(_port_pool(store), t(store.descriptors),
                                t(tid), t(uv), None if lv is None else t(lv))
        ok = np.ones(N, bool) if lv is None else \
            np.abs(level - np.round(level)) > 1e-5
        np.testing.assert_allclose(got.numpy()[ok], want[ok], rtol=0,
                                   atol=1e-6)
