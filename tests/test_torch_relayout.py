"""PyTorch port, K3 material fetch and K6 env-tap gather-split: the plain
twins (which the card run holds bit-equal to the CUDA kernels) vs the
JAX functions in their CPU form, bit for bit, out-of-range rows and
indices included; plus the cubemap tap planning that feeds K6."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import _torch_port as T

from awsm_renderer_tpu_torch.ops import cubemap as TC
from awsm_renderer_tpu_torch.ops.relayout import (
    gather_split_channels, gather_split_channels_reference,
    onehot_split_rows, onehot_split_rows_reference,
)


@pytest.mark.parametrize("cap, C, P", [(32, 50, 8192), (5, 3, 1000)])
def test_k3_bit_equal_to_jax(cap, C, P):
    from awsm_renderer_tpu.ops.relayout import onehot_split_rows as jax_k3

    rng = np.random.default_rng(cap)
    table = rng.standard_normal((cap, C)).astype(np.float32)
    rows = rng.integers(-3, cap + 3, P).astype(np.int32)   # some outside
    want = np.stack([np.asarray(c) for c in jax_k3(
        jnp.asarray(rows), jnp.asarray(table), interpret=True)])
    got = onehot_split_rows(torch.as_tensor(rows), torch.as_tensor(table))
    assert got.shape == (C, P) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))
    out = (rows < 0) | (rows >= cap)
    assert out.any() and np.all(got.numpy()[:, out] == 0.0)
    assert torch.equal(got, onehot_split_rows_reference(
        torch.as_tensor(rows), torch.as_tensor(table)))


@pytest.fixture(scope="module")
def env_pool():
    """The env-ibl scene's flushed bf16 texel pool (env rows appended) and
    its env base row."""
    ds = T.torch_renderer("env-ibl")._flush()
    return ds["texels"], ds["env_pool_base"], ds


def test_k6_bit_equal_to_jax(env_pool):
    from awsm_renderer_tpu.ops.relayout import split_channels

    texels, base, _ = env_pool
    rng = np.random.default_rng(2)
    N = texels.shape[0]
    idx = np.concatenate([rng.integers(base, N, 5000),
                          [-7, -1, N, N + 100, 0]]).astype(np.int32)
    u16 = T.to_numpy(texels)
    tex_j = jnp.asarray(u16.view(ml_dtypes.bfloat16))
    q = tex_j[jnp.clip(jnp.asarray(idx), 0, N - 1)][:, :16]
    want = np.stack([np.asarray(c) for c in split_channels(q,
                                                           interpret=True)])
    got = gather_split_channels(texels, torch.as_tensor(idx), 16)
    assert got.shape == (16, idx.size) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))
    assert torch.equal(got, gather_split_channels_reference(
        texels, torch.as_tensor(idx), 16))


def test_cubemap_face_uv_matches_jax():
    from awsm_renderer_tpu.ops.cubemap import _bilinear_setup_c

    rng = np.random.default_rng(4)
    d = rng.standard_normal((3, 4096)).astype(np.float32)
    d[:, :6] = [[1, -1, 0, 0, 0, 0], [0, 0, 1, -1, 0, 0], [0, 0, 0, 0, 1, -1]]
    ji, jfx, jfy = _bilinear_setup_c(tuple(jnp.asarray(c) for c in d), 16)
    ti, tfx, tfy = TC._bilinear_setup_c(tuple(torch.as_tensor(c) for c in d),
                                        16)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tfx.numpy(), np.asarray(jfx), atol=2e-6)
    np.testing.assert_allclose(tfy.numpy(), np.asarray(jfy), atol=2e-6)


def test_env_batch_matches_jax(env_pool):
    """sample_env_batch_c through the texel pool (irradiance, skybox and
    one prefiltered request): bf16 taps are shared, so the blends agree
    to f32 rounding."""
    from awsm_renderer_tpu.ops.cubemap import sample_env_batch_c as jax_env

    texels, base, ds = env_pool
    rng = np.random.default_rng(6)
    P = 4096
    n = rng.standard_normal((3, P)).astype(np.float32)
    v = rng.standard_normal((3, P)).astype(np.float32)
    rough = rng.uniform(0, 1, P).astype(np.float32)
    u16 = T.to_numpy(texels)
    irr, prefs, sky = jax_env(
        jnp.asarray(ds["skybox"]), jnp.asarray(ds["irradiance"]),
        jnp.asarray(ds["prefiltered"]), tuple(jnp.asarray(c) for c in n),
        [(tuple(jnp.asarray(c) for c in v), jnp.asarray(rough))],
        sky_dirs=tuple(jnp.asarray(-c) for c in v),
        texq=jnp.asarray(u16.view(ml_dtypes.bfloat16)), env_base=base)
    t_irr, t_prefs, t_sky = TC.sample_env_batch_c(
        ds["skybox"].shape[0], ds["irradiance"].shape[0],
        ds["prefiltered"].shape[:2], [torch.as_tensor(c) for c in n],
        [([torch.as_tensor(c) for c in v], torch.as_tensor(rough))],
        [torch.as_tensor(-c) for c in v], texels, base)
    for a, b in ((t_irr, irr), (t_prefs[0], prefs[0]), (t_sky, sky)):
        for c in range(4):
            np.testing.assert_allclose(a[c].numpy(), np.asarray(b[c]),
                                       rtol=1e-5, atol=1e-6)
