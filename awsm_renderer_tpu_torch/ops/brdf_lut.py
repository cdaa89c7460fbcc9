"""Split-sum BRDF lookup table, generated once per (size, samples, device).

Port of awsm_renderer_tpu/ops/brdf_lut.py (the reference's GPU-generated
BRDF LUT, crates/renderer-core/src/brdf_lut/generate.rs:24-60 +
brdf_lut/shader.wgsl: split-sum integration). The per-sample terms are
computed for a chunk of importance samples at a time, then added to the
accumulators one sample after another, in the reference scan's order
(so the sums round as a sequential scan does; the terms themselves may
differ from XLA's by an ulp where it contracts into FMAs). No frame path
reads the table: the renderer builds it once, as the reference does.
"""

from __future__ import annotations

import functools
import math

import torch

_CHUNK = 64     # importance samples whose terms are computed at once


def _hammersley(samples: int, device):
    """(xi1, xi2) of the Hammersley sequence: i / N and the radical
    inverse of i by bit reversal."""
    i = torch.arange(samples, dtype=torch.int64, device=device)
    bits = i
    bits = ((bits << 16) | (bits >> 16)) & 0xFFFFFFFF
    bits = ((bits & 0x55555555) << 1) | ((bits & 0xAAAAAAAA) >> 1)
    bits = ((bits & 0x33333333) << 2) | ((bits & 0xCCCCCCCC) >> 2)
    bits = ((bits & 0x0F0F0F0F) << 4) | ((bits & 0xF0F0F0F0) >> 4)
    bits = ((bits & 0x00FF00FF) << 8) | ((bits & 0xFF00FF00) >> 8)
    xi1 = i.to(torch.float32) / samples
    xi2 = bits.to(torch.float32) * 2.3283064365386963e-10
    return xi1, xi2


@functools.lru_cache(maxsize=None)
def _lut(size: int, samples: int, device: str) -> torch.Tensor:
    n_dot_v = ((torch.arange(size, dtype=torch.float32, device=device) + 0.5)
               / size)
    rough = (torch.arange(size, dtype=torch.float32, device=device) + 0.5) / size
    alpha = rough * rough
    vx = torch.sqrt(torch.clamp(1.0 - n_dot_v * n_dot_v, min=0.0))
    vz = n_dot_v
    xi1, xi2 = _hammersley(samples, device)

    # (S_rough, S_ndv, chunk): roughness rows, NdotV columns, samples
    a = alpha[:, None, None]
    vx3, vz3 = vx[None, :, None], vz[None, :, None]
    ndv = n_dot_v[None, :, None]
    k = a * a / 2.0                             # Karis IBL k
    g_v = ndv / (ndv * (1.0 - k) + k)
    acc_a = torch.zeros((size, size), dtype=torch.float32, device=device)
    acc_b = torch.zeros_like(acc_a)
    for c0 in range(0, samples, _CHUNK):
        x1 = xi1[c0:c0 + _CHUNK][None, None, :]
        x2 = xi2[c0:c0 + _CHUNK][None, None, :]
        ph = 2.0 * math.pi * x1
        cos_th = torch.sqrt((1.0 - x2) / (1.0 + (a * a - 1.0) * x2))
        sin_th = torch.sqrt(torch.clamp(1.0 - cos_th * cos_th, min=0.0))
        hx = sin_th * torch.cos(ph)
        hz = cos_th
        v_dot_h = vx3 * hx + vz3 * hz
        lz = 2.0 * v_dot_h * hz - vz3
        n_dot_l = torch.clamp(lz, min=0.0)
        n_dot_h = torch.clamp(hz, min=0.0)
        v_dot_h = torch.clamp(v_dot_h, min=0.0)
        g_l = n_dot_l / torch.clamp(n_dot_l * (1.0 - k) + k, min=1e-6)
        g_vis = torch.where(
            n_dot_l > 0,
            g_v * g_l * v_dot_h / torch.clamp(n_dot_h * ndv, min=1e-6),
            torch.zeros((), device=device))
        fc = torch.pow(1.0 - v_dot_h, 5.0)
        term_a = (1.0 - fc) * g_vis
        term_b = fc * g_vis
        for j in range(term_a.shape[-1]):       # the scan's order
            acc_a += term_a[..., j]
            acc_b += term_b[..., j]
    return torch.stack([acc_a, acc_b], dim=-1) / samples


def generate_brdf_lut(size: int = 256, samples: int = 512,
                      device="cuda") -> torch.Tensor:
    """Returns (size, size, 2) f32 on `device`: scale (A) and bias (B) for
    F0. Grid: x = NdotV in (0,1], y = roughness in (0,1]. Standard Karis
    split-sum integration with GGX importance sampling. Cached per
    (size, samples, device): every caller gets the same tensor, which
    must not be written to."""
    return _lut(int(size), int(samples), str(torch.device(device)))


def sample_brdf_lut(lut: torch.Tensor, n_dot_v: torch.Tensor,
                    roughness: torch.Tensor):
    """Bilinear LUT fetch -> (A (P,), B (P,))."""
    S = lut.shape[0]
    x = torch.clamp(n_dot_v, 0.0, 1.0) * S - 0.5
    y = torch.clamp(roughness, 0.0, 1.0) * S - 0.5
    x0 = torch.clamp(torch.floor(x), 0, S - 1)
    y0 = torch.clamp(torch.floor(y), 0, S - 1)
    x1 = torch.clamp(x0 + 1, 0, S - 1)
    y1 = torch.clamp(y0 + 1, 0, S - 1)
    fx = torch.clamp(x - x0, 0.0, 1.0)[:, None]
    fy = torch.clamp(y - y0, 0.0, 1.0)[:, None]
    flat = lut.reshape(S * S, 2)

    def tap(yi, xi):
        return flat[(yi * S + xi).long()]

    out = (tap(y0, x0) * (1 - fx) * (1 - fy)
           + tap(y0, x1) * fx * (1 - fy)
           + tap(y1, x0) * (1 - fx) * fy
           + tap(y1, x1) * fx * fy)
    return out[:, 0], out[:, 1]
