"""Tone mapping + display transfer on [r, g, b, a] channel planes.

Port of awsm_renderer_tpu/ops/tonemap.py display_pass_c: Khronos PBR
Neutral | ACES | none, then the linear -> sRGB encode.
"""

from __future__ import annotations

import torch

from ..config import ToneMapping


def tonemap_aces(x):
    """ACES filmic fit (Narkowicz 2015)."""
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return torch.clamp((x * (a * x + b)) / (x * (c * x + d) + e), 0.0, 1.0)


def linear_to_srgb(c):
    c = torch.clamp(c, min=0.0)
    return torch.where(
        c <= 0.0031308, c * 12.92,
        1.055 * torch.pow(torch.clamp(c, min=1e-12), 1.0 / 2.4) - 0.055)


def _khronos_pbr_neutral_c(rgb):
    f90 = 0.04
    start_compression = 0.8 - f90
    desaturation = 0.15
    x = torch.minimum(torch.minimum(rgb[0], rgb[1]), rgb[2])
    offset = torch.where(x < 0.08, x - 6.25 * x * x,
                         torch.full_like(x, f90))
    c = [ch - offset for ch in rgb]
    peak = torch.maximum(torch.maximum(c[0], c[1]), c[2])
    d = 1.0 - start_compression
    new_peak = 1.0 - d * d / torch.clamp(peak + d - start_compression,
                                         min=1e-6)
    g = 1.0 / (desaturation * (peak - new_peak) + 1.0)
    inv_peak = 1.0 / torch.clamp(peak, min=1e-6)
    hit = peak > start_compression
    return [torch.where(hit, new_peak * (g * ch * inv_peak + (1.0 - g)), ch)
            + offset for ch in c]


def display_pass_c(hdr_ch, mode: ToneMapping):
    """[r,g,b,a] HDR planes -> [r,g,b,a] sRGB planes in [0,1]."""
    rgb = hdr_ch[:3]
    if mode == ToneMapping.ACES:
        rgb = [tonemap_aces(ch) for ch in rgb]
    elif mode == ToneMapping.KHRONOS_PBR_NEUTRAL:
        rgb = _khronos_pbr_neutral_c(rgb)
    rgb = [torch.clamp(linear_to_srgb(ch), 0.0, 1.0) for ch in rgb]
    return rgb + [torch.clamp(hdr_ch[3], 0.0, 1.0)]


def display_pass(hdr: torch.Tensor, mode: ToneMapping) -> torch.Tensor:
    """HDR linear (H, W, 4) -> display sRGB (H, W, 4) in [0, 1]
    (display_pass_c on the image's planes)."""
    return torch.stack(display_pass_c(list(hdr.unbind(-1)), mode), dim=-1)
