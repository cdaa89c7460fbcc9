"""Post-processing of the reference, on (3, H, W) HDR tensors: bloom, depth
of field, the display transfer. Frozen from the renderer's documented
effect definitions (awsm-renderer's bloom.wgsl, dof.wgsl and the
Khronos PBR Neutral tonemapper), so a later change to the program cannot
move the yardstick.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as Fn

BLOOM_BLUR_PASSES = 3
BLOOM_THRESHOLD = 0.8
BLOOM_INTENSITY = 0.5
BLOOM_RADIUS = 2.0

DOF_MAX_BLUR = 16.0
DOF_SAMPLES = 16
DOF_SENSOR_HEIGHT = 0.024
DOF_GOLDEN_ANGLE = 2.39996323
DOF_RING_SCALES = (1.0, 0.5, 0.25)


def _pad(x: torch.Tensor, r: int) -> torch.Tensor:
    return Fn.pad(x[None], (r, r, r, r), mode="replicate")[0]


def bloom(rgb: torch.Tensor) -> torch.Tensor:
    """Soft-knee extract, BLOOM_BLUR_PASSES + 2 masked gaussian blurs,
    added at BLOOM_INTENSITY."""
    luma = rgb[0] * 0.2126 + rgb[1] * 0.7152 + rgb[2] * 0.0722
    soft_t = BLOOM_THRESHOLD * 0.8
    knee = BLOOM_THRESHOLD - soft_t
    soft = torch.clamp((luma - soft_t) / knee, 0.0, 1.0)
    factor = (torch.clamp(luma - BLOOM_THRESHOLD, min=0.0)
              / torch.clamp(luma, min=1e-4) * soft)
    sigma, r = BLOOM_RADIUS, int(np.ceil(BLOOM_RADIUS))
    taps = [(dy, dx, np.exp(-(dy * dy + dx * dx) / (2.0 * sigma * sigma)))
            for dy in range(-r, r + 1) for dx in range(-r, r + 1)
            if dy * dy + dx * dx <= BLOOM_RADIUS * BLOOM_RADIUS + 0.5]
    total = sum(w for _, _, w in taps)
    _, H, W = rgb.shape

    def blur(x):
        xp = _pad(x, r)
        out = torch.zeros_like(x)
        for dy, dx, w in taps:
            out = out + xp[:, r + dy:r + dy + H, r + dx:r + dx + W] * float(
                w / total)
        return out

    b = blur(rgb * factor)
    for _ in range(BLOOM_BLUR_PASSES):
        b = blur(b)
    return rgb + blur(b) * BLOOM_INTENSITY


def linearize_depth(depth: torch.Tensor, proj: np.ndarray) -> torch.Tensor:
    A, B = float(np.float32(proj[2][2])), float(np.float32(proj[2][3]))
    den = torch.clamp(depth, 0.0, 1.0) + A
    return B / torch.where(den.abs() > 1e-8, den, torch.full_like(den, 1e-8))


def _coc_scalars(dof, proj):
    S = np.float32(dof[0])
    N = np.float32(dof[1])
    f = np.float32(DOF_SENSOR_HEIGHT * 0.5) * np.float32(proj[1][1])
    a_ap = f / np.maximum(N, np.float32(0.1))
    return S, np.float32(a_ap * f)


def coc_pixels(D, dof, proj, height: int):
    S, af = _coc_scalars(dof, proj)
    coc_w = float(af) * (D - float(S)).abs() / (
        D * float(np.maximum(S, np.float32(1e-3))))
    return torch.clamp(coc_w * height / DOF_SENSOR_HEIGHT, 0.0, DOF_MAX_BLUR)


def coc_at(d: float, dof, proj, height: int) -> float:
    """Host CoC in pixels at view distance d."""
    S, N = float(dof[0]), float(dof[1])
    f = DOF_SENSOR_HEIGHT * 0.5 * float(proj[1][1])
    A = f / max(N, 0.1)
    return min(A * f * abs(d - S) / (d * max(S, 1e-3)) * height
               / DOF_SENSOR_HEIGHT, DOF_MAX_BLUR)


def disk_offsets(scale: float):
    taps = []
    for i in range(DOF_SAMPLES):
        theta = i * DOF_GOLDEN_ANGLE
        r = np.sqrt((i + 1) / DOF_SAMPLES) * DOF_MAX_BLUR * scale
        ox, oy = np.cos(theta) * r, np.sin(theta) * r
        taps.append((int(np.round(ox)), int(np.round(oy)),
                     float(np.hypot(ox, oy))))
    return taps


def ring_weight(coc, scale: float):
    R = scale * DOF_MAX_BLUR
    t = torch.log2(torch.clamp(coc, min=1e-6)) - float(np.log2(R))
    up = torch.clamp(1.0 - t, 0.0, 1.0)
    dn = torch.clamp(1.0 + t, 0.0, 1.0)
    if scale >= max(DOF_RING_SCALES):
        up = torch.ones_like(up)
    if scale <= min(DOF_RING_SCALES):
        dn = torch.ones_like(dn)
    return torch.minimum(up, dn)


def depth_of_field(rgb: torch.Tensor, depth: torch.Tensor, dof,
                   proj) -> torch.Tensor:
    """The 16-tap golden-angle disk at every ring radius, each ring
    weighted by a hat of log2(CoC), taps guarded against background
    bleed and faded radially; mixed in by smoothstep(0, 2, CoC)."""
    H, W = depth.shape
    D = torch.clamp(linearize_depth(depth, proj), min=1e-4)
    coc = coc_pixels(D, dof, proj, H)
    inv_coc = 1.0 / torch.clamp(coc, min=0.01)
    inv_half = 2.0 * inv_coc
    p = int(DOF_MAX_BLUR)
    rgb_p = _pad(rgb, p)
    D_p, coc_p = _pad(torch.stack([D, coc]), p)
    blur = rgb * 1.0
    total = torch.ones_like(coc)
    for scale in DOF_RING_SCALES:
        rw = ring_weight(coc, scale)
        for dx, dy, dist in disk_offsets(scale):
            s_rgb = rgb_p[:, p + dy:p + dy + H, p + dx:p + dx + W]
            s_D = D_p[p + dy:p + dy + H, p + dx:p + dx + W]
            s_coc = coc_p[p + dy:p + dy + H, p + dx:p + dx + W]
            occluded = (s_D > D) & (s_coc < coc)
            w = torch.where(occluded, s_coc * inv_coc, torch.ones_like(coc))
            t = torch.clamp((dist - coc * 0.5) * inv_half, 0.0, 1.0)
            w = torch.clamp(w * (1.0 - t * t * (3.0 - 2.0 * t)),
                            min=0.01) * rw
            blur = blur + s_rgb * w
            total = total + w
    inv = 1.0 / torch.clamp(total, min=0.01)
    tb = torch.clamp(coc / 2.0, 0.0, 1.0)
    blend = tb * tb * (3.0 - 2.0 * tb)
    return rgb * (1.0 - blend) + blur * inv * blend


def khronos_pbr_neutral(rgb: torch.Tensor) -> torch.Tensor:
    f90 = 0.04
    start = 0.8 - f90
    desat = 0.15
    x = torch.minimum(torch.minimum(rgb[0], rgb[1]), rgb[2])
    offset = torch.where(x < 0.08, x - 6.25 * x * x, torch.full_like(x, f90))
    c = rgb - offset
    peak = torch.maximum(torch.maximum(c[0], c[1]), c[2])
    d = 1.0 - start
    new_peak = 1.0 - d * d / torch.clamp(peak + d - start, min=1e-6)
    g = 1.0 / (desat * (peak - new_peak) + 1.0)
    inv_peak = 1.0 / torch.clamp(peak, min=1e-6)
    hit = peak > start
    return torch.where(hit, new_peak * (g * c * inv_peak + (1.0 - g)),
                       c) + offset


def linear_to_srgb(c: torch.Tensor) -> torch.Tensor:
    c = torch.clamp(c, min=0.0)
    return torch.where(c <= 0.0031308, c * 12.92,
                       1.055 * torch.pow(torch.clamp(c, min=1e-12), 1.0 / 2.4)
                       - 0.055)


def display(rgb: torch.Tensor, alpha: torch.Tensor, tonemap: str):
    """(3, H, W) HDR + (H, W) alpha -> (H, W, 4) display image in [0, 1]."""
    if tonemap == "khronos_pbr_neutral":
        rgb = khronos_pbr_neutral(rgb)
    elif tonemap != "none":
        raise NotImplementedError(f"tonemap {tonemap!r}")
    rgb = torch.clamp(linear_to_srgb(rgb), 0.0, 1.0)
    return torch.cat([rgb, torch.clamp(alpha, 0.0, 1.0)[None]]).permute(1, 2, 0)
