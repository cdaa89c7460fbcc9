"""Textures of the reference: 8-bit images decoded to linear float32,
full mip chains, and trilinear taps with repeat wrapping.

Decoding and mip filtering follow what the renderer documents for an
uploaded glTF image: the sRGB EOTF on colour channels, a 2x2 area
filter in linear light, normal maps renormalized at every level, the
metallic-roughness map's roughness averaged as r^2. A tap's level of
detail is log2 of the longer screen-gradient axis in texels, clamped to
the chain; the tap is bilinear at the two nearest levels, blended by
the fraction.
"""

from __future__ import annotations

import numpy as np
import torch

F = np.float32
MAX_MIPS = 14


def srgb_to_linear(c: np.ndarray) -> np.ndarray:
    c = np.asarray(c, F)
    return np.where(c <= 0.04045, c / 12.92,
                    ((c + 0.055) / 1.055) ** 2.4).astype(F)


def decode(image: np.ndarray, srgb: bool) -> np.ndarray:
    """(h, w, 4) uint8 -> (h, w, 4) float32, colour channels linear."""
    img = image.astype(F) / F(255.0)
    if srgb:
        img = np.concatenate([srgb_to_linear(img[..., :3]), img[..., 3:]], -1)
    return img


def _area_half(img: np.ndarray, w: int, h: int) -> np.ndarray:
    H, W = img.shape[:2]
    if W == 2 * w and H == 2 * h:
        return img.reshape(h, 2, w, 2, img.shape[2]).mean(axis=(1, 3)).astype(F)
    import cv2

    return cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA).reshape(
        h, w, -1).astype(F)


def mip_chain(img: np.ndarray, kind: str):
    h, w = img.shape[:2]
    levels = min(MAX_MIPS, int(np.floor(np.log2(max(w, h)))) + 1)
    chain, cur = [img], img
    for _ in range(1, levels):
        nw, nh = max(1, w // 2), max(1, h // 2)
        if kind == "normal":
            vec = cur[..., :3] * 2.0 - 1.0
            down = _area_half(np.concatenate([vec, cur[..., 3:4]], -1), nw, nh)
            n = down[..., :3]
            ln = np.linalg.norm(n, axis=-1, keepdims=True)
            n = np.where(ln > 1e-6, n / np.maximum(ln, 1e-6),
                         np.array([0, 0, 1], F))
            nxt = np.concatenate([(n + 1.0) * 0.5, down[..., 3:4]], -1)
        elif kind == "mr":
            tmp = cur.copy()
            tmp[..., 1] = cur[..., 1] ** 2
            nxt = _area_half(tmp, nw, nh)
            nxt[..., 1] = np.sqrt(np.maximum(nxt[..., 1], 0.0))
        else:
            nxt = _area_half(cur, nw, nh)
        nxt = nxt.astype(F)
        chain.append(nxt)
        cur, w, h = nxt, nw, nh
    return chain


def _bilinear(level: torch.Tensor, u, v):
    """Repeat-wrapped bilinear tap of one (h, w, 4) level -> (P, 4)."""
    h, w = level.shape[:2]
    x = (u * w - 0.5).nan_to_num(0.0, 0.0, 0.0)
    y = (v * h - 0.5).nan_to_num(0.0, 0.0, 0.0)
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = (x - x0)[:, None], (y - y0)[:, None]
    xi = torch.remainder(x0.long(), w)
    yi = torch.remainder(y0.long(), h)
    x1, y1 = torch.remainder(xi + 1, w), torch.remainder(yi + 1, h)
    return (level[yi, xi] * ((1 - fx) * (1 - fy))
            + level[yi, x1] * (fx * (1 - fy))
            + level[y1, xi] * ((1 - fx) * fy) + level[y1, x1] * (fx * fy))


def sample(chain, u, v, duv, use_mips: bool = True):
    """Trilinear taps of a mip chain (list of (h, w, 4) tensors) at uv with
    screen gradients duv = (du/dx, dv/dx, du/dy, dv/dy) -> (4, P)."""
    h, w = chain[0].shape[:2]
    if not use_mips or duv is None:
        return _bilinear(chain[0], u, v).T
    dudx, dvdx, dudy, dvdy = duv
    rx = (dudx * w) ** 2 + (dvdx * h) ** 2
    ry = (dudy * w) ** 2 + (dvdy * h) ** 2
    lod = 0.5 * torch.log2(torch.clamp(torch.maximum(rx, ry), min=1e-12))
    n = len(chain)
    level = torch.clamp(torch.minimum(lod, torch.full_like(lod, n - 1.0)),
                        min=0.0)
    level = torch.where(torch.isnan(level), torch.zeros_like(level), level)
    l0 = torch.floor(level)
    frac = (level - l0)[:, None]
    l0i = l0.long()
    out = torch.zeros((u.shape[0], 4), dtype=chain[0].dtype, device=u.device)
    for lv in range(n):
        m = l0i == lv
        if not bool(m.any()):
            continue
        idx = m.nonzero()[:, 0]
        a = _bilinear(chain[lv], u[idx], v[idx])
        b = _bilinear(chain[min(lv + 1, n - 1)], u[idx], v[idx])
        out[idx] = a * (1 - frac[idx]) + b * frac[idx]
    return out.T
