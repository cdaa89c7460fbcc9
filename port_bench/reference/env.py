"""Image-based lighting of the reference: an equirect panorama turned into
a skybox cube, a prefiltered specular chain and an irradiance cube, and
bilinear cube taps.

The maps follow the semantics the renderer documents for an equirect
environment (a bilinear equirect -> cube resample; the specular chain as
progressive Gaussian blurs of an area-resized base, one level per
roughness step; irradiance as a wide blur of the last level), worked out
here from the panorama alone, in float32 on the host. Faces follow the
order +X, -X, +Y, -Y, +Z, -Z; a tap is bilinear with edge clamp inside
one face.
"""

from __future__ import annotations

import numpy as np
import torch

F = np.float32
SPEC_SIZE = 64
N_SPEC_MIPS = 5
IRRADIANCE_SIZE = 16


def equirect_to_cubemap(equirect: np.ndarray, size: int) -> np.ndarray:
    """(h, w, 3|4) -> (6, size, size, 4), bilinear, longitude wrapped."""
    eq = np.asarray(equirect, F)
    if eq.shape[-1] == 3:
        eq = np.concatenate([eq, np.ones((*eq.shape[:-1], 1), F)], axis=-1)
    Hs, Ws = eq.shape[:2]
    uv = (np.arange(size, dtype=np.float64) + 0.5) / size * 2.0 - 1.0
    u, v = np.meshgrid(uv, uv, indexing="xy")
    ones = np.ones_like(u)
    faces_dirs = [
        np.stack([ones, -v, -u], -1), np.stack([-ones, -v, u], -1),
        np.stack([u, ones, v], -1), np.stack([u, -ones, -v], -1),
        np.stack([u, -v, ones], -1), np.stack([-u, -v, -ones], -1),
    ]
    out = np.zeros((6, size, size, 4), F)
    for f, d in enumerate(faces_dirs):
        dn = d / np.linalg.norm(d, axis=-1, keepdims=True)
        theta = np.arctan2(dn[..., 0], -dn[..., 2])
        phi = np.arcsin(np.clip(dn[..., 1], -1, 1))
        x = (theta / (2 * np.pi) + 0.5) * Ws - 0.5
        y = (0.5 - phi / np.pi) * Hs - 0.5
        x0 = np.floor(x).astype(np.int64)
        y0 = np.clip(np.floor(y).astype(np.int64), 0, Hs - 1)
        fx = (x - x0)[..., None]
        fy = (y - y0)[..., None]
        x0m, x1m = np.mod(x0, Ws), np.mod(x0 + 1, Ws)
        y1 = np.clip(y0 + 1, 0, Hs - 1)
        out[f] = (eq[y0, x0m] * (1 - fx) * (1 - fy)
                  + eq[y0, x1m] * fx * (1 - fy)
                  + eq[y1, x0m] * (1 - fx) * fy + eq[y1, x1m] * fx * fy)
    return out


def ibl_maps(faces: np.ndarray):
    """(6, S, S, 4) environment -> (prefiltered (N_SPEC_MIPS, 6, SPEC_SIZE,
    SPEC_SIZE, 4), irradiance (6, IRRADIANCE_SIZE, IRRADIANCE_SIZE, 4))."""
    import cv2

    base = np.stack([cv2.resize(f, (SPEC_SIZE, SPEC_SIZE),
                                interpolation=cv2.INTER_AREA) for f in faces])
    mips = [base]
    cur = base
    for _ in range(1, N_SPEC_MIPS):
        cur = np.stack([cv2.GaussianBlur(f, (0, 0), sigmaX=2.0) for f in cur])
        mips.append(cur)
    irr = np.stack([cv2.resize(cv2.GaussianBlur(f, (0, 0), sigmaX=8.0),
                               (IRRADIANCE_SIZE, IRRADIANCE_SIZE),
                               interpolation=cv2.INTER_AREA)
                    for f in mips[-1]])
    return np.stack(mips).astype(F), irr.astype(F)


def face_uv(d):
    """Direction [x, y, z] -> (face, u, v), u, v in [0, 1]."""
    x, y, z = d
    ax, ay, az = x.abs(), y.abs(), z.abs()
    is_x = (ax >= ay) & (ax >= az)
    is_y = (~is_x) & (ay >= az)
    face = torch.where(is_x, torch.where(x > 0, 0, 1),
                       torch.where(is_y, torch.where(y > 0, 2, 3),
                                   torch.where(z > 0, 4, 5)))
    ma = torch.clamp(torch.where(is_x, ax, torch.where(is_y, ay, az)),
                     min=1e-12)
    sc = torch.where(is_x, torch.where(x > 0, -z, z),
                     torch.where(is_y, x, torch.where(z > 0, x, -x)))
    tc = torch.where(is_y, torch.where(y > 0, z, -z), -y)
    return face, (sc / ma + 1.0) * 0.5, (tc / ma + 1.0) * 0.5


def sample_cube(cube: torch.Tensor, d):
    """cube (6, S, S, 4) -> (4, P) bilinear taps along directions d."""
    S = cube.shape[1]
    face, u, v = face_uv(d)
    x = torch.clamp((u * S - 0.5).nan_to_num(0.0), 0.0, S - 1.0)
    y = torch.clamp((v * S - 0.5).nan_to_num(0.0), 0.0, S - 1.0)
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = (x - x0)[:, None], (y - y0)[:, None]
    xi, yi = x0.long(), y0.long()
    x1, y1 = (xi + 1).clamp(max=S - 1), (yi + 1).clamp(max=S - 1)
    f = face.long()
    c = (cube[f, yi, xi] * ((1 - fx) * (1 - fy)) + cube[f, yi, x1] * (fx * (1 - fy))
         + cube[f, y1, xi] * ((1 - fx) * fy) + cube[f, y1, x1] * (fx * fy))
    return c.T


def sample_prefiltered(chain: torch.Tensor, d, roughness):
    """chain (n, 6, S, S, 4): the level is roughness * (n - 1), linear
    between the two nearest."""
    n = chain.shape[0]
    level = torch.clamp(roughness, 0.0, 1.0) * (n - 1)
    l0 = torch.floor(level)
    frac = level - l0
    l0i = l0.long()
    l1i = (l0i + 1).clamp(max=n - 1)
    out = torch.zeros((4, roughness.shape[0]), dtype=chain.dtype,
                      device=chain.device)
    for lv in range(n):
        m0, m1 = l0i == lv, l1i == lv
        if bool(m0.any()) or bool(m1.any()):
            s = sample_cube(chain[lv], d)
            out = out + s * torch.where(m0, 1.0 - frac, 0.0) \
                + s * torch.where(m1, frac, 0.0)
    return out
