"""Cubemap sampling (skybox, IBL prefiltered/irradiance) on channel planes.

Port of awsm_renderer_tpu/ops/cubemap.py. Faces follow the WebGPU/GL
order +X,-X,+Y,-Y,+Z,-Z; bilinear filtering with edge clamp. Each packed
texel row carries its edge-clamped right/down/diagonal neighbours (16
channels), so one bilinear tap is one row. For an image environment the
renderer appends the [skybox | irradiance | prefiltered] rows to the bf16
texel pool at ``env_base``, and every tap of a pass goes through one K6
gather (ops/relayout.py gather_split_channels).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .relayout import gather_split_channels


def pack_cubemap(faces: np.ndarray) -> np.ndarray:
    """(..., 6, S, S, 4) f32 -> (..., 6*S*S, 16) quad-packed, clamp wrap
    (host side, at scene flush)."""
    from ..core.textures import WRAP_CLAMP, _pack_quads

    faces = np.asarray(faces, dtype=np.float32)
    lead = faces.shape[:-4]
    S = faces.shape[-2]
    flat_faces = faces.reshape(-1, S, S, 4)
    packed = np.stack([_pack_quads(f, WRAP_CLAMP, WRAP_CLAMP)
                       for f in flat_faces])
    return packed.reshape(*lead, 6 * S * S, 16)


def cubemap_face_uv_c(d3):
    """(x, y, z) (P,) -> (face (P,) int32, u (P,), v (P,))."""
    x, y, z = d3
    ax, ay, az = torch.abs(x), torch.abs(y), torch.abs(z)
    is_x = (ax >= ay) & (ax >= az)
    is_y = (~is_x) & (ay >= az)
    # Python-scalar branches: a scalar tensor made on the card per call is
    # a pageable host-to-device copy, which waits for the stream
    face = torch.where(is_x, torch.where(x > 0, 0, 1),
                       torch.where(is_y, torch.where(y > 0, 2, 3),
                                   torch.where(z > 0, 4, 5))).to(torch.int32)
    ma = torch.where(is_x, ax, torch.where(is_y, ay, az))
    ma = torch.clamp(ma, min=1e-12)
    sc = torch.where(is_x, torch.where(x > 0, -z, z),
                     torch.where(is_y, x, torch.where(z > 0, x, -x)))
    tc = torch.where(is_y, torch.where(y > 0, z, -z), -y)
    u = (sc / ma + 1.0) * 0.5
    v = (tc / ma + 1.0) * 0.5
    return face, u, v


def cubemap_face_uv(dirs: torch.Tensor):
    """dirs (P, 3) -> (face (P,) int32, uv (P, 2) in [0, 1])."""
    face, u, v = cubemap_face_uv_c(dirs.unbind(1))
    return face, torch.stack([u, v], dim=-1)


def _bilinear_setup_c(d3, S: int):
    """Flat base index within one cubemap + (P,) fractional weights."""
    face, u, v = cubemap_face_uv_c(d3)
    x = torch.clamp(u * S - 0.5, 0.0, S - 1.0)
    y = torch.clamp(v * S - 0.5, 0.0, S - 1.0)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    idx = face * (S * S) + y0.to(torch.int32) * S + x0.to(torch.int32)
    return idx, x - x0, y - y0


def _blend_quads_c(cols, fx, fy):
    """16 (P,) texel columns + (P,) weights -> [r, g, b, a]."""
    w00 = (1 - fx) * (1 - fy)
    w10 = fx * (1 - fy)
    w01 = (1 - fx) * fy
    w11 = fx * fy
    return [cols[c] * w00 + cols[4 + c] * w10 + cols[8 + c] * w01
            + cols[12 + c] * w11 for c in range(4)]


def _sample_rows(rows: torch.Tensor, idx, fx, fy) -> torch.Tensor:
    """Bilinear taps of quad-packed f32 rows (N, 16) at row idx -> (P, 4)."""
    cols = rows.index_select(0, idx.long()).unbind(1)
    return torch.stack(_blend_quads_c(cols, fx, fy), dim=-1)


def sample_cubemap(packed: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """packed (6*S*S, 16) quad rows (pack_cubemap, as a tensor), dirs
    (P, 3) -> (P, 4): bilinear, edge-clamped. A helper for tools and
    tests: the frame's env taps go through sample_env_batch_c's one K6
    gather."""
    idx, fx, fy = _bilinear_setup_c(dirs.unbind(1),
                                    math.isqrt(packed.shape[0] // 6))
    return _sample_rows(packed, idx, fx, fy)


def sample_prefiltered(packed: torch.Tensor, dirs: torch.Tensor,
                       roughness: torch.Tensor) -> torch.Tensor:
    """packed (n_levels, 6*S*S, 16); roughness (P,) picks the level,
    blended linearly between the two nearest -> (P, 4)."""
    n, rows = packed.shape[:2]
    level = torch.clamp(roughness, 0.0, 1.0) * (n - 1)
    l0 = torch.floor(level).to(torch.int32)
    l1 = torch.clamp(l0 + 1, max=n - 1)
    frac = (level - l0.float())[:, None]
    idx, fx, fy = _bilinear_setup_c(dirs.unbind(1), math.isqrt(rows // 6))
    flat = packed.reshape(n * rows, 16)
    s0 = _sample_rows(flat, l0 * rows + idx, fx, fy)
    s1 = _sample_rows(flat, l1 * rows + idx, fx, fy)
    return s0 * (1 - frac) + s1 * frac


def sample_env_batch_c(sky_rows: int, irr_rows: int, pref_shape,
                       irr_dirs, pref_reqs, sky_dirs, texq: torch.Tensor,
                       env_base: int, gather=gather_split_channels):
    """All of a pass's environment taps through ONE K6 gather from the
    texel pool.

    sky_rows / irr_rows: 6*S*S row counts of the packed skybox and
    irradiance maps; pref_shape: (n_levels, rows per level) of the
    prefiltered map; irr_dirs: (x, y, z) planes; pref_reqs: list of
    (direction triple, roughness (P,)); sky_dirs: view-ray triple for the
    miss-path skybox colour, or None; texq: (N, 64) bf16 texel pool with
    the env rows appended at env_base; gather: the texel-pool gather (K6,
    or its twin for a plain computation). Returns (irr [r,g,b,a],
    [pref_i ...], sky or None) as channel lists."""
    A, B = sky_rows, irr_rows
    n, C = pref_shape
    S_sky = math.isqrt(A // 6)
    S_irr = math.isqrt(B // 6)
    S_pref = math.isqrt(C // 6)

    parts = []      # index arrays
    plans = []      # per output: (kind, part0, fx, fy, part1, frac)
    idx, fx, fy = _bilinear_setup_c(irr_dirs, S_irr)
    plans.append(("irr", len(parts), fx, fy, None, None))
    parts.append(env_base + idx + A)
    if sky_dirs is not None:
        idx, fx, fy = _bilinear_setup_c(sky_dirs, S_sky)
        plans.append(("sky", len(parts), fx, fy, None, None))
        parts.append(env_base + idx)
    for dirs, roughness in pref_reqs:
        level = torch.clamp(roughness, 0.0, 1.0) * (n - 1)
        l0 = torch.floor(level).to(torch.int32)
        l1 = torch.clamp(l0 + 1, max=n - 1)
        frac = level - l0.float()
        idx, fx, fy = _bilinear_setup_c(dirs, S_pref)
        plans.append(("pref", len(parts), fx, fy, len(parts) + 1, frac))
        parts.append(env_base + A + B + l0 * C + idx)
        parts.append(env_base + A + B + l1 * C + idx)

    P = irr_dirs[0].shape[0]
    cols_all = gather(texq, torch.cat(parts).to(torch.int32), 16)

    def cols(i):
        return cols_all[:, i * P:(i + 1) * P]

    irr_out, sky_out, pref_outs = None, None, []
    for kind, p0, fx, fy, p1, frac in plans:
        s0 = _blend_quads_c(cols(p0), fx, fy)
        if kind == "pref":
            s1 = _blend_quads_c(cols(p1), fx, fy)
            pref_outs.append([a * (1 - frac) + b * frac
                              for a, b in zip(s0, s1)])
        elif kind == "sky":
            sky_out = s0
        else:
            irr_out = s0
    return irr_out, pref_outs, sky_out


def sample_skybox_pool_c(texq: torch.Tensor, env_base: int, sky_rows: int,
                         d3):
    """Skybox-only bilinear taps from the texel-pool env rows: one K6
    gather (the sky of the tiles the compacted opaque shade skips, so the
    gather is O(sky pixels)). sky_rows: 6*S*S rows of the packed skybox;
    d3: (x, y, z) direction planes. Returns [r, g, b, a]."""
    idx, fx, fy = _bilinear_setup_c(d3, math.isqrt(sky_rows // 6))
    cols = gather_split_channels(texq, (env_base + idx).to(torch.int32), 16)
    return _blend_quads_c(cols, fx, fy)
