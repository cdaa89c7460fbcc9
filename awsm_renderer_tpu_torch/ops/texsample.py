"""Texture sampling from the packed texel pool: K4 (tap planner) and K5
(texel filter).

Port of awsm_renderer_tpu/ops/texsample.py. Every tap of a frame goes
through one plan and one filter: K4 turns (texture id, uv, screen
gradients, KHR_texture_transform id) into a texel-row index and 11
filter weights; K5 reads that quad-packed 128-byte row (bilinear quad +
parent-mip 3x3, core/textures.py) and filters it to rgba. Both are
hand-written CUDA (csrc/texsample.cu) with plain PyTorch twins
(tap_plan_reference, filter_taps_reference); a CPU tensor takes the
twin, a CUDA tensor the kernel.

The reference's fallback branch (per-field descriptor splits, one
gather, split_channels) exists for its interpret mode and for tap lists
that mix mip and non-mip taps, which the shade never builds; the port
has the fused path only and refuses a mixed list.
"""

from __future__ import annotations

import torch

from ..core.textures import (
    MAX_MIPS,
    TD_FILTER_LINEAR,
    TD_HEIGHT,
    TD_MAX_ANISO,
    TD_MIP_FILTER_LINEAR,
    TD_MIP_OFFSETS,
    TD_N_MIPS,
    TD_WIDTH,
    TD_WRAP_S,
    TD_WRAP_T,
    TEXEL_COLS,
    WRAP_CLAMP,
    WRAP_MIRROR,
    WRAP_REPEAT,
)
from . import kernels

N_WEIGHTS = 11
_I_LIMIT = float(1 << 30)


def _wrap_coord(i, n, mode):
    """Wrap integer texel coord i into [0, n) per tap by sampler mode
    (torch.remainder is the exact floor-mod)."""
    rep = torch.remainder(i, n)
    clm = torch.minimum(torch.clamp(i, min=0), n - 1)
    m = torch.remainder(i, 2 * n)
    mir = torch.where(m >= n, 2 * n - 1 - m, m)
    return torch.where(mode == WRAP_REPEAT, rep,
                       torch.where(mode == WRAP_CLAMP, clm, mir))


def _prep_coord(u, n_f, mode):
    """Continuous texel-space coord with the wrap baked into its range:
    MIRROR folds u into [0, 1] (then behaves like CLAMP); CLAMP pre-clamps
    to [0, n-1] so the bilinear footprint never leaves the texture;
    REPEAT stays unbounded (see the reference's docstring)."""
    h = u * 0.5
    u_mir = 1.0 - torch.abs(2.0 * (h - torch.floor(h)) - 1.0)
    u_p = torch.where(mode == WRAP_MIRROR, u_mir, u)
    x = u_p * n_f - 0.5
    return torch.where(mode == WRAP_REPEAT, x,
                       torch.minimum(torch.clamp(x, min=0.0), n_f - 1.0))


def _to_int(x0):
    """Floored f32 coordinate -> int32: NaN -> 0, clamped to +-2^30 first
    (an out-of-range float cast is undefined on the CPU and saturates on
    the card; the kernel does the same)."""
    x0 = torch.where(torch.isnan(x0), torch.zeros_like(x0), x0)
    return torch.clamp(x0, -_I_LIMIT, _I_LIMIT).to(torch.int32)


def _level_idx(desc, u, v, level):
    """Footprint math for one mip level: texel-row indices + weights.

    desc: (N, DESC_I32) int32 descriptor rows; level (N,) int32. Returns
    (idx, fx, fy, x0i, y0i, wm, hm)."""
    wm = torch.clamp(desc[:, TD_WIDTH] >> level, min=1)
    hm = torch.clamp(desc[:, TD_HEIGHT] >> level, min=1)
    lv = torch.clamp(level, 0, MAX_MIPS - 1)
    offset = torch.gather(desc, 1, (TD_MIP_OFFSETS + lv).long()[:, None])[:, 0]
    wrap_s = desc[:, TD_WRAP_S]
    wrap_t = desc[:, TD_WRAP_T]
    x = _prep_coord(u, wm.float(), wrap_s)
    y = _prep_coord(v, hm.float(), wrap_t)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = _wrap_coord(_to_int(x0), wm, wrap_s)
    y0i = _wrap_coord(_to_int(y0), hm, wrap_t)
    idx = offset + y0i * wm + x0i
    return idx, fx, fy, x0i, y0i, wm, hm


def _snap(f, linear, has_nearest: bool):
    """NEAREST filtering folded in as 0/1 weights (f >= 0.5 picks the
    right/lower texel exactly)."""
    if not has_nearest:
        return f
    return torch.where(linear, f, (f >= 0.5).float())


def _quad_weights(fx, fy, linear, has_nearest: bool):
    """Bilinear corner weights [w00, w10, w01, w11]."""
    fx = _snap(fx, linear, has_nearest)
    fy = _snap(fy, linear, has_nearest)
    return [(1.0 - fx) * (1.0 - fy), fx * (1.0 - fy), (1.0 - fx) * fy,
            fx * fy]


def _axis_weights(f, d1, linear, has_nearest: bool):
    """3-tap stencil weights along one parent-block axis: [1-f, f, 0], or
    [0, 1-f, f] when the parent anchor sits one cell right/down (d1)."""
    f = _snap(f, linear, has_nearest)
    z = torch.zeros_like(f)
    return [torch.where(d1, z, 1.0 - f), torch.where(d1, 1.0 - f, f),
            torch.where(d1, f, z)]


def _tap_weights(desc, u, v, plan, frac, has_nearest: bool):
    """The 11 weight planes of one tap: [w00, w10, w01, w11, wx0, wx1,
    wx2, wy0, wy1, wy2, blend]. frac=None (no mips) -> parent weights and
    blend are zero."""
    fx, fy, x0i, y0i, wm, hm = plan
    linear = desc[:, TD_FILTER_LINEAR] > 0
    quad = _quad_weights(fx, fy, linear, has_nearest)
    if frac is None:
        return quad + [torch.zeros_like(fx)] * 7
    w1 = torch.clamp(wm >> 1, min=1)
    h1 = torch.clamp(hm >> 1, min=1)
    wrap_s = desc[:, TD_WRAP_S]
    wrap_t = desc[:, TD_WRAP_T]
    x = _prep_coord(u, w1.float(), wrap_s)
    y = _prep_coord(v, h1.float(), wrap_t)
    ax = torch.floor(x)
    ay = torch.floor(y)
    fx1 = x - ax
    fy1 = y - ay
    axw = _wrap_coord(_to_int(ax), w1, wrap_s)
    ayw = _wrap_coord(_to_int(ay), h1, wrap_t)
    bx = _wrap_coord((x0i - 1) >> 1, w1, wrap_s)
    by = _wrap_coord((y0i - 1) >> 1, h1, wrap_t)
    # axw and bx lie in [0, w1): the mod-w1 fold is one conditional add
    ddx = axw - bx
    ddy = ayw - by
    dx1 = torch.where(ddx < 0, ddx + w1, ddx) >= 1
    dy1 = torch.where(ddy < 0, ddy + h1, ddy) >= 1
    wx = _axis_weights(fx1, dx1, linear, has_nearest)
    wy = _axis_weights(fy1, dy1, linear, has_nearest)
    tri = desc[:, TD_MIP_FILTER_LINEAR] > 0
    blend = torch.where(tri, frac, torch.zeros_like(frac))
    return quad + wx + wy + [blend]


def _apply_tap_weights(cols, w, parent: bool):
    """Filter texel channel columns (16 quad [+ 36 parent] planes) with
    the weight planes -> [r, g, b, a]."""
    w00, w10, w01, w11 = w[:4]
    out = [cols[c] * w00 + cols[4 + c] * w10 + cols[8 + c] * w01
           + cols[12 + c] * w11 for c in range(4)]
    if not parent:
        return out
    wx, wy, blend = w[4:7], w[7:10], w[10]
    res = []
    for c in range(4):
        rows = [cols[16 + (cy * 3) * 4 + c] * wx[0]
                + cols[16 + (cy * 3 + 1) * 4 + c] * wx[1]
                + cols[16 + (cy * 3 + 2) * 4 + c] * wx[2] for cy in range(3)]
        par = rows[0] * wy[0] + rows[1] * wy[1] + rows[2] * wy[2]
        res.append(out[c] * (1.0 - blend) + par * blend)
    return res


def _mip_level(desc, duv):
    """Anisotropy-aware LOD from screen-space uv gradients: with rho the
    footprint axes and N the sampler's max anisotropy, 0.5*log2(max(
    rho_min^2, rho_max^2 / N^2)) (N = 1 is the isotropic max-axis rule)."""
    dudx, dvdx, dudy, dvdy = duv
    w = desc[:, TD_WIDTH].float()
    h = desc[:, TD_HEIGHT].float()
    a = torch.clamp(desc[:, TD_MAX_ANISO].float(), min=1.0)
    ax, bx = dudx * w, dvdx * h
    ay, by = dudy * w, dvdy * h
    rx = ax * ax + bx * bx
    ry = ay * ay + by * by
    r_eff = torch.maximum(torch.minimum(rx, ry),
                          torch.maximum(rx, ry) / (a * a))
    return 0.5 * torch.log2(torch.clamp(r_eff, min=1e-12))


def apply_texture_transform_with_grads_c(tex_transforms, transform_id,
                                         u, v, duv):
    """KHR_texture_transform (uv' = M uv + offset; id < 0 = identity; row
    slot 6 = wrap uv into [0, 1) first, the MegaTexture atlas mode) and
    the push-forward of the screen-space gradients through M. duv =
    (du_dx, dv_dx, du_dy, dv_dy) or None. Returns (u', v', duv')."""
    safe = transform_id.clamp(0, tex_transforms.shape[0] - 1).long()
    t = tex_transforms.index_select(0, safe).T              # (8, N)
    wrap_first = t[6] > 0.5
    uw = torch.where(wrap_first, u - torch.floor(u), u)
    vw = torch.where(wrap_first, v - torch.floor(v), v)
    bound = transform_id >= 0
    uo = torch.where(bound, t[0] * uw + t[1] * vw + t[4], u)
    vo = torch.where(bound, t[2] * uw + t[3] * vw + t[5], v)
    if duv is None:
        return uo, vo, None
    du_dx, dv_dx, du_dy, dv_dy = duv
    out = (
        torch.where(bound, t[0] * du_dx + t[1] * dv_dx, du_dx),
        torch.where(bound, t[2] * du_dx + t[3] * dv_dx, dv_dx),
        torch.where(bound, t[0] * du_dy + t[1] * dv_dy, du_dy),
        torch.where(bound, t[2] * du_dy + t[3] * dv_dy, dv_dy),
    )
    return uo, vo, out


def tap_plan_reference(tex_id, u, v, duv, descriptors, *, has_nearest: bool,
                       tform_id=None, tex_transforms=None):
    """Plain PyTorch twin of K4, in the kernel's order of operations.
    Returns (idx (N,) int32, (11, N) f32 weight block)."""
    if tform_id is not None:
        u, v, duv = apply_texture_transform_with_grads_c(
            tex_transforms, tform_id, u, v, duv)
    desc = descriptors.index_select(
        0, tex_id.clamp(0, descriptors.shape[0] - 1).long())
    if duv is None:
        l0 = torch.zeros_like(tex_id)
        frac = None
    else:
        n_mips = desc[:, TD_N_MIPS].float()
        level = torch.clamp(torch.minimum(_mip_level(desc, duv),
                                          n_mips - 1.0), min=0.0)
        level = torch.where(torch.isnan(level), torch.zeros_like(level),
                            level)
        l0 = torch.floor(level).to(torch.int32)
        frac = level - l0.float()
    idx, *plan = _level_idx(desc, u, v, l0)
    w = _tap_weights(desc, u, v, plan, frac, has_nearest)
    return idx.to(torch.int32), torch.stack(w)


def tap_plan_fused(tex_id, u, v, duv, descriptors, *, has_nearest: bool,
                   tform_id=None, tex_transforms=None):
    """K4: per tap, the texel-row index of the bilinear anchor and the 11
    filter weights.

    tex_id (N,) int32 (clipped to the table); u, v (N,) f32; duv = four
    (N,) f32 gradient planes (du_dx, dv_dx, du_dy, dv_dy) enabling the
    mip LOD, or None (level 0); descriptors (capD, DESC_I32) int32;
    tform_id (N,) int32 + tex_transforms (capT, 8) f32 apply
    KHR_texture_transform (id < 0 = identity). Returns (idx (N,) int32,
    (11, N) f32)."""
    if tex_id.device.type == "cpu":
        return tap_plan_reference(tex_id, u, v, duv, descriptors,
                                  has_nearest=has_nearest, tform_id=tform_id,
                                  tex_transforms=tex_transforms)
    N = tex_id.shape[0]
    ints = [tex_id] + ([tform_id] if tform_id is not None else [])
    floats = [u, v] + (list(duv) if duv is not None else [])
    for t in ints:
        if t.dtype != torch.int32 or t.shape != (N,):
            raise ValueError("tex_id / tform_id must be (N,) int32")
    for t in floats:
        if t.dtype != torch.float32 or t.shape != (N,):
            raise ValueError("u, v and duv planes must be (N,) f32")
    if descriptors.dtype != torch.int32 or descriptors.dim() != 2 \
            or descriptors.shape[1] < TD_MIP_OFFSETS + MAX_MIPS:
        raise ValueError("descriptors must be (capD, >= 22) int32")
    tables = [descriptors]
    if tform_id is not None:
        if tex_transforms is None or tex_transforms.dtype != torch.float32 \
                or tex_transforms.dim() != 2 or tex_transforms.shape[1] != 8:
            raise ValueError("tex_transforms must be (capT, 8) f32")
        tables.append(tex_transforms)
    kernels.check_cuda(*ints, *floats, *tables)
    idx = torch.empty(N, dtype=torch.int32, device=tex_id.device)
    w = torch.empty((N_WEIGHTS, N), dtype=torch.float32, device=tex_id.device)
    d4 = [p.data_ptr() for p in duv] if duv is not None else [None] * 4
    tf = tform_id is not None
    kernels.launch(
        "tap_plan_fused", "awsm_tap_plan",
        tex_id.data_ptr(), tform_id.data_ptr() if tf else None,
        u.data_ptr(), v.data_ptr(), *d4,
        descriptors.data_ptr(), descriptors.shape[0], descriptors.shape[1],
        tex_transforms.data_ptr() if tf else None,
        tex_transforms.shape[0] if tf else 1, N, int(duv is not None),
        int(tf), int(has_nearest), idx.data_ptr(), w.data_ptr())
    return idx, w


def filter_taps_reference(texq, idx, w, *, mips: bool):
    """Plain PyTorch twin of K5: the rows texq[clip(idx)] widened to f32,
    filtered with the (11, N) weights -> (4, N) f32."""
    ncols = 52 if mips else 16
    safe = idx.clamp(0, texq.shape[0] - 1).long()
    cols = texq.index_select(0, safe)[:, :ncols].float().T
    return torch.stack(_apply_tap_weights(cols, w, parent=mips))


def filter_taps_fused(texq, idx, w, *, mips: bool):
    """K5: gather + filter. texq (R, TEXEL_COLS) bf16 texel pool, idx (N,)
    int32 (clipped to the pool here), w (11, N) f32 from K4 -> rgba
    (4, N) f32. With mips the parent 3x3 and the trilinear blend are
    read too (52 columns), else the bilinear quad only (16)."""
    if texq.device.type == "cpu":
        return filter_taps_reference(texq, idx, w, mips=mips)
    # the kernel reads whole 128-byte rows as 16-byte vectors
    if texq.dtype != torch.bfloat16 or texq.dim() != 2 \
            or texq.shape[1] != TEXEL_COLS:
        raise ValueError(f"texq must be (R, {TEXEL_COLS}) bf16 rows")
    if not texq.is_contiguous() or texq.data_ptr() % 16:
        raise ValueError("texq must be contiguous and 16-byte aligned")
    N = idx.shape[0]
    if idx.dtype != torch.int32 or idx.dim() != 1:
        raise ValueError("idx must be (N,) int32")
    if w.dtype != torch.float32 or w.shape != (N_WEIGHTS, N):
        raise ValueError(f"w must be ({N_WEIGHTS}, N) f32")
    kernels.check_cuda(texq, idx, w)
    out = torch.empty((4, N), dtype=torch.float32, device=idx.device)
    kernels.launch("filter_taps_fused", "awsm_filter_taps",
                   texq.data_ptr(), texq.shape[0], idx.data_ptr(),
                   w.data_ptr(), N, int(mips), out.data_ptr())
    return out


def sample_texture_block_c(texq, descriptors, taps, has_nearest: bool = True,
                           tex_transforms=None):
    """Sample many texture taps through ONE plan (K4) and ONE gather +
    filter (K5) -> K5's (4, n_taps * P) rgba block, tap i at columns
    [i * P, (i + 1) * P), unbound taps (tex_id < 0) not whitened.

    taps: list of (tex_id (P,) int32, (u, v), duv or None [, tform_id
    (P,) int32 or None]); duv = (du_dx, dv_dx, du_dy, dv_dy) enables the
    gradient mip LOD and trilinear filtering (one texel row per tap even
    then: it carries the parent-mip 3x3). Every tap carries duv or none
    does."""
    P = taps[0][0].shape[0]
    mips = {t[2] is not None for t in taps}
    if len(mips) != 1:
        raise ValueError("taps must all carry gradients or none may")
    mips = mips.pop()

    def cat(xs):
        return torch.cat(xs) if len(xs) > 1 else xs[0]

    ids = cat([t[0].to(torch.int32) for t in taps])
    u_all = cat([t[1][0] for t in taps])
    v_all = cat([t[1][1] for t in taps])
    duv = (tuple(cat([t[2][c] for t in taps]) for c in range(4))
           if mips else None)
    tforms = [t[3] if len(t) > 3 else None for t in taps]
    tform_all = None
    if any(tf is not None for tf in tforms):
        none_t = torch.full((P,), -1, dtype=torch.int32, device=ids.device)
        tform_all = cat([none_t if tf is None else tf.to(torch.int32)
                         for tf in tforms])
    idx, w = tap_plan_fused(ids, u_all, v_all, duv, descriptors,
                            has_nearest=has_nearest, tform_id=tform_all,
                            tex_transforms=(tex_transforms
                                            if tform_all is not None
                                            else None))
    return filter_taps_fused(texq, idx, w, mips=mips)


def sample_texture_batch_c(texq, descriptors, taps, has_nearest: bool = True,
                           tex_transforms=None):
    """sample_texture_block_c's taps, channel-column form: one [r, g, b,
    a] list of (P,) planes per tap; tex_id < 0 gives white."""
    if not taps:
        return []
    P = taps[0][0].shape[0]
    rgba = sample_texture_block_c(texq, descriptors, taps, has_nearest,
                                  tex_transforms)
    one = torch.ones((), device=rgba.device)
    outs = []
    for i, t in enumerate(taps):
        bound = t[0] >= 0
        outs.append([torch.where(bound, c[i * P:(i + 1) * P], one)
                     for c in rgba])
    return outs


def sample_texture_batch(texq, descriptors, taps, has_nearest: bool = True):
    """AoS wrapper over sample_texture_batch_c: taps carry (P, 2) uv and
    ((P, 2), (P, 2)) duv; results come back as (P, 4)."""
    conv = []
    for tex_id, uv, duv in taps:
        duv_c = None if duv is None else (duv[0][:, 0], duv[0][:, 1],
                                          duv[1][:, 0], duv[1][:, 1])
        conv.append((tex_id, (uv[:, 0], uv[:, 1]), duv_c))
    return [torch.stack(ch, dim=-1)
            for ch in sample_texture_batch_c(texq, descriptors, conv,
                                             has_nearest)]


def sample_texture(texq, descriptors, tex_id, uv, mip_level=None,
                   has_nearest: bool = True):
    """Sample textures per pixel at the base level or at an explicit
    (P,) f32 mip level (trilinear when the sampler's mip filter is
    linear) -> (P, 4); tex_id < 0 gives white. The footprint math runs in
    PyTorch, the gather + filter in K5."""
    if mip_level is None:
        return sample_texture_batch(texq, descriptors, [(tex_id, uv, None)],
                                    has_nearest)[0]
    desc = descriptors.index_select(
        0, tex_id.clamp(0, descriptors.shape[0] - 1).long())
    level = torch.clamp(torch.minimum(
        mip_level, desc[:, TD_N_MIPS].float() - 1.0), min=0.0)
    l0 = torch.floor(level).to(torch.int32)
    frac = level - l0.float()
    u, v = uv[:, 0], uv[:, 1]
    idx, *plan = _level_idx(desc, u, v, l0)
    w = torch.stack(_tap_weights(desc, u, v, plan, frac, has_nearest))
    out = filter_taps_fused(texq, idx.to(torch.int32).contiguous(), w,
                            mips=True).T
    return torch.where((tex_id >= 0)[:, None], out, torch.ones_like(out))
