"""Deferred opaque shading: attribute resolve (K2), material fetch (K3),
texture taps (K4 + K5), punctual + IBL lighting (K6 env taps), skybox on
miss.

Port of the opaque path of awsm_renderer_tpu/ops/shade.py: every texture
slot, KHR_texture_transform, normal mapping, the opaque material
extensions (clearcoat, sheen, iridescence, anisotropy, specular), the
debug views, a solid or image environment, the dense punctual-light
loop and the tiled light lists (passes/light_culling.py); the
transparent pass's forward shade and composite, band-wide, compacted
over 8x128 tiles or rasterized compacted over 32x32 tiles. All shading
math runs on flat (P,) channel planes (ops/cvec.py lists); camera
parameters and the dense loop's light rows enter as Python floats, the
tiled loop's light rows as the device table.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import torch

from ..core import materials as M
from ..core.lights import (
    L_COLOR, L_DIRECTION, L_INNER_COS, L_KIND, L_OUTER_COS, L_POSITION,
    L_RANGE, LIGHT_F32,
)
from ..core.textures import TEXEL_COLS
from ..utils.profiling import count
from . import brdf, kernels
from .cubemap import sample_env_batch_c
from .cvec import (
    add as v_add, cross3, dot3, lerp as v_lerp, mul as v_mul, norm3,
    scale as v_scale, where as v_where,
)
from .relayout import (
    gather_split_channels, gather_split_channels_reference,
    onehot_split_rows, onehot_split_rows_reference,
)
from .texsample import sample_texture_block_c
from .vertex import (
    NSETUP, S_COLOR, S_E0A, S_E0B, S_E0C, S_E1A, S_E1B, S_E1C, S_E2A, S_E2B,
    S_E2C, S_IW0, S_MAT_ROW, S_NORMAL, S_TANGENT, S_TANGENT_W, S_UV0, S_UV1,
)

_EPS = 1e-6
NO_SLOTS = (False,) * M.NUM_TEX_SLOTS
ALL_SLOTS = (True,) * M.NUM_TEX_SLOTS
# extension flags: (clearcoat, sheen, iridescence, anisotropy,
# transmission, volume), static per bucket like the reference's template
# variables
(EXT_CLEARCOAT, EXT_SHEEN, EXT_IRIDESCENCE, EXT_ANISOTROPY,
 EXT_TRANSMISSION, EXT_VOLUME) = range(6)
NO_EXT = (False,) * 6
ALL_EXT = (True,) * 6
# global channel-isolation debug views ("channel:<name>"); indices match
# the per-material debug bitmask's bit order
DEBUG_CHANNELS = {
    "basecolor": 0,
    "metallicroughness": 1,
    "normals": 2,
    "occlusion": 3,
    "emissive": 4,
    "specular": 5,
}



@dataclass(frozen=True)
class ShadeSpec:
    """A shade call's specialization: the host values that pick its code
    path, as the reference's shader-template variables do. slot_mask /
    ext: the texture slots and material extensions the bucket's
    materials use (everything else compiles to constants); solid_env: a
    solid environment's constants in place of the texel pool's image
    rows; use_mips: mip-mapped taps; has_nearest: some texture filters
    nearest; light_tiles: punctual lights through per-unit tiled lists
    (_punctual_lights_tiled) instead of the dense loop; debug_mode: the
    view drawn, none | normals (the shading normal as colour) | ibl |
    punctual | material | channel:<name>. A frame's come from
    passes/frame.py FrameSpec."""

    slot_mask: tuple = NO_SLOTS
    ext: tuple = NO_EXT
    solid_env: bool = False
    use_mips: bool = True
    has_nearest: bool = True
    light_tiles: bool = False
    debug_mode: str = "none"


#: resolved-plane names the resolve emits, in output order
RESOLVE_NAMES = (
    "tri_id", "mat_row", "uv0_u", "uv0_v", "uv1_u", "uv1_v",
    "color_r", "color_g", "color_b", "color_a",
    "normal_x", "normal_y", "normal_z",
    "tangent_x", "tangent_y", "tangent_z", "tangent_w",
    "du0_dx", "dv0_dx", "du0_dy", "dv0_dy",
)


def env_brdf_approx(n_dot_v, roughness):
    """Analytic split-sum environment BRDF (Lazarov 2013 fit) — the
    reference replaces the BRDF LUT fetch with this ALU."""
    rx = roughness * -1.0 + 1.0
    ry = roughness * -0.0275 + 0.0425
    rz = roughness * -0.572 + 1.04
    rw = roughness * 0.022 + -0.04
    a004 = torch.minimum(rx * rx, torch.exp2(-9.28 * n_dot_v)) * rx + ry
    return a004 * -1.04 + rz, a004 * 1.04 + rw  # (A, B)


def _one_light(row, n_pos, n, v, base_diffuse, f0, alpha_rough, n_dot_v,
               total):
    """Shade ONE light (host row of LIGHT_F32 floats) into `total`."""
    kind = row[L_KIND]
    intensity = row[4]
    lrange = row[L_RANGE]
    is_dir = kind == 0.0

    if is_dir:
        tl = [torch.full_like(n_pos[0], -row[L_DIRECTION + k])
              for k in range(3)]
    else:
        tl = [row[L_POSITION + k] - n_pos[k] for k in range(3)]
    dist = torch.sqrt(dot3(tl, tl))
    inv_d = 1.0 / torch.clamp(dist, min=_EPS)
    l = v_scale(tl, inv_d)

    rad = torch.clamp(dot3(n, l), min=0.0)            # n_dot_l
    n_dot_l = rad
    if not is_dir:
        rad = rad * (1.0 / torch.clamp(dist * dist, min=_EPS))
        if lrange > 0.0:
            ratio = dist / max(lrange, _EPS)
            rad = rad * torch.clamp(1.0 - ratio ** 4, 0.0, 1.0) ** 2
    if kind == 2.0:
        cd = -(l[0] * row[L_DIRECTION] + l[1] * row[L_DIRECTION + 1]
               + l[2] * row[L_DIRECTION + 2])
        rad = rad * torch.clamp(
            (cd - row[L_OUTER_COS])
            / max(row[L_INNER_COS] - row[L_OUTER_COS], 1e-4), 0.0, 1.0)
    rad = rad * intensity

    h = norm3(v_add(l, v))
    n_dot_h = torch.clamp(dot3(n, h), min=0.0)
    v_dot_h = torch.clamp(dot3(v, h), min=0.0)
    f = brdf.f_schlick3(v_dot_h, f0)
    spec_s = brdf.specular_ggx(n_dot_l, n_dot_v, n_dot_h, alpha_rough)
    inv_pi = 1.0 / math.pi
    for c in range(3):
        lobe = base_diffuse[c] * inv_pi * (1.0 - f[c]) + spec_s * f[c]
        total[c] = total[c] + (row[L_COLOR + c] * rad) * lobe
    return total


def _one_light_listed(row, active, n_pos, n, v, base_diffuse, f0,
                      alpha_rough, n_dot_v, total):
    """Shade one slot of the tiled lists into `total`: row(j) gives the
    (n_units, 1) column of light field j, one light a unit, broadcasting
    against (n_units, 128) pixel planes; `active` (n_units, 1) marks the
    units whose slot holds a light. The kind, range and spot branches of
    _one_light are selects here, in the reference's factor order (its
    _one_light, the form both of its loops share)."""
    kind = row(L_KIND)
    lrange = row(L_RANGE)
    is_dir = kind == 0.0
    tl = [torch.where(is_dir, -row(L_DIRECTION + k),
                      row(L_POSITION + k) - n_pos[k]) for k in range(3)]
    dist = torch.sqrt(dot3(tl, tl))
    inv_d = 1.0 / torch.clamp(dist, min=_EPS)
    l = v_scale(tl, inv_d)
    atten = torch.where(is_dir, 1.0,
                        1.0 / torch.clamp(dist * dist, min=_EPS))
    window = torch.where(
        (lrange > 0.0) & ~is_dir,
        torch.clamp(1.0 - (dist / torch.clamp(lrange, min=_EPS)) ** 4,
                    0.0, 1.0) ** 2, 1.0)
    cd = -(l[0] * row(L_DIRECTION) + l[1] * row(L_DIRECTION + 1)
           + l[2] * row(L_DIRECTION + 2))
    spot = torch.where(
        kind == 2.0,
        torch.clamp((cd - row(L_OUTER_COS))
                    / torch.clamp(row(L_INNER_COS) - row(L_OUTER_COS),
                                  min=1e-4), 0.0, 1.0), 1.0)
    n_dot_l = torch.clamp(dot3(n, l), min=0.0)
    h = norm3(v_add(l, v))
    n_dot_h = torch.clamp(dot3(n, h), min=0.0)
    v_dot_h = torch.clamp(dot3(v, h), min=0.0)
    f = brdf.f_schlick3(v_dot_h, f0)
    spec_s = brdf.specular_ggx(n_dot_l, n_dot_v, n_dot_h, alpha_rough)
    rad = atten * window * spot * n_dot_l * row(4)
    gated = torch.where(active, rad, 0.0)
    inv_pi = 1.0 / math.pi
    for c in range(3):
        lobe = base_diffuse[c] * inv_pi * (1.0 - f[c]) + spec_s * f[c]
        total[c] = total[c] + (row(L_COLOR + c) * gated) * lobe
    return total


def _punctual_lights(ds, n_pos, n, v, base_diffuse, f0, alpha_rough,
                     light_tiles: bool, valid, rows):
    """Punctual lighting: the dense loop over the live lights' host `rows`
    (rows >= n_lights would add exact zeros in the reference's masked
    capacity loop), or with light_tiles the tiled-list loop over the
    covered (`valid`) pixels' unit boxes."""
    if light_tiles:
        return _punctual_lights_tiled(ds, n_pos, n, v, base_diffuse, f0,
                                      alpha_rough, valid)
    n_dot_v = torch.clamp(dot3(n, v), min=_EPS)
    total = [torch.zeros_like(alpha_rough) for _ in range(3)]
    for row in rows:
        total = _one_light([float(x) for x in row], n_pos, n, v,
                           base_diffuse, f0, alpha_rough, n_dot_v, total)
    return total


def _punctual_lights_tiled(ds, n_pos, n, v, base_diffuse, f0, alpha_rough,
                           valid):
    """Tiled-light-list punctual lighting (reference: shade.py
    _punctual_lights_tiled). The (P,) planes cut into units of 128
    consecutive pixels, the same pixels as the reference's in every shade
    layout; each unit's world AABB over its covered (`valid`) pixels
    (miss pixels reconstruct at the far plane and would stretch the box)
    selects up to MAX_LIGHTS_PER_TILE lights
    (passes/light_culling.py), and the loop runs the list's K slots with
    one light row a unit. Equal to the dense loop up to summation order
    whenever at most MAX_LIGHTS_PER_TILE lights reach any unit; beyond
    that a unit drops its faintest lights by estimated contribution."""
    from ..passes import light_culling as LC

    lights = ds["lights"]                   # (L, 16) device rows
    K = min(LC.MAX_LIGHTS_PER_TILE, lights.shape[0])
    P = alpha_rough.shape[0]
    U = 128
    n_units = P // U

    def units(x):
        return x.reshape(n_units, U)

    pos_u = [units(p) for p in n_pos]
    v_u = units(valid)
    mn = [torch.where(v_u, p, 3e38).amin(dim=1) for p in pos_u]
    mx = [torch.where(v_u, p, -3e38).amax(dim=1) for p in pos_u]
    lidx, listed = LC.light_lists_from_bounds(mn, mx, lights,
                                              ds["n_lights"], K)

    n_dot_v = units(torch.clamp(dot3(n, v), min=_EPS))
    args = ([units(x) for x in n], [units(x) for x in v],
            [units(x) for x in base_diffuse], [units(x) for x in f0],
            units(alpha_rough), n_dot_v)
    total = [torch.zeros((n_units, U), device=lights.device)
             for _ in range(3)]
    for k in range(K):
        params = lights.index_select(0, lidx[:, k])   # (n_units, 16)

        def row(j):
            return params[:, j:j + 1]

        total = _one_light_listed(row, listed[:, k:k + 1], pos_u, *args,
                                  total)
    return [t.reshape(P) for t in total]


def _material_table(ds) -> torch.Tensor:
    """Fused material table (cap, NUM_F32 + slots*3 + NUM_I32) f32: float
    params, the (tex id, uv set, transform id) of every slot, the flags."""
    cap = ds["mat_float"].shape[0]
    return torch.cat([ds["mat_float"],
                      ds["mat_tex"].reshape(cap, -1).float(),
                      ds["mat_flags"].float()], dim=1)


def _material_columns(ds, slot_mask, debug_mode: str,
                      slots_only: bool = False):
    """The fused-table columns a shade call reads — the float params, the
    3 columns of each active slot, the kind and alpha-mode flags (+ the
    debug bitmask for the per-material view); slots_only: the active
    slots' alone (K14 reads the rest itself) — as (column list, int64
    index tensor on the table's device). The index tensor is built once
    per (slot_mask, view) and kept in `ds`: indexing the table with a
    Python list copies the list to the card on every call, which waits
    for the stream."""
    flag0 = M.NUM_F32 + M.NUM_TEX_SLOTS * 3
    slots = [M.NUM_F32 + s * 3 + c for s in range(M.NUM_TEX_SLOTS)
             if slot_mask[s] for c in range(3)]
    if slots_only:
        needed = slots
    else:
        needed = list(range(M.NUM_F32)) + slots
        needed += [flag0 + M.MI_KIND, flag0 + M.MI_ALPHA_MODE]
    if debug_mode == "material":
        needed.append(flag0 + M.MI_DEBUG_MASK)
    cache = ds.setdefault("mat_columns", {})
    key = tuple(needed)
    if key not in cache:
        cache[key] = torch.tensor(needed, dtype=torch.int64,
                                  device=ds["mat_float"].device)
    return needed, cache[key]


def _screen_gradient(ch, W: int, H: int, vertical: bool = False,
                     layers: int = 1):
    """Min-magnitude forward/backward screen difference of one (P,) plane
    (the GPU quad-derivative model; the smaller difference stays on the
    surface at silhouettes). layers > 1: `ch` holds that many stacked
    images of H // layers rows; differences never cross a layer
    boundary."""
    g = ch.reshape(layers, H // layers, W)
    ax = 1 if vertical else 2
    d = torch.diff(g, dim=ax)
    first, last = d.narrow(ax, 0, 1), d.narrow(ax, d.shape[ax] - 1, 1)
    fwd = torch.cat([d, last], ax)        # edge-replicated
    bwd = torch.cat([first, d], ax)
    return torch.where(torch.abs(fwd) <= torch.abs(bwd), fwd,
                       bwd).reshape(-1)


def _tm(x, t):
    """x times a texture channel; an unbound slot's constant 1.0 costs no
    op (x * 1.0 == x exactly)."""
    return x if isinstance(t, float) and t == 1.0 else x * t


def _resolve_math(ch, px, py):
    """Per-pixel attribute reconstruction (the reference's _resolve_math):
    `ch` indexable by setup-row constant, one tensor per channel; px/py
    pixel centers. Returns {name: plane} for RESOLVE_NAMES[1:]."""
    e0 = ch[S_E0A] * px + (ch[S_E0B] * py + ch[S_E0C])
    e1 = ch[S_E1A] * px + (ch[S_E1B] * py + ch[S_E1C])
    e2 = ch[S_E2A] * px + (ch[S_E2B] * py + ch[S_E2C])
    iw0, iw1, iw2 = ch[S_IW0], ch[S_IW0 + 1], ch[S_IW0 + 2]
    pb0 = e0 * iw0
    pb1 = e1 * iw1
    pb2 = e2 * iw2
    denom = pb0 + pb1 + pb2
    inv_denom = 1.0 / torch.where(torch.abs(denom) > 1e-30, denom,
                                  torch.ones_like(denom))
    pn0 = pb0 * inv_denom
    pn1 = pb1 * inv_denom
    pn2 = pb2 * inv_denom

    def interp(row):
        return pn0 * ch[row] + pn1 * ch[row + 1] + pn2 * ch[row + 2]

    out = {"mat_row": ch[S_MAT_ROW],
           "uv0_u": interp(S_UV0), "uv0_v": interp(S_UV0 + 3),
           "uv1_u": interp(S_UV1), "uv1_v": interp(S_UV1 + 3)}
    for i, name in enumerate(("color_r", "color_g", "color_b", "color_a")):
        out[name] = interp(S_COLOR + 3 * i)
    for i, name in enumerate(("normal_x", "normal_y", "normal_z")):
        out[name] = interp(S_NORMAL + 3 * i)
    for i, name in enumerate(("tangent_x", "tangent_y", "tangent_z")):
        out[name] = interp(S_TANGENT + 3 * i)
    out["tangent_w"] = ch[S_TANGENT_W]

    a0, a1, a2 = ch[S_E0A], ch[S_E1A], ch[S_E2A]
    b0, b1, b2 = ch[S_E0B], ch[S_E1B], ch[S_E2B]
    dD_dx = a0 * iw0 + a1 * iw1 + a2 * iw2
    dD_dy = b0 * iw0 + b1 * iw1 + b2 * iw2
    dpn0_dx = inv_denom * (a0 * iw0 - pn0 * dD_dx)
    dpn1_dx = inv_denom * (a1 * iw1 - pn1 * dD_dx)
    dpn2_dx = inv_denom * (a2 * iw2 - pn2 * dD_dx)
    dpn0_dy = inv_denom * (b0 * iw0 - pn0 * dD_dy)
    dpn1_dy = inv_denom * (b1 * iw1 - pn1 * dD_dy)
    dpn2_dy = inv_denom * (b2 * iw2 - pn2 * dD_dy)
    u0a, u0b, u0c = ch[S_UV0], ch[S_UV0 + 1], ch[S_UV0 + 2]
    v0a, v0b, v0c = ch[S_UV0 + 3], ch[S_UV0 + 4], ch[S_UV0 + 5]
    out["du0_dx"] = dpn0_dx * u0a + dpn1_dx * u0b + dpn2_dx * u0c
    out["dv0_dx"] = dpn0_dx * v0a + dpn1_dx * v0b + dpn2_dx * v0c
    out["du0_dy"] = dpn0_dy * u0a + dpn1_dy * u0b + dpn2_dy * u0c
    out["dv0_dy"] = dpn0_dy * v0a + dpn1_dy * v0b + dpn2_dy * v0c
    return out


def resolve_planes_reference(tid: torch.Tensor, setup_rows: torch.Tensor, *,
                             width: int, row_offset: int = 0,
                             coord_scale: int = 1, px=None, py=None):
    """Plain PyTorch twin of K2: winner column (P,) int32 -> {name: (P,)}
    for RESOLVE_NAMES. tri_id is the column itself (-1 on a miss); every
    float plane is 0 on a miss. The planes are evaluated at (x *
    coord_scale + 0.5, (y + row_offset) * coord_scale + 0.5) for flat
    index i = y * width + x, or at explicit raster-space centers px/py
    (P,) f32 when given."""
    P = tid.shape[0]
    T = setup_rows.shape[0]
    S = setup_rows.index_select(0, tid.clamp(0, T - 1).long())   # (P, 64)
    ch = S.T
    if px is None:
        i = torch.arange(P, device=tid.device)
        px = (i % width).float() * coord_scale + 0.5
        py = ((torch.div(i, width, rounding_mode="floor")
               + row_offset).float() * coord_scale + 0.5)
    res = _resolve_math(ch, px, py)
    miss = tid < 0
    out = {"tri_id": torch.where(miss, torch.full_like(tid, -1), tid)}
    zero = torch.zeros((), device=tid.device)
    for name in RESOLVE_NAMES[1:]:
        out[name] = torch.where(miss, zero, res[name])
    return out


def resolve_planes_fused(tid: torch.Tensor, setup_rows: torch.Tensor, *,
                         width: int, row_offset: int = 0,
                         coord_scale: int = 1, px=None, py=None):
    """K2: slim winner buffer -> the 21 RESOLVE_NAMES planes (P,).

    tid (P,) int32 raster columns (-1 = miss) over a width-wide pixel
    grid starting at row `row_offset`; setup_rows (T', NSETUP) f32.
    coord_scale 2: the ids were taken at the top-left sample of a raster
    at twice the resolution (MSAA), whose plane equations are evaluated
    at that sample's center. px/py (P,) f32: explicit raster-space
    centers (the covered-tile-compacted shade, whose flat index no longer
    encodes the screen position); width/row_offset/coord_scale are then
    unused. A CUDA tensor launches csrc/resolve.cu; a CPU tensor takes
    the twin."""
    if (px is None) != (py is None):
        raise ValueError("px and py go together")
    if tid.device.type == "cpu":
        return resolve_planes_reference(tid, setup_rows, width=width,
                                        row_offset=row_offset,
                                        coord_scale=coord_scale, px=px,
                                        py=py)
    if tid.dtype != torch.int32 or tid.dim() != 1:
        raise ValueError("tid must be (P,) int32")
    if setup_rows.dtype != torch.float32 or setup_rows.shape[1] != NSETUP:
        raise ValueError(f"setup rows must be (T, {NSETUP}) f32")
    P = tid.shape[0]
    xy = ()
    if px is not None:
        if (px.dtype != torch.float32 or py.dtype != torch.float32
                or px.shape != (P,) or py.shape != (P,)):
            raise ValueError("px/py must be (P,) f32")
        xy = (px, py)
    kernels.check_cuda(tid, setup_rows, *xy)
    out_tid = torch.empty_like(tid)
    planes = torch.empty((len(RESOLVE_NAMES) - 1, P), dtype=torch.float32,
                         device=tid.device)
    kernels.launch("resolve_planes_fused", "awsm_resolve",
                   tid.data_ptr(), setup_rows.data_ptr(),
                   setup_rows.shape[0], P, width, row_offset, coord_scale,
                   px.data_ptr() if xy else None,
                   py.data_ptr() if xy else None,
                   out_tid.data_ptr(), planes.data_ptr())
    out = {"tri_id": out_tid}
    out.update(zip(RESOLVE_NAMES[1:], planes))
    return out


def _surface_mode(debug_mode: str) -> str:
    """The view shade_surface draws for a frame's debug_mode: normals |
    ibl | punctual | material | channel:<name>, else none (the edge view
    never reaches the shade)."""
    if (debug_mode in ("normals", "ibl", "punctual", "material")
            or debug_mode.startswith("channel:")):
        return debug_mode
    return "none"


def _in_k14_scope(spec: ShadeSpec) -> bool:
    """Whether K14 covers a shade call: no material extension, the plain
    or the normals view, the dense light loop."""
    return (not any(spec.ext) and spec.debug_mode in ("none", "normals")
            and not spec.light_tiles)


def shade_surface(planes, ds, spec: ShadeSpec, *, width: int, height: int,
                  height_full: int | None = None, row_offset: int = 0,
                  width_full: int | None = None, col_offset: int = 0,
                  transparent_pass: bool = False, want_sky: bool = False,
                  n_layer_tiles: int = 1):
    """Fragment shading shared by the opaque, transparent and HUD passes
    -> (rgb [3 planes], alpha, valid), plus with transparent_pass the
    transmission factor [3 planes] and the refraction info (refracted
    background index (P,) int32, IBL-fallback mask, fallback colour) —
    None without KHR_materials_volume. want_sky: a miss takes the
    environment's sky colour (the opaque pass).

    planes: {name: (P,)} G-buffer (tri_id, depth, mat_row, uv0, optional
    uv1 and colour, normal, tangent, optional analytic uv derivatives;
    tile-compacted planes carry their pixels' ndc_x/ndc_y) over a
    (height, width) grid of band rows starting at row_offset in a
    height_full-row frame (and, for a 2-D screen tile, of columns starting
    at col_offset in a width_full-column frame); n_layer_tiles > 1 marks
    that many stacked layer
    images (screen rows wrap per layer). spec: the call's specialization.
    alpha is 1 / the mask cutoff test / base alpha per alpha mode (the
    editor grid's line alpha in the transparent pass).

    The texture taps (K4 + K5) run first. A call in K14's scope
    (_in_k14_scope) then shades in one launch (shade_surface_fused; its
    plain twin on a CPU tensor); any other call runs the op-by-op chain
    (_shade_math) and counts `shade/chain`."""
    fused = _in_k14_scope(spec)
    if not fused:
        count("shade/chain")
    valid = planes["tri_id"] >= 0
    geom = dict(width=width, height=height,
                height_full=height if height_full is None else height_full,
                width_full=width if width_full is None else width_full,
                row_offset=row_offset, col_offset=col_offset,
                n_layer_tiles=n_layer_tiles)

    # ---- material fetch (K3): only the columns this call reads (K14's
    # route: the active slots' alone, none without an active slot)
    needed, col_idx = _material_columns(ds, spec.slot_mask, spec.debug_mode,
                                        slots_only=fused)
    cols = {}
    if needed:
        table = _material_table(ds).index_select(1, col_idx)
        mat_row = planes["mat_row"].to(torch.int32).clamp(
            0, table.shape[0] - 1)
        cols = dict(zip(needed, onehot_split_rows(mat_row, table)))

    taps = _texture_taps(planes, ds, cols, spec, width=width, height=height,
                         n_layer_tiles=n_layer_tiles)
    if fused:
        color, alpha, trans = shade_surface_fused(
            planes, ds, taps, slot_mask=spec.slot_mask,
            solid_env=spec.solid_env, transparent_pass=transparent_pass,
            want_sky=want_sky, normals_view=spec.debug_mode == "normals",
            **geom)
        refr = None
    else:
        color, alpha, trans, refr = _shade_math(
            planes, ds, cols, taps, valid, spec,
            transparent_pass=transparent_pass, want_sky=want_sky,
            light_rows=ds["lights_host"][:ds["n_lights"]],
            gather=gather_split_channels, **geom)
    if transparent_pass:
        return color, alpha, valid, trans, refr
    return color, alpha, valid


def _texture_taps(planes, ds, cols, spec: ShadeSpec, *, width: int,
                  height: int, n_layer_tiles: int):
    """Every active slot through one K4 plan + one K5 -> K5's (4, n_active
    * P) rgba block (tap t: the t-th active slot, every pixel, bound to a
    texture or not), or None without an active slot. cols: the fetched
    material columns by fused-table number."""
    active = [s for s in range(M.NUM_TEX_SLOTS) if spec.slot_mask[s]]
    if not active:
        return None
    uv0 = (planes["uv0_u"], planes["uv0_v"])
    uv1 = (planes["uv1_u"], planes["uv1_v"]) if "uv1_u" in planes else uv0
    duv = None
    if spec.use_mips:
        if "du0_dx" in planes:
            duv = (planes["du0_dx"], planes["dv0_dx"], planes["du0_dy"],
                   planes["dv0_dy"])
        else:
            # screen-space gradients of uv0, also for uv1 taps (as the
            # reference does)
            L = n_layer_tiles
            duv = (_screen_gradient(uv0[0], width, height, layers=L),
                   _screen_gradient(uv0[1], width, height, layers=L),
                   _screen_gradient(uv0[0], width, height, vertical=True,
                                    layers=L),
                   _screen_gradient(uv0[1], width, height, vertical=True,
                                    layers=L))
    taps = []
    for slot in active:
        col0 = M.NUM_F32 + slot * 3
        tex_id = cols[col0].to(torch.int32)
        tform = cols[col0 + 2].to(torch.int32)
        if uv1 is uv0:
            u, vv = uv0
        else:
            use1 = cols[col0 + 1] == 1.0
            u = torch.where(use1, uv1[0], uv0[0])
            vv = torch.where(use1, uv1[1], uv0[1])
        taps.append((tex_id, (u, vv), duv, tform))
    return sample_texture_block_c(
        ds["texels"], ds["tex_desc"], taps, has_nearest=spec.has_nearest,
        tex_transforms=ds["tex_transforms"])


def _view_rays(planes, cam, *, width: int, height: int, height_full: int,
               width_full: int, row_offset: int, col_offset: int,
               n_layer_tiles: int):
    """The pixels' world positions (reconstructed from depth) [3 planes],
    the camera position [3 floats] and the unit rays to it [3 planes]."""
    P = width * height
    depth = planes["depth"]
    if "ndc_x" in planes:
        # tile-compacted planes: the flat index no longer encodes the
        # screen position, so the pixels' NDC coordinates ride as planes
        xs, ys = planes["ndc_x"], planes["ndc_y"]
    else:
        # the divisors are tensors: PyTorch on the card multiplies by a
        # Python scalar divisor's reciprocal, an ulp off the IEEE quotient
        # that K14 and the CPU take, and the GGX peak of a 0.04-roughness
        # surface turns an ulp of the view ray into ~1e-3 of colour
        i = torch.arange(P, device=depth.device)
        xs = (i % width).float()
        if col_offset:
            xs = xs + float(col_offset)
        xs = (xs + 0.5) / torch.full_like(xs, width_full) * 2.0 - 1.0
        rows = torch.div(i, width, rounding_mode="floor")
        if n_layer_tiles > 1:      # stacked layers: rows wrap per layer
            rows = rows % (height // n_layer_tiles)
        ys = (rows + row_offset).float() + 0.5
        ys = 1.0 - ys / torch.full_like(ys, height_full) * 2.0
    ivp = [[float(x) for x in r] for r in cam["inv_view_proj"]]
    wp = [xs * ivp[j][0] + ys * ivp[j][1] + depth * ivp[j][2] + ivp[j][3]
          for j in range(4)]
    inv_w = 1.0 / torch.where(torch.abs(wp[3]) > _EPS, wp[3],
                              torch.full_like(wp[3], _EPS))
    world_pos = [wp[0] * inv_w, wp[1] * inv_w, wp[2] * inv_w]
    cam_pos = [float(x) for x in cam["position"]]
    v = norm3([cam_pos[k] - world_pos[k] for k in range(3)])
    return world_pos, cam_pos, v


def _shade_math(planes, ds, cols, taps, valid, spec: ShadeSpec, *,
                transparent_pass: bool, want_sky: bool, light_rows, gather,
                width: int, height: int, height_full: int, width_full: int,
                row_offset: int, col_offset: int, n_layer_tiles: int):
    """The shade after the taps, op by op on (P,) planes -> (rgb, alpha,
    transmission factor or None, refraction info or None): the chain's
    math, and K14's plain twin's. cols: material columns by fused-table
    number; taps: _texture_taps's block; light_rows: the dense loop's
    host rows; gather: the env taps' texel-pool gather (K6 or its
    twin)."""
    slot_mask, ext, debug_mode = spec.slot_mask, spec.ext, spec.debug_mode
    solid_env, light_tiles = spec.solid_env, spec.light_tiles
    P = width * height
    dev = planes["tri_id"].device
    if "color_r" in planes:
        vcolor = [planes["color_r"], planes["color_g"], planes["color_b"],
                  planes["color_a"]]
    else:
        vcolor = [1.0, 1.0, 1.0, 1.0]
    n = norm3([planes["normal_x"], planes["normal_y"], planes["normal_z"]])
    cam = ds["camera"]
    world_pos, cam_pos, v = _view_rays(
        planes, cam, width=width, height=height, height_full=height_full,
        width_full=width_full, row_offset=row_offset, col_offset=col_offset,
        n_layer_tiles=n_layer_tiles)
    H_full = height_full

    flag0 = M.NUM_F32 + M.NUM_TEX_SLOTS * 3

    def mf(idx, k=1):
        return cols[idx] if k == 1 else [cols[idx + c] for c in range(k)]

    def slot_col(slot, c):
        return cols[M.NUM_F32 + slot * 3 + c]

    def mflag(idx):
        return cols[flag0 + idx]

    is_unlit = mflag(M.MI_KIND) == float(M.KIND_UNLIT)
    is_grid = mflag(M.MI_KIND) == float(M.KIND_GRID)

    tap_of = {s: t for t, s in enumerate(
        s for s in range(M.NUM_TEX_SLOTS) if slot_mask[s])}
    tex_cache = {}
    one = torch.ones((), device=dev)

    def tex(slot):
        """A slot's sampled [r, g, b, a] (white where the pixel's material
        binds no texture there), or constant white when no material of
        the bucket binds the slot."""
        if slot not in tap_of:
            return [1.0, 1.0, 1.0, 1.0]
        if slot not in tex_cache:
            t = tap_of[slot]
            bound = slot_col(slot, 0) >= 0
            tex_cache[slot] = [torch.where(bound, c[t * P:(t + 1) * P], one)
                               for c in taps]
        return tex_cache[slot]

    base_tex = tex(M.TS_BASE_COLOR)
    base_f = mf(M.MF_BASE_COLOR, 4)
    base = [_tm(_tm(base_f[c], base_tex[c]), vcolor[c]) for c in range(4)]

    mr = tex(M.TS_METALLIC_ROUGHNESS)
    metallic = torch.clamp(_tm(mf(M.MF_METALLIC), mr[2]), 0.0, 1.0)
    roughness = torch.clamp(_tm(mf(M.MF_ROUGHNESS), mr[1]), 0.04, 1.0)
    alpha_rough = roughness * roughness
    occlusion = 1.0 + mf(M.MF_OCCLUSION_STRENGTH) * (
        tex(M.TS_OCCLUSION)[0] - 1.0)

    emis_tex = tex(M.TS_EMISSIVE)
    emis_f = mf(M.MF_EMISSIVE, 3)
    emis_s = mf(M.MF_EMISSIVE_STRENGTH)
    emissive = [_tm(emis_f[c], emis_tex[c]) * emis_s for c in range(3)]

    # ---- normal mapping ---------------------------------------------------
    if slot_mask[M.TS_NORMAL] or ext[EXT_ANISOTROPY]:
        tang = [planes["tangent_x"], planes["tangent_y"], planes["tangent_z"]]
        n_dot_t = dot3(n, tang)
        t_w = norm3([tang[k] - n[k] * n_dot_t for k in range(3)])
        b_w = v_scale(cross3(n, t_w), planes["tangent_w"])
    if slot_mask[M.TS_NORMAL]:
        nrm_tex = tex(M.TS_NORMAL)
        has_nrm_tex = slot_col(M.TS_NORMAL, 0) >= 0
        nscale = mf(M.MF_NORMAL_SCALE)
        tsx = (nrm_tex[0] * 2.0 - 1.0) * nscale
        tsy = (nrm_tex[1] * 2.0 - 1.0) * nscale
        tsz = nrm_tex[2] * 2.0 - 1.0
        n_mapped = norm3([tsx * t_w[k] + tsy * b_w[k] + tsz * n[k]
                          for k in range(3)])
        n_final = v_where(has_nrm_tex, n_mapped, n)
    else:
        n_final = n
    facing = dot3(n_final, v) < 0.0
    n_final = v_where(facing, [-c for c in n_final], n_final)

    # ---- BRDF inputs (glTF spec) -------------------------------------------
    ior = mf(M.MF_IOR)
    f0_scalar = ((ior - 1.0) / torch.clamp(ior + 1.0, min=_EPS)) ** 2
    spec_color = mf(M.MF_SPECULAR_COLOR, 3)
    spec_tex = tex(M.TS_SPECULAR)
    spec_color_tex = tex(M.TS_SPECULAR_COLOR)
    spec_amt = _tm(mf(M.MF_SPECULAR), spec_tex[3])
    f0 = [torch.clamp(_tm(f0_scalar * spec_color[c], spec_color_tex[c]),
                      max=1.0) * spec_amt * (1.0 - metallic)
          + base[c] * metallic for c in range(3)]

    # KHR_materials_iridescence: the thin-film Fresnel replaces F0,
    # weighted by the iridescence factor
    if ext[EXT_IRIDESCENCE]:
        irid = _tm(mf(M.MF_IRIDESCENCE), tex(M.TS_IRIDESCENCE)[0])
        t_min = mf(M.MF_IRIDESCENCE_THICKNESS_MIN)
        irid_thick = t_min + _tm(mf(M.MF_IRIDESCENCE_THICKNESS_MAX) - t_min,
                                 tex(M.TS_IRIDESCENCE_THICKNESS)[1])
        n_dot_v_pre = torch.clamp(dot3(n_final, v), min=_EPS)
        f_irid = brdf.iridescent_fresnel_c(
            torch.ones_like(irid), mf(M.MF_IRIDESCENCE_IOR), f0, irid_thick,
            n_dot_v_pre)
        f0 = v_lerp(f0, f_irid, irid)

    c_diff = v_scale(base[:3], 1.0 - metallic)
    if ext[EXT_TRANSMISSION]:
        transmission = _tm(mf(M.MF_TRANSMISSION), tex(M.TS_TRANSMISSION)[0])
        if transparent_pass:
            c_diff = v_scale(c_diff, 1.0 - transmission)
    else:
        transmission = torch.zeros_like(metallic)

    # ---- punctual + IBL -----------------------------------------------------
    direct = _punctual_lights(ds, world_pos, n_final, v, c_diff, f0,
                              alpha_rough, light_tiles=light_tiles,
                              valid=valid, rows=light_rows)
    n_dot_v = torch.clamp(dot3(n_final, v), min=_EPS)

    # KHR_materials_anisotropy: bend the IBL lobe along the tangent or
    # bitangent (bent-normal approximation)
    n_ibl = n_final
    if ext[EXT_ANISOTROPY]:
        aniso = mf(M.MF_ANISOTROPY_STRENGTH)
        if slot_mask[M.TS_ANISOTROPY]:
            aniso = aniso * (2.0 * tex(M.TS_ANISOTROPY)[2] - 1.0)
        rot = mf(M.MF_ANISOTROPY_ROTATION)
        cr, sr = torch.cos(rot), torch.sin(rot)
        t_dir = [t_w[k] * cr + b_w[k] * sr for k in range(3)]
        b_dir = [-t_w[k] * sr + b_w[k] * cr for k in range(3)]
        a_dir = v_where(aniso >= 0, b_dir, t_dir)
        bent = norm3(cross3(cross3(a_dir, v), a_dir))
        mixw = torch.clamp(torch.abs(aniso), 0.0, 1.0)
        n_ibl = norm3(v_lerp(n_final, bent, mixw))
        n_dot_v_ibl = torch.clamp(dot3(n_ibl, v), min=_EPS)
    else:
        n_dot_v_ibl = n_dot_v
    r = norm3([2.0 * n_dot_v_ibl * n_ibl[k] - v[k] for k in range(3)])

    # ---- screen-space refraction direction (KHR_materials_volume): Snell
    # refraction of the view ray at the shaded normal (TIR -> inactive);
    # the exit point is projected below, and the offscreen IBL fallback tap
    # rides the same env gather. Only the volume composite reads it.
    want_refr = (transparent_pass and ext[EXT_TRANSMISSION]
                 and ext[EXT_VOLUME])
    if want_refr:
        eta = 1.0 / torch.where(ior > _EPS, ior, torch.ones_like(ior))
        cos_i = torch.clamp(dot3(n_final, v), min=0.0)
        sin_t2 = eta * eta * (1.0 - cos_i * cos_i)
        cos_t = torch.sqrt(torch.clamp(1.0 - sin_t2, 0.0, 1.0))
        refr = [eta * (-v[k]) + (eta * cos_i - cos_t) * n_final[k]
                for k in range(3)]
        refr_ok = ((sin_t2 <= 1.0) & (torch.abs(eta - 1.0) > 1e-3)
                   & (mf(M.MF_THICKNESS) > 0.0))
        refr_dir = v_where(refr_ok, norm3(refr), [-v[k] for k in range(3)])

    # sheen / clearcoat parameters first, so every env tap rides one K6
    if ext[EXT_SHEEN]:
        sheen_tex = tex(M.TS_SHEEN_COLOR)
        sheen_color = [_tm(c, t) for c, t in zip(mf(M.MF_SHEEN_COLOR, 3),
                                                 sheen_tex)]
        sheen_rough = torch.clamp(_tm(mf(M.MF_SHEEN_ROUGHNESS),
                                      tex(M.TS_SHEEN_ROUGHNESS)[3]),
                                  0.04, 1.0)
    if ext[EXT_CLEARCOAT]:
        cc = _tm(mf(M.MF_CLEARCOAT), tex(M.TS_CLEARCOAT)[0])
        cc_rough = torch.clamp(_tm(mf(M.MF_CLEARCOAT_ROUGHNESS),
                                   tex(M.TS_CLEARCOAT_ROUGHNESS)[1]),
                               0.04, 1.0)

    if solid_env:
        irr = [float(ds["irradiance"][0, c]) for c in range(3)]
        pref = [float(ds["prefiltered"][0, 0, c]) for c in range(3)]
        sky = [float(ds["skybox"][0, c]) for c in range(3)]
        sheen_pref = cc_pref = refr_pref = pref
    else:
        reqs = [(r, roughness)]
        if ext[EXT_SHEEN]:
            reqs.append((r, sheen_rough))
        if ext[EXT_CLEARCOAT]:
            reqs.append((r, cc_rough))
        if want_refr:
            reqs.append((refr_dir, roughness))
        # miss pixels reconstruct world_pos at the far plane, so -v is the
        # view ray: the opaque pass's sky rides the same gather
        irr4, prefs, sky4 = sample_env_batch_c(
            ds["skybox"].shape[0], ds["irradiance"].shape[0],
            ds["prefiltered"].shape[:2], n_final, reqs,
            sky_dirs=[-c for c in v] if want_sky else None,
            texq=ds["texels"], env_base=ds["env_pool_base"], gather=gather)
        irr = irr4[:3]
        pref = prefs[0][:3]
        sky = sky4[:3] if want_sky else None
        if ext[EXT_SHEEN]:
            sheen_pref = prefs[1][:3]
        if ext[EXT_CLEARCOAT]:
            cc_pref = prefs[1 + ext[EXT_SHEEN]][:3]
        if want_refr:
            refr_pref = prefs[1 + ext[EXT_SHEEN] + ext[EXT_CLEARCOAT]][:3]

    lut_a, lut_b = env_brdf_approx(n_dot_v, roughness)
    fresnel_scale = [f0[c] * lut_a + lut_b for c in range(3)]
    ambient = [_tm(irr[c] * c_diff[c] + pref[c] * fresnel_scale[c],
                   occlusion) for c in range(3)]
    pbr_color = [direct[c] + ambient[c] for c in range(3)]

    if ext[EXT_SHEEN]:       # KHR_materials_sheen
        sheen_scale = brdf.sheen_albedo_scaling_c(n_dot_v, sheen_color,
                                                  sheen_rough)
        sheen_ibl = v_mul(sheen_pref, sheen_color)
        pbr_color = [pbr_color[c] * sheen_scale + sheen_ibl[c]
                     for c in range(3)]
    if ext[EXT_CLEARCOAT]:   # KHR_materials_clearcoat
        cc_a, cc_b = env_brdf_approx(n_dot_v, cc_rough)
        cc_amt = cc * (0.04 * cc_a + cc_b)
        cc_fresnel = 0.04 + 0.96 * torch.pow(1.0 - n_dot_v, 5.0)
        cc_scale = 1.0 - cc * cc_fresnel
        pbr_color = [pbr_color[c] * cc_scale + cc_pref[c] * cc_amt
                     for c in range(3)]
    pbr_color = [pbr_color[c] + emissive[c] for c in range(3)]

    # lighting- and channel-isolation debug views
    if debug_mode == "ibl":
        pbr_color = ambient
    elif debug_mode == "punctual":
        pbr_color = direct
    elif debug_mode == "material" or debug_mode.startswith("channel:"):
        spec_vis = [_tm(spec_color[c], spec_color_tex[c]) * spec_amt
                    for c in range(3)]
        views = (
            base[:3],                                          # base colour
            [metallic, roughness, torch.zeros_like(metallic)],  # metal/rough
            [n_final[c] * 0.5 + 0.5 for c in range(3)],        # normals
            [occlusion] * 3,                                   # occlusion
            emissive,                                          # emissive
            spec_vis,                                          # specular
        )
        if debug_mode == "material":
            # per-material bitmask: the lowest set bit wins (selects
            # applied high -> low so bit 0 lands last)
            dbg = mflag(M.MI_DEBUG_MASK).to(torch.int32)
            for b in range(5, -1, -1):
                hit = ((dbg >> b) & 1) == 1
                pbr_color = v_where(hit, views[b], pbr_color)
        else:
            pbr_color = views[DEBUG_CHANNELS[debug_mode.split(":", 1)[1]]]

    # ---- alpha per mode (OPAQUE = 1, MASK = cutoff test, BLEND = base a) --
    alpha_mode = mflag(M.MI_ALPHA_MODE)
    alpha = torch.where(
        alpha_mode == 0.0, torch.ones_like(alpha_mode),
        torch.where(alpha_mode == 1.0,
                    (base[3] >= mf(M.MF_ALPHA_CUTOFF)).float(), base[3]))

    trans_factor = refr_info = None
    if transparent_pass:
        # ---- editor grid (KIND_GRID: procedural world-space lines) -------
        spacing = torch.clamp(mf(M.MF_GRID_SPACING), min=1e-3)
        major_every = torch.clamp(mf(M.MF_GRID_MAJOR_EVERY), min=1.0)
        fade_dist = torch.clamp(mf(M.MF_GRID_FADE_DISTANCE), min=1e-3)
        cam_delta = [world_pos[k] - cam_pos[k] for k in range(3)]
        cam_dist = torch.sqrt(dot3(cam_delta, cam_delta))
        aa = torch.clamp(cam_dist * 2e-3, min=1e-4)

        def line_alpha(p, sp, wdt):
            # floor-mod, as jnp.mod: torch.remainder, not torch.fmod
            d = torch.abs(torch.remainder(p / sp + 0.5, 1.0) - 0.5) * sp
            return torch.clamp(1.0 - (d - wdt) / torch.clamp(wdt, min=1e-6),
                               0.0, 1.0)

        gx, gz = world_pos[0], world_pos[2]
        minor = torch.maximum(line_alpha(gx, spacing, aa),
                              line_alpha(gz, spacing, aa))
        major = torch.maximum(
            line_alpha(gx, spacing * major_every, aa * 1.5),
            line_alpha(gz, spacing * major_every, aa * 1.5))
        grid_a = torch.maximum(minor * 0.5, major) * torch.clamp(
            1.0 - cam_dist / fade_dist, 0.0, 1.0)
        alpha = torch.where(is_grid, grid_a * base[3], alpha)

        # ---- transmission factor: what the compositor multiplies into the
        # background behind this fragment (PBR only; attenuation by
        # KHR_materials_volume's colour over its thickness) ---------------
        att_dist = mf(M.MF_ATTENUATION_DISTANCE)
        att_color = mf(M.MF_ATTENUATION_COLOR, 3)
        thickness = mf(M.MF_THICKNESS)
        has_att = att_dist > 0.0
        inv_att = thickness / torch.clamp(att_dist, min=1e-4)
        att = [torch.where(has_att, torch.exp(torch.log(torch.clamp(
            att_color[c], min=1e-4)) * inv_att), torch.ones_like(inv_att))
            for c in range(3)]
        t_gate = torch.where(is_unlit | is_grid, torch.zeros_like(transmission),
                             transmission)
        trans_factor = [base[c] * att[c] * (1.0 - fresnel_scale[c]) * t_gate
                        for c in range(3)]

        # ---- refracted exit point: march `thickness` along the refracted
        # ray, project through view_proj, and hand the compositor a pixel
        # index into the band's opaque image plus the offscreen fallback --
        if want_refr:
            H_band = height // n_layer_tiles
            vp = [[float(x) for x in row] for row in cam["view_proj"]]
            ex = [world_pos[k] + refr_dir[k] * thickness for k in range(3)]

            def clip_row(j):
                return (ex[0] * vp[j][0] + ex[1] * vp[j][1]
                        + ex[2] * vp[j][2] + vp[j][3])

            cxw, cyw, cw = clip_row(0), clip_row(1), clip_row(3)
            inv_cw = 1.0 / torch.where(torch.abs(cw) > _EPS, cw,
                                       torch.full_like(cw, _EPS))
            gxp = (cxw * inv_cw + 1.0) * 0.5 * width - 0.5    # frame pixel x
            gyp = (1.0 - cyw * inv_cw) * 0.5 * H_full - 0.5   # frame pixel y
            ly = gyp - row_offset                             # band-local y
            on_screen = ((cw > 0.0) & (gxp >= 0.0) & (gxp <= width - 1.0)
                         & (gyp >= 0.0) & (gyp <= H_full - 1.0)
                         & (ly >= 0.0) & (ly <= H_band - 1.0))
            own_idx = (torch.arange(P, dtype=torch.int32, device=dev)
                       % (H_band * width))                    # same pixel
            do_refr = refr_ok & (t_gate > 0.0)
            # both roundings are half-to-even, as jnp.round
            refr_idx = torch.where(
                do_refr & on_screen,
                torch.round(ly).to(torch.int32) * width
                + torch.round(gxp).to(torch.int32), own_idx)
            refr_info = (refr_idx, do_refr & ~on_screen, refr_pref)

    color = v_where(is_unlit, base[:3], pbr_color)
    if transparent_pass:
        color = v_where(is_grid, base[:3], color)
    if debug_mode == "normals":
        color = [n_final[c] * 0.5 + 0.5 for c in range(3)]
    if want_sky:
        color = [torch.where(valid, color[c], sky[c]) for c in range(3)]
    return color, alpha, trans_factor, refr_info


#: the texture slots K14 reads, in the order of its tap indices
#: (csrc/shade.cu: T_BASE ... T_SPECULAR_COLOR)
K14_SLOTS = (M.TS_BASE_COLOR, M.TS_METALLIC_ROUGHNESS, M.TS_NORMAL,
             M.TS_OCCLUSION, M.TS_EMISSIVE, M.TS_SPECULAR,
             M.TS_SPECULAR_COLOR)


def shade_surface_fused_reference(planes, ds, taps, *, slot_mask,
                                  solid_env: bool, width: int, height: int,
                                  height_full: int | None = None,
                                  width_full: int | None = None,
                                  row_offset: int = 0, col_offset: int = 0,
                                  n_layer_tiles: int = 1,
                                  transparent_pass: bool = False,
                                  want_sky: bool = False,
                                  normals_view: bool = False):
    """Plain PyTorch twin of K14, on K14's inputs (shade_surface_fused):
    the chain's math (_shade_math) with the material columns, the light
    rows and the environment rows gathered in plain PyTorch. Returns
    (rgb [3 planes], alpha, transmission factor [3 planes] or None)."""
    needed, col_idx = _material_columns(ds, slot_mask, "none")
    table = _material_table(ds).index_select(1, col_idx)
    mat_row = planes["mat_row"].to(torch.int32).clamp(0, table.shape[0] - 1)
    cols = dict(zip(needed, onehot_split_rows_reference(mat_row, table)))
    color, alpha, trans, _refr = _shade_math(
        planes, ds, cols, taps, planes["tri_id"] >= 0,
        ShadeSpec(slot_mask=slot_mask, solid_env=solid_env,
                  debug_mode="normals" if normals_view else "none"),
        transparent_pass=transparent_pass, want_sky=want_sky,
        light_rows=ds["lights"][:ds["n_lights"]].tolist(),
        gather=gather_split_channels_reference, width=width, height=height,
        height_full=height if height_full is None else height_full,
        width_full=width if width_full is None else width_full,
        row_offset=row_offset, col_offset=col_offset,
        n_layer_tiles=n_layer_tiles)
    return color, alpha, trans


_P = ctypes.c_void_p
_I = ctypes.c_int


class _ShadeParams(ctypes.Structure):
    """csrc/shade.cu ShadeParams, field for field."""
    _fields_ = [
        ("tri_id", _P), ("depth", _P), ("mat_row", _P), ("normal", _P * 3),
        ("tangent", _P * 4), ("color", _P * 4), ("ndc", _P * 2),
        ("taps", _P), ("tap_stride", ctypes.c_int64), ("tap", _I * 7),
        ("mat_float", _P), ("mat_tex", _P), ("mat_flags", _P),
        ("mat_cap", _I), ("lights", _P), ("n_lights", _I), ("texels", _P),
        ("n_texels", _I), ("env_base", _I), ("sky_size", _I),
        ("irr_size", _I), ("pref_size", _I), ("pref_levels", _I),
        ("solid", ctypes.c_float * 9), ("inv_view_proj", ctypes.c_float * 16),
        ("cam_pos", ctypes.c_float * 3), ("P", _I), ("width", _I),
        ("height", _I), ("height_full", _I), ("width_full", _I),
        ("row_offset", _I), ("col_offset", _I), ("n_layer_tiles", _I),
        ("transparent", _I), ("want_sky", _I), ("normals_view", _I),
        ("out", _P), ("trans", _P),
    ]


def shade_surface_fused(planes, ds, taps, *, slot_mask, solid_env: bool,
                        width: int, height: int,
                        height_full: int | None = None,
                        width_full: int | None = None, row_offset: int = 0,
                        col_offset: int = 0, n_layer_tiles: int = 1,
                        transparent_pass: bool = False,
                        want_sky: bool = False, normals_view: bool = False):
    """K14 (csrc/shade.cu): the surface shade after the taps in one launch
    -> (rgb [3 planes], alpha, transmission factor [3 planes] with
    transparent_pass, else None).

    planes: shade_surface's (P,) G-buffer planes (tri_id int32, depth,
    mat_row, normal; tangent with the normal slot in slot_mask; colour,
    ndc_x / ndc_y when present) over shade_surface's geometry. ds: the
    material tables (mat_float, mat_tex, mat_flags), the light table
    (lights, its first n_lights rows lit), the camera, and the
    environment: solid_env's colours (skybox, irradiance, prefiltered
    host rows) or the texel pool's env rows at env_pool_base. taps: K5's
    raw (4, n_active * P) block for slot_mask's active slots (None without
    one); K14 reads K14_SLOTS' of them. want_sky: a miss takes the sky;
    normals_view: the shading normal as colour. A CPU tensor takes the
    twin."""
    tid = planes["tri_id"]
    if tid.device.type == "cpu":
        return shade_surface_fused_reference(
            planes, ds, taps, slot_mask=slot_mask, solid_env=solid_env,
            width=width, height=height, height_full=height_full,
            width_full=width_full, row_offset=row_offset,
            col_offset=col_offset, n_layer_tiles=n_layer_tiles,
            transparent_pass=transparent_pass, want_sky=want_sky,
            normals_view=normals_view)
    P = width * height
    if tid.dtype != torch.int32 or tid.shape != (P,):
        raise ValueError(f"tri_id must be ({P},) int32")
    active = [s for s in range(M.NUM_TEX_SLOTS) if slot_mask[s]]
    names = ["depth", "mat_row", "normal_x", "normal_y", "normal_z"]
    if slot_mask[M.TS_NORMAL]:
        names += ["tangent_x", "tangent_y", "tangent_z", "tangent_w"]
    if "color_r" in planes:
        names += ["color_r", "color_g", "color_b", "color_a"]
    if "ndc_x" in planes:
        names += ["ndc_x", "ndc_y"]
    pl = {k: planes[k].contiguous() for k in names}
    for k, t in pl.items():
        if t.dtype != torch.float32 or t.shape != (P,):
            raise ValueError(f"plane {k} must be ({P},) f32")
    if active and (taps is None or taps.dtype != torch.float32
                   or taps.shape != (4, len(active) * P)):
        raise ValueError(f"taps must be (4, {len(active) * P}) f32")
    mat_float, mat_tex, mat_flags = (ds["mat_float"], ds["mat_tex"],
                                     ds["mat_flags"])
    cap = mat_float.shape[0]
    if (mat_float.dtype != torch.float32
            or mat_float.shape[1:] != (M.NUM_F32,)
            or mat_tex.dtype != torch.int32
            or mat_tex.shape != (cap, M.NUM_TEX_SLOTS, 3)
            or mat_flags.dtype != torch.int32
            or mat_flags.shape != (cap, M.NUM_I32)):
        raise ValueError("material tables must be (cap, NUM_F32) f32, "
                         "(cap, NUM_TEX_SLOTS, 3) and (cap, NUM_I32) int32")
    lights, n_lights = ds["lights"], ds["n_lights"]
    if (lights.dtype != torch.float32 or lights.dim() != 2
            or lights.shape[1] != LIGHT_F32 or n_lights > lights.shape[0]):
        raise ValueError(f"lights must be (L >= n_lights, {LIGHT_F32}) f32")
    tensors = [tid, *pl.values(), mat_float, mat_tex, mat_flags, lights]
    if active:
        tensors.append(taps)

    prm = _ShadeParams()
    if not solid_env:
        texq = ds["texels"]
        if (texq.dtype != torch.bfloat16 or texq.dim() != 2
                or texq.shape[1] != TEXEL_COLS or texq.data_ptr() % 16):
            raise ValueError(f"texels must be 16-byte aligned (N, "
                             f"{TEXEL_COLS}) bf16 rows")
        tensors.append(texq)
        n_lv, pref_rows = ds["prefiltered"].shape[:2]
        prm.texels = texq.data_ptr()
        prm.n_texels = texq.shape[0]
        prm.env_base = ds["env_pool_base"]
        prm.sky_size = math.isqrt(ds["skybox"].shape[0] // 6)
        prm.irr_size = math.isqrt(ds["irradiance"].shape[0] // 6)
        prm.pref_size = math.isqrt(pref_rows // 6)
        prm.pref_levels = n_lv
    else:
        prm.solid[:] = ([float(ds["irradiance"][0, c]) for c in range(3)]
                        + [float(ds["prefiltered"][0, 0, c])
                           for c in range(3)]
                        + [float(ds["skybox"][0, c]) for c in range(3)])
    kernels.check_cuda(*tensors)

    out = torch.empty((4, P), dtype=torch.float32, device=tid.device)
    trans = (torch.empty((3, P), dtype=torch.float32, device=tid.device)
             if transparent_pass else None)
    prm.tri_id, prm.depth, prm.mat_row = (tid.data_ptr(),
                                          pl["depth"].data_ptr(),
                                          pl["mat_row"].data_ptr())
    prm.normal[:] = [pl[f"normal_{a}"].data_ptr() for a in "xyz"]
    if slot_mask[M.TS_NORMAL]:
        prm.tangent[:] = [pl[f"tangent_{a}"].data_ptr() for a in "xyzw"]
    if "color_r" in pl:
        prm.color[:] = [pl[f"color_{a}"].data_ptr() for a in "rgba"]
    if "ndc_x" in pl:
        prm.ndc[:] = [pl["ndc_x"].data_ptr(), pl["ndc_y"].data_ptr()]
    if active:
        prm.taps = taps.data_ptr()
        prm.tap_stride = len(active) * P
    prm.tap[:] = [active.index(s) if slot_mask[s] else -1 for s in K14_SLOTS]
    prm.mat_float, prm.mat_tex, prm.mat_flags = (
        mat_float.data_ptr(), mat_tex.data_ptr(), mat_flags.data_ptr())
    prm.mat_cap = cap
    prm.lights, prm.n_lights = lights.data_ptr(), n_lights
    cam = ds["camera"]
    prm.inv_view_proj[:] = [float(x) for r in cam["inv_view_proj"]
                            for x in r]
    prm.cam_pos[:] = [float(x) for x in cam["position"]]
    prm.P, prm.width, prm.height = P, width, height
    prm.height_full = height if height_full is None else height_full
    prm.width_full = width if width_full is None else width_full
    prm.row_offset, prm.col_offset = row_offset, col_offset
    prm.n_layer_tiles = n_layer_tiles
    prm.transparent, prm.want_sky = int(transparent_pass), int(want_sky)
    prm.normals_view = int(normals_view)
    prm.out = out.data_ptr()
    prm.trans = trans.data_ptr() if trans is not None else None
    kernels.launch("shade_surface_fused", "awsm_shade_surface",
                   ctypes.byref(prm))
    return ([out[0], out[1], out[2]], out[3],
            None if trans is None else [trans[0], trans[1], trans[2]])


def shade_deferred_c(vis, ds, spec: ShadeSpec, *, width: int, height: int,
                     height_full: int | None = None, row_offset: int = 0,
                     width_full: int | None = None, col_offset: int = 0):
    """Deferred opaque shade -> HDR linear [r, g, b, a] (P,) planes: the
    shaded surface where covered, the skybox on a miss, alpha = coverage.
    The (height, width) planes are a band (or screen tile) starting at
    row_offset / col_offset of a height_full x width_full frame (the
    sharded frame's)."""
    P = width * height
    planes = {k: vis[k].reshape(P) for k in vis if k != "bins"}
    color, _alpha, valid = shade_surface(
        planes, ds, spec, width=width, height=height,
        height_full=height_full, row_offset=row_offset,
        width_full=width_full, col_offset=col_offset, want_sky=True)
    return color + [valid.float()]


# rows of the compacted opaque shade's (OPAQUE_TILE_ROWS, 128) units
OPAQUE_TILE_ROWS = 8


def _tile_swizzle(p: torch.Tensor, H: int, W: int):
    """(..., H*W) row-major plane -> (..., n_units, th*128) of (th, 128)
    units (th = OPAQUE_TILE_ROWS), unit-row-major."""
    th = OPAQUE_TILE_ROWS
    lead = p.shape[:-1]
    t = p.reshape(*lead, H // th, th, W // 128, 128).transpose(-3, -2)
    return t.reshape(*lead, (H // th) * (W // 128), th * 128)


def _tile_unswizzle(t: torch.Tensor, H: int, W: int):
    """(n_units, th*128) of (th, 128) units -> (H*W,) row-major plane."""
    th = OPAQUE_TILE_ROWS
    return (t.reshape(H // th, W // 128, th, 128).transpose(1, 2)
            .reshape(H * W))


def shade_units_c(tid_c, dep_c, idx, setup_rows, ds, spec: ShadeSpec, *,
                  width: int, height: int, coord_scale: int):
    """Shade an explicit set of C compacted (th, 128) units (th =
    OPAQUE_TILE_ROWS; reference: shade.py shade_units_c) of a height-row
    frame: the MSAA frame's covered units and the temporal frame's
    chosen ones.

    idx (C,) names the units in the frame's (H // th, W // 128) grid;
    tid_c / dep_c their gathered (C*th*128,) winner and depth planes,
    taken on a raster at coord_scale times the display resolution (2:
    the top-left sample of the MSAA raster; 1: the temporal frame's). K2
    evaluates the planes at explicit raster-space centers (x *
    coord_scale + 0.5, as the band-wide resolve derives them from the
    flat index), and the pixels' NDC coordinates ride as planes into
    shade_surface. Returns ([r, g, b] compact planes, valid); miss pixels
    carry the sky."""
    th = OPAQUE_TILE_ROWS
    C = idx.shape[0]
    U = th * 128
    ntx = width // 128
    tx = (idx % ntx).float()
    ty = torch.div(idx, ntx, rounding_mode="floor").float()
    q = torch.arange(U, dtype=torch.float32, device=idx.device)
    gx = tx[:, None] * 128.0 + (q % 128)[None, :]             # (C, U)
    gy = ty[:, None] * float(th) + torch.floor(q / 128)[None, :]
    px = (gx * coord_scale + 0.5).reshape(C * U)
    py = (gy * coord_scale + 0.5).reshape(C * U)
    vis = resolve_planes_fused(tid_c, setup_rows, width=width, px=px, py=py)
    planes = {k: vis[k] for k in RESOLVE_NAMES}
    planes["depth"] = dep_c
    planes["ndc_x"] = ((gx + 0.5) / width * 2.0 - 1.0).reshape(C * U)
    planes["ndc_y"] = (1.0 - (gy + 0.5) / height * 2.0).reshape(C * U)
    color, _alpha, valid = shade_surface(
        planes, ds, spec, width=128, height=C * th, height_full=height,
        want_sky=True)
    return color, valid


def shade_deferred_compact_c(tid_flat, setup_rows, depth_flat, ds,
                             spec: ShadeSpec, *, width: int, height: int,
                             tile_cap: int):
    """Covered-tile-compacted deferred opaque shade (reference: shade.py
    shade_deferred_compact_c; the MSAA frame's, whose ids come from the
    top-left samples of a 2x raster).

    The slim tri_id plane (height*width,) cuts into (OPAQUE_TILE_ROWS,
    128) units; the covered units come first (a stable argsort) and the first
    C = min(tile_cap, n_units) (a host bound, renderer._bucket_tile_cap)
    are resolved and shaded (shade_units_c); the rest is sky: the
    solid environment's constant, or for an image environment one
    skybox-only K6 gather over the skipped units' view rays
    (cubemap.sample_skybox_pool_c). Equal to shade_deferred_c's result
    whenever the cap covers every live unit. Returns [r, g, b, a] (P,)."""
    H, W, th = height, width, OPAQUE_TILE_ROWS
    U = th * 128
    n_tiles = (H // th) * (W // 128)
    C = min(tile_cap, n_tiles)
    sw_tid = _tile_swizzle(tid_flat, H, W)                    # (n_units, U)
    cov = (sw_tid >= 0).any(dim=-1)
    order = torch.argsort((~cov).to(torch.int8), stable=True)  # covered first
    idx = order[:C]
    tid_c = sw_tid.index_select(0, idx).reshape(C * U)
    dep_c = _tile_swizzle(depth_flat, H, W).index_select(
        0, idx).reshape(C * U)
    out_c, valid = shade_units_c(tid_c, dep_c, idx, setup_rows, ds, spec,
                                 width=W, height=H, coord_scale=2)

    R = n_tiles - C
    rest_sky = None
    if not spec.solid_env and R:
        # per-pixel skybox for the skipped units: view rays through the
        # far plane, as shade_surface's miss path reconstructs them
        from .cubemap import sample_skybox_pool_c

        idx_rest = order[C:]
        q = torch.arange(U, dtype=torch.float32, device=idx.device)
        ntx = W // 128
        gxr = ((idx_rest % ntx).float()[:, None] * 128.0
               + (q % 128)[None, :])
        gyr = (torch.div(idx_rest, ntx, rounding_mode="floor").float()
               [:, None] * float(th) + torch.floor(q / 128)[None, :])
        nx = ((gxr + 0.5) / W * 2.0 - 1.0).reshape(R * U)
        ny = (1.0 - (gyr + 0.5) / H * 2.0).reshape(R * U)
        ivp = [[float(x) for x in r] for r in ds["camera"]["inv_view_proj"]]
        wp = [nx * ivp[j][0] + ny * ivp[j][1] + ivp[j][2] + ivp[j][3]
              for j in range(4)]
        iw = 1.0 / torch.where(torch.abs(wp[3]) > _EPS, wp[3],
                               torch.full_like(wp[3], _EPS))
        cam = [float(x) for x in ds["camera"]["position"]]
        d3 = tuple(wp[k] * iw - cam[k] for k in range(3))
        rest_sky = sample_skybox_pool_c(ds["texels"], ds["env_pool_base"],
                                        ds["skybox"].shape[0], d3)

    out = []
    dev = tid_flat.device
    for c in range(3):
        fill = float(ds["skybox"][0, c]) if spec.solid_env else 0.0
        scat = torch.full((n_tiles, U), fill, device=dev).index_copy(
            0, idx, out_c[c].reshape(C, U))
        if rest_sky is not None:
            scat = scat.index_copy(0, idx_rest, rest_sky[c].reshape(R, U))
        out.append(_tile_unswizzle(scat, H, W))
    alpha = torch.zeros((n_tiles, U), device=dev).index_copy(
        0, idx, valid.float().reshape(C, U))
    return out + [_tile_unswizzle(alpha, H, W)]


def _composite(color, alpha, valid, trans, bg, out_rgb):
    """Back to front over out_rgb (3 planes): the last of the Kg stacked
    layers is the farthest peel. Each layer adds the background it
    transmits (bg, the pre-transparent opaque image, [3] x (Kg, N)) times
    its transmission factor, then blends by its alpha (0 where it
    missed)."""
    Kg = bg[0].shape[0]
    a = torch.where(valid, alpha, torch.zeros_like(alpha)).reshape(Kg, -1)
    color = [c.reshape(Kg, -1) for c in color]
    trans = [t.reshape(Kg, -1) for t in trans]
    out_rgb = list(out_rgb)
    for k in range(Kg - 1, -1, -1):
        for c in range(3):
            cc = color[c][k] + bg[c][k] * trans[c][k]
            out_rgb[c] = cc * a[k] + out_rgb[c] * (1.0 - a[k])
    return out_rgb


def _shade_deep_then_front(layers, K: int, shade_group, out):
    """Layers 2..K-1 shade only if peel 2 holds a fragment (a host sync:
    typical scenes have at most two overlapping transparent surfaces, and
    shading an empty peel could put NaN into the composite), then layers
    0-1 on top."""
    if K > 2:
        if bool((layers["tri_id"][2:] >= 0).any()):
            out = shade_group(2, K - 2, out)
        return shade_group(0, 2, out)
    return shade_group(0, K, out)


def shade_transparent_layers_c(layers, opaque_ch, ds, spec: ShadeSpec, *,
                               width: int, height: int,
                               height_full: int | None = None,
                               row_offset: int = 0,
                               width_full: int | None = None,
                               col_offset: int = 0, n_layers: int = 4,
                               tile_cap: int | None = None):
    """Forward-shade K depth-peeled transparent layers and composite them
    back to front over the opaque band (reference: shade.py
    shade_transparent_layers_c).

    layers: {name: (K, P)} from rasterize_layers_rows; opaque_ch [r, g, b,
    a] (P,) planes. Layers shade in batched calls on stacked (Kg*P,)
    planes (one texture-tap plan and one env gather per group) and return
    a transmission factor, so the composite applies each layer's tint to
    what lies behind it. The background transmission sees is the
    pre-transparent opaque image: at the fragment's own pixel, or with
    KHR_materials_volume at the refracted exit pixel, gathered by K6's
    f32 entry (offscreen exits take the prefiltered IBL colour).

    The planes are a band (or screen tile) starting at row_offset /
    col_offset of a height_full x width_full frame. tile_cap:
    covered-tile compaction over (8, 128) tiles
    (_shade_transparent_compact), taken when the cap leaves part of the
    band out and the planes are fat; no frame path passes it (the frame
    compacts at the raster instead, shade_transparent_compact32).
    Returns [r, g, b, a] (P,) planes."""
    from .relayout import gather_split_channels_f32

    H, W, K = height, width, n_layers
    H_full = height if height_full is None else height_full
    P = H * W
    if (tile_cap is not None and H % OPAQUE_TILE_ROWS == 0 and W % 128 == 0
            and tile_cap * OPAQUE_TILE_ROWS * 128 < P and "uv0_u" in layers):
        return _shade_transparent_compact(
            layers, opaque_ch, ds, spec, width=W, height=H,
            height_full=H_full, row_offset=row_offset, n_layers=K,
            tile_cap=tile_cap)

    def shade_group(k0, Kg, out_rgb):
        flat = {k: v[k0:k0 + Kg].reshape(Kg * P) for k, v in layers.items()}
        color, alpha, valid, trans, refr = shade_surface(
            flat, ds, spec, width=W, height=Kg * H, height_full=H_full,
            row_offset=row_offset, width_full=width_full,
            col_offset=col_offset, transparent_pass=True, n_layer_tiles=Kg)
        if refr is not None:
            idx, use_fb, fb = refr
            got = gather_split_channels_f32(torch.stack(opaque_ch, dim=-1),
                                            idx, 4)
            bg = [torch.where(use_fb, fb[c], got[c]).reshape(Kg, P)
                  for c in range(3)]
        else:
            bg = [opaque_ch[c].expand(Kg, P) for c in range(3)]
        return _composite(color, alpha, valid, trans, bg, out_rgb)

    out = _shade_deep_then_front(layers, K, shade_group, list(opaque_ch[:3]))
    return out + [opaque_ch[3]]


def _shade_transparent_compact(layers, opaque_ch, ds, spec: ShadeSpec, *,
                               width: int, height: int, height_full: int,
                               row_offset: int, n_layers: int,
                               tile_cap: int):
    """Covered-tile-compacted K-layer transparent shade + composite
    (reference: shade.py _shade_transparent_compact, reached through
    shade_transparent_layers_c(tile_cap=...)). The band planes cut into
    (8, 128) tiles; the tiles layer 0 covers come first (a stable
    argsort: a peel's coverage lies inside layer 0's) and the first C =
    min(tile_cap, n_tiles) are shaded with their NDC coordinates and uv
    gradients riding as planes (screen differences taken band-wide first
    when the raster emitted none); only the composited rgb scatters back.
    Equal to the band path whenever the cap covers every tile layer 0
    touches. Not valid with KHR_materials_volume."""
    if spec.ext[EXT_VOLUME]:
        raise ValueError("refraction needs band-space planes")
    H, W, K, th = height, width, n_layers, OPAQUE_TILE_ROWS
    P = H * W
    U = th * 128
    n_tiles = (H // th) * (W // 128)
    C = min(tile_cap, n_tiles)
    planes = dict(layers)
    if "du0_dx" not in planes:
        u, v = (planes[k].reshape(K * P) for k in ("uv0_u", "uv0_v"))
        for name, ch, vert in (("du0_dx", u, False), ("dv0_dx", v, False),
                               ("du0_dy", u, True), ("dv0_dy", v, True)):
            planes[name] = _screen_gradient(ch, W, K * H, vertical=vert,
                                            layers=K).reshape(K, P)
    sw = {k: _tile_swizzle(v, H, W) for k, v in planes.items()}
    cov = (sw["tri_id"][0] >= 0).any(dim=-1)
    idx = torch.argsort((~cov).to(torch.int8), stable=True)[:C]
    comp = {k: v.index_select(1, idx) for k, v in sw.items()}

    ntx = W // 128
    q = torch.arange(U, dtype=torch.float32, device=idx.device)
    gx = (idx % ntx).float()[:, None] * 128.0 + (q % 128)[None, :]
    gy = (torch.div(idx, ntx, rounding_mode="floor").float()[:, None]
          * float(th) + torch.floor(q / 128)[None, :] + float(row_offset))
    Pc = C * U
    ndc_x = ((gx + 0.5) / W * 2.0 - 1.0).reshape(Pc)
    ndc_y = (1.0 - (gy + 0.5) / height_full * 2.0).reshape(Pc)
    ob_full = [_tile_swizzle(opaque_ch[c], H, W) for c in range(3)]
    ob = [f.index_select(0, idx).reshape(Pc) for f in ob_full]

    def shade_group(k0, Kg, out_rgb):
        flat = {k: v[k0:k0 + Kg].reshape(Kg * Pc) for k, v in comp.items()}
        flat["ndc_x"] = ndc_x.repeat(Kg)
        flat["ndc_y"] = ndc_y.repeat(Kg)
        color, alpha, valid, trans, _refr = shade_surface(
            flat, ds, spec, width=128, height=Kg * C * th,
            height_full=height_full, transparent_pass=True)
        bg = [o.expand(Kg, Pc) for o in ob]
        return _composite(color, alpha, valid, trans, bg, out_rgb)

    out = _shade_deep_then_front(comp, K, shade_group, ob)
    out_full = [_tile_unswizzle(ob_full[c].index_copy(
        0, idx, out[c].reshape(C, U)), H, W) for c in range(3)]
    return out_full + [opaque_ch[3]]


def shade_transparent_compact32(layers, tile_idx, opaque_ch, ds,
                                spec: ShadeSpec, *, width: int, height: int,
                                height_full: int, row_offset: int, n_tx: int,
                                n_layers: int = 4):
    """Shade + composite K peels rasterized in covered-tile-compacted
    space (rasterize_layers_compact; reference: shade.py
    shade_transparent_compact32).

    layers: {name: (K, C*1024)}, block i = logical 32x32 tile
    tile_idx[i], with analytic uv-derivative planes; the pixels' NDC
    coordinates ride as planes. Only the opaque background compacts
    (index_select of its 32x32 blocks) and only the composited rgb
    scatters back; pixels outside the covered tiles keep the opaque
    result, as the reference's forward pass has no fragments there. Not
    valid with KHR_materials_volume (refraction gathers the opaque image
    at arbitrary pixels). Returns [r, g, b, a] (height*width,) planes."""
    from .raster import BT_H, BT_W, _deswizzle32, _pad_swizzle32

    if spec.ext[EXT_VOLUME]:
        raise ValueError("refraction needs band-space planes")
    if "du0_dx" not in layers:
        raise ValueError("compact peel planes carry analytic derivatives")
    H, W, K = height, width, n_layers
    npx = BT_H * BT_W
    C = int(tile_idx.shape[0])
    Pc = C * npx
    H32 = -(-H // BT_H) * BT_H
    if W % BT_W or n_tx != W // BT_W:
        raise ValueError(f"width {W} is not {n_tx} 32-pixel tiles")
    comp = {k: v.reshape(K, C, npx) for k, v in layers.items()}

    tidx = tile_idx.long()
    tx = (tidx % n_tx).float()
    ty = torch.div(tidx, n_tx, rounding_mode="floor").float()
    q = torch.arange(npx, device=tile_idx.device)
    gx = tx[:, None] * float(BT_W) + (q % BT_W).float()[None, :]
    gy = (ty[:, None] * float(BT_H)
          + torch.div(q, BT_W, rounding_mode="floor").float()[None, :]
          + float(row_offset))
    ndc_x = ((gx + 0.5) / W * 2.0 - 1.0).reshape(Pc)
    ndc_y = (1.0 - (gy + 0.5) / height_full * 2.0).reshape(Pc)

    ob_full = [_pad_swizzle32(opaque_ch[c].reshape(H, W), H32, W)
               for c in range(3)]
    ob = [f.index_select(0, tidx).reshape(Pc) for f in ob_full]

    def shade_group(k0, Kg, out_rgb):
        flat = {k: v[k0:k0 + Kg].reshape(Kg * Pc) for k, v in comp.items()}
        flat["ndc_x"] = ndc_x.repeat(Kg)
        flat["ndc_y"] = ndc_y.repeat(Kg)
        color, alpha, valid, trans, _refr = shade_surface(
            flat, ds, spec, width=128, height=Kg * C * 8,
            height_full=height_full, transparent_pass=True)
        bg = [o.expand(Kg, Pc) for o in ob]
        return _composite(color, alpha, valid, trans, bg, out_rgb)

    out = _shade_deep_then_front(comp, K, shade_group, ob)
    out_full = []
    for c in range(3):
        scat = ob_full[c].index_copy(0, tidx, out[c].reshape(C, npx))
        out_full.append(_deswizzle32(scat, H32, W)[:H].reshape(H * W))
    return out_full + [opaque_ch[3]]
