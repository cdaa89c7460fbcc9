"""Deferred opaque shading: attribute resolve (K2), material fetch (K3),
punctual + IBL lighting, skybox on miss.

Port of the opaque path of awsm_renderer_tpu/ops/shade.py for the slice
the port covers: no bound texture slots, no material extensions, a solid
or image environment, the dense punctual-light loop, debug mode "none".
All shading math runs on flat (P,) channel planes (ops/cvec.py lists);
camera and light parameters enter as Python floats.
"""

from __future__ import annotations

import math

import torch

from ..core import materials as M
from ..core.lights import (
    L_COLOR, L_DIRECTION, L_INNER_COS, L_KIND, L_OUTER_COS, L_POSITION,
    L_RANGE,
)
from . import brdf, kernels
from .cubemap import sample_env_batch_c
from .cvec import add as v_add, dot3, norm3, scale as v_scale, where as v_where
from .relayout import onehot_split_rows
from .vertex import (
    NSETUP, S_COLOR, S_E0A, S_E0B, S_E0C, S_E1A, S_E1B, S_E1C, S_E2A, S_E2B,
    S_E2C, S_IW0, S_MAT_ROW, S_NORMAL, S_TANGENT, S_TANGENT_W, S_UV0, S_UV1,
)

_EPS = 1e-6

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


def _punctual_lights(lights_host, n_lights: int, n_pos, n, v, base_diffuse,
                     f0, alpha_rough):
    """Dense punctual loop over the live lights (rows >= n_lights would
    add exact zeros in the reference's masked capacity loop)."""
    n_dot_v = torch.clamp(dot3(n, v), min=_EPS)
    total = [torch.zeros_like(alpha_rough) for _ in range(3)]
    for li in range(n_lights):
        row = [float(x) for x in lights_host[li]]
        total = _one_light(row, n_pos, n, v, base_diffuse, f0, alpha_rough,
                           n_dot_v, total)
    return total


def _material_table(ds) -> torch.Tensor:
    """(cap, NUM_F32 + 2) f32: the float params plus the kind and
    alpha-mode flag columns — the columns the untextured, extension-free
    shade reads."""
    flags = ds["mat_flags"][:, [M.MI_KIND, M.MI_ALPHA_MODE]].float()
    return torch.cat([ds["mat_float"], flags], dim=1).contiguous()


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
                             width: int, row_offset: int = 0):
    """Plain PyTorch twin of K2: winner column (P,) int32 -> {name: (P,)}
    for RESOLVE_NAMES. tri_id is the column itself (-1 on a miss); every
    float plane is 0 on a miss."""
    P = tid.shape[0]
    T = setup_rows.shape[0]
    S = setup_rows.index_select(0, tid.clamp(0, T - 1).long())   # (P, 64)
    ch = S.T
    i = torch.arange(P, device=tid.device)
    px = (i % width).float() + 0.5
    py = (torch.div(i, width, rounding_mode="floor")
          + row_offset).float() + 0.5
    res = _resolve_math(ch, px, py)
    miss = tid < 0
    out = {"tri_id": torch.where(miss, torch.full_like(tid, -1), tid)}
    zero = torch.zeros((), device=tid.device)
    for name in RESOLVE_NAMES[1:]:
        out[name] = torch.where(miss, zero, res[name])
    return out


def resolve_planes_fused(tid: torch.Tensor, setup_rows: torch.Tensor, *,
                         width: int, row_offset: int = 0):
    """K2: slim winner buffer -> the 21 RESOLVE_NAMES planes (P,).

    tid (P,) int32 raster columns (-1 = miss) over a width-wide pixel
    grid starting at row `row_offset`; setup_rows (T', NSETUP) f32. A CUDA
    tensor launches csrc/resolve.cu; a CPU tensor takes the twin."""
    if tid.device.type == "cpu":
        return resolve_planes_reference(tid, setup_rows, width=width,
                                        row_offset=row_offset)
    if tid.dtype != torch.int32 or tid.dim() != 1:
        raise ValueError("tid must be (P,) int32")
    if setup_rows.dtype != torch.float32 or setup_rows.shape[1] != NSETUP:
        raise ValueError(f"setup rows must be (T, {NSETUP}) f32")
    kernels.check_cuda(tid, setup_rows)
    P = tid.shape[0]
    out_tid = torch.empty_like(tid)
    planes = torch.empty((len(RESOLVE_NAMES) - 1, P), dtype=torch.float32,
                         device=tid.device)
    kernels.launch("resolve_planes_fused", "awsm_resolve",
                   tid.data_ptr(), setup_rows.data_ptr(),
                   setup_rows.shape[0], P, width, row_offset,
                   out_tid.data_ptr(), planes.data_ptr())
    out = {"tri_id": out_tid}
    out.update(zip(RESOLVE_NAMES[1:], planes))
    return out


def shade_surface(planes, ds, *, width: int, height: int, solid_env: bool):
    """Opaque fragment shading of the slice -> (rgb [3 planes], valid,
    sky [3 planes]).

    planes: {name: (P,)} G-buffer (tri_id, depth, mat_row, normal,
    optional colour). Untextured and extension-free by construction: the
    facade raises before a frame that binds a texture slot or uses a
    material extension reaches here."""
    P = width * height
    dev = planes["tri_id"].device
    miss = planes["tri_id"] < 0
    depth = planes["depth"]
    if "color_r" in planes:
        vcolor = [planes["color_r"], planes["color_g"], planes["color_b"],
                  planes["color_a"]]
    else:
        vcolor = [1.0, 1.0, 1.0, 1.0]
    n = norm3([planes["normal_x"], planes["normal_y"], planes["normal_z"]])

    # ---- world position + view ray ---------------------------------------
    cam = ds["camera"]
    i = torch.arange(P, device=dev)
    xs = ((i % width).float() + 0.5) / width * 2.0 - 1.0
    rows = torch.div(i, width, rounding_mode="floor").float()
    ys = 1.0 - (rows + 0.5) / height * 2.0
    ivp = [[float(x) for x in r] for r in cam["inv_view_proj"]]
    wp = [xs * ivp[j][0] + ys * ivp[j][1] + depth * ivp[j][2] + ivp[j][3]
          for j in range(4)]
    inv_w = 1.0 / torch.where(torch.abs(wp[3]) > _EPS, wp[3],
                              torch.full_like(wp[3], _EPS))
    world_pos = [wp[0] * inv_w, wp[1] * inv_w, wp[2] * inv_w]
    cam_pos = [float(x) for x in cam["position"]]
    v = norm3([cam_pos[k] - world_pos[k] for k in range(3)])

    # ---- material fetch (K3): one gather, channel-major ------------------
    table = _material_table(ds)
    mat_row = planes["mat_row"].to(torch.int32).clamp(0, table.shape[0] - 1)
    cols = onehot_split_rows(mat_row, table)                  # (C, P)

    def mf(idx, k=1):
        return cols[idx] if k == 1 else [cols[idx + c] for c in range(k)]

    kind = cols[M.NUM_F32]
    is_unlit = kind == float(M.KIND_UNLIT)

    base_f = mf(M.MF_BASE_COLOR, 4)
    base = [base_f[c] * vcolor[c] for c in range(4)]
    metallic = torch.clamp(mf(M.MF_METALLIC), 0.0, 1.0)
    roughness = torch.clamp(mf(M.MF_ROUGHNESS), 0.04, 1.0)
    alpha_rough = roughness * roughness
    emis_f = mf(M.MF_EMISSIVE, 3)
    emis_s = mf(M.MF_EMISSIVE_STRENGTH)
    emissive = [emis_f[c] * emis_s for c in range(3)]

    facing = dot3(n, v) < 0.0
    n_final = v_where(facing, [-c for c in n], n)

    # ---- BRDF inputs (glTF spec) -----------------------------------------
    ior = mf(M.MF_IOR)
    f0_scalar = ((ior - 1.0) / torch.clamp(ior + 1.0, min=_EPS)) ** 2
    spec_color = mf(M.MF_SPECULAR_COLOR, 3)
    spec_amt = mf(M.MF_SPECULAR)
    f0 = [torch.clamp(f0_scalar * spec_color[c], max=1.0) * spec_amt
          * (1.0 - metallic) + base[c] * metallic for c in range(3)]
    c_diff = v_scale(base[:3], 1.0 - metallic)

    # ---- punctual + IBL ---------------------------------------------------
    direct = _punctual_lights(ds["lights_host"], ds["n_lights"], world_pos,
                              n_final, v, c_diff, f0, alpha_rough)
    n_dot_v = torch.clamp(dot3(n_final, v), min=_EPS)
    r = norm3([2.0 * n_dot_v * n_final[k] - v[k] for k in range(3)])

    if solid_env:
        irr = [float(ds["irradiance"][0, c]) for c in range(3)]
        pref = [float(ds["prefiltered"][0, 0, c]) for c in range(3)]
        sky = [float(ds["skybox"][0, c]) for c in range(3)]
    else:
        irr4, prefs, sky4 = sample_env_batch_c(
            ds["skybox"].shape[0], ds["irradiance"].shape[0],
            ds["prefiltered"].shape[:2], n_final, [(r, roughness)],
            sky_dirs=[-c for c in v], texq=ds["texels"],
            env_base=ds["env_pool_base"])
        irr = irr4[:3]
        pref = prefs[0][:3]
        sky = sky4[:3]

    lut_a, lut_b = env_brdf_approx(n_dot_v, roughness)
    ambient = [irr[c] * c_diff[c] + pref[c] * (f0[c] * lut_a + lut_b)
               for c in range(3)]
    pbr_color = [direct[c] + ambient[c] + emissive[c] for c in range(3)]
    color = v_where(is_unlit, base[:3], pbr_color)
    return color, ~miss, sky


def shade_deferred_c(vis, ds, *, width: int, height: int,
                     solid_env: bool = False):
    """Deferred opaque shade -> HDR linear [r, g, b, a] (P,) planes: the
    shaded surface where covered, the skybox on a miss, alpha = coverage."""
    P = width * height
    planes = {k: vis[k].reshape(P) for k in vis if k != "bins"}
    color, valid, sky = shade_surface(planes, ds, width=width,
                                      height=height, solid_env=solid_env)
    out = [torch.where(valid, color[c], sky[c]) for c in range(3)]
    return out + [valid.float()]
