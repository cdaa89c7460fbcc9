"""PBR BRDF math (glTF 2.0 Appendix B + material extensions): GGX
distribution, height-correlated Smith visibility, Schlick Fresnel,
Lambert diffuse; the sheen (Charlie + Ashikhmin), thin-film iridescence
and anisotropic GGX lobes.

Port of awsm_renderer_tpu/ops/brdf.py on (P,) tensors (the *_c forms take
[r, g, b] channel lists, see ops/cvec.py).
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-6


def saturate(x):
    return torch.clamp(x, 0.0, 1.0)


def d_ggx(n_dot_h, alpha_rough):
    """Trowbridge-Reitz / GGX normal distribution."""
    a2 = alpha_rough * alpha_rough
    f = n_dot_h * n_dot_h * (a2 - 1.0) + 1.0
    return a2 / torch.clamp(math.pi * f * f, min=_EPS)


def v_smith_ggx_correlated(n_dot_v, n_dot_l, alpha_rough):
    """Height-correlated Smith visibility (glTF spec form)."""
    a2 = alpha_rough * alpha_rough
    ggx_v = n_dot_l * torch.sqrt(
        torch.clamp(n_dot_v * n_dot_v * (1 - a2) + a2, min=_EPS))
    ggx_l = n_dot_v * torch.sqrt(
        torch.clamp(n_dot_l * n_dot_l * (1 - a2) + a2, min=_EPS))
    return 0.5 / torch.clamp(ggx_v + ggx_l, min=_EPS)


def f_schlick(v_dot_h, f0, f90=1.0):
    """Fresnel-Schlick for one channel."""
    w = torch.pow(saturate(1.0 - v_dot_h), 5.0)
    return f0 + (f90 - f0) * w


def f_schlick3(v_dot_h, f0_3, f90=1.0):
    """Fresnel-Schlick over an [r,g,b] channel list (see ops/cvec.py)."""
    w = torch.pow(saturate(1.0 - v_dot_h), 5.0)
    return [f0 + (f90 - f0) * w for f0 in f0_3]


def specular_ggx(n_dot_l, n_dot_v, n_dot_h, alpha_rough):
    """Specular lobe without Fresnel: D * V (P,)."""
    return (d_ggx(n_dot_h, alpha_rough)
            * v_smith_ggx_correlated(n_dot_v, n_dot_l, alpha_rough))


def diffuse_lambert(base_color):
    return base_color / math.pi


# ---- sheen (KHR_materials_sheen; Charlie distribution) ---------------------

def d_charlie(n_dot_h, sheen_rough):
    alpha = torch.clamp(sheen_rough * sheen_rough, min=1e-3)
    inv_a = 1.0 / alpha
    cos2 = n_dot_h * n_dot_h
    sin2 = torch.clamp(1.0 - cos2, min=_EPS)
    return (2.0 + inv_a) * torch.pow(sin2, inv_a * 0.5) / (2.0 * math.pi)


def v_ashikhmin(n_dot_l, n_dot_v):
    return 1.0 / torch.clamp(4.0 * (n_dot_l + n_dot_v - n_dot_l * n_dot_v),
                             min=_EPS)


def sheen_brdf(sheen_color, sheen_rough, n_dot_l, n_dot_v, n_dot_h):
    """sheen_color (P, 3) -> (P, 3)."""
    d = d_charlie(n_dot_h, sheen_rough)
    v = v_ashikhmin(n_dot_l, n_dot_v)
    return sheen_color * (d * v)[:, None]


def sheen_albedo_scaling_c(n_dot_v, sheen_color3, sheen_rough):
    """Energy compensation of the sheen lobe (the reference's max-component
    fit of the Charlie lobe's directional albedo)."""
    max_c = torch.maximum(torch.maximum(sheen_color3[0], sheen_color3[1]),
                          sheen_color3[2])
    e = (0.65 * (1.0 - torch.pow(1.0 - n_dot_v, 3.0))
         * torch.sqrt(torch.clamp(sheen_rough, min=1e-3)))
    return 1.0 - max_c * saturate(e)


# ---- iridescence (KHR_materials_iridescence, thin film) --------------------

def _fresnel_dielectric(cos_theta, ior_ratio):
    """Exact unpolarized dielectric Fresnel (per-pixel ior ratio)."""
    c = saturate(cos_theta)
    g2 = ior_ratio * ior_ratio - 1.0 + c * c
    g = torch.sqrt(torch.clamp(g2, min=0.0))
    a = (g - c) / torch.clamp(g + c, min=_EPS)
    b = (c * (g + c) - 1.0) / torch.clamp(c * (g - c) + 1.0, min=_EPS)
    return torch.where(g2 >= 0.0, 0.5 * a * a * (1.0 + b * b),
                       torch.ones_like(c))


def iridescent_fresnel_c(outside_ior, iridescence_ior, base_f0_3, thickness,
                         cos_theta1):
    """Thin-film interference Fresnel per channel (the spec's simplified
    two-bounce Airy sum at 612/549/465 nm); thickness in nanometres."""
    eta1 = outside_ior / iridescence_ior
    sin2 = eta1 * eta1 * (1.0 - cos_theta1 * cos_theta1)
    cos_theta2 = torch.sqrt(torch.clamp(1.0 - sin2, min=0.0))
    opd = 2.0 * iridescence_ior * thickness * cos_theta2
    r12 = _fresnel_dielectric(cos_theta1, iridescence_ior / outside_ior)
    t121 = 1.0 - r12
    out = []
    for c, wl in enumerate((612.0, 549.0, 465.0)):
        phi = 2.0 * math.pi * opd / wl
        f0 = torch.clamp(base_f0_3[c], 0.0, 0.9999)
        f0s = torch.sqrt(f0)
        base_ior = (1.0 + f0s) / torch.clamp(1.0 - f0s, min=_EPS)
        r23 = _fresnel_dielectric(cos_theta2, base_ior / iridescence_ior)
        r_phi = r12 + t121 * t121 * r23 / torch.clamp(1.0 - r12 * r23,
                                                      min=_EPS)
        cos_term = torch.cos(phi)
        out.append(saturate(r_phi * (1.0 + cos_term) * 0.5
                            + base_f0_3[c] * (1.0 - cos_term) * 0.5))
    return out


# ---- anisotropy (KHR_materials_anisotropy) ----------------------------------

def d_ggx_anisotropic(n_dot_h, t_dot_h, b_dot_h, at, ab):
    a2 = at * ab
    v0 = t_dot_h / torch.clamp(at, min=_EPS) * a2 * 0 + t_dot_h * ab
    v1 = b_dot_h * at
    v2 = n_dot_h * at * ab
    vv = v0 * v0 + v1 * v1 + v2 * v2
    w2 = a2 / torch.clamp(vv, min=_EPS)
    return a2 * w2 * w2 / math.pi


def v_smith_ggx_anisotropic(n_dot_v, n_dot_l, t_dot_v, b_dot_v, t_dot_l,
                            b_dot_l, at, ab):
    lv = n_dot_l * torch.sqrt(torch.clamp(
        t_dot_v * t_dot_v * at * at + b_dot_v * b_dot_v * ab * ab
        + n_dot_v * n_dot_v, min=_EPS))
    ll = n_dot_v * torch.sqrt(torch.clamp(
        t_dot_l * t_dot_l * at * at + b_dot_l * b_dot_l * ab * ab
        + n_dot_l * n_dot_l, min=_EPS))
    return 0.5 / torch.clamp(lv + ll, min=_EPS)
