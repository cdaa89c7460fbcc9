"""PBR BRDF core (glTF 2.0 Appendix B): GGX distribution, height-correlated
Smith visibility, Schlick Fresnel, Lambert diffuse.

Port of the core of awsm_renderer_tpu/ops/brdf.py on (P,) tensors; the
extension lobes (sheen, clearcoat, iridescence, anisotropy) come with the
material-extension milestone (ROADMAP.md).
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
