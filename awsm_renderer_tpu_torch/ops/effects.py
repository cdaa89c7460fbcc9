"""Post-processing effects: bloom, depth of field, SMAA.

Port of awsm_renderer_tpu/ops/effects.py (which has no Pallas kernel):
bloom's soft-knee extract, 5 circular gaussian blurs and blend; the
physically based DoF circle of confusion with the 16-tap golden-angle
disk at three static ring radii; single-pass SMAA on the display image.
Every stage is a whole-image stencil of shifted slices and elementwise
ops, in the reference's operation order. The channel-list API of the
reference stays; inside, the three colour planes ride one stacked
(3, H, W) tensor, so a tap is one launch for all of them (elementwise
ops give the same values per element either way). Camera parameters
enter as host floats, rounded to f32 where the reference computes them
as f32 scalars.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

BLOOM_BLUR_PASSES = 3   # reference: BLOOM_BLUR_PASSES const
BLOOM_THRESHOLD = 0.8   # bloom.wgsl BLOOM_THRESHOLD
BLOOM_INTENSITY = 0.5   # bloom.wgsl BLOOM_INTENSITY
BLOOM_RADIUS = 2.0      # bloom.wgsl BLOOM_RADIUS


def _luma(rgb):
    return rgb[0] * 0.2126 + rgb[1] * 0.7152 + rgb[2] * 0.0722


def _edge_pad(x: torch.Tensor, r: int) -> torch.Tensor:
    """Edge-replicate the last two dims of (C, H, W) by r."""
    return F.pad(x[None], (r, r, r, r), mode="replicate")[0]


def _bloom_threshold_c(rgb):
    """Soft-knee brightness extract (bloom.wgsl bloom_threshold) on a
    stacked (3, H, W) tensor."""
    brightness = _luma(rgb)
    contribution = torch.clamp(brightness - BLOOM_THRESHOLD, min=0.0)
    soft_threshold = BLOOM_THRESHOLD * 0.8
    knee = BLOOM_THRESHOLD - soft_threshold
    soft = torch.clamp((brightness - soft_threshold) / knee, 0.0, 1.0)
    factor = contribution / torch.clamp(brightness, min=1e-4) * soft
    return rgb * factor


def _bloom_taps():
    """bloom.wgsl blur_sample's 5x5 neighbourhood: (dy, dx, weight) with
    the corners beyond BLOOM_RADIUS skipped, normalized."""
    sigma = BLOOM_RADIUS
    r = int(np.ceil(BLOOM_RADIUS))
    taps = []
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            dist_sq = float(dy * dy + dx * dx)
            if dist_sq > BLOOM_RADIUS * BLOOM_RADIUS + 0.5:
                continue
            taps.append((dy, dx, np.exp(-dist_sq / (2.0 * sigma * sigma))))
    total = sum(w for _, _, w in taps)
    return r, [(dy, dx, float(w / total)) for dy, dx, w in taps]


def _bloom_blur_c(x):
    """Circular-masked gaussian stencil with edge clamp on (3, H, W)."""
    r, taps = _bloom_taps()
    _, H, W = x.shape
    xp = _edge_pad(x, r)
    out = torch.zeros_like(x)
    for dy, dx, w in taps:
        out = out + xp[:, r + dy:r + dy + H, r + dx:r + dx + W] * w
    return out


def bloom_c(rgb_ch):
    """Reference bloom pipeline (1 extract + BLOOM_BLUR_PASSES ping-pong
    blurs + 1 blend, all full resolution) on [r, g, b] (H, W) planes."""
    rgb = torch.stack(list(rgb_ch))
    b = _bloom_blur_c(_bloom_threshold_c(rgb))
    for _ in range(BLOOM_BLUR_PASSES):
        b = _bloom_blur_c(b)
    out = rgb + _bloom_blur_c(b) * BLOOM_INTENSITY
    return list(out)


def _with_alpha(out_rgb, img: torch.Tensor) -> torch.Tensor:
    """(H, W, 4) from 3 (H, W) planes and img's alpha."""
    return torch.cat([torch.stack(list(out_rgb), dim=-1), img[..., 3:4]],
                     dim=-1)


def bloom(hdr: torch.Tensor) -> torch.Tensor:
    """bloom_c on an (H, W, 4) image; alpha passes through."""
    return _with_alpha(bloom_c(list(hdr[..., :3].unbind(-1))), hdr)


DOF_MAX_BLUR = 16.0         # dof.wgsl DOF_MAX_BLUR (pixels)
DOF_SAMPLES = 16            # dof.wgsl DOF_SAMPLES
DOF_SENSOR_HEIGHT = 0.024   # dof.wgsl SENSOR_HEIGHT (24mm full frame)
DOF_GOLDEN_ANGLE = 2.39996323  # dof.wgsl get_disk_offset
DOF_RING_SCALES = (1.0, 0.5, 0.25)   # static disk radii: 16, 8, 4 px
_DOF_PAD = int(DOF_MAX_BLUR)


def dof_disk_offsets(scale: float = 1.0):
    """The 16 golden-angle disk taps at radius scale*DOF_MAX_BLUR: (dx,
    dy, dist) with integer pixel offsets (rounded like the WGSL
    round(offset)) and the pre-round euclidean distance."""
    taps = []
    for i in range(DOF_SAMPLES):
        theta = i * DOF_GOLDEN_ANGLE
        r = np.sqrt((i + 1) / DOF_SAMPLES) * DOF_MAX_BLUR * scale
        ox, oy = np.cos(theta) * r, np.sin(theta) * r
        taps.append((int(np.round(ox)), int(np.round(oy)),
                     float(np.hypot(ox, oy))))
    return taps


def dof_ring_weight(coc, scale: float):
    """Blend weight of the ring of radius R = scale*DOF_MAX_BLUR: a hat of
    log2(CoC), 1 at CoC == R, fading to the adjacent rings' radii (the
    smallest ring keeps 1 below its radius, the largest above)."""
    R = scale * DOF_MAX_BLUR
    t = torch.log2(torch.clamp(coc, min=1e-6)) - float(np.log2(R))
    up = torch.clamp(1.0 - t, 0.0, 1.0)
    dn = torch.clamp(1.0 + t, 0.0, 1.0)
    if scale >= max(DOF_RING_SCALES):
        up = torch.ones_like(up)
    if scale <= min(DOF_RING_SCALES):
        dn = torch.ones_like(dn)
    return torch.minimum(up, dn)


def _smoothstep(e0: float, e1: float, x):
    t = torch.clamp((x - e0) / max(e1 - e0, 1e-8), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def linearize_depth(depth: torch.Tensor, proj) -> torch.Tensor:
    """[0, 1] depth -> positive view-space distance from the (host)
    projection matrix, perspective or orthographic (dof.wgsl
    linearize_depth)."""
    A, B = float(np.float32(proj[2][2])), float(np.float32(proj[2][3]))
    d = torch.clamp(depth, 0.0, 1.0)
    if abs(float(proj[3][2])) > 0.5:
        den = d + A
        return B / torch.where(torch.abs(den) > 1e-8, den,
                               torch.full_like(den, 1e-8))
    return (B - d) / (A if abs(A) > 1e-12 else float(np.float32(1e-12)))


def linearize_depth_host(d: float, proj: np.ndarray) -> float:
    """Host mirror of linearize_depth for the per-frame CoC bound."""
    A = float(proj[2, 2])
    B = float(proj[2, 3])
    persp = abs(float(proj[3, 2])) > 0.5
    d = min(max(d, 0.0), 1.0)
    if persp:
        den = A + d
        return B / (den if abs(den) > 1e-8 else 1e-8)
    return (B - d) / (A if abs(A) > 1e-12 else 1e-12)


def _coc_scalars(camera):
    """(focus S, f * A_ap) as the reference's f32 scalars: focal length
    from proj[1][1] against a 24 mm sensor, aperture diameter f / N."""
    S = np.float32(camera["dof"][0])
    N = np.float32(camera["dof"][1])
    f = np.float32(DOF_SENSOR_HEIGHT * 0.5) * np.float32(camera["proj"][1][1])
    a_ap = f / np.maximum(N, np.float32(0.1))
    return S, np.float32(a_ap * f)


def dof_coc_c(depth: torch.Tensor, camera: dict) -> torch.Tensor:
    """Per-pixel circle of confusion in pixels (dof.wgsl calculate_coc):
    CoC = (f/N)*f*|D-S| / (D*S) over a 24 mm sensor, capped at
    DOF_MAX_BLUR."""
    S, af = _coc_scalars(camera)
    D = torch.clamp(linearize_depth(depth, camera["proj"]), min=1e-4)
    coc_world = float(af) * torch.abs(D - float(S)) / (
        D * float(np.maximum(S, np.float32(1e-3))))
    return torch.clamp(coc_world * depth.shape[0] / DOF_SENSOR_HEIGHT,
                       0.0, DOF_MAX_BLUR)


def dof_max_coc(dof_params, proj_11: float, dmin: float, dmax: float,
                height_px: int) -> float:
    """Host-side upper bound on the frame's CoC in pixels over the view
    distance range [dmin, dmax] (coc is monotone on either side of the
    focus distance, so the max sits at an endpoint)."""
    S, N = float(dof_params[0]), float(dof_params[1])
    f = DOF_SENSOR_HEIGHT * 0.5 * float(proj_11)
    A = f / max(N, 0.1)
    dmin = max(float(dmin), 1e-4)
    dmax = max(float(dmax), dmin)
    coc_w = max(A * f * abs(d - S) / (d * max(S, 1e-3)) for d in (dmin, dmax))
    return min(coc_w * height_px / DOF_SENSOR_HEIGHT, DOF_MAX_BLUR)


def dof_active_rings(coc_max: float):
    """Static ring set for a CoC bound: ring R keeps nonzero weight only
    when coc can exceed R/2; the smallest ring always stays. () when DoF
    is the identity (coc_max <= 1 px)."""
    if coc_max <= 1.0:
        return ()
    smallest = min(DOF_RING_SCALES)
    return tuple(s for s in DOF_RING_SCALES
                 if s == smallest or coc_max > s * DOF_MAX_BLUR / 2.0)


def _pad_once(p: torch.Tensor) -> torch.Tensor:
    """Edge-pad (C, H, W) by the largest tap radius once; every tap is
    then a slice of the same buffer."""
    return _edge_pad(p, _DOF_PAD)


def _shift_padded(xp: torch.Tensor, H: int, W: int, dy: int, dx: int):
    """Value at (y+dy, x+dx) of the original (clamped to the image), read
    from its _pad_once buffer."""
    return xp[..., _DOF_PAD + dy:_DOF_PAD + dy + H,
              _DOF_PAD + dx:_DOF_PAD + dx + W]


def depth_of_field_c(rgb_ch, depth: torch.Tensor, camera: dict,
                     rings=DOF_RING_SCALES):
    """dof.wgsl apply_dof on [r, g, b] (H, W) planes: the 16-tap disk at
    the static ring radii `rings` (dof_active_rings) blended by a
    log2(CoC) hat, each tap weighted by the background-bleed guard and the
    radial falloff at its true distance, floored at 0.01 before the ring
    hat; the sum renormalized and mixed by smoothstep(0, 2, coc).
    rings=() is the identity."""
    if not rings:
        return list(rgb_ch)
    rgb = torch.stack(list(rgb_ch))
    coc = dof_coc_c(depth, camera)
    D = torch.clamp(linearize_depth(depth, camera["proj"]), min=1e-4)
    H, W = coc.shape
    coc_safe = torch.clamp(coc, min=0.01)
    inv_coc = 1.0 / coc_safe
    inv_half = 2.0 * inv_coc                 # 1 / (coc - coc/2)
    rgb_p = _pad_once(rgb)
    D_p, coc_p = _pad_once(torch.stack([D, coc]))
    blur = rgb * 1.0                         # the centre tap, weight 1
    total_w = torch.ones_like(coc)
    for scale in rings:
        ring_w = dof_ring_weight(coc, scale)
        for dx, dy, dist in dof_disk_offsets(scale):
            s_rgb = _shift_padded(rgb_p, H, W, dy, dx)
            s_D = _shift_padded(D_p, H, W, dy, dx)
            s_coc = _shift_padded(coc_p, H, W, dy, dx)
            occluded = (s_D > D) & (s_coc < coc)
            w = torch.where(occluded, s_coc * inv_coc,
                            torch.ones_like(coc))
            t = torch.clamp((dist - coc * 0.5) * inv_half, 0.0, 1.0)
            w = torch.clamp(w * (1.0 - t * t * (3.0 - 2.0 * t)),
                            min=0.01) * ring_w
            blur = blur + s_rgb * w
            total_w = total_w + w
    inv = 1.0 / torch.clamp(total_w, min=0.01)
    blend = _smoothstep(0.0, 2.0, coc)
    return list(rgb * (1.0 - blend) + blur * inv * blend)


def depth_of_field(hdr: torch.Tensor, depth: torch.Tensor,
                   camera: dict) -> torch.Tensor:
    """depth_of_field_c (every ring) on an (H, W, 4) image; alpha passes
    through."""
    return _with_alpha(depth_of_field_c(list(hdr[..., :3].unbind(-1)),
                                        depth, camera), hdr)


SMAA_THRESHOLD = 0.03       # smaa.wgsl SMAA_THRESHOLD
SMAA_BLEND_STRENGTH = 0.6   # smaa.wgsl SMAA_BLEND_STRENGTH
_SMAA_OFFSETS = {
    "w": (0, -1), "e": (0, 1), "n": (-1, 0), "s": (1, 0),
    "nw": (-1, -1), "ne": (-1, 1), "sw": (1, -1), "se": (1, 1),
}


def smaa_c(rgb_ch):
    """Single-pass morphological AA (smaa.wgsl apply_smaa) on the display
    image's [r, g, b] (H, W) planes: 8-neighbour luma deltas, horizontal
    / vertical / diagonal edge classification, inverse-contrast weighted
    neighbourhood blending; wrap-around borders, as the reference's
    rolls."""
    rgb = torch.stack(list(rgb_ch))
    luma = _luma(rgb)

    def at_offset(x, dy, dx):
        """Value at pixel (y+dy, x+dx), wrapping."""
        return torch.roll(x, (-dy, -dx), dims=(-2, -1))

    d = {k: torch.abs(luma - at_offset(luma, *o))
         for k, o in _SMAA_OFFSETS.items()}
    max_h = torch.maximum(d["w"], d["e"])
    max_v = torch.maximum(d["n"], d["s"])
    max_diag = torch.maximum(torch.maximum(d["nw"], d["ne"]),
                             torch.maximum(d["sw"], d["se"]))
    max_delta = torch.maximum(torch.maximum(max_h, max_v), max_diag)
    no_edge = max_delta < SMAA_THRESHOLD
    is_diag = max_diag > torch.maximum(max_h, max_v)
    is_horiz = max_h > max_v            # horizontal edge: blend vertically
    c = {k: at_offset(rgb, *o) for k, o in _SMAA_OFFSETS.items()}

    def inv_w(a, b):
        wa = 1.0 / (a + 1e-3)
        wb = 1.0 / (b + 1e-3)
        t = wa + wb
        return wa / t, wb / t

    wt, wb = inv_w(d["n"], d["s"])
    wt = wt * SMAA_BLEND_STRENGTH
    wb = wb * SMAA_BLEND_STRENGTH
    blended_h = rgb * (1 - wt) + c["n"] * wt
    blended_h = blended_h * (1 - wb) + c["s"] * wb
    wl, wr = inv_w(d["w"], d["e"])
    wl = wl * SMAA_BLEND_STRENGTH
    wr = wr * SMAA_BLEND_STRENGTH
    blended_v = rgb * (1 - wl) + c["w"] * wl
    blended_v = blended_v * (1 - wr) + c["e"] * wr
    ws = {k: 1.0 / (d[k] + 1e-3) for k in ("nw", "ne", "sw", "se")}
    wtot = ws["nw"] + ws["ne"] + ws["sw"] + ws["se"]
    nb = sum(c[k] * (ws[k] / wtot) for k in ("nw", "ne", "sw", "se"))
    blended_d = (rgb * (1 - SMAA_BLEND_STRENGTH)
                 + nb * SMAA_BLEND_STRENGTH)
    out = torch.where(is_horiz, blended_h, blended_v)
    out = torch.where(is_diag, blended_d, out)
    return list(torch.where(no_edge, rgb, out))


def smaa(img: torch.Tensor) -> torch.Tensor:
    """smaa_c on an (H, W, 4) display image; alpha passes through."""
    return _with_alpha(smaa_c(list(img[..., :3].unbind(-1))), img)
