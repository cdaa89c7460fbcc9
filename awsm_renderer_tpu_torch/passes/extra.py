"""User geometry drawn mid-frame (reference: passes/extra.py).

RenderHooks callbacks receive the HDR or display image, so an "extra
pass" is a function that rasterizes a few extra triangles over it: the
editor's grid, gizmos, debug lines. It walks the triangles one after
another (the blend depends on their order, as the reference's lax.scan)
with full-screen edge tests: O(triangles x pixels) elementwise work with
no setup, meant for editor-scale geometry (tens to hundreds of
triangles), with the main raster's rules: the top-left fill rule,
perspective-correct colour, a depth test and write on [0, 1] depth.
"""

from __future__ import annotations

import numpy as np
import torch


def project_triangles(camera: dict, tris_world: torch.Tensor):
    """World-space (T, 3, 3) triangle corners -> clip-space (T, 3, 4)
    through the camera dict's view_proj (a numpy array or tensor)."""
    vp = torch.as_tensor(camera["view_proj"], dtype=torch.float32,
                         device=tris_world.device)
    p = torch.cat([tris_world, torch.ones((*tris_world.shape[:2], 1),
                                          device=tris_world.device)], dim=-1)
    return torch.einsum("ij,tcj->tci", vp, p)


def extra_geometry_pass(img: torch.Tensor, depth, camera: dict,
                        tris_world: torch.Tensor, colors: torch.Tensor, *,
                        depth_test: bool = True, depth_write: bool = False,
                        two_sided: bool = True):
    """Rasterize user triangles over `img` (H, W, 4) with alpha blending;
    returns (img, depth). depth: the (H, W) f32 depth plane, or None (a
    display overlay: every pixel at the far plane). colors: (T, 3, 4)
    per-corner RGBA or (T, 4) flat. Call it from a hook:

      before_transparent(hdr, depth, ds): world space, depth-tested
      last_pass(ldr, ds):                 display overlay (depth=None)

    A triangle with a corner at w <= 0 is dropped (no clipping: split
    geometry that crosses the near plane first). Front faces wind
    clockwise in y-down screen space; two_sided=False drops back faces.
    Returns the depth plane only when one was given or depth_write."""
    H, W = img.shape[:2]
    dev = img.device
    if colors.dim() == 2:
        colors = colors[:, None, :].expand(*tris_world.shape[:2], 4)
    clip = project_triangles(camera, tris_world)          # (T, 3, 4)
    px = torch.arange(W, dtype=torch.float32, device=dev)[None, :] + 0.5
    py = torch.arange(H, dtype=torch.float32, device=dev)[:, None] + 0.5
    dep = (torch.ones((H, W), device=dev) if depth is None
           else depth.reshape(H, W))
    rgba = [img[..., c] for c in range(4)]
    # the per-triangle scalars come to the host once: the walk branches on
    # them (orientation, validity) as the reference's scan selects
    clip_h = clip.detach().cpu().numpy().astype(np.float32)
    col_h = colors.detach().cpu().numpy().astype(np.float32)
    f32 = np.float32
    for c, col in zip(clip_h, col_h):
        w = c[:, 3]
        iw = f32(1.0) / np.where(np.abs(w) > 1e-20, w, f32(1e-20))
        sx = (c[:, 0] * iw * f32(0.5) + f32(0.5)) * f32(W)
        sy = (f32(0.5) - c[:, 1] * iw * f32(0.5)) * f32(H)
        z = c[:, 2] * iw
        area2 = ((sx[1] - sx[0]) * (sy[2] - sy[0])
                 - (sx[2] - sx[0]) * (sy[1] - sy[0]))
        front = bool(area2 < 0.0)
        # clockwise-front in y-down screen space: flip to the positive
        # orientation
        ix = [0, 2, 1] if front else [0, 1, 2]
        if not ((w > 0.0).all() and (front or two_sided)
                and abs(area2) > 1e-12):
            continue
        sxo, syo, zo, iwo, colo = sx[ix], sy[ix], z[ix], iw[ix], col[ix]

        def edge(a, b):
            # edge opposite corner i, interior positive; the top-left
            # rule: edges pointing left (A > 0) or horizontal top (A == 0,
            # B < 0) own their boundary pixels
            A = f32(syo[a] - syo[b])
            B = f32(sxo[b] - sxo[a])
            C = f32(sxo[a] * syo[b] - sxo[b] * syo[a])
            e = A * px + B * py + C
            owns = A > 0 or (A == 0 and B < 0)
            return (e >= 0.0) if owns else (e > 0.0), e

        m0, e0 = edge(1, 2)
        m1, e1 = edge(2, 0)
        m2, e2 = edge(0, 1)
        inv_sum = 1.0 / torch.clamp(e0 + e1 + e2, min=1e-30)
        l0, l1, l2 = e0 * inv_sum, e1 * inv_sum, e2 * inv_sum
        zpix = l0 * float(zo[0]) + l1 * float(zo[1]) + l2 * float(zo[2])
        covered = m0 & m1 & m2 & (zpix >= 0.0) & (zpix <= 1.0)
        if depth_test:
            covered = covered & (zpix <= dep)
        # perspective-correct colour
        w0, w1, w2 = (l0 * float(iwo[0]), l1 * float(iwo[1]),
                      l2 * float(iwo[2]))
        inv_pw = 1.0 / torch.clamp(w0 + w1 + w2, min=1e-30)
        ch = [(w0 * float(colo[0, k]) + w1 * float(colo[1, k])
               + w2 * float(colo[2, k])) * inv_pw for k in range(4)]
        a = torch.where(covered, ch[3], 0.0)
        rgba = ([torch.where(covered, ch[k] * a + rgba[k] * (1 - a), rgba[k])
                 for k in range(3)]
                + [torch.where(covered, torch.maximum(rgba[3], a), rgba[3])])
        if depth_write:
            dep = torch.where(covered, zpix, dep)
    out = torch.stack(rgba, dim=-1)
    return out, (None if depth is None and not depth_write else dep)
