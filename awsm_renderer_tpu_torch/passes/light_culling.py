"""Light culling: tiled light lists.

Port of awsm_renderer_tpu/passes/light_culling.py. Two consumers share
`light_lists_from_bounds`:

- the shading path (ops/shade.py `_punctual_lights_tiled`) builds its
  lists over the shade layout's 128-pixel units, from the world AABB of
  each unit's covered pixels; the renderer engages it when
  `lights.count > 8` (RendererConfig.light_tiles overrides the rule);
- `cull_lights`, the standalone pass for hook consumers, rebuilds tile
  AABBs from the depth plane through the inverse view-projection and
  runs the same test and priority, so its lists match the in-shade ones
  on matching units.

Per unit: a light overlaps when it is directional or of unlimited range,
or when its range sphere reaches the unit's AABB; its priority is its
estimated contribution (intensity for a directional light, intensity /
(1 + d^2) for a positional one, d the distance to the box). The K
highest priorities make the list, so on overflow the faintest drop.

Tie order: the reference's `jax.lax.top_k` lists the lower light index
first among equal scores, and ties are common (equal directional lights
tie in every unit; an empty unit lists only the always-on lights). A
stable descending sort keeps that order; `torch.topk` promises none.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.lights import L_INTENSITY, L_KIND, L_POSITION, L_RANGE

MAX_LIGHTS_PER_TILE = 16

_EPS = 1e-6


def light_lists_from_bounds(mn, mx, lights: torch.Tensor, n_lights: int,
                            K: int):
    """Per-unit light lists from unit world AABBs.

    mn, mx: 3-lists of (n_units,) f32 unit AABB bounds per axis (an empty
    unit may use mn = +BIG / mx = -BIG; only always-on lights then overlap
    it). lights: (L, 16) packed rows (core/lights.py layout); rows at or
    past n_lights never list. Returns (lidx (n_units, K) int64 light rows,
    valid (n_units, K) bool)."""
    L = lights.shape[0]
    kind = lights[:, L_KIND]
    lrange = lights[:, L_RANGE]
    always = (kind == 0.0) | (lrange <= 0.0)
    d2 = None
    for a in range(3):
        c = lights[None, :, L_POSITION + a]               # (1, L)
        dd = (torch.clamp(mn[a][:, None] - c, min=0.0)
              + torch.clamp(c - mx[a][:, None], min=0.0))
        d2 = dd * dd if d2 is None else d2 + dd * dd
    live = torch.arange(L, device=lights.device)[None, :] < n_lights
    overlap = (always[None, :] | (d2 <= (lrange * lrange)[None, :])) & live
    # a zero-intensity overlapping light still beats an empty slot: the
    # floor keeps the lists exact whenever at most K lights reach a unit
    intensity = lights[None, :, L_INTENSITY]
    contrib = torch.where(kind[None, :] == 0.0, intensity,
                          intensity / (1.0 + d2))
    score = torch.where(overlap, torch.clamp(contrib, min=1e-20), 0.0)
    vals, order = torch.sort(score, dim=1, descending=True, stable=True)
    return order[:, :K], vals[:, :K] > 0


def cull_lights(lights: torch.Tensor, n_lights: int, depth_plane, camera,
                *, width: int, height: int, tile_h: int = 8,
                tile_w: int = 128):
    """Standalone tiled light culling over the depth plane.

    Unprojects every covered pixel (depth < 1) through the camera's
    inverse view-projection, reduces a world AABB per tile (raster order:
    tile = ty * (width // tile_w) + tx) and lists the lights as
    `light_lists_from_bounds`. With tile_h=1, tile_w=128 the tiles are the
    band-space units of the ordinary shade.

    lights: (L, 16) rows; depth_plane: (height*width,) or (height, width)
    NDC depth; camera: a camera dict whose "inv_view_proj" is a 4x4 numpy
    array or tensor. Returns (lists (n_tiles, K) int64, counts (n_tiles,)
    int64) with K = min(MAX_LIGHTS_PER_TILE, L); slots at or past a tile's
    count are not lights of that tile."""
    H, W, th, tw = height, width, tile_h, tile_w
    if H % th or W % tw:
        raise ValueError(f"{W}x{H} is not a grid of {tw}x{th} tiles")
    dev = lights.device
    d = torch.as_tensor(depth_plane, device=dev).reshape(H, W)
    xs = (torch.arange(W, dtype=torch.float32, device=dev) + 0.5) / W \
        * 2.0 - 1.0
    ys = 1.0 - (torch.arange(H, dtype=torch.float32, device=dev) + 0.5) \
        / H * 2.0
    nx = xs[None, :].expand(H, W)
    ny = ys[:, None].expand(H, W)
    ivp = np.asarray(torch.as_tensor(camera["inv_view_proj"]).cpu(),
                     np.float32)
    iv = [[float(x) for x in row] for row in ivp]
    wp = [nx * iv[j][0] + ny * iv[j][1] + d * iv[j][2] + iv[j][3]
          for j in range(4)]
    iw = 1.0 / torch.where(torch.abs(wp[3]) > _EPS, wp[3],
                           torch.full_like(wp[3], _EPS))
    pos = [wp[a] * iw for a in range(3)]
    covered = d < 1.0

    def tiles(p):
        return (p.reshape(H // th, th, W // tw, tw).transpose(1, 2)
                .reshape(-1, th * tw))

    cov_t = tiles(covered)
    mn = [torch.where(cov_t, tiles(p), 3e38).amin(dim=1) for p in pos]
    mx = [torch.where(cov_t, tiles(p), -3e38).amax(dim=1) for p in pos]
    K = min(MAX_LIGHTS_PER_TILE, lights.shape[0])
    lidx, valid = light_lists_from_bounds(mn, mx, lights, n_lights, K)
    return lidx, valid.sum(dim=1)
