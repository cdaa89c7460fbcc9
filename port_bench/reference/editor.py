"""The plain reference of an editing session: the shared reference
(render.py) plus what an editor frame draws besides the scene.

- "unlit" materials (the gizmo's handles): the base colour factor, as it
  is, in place of the lit colour.
- "grid" materials (the editor's ground grid) in the alpha-blended
  layers: the base colour under a procedural line alpha at the fragment's
  world x and z. Minor lines every `spacing`, major lines every
  `spacing * major_every`; a line's alpha is 1 within its half-width w of
  the line and falls linearly to 0 at 2w, w = 2e-3 x the distance to the
  camera (1.5x that for major lines); alpha = max(minor / 2, major) x
  clamp(1 - distance / fade_distance, 0, 1) x the base colour's alpha.
- the HUD pass: the meshes flagged `hud`, after the alpha-blended layers
  and before bloom, depth of field and the tonemap, at display
  resolution (the overlay's sample layout) with a depth of their own,
  cleared for the pass: the nearest HUD fragment of a pixel is blended
  over the HDR image by its alpha, and the coverage takes the larger of
  the two.

Written from those semantics (awsm-renderer's editor crate: the gizmo
and grid/); nothing here imports the program.
"""

from __future__ import annotations

import torch

from . import render

UNLIT, GRID = 1.0, 2.0


class Reference(render.Reference):
    KINDS = ("pbr", "unlit", "grid")
    HUD = True

    def __init__(self, scene, device, dtype=torch.float32):
        super().__init__(scene, device, dtype)
        mats = scene.materials
        t = self._t
        self.m_kind = t([{"unlit": UNLIT, "grid": GRID}.get(m.kind, 0.0)
                         for m in mats])
        g = [m.grid if m.kind == "grid" else {} for m in mats]
        self.m_spacing = t([x.get("spacing", 1.0) for x in g])
        self.m_major = t([x.get("major_every", 10.0) for x in g])
        self.m_fade = t([x.get("fade_distance", 60.0) for x in g])
        hud = [m for m in scene.meshes if m.hud]
        self.hud = self._tables(hud) if hud else None

    def _surface(self, color, alpha, base, mat, world, cpos, transparent):
        kind = self.m_kind[mat]
        color = torch.where(kind == UNLIT, base[:3], color)
        if not transparent:
            return color, alpha
        spacing = torch.clamp(self.m_spacing[mat], min=1e-3)
        major_every = torch.clamp(self.m_major[mat], min=1.0)
        fade = torch.clamp(self.m_fade[mat], min=1e-3)
        d = world - cpos
        dist = torch.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
        w = torch.clamp(dist * 2e-3, min=1e-4)

        def line(p, sp, wdt):
            off = torch.abs(torch.remainder(p / sp + 0.5, 1.0) - 0.5) * sp
            return torch.clamp(1.0 - (off - wdt) / torch.clamp(wdt, min=1e-6),
                               0.0, 1.0)

        x, z = world[0], world[2]
        minor = torch.maximum(line(x, spacing, w), line(z, spacing, w))
        major = torch.maximum(line(x, spacing * major_every, w * 1.5),
                              line(z, spacing * major_every, w * 1.5))
        grid_a = torch.maximum(minor * 0.5, major) * torch.clamp(
            1.0 - dist / fade, 0.0, 1.0)
        is_grid = kind == GRID
        return (torch.where(is_grid, base[:3], color),
                torch.where(is_grid, grid_a * base[3], alpha))

    def _hud(self, hdr, vp, cam, ndc_x, ndc_y, xx, yy):
        if self.hud is None:
            return hdr
        W, H = self.W, self.H
        tri, clip = self._near_clip(self.hud, self._clip(self.hud["pos"], vp))
        su = self._setup(tri, clip, W, H, torch.ones_like(tri["transparent"]))
        ids = su["keep"].nonzero()[:, 0]
        if ids.numel() == 0:
            return hdr
        win, z = self._raster(su, ids, W, H)
        r = self._resolve(su, tri, win.reshape(-1), xx + 0.5, yy + 0.5, False)
        color, alpha, _ = self._shade(r, ndc_x, ndc_y,
                                      z.reshape(-1).to(self.dt), cam)
        valid = r["valid"]
        a = torch.where(valid, alpha, torch.zeros_like(alpha))
        rgb, cov = hdr[:3].reshape(3, -1), hdr[3].reshape(-1)
        rgb = torch.where(valid, color * a + rgb * (1.0 - a), rgb)
        cov = torch.where(valid, torch.maximum(cov, a), cov)
        return torch.cat([rgb, cov[None]]).reshape(4, H, W)
