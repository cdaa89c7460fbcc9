"""The plain reference renderer: a scene description (port_bench/scene.py)
and a camera in, the (H, W, 4) display image out, in plain PyTorch.

What it computes, in the order a frame does:

1. vertex: world-space corners (model matrix; normals by its inverse
   transpose), clip space by the camera's view-projection; a triangle
   that crosses the near plane is clipped there in clip space, before
   the divide, into one triangle or two, its attributes interpolated
   linearly at the crossing; screen space on the raster grid (twice the
   display size under MSAA-4x); back faces culled unless double-sided.
2. visibility: a z-buffer over every sample, by brute force over each
   triangle's bounding box: edge functions with the top-left rule at
   sample centres, the affine NDC z plane, the nearest fragment (lower
   triangle index on an exact tie).
3. resolve: perspective-correct barycentrics at the shading point (the
   pixel centre, or under MSAA the top-left sample of the pixel),
   interpolated uv, normal and tangent; uv gradients analytic (MSAA, and
   the transparent layers, per raster sample) or as the smaller of the
   forward and backward screen differences (single-sample frames).
4. shading: glTF metallic-roughness with its five texture slots
   (trilinear), normal mapping, GGX + Smith + Schlick for each
   directional and point light (range falloff), the split-sum IBL
   (irradiance cube, prefiltered chain, the analytic environment BRDF),
   occlusion and emission; the skybox where nothing is hit.
5. MSAA-4x: shaded once per pixel; each of the four samples takes the
   colour of the pixel whose shading sample hit the same triangle (its
   own, else the axis neighbours towards the sample, then the diagonal,
   wrapping at the borders), and the four average.
6. the alpha-blended layers: depth-peeled in front of the opaque depth
   (the nearest of a pixel's samples), up to max_layers, composited back
   to front.
7. bloom, depth of field, tonemap and the sRGB transfer (post.py).

Every float tensor is in `dtype` (float32, or bfloat16 for the
control). Nothing here imports the program. It shades "pbr" materials
and draws no HUD; a scene with other material kinds or HUD meshes needs
a subclass that does (editor.py), and this class refuses it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import env as env_mod
from . import post
from . import texture as tex_mod
from ..scene import SLOTS

_EPS = 1e-6
# the near plane in clip space, [0, 1] depth: z_clip > _Z_EPS lies in front
_Z_EPS = 1e-6
# candidate (triangle, sample) pairs tested at once
_CHUNK = 1 << 23


def _norm3(v):
    m = torch.clamp(torch.sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2]),
                    min=_EPS)
    return v / m


def _dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _cross3(a, b):
    return torch.stack([a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
                        a[0] * b[1] - a[1] * b[0]])


def _screen_gradient(p: torch.Tensor, vertical: bool):
    """Smaller-magnitude forward/backward difference of an (H, W) plane,
    edge-replicated at the borders."""
    ax = 0 if vertical else 1
    d = torch.diff(p, dim=ax)
    first, last = d.narrow(ax, 0, 1), d.narrow(ax, d.shape[ax] - 1, 1)
    fwd = torch.cat([d, last], ax)
    bwd = torch.cat([first, d], ax)
    return torch.where(fwd.abs() <= bwd.abs(), fwd, bwd)


class Reference:
    """Renders frames of one scene; the scene's tables are built once."""

    #: the material kinds _shade and _surface know, and whether _hud draws
    KINDS = ("pbr",)
    HUD = False

    def __init__(self, scene, device, dtype=torch.float32):
        self.scene = scene
        self.dev = torch.device(device)
        self.dt = dtype
        st = scene.settings
        self.W, self.H = int(st["width"]), int(st["height"])
        self.msaa = bool(st.get("msaa", False))
        self.use_mips = bool(st.get("mipmap", True))
        self.max_layers = int(st.get("max_transparent_layers", 4))
        kinds = sorted({m.kind for m in scene.materials} - set(self.KINDS))
        if kinds or (not self.HUD and any(m.hud for m in scene.meshes)):
            raise ValueError(f"{type(self).__name__} shades no material of "
                             f"kind {kinds} and draws no HUD mesh")

        t = self._t
        self.aabbs = []
        for m in scene.meshes:
            Wm = np.asarray(m.world, np.float64)
            p = np.asarray(m.positions, np.float64) @ Wm[:3, :3].T + Wm[:3, 3]
            self.aabbs.append((p.min(0), p.max(0)))
        self.tri = self._tables([m for m in scene.meshes if not m.hud])

        mats = scene.materials
        self.m_base = t([m.base_color for m in mats])
        self.m_metal = t([m.metallic for m in mats])
        self.m_rough = t([m.roughness for m in mats])
        self.m_emis = t([m.emissive for m in mats])
        self.m_occ = t([m.occlusion_strength for m in mats])
        self.m_nscale = t([m.normal_scale for m in mats])
        self.m_blend = t([m.alpha_mode == "blend" for m in mats], torch.bool)
        self.m_tex = {s: t([m.textures.get(s, -1) for m in mats],
                           torch.int64) for s in SLOTS}
        self.textures = [[t(lv) for lv in tex_mod.mip_chain(
            tex_mod.decode(x.image, x.srgb), x.kind)] for x in scene.textures]

        faces = env_mod.equirect_to_cubemap(scene.env_equirect,
                                            scene.env_size)
        pref, irr = env_mod.ibl_maps(faces)
        self.sky, self.pref, self.irr = t(faces), t(pref), t(irr)
        self.lights = scene.lights

    def _t(self, a, dt=None):
        return torch.as_tensor(np.asarray(a), device=self.dev,
                               dtype=dt or self.dt)

    def _tables(self, meshes) -> dict:
        """Per-triangle tables of `meshes`: world corners (T, 3, 3),
        normals and tangents by corner, the tangents' handedness, uvs
        (T, 3, 2), material, transparent and double-sided flags."""
        pos, nrm, tan, tw, uv, mat, trans, dsd = [], [], [], [], [], [], [], []
        for m in meshes:
            Wm = np.asarray(m.world, np.float64)
            nm = np.linalg.inv(Wm[:3, :3]).T
            idx = np.asarray(m.indices, np.int64)
            p = np.asarray(m.positions, np.float64) @ Wm[:3, :3].T + Wm[:3, 3]
            pos.append(p[idx])
            nrm.append((np.asarray(m.normals, np.float64) @ nm.T)[idx])
            tg = np.asarray(m.tangents, np.float64)
            tan.append((tg[:, :3] @ Wm[:3, :3].T)[idx])
            tw.append(tg[idx[:, 0], 3])
            uv.append(np.asarray(m.uv0, np.float64)[idx])
            n = idx.shape[0]
            mat.append(np.full(n, m.material))
            trans.append(np.full(n, m.transparent))
            dsd.append(np.full(n, m.double_sided))
        t = self._t
        return dict(pos=t(np.concatenate(pos)), nrm=t(np.concatenate(nrm)),
                    tan=t(np.concatenate(tan)), tan_w=t(np.concatenate(tw)),
                    uv=t(np.concatenate(uv)),
                    mat=t(np.concatenate(mat), torch.int64),
                    transparent=t(np.concatenate(trans), torch.bool),
                    double_sided=t(np.concatenate(dsd), torch.bool))

    # ---- visibility -------------------------------------------------------

    def _clip(self, pos, vp):
        """Clip-space x, y, z, w of world corners `pos` (T, 3, 3): four
        (T, 3) planes."""
        vpf = [[float(x) for x in r] for r in vp]
        return [sum(pos[:, :, k] * vpf[j][k] for k in range(3)) + vpf[j][3]
                for j in range(4)]

    _CORNER_KEYS = ("nrm", "tan", "uv")

    def _near_clip(self, tri, clip):
        """Triangles that cross the near plane, clipped in clip space
        before the divide: with one corner in front, the triangle from it
        to the two crossings; with two, the quad they cut off, as two
        triangles. The crossings' clip coordinates, normals, tangents and
        uvs are the corners' interpolated linearly at the crossing. The
        first triangle takes the original's index, a second is appended
        after every original. Returns (tri, clip) as they came when no
        triangle crosses."""
        inside = clip[2] > _Z_EPS
        n_in = inside.sum(1)
        cross = ((n_in > 0) & (n_in < 3)).nonzero()[:, 0]
        if cross.numel() == 0:
            return tri, clip
        ins, n = inside[cross], n_in[cross]
        # rotate so that corner a is the one in front (n = 1), or c the one
        # behind (n = 2); the winding is kept
        first_in = ins.int().argmax(1)
        first_out = (~ins).int().argmax(1)
        rot = torch.where(n == 1, first_in, (first_out + 1) % 3)
        order = (rot[:, None] + torch.arange(3, device=self.dev)) % 3
        corner = {k: tri[k][cross] for k in self._CORNER_KEYS}
        corner["clip"] = torch.stack([c[cross] for c in clip], -1)
        corner = {k: v.gather(1, order[:, :, None].expand(-1, -1, v.shape[2]))
                  for k, v in corner.items()}
        zc = corner["clip"][:, :, 2]

        def at(k):
            return {key: v[:, k] for key, v in corner.items()}

        def crossing(p, q):
            dz = zc[:, q] - zc[:, p]
            t = torch.clamp((_Z_EPS - zc[:, p]) / torch.where(
                dz.abs() > 1e-20, dz, torch.ones_like(dz)), 0.0, 1.0)[:, None]
            return {key: v[:, p] + t * (v[:, q] - v[:, p])
                    for key, v in corner.items()}

        a, b = at(0), at(1)
        i_ab, i_ac, i_bc = crossing(0, 1), crossing(0, 2), crossing(1, 2)
        one = (n == 1)[:, None]
        first = {k: torch.stack([a[k], torch.where(one, i_ab[k], b[k]),
                                 torch.where(one, i_ac[k], i_bc[k])], 1)
                 for k in corner}
        two = (n == 2).nonzero()[:, 0]
        second = {k: torch.stack([a[k], i_bc[k], i_ac[k]], 1)[two]
                  for k in corner}
        out = {}
        for k, v in tri.items():
            if k == "pos":
                continue
            if k in self._CORNER_KEYS:
                v = v.clone()
                v[cross] = first[k]
                out[k] = torch.cat([v, second[k]])
            else:
                out[k] = torch.cat([v, v[cross[two]]])
        cl = torch.stack(clip, -1)
        cl[cross] = first["clip"]
        cl = torch.cat([cl, second["clip"]])
        return out, [cl[..., j] for j in range(4)]

    def _setup(self, tri, clip, Wr: int, Hr: int, keep_mask):
        """Screen-space setup of the triangles of `tri` at clip-space
        corners `clip`, all in front of the near plane or behind it:
        oriented corners, edge functions, z plane, integer bboxes."""
        w = clip[3]
        iw = 1.0 / torch.where(w.abs() > 1e-20, w, torch.full_like(w, 1e-20))
        sx = (clip[0] * iw * 0.5 + 0.5) * Wr
        sy = (0.5 - clip[1] * iw * 0.5) * Hr
        z = clip[2] * iw
        area2 = ((sx[:, 1] - sx[:, 0]) * (sy[:, 2] - sy[:, 0])
                 - (sx[:, 2] - sx[:, 0]) * (sy[:, 1] - sy[:, 0]))
        front = area2 < 0.0
        keep = (keep_mask & (front | tri["double_sided"])
                & (area2.abs() > 1e-12)
                & (w > 0).all(1) & (z.amax(1) >= 0.0) & (z.amin(1) <= 1.0))
        order = torch.where(front[:, None],
                            torch.tensor([0, 2, 1], device=self.dev),
                            torch.tensor([0, 1, 2], device=self.dev))
        sx, sy, z, iw = (a.gather(1, order) for a in (sx, sy, z, iw))
        i_, j_ = (1, 2, 0), (2, 0, 1)
        ea = torch.stack([sy[:, i_[k]] - sy[:, j_[k]] for k in range(3)], 1)
        eb = torch.stack([sx[:, j_[k]] - sx[:, i_[k]] for k in range(3)], 1)
        ec = []
        for k in range(3):
            a, b = i_[k], j_[k]
            lt = (sy[:, a] < sy[:, b]) | ((sy[:, a] == sy[:, b])
                                          & (sx[:, a] <= sx[:, b]))
            ax = torch.where(lt, sx[:, a], sx[:, b])
            ay = torch.where(lt, sy[:, a], sy[:, b])
            ec.append(-(ea[:, k] * ax + eb[:, k] * ay))
        ec = torch.stack(ec, 1)
        area = torch.where(front, -area2, area2)
        inv_area = 1.0 / torch.where(area.abs() > 1e-30, area,
                                     torch.ones_like(area))
        zp = torch.stack([(z * ea).sum(1), (z * eb).sum(1), (z * ec).sum(1)],
                         1) * inv_area[:, None]
        finite = (sx.isfinite() & sy.isfinite() & z.isfinite()).all(1)
        keep = keep & finite
        sx, sy = sx.nan_to_num(0.0), sy.nan_to_num(0.0)
        def ints(a, hi):
            return torch.clamp(a.float().clamp(-1.0, hi + 1.0).long(), 0, hi)

        x0 = ints(torch.floor(sx.amin(1)), Wr - 1)
        x1 = ints(torch.ceil(sx.amax(1)), Wr - 1)
        y0 = ints(torch.floor(sy.amin(1)), Hr - 1)
        y1 = ints(torch.ceil(sy.amax(1)), Hr - 1)
        keep = keep & (sx.amax(1) > 0) & (sx.amin(1) < Wr) \
            & (sy.amax(1) > 0) & (sy.amin(1) < Hr)
        return dict(ea=ea, eb=eb, ec=ec, zp=zp, iw=iw, order=order,
                    keep=keep, bbox=torch.stack([x0, y0, x1, y1], 1))

    def _raster(self, su, ids, Wr: int, Hr: int, zlo=None, zhi=None):
        """Nearest fragment per sample of the Wr x Hr grid among triangles
        `ids` of setup `su`; zlo < z < zhi per sample when given. Returns
        (winner (Hr, Wr) int64, -1 = miss; z (Hr, Wr) f32, 1 on a miss)."""
        init = (torch.tensor(1.0).view(torch.int32).long() << 32) | 0x7FFFFFFF
        key = torch.full((Hr * Wr,), int(init), dtype=torch.int64,
                         device=self.dev)
        bb = su["bbox"][ids]
        bw = bb[:, 2] - bb[:, 0] + 1
        bh = bb[:, 3] - bb[:, 1] + 1
        pw = 2 ** torch.ceil(torch.log2(bw.float())).long()
        ph = 2 ** torch.ceil(torch.log2(bh.float())).long()
        groups = pw * 65536 + ph
        for g in torch.unique(groups).tolist():
            gw, gh = g // 65536, g % 65536
            sel = ids[groups == g]
            n_chunk = max(1, _CHUNK // (gw * gh))
            oy, ox = torch.meshgrid(torch.arange(gh, device=self.dev),
                                    torch.arange(gw, device=self.dev),
                                    indexing="ij")
            ox, oy = ox.reshape(1, -1), oy.reshape(1, -1)
            for c0 in range(0, sel.shape[0], n_chunk):
                tid = sel[c0:c0 + n_chunk]
                b = su["bbox"][tid]
                xi = b[:, 0:1] + ox
                yi = b[:, 1:2] + oy
                ok = (xi <= b[:, 2:3]) & (yi <= b[:, 3:4])
                px = xi.to(self.dt) + 0.5
                py = yi.to(self.dt) + 0.5
                cover = ok
                for k in range(3):
                    a = su["ea"][tid, k:k + 1]
                    bk = su["eb"][tid, k:k + 1]
                    e = a * px + (bk * py + su["ec"][tid, k:k + 1])
                    tl = (a > 0) | ((a == 0) & (bk > 0))
                    cover = cover & torch.where(tl, e >= 0, e > 0)
                zp = su["zp"][tid]
                z = (zp[:, 0:1] * px + (zp[:, 1:2] * py + zp[:, 2:3])).float()
                take = cover & (z >= 0.0) & (z < 1.0)
                pix = yi * Wr + xi
                if zlo is not None:
                    pz = pix.clamp(0, Hr * Wr - 1)
                    take = take & (z > zlo.reshape(-1)[pz]) \
                        & (z < zhi.reshape(-1)[pz])
                if not bool(take.any()):
                    continue
                k64 = (z.view(torch.int32).long() << 32) | tid[:, None]
                key.scatter_reduce_(0, pix[take], k64[take], reduce="amin")
        win = torch.where(key == init, torch.full_like(key, -1),
                          key & 0xFFFFFFFF)
        zb = (key >> 32).to(torch.int32).view(torch.float32)
        return win.reshape(Hr, Wr), zb.reshape(Hr, Wr)

    # ---- resolve + shade --------------------------------------------------

    def _resolve(self, su, tri, tid, px, py, analytic: bool):
        """Perspective-correct attributes of triangles tid (-1 = miss) of
        `tri`, set up as `su`, at
        raster points px, py -> dict of (P,) planes, zero on a miss."""
        miss = tid < 0
        t = tid.clamp(min=0)
        ea, eb, ec = su["ea"][t], su["eb"][t], su["ec"][t]
        iw = su["iw"][t]
        order = su["order"][t]
        e = ea * px[:, None] + (eb * py[:, None] + ec)
        pb = e * iw
        den = pb.sum(1)
        inv_den = 1.0 / torch.where(den.abs() > 1e-30, den,
                                    torch.ones_like(den))
        pn = pb * inv_den[:, None]

        def corners(a):                     # (T, 3, k) -> oriented (P, 3, k)
            return a[t].gather(1, order[:, :, None].expand(-1, -1,
                                                           a.shape[2]))

        uv, nrm, tan = (corners(tri["uv"]), corners(tri["nrm"]),
                        corners(tri["tan"]))
        out = {"uv": (pn[:, :, None] * uv).sum(1).T,
               "n": (pn[:, :, None] * nrm).sum(1).T,
               "t": (pn[:, :, None] * tan).sum(1).T,
               "tw": tri["tan_w"][t], "mat": tri["mat"][t]}
        if analytic:
            dDx = (ea * iw).sum(1)
            dDy = (eb * iw).sum(1)
            dpx = inv_den[:, None] * (ea * iw - pn * dDx[:, None])
            dpy = inv_den[:, None] * (eb * iw - pn * dDy[:, None])
            out["duv"] = ((dpx * uv[:, :, 0]).sum(1), (dpx * uv[:, :, 1]).sum(1),
                          (dpy * uv[:, :, 0]).sum(1), (dpy * uv[:, :, 1]).sum(1))
        zero = torch.zeros((), dtype=self.dt, device=self.dev)
        for k in ("uv", "n", "t", "tw"):
            out[k] = torch.where(miss, zero, out[k])
        if analytic:
            out["duv"] = tuple(torch.where(miss, zero, d) for d in out["duv"])
        out["valid"] = ~miss
        return out

    def _tex(self, slot: str, mat, u, v, duv):
        """(4, P) taps of the slot's texture, 1.0 where unbound."""
        tid = self.m_tex[slot][mat]
        out = torch.ones((4, u.shape[0]), dtype=self.dt, device=self.dev)
        for k in torch.unique(tid).tolist():
            if k < 0:
                continue
            idx = (tid == k).nonzero()[:, 0]
            d = None if duv is None else tuple(x[idx] for x in duv)
            out[:, idx] = tex_mod.sample(self.textures[k], u[idx], v[idx], d,
                                         self.use_mips)
        return out

    def _shade(self, r, ndc_x, ndc_y, depth, cam, transparent=False):
        """Shade resolved planes r at NDC (ndc_x, ndc_y) and NDC depth ->
        (rgb (3, P), alpha (P,), sky (3, P))."""
        ivp = [[float(x) for x in row] for row in cam["inv_view_proj"]]
        wp = [ndc_x * ivp[j][0] + ndc_y * ivp[j][1] + depth * ivp[j][2]
              + ivp[j][3] for j in range(4)]
        iw = 1.0 / torch.where(wp[3].abs() > _EPS, wp[3],
                               torch.full_like(wp[3], _EPS))
        world = torch.stack([wp[0] * iw, wp[1] * iw, wp[2] * iw])
        cpos = torch.tensor([float(x) for x in cam["position"]],
                            dtype=self.dt, device=self.dev)[:, None]
        v = _norm3(cpos - world)
        mat = r["mat"]
        u_, v_ = r["uv"][0], r["uv"][1]
        duv = r.get("duv")
        if duv is None and self.use_mips:
            Wd = self.W
            up, vpl = u_.reshape(-1, Wd), v_.reshape(-1, Wd)
            duv = (_screen_gradient(up, False).reshape(-1),
                   _screen_gradient(vpl, False).reshape(-1),
                   _screen_gradient(up, True).reshape(-1),
                   _screen_gradient(vpl, True).reshape(-1))
        tex = {s: self._tex(s, mat, u_, v_, duv) for s in SLOTS}
        base = self.m_base[mat].T * tex["base"]
        metallic = torch.clamp(self.m_metal[mat] * tex["mr"][2], 0.0, 1.0)
        rough = torch.clamp(self.m_rough[mat] * tex["mr"][1], 0.04, 1.0)
        a_r = rough * rough
        occ = 1.0 + self.m_occ[mat] * (tex["occlusion"][0] - 1.0)
        emis = self.m_emis[mat].T * tex["emissive"][:3]
        n = _norm3(r["n"])
        has_n = self.m_tex["normal"][mat] >= 0
        if bool(has_n.any()):
            tg = r["t"]
            t_w = _norm3(tg - n * _dot3(n, tg))
            b_w = _cross3(n, t_w) * r["tw"]
            ns = self.m_nscale[mat]
            tn = tex["normal"]
            tsx = (tn[0] * 2.0 - 1.0) * ns
            tsy = (tn[1] * 2.0 - 1.0) * ns
            tsz = tn[2] * 2.0 - 1.0
            n = torch.where(has_n, _norm3(tsx * t_w + tsy * b_w + tsz * n), n)
        n = torch.where(_dot3(n, v) < 0.0, -n, n)
        f0 = 0.04 * (1.0 - metallic) + base[:3] * metallic
        c_diff = base[:3] * (1.0 - metallic)
        n_dot_v = torch.clamp(_dot3(n, v), min=_EPS)

        direct = torch.zeros_like(c_diff)
        for L in self.lights:
            if L.kind == "directional":
                tl = -torch.tensor(np.asarray(L.direction, np.float32),
                                   dtype=self.dt, device=self.dev)[:, None] \
                    * torch.ones_like(world)
            else:
                tl = torch.tensor(np.asarray(L.position, np.float32),
                                  dtype=self.dt, device=self.dev)[:, None] \
                    - world
            dist = torch.sqrt(_dot3(tl, tl))
            ldir = tl * (1.0 / torch.clamp(dist, min=_EPS))
            n_dot_l = torch.clamp(_dot3(n, ldir), min=0.0)
            rad = n_dot_l
            if L.kind != "directional":
                rad = rad * (1.0 / torch.clamp(dist * dist, min=_EPS))
                if L.range > 0.0:
                    ratio = dist / max(float(L.range), _EPS)
                    rad = rad * torch.clamp(1.0 - ratio ** 4, 0.0, 1.0) ** 2
            rad = rad * float(L.intensity)
            h = _norm3(ldir + v)
            n_dot_h = torch.clamp(_dot3(n, h), min=0.0)
            v_dot_h = torch.clamp(_dot3(v, h), min=0.0)
            fres = f0 + (1.0 - f0) * torch.pow(
                torch.clamp(1.0 - v_dot_h, 0.0, 1.0), 5.0)
            a2 = a_r * a_r
            fd = n_dot_h * n_dot_h * (a2 - 1.0) + 1.0
            d_ggx = a2 / torch.clamp(math.pi * fd * fd, min=_EPS)
            gv = n_dot_l * torch.sqrt(torch.clamp(
                n_dot_v * n_dot_v * (1 - a2) + a2, min=_EPS))
            gl = n_dot_v * torch.sqrt(torch.clamp(
                n_dot_l * n_dot_l * (1 - a2) + a2, min=_EPS))
            vis = 0.5 / torch.clamp(gv + gl, min=_EPS)
            lobe = c_diff * (1.0 / math.pi) * (1.0 - fres) + d_ggx * vis * fres
            col = torch.tensor(np.asarray(L.color, np.float32), dtype=self.dt,
                               device=self.dev)[:, None]
            direct = direct + (col * rad) * lobe

        refl = _norm3(2.0 * n_dot_v * n - v)
        irr = env_mod.sample_cube(self.irr, n)[:3]
        pref = env_mod.sample_prefiltered(self.pref, refl, rough)[:3]
        rx = rough * -1.0 + 1.0
        a004 = torch.minimum(rx * rx, torch.exp2(-9.28 * n_dot_v)) * rx \
            + (rough * -0.0275 + 0.0425)
        lut_a = a004 * -1.04 + (rough * -0.572 + 1.04)
        lut_b = a004 * 1.04 + (rough * 0.022 + -0.04)
        ambient = (irr * c_diff + pref * (f0 * lut_a + lut_b)) * occ
        color = direct + ambient + emis
        alpha = torch.where(self.m_blend[mat], base[3],
                            torch.ones_like(base[3]))
        color, alpha = self._surface(color, alpha, base, mat, world, cpos,
                                     transparent)
        sky = None if transparent else env_mod.sample_cube(self.sky, -v)[:3]
        return color, alpha, sky

    def _surface(self, color, alpha, base, mat, world, cpos, transparent):
        """(colour, alpha) of the material kinds other than "pbr", from
        the pbr ones, the base colour (4, P), the world positions (3, P)
        and the camera's (3, 1); this class shades "pbr" alone."""
        return color, alpha

    def _hud(self, hdr, vp, cam, ndc_x, ndc_y, xx, yy):
        """The HUD pass over the (4, H, W) HDR image; this class draws
        none."""
        return hdr

    # ---- the frame ----------------------------------------------------------

    def render(self, view: np.ndarray, proj: np.ndarray) -> torch.Tensor:
        W, H, dt = self.W, self.H, self.dt
        view = np.asarray(view, np.float32)
        proj = np.asarray(proj, np.float32)
        vp = (proj.astype(np.float64) @ view.astype(np.float64)).astype(
            np.float32)
        cam = dict(inv_view_proj=np.linalg.inv(vp.astype(np.float64)).astype(
            np.float32),
            position=np.linalg.inv(view.astype(np.float64))[:3, 3].astype(
                np.float32))
        s = 2 if self.msaa else 1
        Wr, Hr = W * s, H * s
        tri, clip = self._near_clip(self.tri, self._clip(self.tri["pos"], vp))
        opaque = ~tri["transparent"]
        su = self._setup(tri, clip, Wr, Hr, torch.ones_like(opaque))
        ids = (su["keep"] & opaque).nonzero()[:, 0]
        win, zb = self._raster(su, ids, Wr, Hr)
        yy, xx = torch.meshgrid(torch.arange(H, device=self.dev),
                                torch.arange(W, device=self.dev),
                                indexing="ij")
        xx, yy = xx.reshape(-1).to(dt), yy.reshape(-1).to(dt)
        ndc_x = (xx + 0.5) / W * 2.0 - 1.0
        ndc_y = 1.0 - (yy + 0.5) / H * 2.0
        if self.msaa:
            samp = [win[i::2, j::2] for i, j in ((0, 0), (0, 1), (1, 0), (1, 1))]
            depth = torch.minimum(torch.minimum(zb[0::2, 0::2], zb[0::2, 1::2]),
                                  torch.minimum(zb[1::2, 0::2], zb[1::2, 1::2]))
            rep = samp[0].reshape(-1)
            r = self._resolve(su, tri, rep, xx * 2 + 0.5, yy * 2 + 0.5, True)
        else:
            depth = zb
            rep = win.reshape(-1)
            r = self._resolve(su, tri, rep, xx + 0.5, yy + 0.5, False)
        depth_d = depth.reshape(-1).to(dt)
        color, _a, sky = self._shade(r, ndc_x, ndc_y, depth_d, cam)
        valid = r["valid"]
        hdr = torch.cat([torch.where(valid, color, sky),
                         valid.to(dt)[None]]).reshape(4, H, W)
        if self.msaa:
            hdr = self._edge_blend(hdr, samp)

        trans = (su["keep"] & tri["transparent"]).nonzero()[:, 0]
        if trans.numel():
            hdr = self._overlay(hdr, depth.float(), tri, clip, trans, cam,
                                ndc_x, ndc_y, xx, yy)
        hdr = self._hud(hdr, vp, cam, ndc_x, ndc_y, xx, yy)
        rgb, alpha = hdr[:3], hdr[3]
        st = self.scene.settings
        if st.get("bloom"):
            rgb = post.bloom(rgb)
        if st.get("dof"):
            dof = (float(st["dof_focus"]), float(st["dof_aperture"]))
            if self._coc_bound(view, proj, vp, dof) > 1.0:
                rgb = post.depth_of_field(rgb, depth.to(dt), dof, proj)
        return post.display(rgb, alpha, st.get("tonemap",
                                                "khronos_pbr_neutral"))

    def _coc_bound(self, view, proj, vp, dof) -> float:
        """The renderer's bound on the frame's CoC in pixels: its depth
        range runs from the nearest corner of the meshes whose world
        AABB meets the view frustum (floored at the near plane) to the
        far plane. Depth of field is the identity at a bound of 1 px or
        less, and is then skipped."""
        m = vp.astype(np.float64)
        planes = np.stack([m[3] + m[0], m[3] - m[0], m[3] + m[1], m[3] - m[1],
                           m[2], m[3] - m[2]])
        nrm = np.linalg.norm(planes[:, :3], axis=1, keepdims=True)
        planes = (planes / np.where(nrm == 0, 1.0, nrm)).astype(np.float32)
        mins = np.stack([a[0] for a in self.aabbs]).astype(np.float32)
        maxs = np.stack([a[1] for a in self.aabbs]).astype(np.float32)
        vis = np.ones(len(mins), bool)
        for p in planes:
            pv = np.where(p[None, :3] >= 0.0, maxs, mins)
            vis &= (pv @ p[:3] + p[3]) >= 0.0
        P = np.asarray(proj, np.float64)
        near_d = P[2, 3] / (P[2, 2] if abs(P[2, 2]) > 1e-8 else 1e-8)
        far_d = P[2, 3] / (1.0 + P[2, 2])
        dmin = min(near_d, far_d)
        if vis.any():
            mn, mx = mins[vis].astype(np.float64), maxs[vis].astype(np.float64)
            corners = np.stack([np.stack([np.where(b & 1, mx[:, 0], mn[:, 0]),
                                          np.where(b & 2, mx[:, 1], mn[:, 1]),
                                          np.where(b & 4, mx[:, 2], mn[:, 2])],
                                         -1) for b in range(8)], 1)
            V = np.asarray(view, np.float64)
            vz = -(corners.reshape(-1, 3) @ V[2, :3] + V[2, 3])
            dmin = max(float(vz.min()), dmin)
        dmax = max(far_d, dmin)
        dmin = max(dmin, 1e-4)
        return max(post.coc_at(d, dof, proj, self.H) for d in (dmin, dmax))

    def _edge_blend(self, hdr, samp):
        rep = samp[0]
        acc = hdr.clone()
        for s_idx, (i, j) in enumerate(((0, 1), (1, 0), (1, 1)), start=1):
            ts = samp[s_idx]
            dy = -1 if i == 0 else 1
            dx = -1 if j == 0 else 1
            chosen = hdr
            found = ts == rep
            for oy, ox in ((0, dx), (dy, 0), (dy, dx)):
                ntid = torch.roll(rep, (-oy, -ox), dims=(0, 1))
                m = (~found) & (ntid == ts)
                chosen = torch.where(m, torch.roll(hdr, (-oy, -ox),
                                                   dims=(1, 2)), chosen)
                found = found | m
            acc = acc + chosen
        return acc * 0.25

    def _overlay(self, hdr, depth, tri, clip, trans, cam, ndc_x, ndc_y, xx,
                 yy):
        """Peel the alpha-blended layers over the opaque depth at display
        resolution and composite them back to front."""
        W, H = self.W, self.H
        su = self._setup(tri, clip, W, H, tri["transparent"])
        layers = []
        zlo = torch.full((H, W), -1.0, device=self.dev)
        for _ in range(self.max_layers):
            win, z = self._raster(su, trans, W, H, zlo=zlo, zhi=depth)
            if not bool((win >= 0).any()):
                break
            r = self._resolve(su, tri, win.reshape(-1), xx + 0.5, yy + 0.5,
                              True)
            color, alpha, _ = self._shade(r, ndc_x, ndc_y,
                                          z.reshape(-1).to(self.dt), cam,
                                          transparent=True)
            layers.append((color, torch.where(r["valid"], alpha,
                                              torch.zeros_like(alpha))))
            zlo = torch.where(win >= 0, z, zlo)
        out = hdr[:3].reshape(3, -1)
        for color, a in reversed(layers):
            out = color * a + out * (1.0 - a)
        return torch.cat([out.reshape(3, H, W), hdr[3:]])
