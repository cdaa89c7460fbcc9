"""AwsmRendererTorch — the port's renderer facade.

Port of awsm_renderer_tpu/renderer.py (AwsmRendererTpu) for the slice
ported so far: glTF PBR / unlit materials with every texture slot and
KHR_texture_transform, the material extensions (clearcoat, sheen,
iridescence, anisotropy, specular, transmission, volume), the debug
views, the transparent overlay (BLEND / MASK / transmission meshes in a
K-layer depth peel, the editor grid kind) and HUD meshes, under a solid
or image environment, at most 8 punctual lights, MSAA-4x / supersample /
SMAA / temporal (TAA) anti-aliasing, bloom and depth of field. The
temporal frame keeps its history across frames (self._temporal); any
content flush or resize resets it. The key-based stores, the
per-frame dirty flush to device tensors and the host-side cull, pass
bucketing and per-pass specialization (overlay crop, compacted overlay
pool, tile caps, proven layer bound, DoF ring set) mirror the
reference; the frame runs eagerly on `device` (passes/frame.py).

Content or configuration outside the slice raises NotImplementedError
naming its ROADMAP.md milestone instead of rendering it wrongly.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .config import RendererConfig
from .core.animation import Animations
from .core.camera import CameraState, get_halton_jitter
from .core.environment import Environment
from .core.frustum import Frustum
from .core.lights import Lights
from .core.materials import MI_DEBUG_MASK, Materials
from .core.meshes import (
    MESH_FLAG_HIDDEN, MESH_FLAG_HUD, MESH_FLAG_TRANSPARENT, Meshes,
    MeshGeometry,
)
from .core.skins import Skins
from .core.textures import TEXEL_COLS, Textures, f32_to_bf16_bits
from .core.transforms import Transform, Transforms
from .errors import ConfigError
from .ops.shade import OPAQUE_TILE_ROWS
from .ops.raster import TILE_H, TILE_W
from .ops.temporal import reset_history
from .passes.frame import _pad_to, render_frame, render_frame_temporal

MAX_DENSE_LIGHTS = 8
# component-major corner pools the static vertex stage reads: name -> comps
_CORNERS = (("c_pos", 3), ("c_norm", 3), ("c_tang", 4), ("c_uv0", 2),
            ("c_uv1", 2), ("c_color", 4))


def _unsupported(what: str, milestone: str):
    return NotImplementedError(
        f"{what} is not ported to the PyTorch renderer yet "
        f"(ROADMAP.md queue 1, {milestone})")


def _bf16_tensor(u16: np.ndarray, device) -> torch.Tensor:
    """uint16 bf16 bit patterns -> torch.bfloat16 tensor on `device`."""
    t = torch.from_numpy(np.array(u16, dtype=np.uint16).view(np.int16))
    return t.view(torch.bfloat16).to(device)


class AwsmRendererTorch:
    def __init__(self, config: Optional[RendererConfig] = None,
                 device="cuda"):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device='cuda' but no CUDA device is visible")
        self.device = device
        self.config = config or RendererConfig()
        self.transforms = Transforms()
        self.meshes = Meshes()
        self.materials = Materials()
        self.lights = Lights()
        self.textures = Textures()
        self.skins = Skins()
        self.animations = Animations()
        self.camera = CameraState()
        self.environment = Environment()
        self._device: Dict[str, object] = {}
        self._env_rows64 = None        # image-env quad rows appended to texels
        self._prep = None              # (scene signature, _prepare())
        self._last_tri_id = None       # device plane kept for picking
        self._mesh_row_to_key: Dict[int, int] = {}
        self._tri_mesh_device_order = None
        self._mesh_flush_gen = 0       # bumps on every mesh-pool flush
        self._ov_idx_cache = None      # (overlay mask, flush gen, tensor)
        self._mask_cache: Dict[str, tuple] = {}   # name -> (mask, tensor)
        self._last_debug_mode = "none"  # pick() replays the last frame's
        self.last_bins = None          # raster bins of the last frame
        self._content_epoch = 0        # non-camera store flush counter
        self._temporal = None          # TAA state: hist/age/prev_vp/epoch

    # ---- content helpers (host stores, as the reference) -----------------

    def add_mesh(self, geometry: MeshGeometry, material_key: int,
                 transform: Optional[Transform] = None,
                 parent: Optional[int] = None,
                 transform_key: Optional[int] = None, *, hud: bool = False,
                 hidden: bool = False, skin_key: Optional[int] = None,
                 initial_morph_weights=None) -> int:
        """Insert geometry + mesh record; routes transparency from the
        material (reference: renderer.py add_mesh)."""
        if transform_key is None:
            transform_key = self.transforms.insert(transform, parent)
            self.transforms.update_world()
        mat = self.materials.get(material_key)
        skin_rows = (self.skins.joint_rows(skin_key)
                     if skin_key is not None else None)
        key = self.meshes.insert_geometry(
            geometry,
            self.transforms.row_of(transform_key),
            self.materials.row_of(material_key),
            transform_key,
            material_key,
            double_sided=getattr(mat, "double_sided", False),
            transparent=self.materials.is_transparency_pass(material_key),
            hud=hud,
            hidden=hidden,
            skin_key=skin_key,
            skin_joint_rows=skin_rows,
            initial_morph_weights=initial_morph_weights,
        )
        self.meshes.update_world(self.transforms, {transform_key})
        return key

    def add_instanced_mesh(self, geometry: MeshGeometry, material_key: int,
                           transforms) -> list:
        """Insert one geometry resource under many transforms (host store
        only: rendering instanced groups is milestone M2b)."""
        rk = self.meshes.insert_resource(geometry)
        mat = self.materials.get(material_key)
        tks = [self.transforms.insert(tr) for tr in transforms]
        self.transforms.update_world()
        keys = self.meshes.insert_instanced(
            rk, [(self.transforms.row_of(t), t) for t in tks],
            self.materials.row_of(material_key), material_key,
            double_sided=getattr(mat, "double_sided", False),
            transparent=self.materials.is_transparency_pass(material_key))
        self.meshes.update_world(self.transforms)
        return keys

    def remove_all(self) -> None:
        self.__init__(self.config, self.device)

    def update_all(self, dt: float, view=None, projection=None) -> None:
        self.animations.update(dt, self.transforms, self.meshes)
        changed = self.transforms.update_world()
        if changed:
            self.meshes.update_world(self.transforms, changed)
            self.skins.update_transforms(self.transforms, changed)
        if view is not None and projection is not None:
            self.camera.update(view, projection)

    # ---- device flush (reference: renderer.py _flush) --------------------

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a), device=self.device)

    def _upload(self, a) -> torch.Tensor:
        """Host array -> device tensor without waiting for the device: on
        a card, staged through pinned memory and copied on the current
        stream (a copy from pageable memory waits for the device)."""
        if self.device.type != "cuda":
            return self._tensor(a)
        return torch.from_numpy(np.ascontiguousarray(a)).pin_memory().to(
            self.device, non_blocking=True)

    def _device_mask(self, name: str, arr: np.ndarray) -> torch.Tensor:
        """Upload a bucket mask only when its content changed (reference:
        renderer.py _device_mask). _prepare reruns on every camera move,
        and the frustum cull changes the masks as the camera moves."""
        cached = self._mask_cache.get(name)
        if cached is not None and np.array_equal(cached[0], arr):
            return cached[1]
        dev = self._upload(arr)
        self._mask_cache[name] = (arr.copy(), dev)
        return dev

    def _flush(self, jitter_px=None, prev_view_proj=None) -> Dict[str, object]:
        """Upload the dirty host stores. jitter_px / prev_view_proj (the
        temporal frame's) repack the camera with the Halton jitter and
        the previous frame's unjittered view-projection."""
        d = self._device
        self.skins.flush_pending(self.transforms)
        # content epoch: bumped whenever a non-camera store reaches the
        # device; the temporal history is valid only while it holds.
        # Skinning is refused (M2b), so nothing uploads the skins' joint
        # matrices: their flag only feeds the epoch, and is consumed here
        if (self.transforms.gpu_dirty or self.meshes.gpu_dirty
                or self.materials.gpu_dirty or self.lights.gpu_dirty
                or self.textures.gpu_dirty or self.environment.gpu_dirty
                or self.skins.gpu_dirty):
            self._content_epoch += 1
        self.skins.gpu_dirty = False
        t = self.transforms
        if t.gpu_dirty:
            d["world"] = self._tensor(t.world)
            d["normal_mat"] = self._tensor(t.normal)
            t.gpu_dirty = False

        m = self.meshes
        if m.gpu_dirty:
            def _slice_cm(name, c, rows):
                """(cnt,) host rows -> component-major (3c, cnt) block."""
                arr = getattr(m, name)
                return (arr.reshape(-1, 3, c)[rows].transpose(1, 2, 0)
                        .reshape(3 * c, rows.size))

            plan = m.device_updates()
            if plan[0] == "full":
                _, idx, dead = plan
                for name, c in _CORNERS:
                    d[name] = self._tensor(_slice_cm(name, c, idx))
                tri_mesh_c = m.tri_mesh[idx].copy()
                tri_mesh_c[dead] = -1
                self._tri_mesh_device_order = tri_mesh_c
                d["tri_mesh"] = self._tensor(tri_mesh_c)
            else:
                # dirty-range updates in place (buffer/helpers.rs semantics)
                for s, rows, dead in plan[1]:
                    if rows is None:       # tombstone: mask the stale rows
                        self._tri_mesh_device_order[s:s + dead] = -1
                        d["tri_mesh"][s:s + dead] = -1
                        continue
                    for name, c in _CORNERS:
                        d[name][:, s:s + rows.size] = self._tensor(
                            _slice_cm(name, c, rows))
                    tri_mesh_c = m.tri_mesh[rows].copy()
                    tri_mesh_c[dead] = -1
                    self._tri_mesh_device_order[s:s + rows.size] = tri_mesh_c
                    d["tri_mesh"][s:s + rows.size] = self._tensor(tri_mesh_c)
            d["mesh_info"] = self._tensor(m.mesh_info)
            m.gpu_dirty = False
            self._mesh_flush_gen += 1
            self._mesh_row_to_key = {row: key
                                     for key, row in m._mesh_alloc.items()}

        mats = self.materials
        if mats.gpu_dirty:
            d["mat_float"] = self._tensor(mats.float_data)
            d["mat_tex"] = self._tensor(mats.tex_slots)
            d["mat_flags"] = self._tensor(mats.flags)
            mats.gpu_dirty = False

        if self.lights.gpu_dirty or "lights" not in d:
            cap = max(8, 1 << (max(self.lights.count, 1) - 1).bit_length())
            packed = self.lights.packed(cap)
            d["lights"] = self._tensor(packed)
            d["lights_host"] = packed        # uniforms: read as Python floats
            d["n_lights"] = self.lights.count
            self.lights.gpu_dirty = False

        tx = self.textures
        e = self.environment
        if tx.gpu_dirty or e.gpu_dirty or "texels" not in d:
            if e.gpu_dirty or "skybox" not in d:
                from .ops.cubemap import pack_cubemap

                # host copies: a solid env shades from their constants, an
                # image env only needs their row counts (its taps read the
                # same rows appended to the texel pool below)
                d["skybox"] = pack_cubemap(e.skybox)
                d["irradiance"] = pack_cubemap(e.irradiance)
                d["prefiltered"] = pack_cubemap(e.prefiltered)
                if e.is_solid:
                    self._env_rows64 = None
                else:
                    env16 = np.concatenate(
                        [d["skybox"], d["irradiance"],
                         d["prefiltered"].reshape(-1, 16)], axis=0)
                    blk = np.zeros((env16.shape[0], TEXEL_COLS), np.uint16)
                    blk[:, :16] = f32_to_bf16_bits(env16)
                    self._env_rows64 = blk
                e.gpu_dirty = False
            if tx.gpu_dirty:
                d["tex_desc"] = self._tensor(tx.descriptors)
                d["tex_transforms"] = self._tensor(tx.tex_transforms)
                tx.gpu_dirty = False
            if self._env_rows64 is None:
                d.pop("env_pool_base", None)
                d["texels"] = _bf16_tensor(tx.texels_packed, self.device)
            else:
                d["env_pool_base"] = int(tx.texels_packed.shape[0])
                d["texels"] = _bf16_tensor(np.concatenate(
                    [tx.texels_packed, self._env_rows64], axis=0),
                    self.device)

        dof = np.array([self.camera.dof.focus_distance,
                        self.camera.dof.aperture], np.float32)
        want_nj = jitter_px is not None
        if (self.camera.gpu_dirty or "camera" not in d or want_nj
                or ("view_proj_nj" in d["camera"]) != want_nj
                or not np.array_equal(d["camera"]["dof"], dof)):
            # the camera is a uniform: kept on the host, read as floats.
            # The DoF parameters are plain fields that set no dirty flag,
            # so an edit to them repacks too (the reference's flush keeps
            # the old ones until the camera moves). A temporal frame
            # repacks every frame (its jitter and previous matrix change),
            # and leaving temporal mode repacks without them
            cam = self.camera.packed(
                viewport=(self.config.width, self.config.height),
                jitter_px=jitter_px)
            if prev_view_proj is not None:
                cam["prev_view_proj"] = prev_view_proj
            d["camera"] = cam
            self.camera.gpu_dirty = False
        return d

    # ---- pass bucketing (reference: renderer.py _mesh_masks) -------------

    def _mesh_masks(self) -> Dict[str, np.ndarray]:
        """Frustum cull + pass bucketing over the cached world bounds."""
        cap = self.meshes.mesh_capacity
        opaque = np.zeros(cap, dtype=bool)
        transparent = np.zeros(cap, dtype=bool)
        hud = np.zeros(cap, dtype=bool)
        needs_clip = False
        mins, maxs, keys = self.meshes.world_bounds()
        if keys:
            rows = self.meshes.world_rows()
            info = self.meshes.mesh_info
            frustum = Frustum(self.camera.view_projection)
            visible = frustum.intersects_aabbs(mins, maxs)
            in_front = frustum.fully_in_front_of_near(mins, maxs)
            needs_clip = bool((~in_front).any())
            finite = (np.isfinite(mins).all(axis=1)
                      & np.isfinite(maxs).all(axis=1))
            mat_ok = ((info[rows, 1] >= 0)
                      & (info[rows, 1] < max(self.materials.capacity, 1)))
            tf_ok = ((info[rows, 0] >= 0)
                     & (info[rows, 0] < max(self.transforms.capacity, 1)))
            ok = finite & mat_ok & tf_ok
            if not ok.all():
                import warnings

                for i in np.nonzero(~ok)[0]:
                    warnings.warn(f"skipping mesh {keys[i]}: bad bounds or "
                                  f"store row (frame continues without it)",
                                  RuntimeWarning, stacklevel=3)
            flags = info[rows, 2]
            hidden = (flags & MESH_FLAG_HIDDEN) != 0
            hud_f = (flags & MESH_FLAG_HUD) != 0
            transp = (flags & MESH_FLAG_TRANSPARENT) != 0
            live = ok & ~hidden
            hud[rows[live & hud_f]] = True
            vis_live = live & ~hud_f & visible
            transparent[rows[vis_live & transp]] = True
            opaque[rows[vis_live & ~transp]] = True
        return {"opaque": opaque, "transparent": transparent, "hud": hud,
                "needs_clip": needs_clip}

    def _bucket_mat_rows(self, mesh_mask: np.ndarray) -> np.ndarray:
        info = self.meshes.mesh_info
        rows = np.unique(info[mesh_mask[: info.shape[0]], 1])
        return rows[(rows >= 0) & (rows < max(self.materials.capacity, 1))]

    def _ext_mask(self, mat_rows: np.ndarray) -> tuple:
        """Which material extensions the bucket's materials use."""
        from .core import materials as M

        if mat_rows.size == 0:
            return (False,) * 6
        f = self.materials.float_data[mat_rows]
        slots = self.materials.tex_slots[mat_rows][:, :, 0]
        return (
            bool((f[:, M.MF_CLEARCOAT] > 0).any()
                 or (slots[:, M.TS_CLEARCOAT] >= 0).any()),
            bool((f[:, M.MF_SHEEN_COLOR:M.MF_SHEEN_COLOR + 3] > 0).any()),
            bool((f[:, M.MF_IRIDESCENCE] > 0).any()),
            bool((np.abs(f[:, M.MF_ANISOTROPY_STRENGTH]) > 0).any()),
            bool((f[:, M.MF_TRANSMISSION] > 0).any()
                 or (slots[:, M.TS_TRANSMISSION] >= 0).any()),
            bool((f[:, M.MF_THICKNESS] > 0).any()),
        )

    def _slot_mask(self, mat_rows: np.ndarray) -> tuple:
        """Which texture slots the bucket's materials bind."""
        slots = self.materials.tex_slots[:, :, 0]
        if mat_rows.size == 0:
            return (False,) * slots.shape[1]
        return tuple(bool(b) for b in (slots[mat_rows] >= 0).any(axis=0))

    def _check_config(self, cfg: RendererConfig) -> None:
        aa = cfg.anti_aliasing
        if aa.msaa and aa.supersample:
            raise ConfigError("pick one AA mode: AntiAliasing(msaa=True) "
                              "and supersample=True are exclusive")
        if cfg.light_tiles:
            raise _unsupported("tiled light lists", "M12 passes and hooks")

    def _overlay_tri_idx(self, masks):
        """Compacted overlay triangle ids: pool indices of every triangle
        of a transparent/HUD mesh, power-of-2 padded with -1 (at least
        128). None when nothing is live, and the frame then skips the
        overlay: it runs only over this pool. Cached by mask content and mesh
        flush (the isin scan over the pool costs milliseconds). Instanced
        groups, which the reference excludes here, are refused by
        _prepare."""
        mask = masks["transparent"] | masks["hud"]
        tm = self._tri_mesh_device_order
        if tm is None or not mask.any():
            return None
        cached = self._ov_idx_cache
        if (cached is not None and cached[1] == self._mesh_flush_gen
                and np.array_equal(cached[0], mask)):
            return cached[2]
        sel = np.where(np.isin(tm, np.where(mask)[0]))[0].astype(np.int32)
        if sel.size == 0:
            return None
        cap = max(128, 1 << (int(sel.size) - 1).bit_length())
        out = np.full(cap, -1, np.int32)
        out[: sel.size] = sel
        dev = self._upload(out)
        self._ov_idx_cache = (mask.copy(), self._mesh_flush_gen, dev)
        return dev

    def _projected_corners(self, masks, bucket_mask):
        """World AABB corners of the bucket's visible meshes projected
        through the camera -> (selected rows, keys, clip (8N, 3), w
        (8N,)), or None when the bucket is empty."""
        mins, maxs, keys = self.meshes.world_bounds()
        if not keys:
            return None
        sel = np.nonzero(bucket_mask[self.meshes.world_rows()])[0]
        if sel.size == 0:
            return None
        mn, mx = mins[sel], maxs[sel]
        corners = np.stack([
            np.stack([np.where(b & 1, mx[:, 0], mn[:, 0]),
                      np.where(b & 2, mx[:, 1], mn[:, 1]),
                      np.where(b & 4, mx[:, 2], mn[:, 2])], axis=-1)
            for b in range(8)], axis=1)                      # (N, 8, 3)
        vp = np.asarray(self.camera.view_projection, np.float32)
        h = corners.reshape(-1, 3)
        return sel, keys, h @ vp[:3, :3].T + vp[:3, 3], h @ vp[3, :3] + vp[3, 3]

    def _overlay_crop(self, masks):
        """Screen row band the transparent/HUD geometry covers: (y0, band
        height), or None = the whole frame. The projected AABB rows are
        quantized to 32-row multiples with a power-of-2 height; an AABB
        touching the near plane (unbounded screen extent) disables it."""
        rh1 = ((self.config.height + 7) // 8) * 8
        proj = self._projected_corners(masks, masks["transparent"]
                                       | masks["hud"])
        if proj is None:
            return None
        _sel, _keys, clip, w = proj
        if (w <= 1e-6).any():
            return None
        sy = (0.5 - 0.5 * clip[:, 1] / w) * rh1
        y0 = int(np.clip(np.floor(sy.min()), 0, rh1))
        y1 = int(np.clip(np.ceil(sy.max()), 0, rh1))
        y0q = (y0 // 32) * 32
        y1q = -(-y1 // 32) * 32
        b = 32
        while b < y1q - y0q:
            b *= 2
        if b >= rh1:
            return None
        y0q = max(0, min(y0q, rh1 - b))
        return y0q, b

    def _transparent_layer_bound(self, masks):
        """Proven upper bound on per-pixel transparent depth complexity, or
        None when unprovable: every visible transparent mesh must be a
        verified-convex resource (core/meshes._is_convex), so it adds at
        most 1 fragment per ray (2 when double-sided); the bound is the
        max point-stab of the multiplicity-weighted projected-AABB screen
        rects on an 8-pixel grid (1-pixel safety pad). Peels beyond it
        cannot receive fragments, so the clamp is exact."""
        proj = self._projected_corners(masks, masks["transparent"])
        if proj is None:
            return None
        sel, keys, clip, w = proj
        mult = []
        for i in sel:
            mesh = self.meshes.get(keys[i])
            res = self.meshes._resources.get(mesh.resource_key)
            if res is None or not res.convex:
                return None
            mult.append(2 if mesh.double_sided else 1)
        if (w <= 1e-6).any():
            return None     # near-plane crossing: unbounded screen rect
        WW = max(self.config.width, 1)
        HH = max(self.config.height, 1)
        sx = ((0.5 + 0.5 * clip[:, 0] / w) * WW).reshape(-1, 8)
        sy = ((0.5 - 0.5 * clip[:, 1] / w) * HH).reshape(-1, 8)
        gx = max(WW // 8, 1)
        gy = max(HH // 8, 1)
        x0 = np.clip(np.floor((sx.min(1) - 1) / 8), 0, gx - 1).astype(int)
        x1 = np.clip(np.floor((sx.max(1) + 1) / 8), 0, gx - 1).astype(int)
        y0 = np.clip(np.floor((sy.min(1) - 1) / 8), 0, gy - 1).astype(int)
        y1 = np.clip(np.floor((sy.max(1) + 1) / 8), 0, gy - 1).astype(int)
        m = np.asarray(mult, np.int32)
        acc = np.zeros((gy + 1, gx + 1), np.int32)
        np.add.at(acc, (y0, x0), m)
        np.add.at(acc, (y0, x1 + 1), -m)
        np.add.at(acc, (y1 + 1, x0), -m)
        np.add.at(acc, (y1 + 1, x1 + 1), m)
        return int(acc.cumsum(0).cumsum(1)[:-1, :-1].max())

    def _bucket_tile_cap(self, masks, bucket: str, tile_h: int = 8,
                         tile_w: int = 128):
        """Upper bound on the (tile_h x tile_w) tiles one pass bucket can
        cover: per-mesh projected-AABB screen rects, tile-quantized (1 px
        safety pad), union-counted (over-counting is safe), then quantized
        so camera motion changes the cap in bounded steps: transparent
        buckets in 32-aligned 1.25x steps from 64, the opaque bucket in
        ~n_tiles/32 steps. None = empty bucket, a mesh crosses the near
        plane, or the bound would not pay for itself. The transparent cap
        (32x32 tiles) drives the covered-tile compaction of the K-layer
        peel + shade."""
        rw1 = ((self.config.width + 127) // 128) * 128
        rh1 = ((self.config.height + 7) // 8) * 8
        rh_t = -(-rh1 // tile_h) * tile_h
        n_tiles = (rh_t // tile_h) * (rw1 // tile_w)
        proj = self._projected_corners(masks, masks[bucket])
        if proj is None:
            return None
        _sel, _keys, clip, w = proj
        if (w <= 1e-6).any():
            return None
        sx = ((0.5 + 0.5 * clip[:, 0] / w) * rw1).reshape(-1, 8)
        sy = ((0.5 - 0.5 * clip[:, 1] / w) * rh1).reshape(-1, 8)
        ntx, nty = rw1 // tile_w, rh_t // tile_h
        # the overlay band's tile grid can sit up to tile_h - 8 rows off
        # this frame-aligned grid (_overlay_crop clamps y0 to rh1 - band,
        # an 8-multiple): expand the rects by that slack
        slack = max(0, tile_h - 8)
        tx0 = np.clip(np.floor((sx.min(1) - 1) / tile_w), 0, ntx - 1).astype(int)
        tx1 = np.clip(np.floor((sx.max(1) + 1) / tile_w), 0, ntx - 1).astype(int)
        ty0 = np.clip(np.floor((sy.min(1) - 1 - slack) / tile_h), 0,
                      nty - 1).astype(int)
        ty1 = np.clip(np.floor((sy.max(1) + 1 + slack) / tile_h), 0,
                      nty - 1).astype(int)
        acc = np.zeros((nty + 1, ntx + 1), np.int32)
        np.add.at(acc, (ty0, tx0), 1)
        np.add.at(acc, (ty0, tx1 + 1), -1)
        np.add.at(acc, (ty1 + 1, tx0), -1)
        np.add.at(acc, (ty1 + 1, tx1 + 1), 1)
        cap = int(np.count_nonzero(
            acc.cumsum(axis=0).cumsum(axis=1)[:-1, :-1]))
        if cap <= 0:
            return None
        if bucket == "opaque":
            step = max(64, 1 << max(0, (n_tiles // 32 - 1)).bit_length())
            capb = -(-cap // step) * step
            if capb * 8 >= n_tiles * 7:   # < 12.5% sky: not worth it
                return None
            return capb
        capb = 64
        while capb < cap:
            capb = -(-(capb * 5 // 4) // 32) * 32
        if capb * 4 >= n_tiles * 3:
            return None
        return capb

    def _dof_ring_set(self, masks):
        """Static DoF ring set from a host-side CoC bound (ops/effects.py
        dof_max_coc / dof_active_rings) over the view-depth range [the
        nearest AABB corner of the visible meshes (floored at the near
        plane), the far plane]: rings the bound proves weightless are
        left out, () skips DoF (the WGSL coc < 0.5 early-out). The min
        view depth over an AABB is the min over its 8 corners."""
        from .ops.effects import (
            dof_active_rings, dof_max_coc, linearize_depth_host,
        )

        proj = np.asarray(self.camera.projection, np.float64)
        near_d = linearize_depth_host(0.0, proj)
        far_d = linearize_depth_host(1.0, proj)
        mins, maxs, _keys = self.meshes.world_bounds()
        if len(mins):
            vis = masks["opaque"] | masks["transparent"] | masks["hud"]
            sel = np.nonzero(vis[self.meshes.world_rows()])[0]
            mins, maxs = mins[sel], maxs[sel]
        if len(mins):
            view = np.asarray(self.camera.view, np.float64)
            corners = np.stack([
                np.stack([np.where(b & 1, maxs[:, 0], mins[:, 0]),
                          np.where(b & 2, maxs[:, 1], mins[:, 1]),
                          np.where(b & 4, maxs[:, 2], mins[:, 2])], axis=-1)
                for b in range(8)], axis=1)                  # (N, 8, 3)
            vz = -(corners.reshape(-1, 3) @ view[2, :3] + view[2, 3])
            dmin = max(float(vz.min()), min(near_d, far_d))
        else:
            dmin = min(near_d, far_d)
        dmax = max(far_d, dmin)
        coc_max = dof_max_coc(
            [self.camera.dof.focus_distance, self.camera.dof.aperture],
            float(proj[1, 1]), dmin, dmax, self.config.height)
        return dof_active_rings(coc_max)

    def _prepare(self):
        """Cull + bucket, each bucket's shading specialization (slot_mask,
        ext), the overlay's crop band, compacted pool, tile cap and layer
        clamp, the MSAA frame's opaque tile cap, the DoF ring set, and
        refuse content outside the slice."""
        masks = self._mesh_masks()
        info = self.meshes.mesh_info
        if (info[:, 3] > 0).any() or (info[:, 5] > 0).any():
            raise _unsupported("morph targets / skins",
                               "M2b animated vertex stage")
        if any(True for _ in self.meshes.inst_group_items()):
            raise _unsupported("instanced groups",
                               "M2b animated vertex stage and instancing")
        if self.lights.count > MAX_DENSE_LIGHTS:
            raise _unsupported(f"more than {MAX_DENSE_LIGHTS} lights "
                               "(tiled light lists)", "M12 passes and hooks")
        op_rows = self._bucket_mat_rows(masks["opaque"])
        prep = dict(masks=masks, slot_mask=self._slot_mask(op_rows),
                    ext=self._ext_mask(op_rows),
                    opaque_dev=self._device_mask("opaque", masks["opaque"]),
                    transparent_dev=None, hud_dev=None, ov_slot_mask=None,
                    ov_ext=None, ov_crop=None, ov_idx=None, ov_tile_cap=None,
                    n_layers=self.config.max_transparent_layers,
                    # the MSAA frame's covered-tile compacted shade
                    op_tile_cap=(self._bucket_tile_cap(
                        masks, "opaque", tile_h=OPAQUE_TILE_ROWS,
                        tile_w=128)
                        if self.config.anti_aliasing.msaa else None),
                    dof_rings=(self._dof_ring_set(masks)
                               if self.config.post_processing.dof
                               else None))
        has_transparent = bool(masks["transparent"].any())
        has_hud = bool(masks["hud"].any())
        if has_transparent or has_hud:
            ov_rows = self._bucket_mat_rows(masks["transparent"]
                                            | masks["hud"])
            prep.update(ov_slot_mask=self._slot_mask(ov_rows),
                        ov_ext=self._ext_mask(ov_rows),
                        ov_crop=self._overlay_crop(masks),
                        ov_idx=self._overlay_tri_idx(masks))
        if has_transparent:
            prep["transparent_dev"] = self._device_mask(
                "transparent", masks["transparent"])
            # 32x32 units: the cap sizes the compacted peel's tile grid
            prep["ov_tile_cap"] = self._bucket_tile_cap(
                masks, "transparent", tile_h=32, tile_w=32)
            bound = self._transparent_layer_bound(masks)
            if bound:
                prep["n_layers"] = min(prep["n_layers"], bound)
        if has_hud:
            prep["hud_dev"] = self._device_mask("hud", masks["hud"])
        return prep

    def _scene_signature(self, cfg=None):
        """Content signature of everything a frame depends on (the
        pick-staleness epoch and the per-frame prep memo key)."""
        return (
            getattr(self.meshes, "mutation_count", 0),
            getattr(self.materials, "mutation_count", 0),
            getattr(self.transforms, "mutation_count", 0),
            self.skins.gpu_dirty, self.environment.gpu_dirty,
            self.textures.gpu_dirty, self.lights.gpu_dirty,
            self.camera.view.tobytes(), self.camera.projection.tobytes(),
            self.camera.dof.focus_distance, self.camera.dof.aperture,
            cfg if cfg is not None else self.config,
        )

    # ---- render (reference: renderer.py render_device / render / pick) ---

    def render_device(self, debug_mode: str = "none", hooks=None):
        """Render one frame; returns the (H, W, 4) f32 sRGB display image as
        a tensor on the renderer's device (no host readback)."""
        if hooks is not None:
            raise _unsupported("render hooks", "M12 passes and hooks")
        cfg = self.config
        if debug_mode == "edges" and not cfg.anti_aliasing.msaa:
            raise ConfigError(
                "debug_mode 'edges' visualizes MSAA per-sample coverage "
                "and requires AntiAliasing(msaa=True)")
        self._check_config(cfg)
        self.camera.next_frame()
        if debug_mode == "none" and (
                self.materials.flags[:, MI_DEBUG_MASK] != 0).any():
            # a material's debug bitmask switches to the per-material view
            debug_mode = "material"
        aa, pp = cfg.anti_aliasing, cfg.post_processing
        # temporal reuse engages unless a debug view or another AA mode
        # reshapes the opaque stage; those fall back to the ordinary frame.
        # The history leaves self._temporal until this frame returns, so a
        # frame that raises makes the next one reset
        use_temporal = (aa.temporal and debug_mode == "none"
                        and not aa.supersample and not aa.msaa)
        st, self._temporal = self._temporal, None
        if use_temporal:
            ds = self._flush(
                jitter_px=get_halton_jitter((self.camera.frame_count % 8)
                                            + 1),
                prev_view_proj=(st["prev_vp"] if st is not None
                                else self.camera.view_projection))
        else:
            ds = self._flush()
        prep_key = self._scene_signature(cfg)
        if self._prep is None or self._prep[0] != prep_key:
            self._prep = (prep_key, self._prepare())
        prep = self._prep[1]
        masks = prep["masks"]
        tx = self.textures
        ov_crop = prep["ov_crop"]
        kw = dict(
            width=cfg.width, height=cfg.height, tonemap=pp.tonemapping,
            bloom=pp.bloom, dof=pp.dof, smaa=aa.smaa,
            dof_rings=prep["dof_rings"], needs_clip=masks["needs_clip"],
            solid_env=self.environment.is_solid,
            has_color=self.meshes.uses_vertex_colors,
            has_uv1=bool((self.materials.tex_slots[:, :, 1] == 1).any()),
            use_mips=aa.mipmap, slot_mask=prep["slot_mask"],
            has_nearest=bool((tx.descriptors[:, 5] == 0).any()
                             and tx.descriptor_capacity > 0),
            ext=prep["ext"], n_transparent_layers=prep["n_layers"],
            overlay_slot_mask=prep["ov_slot_mask"],
            overlay_ext=prep["ov_ext"],
            overlay_crop_y0=ov_crop[0] if ov_crop else None,
            overlay_crop_h=ov_crop[1] if ov_crop else None,
            overlay_tri_idx=prep["ov_idx"],
            overlay_tile_cap=prep["ov_tile_cap"])
        bucket_masks = (prep["opaque_dev"], prep["transparent_dev"],
                        prep["hud_dev"])
        if use_temporal:
            rw1 = _pad_to(cfg.width, TILE_W)
            rh1 = _pad_to(cfg.height, TILE_H)
            n_units = (rh1 // 8) * (rw1 // 128)
            # the history survives camera motion (that is its point); a
            # content flush or a resize resets it, and the reset frame
            # shades every unit so the next one starts converged
            if (st is None or st["epoch"] != self._content_epoch
                    or st["shape"] != (rh1, rw1)):
                hist = reset_history(rh1, rw1, self.device)
                age = torch.full((n_units,), 1 << 20, dtype=torch.int32,
                                 device=self.device)
                cap = n_units
            else:
                hist, age = st["hist"], st["age"]
                cap = max(1, min(n_units, int(round(cfg.temporal.cap_frac
                                                    * n_units))))
            ldr, tri_id, _depth, hist, age = render_frame_temporal(
                ds, *bucket_masks, hist, age, shade_cap=cap,
                alpha=cfg.temporal.alpha, **kw)
            self._temporal = dict(
                hist=hist, age=age, prev_vp=self.camera.view_projection,
                epoch=self._content_epoch, shape=(rh1, rw1))
            bins = None
        else:
            ldr, tri_id, _depth, bins = render_frame(
                ds, *bucket_masks, supersample=aa.supersample, msaa=aa.msaa,
                opaque_tile_cap=prep["op_tile_cap"], debug_mode=debug_mode,
                **kw)
        self._last_tri_id = tri_id
        self._rendered_sig = prep_key
        self.last_bins = bins
        # pick() re-renders THIS frame's configuration when it is stale
        self._last_debug_mode = debug_mode
        return ldr

    def render(self, debug_mode: str = "none", hooks=None) -> np.ndarray:
        """Render one frame and read it back: (H, W, 4) f32 sRGB.

        debug_mode: "none" | "normals" | "ibl" | "punctual" |
        "edges" (the MSAA edge view; needs msaa) | "channel:<name>"
        (ops/shade.py DEBUG_CHANNELS)."""
        return self.render_device(debug_mode, hooks).cpu().numpy()

    def render_u8(self) -> np.ndarray:
        return (np.clip(self.render(), 0.0, 1.0) * 255.0
                + 0.5).astype(np.uint8)

    def pick(self, x: int, y: int) -> Optional[int]:
        """Mesh key under pixel (x, y), or None. Re-renders first when the
        scene, camera or config changed since the cached tri_id plane."""
        if (self._last_tri_id is None
                or getattr(self, "_rendered_sig", None)
                != self._scene_signature()):
            if self.meshes.count == 0:
                return None
            # replay the last frame's debug mode (reference: renderer.py
            # pick; render hooks are refused until M12)
            self.render_device(debug_mode=self._last_debug_mode)
        h, w = self._last_tri_id.shape
        if not (0 <= x < w and 0 <= y < h):
            return None
        tid = int(self._last_tri_id[y, x])
        tm = self._tri_mesh_device_order
        if tid < 0 or tm is None or tid >= tm.size:
            return None
        return self._mesh_row_to_key.get(int(tm[tid]))
