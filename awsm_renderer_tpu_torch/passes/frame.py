"""Frame pipeline of the port's slice: vertex -> raster (K1) -> resolve
(K2) -> deferred shade (K3 material fetch, K4 + K5 texture taps, K6 env
taps) -> display.

Port of the non-AA, effect-free, opaque-only path of
awsm_renderer_tpu/passes/frame.py: render_frame -> _opaque_band ->
_finish_frame. PyTorch runs it eagerly, op by op, on the scene tensors'
device.
"""

from __future__ import annotations

import torch

from ..config import ToneMapping
from ..ops.raster import TILE_H, TILE_W, pad_setup_rows, rasterize16
from ..ops.shade import NO_EXT, NO_SLOTS, shade_deferred_c
from ..ops.tonemap import display_pass_c
from ..ops.vertex import vertex_stage

_CORNER_NAMES = ("c_pos", "c_norm", "c_tang", "c_uv0", "c_uv1", "c_color")


def _pad_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _combined_geometry(ds):
    """The triangle pool's corner arrays and tri -> mesh rows (instanced
    groups are not in the slice; the facade refuses them)."""
    return {n: ds[n] for n in _CORNER_NAMES}, ds["tri_mesh"]


def _run_vertex(ds, mask, *, rw: int, rh_full: int, needs_clip: bool):
    geo, tri_mesh = _combined_geometry(ds)
    return vertex_stage(
        geo["c_pos"], geo["c_norm"], geo["c_tang"], geo["c_uv0"],
        geo["c_uv1"], geo["c_color"], tri_mesh, ds["mesh_info"],
        ds["world"], ds["normal_mat"], ds["camera"]["view_proj"], mask,
        width=rw, height=rh_full, needs_clip=needs_clip)


def prep_setup_rows(rows: torch.Tensor) -> torch.Tensor:
    """(T, NSETUP) vertex rows -> padded row-major raster input. No sort:
    the binner's 16-triangle groups keep the pool's per-mesh order."""
    return pad_setup_rows(rows)


def _opaque_band(ds, opaque_mask, *, rw: int, rh: int, needs_clip: bool,
                 solid_env: bool, has_color: bool, has_uv1: bool,
                 use_mips: bool, slot_mask, has_nearest: bool, ext,
                 debug_mode: str):
    """Opaque geometry + deferred shade over the whole (rh, rw) padded
    framebuffer -> (hdr [r,g,b,a] (rh*rw,) planes, tri_id, depth
    (rh, rw), raster bins)."""
    srows = prep_setup_rows(_run_vertex(ds, opaque_mask, rw=rw, rh_full=rh,
                                        needs_clip=needs_clip))
    # uv1 / vertex-colour planes only when a material samples uv1 or a
    # mesh carries colours; no analytic derivatives: the mip gradients
    # are screen differences of the padded uv0 planes, as in the reference
    vis = rasterize16(srows, width=rw, height=rh, has_uv1=has_uv1,
                      has_color=has_color, analytic_derivs=False)
    hdr_ch = shade_deferred_c(vis, ds, width=rw, height=rh,
                              solid_env=solid_env, use_mips=use_mips,
                              slot_mask=slot_mask, has_nearest=has_nearest,
                              ext=ext, debug_mode=debug_mode)
    return hdr_ch, vis["tri_id"], vis["depth"], vis["bins"]


def _finish_frame(hdr_ch, tri_id, depth, *, rw: int, rh: int, width: int,
                  height: int, tonemap: ToneMapping):
    """Crop the padding, tonemap + sRGB display pass, stack to (H, W, 4)."""
    hdr_ch = [c.reshape(rh, rw)[:height, :width] for c in hdr_ch]
    ldr_ch = display_pass_c(hdr_ch, tonemap)
    return (torch.stack(ldr_ch, dim=-1), tri_id[:height, :width],
            depth[:height, :width])


def render_frame(ds, opaque_mask, *, width: int, height: int,
                 tonemap: ToneMapping, needs_clip: bool = True,
                 solid_env: bool = False, has_color: bool = True,
                 has_uv1: bool = False, use_mips: bool = True,
                 slot_mask=NO_SLOTS, has_nearest: bool = True, ext=NO_EXT,
                 debug_mode: str = "none"):
    """Returns (display rgba (H, W, 4) f32 in [0, 1], tri_id (H, W) int32
    in triangle-pool space (-1 = miss), depth (H, W) f32, raster bins)."""
    rw = _pad_to(width, TILE_W)
    rh = _pad_to(height, TILE_H)
    hdr_ch, tri_id, depth, bins = _opaque_band(
        ds, opaque_mask, rw=rw, rh=rh, needs_clip=needs_clip,
        solid_env=solid_env, has_color=has_color, has_uv1=has_uv1,
        use_mips=use_mips, slot_mask=slot_mask, has_nearest=has_nearest,
        ext=ext, debug_mode=debug_mode)
    ldr, tri_id, depth = _finish_frame(hdr_ch, tri_id, depth, rw=rw, rh=rh,
                                       width=width, height=height,
                                       tonemap=tonemap)
    # picking ids in triangle-pool space (clipping doubles the rows)
    T_pool = ds["tri_mesh"].shape[0]
    tri_id = torch.where(tri_id >= 0, tri_id % T_pool, -1)
    return ldr, tri_id, depth, bins
