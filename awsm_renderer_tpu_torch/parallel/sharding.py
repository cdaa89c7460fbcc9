"""The multi-GPU frame: the framebuffer split into row bands (1-D) or
screen tiles (2-D) over the ranks of a torch.distributed DeviceMesh.

Port of awsm_renderer_tpu/parallel/sharding.py. The reference wraps the
band pipeline in shard_map and runs the rest of the frame under jit over
row-sharded arrays, where GSPMD exchanges the halos. Here:

  - what runs inside shard_map runs on each rank for its own band: the
    single-device frame's band functions (passes/frame.py _frame_band,
    _opaque_band, _opaque_band_msaa, _overlay_band) with the setup rows
    shifted into the band's local coordinates, so the raster kernels see
    only the band;
  - where the reference leaves shard_map, the ranks exchange: each packs
    its band planes into one tensor and all-gathers it over the mesh's
    process group; every rank then runs the full-frame step on the whole
    frame and takes its own band back where the band pipeline goes on.
    The full-frame steps are the MSAA edge blend (its rolls wrap at the
    frame's borders, as the reference's global roll), the supersample
    resolve and the image-space tail _finish_frame (bloom, depth of
    field, display, SMAA). A single-scale frame exchanges once, an MSAA
    or supersampled frame twice.

The tail runs on every rank over the whole frame, where the reference
runs it sharded with GSPMD's halo exchanges: the math is the same, and a
halo exchange of the tail is later speed work. Every rank returns the
whole frame.

The bands follow the reference's sharded frame, not its single-device
frame, where the two differ: the mip gradients are screen differences
inside each band (a band's border rows may pick another mip level), and a
row band's volume refraction takes the IBL colour for an exit point
outside the band.

The scene is replicated: every rank passes the same device dict (the
renderer's flush on that rank's device, from the same scene). Nothing is
broadcast here.

On N GPUs: one process per GPU, an NCCL process group, and
DeviceMesh("cuda", list(range(N)), mesh_dim_names=("rows",)). Several
ranks on one card, or on the CPU, take a gloo group: NCCL refuses two
ranks on one GPU.
"""

from __future__ import annotations

import functools

import torch
import torch.distributed as dist

from ..config import ToneMapping
from ..ops.raster import TILE_H, TILE_W
from ..ops.shade import ALL_EXT, ALL_SLOTS, EXT_VOLUME
from ..passes.frame import (
    FrameSpec, _finish_frame, _frame_band, _msaa_edge_blend, _opaque_band,
    _opaque_band_msaa, _overlay_band, _pad_to, _resolve_supersample,
)


def _pack(planes) -> torch.Tensor:
    """One (k, h, w) float32 tensor of a band's k (h, w) planes, int32
    planes by their bits (an exchange moves one tensor)."""
    return torch.stack([p.view(torch.float32) if p.dtype == torch.int32
                        else p for p in planes])


def _assemble(packs, grid):
    """The whole frame (k, H, W) from the packs of every band of a (rows,
    cols) grid, in row-major band order."""
    nr, nc = grid
    return torch.cat([torch.cat(packs[r * nc:(r + 1) * nc], dim=2)
                      for r in range(nr)], dim=1)


def _all_gather(t: torch.Tensor, group) -> list:
    """Every rank's `t` in the group's rank order (list form of
    torch.distributed.all_gather)."""
    n = dist.get_world_size(group)
    if n == 1:
        return [t]
    out = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(out, t, group=group)
    return out


class _MeshExchange:
    """The exchange of this rank's band over a DeviceMesh: all-gather
    along the mesh's column dim (2-D: the tiles of this rank's row of
    tiles), then along its row dim. Bit-equal to _assemble of every
    band's pack."""

    def __init__(self, mesh):
        self.mesh = mesh

    def __call__(self, packs) -> torch.Tensor:
        (t,) = packs
        if self.mesh.ndim == 2:
            t = torch.cat(_all_gather(t, self.mesh.get_group(1)), dim=2)
        return torch.cat(_all_gather(t, self.mesh.get_group(0)), dim=1)


def _bucket(mask, on: bool, like):
    """An overlay bucket's mask as the band functions take it: None when
    the pass is off, all-false when it is on without a mask (the
    reference's zeros)."""
    if not on:
        return None
    return torch.zeros_like(like) if mask is None else mask


def _band_frame(ds, opaque_mask, transparent_mask, hud_mask,
                spec: FrameSpec, *, bands, grid, exchange=None):
    """The sharded frame's pipeline for the bands `bands` (row-major
    indices) of a `grid` = (rows, cols) split of the padded frame.

    exchange(packs): given the packs (_pack) of the bands in `bands`, in
    order, returns the whole frame's (_assemble). None: `bands` holds
    every band of the grid (range(rows * cols)), and the exchange
    assembles them — the in-process frame, which runs a sharded frame's
    every band in one process with no process group. A grid of more than
    one column is single-scale. transparent_mask / hud_mask None skip
    their pass. The overlay takes the opaque bucket's slot and extension
    masks, and nothing compacts, crops or drops a DoF ring: spec's
    overlay_* fields, tile caps and dof_rings are the single-device
    frame's.

    Returns (ldr (H, W, 4), tri_id (H, W) int32 in triangle-pool space,
    depth (H, W)), the whole frame."""
    nr, nc = grid
    if spec.supersample and spec.msaa:
        raise ValueError("pick one AA mode")
    if exchange is None:
        exchange = functools.partial(_assemble, grid=grid)
    width, height = spec.width, spec.height
    scale = 2 if spec.supersample else 1
    rw2 = _pad_to(width * scale, TILE_W)
    rh2 = _pad_to(height * scale, TILE_H)
    rw1 = _pad_to(width, TILE_W)
    rh1 = _pad_to(height, TILE_H)
    if rh2 % (TILE_H * nr):
        raise ValueError(
            f"padded render height {rh2} must split into TILE_H({TILE_H})-"
            f"aligned bands across {nr} devices")
    if (spec.supersample or spec.msaa) and rh1 % (TILE_H * nr):
        raise ValueError(
            f"padded display height {rh1} must split into TILE_H({TILE_H})-"
            f"aligned bands across {nr} devices for the 1x overlay pass")
    if rw1 % (TILE_W * nc):
        raise ValueError(
            f"padded width {rw1} must split into TILE_W({TILE_W})-aligned "
            f"tile columns across {nc} devices")

    def overlay_bands(hdr_ch, tri_id, depth):
        """The overlay over each band's rows of the resolved 1x frame
        (row bands only), then the exchange -> hdr_ch, tri_id."""
        band_h = rh1 // nr
        packs = []
        for b in bands:
            rows = slice(b * band_h, (b + 1) * band_h)
            hdr_b, tid_b = _overlay_band(
                [c.reshape(rh1, rw1)[rows].reshape(-1) for c in hdr_ch],
                tri_id[rows], depth[rows], ds, transparent_mask, hud_mask,
                spec, rw=rw1, band_h=band_h, rh_full=rh1,
                row_offset=b * band_h, shift_rows=True)
            packs.append(_pack([c.reshape(band_h, rw1) for c in hdr_b]
                               + [tid_b]))
        full = exchange(packs)
        return [full[c].reshape(-1) for c in range(4)], full[4].view(
            torch.int32)

    packs = []
    if spec.msaa:
        band_h = rh1 // nr
        for b in bands:
            hdr_b, samp, depth_b, _bins = _opaque_band_msaa(
                ds, opaque_mask, spec, rw2=_pad_to(width * 2, TILE_W),
                rh2=2 * rh1, rw1=rw1, rh1=rh1, band1_h=band_h,
                row_offset1=b * band_h, shift_rows=True)
            packs.append(_pack([c.reshape(band_h, rw1) for c in hdr_b]
                               + list(samp) + [depth_b]))
        full = exchange(packs)
        samp = [full[4 + s].view(torch.int32) for s in range(4)]
        # the edge blend over the whole frame: the reference's runs outside
        # shard_map, where its rolls wrap at the frame's borders
        hdr_ch = _msaa_edge_blend([full[c].reshape(-1) for c in range(4)],
                                  samp, rh1, rw1)
        hdr_ch, tri_id = overlay_bands(hdr_ch, samp[0], full[8])
        depth = full[8]
    elif spec.supersample:
        band_h = rh2 // nr
        for b in bands:
            hdr_b, tid_b, depth_b, _bins = _opaque_band(
                ds, opaque_mask, spec, rw=rw2, band_h=band_h, rh_full=rh2,
                row_offset=b * band_h, shift_rows=True)
            packs.append(_pack([c.reshape(band_h, rw2) for c in hdr_b]
                               + [tid_b, depth_b]))
        full = exchange(packs)
        hdr_ch, tri_id, depth = _resolve_supersample(
            [full[c].reshape(-1) for c in range(4)], full[4].view(
                torch.int32), full[5], width=width, height=height, rw2=rw2,
            rw1=rw1, rh1=rh1)
        hdr_ch, tri_id = overlay_bands(hdr_ch, tri_id, depth)
    else:
        band_h, band_w = rh1 // nr, rw1 // nc
        for b in bands:
            r, c = divmod(b, nc)
            hdr_b, tid_b, depth_b = _frame_band(
                ds, opaque_mask, transparent_mask, hud_mask, spec,
                rw=band_w, band_h=band_h, rh_full=rh1, row_offset=r * band_h,
                shift_rows=True, rw_full=rw1 if nc > 1 else None,
                col_offset=c * band_w, shift_cols=nc > 1)
            packs.append(_pack([h.reshape(band_h, band_w) for h in hdr_b]
                               + [tid_b, depth_b]))
        full = exchange(packs)
        hdr_ch = [full[c].reshape(-1) for c in range(4)]
        tri_id, depth = full[4].view(torch.int32), full[5]
    return _finish_frame(hdr_ch, tri_id, depth, ds, spec, rw=rw1, rh=rh1)


def render_frame_sharded(
        mesh, ds, opaque_mask, transparent_mask=None, hud_mask=None, *,
        width: int, height: int, supersample: bool = False,
        msaa: bool = False,
        tonemap: ToneMapping = ToneMapping.KHRONOS_PBR_NEUTRAL,
        use_mips: bool = True, has_morphs: bool = False, skin_sets: int = 0,
        has_transparent: bool = False, has_hud: bool = False,
        n_transparent_layers: int = 4, slot_mask=ALL_SLOTS,
        solid_env: bool = False, debug_mode: str = "none",
        bloom: bool = False, dof: bool = False, smaa: bool = False,
        has_nearest: bool = True, needs_clip: bool = True, ext=None,
        has_uv1: bool = True, has_color: bool = True,
        light_tiles: bool = False):
    """Render with the framebuffer split into row bands over `mesh`, a
    1-D torch.distributed DeviceMesh (dim name e.g. "rows"): this rank
    renders band mesh.get_local_rank(0) of mesh.size(0).

    The pass set and keywords are the reference's render_frame_sharded:
    opaque, transparent peel (has_transparent) and HUD (has_hud) over the
    full combined pool, supersample or MSAA, bloom, DoF, SMAA. ds is the
    port's device dict as this rank holds it; every rank passes the same
    scene and masks (nothing is broadcast). solid_env must say whether
    the scene's environment is solid: the port's flush ships an image
    environment's rows in the texel pool (ds["env_pool_base"]) and a
    solid one's as constants (the renderer's _frame_spec has it). The
    padded render height must split into TILE_H-aligned bands:
    pad(height * scale) % (TILE_H * n) == 0 (1080 rows: n dividing 135).

    Returns (ldr (H, W, 4), tri_id (H, W), depth (H, W)), the whole frame,
    on every rank."""
    if mesh.ndim != 1:
        raise ValueError("render_frame_sharded takes a 1-D mesh; screen "
                         "tiles are render_frame_sharded_2d's")
    spec = FrameSpec(
        width=width, height=height, tonemap=tonemap, supersample=supersample,
        msaa=msaa, needs_clip=needs_clip, has_morphs=has_morphs,
        skin_sets=skin_sets, solid_env=solid_env, has_color=has_color,
        has_uv1=has_uv1, use_mips=use_mips, slot_mask=slot_mask,
        has_nearest=has_nearest, ext=ALL_EXT if ext is None else ext,
        debug_mode=debug_mode, n_transparent_layers=n_transparent_layers,
        bloom=bloom, dof=dof, smaa=smaa, light_tiles=light_tiles)
    return _band_frame(
        ds, opaque_mask, _bucket(transparent_mask, has_transparent,
                                 opaque_mask),
        _bucket(hud_mask, has_hud, opaque_mask), spec,
        bands=(mesh.get_local_rank(0),), grid=(mesh.size(0), 1),
        exchange=_MeshExchange(mesh))


def render_frame_sharded_2d(
        mesh, ds, opaque_mask, transparent_mask=None, hud_mask=None, *,
        width: int, height: int,
        tonemap: ToneMapping = ToneMapping.KHRONOS_PBR_NEUTRAL,
        use_mips: bool = True, has_morphs: bool = False, skin_sets: int = 0,
        has_transparent: bool = False, has_hud: bool = False,
        n_transparent_layers: int = 4, slot_mask=ALL_SLOTS,
        solid_env: bool = False, bloom: bool = False, dof: bool = False,
        smaa: bool = False, has_nearest: bool = True,
        needs_clip: bool = True, ext=None, has_uv1: bool = True,
        has_color: bool = True, light_tiles: bool = False):
    """Single-scale frame over a 2-D DeviceMesh (dim names e.g. ("rows",
    "cols")): this rank renders the (band_h x band_w) screen tile
    (mesh.get_local_rank(0), mesh.get_local_rank(1)), its setup in fully
    local coordinates (both shifts), with the production band pipeline.

    Single-scale only (no supersample or MSAA resolve between stages) and
    no KHR_materials_volume refraction (its background gather crosses
    tile bounds). The padded height must split into TILE_H-aligned rows
    and the padded width into TILE_W-aligned columns (1920: n dividing
    15). Otherwise as render_frame_sharded."""
    ext = ALL_EXT if ext is None else ext
    if has_transparent and ext[EXT_VOLUME]:
        raise ValueError(
            "2-D tile sharding cannot serve screen-space refraction — pass "
            "ext with the volume flag off (renderer buckets do this when no "
            "material uses KHR_materials_volume)")
    if mesh.ndim != 2:
        raise ValueError("render_frame_sharded_2d takes a 2-D mesh")
    nc = mesh.size(1)
    spec = FrameSpec(
        width=width, height=height, tonemap=tonemap, needs_clip=needs_clip,
        has_morphs=has_morphs, skin_sets=skin_sets, solid_env=solid_env,
        has_color=has_color, has_uv1=has_uv1, use_mips=use_mips,
        slot_mask=slot_mask, has_nearest=has_nearest, ext=ext,
        n_transparent_layers=n_transparent_layers, bloom=bloom, dof=dof,
        smaa=smaa, light_tiles=light_tiles)
    return _band_frame(
        ds, opaque_mask, _bucket(transparent_mask, has_transparent,
                                 opaque_mask),
        _bucket(hud_mask, has_hud, opaque_mask), spec,
        bands=(mesh.get_local_rank(0) * nc + mesh.get_local_rank(1),),
        grid=(mesh.size(0), nc), exchange=_MeshExchange(mesh))
