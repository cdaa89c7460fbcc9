"""Frame pipeline of the port's slice: vertex (pool + instanced groups;
morphs and skins on the animated subset) -> raster (K1, or K9 at 2x2
samples with MSAA) -> resolve (K2) -> deferred shade (K3 material fetch,
K4 + K5 texture taps, K6 env taps; covered-tile compacted with MSAA) ->
MSAA edge blend or supersample resolve -> transparent peel (K7 or K8) +
forward shade + composite -> HUD (K7, or K1 + K2 over the full pool) ->
bloom, depth of field -> display -> SMAA. The temporal frame swaps the
opaque stage for a jittered K1 raster, history reprojection (K10) and a
budgeted shade of the units the history cannot answer for. Every shade
takes the tiled light lists when light_tiles is set, and RenderHooks
callbacks run at the reference's seven points.

Port of awsm_renderer_tpu/passes/frame.py: render_frame ->
_opaque_band / _opaque_band_msaa -> _msaa_edge_blend /
_resolve_supersample -> _overlay_band -> _finish_frame, and
render_frame_temporal. The band functions (and _frame_band) also run
one row band or screen tile of the frame, their setup shifted into its
local coordinates (_shift_rows_band, _shift_cols_band): the sharded
frame's (parallel/sharding.py). Each function takes the frame's
specialization whole, a FrameSpec, and each shade its bucket's
ShadeSpec. PyTorch runs it eagerly, op by op, on the scene tensors'
device.

With the renderer's timings on, each stage runs in a span of them
(utils/profiling.py span), inside the facade's render_frame/dispatch
and never inside another stage: render_frame/vertex, raster, shade,
resolve (MSAA edge blend, supersample resolve, the temporal
reprojection and merge), overlay, effects (bloom, DoF, SMAA) and
display.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import Callable, Optional

import torch

from ..config import ToneMapping
from ..ops.effects import (
    DOF_RING_SCALES, bloom_c, depth_of_field_c, smaa_c,
)
from ..ops.raster import (
    BT_H, BT_W, CHUNK, TILE_H, TILE_W, rasterize,
    rasterize16, rasterize16_msaa, rasterize16_slim,
    rasterize_layers_compact, rasterize_layers_rows,
)
from ..ops.shade import (
    EXT_VOLUME, NO_EXT, NO_SLOTS, OPAQUE_TILE_ROWS, RESOLVE_NAMES, ShadeSpec,
    _surface_mode, _tile_swizzle, _tile_unswizzle, resolve_planes_fused,
    shade_deferred_c, shade_deferred_compact_c, shade_surface,
    shade_transparent_compact32, shade_transparent_layers_c, shade_units_c,
)
from ..ops.temporal import (
    reproject_history, select_units, temporal_merge, temporal_offsets,
)
from ..ops.tonemap import display_pass_c
from ..ops.vertex import (
    _BIG, S_BB_MAXX, S_BB_MAXY, S_BB_MINX, S_BB_MINY, S_E0A, S_E0B, S_E0C,
    S_E1A, S_E1B, S_E1C, S_E2A, S_E2B, S_E2C, S_ZA, S_ZB, S_ZC, vertex_stage,
)
from ..utils.profiling import span

_CORNER_NAMES = ("c_pos", "c_norm", "c_tang", "c_uv0", "c_uv1", "c_color",
                 "c_joints", "c_weights", "c_morph_base")


def _pad_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class RenderHooks:
    """The reference's seven hook points (reference: frame.py
    RenderHooks). The five in-frame hooks are torch functions that the
    frame calls eagerly; pre_render / post_render are host callbacks
    around the frame.

    Signatures:
      pre_render(renderer) -> None       [host, before the config is read
                                          and the scene flushed]
      first_pass(ds) -> ds               [before the vertex stage; gets a
                                          copy of the device dict]
      after_geometry(vis, ds) -> vis     [after raster + resolve of the
                                          opaque stage]
      before_transparent(hdr, depth, ds) -> hdr   [(rh, rw, 4) padded]
      after_transparent(hdr, ds) -> hdr           [(rh, rw, 4) padded]
      last_pass(ldr, ds) -> ldr          [(H, W, 4) display image, after
                                          SMAA]
      post_render(renderer) -> None      [host, after the frame]

    Draw user geometry mid-frame with passes/extra.py
    extra_geometry_pass."""

    pre_render: Optional[Callable] = None
    first_pass: Optional[Callable] = None
    after_geometry: Optional[Callable] = None
    before_transparent: Optional[Callable] = None
    after_transparent: Optional[Callable] = None
    last_pass: Optional[Callable] = None
    post_render: Optional[Callable] = None


def _first_pass(ds, hooks):
    """Run the first_pass hook on a copy of ds and of its camera dict: the
    renderer keeps ds across frames and the flush updates it in place, so
    an entry the hook sets must not outlive this frame (the reference's
    hook gets a fresh dict from jit's flattening). The shade's column
    cache (ds["mat_columns"]) stays shared."""
    fn = getattr(hooks, "first_pass", None)
    if fn is None:
        return ds
    return fn({**ds, "camera": dict(ds["camera"])})


def _inst_gids(ds):
    """Ids of the instanced groups in ds (keys inst{g}_*), ascending."""
    return sorted({int(k[4:].split("_", 1)[0]) for k in ds
                   if k.startswith("inst") and "_" in k
                   and k[4:].split("_", 1)[0].isdigit()})


def _combined_geometry(ds):
    """Pool corners + instanced groups tiled across their instances.

    An instanced group (core/meshes.py _InstGroup) holds its resource's
    corners once in ds; here they are tiled I times after the pool, in
    group-id order (which picking mirrors), and each triangle's mesh row
    comes from the (I,) instance-row vector: where(live.repeat(I),
    rows.repeat_interleave(Tp), -1)."""
    gids = _inst_gids(ds)
    if not gids:
        return {n: ds[n] for n in _CORNER_NAMES}, ds["tri_mesh"]
    parts = {n: [ds[n]] for n in _CORNER_NAMES}
    tri = [ds["tri_mesh"]]
    for g in gids:
        rows = ds[f"inst{g}_rows"]          # (I,) int32 mesh rows
        live = ds[f"inst{g}_live"]          # (Tp,) bool
        n_inst = rows.shape[0]
        for n in _CORNER_NAMES:
            parts[n].append(ds[f"inst{g}_{n}"].repeat(1, n_inst))
        tri.append(torch.where(live.repeat(n_inst),
                               rows.repeat_interleave(live.shape[0]),
                               torch.full((), -1, dtype=rows.dtype,
                                          device=rows.device)))
    return ({n: torch.cat(parts[n], dim=1) for n in _CORNER_NAMES},
            torch.cat(tri))


def _total_triangles(ds) -> int:
    """Triangle count of the combined stream, pool + instanced groups (the
    clip doubling and the picking modulo key off it)."""
    return ds["tri_mesh"].shape[0] + sum(
        ds[f"inst{g}_rows"].shape[0] * ds[f"inst{g}_live"].shape[0]
        for g in _inst_gids(ds))


_BBOX = (S_BB_MINX, S_BB_MINY, S_BB_MAXX, S_BB_MAXY)


def _shift_band(rows: torch.Tensor, o: int, coefs, bb_lo: int, bb_hi: int,
                extent: int | None) -> torch.Tensor:
    """rows with the constant of each plane (three edges, z) raised by its
    coefficient column in `coefs` times o, and the bbox columns bb_lo /
    bb_hi lowered by o. extent: the band's size along the axis; a row
    whose bbox then lies wholly outside [0, extent) gets the empty bbox
    the vertex stage gives a triangle off the frame, so the binners skip
    it (its edges cover no pixel of the band either way; a bbox out of
    range would file it under the band's edge tiles)."""
    s = rows.clone()
    o = float(o)
    for rc, rk in zip((S_E0C, S_E1C, S_E2C, S_ZC), coefs):
        s[:, rc] = s[:, rc] + s[:, rk] * o
    s[:, bb_lo] = s[:, bb_lo] - o
    s[:, bb_hi] = s[:, bb_hi] - o
    if extent is not None:
        out = (s[:, bb_hi] <= 0.0) | (s[:, bb_lo] >= float(extent))
        for c, v in zip(_BBOX, (_BIG, _BIG, -_BIG, -_BIG)):
            s[:, c] = torch.where(out, v, s[:, c])
    return s


def _shift_rows_band(rows: torch.Tensor, y0: int,
                     band_h: int | None = None) -> torch.Tensor:
    """Translate row-major (T, NSETUP) plane-equation setup into band-local
    y: E(px, py - y0) must equal the frame value, so every y-linear
    plane's constant gains B*y0 and the y bboxes move up by y0; with
    band_h, rows wholly outside the band's rows get empty bboxes."""
    return _shift_band(rows, y0, (S_E0B, S_E1B, S_E2B, S_ZB), S_BB_MINY,
                       S_BB_MAXY, band_h)


def _shift_cols_band(rows: torch.Tensor, x0: int,
                     band_w: int | None = None) -> torch.Tensor:
    """The x-axis analogue of _shift_rows_band: E(px - x0, py) — every
    x-linear plane's constant gains A*x0 and the x bboxes move left by
    x0. Both shifts give a 2-D screen tile its local coordinates."""
    return _shift_band(rows, x0, (S_E0A, S_E1A, S_E2A, S_ZA), S_BB_MINX,
                       S_BB_MAXX, band_w)


def _stage(ds, geo, tri_mesh, mask, index=None, **kw):
    """vertex_stage (K15) over corner pools `geo` with ds's per-mesh
    tables."""
    return vertex_stage(
        *(geo[n] for n in _CORNER_NAMES), ds["morph_deltas"], tri_mesh,
        ds["mesh_info"], ds["morph_weights"], ds["world"], ds["normal_mat"],
        ds["joint_matrices"], ds["camera"]["view_proj"], mask, index, **kw)


def _run_vertex(ds, mask, *, rw: int, rh_full: int, needs_clip: bool,
                has_morphs: bool = False, skin_sets: int = 0,
                row_offset: int = 0, shift_rows: bool = False,
                col_offset: int = 0, shift_cols: bool = False,
                band=None, pad: bool = False):
    """Vertex stage over the combined stream (pool + instanced groups) of
    an rw x rh_full frame; shift_rows / shift_cols move the rows into the
    local coordinates of the band (or screen tile) at row_offset /
    col_offset, after the animated-subset split, and band = (band_h,
    band_w), when given, empties the bboxes of rows wholly outside it.
    pad: the rows come padded to a CHUNK multiple (the raster's input,
    ops/raster.py pad_setup_rows), the tail written by the stage's own
    launch.

    The animated-subset split: when the scene has morphs or skins and the
    renderer shipped the animated triangle set (ds["anim_tri_idx"], pool
    indices padded with -1 to a power of two, its live count in
    ds["anim_tri_n"]), the whole pool runs the plain stage and only the
    subset pays the morph and skin sums: a second launch over the
    subset's live count writes its rows over the pool's at anim_idx (and
    at T + anim_idx under clipping), so row j stays triangle j's. The
    subset's rows carry their pool ids in S_ORIG_ID, so a secondary row
    T + t written there carries t (as the reference's). The pads are
    never written."""
    geo, tri_mesh = _combined_geometry(ds)
    kw = dict(width=rw, height=rh_full, needs_clip=needs_clip)
    anim_idx = ds.get("anim_tri_idx") if (has_morphs or skin_sets) else None
    pad_to = CHUNK if pad else 1
    if anim_idx is None:
        rows = _stage(ds, geo, tri_mesh, mask, has_morphs=has_morphs,
                      skin_sets=skin_sets, pad_to=pad_to, **kw)
    else:
        rows = _stage(ds, geo, tri_mesh, mask, pad_to=pad_to, **kw)
        _stage(ds, geo, tri_mesh, mask, anim_idx, out=rows,
               n_index=ds["anim_tri_n"], has_morphs=has_morphs,
               skin_sets=skin_sets, **kw)
    band_h, band_w = band or (None, None)
    if shift_rows:
        rows = _shift_rows_band(rows, row_offset, band_h)
    if shift_cols:
        rows = _shift_cols_band(rows, col_offset, band_w)
    return rows


def _run_vertex_compact(ds, mask, tri_idx, *, rw: int, rh_full: int,
                        needs_clip: bool, row_offset: int = 0,
                        shift_rows: bool = False, has_morphs: bool = False,
                        skin_sets: int = 0):
    """Vertex stage over a compacted triangle set: tri_idx (Nc,) int32
    pool indices, -1 = padding. The overlay buckets hold a few hundred
    triangles of a pool of hundreds of thousands; the stage reads the
    pools at tri_idx (vertex_stage's index) and the rows carry their pool
    ids in S_ORIG_ID, which the fat K7/K8 kernels emit as tri_id. The
    rows come padded to a CHUNK multiple. Instanced geometry never
    reaches it (the renderer passes no index when an overlay mesh is
    instanced)."""
    rows = _stage(ds, ds, ds["tri_mesh"], mask, tri_idx, width=rw,
                  height=rh_full, needs_clip=needs_clip,
                  has_morphs=has_morphs, skin_sets=skin_sets, pad_to=CHUNK)
    return _shift_rows_band(rows, row_offset) if shift_rows else rows


@dataclass(frozen=True)
class FrameSpec:
    """A frame's specialization: the host values that pick its code path,
    under the reference's render_frame / render_frame_temporal keyword
    names. The renderer builds one a frame (renderer.py _frame_spec).

    width / height: the display size; tonemap, bloom, dof, smaa,
    dof_rings (the host-proven active DoF rings, () = the identity, None
    = every ring): the effects and the display. supersample / msaa: the
    opaque stage at 2x2 samples a pixel (K1 at twice the resolution,
    box-resolved; K9, shaded once a pixel and edge-blended). needs_clip,
    has_morphs, skin_sets: the vertex stage's (clipping; the morph and
    skin branches, split to ds["anim_tri_idx"] when the renderer ships
    it). has_uv1 / has_color: the raster's uv1 and vertex-colour planes.
    slot_mask, ext, solid_env, use_mips, has_nearest, light_tiles,
    debug_mode: the shade's (ops/shade.py ShadeSpec; debug_mode "edges"
    is the MSAA frame's coverage view). n_transparent_layers: the peel's
    depth; overlay_slot_mask / overlay_ext: the overlay buckets' own
    masks (None: the opaque bucket's); overlay_crop_y0 / overlay_crop_h:
    the rows the overlay's geometry reaches (renderer._overlay_crop);
    overlay_tile_cap / opaque_tile_cap: the host's covered-tile bounds of
    the compacted peel and of the MSAA frame's compacted shade (None:
    no compaction). shade_cap / alpha: the temporal frame's unit budget
    and history blend (None on the ordinary frame)."""

    width: int
    height: int
    tonemap: ToneMapping
    supersample: bool = False
    msaa: bool = False
    needs_clip: bool = True
    has_morphs: bool = False
    skin_sets: int = 0
    solid_env: bool = False
    has_color: bool = True
    has_uv1: bool = False
    use_mips: bool = True
    slot_mask: tuple = NO_SLOTS
    has_nearest: bool = True
    ext: tuple = NO_EXT
    debug_mode: str = "none"
    n_transparent_layers: int = 4
    overlay_slot_mask: Optional[tuple] = None
    overlay_ext: Optional[tuple] = None
    overlay_crop_y0: Optional[int] = None
    overlay_crop_h: Optional[int] = None
    overlay_tile_cap: Optional[int] = None
    opaque_tile_cap: Optional[int] = None
    bloom: bool = False
    dof: bool = False
    smaa: bool = False
    dof_rings: Optional[tuple] = None
    light_tiles: bool = False
    shade_cap: Optional[int] = None
    alpha: Optional[float] = None

    @property
    def vertex(self) -> dict:
        """_run_vertex's specialization keywords."""
        return dict(needs_clip=self.needs_clip, has_morphs=self.has_morphs,
                    skin_sets=self.skin_sets)

    @cached_property
    def opaque_shade(self) -> ShadeSpec:
        """The opaque bucket's shade, drawing debug_mode's view (the edge
        view never reaches the shade)."""
        return ShadeSpec(
            slot_mask=self.slot_mask, ext=self.ext, solid_env=self.solid_env,
            use_mips=self.use_mips, has_nearest=self.has_nearest,
            light_tiles=self.light_tiles,
            debug_mode=_surface_mode(self.debug_mode))

    @cached_property
    def overlay_shade(self) -> ShadeSpec:
        """The overlay buckets' shade: their own masks where given, else
        the opaque bucket's, and the plain view."""
        return ShadeSpec(
            slot_mask=(self.slot_mask if self.overlay_slot_mask is None
                       else self.overlay_slot_mask),
            ext=self.ext if self.overlay_ext is None else self.overlay_ext,
            solid_env=self.solid_env, use_mips=self.use_mips,
            has_nearest=self.has_nearest, light_tiles=self.light_tiles)


def _opaque_band(ds, opaque_mask, spec: FrameSpec, *, rw: int, band_h: int,
                 rh_full: int, row_offset: int = 0, shift_rows: bool = False,
                 rw_full: int | None = None, col_offset: int = 0,
                 shift_cols: bool = False, hooks=None):
    """Opaque geometry + deferred shade over one (band_h, rw) band of the
    padded rw_full x rh_full framebuffer, starting at row_offset /
    col_offset (the whole frame: band_h = rh_full, rw_full None, offsets
    0) -> (hdr [r,g,b,a] (band_h*rw,) planes, tri_id, depth (band_h,
    rw), raster bins). shift_rows / shift_cols put the setup rows in the
    band's local coordinates (the sharded frame). An after_geometry hook
    gets the raster's planes (without the bins) and returns the planes
    that are shaded and whose tri_id and depth the frame keeps."""
    with span("render_frame/vertex"):
        srows = _run_vertex(
            ds, opaque_mask, rw=rw_full or rw, rh_full=rh_full,
            row_offset=row_offset, shift_rows=shift_rows,
            col_offset=col_offset, shift_cols=shift_cols,
            band=(band_h, rw), pad=True, **spec.vertex)
    # uv1 / vertex-colour planes only when a material samples uv1 or a
    # mesh carries colours; no analytic derivatives: the mip gradients
    # are screen differences of the band's padded uv0 planes, as in the
    # reference
    with span("render_frame/raster"):
        vis = rasterize16(srows, width=rw, height=band_h,
                          has_uv1=spec.has_uv1, has_color=spec.has_color,
                          analytic_derivs=False)
        bins = vis.pop("bins")
    if getattr(hooks, "after_geometry", None):
        vis = hooks.after_geometry(vis, ds)
    with span("render_frame/shade"):
        hdr_ch = shade_deferred_c(
            vis, ds, spec.opaque_shade, width=rw, height=band_h,
            height_full=rh_full, row_offset=row_offset, width_full=rw_full,
            col_offset=col_offset)
    return hdr_ch, vis["tri_id"], vis["depth"], bins


def _opaque_band_msaa(ds, opaque_mask, spec: FrameSpec, *, rw2: int,
                      rh2: int, rw1: int, rh1: int,
                      band1_h: int | None = None, row_offset1: int = 0,
                      shift_rows: bool = False, hooks=None):
    """MSAA-4x opaque stage: coverage and depth at 2x2 samples per display
    pixel (K9 over the vertex stage at twice the resolution, rw2 x rh2),
    shading once per display pixel at its top-left sample (K2 with
    coord_scale 2), covered-tile compacted when the host cap
    spec.opaque_tile_cap bounds the covered (OPAQUE_TILE_ROWS, 128) units
    below the band. The "edges" view skips shading: white where a pixel's
    4 samples disagree, dim grey on interior coverage, black on a miss.
    An after_geometry hook gets the resolved planes of the shading
    samples, with depth, and turns the compaction off (it sees full-frame
    planes); the sample planes stay the raster's.

    band1_h (None: rh1, the whole frame) display rows starting at display
    row row_offset1: K9 rasterizes the band's 2 * band1_h sample rows;
    shift_rows puts the setup in the band's coordinates (the sharded
    frame), so K2 resolves at band-local rows. The compaction is the
    whole frame's only (the sharded frame's spec has no tile cap).

    Returns (hdr [r, g, b, a] (band1_h*rw1,) planes, samp = 4x (band1_h,
    rw1) sample-id planes [tl, tr, bl, br], depth1 (band1_h, rw1), K9's
    bins)."""
    band1_h = rh1 if band1_h is None else band1_h
    with span("render_frame/vertex"):
        srows = _run_vertex(
            ds, opaque_mask, rw=rw2, rh_full=rh2, row_offset=2 * row_offset1,
            shift_rows=shift_rows, band=(2 * band1_h, rw2), pad=True,
            **spec.vertex)
    w_half = rw2 // 2

    def fit_cols(p, fill):
        if w_half >= rw1:
            return p[:, :rw1]
        pad = torch.full((p.shape[0], rw1 - w_half), fill, dtype=p.dtype,
                         device=p.device)
        return torch.cat([p, pad], dim=1)

    with span("render_frame/raster"):
        samp_raw, depth1_raw, bins = rasterize16_msaa(srows, width2=rw2,
                                                      height2=2 * band1_h)
        samp = [fit_cols(p, -1) for p in samp_raw]
        depth1 = fit_cols(depth1_raw, 1.0)
    with span("render_frame/shade"):
        P = band1_h * rw1
        rep = samp[0].reshape(P)
        if spec.debug_mode == "edges":
            edge = ((samp[1] != samp[0]) | (samp[2] != samp[0])
                    | (samp[3] != samp[0])).reshape(P)
            v = torch.where(edge, 1.0, torch.where(rep >= 0, 0.15, 0.0))
            return [v, v, v, (rep >= 0).float()], samp, depth1, bins

        # covered-tile compaction (shade.py shade_deferred_compact_c): an
        # image environment fills the skipped units' sky from its
        # texel-pool rows. rh1 and rw1 are TILE_H- and TILE_W-multiples (8,
        # 128), so the reference's layout conditions (frame.py:751-756)
        # reduce to this gate
        tile_cap = spec.opaque_tile_cap
        if (tile_cap is not None and (spec.solid_env or "env_pool_base" in ds)
                and tile_cap * OPAQUE_TILE_ROWS * 128 < P
                and not getattr(hooks, "after_geometry", None)):
            hdr_ch = shade_deferred_compact_c(
                rep, srows, depth1.reshape(P), ds, spec.opaque_shade,
                width=rw1, height=rh1, tile_cap=tile_cap)
            return hdr_ch, samp, depth1, bins

        vis = resolve_planes_fused(
            rep, srows, width=rw1,
            row_offset=0 if shift_rows else row_offset1, coord_scale=2)
        vis = {k: vis[k] for k in RESOLVE_NAMES}
        vis["depth"] = depth1.reshape(P)
    if getattr(hooks, "after_geometry", None):
        vis = hooks.after_geometry(vis, ds)
    with span("render_frame/shade"):
        hdr_ch = shade_deferred_c(
            vis, ds, spec.opaque_shade, width=rw1, height=band1_h,
            height_full=rh1, row_offset=row_offset1)
    return hdr_ch, samp, depth1, bins


def _msaa_edge_blend(hdr_ch, samp, H: int, W: int):
    """Per-sample MSAA resolve in image space: each of a pixel's 4
    coverage samples takes the shaded colour of the pixel whose winner
    matches it — its own when the ids agree, otherwise the nearest
    neighbour toward the sample's quadrant (axis neighbours first, then
    the diagonal; else its own) — and the 4 average. Rolls and
    selects, as the reference (wrapping at the borders)."""
    rep = samp[0]
    imgs = [c.reshape(H, W) for c in hdr_ch]
    acc = [torch.zeros_like(imgs[0]) + im for im in imgs]   # ts == rep
    for s_idx, (i, j) in enumerate(((0, 1), (1, 0), (1, 1)), start=1):
        ts = samp[s_idx]
        dy = -1 if i == 0 else 1
        dx = -1 if j == 0 else 1
        chosen = list(imgs)
        found = ts == rep
        for oy, ox in ((0, dx), (dy, 0), (dy, dx)):
            ntid = torch.roll(rep, (-oy, -ox), dims=(0, 1))  # value at p+o
            m = (~found) & (ntid == ts)
            chosen = [torch.where(m, torch.roll(im, (-oy, -ox), dims=(0, 1)),
                                  c) for im, c in zip(imgs, chosen)]
            found = found | m
        acc = [a + c for a, c in zip(acc, chosen)]
    return [(a * 0.25).reshape(H * W) for a in acc]


def _resolve_supersample(hdr_ch, tri_id, depth, *, width: int, height: int,
                         rw2: int, rw1: int, rh1: int):
    """2x2 box resolve of the supersampled opaque HDR to display
    resolution, re-padded onto the 1x grid: the mean of the HDR, the min
    of the depth (conservative for the transparent peel), the top-left
    sample's tri_id; pads tri_id -1, depth 0.0."""
    h2, w2 = height * 2, width * 2
    hdr_ch = [c.reshape(-1, rw2)[:h2, :w2].reshape(height, 2, width, 2)
              .mean(dim=(1, 3)) for c in hdr_ch]
    tri_id = tri_id[:h2:2, :w2:2]
    depth = depth[:h2, :w2].reshape(height, 2, width, 2).amin(dim=(1, 3))
    pad = (0, rw1 - width, 0, rh1 - height)
    hdr_ch = [torch.nn.functional.pad(c, pad).reshape(rh1 * rw1)
              for c in hdr_ch]
    tri_id = torch.nn.functional.pad(tri_id, pad, value=-1)
    depth = torch.nn.functional.pad(depth, pad)
    return hdr_ch, tri_id, depth


def _overlay_band(hdr_ch, tri_id, depth, ds, transparent_mask, hud_mask,
                  spec: FrameSpec, *, rw: int, band_h: int, rh_full: int,
                  row_offset: int = 0, shift_rows: bool = False,
                  rw_full: int | None = None, col_offset: int = 0,
                  shift_cols: bool = False, ov_tri_idx=None, hooks=None):
    """Transparent forward peel + HUD over the shaded opaque band
    (reference: frame.py _overlay_band), shaded with spec.overlay_shade.
    ov_tri_idx is the overlay's compacted triangle pool
    (renderer._overlay_tri_idx), or None for the full combined pool (an
    overlay mesh is instanced, or the sharded frame). The band is
    (band_h, rw) at row_offset / col_offset of an rw_full x rh_full frame,
    its setup shifted into local coordinates with shift_rows /
    shift_cols; a compacted pool takes row bands only. transparent_mask /
    hud_mask None skip their pass. The before_transparent /
    after_transparent hooks run before and after the transparent pass on
    the (band_h, rw, 4) image. Returns (hdr_ch, tri_id)."""
    shade = spec.overlay_shade
    # ---- row-band crop: the overlay runs only on the rows its geometry's
    # projected AABBs reach (renderer._overlay_crop); off with volume
    # refraction, which gathers the opaque image outside the band, and
    # with the overlay hooks, which see the whole image
    crop_h = spec.overlay_crop_h
    if (crop_h is not None and not shift_rows and crop_h < band_h
            and not shade.ext[EXT_VOLUME]
            and not (getattr(hooks, "before_transparent", None)
                     or getattr(hooks, "after_transparent", None))):
        y0 = spec.overlay_crop_y0
        hdr_c = [c.reshape(band_h, rw)[y0:y0 + crop_h].reshape(-1)
                 for c in hdr_ch]
        hdr_c, tri_c = _overlay_band(
            hdr_c, tri_id[y0:y0 + crop_h], depth[y0:y0 + crop_h], ds,
            transparent_mask, hud_mask, spec, rw=rw, band_h=crop_h,
            rh_full=rh_full, row_offset=y0, shift_rows=True,
            ov_tri_idx=ov_tri_idx)
        out = []
        for full, band in zip(hdr_ch, hdr_c):
            full = full.reshape(band_h, rw).clone()
            full[y0:y0 + crop_h] = band.reshape(crop_h, rw)
            out.append(full.reshape(-1))
        tri_id = tri_id.clone()
        tri_id[y0:y0 + crop_h] = tri_c
        return out, tri_id

    if ov_tri_idx is not None and shift_cols:
        raise ValueError("compacted overlay pools are 1-D only")

    def run_vertex(mask):
        if ov_tri_idx is not None:
            return _run_vertex_compact(ds, mask, ov_tri_idx, rw=rw,
                                       rh_full=rh_full, row_offset=row_offset,
                                       shift_rows=shift_rows, **spec.vertex)
        return _run_vertex(ds, mask, rw=rw_full or rw, rh_full=rh_full,
                           row_offset=row_offset, shift_rows=shift_rows,
                           col_offset=col_offset, shift_cols=shift_cols,
                           band=(band_h, rw), pad=True, **spec.vertex)

    # the compacted peel's shade takes row bands only (the sharded frame
    # passes no tile_cap)
    cols_kw = dict(width_full=rw_full, col_offset=col_offset)
    rows_kw = dict(height_full=rh_full, row_offset=row_offset)
    planes_kw = dict(has_uv1=spec.has_uv1, has_color=spec.has_color)
    K = spec.n_transparent_layers
    tile_cap = spec.overlay_tile_cap

    def stack(ch):
        return torch.stack(ch, dim=-1).reshape(band_h, rw, 4)

    def unstack(img):
        flat = img.reshape(band_h * rw, 4)
        return [flat[:, c].contiguous() for c in range(4)]

    if getattr(hooks, "before_transparent", None):
        hdr_ch = unstack(hooks.before_transparent(stack(hdr_ch), depth, ds))

    # ---- transparent forward pass: K-layer depth peel under the shared,
    # read-only opaque depth; back-to-front composite ---------------------
    if transparent_mask is not None:
        t_rows = run_vertex(transparent_mask)
        n_t32 = (-(-band_h // BT_H)) * (rw // BT_W)
        # covered-tile compaction of the whole peel + shade when the host
        # cap bounds the transparent tiles below the band (not with volume
        # refraction, which gathers the opaque image at arbitrary pixels)
        if (tile_cap is not None and not shade.ext[EXT_VOLUME]
                and min(tile_cap, n_t32) * BT_H * BT_W < band_h * rw):
            layers_c, t_idx, ntx32 = rasterize_layers_compact(
                t_rows, depth, width=rw, height=band_h, n_layers=K,
                tile_cap32=tile_cap, **planes_kw)
            hdr_ch = shade_transparent_compact32(
                layers_c, t_idx, hdr_ch, ds, shade, width=rw, height=band_h,
                n_tx=ntx32, n_layers=K, **rows_kw)
        else:
            # analytic uv derivatives here too, as the compacted peel: the
            # tile cap can toggle with camera motion, and screen
            # differencing here would make mip selection pop
            layers = rasterize_layers_rows(
                t_rows, depth, width=rw, height=band_h, n_layers=K,
                analytic_derivs=True, **planes_kw)
            hdr_ch = shade_transparent_layers_c(
                layers, hdr_ch, ds, shade, width=rw, height=band_h,
                n_layers=K, **cols_kw, **rows_kw)

    if getattr(hooks, "after_transparent", None):
        hdr_ch = unstack(hooks.after_transparent(stack(hdr_ch), ds))

    # ---- HUD pass: its own cleared depth, composited on top -------------
    if hud_mask is not None:
        h_rows = run_vertex(hud_mask)
        if ov_tri_idx is not None:
            # the compacted pool breaks K2's row index == pool id
            # invariant, so the HUD takes K7, which reads the ids from
            # S_ORIG_ID
            h_vis = rasterize(h_rows, width=rw, height=band_h,
                              analytic_derivs=False, **planes_kw)
        else:
            # the full pool keeps it: K1 + K2, as the opaque pass
            h_vis = rasterize16(h_rows, width=rw, height=band_h,
                                analytic_derivs=False, **planes_kw)
            del h_vis["bins"]
        P = rw * band_h
        h_planes = {k: v.reshape(P) for k, v in h_vis.items()}
        h_color, h_alpha, h_valid = shade_surface(
            h_planes, ds, shade, width=rw, height=band_h, **cols_kw,
            **rows_kw)
        a = torch.where(h_valid, h_alpha, torch.zeros_like(h_alpha))
        out = [torch.where(h_valid, h_color[c] * a + hdr_ch[c] * (1 - a),
                           hdr_ch[c]) for c in range(3)]
        out.append(torch.where(h_valid, torch.maximum(hdr_ch[3], a),
                               hdr_ch[3]))
        hdr_ch = out
        tri_id = torch.where(h_vis["tri_id"] >= 0, h_vis["tri_id"], tri_id)
    return hdr_ch, tri_id


def _finish_frame(hdr_ch, tri_id, depth, ds, spec: FrameSpec, *, rw: int,
                  rh: int, hooks=None):
    """Crop the padding, then the effects chain at display resolution on
    channel planes: bloom, depth of field (over spec.dof_rings), the
    tonemap + sRGB display pass, SMAA on the display image; stack to (H,
    W, 4); the last_pass hook; tri_id to picking ids in triangle-pool
    space (clipping doubles the rows)."""
    width, height, dof_rings = spec.width, spec.height, spec.dof_rings
    with span("render_frame/display"):
        hdr_ch = [c.reshape(rh, rw)[:height, :width] for c in hdr_ch]
        tri_id = tri_id[:height, :width]
        depth = depth[:height, :width]
    rgb = hdr_ch[:3]
    dof = spec.dof and dof_rings != ()
    if spec.bloom or dof:
        with span("render_frame/effects"):
            if spec.bloom:
                rgb = bloom_c(rgb)
            if dof:
                rgb = depth_of_field_c(
                    rgb, depth, ds["camera"],
                    rings=DOF_RING_SCALES if dof_rings is None else dof_rings)
    with span("render_frame/display"):
        ldr_ch = display_pass_c(list(rgb) + hdr_ch[3:], spec.tonemap)
    if spec.smaa:
        with span("render_frame/effects"):
            ldr_ch = smaa_c(ldr_ch[:3]) + ldr_ch[3:]
    with span("render_frame/display"):
        ldr = torch.stack(ldr_ch, dim=-1)
        if getattr(hooks, "last_pass", None):
            ldr = hooks.last_pass(ldr, ds)
        T_pool = _total_triangles(ds)
        tri_id = torch.where(tri_id >= 0, tri_id % T_pool, -1)
    return ldr, tri_id, depth


def _frame_band(ds, opaque_mask, transparent_mask, hud_mask,
                spec: FrameSpec, *, rw: int, band_h: int, rh_full: int,
                row_offset: int = 0, shift_rows: bool = False,
                rw_full: int | None = None, col_offset: int = 0,
                shift_cols: bool = False):
    """Single-scale band pipeline (reference: frame.py _frame_band): the
    opaque stage and the overlay at the same resolution over one (band_h,
    rw) band (or screen tile) of the padded frame. Returns (hdr_ch
    planes, tri_id, depth (band_h, rw)); the overlay runs over the full
    combined pool."""
    band = dict(rw=rw, band_h=band_h, rh_full=rh_full, row_offset=row_offset,
                shift_rows=shift_rows, rw_full=rw_full, col_offset=col_offset,
                shift_cols=shift_cols)
    hdr_ch, tri_id, depth, _bins = _opaque_band(ds, opaque_mask, spec,
                                                **band)
    hdr_ch, tri_id = _overlay_band(hdr_ch, tri_id, depth, ds,
                                   transparent_mask, hud_mask, spec, **band)
    return hdr_ch, tri_id, depth


def _frame_tail(hdr_ch, tri_id, depth, ds, transparent_mask, hud_mask,
                spec: FrameSpec, *, rw: int, rh: int, overlay_tri_idx,
                hooks):
    """The overlay over the padded rw x rh frame, when it runs (a bucket
    has content or an overlay hook is set: the hooks fire on a frame
    without overlay content), then _finish_frame -> (ldr, tri_id,
    depth)."""
    if (transparent_mask is not None or hud_mask is not None
            or getattr(hooks, "before_transparent", None)
            or getattr(hooks, "after_transparent", None)):
        with span("render_frame/overlay"):
            hdr_ch, tri_id = _overlay_band(
                hdr_ch, tri_id, depth, ds, transparent_mask, hud_mask, spec,
                rw=rw, band_h=rh, rh_full=rh, ov_tri_idx=overlay_tri_idx,
                hooks=hooks)
    return _finish_frame(hdr_ch, tri_id, depth, ds, spec, rw=rw, rh=rh,
                         hooks=hooks)


def render_frame(ds, opaque_mask, transparent_mask=None, hud_mask=None, *,
                 spec: FrameSpec, overlay_tri_idx=None, hooks=None):
    """Returns (display rgba (H, W, 4) f32 in [0, 1], tri_id (H, W) int32
    in triangle-pool space (-1 = miss), depth (H, W) f32, raster bins).

    transparent_mask / hud_mask: (M,) bool device masks of the overlay
    buckets, or None when a bucket is empty; spec: the frame's
    specialization (FrameSpec). The overlay runs over its compacted
    triangle pool, overlay_tri_idx, or over the full combined pool when
    it is None (an overlay mesh is instanced). With spec.msaa the opaque
    stage runs at 2x2 samples per pixel (K9), shaded once per pixel and
    edge-blended; with spec.supersample at twice the resolution (K1),
    box-resolved before the overlay. The overlay always runs at display
    resolution over the resolved depth. hooks: a RenderHooks whose
    in-frame callbacks run here (pre_render / post_render are the
    renderer's)."""
    if spec.supersample and spec.msaa:
        raise ValueError("pick one AA mode: supersample or msaa")
    ds = _first_pass(ds, hooks)
    width, height = spec.width, spec.height
    rw1 = _pad_to(width, TILE_W)
    rh1 = _pad_to(height, TILE_H)
    if spec.msaa:
        hdr_ch, samp, depth, bins = _opaque_band_msaa(
            ds, opaque_mask, spec, rw2=_pad_to(width * 2, TILE_W),
            rh2=2 * rh1, rw1=rw1, rh1=rh1, hooks=hooks)
        if spec.debug_mode != "edges":    # keep the edge view crisp
            with span("render_frame/resolve"):
                hdr_ch = _msaa_edge_blend(hdr_ch, samp, rh1, rw1)
        tri_id = samp[0]
    else:
        scale = 2 if spec.supersample else 1
        rw2 = _pad_to(width * scale, TILE_W)
        rh2 = _pad_to(height * scale, TILE_H)
        hdr_ch, tri_id, depth, bins = _opaque_band(
            ds, opaque_mask, spec, rw=rw2, band_h=rh2, rh_full=rh2,
            hooks=hooks)
        if spec.supersample:
            # resolve BEFORE the overlay: the peel and HUD then run at
            # display resolution, over the resolved depth
            with span("render_frame/resolve"):
                hdr_ch, tri_id, depth = _resolve_supersample(
                    hdr_ch, tri_id, depth, width=width, height=height,
                    rw2=rw2, rw1=rw1, rh1=rh1)
    ldr, tri_id, depth = _frame_tail(
        hdr_ch, tri_id, depth, ds, transparent_mask, hud_mask, spec, rw=rw1,
        rh=rh1, overlay_tri_idx=overlay_tri_idx, hooks=hooks)
    return ldr, tri_id, depth, bins


def render_frame_temporal(ds, opaque_mask, transparent_mask, hud_mask, hist,
                          age, *, spec: FrameSpec, overlay_tri_idx=None,
                          hooks=None):
    """Temporal-reuse frame (TAA; reference: frame.py
    render_frame_temporal): shade only what the previous frame cannot
    answer for. hist (5, rh1, rw1) f32 history [r, g, b, tid bits,
    depth]; age (n_units,) int32 frames since each (8, 128) unit shaded;
    spec.shade_cap the host's unit budget C, spec.alpha the history
    blend. Per frame:

      1. K1 at display resolution with the jittered camera (ids + depth);
      2. reprojection offsets through the unjittered current and previous
         matrices, then K10 (validity by winner id and depth);
      3. select_units picks C units; their ids and depths are gathered
         (index_select over _tile_swizzle), shaded (shade_units_c,
         coord_scale 1) and scattered back (index_copy, _tile_unswizzle);
      4. temporal_merge (3x3-clamped blend); new_age = 0 on the shaded
         units, age + 1 elsewhere;
      5. the overlay, effects and display as render_frame.

    C comes from the host, so no step reads a device value on the host.
    hooks: the overlay hooks and last_pass run as in render_frame; the
    opaque-stage hooks (first_pass, after_geometry) and the debug views
    are refused, and the renderer sends such a frame to render_frame.
    Returns (ldr, tri_id, depth, new_hist, new_age)."""
    if (getattr(hooks, "first_pass", None)
            or getattr(hooks, "after_geometry", None)):
        raise ValueError("the temporal frame takes no opaque-stage hooks")
    if spec.debug_mode != "none":
        raise ValueError("the temporal frame takes no debug view")
    rw1 = _pad_to(spec.width, TILE_W)
    rh1 = _pad_to(spec.height, TILE_H)
    U = OPAQUE_TILE_ROWS * 128
    n_units = (rh1 // OPAQUE_TILE_ROWS) * (rw1 // 128)

    # ---- 1. slim geometry (jittered camera) -------------------------------
    with span("render_frame/vertex"):
        srows = _run_vertex(ds, opaque_mask, rw=rw1, rh_full=rh1, pad=True,
                            **spec.vertex)
    with span("render_frame/raster"):
        col, depth, _bins = rasterize16_slim(srows, width=rw1, height=rh1)

    # ---- 2. reproject + validate (unjittered matrices) ---------------------
    with span("render_frame/resolve"):
        off_x, off_y, exp_z = temporal_offsets(ds["camera"], depth,
                                               width=rw1, height=rh1)
        rep_r, rep_g, rep_b, valid, blendable = reproject_history(
            hist, off_x, off_y, exp_z, col, width=rw1, height=rh1)

    # ---- 3. shade the budgeted unit set ------------------------------------
    with span("render_frame/shade"):
        idx, shaded_unit = select_units(valid, age, width=rw1, height=rh1,
                                        shade_cap=spec.shade_cap)
        C = idx.shape[0]
        tid_c = _tile_swizzle(col, rh1, rw1).index_select(0, idx).reshape(
            C * U)
        dep_c = _tile_swizzle(depth, rh1, rw1).index_select(0, idx).reshape(
            C * U)
        out_c, _valid_c = shade_units_c(
            tid_c, dep_c, idx, srows, ds, spec.opaque_shade, width=rw1,
            height=rh1, coord_scale=1)
        new_ch = [_tile_unswizzle(
            torch.zeros((n_units, U), device=col.device).index_copy(
                0, idx, out_c[c].reshape(C, U)), rh1, rw1) for c in range(3)]
        shaded_px = _tile_unswizzle(shaded_unit[:, None].expand(n_units, U),
                                    rh1, rw1)

    # ---- 4. temporal resolve + new history ---------------------------------
    with span("render_frame/resolve"):
        merged, new_hist, cov = temporal_merge(
            new_ch, shaded_px, [rep_r, rep_g, rep_b], valid, blendable, hist,
            col, depth, width=rw1, height=rh1, alpha=spec.alpha)
        new_age = torch.where(shaded_unit, 0, age + 1)

    # ---- 5. overlay + effects + display (as render_frame) ------------------
    ldr, tri_id, depth2 = _frame_tail(
        merged + [cov], col.reshape(rh1, rw1), depth.reshape(rh1, rw1), ds,
        transparent_mask, hud_mask, spec, rw=rw1, rh=rh1,
        overlay_tri_idx=overlay_tri_idx, hooks=hooks)
    return ldr, tri_id, depth2, new_hist, new_age
