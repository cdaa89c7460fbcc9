"""Vertex stage: morph -> skin -> world -> clip -> near-plane clip ->
plane-equation setup.

Port of awsm_renderer_tpu/ops/vertex.py: per-triangle mesh/transform
fetches, morph targets (one gather of every target's deltas per corner
and a weighted sum over the weights table's width), skins (one gather of
every influence's joint matrix per corner and a weighted sum), corner
transform, 2-slot near-plane clipping and the v4 plane-equation setup
rows. vertex_stage_chain runs it op by op on flat (T,) component tensors
(the camera matrix enters as Python floats, the per-mesh tables through
index_select). vertex_stage, what the frame calls, runs it in one launch
of K15 (csrc/vertex.cu) on a CUDA tensor and in its plain twin,
vertex_stage_reference (the chain's math on K15's inputs), on a CPU
tensor.

Output: row-major (T, NSETUP) f32 setup — (2T, NSETUP) with clipping,
where row t is triangle t's primary piece and row T+t its secondary clip
piece. Row j carries S_ORIG_ID == j; a compacted pool (orig_ids, or
vertex_stage's index) carries its pool ids instead, on the secondary
pieces too.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.meshes import (
    MESH_FLAG_DOUBLE_SIDED, MI_FLAGS, MI_MATERIAL_ROW, MI_MORPH_STRIDE,
    MI_N_MORPH_TARGETS, MI_SKIN_SETS, MI_TRANSFORM_ROW,
)
from . import kernels

# ---- setup row indices (row-major (T, NSETUP)) — see the JAX module's
# comment for the plane-equation layout and its watertightness argument
S_E0A, S_E0B, S_E0C = 0, 1, 2
S_E1A, S_E1B, S_E1C = 3, 4, 5
S_E2A, S_E2B, S_E2C = 6, 7, 8
S_ZA, S_ZB, S_ZC = 9, 10, 11
S_IW0, S_IW1, S_IW2 = 12, 13, 14
S_BB_MINX, S_BB_MINY, S_BB_MAXX, S_BB_MAXY = 15, 16, 17, 18
S_MAT_ROW = 19
S_TANGENT_W = 20
S_UV0 = 21
S_UV1 = 27
S_COLOR = 33
S_NORMAL = 45
S_TANGENT = 54
S_ORIG_ID = 63
NSETUP = 64

# per-corner attribute channels: uv0.uv, uv1.uv, color.rgba, normal.xyz,
# tangent.xyz, tangent.w
NA = 15

_Z_EPS = 1e-6
_BIG = 3.0e38


def onehot_gather(rows: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """table[rows] with zero rows where `rows` is outside [0, cap) — what
    the reference's one-hot matmul returns. rows (N,) int, table (cap, K)."""
    cap = table.shape[0]
    ok = (rows >= 0) & (rows < cap)
    g = table.index_select(0, rows.clamp(0, cap - 1).long())
    return torch.where(ok[:, None], g, torch.zeros((), dtype=g.dtype,
                                                   device=g.device))


def _gather_cols(geo, tri_idx):
    """Compacted corner pools: the columns tri_idx of each (C, T) pool in
    `geo`, by flat row-major indices c*T + idx (the gather is
    output-sized); -1 pads read column 0. Returns them and the clamped
    int64 indices."""
    safe = tri_idx.clamp(min=0).long()

    def cols(a):
        cdim, t = a.shape
        gidx = (torch.arange(cdim, device=a.device)[:, None] * t
                + safe[None, :])
        return a.reshape(cdim * t)[gidx.reshape(-1)].reshape(cdim, -1)

    return {n: cols(a) for n, a in geo.items()}, safe


def pad_rows(rows: torch.Tensor, multiple: int) -> torch.Tensor:
    """Pad row-major setup (T, NSETUP) to a multiple of `multiple` rows
    with invalid triangles (empty bboxes; their edge constant 0 with zero
    A/B covers nothing once the bbox test drops them from every bin)."""
    T = rows.shape[0]
    pad = (-T) % multiple
    if pad == 0:
        return rows
    tail = torch.zeros((pad, rows.shape[1]), dtype=rows.dtype,
                       device=rows.device)
    tail[:, S_BB_MINX] = _BIG
    tail[:, S_BB_MINY] = _BIG
    tail[:, S_BB_MAXX] = -_BIG
    tail[:, S_BB_MAXY] = -_BIG
    return torch.cat([rows, tail], dim=0)


def _corner_comps(arr, C):
    """(3C, T) component-major array -> [corner][component] lists of (T,)."""
    return [[arr[c * C + k] for k in range(C)] for c in range(3)]


def _mat4_point(m, p):
    """(T, 16) row-major matrices times points (x, y, z, 1)."""
    x, y, z = p
    return [m[:, 4 * j] * x + m[:, 4 * j + 1] * y + m[:, 4 * j + 2] * z
            + m[:, 4 * j + 3] for j in range(4)]


def _mat3_vec(m, v):
    """(T, 9) row-major 3x3 matrices times vectors (x, y, z)."""
    x, y, z = v
    return [m[:, 3 * j] * x + m[:, 3 * j + 1] * y + m[:, 3 * j + 2] * z
            for j in range(3)]


def _const_mat4(vp, p):
    """Constant 4x4 matrix (nested Python floats) times [x, y, z, w]."""
    return [vp[j][0] * p[0] + vp[j][1] * p[1] + vp[j][2] * p[2]
            + vp[j][3] * p[3] for j in range(4)]


def finish_setup(corners, attrs, act, mat_row, flags, width: int,
                 height: int, id_offset: int = 0,
                 orig_ids=None) -> torch.Tensor:
    """Screen-map one output triangle set -> (T, NSETUP) setup rows.

    corners: [c][x,y,z,w] clip-space (T,); attrs: [c][ch] of NA (T,)
    channels; act: (T,) bool; flags: (T,) int mesh flags; orig_ids:
    (T,) int pool ids of a compacted pool, written to S_ORIG_ID in place
    of the row index."""
    double_sided = (flags & MESH_FLAG_DOUBLE_SIDED) != 0
    w = [corners[c][3] for c in range(3)]
    iw = [1.0 / torch.where(torch.abs(wc) > 1e-20, wc,
                            torch.full_like(wc, 1e-20)) for wc in w]
    sx = [(corners[c][0] * iw[c] * 0.5 + 0.5) * width for c in range(3)]
    sy = [(0.5 - corners[c][1] * iw[c] * 0.5) * height for c in range(3)]
    z = [corners[c][2] * iw[c] for c in range(3)]

    # front faces are CW in y-down screen space (negative area): swap
    # corners 1<->2 so the rasterizer always sees positive orientation
    area2 = ((sx[1] - sx[0]) * (sy[2] - sy[0])
             - (sx[2] - sx[0]) * (sy[1] - sy[0]))
    front = area2 < 0.0
    keep = (front | double_sided) & act & (torch.abs(area2) > 1e-12)

    def swp(a1, a2):
        return torch.where(front, a2, a1), torch.where(front, a1, a2)

    sx[1], sx[2] = swp(sx[1], sx[2])
    sy[1], sy[2] = swp(sy[1], sy[2])
    z[1], z[2] = swp(z[1], z[2])
    iw[1], iw[2] = swp(iw[1], iw[2])
    a1, a2 = [], []
    for ch in range(NA):
        v1, v2 = swp(attrs[1][ch], attrs[2][ch])
        a1.append(v1)
        a2.append(v2)
    attrs = [attrs[0], a1, a2]

    W, H = float(width), float(height)

    def lo3(a):
        return torch.minimum(torch.minimum(a[0], a[1]), a[2])

    def hi3(a):
        return torch.maximum(torch.maximum(a[0], a[1]), a[2])

    bb_minx = torch.clamp(lo3(sx), 0.0, W)
    bb_maxx = torch.clamp(hi3(sx), 0.0, W)
    bb_miny = torch.clamp(lo3(sy), 0.0, H)
    bb_maxy = torch.clamp(hi3(sy), 0.0, H)
    on_screen = (bb_maxx > bb_minx) & (bb_maxy > bb_miny)
    zmin = lo3(z)
    zmax = hi3(z)
    w_ok = (w[0] > 0.0) & (w[1] > 0.0) & (w[2] > 0.0)
    valid = keep & on_screen & w_ok & (zmax >= 0.0) & (zmin <= 1.0)
    big = torch.full_like(bb_minx, _BIG)
    bb_minx = torch.where(valid, bb_minx, big)
    bb_miny = torch.where(valid, bb_miny, big)
    bb_maxx = torch.where(valid, bb_maxx, -big)
    bb_maxy = torch.where(valid, bb_maxy, -big)

    T = area2.shape[0]
    if orig_ids is None:
        orig_id = (torch.arange(T, dtype=torch.float32, device=area2.device)
                   + float(id_offset))
    else:
        # compacted pools (the overlay buckets) carry their pool ids, clip
        # copies included: the fat kernels read ids from S_ORIG_ID
        orig_id = orig_ids.to(torch.float32)

    # edge i is opposite corner i; A, B exact-negation-symmetric with the
    # neighbour sharing the edge, C anchored at the edge's canonical
    # endpoint (smaller (y, x)) so it negates exactly too
    ea = [sy[1] - sy[2], sy[2] - sy[0], sy[0] - sy[1]]
    eb = [sx[2] - sx[1], sx[0] - sx[2], sx[1] - sx[0]]

    def _edge_c(k, i, j):
        lt = (sy[i] < sy[j]) | ((sy[i] == sy[j]) & (sx[i] <= sx[j]))
        ax = torch.where(lt, sx[i], sx[j])
        ay = torch.where(lt, sy[i], sy[j])
        return -(ea[k] * ax + eb[k] * ay)

    ec = [_edge_c(0, 1, 2), _edge_c(1, 2, 0), _edge_c(2, 0, 1)]
    ec[0] = torch.where(valid, ec[0], -big)      # invalid -> never covers

    # affine NDC z-plane: z(px, py) = ZA*px + ZB*py + ZC
    area_pos = torch.where(front, -area2, area2)
    inv_area = 1.0 / torch.where(torch.abs(area_pos) > 1e-30, area_pos,
                                 torch.ones_like(area_pos))
    za = (z[0] * ea[0] + z[1] * ea[1] + z[2] * ea[2]) * inv_area
    zb = (z[0] * eb[0] + z[1] * eb[1] + z[2] * eb[2]) * inv_area
    zc = (z[0] * ec[0] + z[1] * ec[1] + z[2] * ec[2]) * inv_area

    rows = [ea[0], eb[0], ec[0], ea[1], eb[1], ec[1], ea[2], eb[2], ec[2],
            za, zb, zc, iw[0], iw[1], iw[2],
            bb_minx, bb_miny, bb_maxx, bb_maxy,
            mat_row, attrs[0][14]]
    for ch in range(14):
        rows += [attrs[0][ch], attrs[1][ch], attrs[2][ch]]
    rows.append(orig_id)
    return torch.stack(rows, dim=-1)                       # (T, NSETUP)


def _morph(pos, nrm, tan, c_morph_base, morph_deltas, morph_weights,
           minfo, mesh, ordered: bool = False):
    """Add each corner's weighted morph deltas to its position, normal and
    tangent xyz in place (reference: shared_wgsl/vertex/morph.wgsl).
    Target m of a corner reads delta row base + m * stride, for m below
    the mesh's target count and base >= 0; the weights table's width B
    bounds m. One gather of (3, B, T) rows and one sum over B, whatever
    B is; ordered: K15's order instead, target by target, each live one
    added in turn (up to the largest target count). Tangent w is never
    morphed (the deltas carry xyz only)."""
    T = mesh.shape[0]
    B = morph_weights.shape[1]
    dev = mesh.device
    n_targets = minfo[:, MI_N_MORPH_TARGETS].long()
    stride = minfo[:, MI_MORPH_STRIDE].long()
    wts = onehot_gather(mesh, morph_weights)                      # (T, B)
    base = c_morph_base.long()[:, None, :]                        # (3, 1, T)
    last = max(morph_deltas.shape[0], 1) - 1
    if ordered:
        acc = torch.zeros((3, T, morph_deltas.shape[1]), device=dev)
        n_live = min(B, int(n_targets.max())) if T else 0
        for m in range(n_live):
            rows = (base[:, 0] + m * stride).clamp(0, last)       # (3, T)
            delta = morph_deltas.index_select(0, rows.reshape(-1)).reshape(
                3, T, -1)
            live = (m < n_targets) & (base[:, 0] >= 0)            # (3, T)
            acc = torch.where(live[..., None],
                              acc + wts[None, :, m, None] * delta, acc)
    else:
        m = torch.arange(B, device=dev)[None, :, None]            # (1, B, 1)
        rows = (base + m * stride).clamp(0, last)
        delta = morph_deltas.index_select(0, rows.reshape(-1)).reshape(
            3, B, T, morph_deltas.shape[1])
        live = (m < n_targets) & (base >= 0)                      # (3, B, T)
        wm = torch.where(live, wts.t()[None], torch.zeros((), device=dev))
        acc = (wm[..., None] * delta).sum(dim=1)                  # (3, T, 10)
    for c in range(3):
        for k in range(3):
            pos[c][k] = pos[c][k] + acc[c, :, k]
            nrm[c][k] = nrm[c][k] + acc[c, :, 3 + k]
            tan[c][k] = tan[c][k] + acc[c, :, 6 + k]


def _skin(c_joints, c_weights, joint_matrices, skin_sets: int,
          ordered: bool = False):
    """Per-corner skin matrices (reference: skin.wgsl): the weighted sum
    of the 4 * skin_sets influences' joint matrices, read at stride
    c_joints.shape[0] // 3, joint rows clamped to [0, J - 1]. One gather
    of (3, 4S, T) matrices and one sum over the influences -> (3, T,
    16); ordered: K15's order instead, influence by influence."""
    T = c_joints.shape[1]
    n_inf = 4 * skin_sets
    stride = c_joints.shape[0] // 3
    jm = joint_matrices.reshape(-1, 16)
    ji = c_joints.reshape(3, stride, T)[:, :n_inf].long().clamp(
        0, jm.shape[0] - 1)
    wi = c_weights.reshape(3, stride, T)[:, :n_inf]
    mats = jm.index_select(0, ji.reshape(-1)).reshape(3, n_inf, T, 16)
    if not ordered:
        return (mats * wi[..., None]).sum(dim=1)
    acc = torch.zeros((3, T, 16), device=c_weights.device)
    for i in range(n_inf):
        acc = acc + mats[:, i] * wi[:, i, :, None]
    return acc


def _upper3(m):
    """(T, 16) row-major 4x4 -> (T, 9) row-major upper-left 3x3."""
    return torch.cat([m[:, 0:3], m[:, 4:7], m[:, 8:11]], dim=1)


def vertex_stage_chain(c_pos, c_norm, c_tang, c_uv0, c_uv1, c_color,
                       c_joints, c_weights, c_morph_base, morph_deltas,
                       tri_mesh, mesh_info, morph_weights, world, normal_mat,
                       joint_matrices, view_proj, mesh_mask, orig_ids=None, *,
                       width: int, height: int, has_morphs: bool = False,
                       skin_sets: int = 0, needs_clip: bool = True,
                       ordered: bool = False) -> torch.Tensor:
    """Vertex stage op by op -> (2T or T, NSETUP) setup rows.

    c_*: (3C, T) component-major corner pools (c_joints / c_weights: 4 *
    the skin-set bucket rows a corner; c_morph_base (3, T) int, the row of
    target 0 in morph_deltas, -1 none); morph_deltas (MD, 10); tri_mesh
    (T,) mesh row (-1 = dead); mesh_info (M, K) int; morph_weights (M, B);
    world (TC, 4, 4); normal_mat (TC, 3, 3); joint_matrices (J, 4, 4);
    view_proj: 4x4 host matrix; mesh_mask (M,) bool — this pass's
    meshes; orig_ids: (T,) int pool ids when the corner pools are a
    compacted gather (frame.py), or None. has_morphs / skin_sets turn the
    morph and skin branches on (skin_sets: the influence sets to read);
    without them the animation tables are not read. needs_clip=False
    when the host proved every visible AABB lies in front of the near
    plane (no secondary rows). ordered: the morph and skin sums in K15's
    order (the twin's)."""
    T = tri_mesh.shape[0]
    mesh = tri_mesh.clamp(0, mesh_info.shape[0] - 1)
    minfo = onehot_gather(mesh, torch.cat(
        [mesh_info.float(), mesh_mask.float()[:, None]], dim=1))
    tf_row = minfo[:, MI_TRANSFORM_ROW].int()
    mat_row = minfo[:, MI_MATERIAL_ROW]
    flags = minfo[:, MI_FLAGS].int()
    active = (minfo[:, -1] > 0.5) & (tri_mesh >= 0)

    pos = _corner_comps(c_pos, 3)
    nrm = _corner_comps(c_norm, 3)
    tan = _corner_comps(c_tang, 4)
    uv0 = _corner_comps(c_uv0, 2)
    uv1 = _corner_comps(c_uv1, 2)
    vcol = _corner_comps(c_color, 4)
    if has_morphs:
        _morph(pos, nrm, tan, c_morph_base, morph_deltas, morph_weights,
               minfo, mesh, ordered)

    node_world = onehot_gather(tf_row, world.reshape(-1, 16))     # (T, 16)
    node_nmat = onehot_gather(tf_row, normal_mat.reshape(-1, 9))  # (T, 9)
    if skin_sets > 0:
        skin = _skin(c_joints, c_weights, joint_matrices, skin_sets, ordered)
        skinned = (minfo[:, MI_SKIN_SETS] > 0)[:, None]
        models = [torch.where(skinned, skin[c], node_world)
                  for c in range(3)]
        tmats = [_upper3(mc) for mc in models]
        # the skinned normal matrix is the skin matrix's upper-left 3x3
        # (the reference's shortcut)
        nmats = [torch.where(skinned, tm, node_nmat) for tm in tmats]
    else:
        models = [node_world] * 3
        tmats = [_upper3(node_world)] * 3
        nmats = [node_nmat] * 3
    vp = [[float(v) for v in row] for row in view_proj]

    clip_c, attrs = [], []
    for c in range(3):
        clip_c.append(_const_mat4(vp, _mat4_point(models[c], pos[c])))
        wn = _mat3_vec(nmats[c], nrm[c])
        wt = _mat3_vec(tmats[c], tan[c][:3])
        attrs.append([uv0[c][0], uv0[c][1], uv1[c][0], uv1[c][1],
                      vcol[c][0], vcol[c][1], vcol[c][2], vcol[c][3],
                      wn[0], wn[1], wn[2], wt[0], wt[1], wt[2], tan[c][3]])

    if not needs_clip:
        return finish_setup(clip_c, attrs, active, mat_row, flags,
                            width, height, orig_ids=orig_ids)

    # ---- near-plane clipping (z_clip >= eps; [0,1] depth convention) -----
    inside = [clip_c[c][2] > _Z_EPS for c in range(3)]
    n_in = inside[0].int() + inside[1].int() + inside[2].int()
    first_in = torch.where(inside[0], 0, torch.where(inside[1], 1, 2))
    first_out = torch.where(~inside[0], 0, torch.where(~inside[1], 1, 2))
    rot = torch.where(n_in == 1, first_in,
                      torch.where(n_in == 2, first_out + 1, 0)) % 3

    def rotate3(per_corner):
        cond1 = rot == 1
        cond2 = rot == 2
        return [[torch.where(cond2, per_corner[(c + 2) % 3][k],
                             torch.where(cond1, per_corner[(c + 1) % 3][k],
                                         per_corner[c][k]))
                 for k in range(len(per_corner[0]))] for c in range(3)]

    a, b, c_ = rotate3(clip_c)
    aa_, ab_, ac_ = rotate3(attrs)

    def lerp_at(p, q, ap, aq, zp, zq):
        dz = zq - zp
        t = torch.clamp((_Z_EPS - zp) / torch.where(
            torch.abs(dz) > 1e-20, dz, torch.ones_like(dz)), 0.0, 1.0)
        pi = [pp + t * (qq - pp) for pp, qq in zip(p, q)]
        ai = [pp + t * (qq - pp) for pp, qq in zip(ap, aq)]
        return pi, ai

    i_ab, t_ab = lerp_at(a, b, aa_, ab_, a[2], b[2])
    i_ac, t_ac = lerp_at(a, c_, aa_, ac_, a[2], c_[2])
    i_bc, t_bc = lerp_at(b, c_, ab_, ac_, b[2], c_[2])

    one_in = n_in == 1
    two_in = n_in == 2

    def sel(cond, xs, ys):
        return [torch.where(cond, x, y) for x, y in zip(xs, ys)]

    p1 = sel(one_in, i_ab, b)
    pa1 = sel(one_in, t_ab, ab_)
    p2 = sel(one_in, i_ac, sel(two_in, i_bc, c_))
    pa2 = sel(one_in, t_ac, sel(two_in, t_bc, ac_))
    rows_p = finish_setup([a, p1, p2], [aa_, pa1, pa2], active & (n_in > 0),
                          mat_row, flags, width, height, orig_ids=orig_ids)
    rows_s = finish_setup([a, i_bc, i_ac], [aa_, t_bc, t_ac],
                          active & two_in, mat_row, flags, width, height,
                          id_offset=T, orig_ids=orig_ids)
    return torch.cat([rows_p, rows_s], dim=0)               # (2T, NSETUP)


def vertex_stage_reference(c_pos, c_norm, c_tang, c_uv0, c_uv1, c_color,
                           c_joints, c_weights, c_morph_base, morph_deltas,
                           tri_mesh, mesh_info, morph_weights, world,
                           normal_mat, joint_matrices, view_proj, mesh_mask,
                           index=None, *, width: int, height: int,
                           has_morphs: bool = False, skin_sets: int = 0,
                           needs_clip: bool = True, out=None,
                           n_index: int | None = None,
                           pad_to: int = 1) -> torch.Tensor:
    """Plain PyTorch twin of K15, on K15's inputs (vertex_stage): the
    index's columns gathered from the pools, the chain's math with the
    morph and skin sums in K15's order, the rows scattered into `out` or
    padded to `pad_to`."""
    pools = [c_pos, c_norm, c_tang, c_uv0, c_uv1, c_color, c_joints,
             c_weights, c_morph_base]
    if index is not None:
        # the joint, weight and morph-base pools are read only when
        # animated
        n_read = 9 if (has_morphs or skin_sets) else 6
        cols, safe = _gather_cols(dict(enumerate(pools[:n_read])), index)
        pools[:n_read] = [cols[k] for k in range(n_read)]
        tri_mesh = torch.where(index >= 0, tri_mesh[safe],
                               torch.full_like(index, -1))
    rows = vertex_stage_chain(
        *pools, morph_deltas, tri_mesh, mesh_info, morph_weights, world,
        normal_mat, joint_matrices, view_proj, mesh_mask, index,
        width=width, height=height, has_morphs=has_morphs,
        skin_sets=skin_sets, needs_clip=needs_clip, ordered=True)
    if out is None:
        return pad_rows(rows, pad_to)
    n, cap, T = n_index, index.shape[0], c_pos.shape[1]
    live = safe[:n]
    out.index_copy_(0, live, rows[:n])
    if needs_clip:
        out.index_copy_(0, live + T, rows[cap:cap + n])
    return out


_P = ctypes.c_void_p
_I = ctypes.c_int


class _VertexParams(ctypes.Structure):
    """csrc/vertex.cu VertexParams, field for field."""
    _fields_ = [
        ("pos", _P), ("nrm", _P), ("tang", _P), ("uv0", _P), ("uv1", _P),
        ("color", _P), ("joints", _P), ("weights", _P), ("morph_base", _P),
        ("tri_mesh", _P), ("index", _P), ("mesh_info", _P),
        ("mesh_mask", _P), ("morph_deltas", _P), ("morph_weights", _P),
        ("world", _P), ("normal_mat", _P), ("joint_matrices", _P),
        ("out", _P), ("ld", ctypes.c_int64), ("n", _I), ("second", _I),
        ("scatter", _I), ("tail_row", _I), ("tail_rows", _I),
        ("n_mesh", _I), ("info_cols", _I), ("n_weight_rows", _I),
        ("morph_width", _I), ("n_deltas", _I), ("morph_cols", _I),
        ("n_tf", _I), ("n_joints", _I), ("joint_stride", _I),
        ("n_influences", _I), ("needs_clip", _I), ("has_morphs", _I),
        ("width", _I), ("height", _I), ("view_proj", ctypes.c_float * 16),
    ]


def vertex_stage(c_pos, c_norm, c_tang, c_uv0, c_uv1, c_color, c_joints,
                 c_weights, c_morph_base, morph_deltas, tri_mesh, mesh_info,
                 morph_weights, world, normal_mat, joint_matrices, view_proj,
                 mesh_mask, index=None, *, width: int, height: int,
                 has_morphs: bool = False, skin_sets: int = 0,
                 needs_clip: bool = True, out=None,
                 n_index: int | None = None,
                 pad_to: int = 1) -> torch.Tensor:
    """K15 (csrc/vertex.cu): the vertex stage in one launch -> setup rows.

    The pools, tables and flags are vertex_stage_chain's, over a pool of
    T triangles (the pools' columns). Without index, every column is a
    triangle: (T or 2T, NSETUP) rows, row j carrying j. index (N,) int32
    pool columns, -1 pads (read as dead triangles): with out None, the
    compacted set, (N or 2N) rows in index order carrying their pool ids;
    with out, the (T or 2T [+ tail], NSETUP) rows of this pool's stage,
    the first n_index triangles of index are written into it at their
    pool rows (and T + those with clipping), carrying their pool ids, and
    out is returned. pad_to: without out, the rows padded with invalid
    rows to a multiple of pad_to (ops/raster.py pad_setup_rows with
    CHUNK). A CPU tensor takes the twin."""
    if c_pos.device.type == "cpu":
        return vertex_stage_reference(
            c_pos, c_norm, c_tang, c_uv0, c_uv1, c_color, c_joints,
            c_weights, c_morph_base, morph_deltas, tri_mesh, mesh_info,
            morph_weights, world, normal_mat, joint_matrices, view_proj,
            mesh_mask, index, width=width, height=height,
            has_morphs=has_morphs, skin_sets=skin_sets,
            needs_clip=needs_clip, out=out, n_index=n_index, pad_to=pad_to)
    T = c_pos.shape[1]
    pools = dict(pos=(c_pos, 9), nrm=(c_norm, 9), tang=(c_tang, 12),
                 uv0=(c_uv0, 6), uv1=(c_uv1, 6), color=(c_color, 12))
    for name, (t, rows) in pools.items():
        if t.dtype != torch.float32 or t.shape != (rows, T):
            raise ValueError(f"{name} must be ({rows}, {T}) f32")
    if tri_mesh.dtype != torch.int32 or tri_mesh.shape != (T,):
        raise ValueError(f"tri_mesh must be ({T},) int32")
    if mesh_info.dtype != torch.int32 or mesh_info.dim() != 2:
        raise ValueError("mesh_info must be (M, K) int32")
    M = mesh_info.shape[0]
    if mesh_mask.dtype != torch.bool or mesh_mask.shape != (M,):
        raise ValueError(f"mesh_mask must be ({M},) bool")
    world = world.reshape(-1, 16)
    normal_mat = normal_mat.reshape(-1, 9)
    if (world.dtype != torch.float32 or normal_mat.dtype != torch.float32
            or normal_mat.shape[0] != world.shape[0]):
        raise ValueError("world (TC, 4, 4) and normal_mat (TC, 3, 3) must "
                         "be f32")
    tensors = [c_pos, c_norm, c_tang, c_uv0, c_uv1, c_color, tri_mesh,
               mesh_info, mesh_mask, world, normal_mat]
    prm = _VertexParams()
    if index is not None:
        if index.dtype != torch.int32 or index.dim() != 1:
            raise ValueError("index must be (N,) int32")
        tensors.append(index)
        prm.index = index.data_ptr()
    if has_morphs:
        if (c_morph_base.dtype != torch.int32
                or c_morph_base.shape != (3, T)
                or morph_deltas.dtype != torch.float32
                or morph_deltas.dim() != 2 or morph_deltas.shape[1] < 9
                or morph_weights.dtype != torch.float32
                or morph_weights.dim() != 2):
            raise ValueError(f"c_morph_base must be (3, {T}) int32, "
                             "morph_deltas (MD, >= 9) and morph_weights "
                             "(M, B) f32")
        tensors += [c_morph_base, morph_deltas, morph_weights]
        prm.morph_base = c_morph_base.data_ptr()
        prm.morph_deltas = morph_deltas.data_ptr()
        prm.morph_weights = morph_weights.data_ptr()
        prm.n_weight_rows, prm.morph_width = morph_weights.shape
        prm.n_deltas, prm.morph_cols = morph_deltas.shape
        prm.has_morphs = 1
    if skin_sets > 0:
        jm = joint_matrices.reshape(-1, 16)
        stride = c_joints.shape[0] // 3
        if (c_joints.dtype != torch.int32 or c_weights.dtype != torch.float32
                or c_joints.shape != (3 * stride, T)
                or c_weights.shape != c_joints.shape
                or stride < 4 * skin_sets or jm.dtype != torch.float32
                or jm.shape[0] == 0):
            raise ValueError(f"c_joints (int32) and c_weights (f32) must be "
                             f"(3 * S >= {12 * skin_sets}, {T}), the joint "
                             f"matrices (J > 0, 4, 4) f32")
        tensors += [c_joints, c_weights, jm]
        prm.joints, prm.weights = c_joints.data_ptr(), c_weights.data_ptr()
        prm.joint_matrices = jm.data_ptr()
        prm.n_joints, prm.joint_stride = jm.shape[0], stride
        prm.n_influences = 4 * skin_sets
    kernels.check_cuda(*tensors)

    if out is None:
        n = T if index is None else index.shape[0]
        n_rows = 2 * n if needs_clip else n
        total = n_rows + (-n_rows) % pad_to
        out = torch.empty((total, NSETUP), dtype=torch.float32,
                          device=c_pos.device)
        prm.second, prm.tail_row, prm.tail_rows = n, n_rows, total - n_rows
    else:
        if index is None or n_index is None:
            raise ValueError("out takes an index and its live count")
        if (out.dtype != torch.float32 or out.dim() != 2
                or out.shape[1] != NSETUP
                or out.shape[0] < (2 * T if needs_clip else T)):
            raise ValueError(f"out must hold the pool's rows, (>= "
                             f"{2 * T if needs_clip else T}, {NSETUP}) f32")
        kernels.check_cuda(c_pos, out)
        n = n_index
        prm.second, prm.scatter = T, 1
    if M == 0 or out.data_ptr() % 16:
        raise ValueError("need a mesh table and a 16-byte aligned output")
    prm.pos, prm.nrm, prm.tang = (c_pos.data_ptr(), c_norm.data_ptr(),
                                  c_tang.data_ptr())
    prm.uv0, prm.uv1, prm.color = (c_uv0.data_ptr(), c_uv1.data_ptr(),
                                   c_color.data_ptr())
    prm.tri_mesh, prm.mesh_info = tri_mesh.data_ptr(), mesh_info.data_ptr()
    prm.mesh_mask = mesh_mask.data_ptr()
    prm.world, prm.normal_mat = world.data_ptr(), normal_mat.data_ptr()
    prm.out, prm.ld, prm.n = out.data_ptr(), T, n
    prm.n_mesh, prm.info_cols = M, mesh_info.shape[1]
    prm.n_tf = world.shape[0]
    prm.needs_clip = int(needs_clip)
    prm.width, prm.height = width, height
    prm.view_proj[:] = [float(v) for row in view_proj for v in row]
    kernels.launch("vertex_stage", "awsm_vertex_stage", ctypes.byref(prm))
    return out
