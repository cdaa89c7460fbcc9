"""Temporal reuse (TAA): reprojection (K10), validity, the per-frame unit
choice and the image-space resolve.

Port of awsm_renderer_tpu/ops/temporal.py. The camera jitters by a
centred Halton(2, 3) subpixel offset each frame; the frame keeps a
history of the shaded opaque HDR plus the winner tri-id and depth, and
each new frame rasterizes ids + depth only (K1), reprojects every pixel
into the previous frame through the unjittered matrices, validates it by
winner id and depth (K10), shades only the (8, 128) units that need it
(`select_units`) and blends the fresh samples into the reprojected
history under a 3x3 neighbourhood clamp (`temporal_merge`).

The history is a (5, H, W) f32 tensor [r, g, b, tid, depth] whose tid
plane holds the int32 winner ids' bits: every read and write of that
plane goes through an int32 view, so the -2 reset sentinel (a NaN
pattern) and small ids (float denormals) never meet float arithmetic.

K10 (`reproject_history_planes`) is a hand-written CUDA kernel
(csrc/temporal.cu) on a CUDA tensor and its plain twin
`reproject_history_reference` on a CPU tensor. Everything else here is
plain PyTorch on (H, W) planes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import kernels
from .shade import _tile_swizzle

_EPS = 1e-6

# residual select fan half-width (pixels): a pixel reprojects validly only
# within +-RESID of its unit's anchor
RESID = 2
# the reference's per-unit history window (3x3 tile-aligned blocks of the
# (8, 128) unit grid); here it only bounds the unit anchors
# (_unit_scalars), the kernel gathers straight from the history
WIN_H = 24
WIN_W = 384
N_HIST = 5     # r, g, b, tid (int32 bits), depth


def pack_history(r, g, b, tid, depth, H: int, W: int) -> torch.Tensor:
    """Channel planes -> (5, H, W) f32 history. tid (int32) is stored as
    its bits: the planes are stacked as int32 views, so no value passes
    through a float operation."""
    planes = [p.reshape(H, W).view(torch.int32) for p in (r, g, b)]
    planes += [tid.reshape(H, W), depth.reshape(H, W).view(torch.int32)]
    return torch.stack(planes).view(torch.float32)


def reset_history(H: int, W: int, device="cuda") -> torch.Tensor:
    """All-invalid history on `device` (the card unless the caller asks
    for the CPU): tid plane = -2 (matches nothing, the -1 miss id
    included), colours and depth zero."""
    h = torch.zeros((N_HIST, H, W), dtype=torch.float32, device=device)
    h[3].view(torch.int32).fill_(-2)
    return h


def temporal_offsets(cam, depth, *, width: int, height: int):
    """Per-pixel reprojection offsets from camera motion (static scene).

    cam carries 'inv_view_proj_nj' (current, unjittered) and
    'prev_view_proj' (previous frame, unjittered) as host matrices.
    Returns (off_x, off_y, exp_z) (H, W) f32 planes: offset = previous
    pixel - current pixel in display pixels; exp_z = the NDC depth this
    pixel should find in the history. Behind-the-camera reprojections
    get offsets of 1e6 (off-screen, so invalid)."""
    H, W = height, width
    d = depth.reshape(H, W)
    dev = d.device
    ar = torch.arange(max(H, W), dtype=torch.float32, device=dev)
    nx = ((ar[:W] + 0.5) / W * 2.0 - 1.0)[None, :]
    ny = (1.0 - (ar[:H] + 0.5) / H * 2.0)[:, None]
    ivp = [[float(v) for v in row] for row in cam["inv_view_proj_nj"]]
    pvp = [[float(v) for v in row] for row in cam["prev_view_proj"]]
    wp = [nx * ivp[j][0] + ny * ivp[j][1] + d * ivp[j][2] + ivp[j][3]
          for j in range(4)]
    # prev_clip = pvp @ (wp / wp.w): the 1/wp.w cancels in the NDC divide
    pc = [wp[0] * pvp[j][0] + wp[1] * pvp[j][1] + wp[2] * pvp[j][2]
          + wp[3] * pvp[j][3] for j in range(4)]
    w3 = pc[3]
    iw = 1.0 / torch.where(w3.abs() > _EPS, w3,
                           torch.where(w3 >= 0, _EPS, -_EPS))
    exp_z = pc[2] * iw
    behind = w3 <= _EPS
    px = (pc[0] * iw + 1.0) * 0.5 * W - 0.5
    py = (1.0 - pc[1] * iw) * 0.5 * H - 0.5
    off_x = torch.where(behind, 1e6, px - (nx + 1.0) * 0.5 * W + 0.5)
    off_y = torch.where(behind, 1e6, py - (1.0 - ny) * 0.5 * H + 0.5)
    return off_x, off_y, exp_z


def _to_i32(f: torch.Tensor) -> torch.Tensor:
    """f32 -> int32 as XLA converts (and csrc/temporal.cu): NaN -> 0,
    out-of-range values saturate. torch's own cast gives INT_MIN for
    both on the CPU."""
    return (f.double().clamp(-2147483648.0, 2147483647.0).nan_to_num(0.0)
            .to(torch.int32))


def _unit_scalars(off_x, off_y, *, width: int, height: int,
                  win_h: int = WIN_H, win_w: int = WIN_W) -> torch.Tensor:
    """Per-unit anchors from the unit-mean offsets: (n_units, 8) int32
    [R0, C0, sy0, sx0, ok, 0, 0, 0], the reference's layout. (R0, C0) is
    the tile-aligned window origin, clamped to the image; (sy0, sx0) the
    anchor's residue within the window, clamped to win - 8 - 2*RESID, so
    a border unit's pixels are judged against a shifted anchor; ok = 0
    marks a degenerate mean (|mean| >= 1e5, or non-finite). The anchor a
    pixel is tested against is (R0 + sy0 + RESID, C0 + sx0 + RESID) plus
    its place in the unit. The means round half to even (torch.round, as
    jnp.round); int32 arithmetic wraps as the reference's does."""
    H, W = height, width
    n_ty, n_tx = H // 8, W // 128
    dev = off_x.device

    def unit_mean(p):
        m = p.reshape(n_ty, 8, n_tx, 128).mean(dim=(1, 3))
        return torch.nan_to_num(m, nan=1e6, posinf=1e6, neginf=-1e6)

    my = unit_mean(off_y)
    mx = unit_mean(off_x)
    ay = _to_i32(torch.round(my))
    ax = _to_i32(torch.round(mx))
    uby = torch.arange(n_ty, dtype=torch.int32, device=dev)[:, None]
    ubx = torch.arange(n_tx, dtype=torch.int32, device=dev)[None, :]
    s_y = uby * 8 + ay - RESID          # desired anchor row - RESID
    s_x = ubx * 128 + ax - RESID
    R0 = (torch.div(s_y, 8, rounding_mode="floor") * 8).clamp(0, H - win_h)
    C0 = (torch.div(s_x, 128, rounding_mode="floor") * 128).clamp(
        0, W - win_w)
    sy0 = (s_y - R0).clamp(0, max(0, win_h - 8 - 2 * RESID))
    sx0 = (s_x - C0).clamp(0, max(0, win_w - 128 - 2 * RESID))
    ok = (my.abs() < 1e5) & (mx.abs() < 1e5)     # finite after nan_to_num
    zeros = torch.zeros_like(R0)
    scal = torch.stack([R0, C0, sy0, sx0, ok.to(torch.int32), zeros, zeros,
                        zeros], dim=-1)
    return scal.reshape(n_ty * n_tx, 8).to(torch.int32)


def history_sources(off_x, off_y, scal, H: int, W: int):
    """Each pixel's source in the previous frame: (src (H*W,) int64 flat
    history index, clamped into the image; inr (H, W) bool: the source
    lies in the image, within +-RESID of the unit's anchor, and the unit
    is ok)."""
    dev = off_x.device
    s = scal.reshape(H // 8, W // 128, 8).long()

    def per_px(col):
        return s[..., col].repeat_interleave(8, 0).repeat_interleave(128, 1)

    ly = (torch.arange(H, device=dev) % 8)[:, None]
    lx = (torch.arange(W, device=dev) % 128)[None, :]
    gy = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    gx = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
    ry = _to_i32(torch.floor(gy + off_y.reshape(H, W) + 0.5)).long()
    rx = _to_i32(torch.floor(gx + off_x.reshape(H, W) + 0.5)).long()
    rdy = ry - (per_px(0) + per_px(2) + RESID) - ly
    rdx = rx - (per_px(1) + per_px(3) + RESID) - lx
    inr = ((rdy.abs() <= RESID) & (rdx.abs() <= RESID) & (ry >= 0)
           & (ry < H) & (rx >= 0) & (rx < W) & (per_px(4) > 0))
    src = (ry.clamp(0, H - 1) * W + rx.clamp(0, W - 1)).reshape(-1)
    return src, inr


def reproject_history_reference(hist, off_x, off_y, exp_z, cur_tid, scal):
    """Plain twin of K10 on any device. hist (5, H, W) f32 history (tid
    plane as int32 bits); off_x, off_y, exp_z f32 and cur_tid int32 with
    H*W elements; scal (n_units, 8) int32 from _unit_scalars. Returns
    (rep_r, rep_g, rep_b (H, W) f32, v (H, W) int32 = valid + 2 *
    blendable).

    A pixel's source is (ry, rx) = floor(g + off + 0.5) (history_sources).
    Where that is in range, the pixel is blendable when the history tid
    there is live (>= -1, not the -2 sentinel), and valid when, besides,
    that tid equals the pixel's and |history depth - exp_z| <= max(2e-4,
    0.05 (1 - |exp_z|)). rep is the history colour where blendable, else
    0. The reference's windowed candidate fan selects exactly
    hist[:, ry, rx] for every in-range pixel, so a gather is the same
    function."""
    _, H, W = hist.shape
    src, inr = history_sources(off_x, off_y, scal, H, W)
    # gather the int32 bits of all five planes: exact by construction
    g = hist.view(torch.int32).reshape(N_HIST, H * W).index_select(1, src)
    g = g.reshape(N_HIST, H, W)
    h_tid = g[3]
    gf = g.view(torch.float32)
    blendable = inr & (h_tid >= -1)
    ez = exp_z.reshape(H, W)
    tol = torch.clamp(0.05 * (1.0 - ez.abs()), min=2e-4)
    valid = (blendable & (h_tid == cur_tid.reshape(H, W))
             & ((gf[4] - ez).abs() <= tol))
    zero = torch.zeros((), dtype=torch.float32, device=hist.device)
    rgb = [torch.where(blendable, gf[c], zero) for c in range(3)]
    return (*rgb, valid.to(torch.int32) + 2 * blendable.to(torch.int32))


def reproject_history_planes(hist, off_x, off_y, exp_z, cur_tid, scal):
    """K10: reproject the history through per-pixel offsets (see
    reproject_history_reference for the function). A CUDA tensor
    launches the hand-written kernel (csrc/temporal.cu), one 1024-thread
    block per (8, 128) unit; a CPU tensor takes the twin."""
    if hist.device.type == "cpu":
        return reproject_history_reference(hist, off_x, off_y, exp_z,
                                           cur_tid, scal)
    if hist.dtype != torch.float32 or hist.dim() != 3 \
            or hist.shape[0] != N_HIST:
        raise ValueError(f"hist must be ({N_HIST}, H, W) f32")
    _, H, W = hist.shape
    if H % 8 or W % 128:
        raise ValueError(f"history {H}x{W} is not made of (8, 128) units")
    for name, t, dt in (("off_x", off_x, torch.float32),
                        ("off_y", off_y, torch.float32),
                        ("exp_z", exp_z, torch.float32),
                        ("cur_tid", cur_tid, torch.int32)):
        if t.dtype != dt or t.numel() != H * W:
            raise ValueError(f"{name} must hold {H * W} {dt}")
    n_units = (H // 8) * (W // 128)
    if scal.dtype != torch.int32 or tuple(scal.shape) != (n_units, 8):
        raise ValueError(f"scal must be ({n_units}, 8) int32")
    kernels.check_cuda(hist, off_x, off_y, exp_z, cur_tid, scal)
    out = [torch.empty((H, W), dtype=torch.float32, device=hist.device)
           for _ in range(3)]
    v = torch.empty((H, W), dtype=torch.int32, device=hist.device)
    kernels.launch("reproject_history", "awsm_reproject", hist.data_ptr(),
                   off_x.data_ptr(), off_y.data_ptr(), exp_z.data_ptr(),
                   cur_tid.data_ptr(), scal.data_ptr(), H, W,
                   *(o.data_ptr() for o in out), v.data_ptr())
    return (*out, v)


def reproject_history(hist, off_x, off_y, exp_z, cur_tid, *, width: int,
                      height: int):
    """Reproject the (5, H, W) history (the reference's entry). Returns
    (rep_r, rep_g, rep_b, valid, blendable) flat (H*W,) planes: valid =
    reuse allowed without reshading (same winner id, consistent depth),
    blendable = the source is a live history pixel (a freshly shaded
    sample may accumulate against it under the neighbourhood clamp)."""
    H, W = height, width
    assert H % 8 == 0 and W % 128 == 0
    scal = _unit_scalars(off_x, off_y, width=W, height=H,
                         win_h=min(WIN_H, H), win_w=min(WIN_W, W))
    r, g, b, v = reproject_history_planes(hist, off_x, off_y, exp_z,
                                          cur_tid, scal)
    vf = v.reshape(H * W)
    return (r.reshape(H * W), g.reshape(H * W), b.reshape(H * W),
            (vf & 1) > 0, (vf & 2) > 0)


def select_units(valid, age, *, width: int, height: int, shade_cap: int):
    """Pick the C = min(shade_cap, n_units) units to reshade this frame.

    valid (H*W,) bool; age (n_units,) int32 frames since each unit last
    shaded. Units holding an invalid pixel come first (those of age 0
    excepted: silhouette units stay strict-invalid under jitter and
    would otherwise take the budget every frame), then the rest, oldest
    first; ties keep unit order (a stable sort, as jnp.argsort). Returns
    (idx (C,) int64 unit ids, shaded_unit (n_units,) bool)."""
    H, W = height, width
    n_units = (H // 8) * (W // 128)
    C = min(shade_cap, n_units)
    inval = (~_tile_swizzle(valid, H, W)).any(dim=-1)
    a = age.clamp(0, 1 << 20)
    key = torch.where(inval & (a > 0), a + (1 << 22), a)
    idx = torch.argsort(-key, stable=True)[:C]
    shaded_unit = torch.zeros(n_units, dtype=torch.bool,
                              device=valid.device).index_fill_(0, idx, True)
    return idx, shaded_unit


def _window_max(x: torch.Tensor) -> torch.Tensor:
    """3x3 max of an (H, W) plane with "SAME" padding (the padding never
    wins: every window holds its centre)."""
    return F.max_pool2d(x[None, None], 3, stride=1, padding=1)[0, 0]


def temporal_merge(new_c, shaded_px, rep_c, valid, blendable, hist,
                   cur_tid, depth, *, width: int, height: int,
                   alpha: float):
    """Image-space temporal resolve of this frame's freshly shaded pixels
    with the reprojected history. new_c: 3 (H*W,) planes, defined where
    shaded_px; rep_c: 3 (H*W,) reprojected colours. Per pixel:
      shaded & blendable  -> the history clamped to the 3x3 min/max of
                             the shaded neighbourhood (unshaded
                             neighbours ignored), lerped toward the new
                             sample by alpha;
      shaded & ~blendable -> the new sample;
      ~shaded & valid     -> the reprojected history;
      ~shaded & ~valid    -> the history at this pixel, unprojected (the
                             pixel stays invalid: its tid is stored as
                             -2, so the next frame repairs it).
    Returns (out_c 3 planes, new_hist (5, H, W), cov (H*W,) f32)."""
    H, W = height, width
    big = 1e30
    sm = shaded_px.reshape(H, W)
    v = valid.reshape(H, W)
    b = blendable.reshape(H, W)
    out_c = []
    for c in range(3):
        img = new_c[c].reshape(H, W)
        # unshaded pixels hold +big (min) / -big (max): the reference's
        # masked reduce_window
        lo = -_window_max(torch.where(sm, -img, -big))
        hi = _window_max(torch.where(sm, img, -big))
        rep = rep_c[c].reshape(H, W)
        clamped = torch.minimum(torch.maximum(rep, lo), hi)
        blended = img * alpha + clamped * (1.0 - alpha)
        out = torch.where(sm, torch.where(b, blended, img),
                          torch.where(v, rep, hist[c]))
        out_c.append(out.reshape(H * W))
    keep = shaded_px | valid
    tid_store = torch.where(keep, cur_tid, -2)
    new_hist = pack_history(out_c[0], out_c[1], out_c[2], tid_store, depth,
                            H, W)
    return out_c, new_hist, (cur_tid >= 0).float()
