"""Gather-and-split kernels of the shade: K3 (material fetch) and K6
(environment taps in bf16; the volume-refraction background in f32); and
the two relayouts no frame path runs, K12 split_rows and K13
channel_rows.

Port of the four awsm_renderer_tpu/ops/relayout.py kernels. On the TPU
these exist to give every channel its own rank-1 array (a layout concern
there); on the card K3 and K6 are plain gathers written by hand
(csrc/relayout.cu) that emit channel-major (C, N) f32 planes, K12 a
widening copy and K13 a tile transpose. The reference reaches K12 only
through its fallback tap branch (texsample.py:569-632), which the port
does not copy, and K13 has no caller: both are ported as standalone
kernels. Each has a public plain twin (*_reference) for any device; a CPU
tensor takes the twin, a CUDA tensor the kernel.
"""

from __future__ import annotations

import torch

from . import kernels


def onehot_split_rows_reference(rows: torch.Tensor,
                                table: torch.Tensor) -> torch.Tensor:
    """table[rows] as (C, P) f32; rows outside [0, cap) give zeros."""
    cap = table.shape[0]
    ok = (rows >= 0) & (rows < cap)
    g = table.float().index_select(0, rows.clamp(0, cap - 1).long())
    return torch.where(ok[:, None], g, torch.zeros((), device=g.device)).T


def onehot_split_rows(rows: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """K3: rows (P,) int32, table (cap, C) f32 -> (C, P) f32 planes, zero
    where a row is outside [0, cap) (the reference's one-hot matmul)."""
    if rows.device.type == "cpu":
        return onehot_split_rows_reference(rows, table)
    if rows.dtype != torch.int32 or rows.dim() != 1:
        raise ValueError("rows must be (P,) int32")
    if table.dtype != torch.float32 or table.dim() != 2:
        raise ValueError("table must be (cap, C) f32")
    kernels.check_cuda(rows, table)
    cap, C = table.shape
    P = rows.shape[0]
    out = torch.empty((C, P), dtype=torch.float32, device=rows.device)
    kernels.launch("onehot_split_rows", "awsm_onehot_split_rows",
                   rows.data_ptr(), table.data_ptr(), cap, C, P,
                   out.data_ptr())
    return out


def gather_split_channels_reference(texels: torch.Tensor, idx: torch.Tensor,
                                    ncols: int = 16) -> torch.Tensor:
    """texels[clip(idx)][:, :ncols] widened to f32, as (ncols, M) planes."""
    safe = idx.clamp(0, texels.shape[0] - 1).long()
    return texels.index_select(0, safe)[:, :ncols].float().T.contiguous()


def gather_split_channels(texels: torch.Tensor, idx: torch.Tensor,
                          ncols: int = 16) -> torch.Tensor:
    """K6: texels (N, R) bf16 rows, idx (M,) int32 -> (ncols, M) f32 planes
    of texels[clip(idx, 0, N-1), :ncols] — the reference's env-tap gather
    followed by split_channels, in one pass."""
    if texels.device.type == "cpu":
        return gather_split_channels_reference(texels, idx, ncols)
    if texels.dtype != torch.bfloat16 or texels.dim() != 2:
        raise ValueError("texels must be (N, R) bf16")
    if idx.dtype != torch.int32 or idx.dim() != 1:
        raise ValueError("idx must be (M,) int32")
    N, R = texels.shape
    if not 0 < ncols <= R:
        raise ValueError(f"ncols {ncols} outside (0, {R}]")
    kernels.check_cuda(texels, idx)
    M = idx.shape[0]
    out = torch.empty((ncols, M), dtype=torch.float32, device=idx.device)
    kernels.launch("gather_split_channels", "awsm_gather_split_channels",
                   texels.data_ptr(), N, R, idx.data_ptr(), M, ncols,
                   out.data_ptr())
    return out


def gather_split_channels_f32_reference(table: torch.Tensor, idx: torch.Tensor,
                                        ncols: int) -> torch.Tensor:
    """table[clip(idx)][:, :ncols] as (ncols, M) f32 planes."""
    safe = idx.clamp(0, table.shape[0] - 1).long()
    return table.index_select(0, safe)[:, :ncols].T.contiguous()


def gather_split_channels_f32(table: torch.Tensor, idx: torch.Tensor,
                              ncols: int) -> torch.Tensor:
    """K6, f32 entry: table (N, C) f32 rows, idx (M,) int32 -> (ncols, M)
    f32 planes of table[clip(idx, 0, N-1), :ncols] — the reference's
    split_channels of the gathered opaque rows on the volume-refraction
    path (shade.py:1577)."""
    if table.device.type == "cpu":
        return gather_split_channels_f32_reference(table, idx, ncols)
    if table.dtype != torch.float32 or table.dim() != 2:
        raise ValueError("table must be (N, C) f32")
    if idx.dtype != torch.int32 or idx.dim() != 1:
        raise ValueError("idx must be (M,) int32")
    N, C = table.shape
    if not 0 < ncols <= C:
        raise ValueError(f"ncols {ncols} outside (0, {C}]")
    kernels.check_cuda(table, idx)
    M = idx.shape[0]
    out = torch.empty((ncols, M), dtype=torch.float32, device=idx.device)
    kernels.launch("gather_split_channels_f32",
                   "awsm_gather_split_channels_f32", table.data_ptr(), N, C,
                   idx.data_ptr(), M, ncols, out.data_ptr())
    return out


def _f32_or_bf16(x: torch.Tensor, name: str) -> int:
    """1 for bf16, 0 for f32; raises on another dtype or a 2-D mismatch."""
    if x.dim() != 2 or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name} must be 2-D f32 or bf16")
    return int(x.dtype == torch.bfloat16)


def split_rows_reference(x: torch.Tensor):
    """(C, P) f32/bf16 -> tuple of C (P,) f32 rows."""
    return tuple(x.float().clone().unbind(0))


def split_rows(x: torch.Tensor):
    """K12: a channel-major (C, P) f32 or bf16 table -> tuple of C
    separate (P,) f32 rows (reference: relayout.py split_rows)."""
    if x.device.type == "cpu":
        return split_rows_reference(x)
    bf16 = _f32_or_bf16(x, "x")
    kernels.check_cuda(x)
    C, P = x.shape
    out = torch.empty((C, P), dtype=torch.float32, device=x.device)
    kernels.launch("split_rows", "awsm_split_rows", x.data_ptr(), bf16, C, P,
                   out.data_ptr())
    return out.unbind(0)


def channel_rows_reference(x: torch.Tensor) -> torch.Tensor:
    """(P, C) f32/bf16 -> (C, P) f32."""
    return x.t().float().contiguous()


def channel_rows(x: torch.Tensor) -> torch.Tensor:
    """K13: (P, C) f32 or bf16 -> (C, P) f32, physically transposed
    (reference: relayout.py channel_rows); C at most 1024."""
    if x.device.type == "cpu":
        return channel_rows_reference(x)
    bf16 = _f32_or_bf16(x, "x")
    kernels.check_cuda(x)
    P, C = x.shape
    if C > 1024:
        raise ValueError(f"{C} channels: at most 1024")
    out = torch.empty((C, P), dtype=torch.float32, device=x.device)
    kernels.launch("channel_rows", "awsm_channel_rows", x.data_ptr(), bf16,
                   P, C, out.data_ptr())
    return out
