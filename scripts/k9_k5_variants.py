#!/usr/bin/env python3
"""K9's slice size and pixels a thread, and K5's row-load shape, on one
CUDA card.

K9 (csrc/raster_msaa.cu): the constant S (groups a work slice walks at
most) at 8, 16, 32, 48 and 64 with PX = 1 display pixel a thread (1024
threads), and S = 16 with PX = 4 (256 threads, 2 blocks an SM) and PX = 2
(512 threads, 1 or 2 blocks an SM). K5 (csrc/texsample.cu): each thread
loads its own row as 16-byte vectors (thread_rows, the package's), or a
warp stages its 32 taps' rows in shared memory, each 16-byte load
instruction fetching whole rows (warp_rows, the kernel's row loads
replaced by K5_WARP_ROWS below).

Builds a copy of each source per variant with the constants replaced
(scripts/k1_slices.py build_variants: the package's nvcc flags, one nvcc
each, all started together, under build/k9_k5_variants/; ptxas's register
and spill lines printed), builds chip_smoke.py's scenes at --width x
--height and captures the first frame's inputs: K9's on the MSAA frame
(Stress-1080p-msaa-bloom-dof), K5's on the stress frame
(Stress-1080p-ibl-tex) and on the helmet (glb-helmet-1080p-ibl). Each
variant's output is held bit-equal to the plain twin, then timed in
turns (the variants in order, then in reverse) with chip_smoke.py's
kernel_ms (one event pair around 50 launches). Prints the card's name and
power limit.

Usage (repo root, one card):
    python3 scripts/k9_k5_variants.py [--width 1920 --height 1080]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the package's K9 is S = 48 at PX = 1 (1024 threads, 16x2 warp blocks)
K9_VARIANTS = {"s8": {"S": 8}, "s16": {"S": 16}, "s32": {"S": 32},
               "s48": {"S": 48}, "s64": {"S": 64},
               "s16_px4": {"S": 16, "PX": 4},
               "s16_px2": {"S": 16, "PX": 2},
               "s16_px2_2blocks": {"S": 16, "PX": 2, "MIN_BLOCKS": 2}}
K5_VARIANTS = {"thread_rows": {}, "warp_rows": {}}
# the package's K5 loads each tap's row in its own thread; warp_rows
# stages a warp's 32 rows in shared memory first
K5_THREAD_ROWS = """  if (i >= N) return;
  const int r = min(max(__ldcs(idx + i), 0), R - 1);
  uint4 v[V];
#pragma unroll
  for (int k = 0; k < V; ++k) v[k] = __ldg(texq + (size_t)r * ROW_VECS + k);
"""
K5_WARP_ROWS = """  const int r = i < N ? min(max(__ldcs(idx + i), 0), R - 1) : -1;
  // L lanes a row: a warp load instruction fetches 32 / L whole rows,
  // into shared rows 144 bytes apart (a quarter-warp's 16-byte reads of
  // 8 rows fall in distinct banks)
  constexpr int L = MIPS ? 8 : 2;
  __shared__ uint4 rows[K5_THREADS / 32][32][ROW_VECS + 1];
  uint4(*wr)[ROW_VECS + 1] = rows[threadIdx.x >> 5];
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int it = 0; it < L; ++it) {
    const int k = it * (32 / L) + lane / L, c = lane % L;
    const int rk = __shfl_sync(0xffffffffu, r, k);
    if (rk >= 0 && c < V) {
      wr[k][c] = __ldg(texq + (size_t)rk * ROW_VECS + c);
    }
  }
  __syncwarp();
  if (i >= N) return;
  uint4 v[V];
#pragma unroll
  for (int k = 0; k < V; ++k) v[k] = wr[lane][k];
"""
K5_PATCHES = {"warp_rows": [(K5_THREAD_ROWS, K5_WARP_ROWS)]}


def msaa(fn, S, srows, bins, w2, h2, torch, TR):
    """rasterize16_msaa's launch, with the plan's workspace sized for S."""
    entries, offsets, counts, _z, big_packed, big_ids, n_big, _c = bins
    n_tiles = counts.numel()
    H1, W1 = h2 // 2, w2 // 2
    dev = srows.device
    samp = torch.empty((4, H1, W1), dtype=torch.int32, device=dev)
    depth = torch.empty((H1, W1), dtype=torch.float32, device=dev)
    ws, nb_max, max_slices = TR._plan_workspace(srows, entries, n_tiles, S)
    scratch = torch.empty(n_tiles * 4 * 1024, dtype=torch.int64, device=dev)
    ptrs = [t.data_ptr() for t in (srows, entries, offsets, counts,
                                   big_packed, big_ids, n_big)]
    stream = torch._C._cuda_getCurrentRawStream(torch.cuda.current_device())
    rc = fn(*ptrs, n_tiles, -(-w2 // 64), W1, H1, nb_max, max_slices,
            ws.data_ptr(), scratch.data_ptr(), samp.data_ptr(),
            depth.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"awsm_raster_msaa (S = {S}) failed: "
                           f"cudaError_t {rc}")
    return samp, depth


def filter_taps(fn, texq, idx, w, mips, torch):
    """filter_taps_fused's launch."""
    out = torch.empty((4, idx.shape[0]), dtype=torch.float32,
                      device=idx.device)
    stream = torch._C._cuda_getCurrentRawStream(torch.cuda.current_device())
    rc = fn(texq.data_ptr(), texq.shape[0], idx.data_ptr(), w.data_ptr(),
            idx.shape[0], int(mips), out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"awsm_filter_taps failed: cudaError_t {rc}")
    return out


def in_turns(labels, run, check, C):
    """{label: [ms, ms]}: each variant checked by check(label, out), then
    timed with kernel_ms in turns, in order and in reverse."""
    times = {k: [] for k in labels}
    for k in list(labels) + list(labels)[::-1]:
        check(k, run(k))
        times[k].append(C.kernel_ms(lambda: run(k)))
    return times


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("k9_k5_variants: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import awsm_renderer_tpu_torch as P
    import chip_smoke as C
    from awsm_renderer_tpu_torch.ops import kernels
    from awsm_renderer_tpu_torch.ops import raster as TR
    from awsm_renderer_tpu_torch.ops import texsample as TS
    from k1_slices import build_variants

    k9 = build_variants(kernels, "raster_msaa.cu", "awsm_raster_msaa",
                        K9_VARIANTS, "k9_k5_variants")
    k5 = build_variants(kernels, "texsample.cu", "awsm_filter_taps",
                        K5_VARIANTS, "k9_k5_variants", K5_PATCHES)
    C.W, C.H = args.width, args.height
    failed = []

    # ---- K9 on the MSAA frame's inputs ------------------------------------
    r, _keys, _hud = C.build_stress_scene(P, np, "cuda", effects=True)
    C.orbit_camera(r, np, 0)
    (srows,), kw = C.capture_first_frame(r, ("rasterize16_msaa",))[
        "rasterize16_msaa"]
    w2, h2 = kw["width2"], kw["height2"]
    _s, _d, bins = TR.rasterize16_msaa(srows, width2=w2, height2=h2)
    rsamp, rdepth = TR.rasterize16_msaa_reference(srows, bins, width2=w2,
                                                  height2=h2)
    torch.cuda.synchronize()
    print(f"K9 inputs: setup rows {tuple(srows.shape)}, {w2}x{h2}, max "
          f"{int(bins[2].max())} entries a tile, {int(bins[6])} big groups")

    def k9_check(k, out):
        samp, depth = out
        torch.cuda.synchronize()
        if not (all(torch.equal(a, b) for a, b in zip(samp, rsamp))
                and torch.equal(depth.view(torch.int32),
                                rdepth.view(torch.int32))):
            failed.append(f"K9 {k}")

    t9 = in_turns(K9_VARIANTS, lambda k: msaa(
        k9[k], K9_VARIANTS[k]["S"], srows, bins, w2, h2, torch, TR),
        k9_check, C)
    del r, srows, bins, rsamp, rdepth

    # ---- K5 on the stress frame's and the helmet's inputs -----------------
    t5 = {}
    r, _keys, _hud = C.build_stress_scene(P, np, "cuda")
    C.orbit_camera(r, np, 0)
    scenes = [("stress", r)]
    h, _camera, _stats = C.build_helmet_scene(P, np, "cuda")
    scenes.append(("helmet", h))
    for label, rr in scenes:
        (texq, idx, w), fkw = C.capture_first_frame(
            rr, ("filter_taps_fused",))["filter_taps_fused"]
        mips = bool(fkw["mips"])
        ref = TS.filter_taps_reference(texq, idx, w, mips=mips)
        torch.cuda.synchronize()
        print(f"K5 inputs [{label}]: texq {tuple(texq.shape)}, "
              f"{idx.shape[0]} taps, mips {mips}")

        def k5_check(k, out, label=label, ref=ref):
            torch.cuda.synchronize()
            if not torch.equal(out.view(torch.int32), ref.view(torch.int32)):
                failed.append(f"K5 {k} [{label}]")

        t5[label] = in_turns(K5_VARIANTS, lambda k: filter_taps(
            k5[k], texq, idx, w, mips, torch), k5_check, C)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    card = smi.stdout.strip() if smi.returncode == 0 else "nvidia-smi failed"
    for k, ts in t9.items():
        print(f"K9 {k}: {ts[0]:.4f} / {ts[1]:.4f} ms ({card})")
    for label, tt in t5.items():
        for k, ts in tt.items():
            print(f"K5 {k} [{label}]: {ts[0]:.4f} / {ts[1]:.4f} ms ({card})")
    if failed:
        print(f"differ from the twin: {', '.join(failed)}", file=sys.stderr)
        return 1
    print("every variant bit-equal to its twin")
    return 0


if __name__ == "__main__":
    sys.exit(main())
