#!/usr/bin/env python3
"""K7 and K8 (csrc/binned.cu) by thread shape and register cap, on one
CUDA card, against the parent tree's kernel where one is given.

Each variant is a copy of csrc/binned.cu with its constants replaced: PX
(pixels a thread in the walk, along a row: 1024 / PX threads a CTA, warp
blocks 16 x 2 PX pixels) and MIN_BLOCKS (the CTAs an SM the registers must
allow, __launch_bounds__'s second argument). --parent DIR adds the
binned.cu of another checkout (a `git archive` of the parent commit
unpacked into DIR) as the variant "parent"; a source without
awsm_binned_info gets one appended, for its registers and residency.

Builds every copy (scripts/k1_slices.py build_variants: the package's
nvcc flags, one nvcc each, all started together, under
build/k7_k8_variants/), then chip_smoke.py's scenes at --width x
--height, and captures the frames' own inputs: K8's first compacted peel
on the stress frame (Stress-1080p-ibl-tex), K7's first band peel and its
HUD call without a peel on the volume + HUD frame. For each input it
prints the bins' shape (tiles, chunks a tile, the chunk visits hi-Z
leaves, the valid triangles a chunk) and, for each variant, the tests its
warps make, the two bounds, registers, local bytes, CTAs an SM and the
waves over the tiles. Then, in turns (the variants in order, then in
reverse, --repeat times), each variant is put behind the package's own
wrapper (the library's awsm_binned swapped), its output held bit-equal to
the plain twin, and timed three ways: chip_smoke.py's kernel_ms (one
event pair around 50 calls), host_us (the wrapper's host microseconds a
call) and device_ms (50 calls in one CUDA graph, replayed: the kernel's
own time). Prints the card's name and power limit.

Usage (repo root, one card):
    python3 scripts/k7_k8_variants.py [--parent DIR] [--repeat 2]
        [--width 1920 --height 1080]
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the package's binned.cu is the variant {} (its own constants: PX = 2,
# MIN_BLOCKS = 2)
VARIANTS = {"package": {},
            "px1_1": {"PX": 1, "MIN_BLOCKS": 1},
            "px1_2": {"PX": 1, "MIN_BLOCKS": 2},
            "px2_3": {"PX": 2, "MIN_BLOCKS": 3},
            "px4_2": {"PX": 4, "MIN_BLOCKS": 2},
            "px4_4": {"PX": 4, "MIN_BLOCKS": 4},
            "px4_6": {"PX": 4, "MIN_BLOCKS": 6}}
# appended before awsm_binned to a binned.cu without awsm_binned_info (the
# kernel of earlier trees: one CTA of NPX threads a tile, no warp cull)
ANCHOR = 'extern "C" int awsm_binned('
INFO = """extern "C" int awsm_binned_info(int* out, cudaStream_t stream) {
  (void)stream;
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, binned_kernel);
  int per_sm = 0;
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, binned_kernel,
                                                      NPX, 0);
  }
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = per_sm;
  out[3] = NPX;
  out[4] = 0;
  return (int)e;
}

"""


class _Swapped:
    """The package's library with awsm_binned replaced by a variant's."""

    def __init__(self, base, fn):
        self._base, self.awsm_binned = base, fn

    def __getattr__(self, name):
        return getattr(self._base, name)


def info_of(lib) -> dict:
    out = (ctypes.c_int * 5)()
    fn = lib.awsm_binned_info
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(ctypes.addressof(out), None)
    if rc != 0:
        raise RuntimeError(f"awsm_binned_info failed: cudaError_t {rc}")
    return dict(zip(("regs", "local_bytes", "ctas_per_sm", "threads",
                     "block_rows"), out))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=None)
    ap.add_argument("--repeat", type=int, default=2)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("k7_k8_variants: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import awsm_renderer_tpu_torch as P
    import chip_smoke as C
    from awsm_renderer_tpu_torch.ops import kernels
    from awsm_renderer_tpu_torch.ops import raster as TR
    from k1_slices import build_variants

    variants, paths = dict(VARIANTS), {}
    if args.parent:
        variants = {"parent": {}, **variants}
        paths["parent"] = os.path.join(args.parent, "awsm_renderer_tpu_torch",
                                       "csrc", "binned.cu")
    patches = {}
    for label in variants:
        with open(paths.get(label, os.path.join(kernels.CSRC,
                                                "binned.cu"))) as f:
            if "awsm_binned_info" not in f.read():
                patches[label] = [(ANCHOR, INFO + ANCHOR)]
    libs = {}
    fns = build_variants(kernels, "binned.cu", "awsm_binned", variants,
                         "k7_k8_variants", patches, paths, libs)
    infos = {k: info_of(lib) for k, lib in libs.items()}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    C.W, C.H = args.width, args.height

    # ---- the frames' own inputs -------------------------------------------
    r, _keys, _hud = C.build_stress_scene(P, np, "cuda")
    C.orbit_camera(r, np, 0)
    (rows8, zlo_c, zhi_c), kw8 = C.capture_first_frame(
        r, ("_rasterize_binned_compact",))["_rasterize_binned_compact"]
    del r
    r, _keys, _hud = C.build_stress_scene(P, np, "cuda", volume=True,
                                          hud=True)
    C.orbit_camera(r, np, 0)
    cap = C.capture_first_frame(r, ("rasterize_binned",))
    del r
    (rows7, zlo, zhi), kw7 = cap["rasterize_binned/peel"]
    (h_rows,), hkw = cap["rasterize_binned/nopeel"]
    hkw = dict(hkw, bins=TR.build_bins(
        h_rows, width=-(-hkw["width"] // TR.BT_W) * TR.BT_W,
        height=-(-hkw["height"] // TR.BT_H) * TR.BT_H))

    def band(kw):        # K7's tiles, its n_tx and its planes' pixels
        n_tx = -(-kw["width"] // TR.BT_W)
        n = -(-kw["height"] // TR.BT_H) * n_tx
        return torch.arange(n, device="cuda"), n_tx, kw["width"] * \
            kw["height"]

    names8 = TR.plane_layout(kw8["has_uv1"], kw8["has_color"])
    t7, ntx7, px7 = band(kw7)
    th, ntxh, pxh = band(hkw)
    cases = {
        "K8 stress, first peel": dict(
            run=lambda: TR._rasterize_binned_compact(rows8, zlo_c, zhi_c,
                                                     **kw8),
            ref=lambda: TR.rasterize_binned_compact_reference(
                rows8, zlo_c, zhi_c, bins=kw8["bins"],
                tile_idx=kw8["tile_idx"], n_tx=kw8["n_tx"], names=names8),
            work=(rows8, kw8["bins"], kw8["tile_idx"], kw8["n_tx"],
                  zlo_c.numel(), names8, (zlo_c, zhi_c)),
            walk_zb=(zlo_c, zhi_c)),
        "K7 volume + HUD, first peel": dict(
            run=lambda: TR.rasterize_binned(rows7, zlo, zhi, **kw7),
            ref=lambda: TR.rasterize_binned_reference(
                rows7, zlo, zhi, bins=kw7["bins"], width=kw7["width"],
                height=kw7["height"], names=TR.plane_layout(
                    kw7["has_uv1"], kw7["has_color"],
                    kw7["analytic_derivs"])),
            work=(rows7, kw7["bins"], t7, ntx7, px7, TR.plane_layout(
                kw7["has_uv1"], kw7["has_color"], kw7["analytic_derivs"]),
                (zlo, zhi)),
            walk_zb=(TR._pad_swizzle32(zlo, t7.numel() // ntx7 * TR.BT_H,
                                       ntx7 * TR.BT_W),
                     TR._pad_swizzle32(zhi, t7.numel() // ntx7 * TR.BT_H,
                                       ntx7 * TR.BT_W))),
        "K7 volume + HUD, the HUD": dict(
            run=lambda: TR.rasterize_binned(h_rows, **hkw),
            ref=lambda: TR.rasterize_binned_reference(
                h_rows, None, None, bins=hkw["bins"], width=hkw["width"],
                height=hkw["height"], names=TR.plane_layout(
                    hkw["has_uv1"], hkw["has_color"],
                    hkw["analytic_derivs"])),
            work=(h_rows, hkw["bins"], th, ntxh, pxh, TR.plane_layout(
                hkw["has_uv1"], hkw["has_color"], hkw["analytic_derivs"]),
                ()),
            walk_zb=None),
    }
    for label, c in cases.items():
        c["want"] = c["ref"]()
        rows, bins, tiles, n_tx = c["work"][:4]
        cnt = bins[1].long()[tiles.long()].float()
        q = torch.quantile(cnt, torch.tensor([0.25, 0.5, 0.75],
                                             device=cnt.device))
        visits = int(TR._binned_walk(rows, bins, tiles.long(), n_tx,
                                     c["walk_zb"])[4])
        valid = int((rows[:, 15] <= rows[:, 17]).sum())
        print(f"{label}: setup rows {tuple(rows.shape)} ({valid} valid "
              f"triangles in {rows.shape[0] // 128} chunks), {tiles.numel()}"
              f" tiles, chunks a tile quartiles {q[0]:.0f} / {q[1]:.0f} / "
              f"{q[2]:.0f}, max {int(cnt.max())}, {int(cnt.sum())} listed "
              f"(tile, chunk) pairs, {visits} merged after hi-Z, empty "
              f"tiles {int((cnt == 0).sum())}")
        for k, inf in infos.items():
            work = C.binned_work(*c["work"], torch,
                                 block_rows=inf["block_rows"])
            C.binned_log(f"[{k}]", work, inf, tiles.numel(), sms)

    # ---- in turns -----------------------------------------------------------
    base = kernels.lib()
    failed = []
    times = {(k, c): [] for k in variants for c in cases}
    labels = list(variants)
    try:
        for turn in range(args.repeat):
            for k in (labels if turn % 2 == 0 else labels[::-1]):
                kernels._lib = _Swapped(base, fns[k])
                for label, c in cases.items():
                    got = c["run"]()
                    torch.cuda.synchronize()
                    want = c["want"]
                    if sorted(got) != sorted(want) or not all(
                            torch.equal(got[n].view(torch.int32),
                                        want[n].view(torch.int32))
                            for n in want):
                        failed.append(f"{k} on {label}")
                    times[k, label].append((C.kernel_ms(c["run"]),
                                            C.host_us(c["run"]),
                                            C.device_ms(c["run"])))
    finally:
        kernels._lib = base

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    card = smi.stdout.strip() if smi.returncode == 0 else "nvidia-smi failed"
    for label in cases:
        for k in variants:
            ts = times[k, label]
            fmt = " / ".join
            print(f"{label} [{k}]: kernel_ms "
                  f"{fmt(f'{t[0]:.4f}' for t in ts)}, host_us "
                  f"{fmt(f'{t[1]:.1f}' for t in ts)}, device_ms "
                  f"{fmt(f'{t[2]:.4f}' for t in ts)} ({card})")
    if failed:
        print(f"differ from the twin: {', '.join(failed)}", file=sys.stderr)
        return 1
    print("every variant bit-equal to its twin")
    return 0


if __name__ == "__main__":
    sys.exit(main())
