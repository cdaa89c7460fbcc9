#!/usr/bin/env python3
"""K1's slice size on one CUDA card: csrc/raster16.cu's constant S (the
groups a work slice walks at most) at 8, 16 and 32.

Builds a copy of raster16.cu for each size (the constant replaced, the
package's nvcc flags, one nvcc each, all started together: build_variants,
which scripts/k9_k5_variants.py also uses) under build/k1_slices/, builds
chip_smoke.py's stress scene (Stress-1080p-ibl-tex) at --width x
--height, captures the first frame's
K1 inputs (setup rows and bins), and calls each build's awsm_raster16 on
them with the workspace rasterize16_slim would size for that S. Each
size's output is held bit-equal to the plain twin, then timed in turns
(8, 16, 32, 32, 16, 8) with chip_smoke.py's kernel_ms (one event pair
around 50 launches). Prints the card's name and power limit.

Usage (repo root, one card):
    python3 scripts/k1_slices.py [--width 1920 --height 1080]
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = (8, 16, 32)


def build_variants(kernels, source, entry, variants, out_name,
                   patches=None, paths=None, libs=None):
    """{label: the ctypes entry `entry` of a copy of csrc/`source` with
    constants replaced}: variants maps a label to {NAME: value}, each
    replacing the one `constexpr <type> NAME = ...;` of the source, and
    patches a label to (old, new) pairs, each replacing the one `old`
    text of the source. paths maps a label to another file to copy in
    place of csrc/`source` (its directory then on the include path), and
    libs, where given, receives each label's loaded library. The copies
    build with the package's nvcc flags (the source's directory on the
    include path), one nvcc each, all started together, under
    build/<out_name>/; ptxas's register and spill lines are printed."""
    out_dir = os.path.join(REPO, "build", out_name)
    os.makedirs(out_dir, exist_ok=True)
    paths = paths or {}
    stem = os.path.splitext(source)[0]
    procs = {}
    for label, consts in variants.items():
        path = paths.get(label, os.path.join(kernels.CSRC, source))
        with open(path) as f:
            text = f.read()
        for name, value in consts.items():
            const = re.compile(rf"constexpr (\w+) {name} = [^;]+;")
            if len(const.findall(text)) != 1:
                raise RuntimeError(f"{source}: no single `constexpr ... "
                                   f"{name}`")
            text = const.sub(rf"constexpr \1 {name} = {value};", text)
        for old, new in (patches or {}).get(label, ()):
            if text.count(old) != 1:
                raise RuntimeError(f"{source}: no single {old!r}")
            text = text.replace(old, new)
        cu = os.path.join(out_dir, f"{stem}_{label}.cu")
        with open(cu, "w") as f:
            f.write(text)
        procs[label] = subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I",
             os.path.dirname(path),
             "-shared", "-o", cu[:-3] + ".so", cu], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    entries = {}
    for label, p in procs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {stem}_{label}:\n{log}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas [{stem}_{label}]: {line.strip()}")
        lib = ctypes.CDLL(os.path.join(out_dir, f"{stem}_{label}.so"))
        if libs is not None:
            libs[label] = lib
        fn = getattr(lib, entry)
        fn.argtypes = kernels._SIGNATURES[entry]
        fn.restype = ctypes.c_int
        entries[label] = fn
    return entries


def build(kernels, sizes):
    """{S: ctypes entry awsm_raster16 of raster16.cu built with S}."""
    return build_variants(kernels, "raster16.cu", "awsm_raster16",
                          {s: {"S": s} for s in sizes}, "k1_slices")


def raster16(fn, S, srows, bins, w, h, torch, TR):
    """rasterize16_slim's launch, with the plan's workspace sized for S."""
    entries, offsets, counts, _z, big_packed, big_ids, n_big, _c = bins
    n_tx = -(-w // TR.BT_W)
    n_tiles = counts.numel()
    dev = srows.device
    col = torch.empty(h * w, dtype=torch.int32, device=dev)
    depth = torch.empty(h * w, dtype=torch.float32, device=dev)
    ws, nb_max, max_slices = TR._plan_workspace(srows, entries, n_tiles, S)
    scratch = torch.empty(n_tiles * 1024, dtype=torch.int64, device=dev)
    ptrs = [t.data_ptr() for t in (srows, entries, offsets, counts,
                                   big_packed, big_ids, n_big)]
    stream = torch._C._cuda_getCurrentRawStream(torch.cuda.current_device())
    rc = fn(*ptrs, n_tiles, n_tx, w, h, nb_max, max_slices, ws.data_ptr(),
            scratch.data_ptr(), col.data_ptr(), depth.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"awsm_raster16 (S = {S}) failed: cudaError_t {rc}")
    return col, depth


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("k1_slices: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import awsm_renderer_tpu_torch as P
    import chip_smoke as C
    from awsm_renderer_tpu_torch.ops import kernels
    from awsm_renderer_tpu_torch.ops import raster as TR

    fns = build(kernels, SIZES)
    C.W, C.H = args.width, args.height
    r, _keys, _hud = C.build_stress_scene(P, np, "cuda")
    C.orbit_camera(r, np, 0)
    (srows,), kw = C.capture_first_frame(r, ("rasterize16_slim",))[
        "rasterize16_slim"]
    w, h = kw["width"], kw["height"]
    _col, _depth, bins = TR.rasterize16_slim(srows, width=w, height=h)
    ccol, cdep = TR.rasterize16_slim_reference(srows, bins, width=w,
                                               height=h)
    torch.cuda.synchronize()
    print(f"K1 inputs: setup rows {tuple(srows.shape)}, {w}x{h}, max "
          f"{int(bins[2].max())} groups a tile, {int(bins[6])} big groups")
    times = {s: [] for s in SIZES}
    for s in SIZES + SIZES[::-1]:
        def run():
            return raster16(fns[s], s, srows, bins, w, h, torch, TR)

        col, depth = run()
        torch.cuda.synchronize()
        if not (torch.equal(col, ccol)
                and torch.equal(depth.view(torch.int32),
                                cdep.view(torch.int32))):
            print(f"K1 at slice size {s} differs from the twin",
                  file=sys.stderr)
            return 1
        times[s].append(C.kernel_ms(run))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    card = smi.stdout.strip() if smi.returncode == 0 else "nvidia-smi failed"
    for s, ts in times.items():
        print(f"K1 slice size {s}: {ts[0]:.4f} / {ts[1]:.4f} ms, bit-equal "
              f"to the twin ({card})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
