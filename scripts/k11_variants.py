#!/usr/bin/env python3
"""K11a and K11b (csrc/dense.cu) by thread shape and register cap, a
scan-only form of each design, and the parent tree's kernel where one is
given, on one CUDA card.

Each variant is a copy of csrc/dense.cu with its constants replaced: PX
(pixels a thread along a row: 2 or a multiple of 4), ROWS (rows of an
8x128 tile a CTA owns: ROWS * 128 / PX threads a CTA, at most 512, which
is also the chunks a scan window tests) and MIN_BLOCKS (the CTAs an SM the registers must
allow). "scan_only" is the package's kernel with the
list, the merge and the flush cut out (the chunk and subgroup bbox scan
and its prefix sums, then tri_id and depth written as misses). --parent
DIR adds the dense.cu of another checkout (a `git archive` of the parent
commit unpacked into DIR) as "parent", and its scan-only form as
"parent_scan_only" (each thread's serial walk of every chunk bbox, no
staging, merge or flush); a source without awsm_dense_info gets one
appended, for its registers and residency.

Builds every copy (scripts/k1_slices.py build_variants: the package's
nvcc flags, one nvcc each, all started together, under
build/k11_variants/), then chip_smoke.py's scenes at --width x --height,
and captures the oracle's own inputs: the stress frame's opaque setup
(K11a fat at 1920x1080), the MSAA frame's setup (K11a slim at 3840x2160)
and the volume + HUD frame's first band peel (K11b). For each input it
prints the chunks and subgroups each tile lists (mean, max) and, for each
variant, its registers, local bytes, CTAs an SM and waves. Then, in turns
(the variants in order, then in reverse, --repeat times), each variant
is put behind the package's own wrapper (the library's awsm_dense
swapped), its output held bit-equal to the plain twin (scan-only forms
excepted), and timed three ways: chip_smoke.py's kernel_ms (one event
pair around 50 calls), host_us (the wrapper's host microseconds a call)
and device_ms (50 calls in one CUDA graph, replayed: the kernel's own
time). With --parent, K11b's host_us is also taken behind the parent's
wrapper (the parent checkout's own ops/raster.py, parent_raster below)
against the package's, both on the parent's kernel, in turns. Prints the card's name and power limit.

Usage (repo root, one card):
    python3 scripts/k11_variants.py [--parent DIR] [--repeat 2]
        [--width 1920 --height 1080]
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the package's dense.cu is the variant {} (its own constants)
VARIANTS = {"package": {},
            "px4_1": {"PX": 4, "ROWS": 8, "MIN_BLOCKS": 1},
            "px4_2": {"PX": 4, "ROWS": 8, "MIN_BLOCKS": 2},
            "px4_3": {"PX": 4, "ROWS": 8, "MIN_BLOCKS": 3},
            "px2_1": {"PX": 2, "ROWS": 8, "MIN_BLOCKS": 1},
            "px8_4": {"PX": 8, "ROWS": 8, "MIN_BLOCKS": 4},
            "r4_px4_2": {"PX": 4, "ROWS": 4, "MIN_BLOCKS": 2},
            "r4_px4_4": {"PX": 4, "ROWS": 4, "MIN_BLOCKS": 4},
            "r4_px2_2": {"PX": 2, "ROWS": 4, "MIN_BLOCKS": 2},
            "r2_px2_4": {"PX": 2, "ROWS": 2, "MIN_BLOCKS": 4},
            "scan_only": {}}
SCAN_ONLY = {
    "scan_only": [("    if (total == 0) continue;  // the same for every "
                   "thread", "    if (total >= 0) continue;  // scan only"),
                  ("  if (flags & SLIM) return;", "  return;")],
    "parent_scan_only": [("    if (!overlaps(bbox[c], tx0, ty0)) continue;  "
                          "// the same for every thread",
                          "    if (overlaps(bbox[c], tx0, ty0)) best = c;\n"
                          "    continue;  // scan only"),
                         ("  if (flags & SLIM) return;", "  return;")]}
# appended before awsm_dense to a dense.cu without awsm_dense_info (the
# kernel of earlier trees: one CTA of NPX threads a tile, one pixel each)
ANCHOR = 'extern "C" int awsm_dense('
INFO = """extern "C" int awsm_dense_info(int* out, int peel,
                               cudaStream_t stream) {
  (void)stream;
  (void)peel;
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, dense_kernel);
  int per_sm = 0;
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dense_kernel,
                                                      NPX, 0);
  }
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = per_sm;
  out[3] = NPX;
  out[4] = 1;
  return (int)e;
}

"""


class _Swapped:
    """The package's library with awsm_dense replaced by a variant's."""

    def __init__(self, base, fn):
        self._base, self.awsm_dense = base, fn

    def __getattr__(self, name):
        return getattr(self._base, name)


def parent_raster(parent: str):
    """The ops/raster.py of the checkout in `parent`, loaded as a module of
    this package (its relative imports resolve to this package's kernels
    and vertex), for its wrapper's host time."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "awsm_renderer_tpu_torch.ops._parent_raster",
        os.path.join(parent, "awsm_renderer_tpu_torch", "ops", "raster.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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
        print("k11_variants: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import awsm_renderer_tpu_torch as P
    import chip_smoke as C
    from awsm_renderer_tpu_torch.ops import kernels
    from awsm_renderer_tpu_torch.ops import raster as TR
    from k1_slices import build_variants

    variants, paths = dict(VARIANTS), {}
    patches = {k: list(v) for k, v in SCAN_ONLY.items()}
    if args.parent:
        variants.update(parent={}, parent_scan_only={})
        src = os.path.join(args.parent, "awsm_renderer_tpu_torch", "csrc",
                           "dense.cu")
        paths.update(parent=src, parent_scan_only=src)
    else:
        patches.pop("parent_scan_only")
    for label in variants:
        with open(paths.get(label, os.path.join(kernels.CSRC,
                                                "dense.cu"))) as f:
            if "awsm_dense_info" not in f.read():
                patches.setdefault(label, []).append((ANCHOR, INFO + ANCHOR))
    libs = {}
    fns = build_variants(kernels, "dense.cu", "awsm_dense", variants,
                         "k11_variants", patches, paths, libs)
    for lib in libs.values():
        lib.awsm_dense_info.argtypes = kernels._SIGNATURES["awsm_dense_info"]
        lib.awsm_dense_info.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    C.W, C.H = args.width, args.height

    # ---- the oracle's own inputs ------------------------------------------
    r, _keys, _hud = C.build_stress_scene(P, np, "cuda")
    C.orbit_camera(r, np, 0)
    (srows,), kw1 = C.capture_first_frame(
        r, ("rasterize16_slim",))["rasterize16_slim"]
    del r
    r, _keys, _hud = C.build_stress_scene(P, np, "cuda", effects=True)
    C.orbit_camera(r, np, 0)
    (mrows,), kw9 = C.capture_first_frame(
        r, ("rasterize16_msaa",))["rasterize16_msaa"]
    del r
    r, _keys, _hud = C.build_stress_scene(P, np, "cuda", volume=True,
                                          hud=True)
    C.orbit_camera(r, np, 0)
    (rows7, zlo, zhi), kw7 = C.capture_first_frame(
        r, ("rasterize_binned",))["rasterize_binned/peel"]
    del r
    lay = dict(has_uv1=kw7["has_uv1"], has_color=kw7["has_color"],
               analytic_derivs=kw7["analytic_derivs"])
    rw, rh = kw1["width"], kw1["height"]
    w2, h2 = kw9["width2"], kw9["height2"]
    w7, h7 = kw7["width"], kw7["height"]
    cases = {
        "K11a fat, stress": dict(
            run=lambda: TR.rasterize(srows, width=rw, height=rh,
                                     binned=False),
            ref=lambda: TR.rasterize_dense_reference(srows, width=rw,
                                                     height=rh),
            shape=(srows, rw, rh), peel=False),
        "K11a slim, MSAA at 2x": dict(
            run=lambda: TR.rasterize(mrows, width=w2, height=h2,
                                     binned=False, slim=True),
            ref=lambda: TR.rasterize_dense_reference(mrows, width=w2,
                                                     height=h2, slim=True),
            shape=(mrows, w2, h2), peel=False),
        "K11b, volume + HUD peel 0": dict(
            run=lambda: TR.rasterize_peel(rows7, zlo, zhi, width=w7,
                                          height=h7, binned=False, **lay),
            ref=lambda: TR.rasterize_peel_dense_reference(
                rows7, zlo, zhi, width=w7, height=h7, **lay),
            shape=(rows7, w7, h7), peel=True),
    }
    for label, c in cases.items():
        c["want"] = c["ref"]()
        torch.cuda.synchronize()
        print(f"{label}:")
        for k, lib in libs.items():
            C.dense_log(f"[{k}]", *c["shape"], C.dense_info(lib, c["peel"]),
                        sms, torch)

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
                    if "scan_only" not in k and (sorted(got) != sorted(want)
                                                 or not all(
                            torch.equal(got[n].view(torch.int32),
                                        want[n].view(torch.int32))
                            for n in want)):
                        failed.append(f"{k} on {label}")
                    del got
                    times[k, label].append((C.kernel_ms(c["run"]),
                                            C.host_us(c["run"]),
                                            C.device_ms(c["run"])))
        wrap = []
        if args.parent:
            kernels._lib = _Swapped(base, fns["parent"])
            PR = parent_raster(args.parent)

            def old():
                return PR.rasterize_peel(rows7, zlo, zhi, width=w7,
                                         height=h7, binned=False, **lay)

            new = cases["K11b, volume + HUD peel 0"]["run"]
            for turn in range(args.repeat):
                for f in ((old, new) if turn % 2 == 0 else (new, old)):
                    wrap.append(("parent's" if f is old else "package's",
                                 C.host_us(f)))
    finally:
        kernels._lib = base

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    card = smi.stdout.strip() if smi.returncode == 0 else "nvidia-smi failed"
    fmt = " / ".join
    for label in cases:
        for k in variants:
            ts = times[k, label]
            print(f"{label} [{k}]: kernel_ms "
                  f"{fmt(f'{t[0]:.4f}' for t in ts)}, host_us "
                  f"{fmt(f'{t[1]:.1f}' for t in ts)}, device_ms "
                  f"{fmt(f'{t[2]:.4f}' for t in ts)} ({card})")
    for who, us in wrap:
        print(f"K11b behind the {who} wrapper, the parent's kernel: host_us "
              f"{us:.1f} ({card})")
    if failed:
        print(f"differ from the twin: {', '.join(failed)}", file=sys.stderr)
        return 1
    print("every variant but the scan-only forms bit-equal to its twin")
    return 0


if __name__ == "__main__":
    sys.exit(main())
