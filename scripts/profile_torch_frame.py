#!/usr/bin/env python3
"""Where the PyTorch port's frame spends its time, on one CUDA card.

Builds one of chip_smoke.py's scenes at --width x --height (--scene
stress: Stress-1080p-ibl-tex, bench.py's whole scene — geometry,
textures, the ring of 12 glass panes and lights — under an image
environment; --scene stress-untextured: the same without its textures;
--scene stress-volume: the panes with KHR transmission + volume and a
HUD box, chip_smoke.py's overlay (b) scene; --scene stress-msaa: the
stress scene in bench.py's headline configuration, MSAA + bloom + DoF,
chip_smoke.py's aa scene; --scene stress-temporal: the stress scene in
bench.py's temporal headline configuration, temporal AA + bloom + DoF on
bench.py's orbit arc, chip_smoke.py's temporal scene; --scene
stress-animated: bench.py's animated probe, the stress-msaa scene plus
its morph spheres, rotating nodes and skinned pillar under a static
camera, with update_all(1/60) before each frame, chip_smoke.py's
animated scene; --scene stress-animated-static: the same scene without
the updates; --scene stress-lights: bench.py's 64-light probe, the
stress scene plus 57 point lights with tiled light lists, chip_smoke.py's
lights scene; --scene stress-lights-dense: the same through the dense
loop; --scene stress-session: the stress scene with the editor's gizmo
attached to the colonnade's centre mesh, as chip_smoke.py's tools phase
steps it; --scene helmet: the glTF catalog's helmet),
warms up, then:
  1. renders --frames orbit frames with the profiler off: median ms/frame
     from CUDA events around each frame, and host wall ms/frame;
  2. renders --frames more under torch.profiler (CPU + CUDA activities)
     and prints the top device kernels by CUDA time, the device busy
     share (summed kernel time / wall time of the window) and the device
     kernels launched per frame.

Usage (repo root, one card):
    python3 scripts/profile_torch_frame.py
        [--scene stress|stress-untextured|stress-volume|stress-msaa|
                 stress-temporal|stress-animated|stress-animated-static|
                 stress-lights|stress-lights-dense|stress-session|helmet]
        [--width 1920 --height 1080]
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--scene", choices=("stress", "stress-untextured",
                                        "stress-volume", "stress-msaa",
                                        "stress-temporal", "stress-animated",
                                        "stress-animated-static",
                                        "stress-lights",
                                        "stress-lights-dense",
                                        "stress-session", "helmet"),
                    default="stress")
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_frame: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import awsm_renderer_tpu_torch as P
    import chip_smoke as CS

    CS.W, CS.H = args.width, args.height
    if args.scene.startswith("stress"):
        r, keys, _ = CS.build_stress_scene(
            P, np, "cuda", textured=args.scene != "stress-untextured",
            volume=args.scene == "stress-volume",
            hud=args.scene == "stress-volume",
            effects=args.scene not in ("stress", "stress-untextured",
                                       "stress-volume", "stress-lights",
                                       "stress-lights-dense",
                                       "stress-session"),
            temporal=args.scene == "stress-temporal",
            animated=args.scene.startswith("stress-animated"))
        if args.scene.startswith("stress-lights"):
            CS.add_probe_lights(P, np, r)
            r._force_dense_lights = args.scene == "stress-lights-dense"
        if args.scene == "stress-session":
            from awsm_renderer_tpu_torch.editor import TransformController

            TransformController(r).attach(
                r.meshes.get(keys[len(keys) // 2]).transform_key)
        CS.orbit_camera(r, np, 0)

        def camera(i):
            if args.scene == "stress-temporal":
                CS.temporal_camera(r, np, i)
            elif args.scene == "stress-animated":
                r.update_all(1.0 / 60.0)
            elif args.scene != "stress-animated-static":
                CS.orbit_camera(r, np, i)
    else:
        r, camera, _ = CS.build_helmet_scene(P, np, "cuda")
    for i in range(3):
        camera(i)
        r.render_device()
    torch.cuda.synchronize()

    ev = []
    t0 = time.perf_counter()
    for i in range(args.frames):
        camera(3 + i)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        r.render_device()
        b.record()
        ev.append((a, b))
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / args.frames
    ms = sorted(a.elapsed_time(b) for a, b in ev)
    q1, med, q3 = statistics.quantiles(ms, n=4)
    print(f"{args.scene} {args.width}x{args.height}, {args.frames} frames, "
          f"profiler off: "
          f"median {med:.3f} ms/frame (CUDA events; quartiles {q1:.3f} / "
          f"{q3:.3f}, min {ms[0]:.3f}, max {ms[-1]:.3f}); host wall "
          f"{wall:.3f} ms/frame")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(args.frames):
            camera(3 + args.frames + i)
            r.render_device()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kern) / 1e3
    n_kern = sum(e.count for e in kern)
    print(prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=args.top))
    print(f"profiled window: wall {wall_ms / args.frames:.3f} ms/frame; "
          f"device kernels {dev_ms / args.frames:.3f} ms/frame; busy share "
          f"{dev_ms / wall_ms:.3f}; {n_kern / args.frames:.0f} kernels/frame")
    return 0


if __name__ == "__main__":
    sys.exit(main())
