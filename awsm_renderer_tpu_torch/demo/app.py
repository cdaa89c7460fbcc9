"""Demo / debug application — the reference frontend's analog as a CLI.

Port of demo/app.py on the PyTorch port: the same flags, plus --device
(default cuda; cpu renders through the kernels' plain twins). The
reference frontend (crates/frontend) is a browser app: canvas + rAF
loop + sidebar toggles + model catalog + orbit camera. Headless
equivalent: a CLI that loads a scene (procedural catalog entry or a
.gltf/.glb path), runs the update/render loop with an orbiting camera, and
writes PNG frames (and optionally an MP4). Sidebar toggles become flags.

Usage:
    python -m awsm_renderer_tpu_torch.demo.app --scene box-textured \
        --frames 8 --out frames
    python -m awsm_renderer_tpu_torch.demo.app --gltf model.glb \
        --width 1280 --height 720 --bloom --smaa --orbit
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    src = p.add_mutually_exclusive_group()
    src.add_argument("--scene", default="box",
                     help="procedural scene name (see --list)")
    src.add_argument("--gltf", help="path to a .gltf/.glb asset")
    p.add_argument("--list", action="store_true", help="list scenes and exit")
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=288)
    p.add_argument("--frames", type=int, default=1)
    p.add_argument("--out",
                   default=os.path.join(tempfile.gettempdir(), "awsm_demo"))
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (cuda, cpu)")
    p.add_argument("--orbit", action="store_true", help="orbit camera over frames")
    p.add_argument("--fps", type=float, default=30.0, help="animation dt = 1/fps")
    p.add_argument("--tonemap", choices=["none", "khronos", "aces"], default="khronos")
    p.add_argument("--bloom", action="store_true")
    p.add_argument("--dof", action="store_true")
    p.add_argument("--smaa", action="store_true")
    p.add_argument("--supersample", action="store_true")
    p.add_argument("--msaa", action="store_true",
                   help="MSAA-4x equivalent (2x2 coverage, per-pixel shade)")
    p.add_argument("--no-mips", action="store_true")
    p.add_argument("--grid", action="store_true", help="editor ground grid")
    def _debug_mode(v):
        from awsm_renderer_tpu_torch.ops.shade import DEBUG_CHANNELS

        if v in ("none", "normals", "ibl", "punctual", "edges"):
            return v
        if v.startswith("channel:") and v.split(":", 1)[1] in DEBUG_CHANNELS:
            return v
        import argparse as _ap

        raise _ap.ArgumentTypeError(
            f"unknown debug mode {v!r}; expected none|normals|ibl|punctual|"
            f"edges|channel:<{'|'.join(sorted(DEBUG_CHANNELS))}>")

    p.add_argument("--debug", type=_debug_mode, default="none",
                   help="shader debug variant: none|normals|ibl|punctual|"
                        "edges (MSAA edge view, needs --msaa)|channel:<name> "
                        "(global material-channel isolation)")
    p.add_argument("--report", action="store_true", help="print store reports")
    p.add_argument("--timings", action="store_true")
    p.add_argument("--mp4", help="also write an mp4 at this path (cv2)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from awsm_renderer_tpu_torch.demo.scenes import SCENES
    from awsm_renderer_tpu_torch.gltf.samples import SAMPLES

    if args.list:
        for name in SCENES:
            print(name)
        for name in SAMPLES:      # generated GLB catalog (collections.rs analog)
            print(name)
        return 0

    from awsm_renderer_tpu_torch import (
        AntiAliasing, AwsmRendererTorch, PostProcessing, RendererConfig,
        ToneMapping,
    )
    from awsm_renderer_tpu_torch.utils import math3d as m3

    tm = {"none": ToneMapping.NONE, "khronos": ToneMapping.KHRONOS_PBR_NEUTRAL,
          "aces": ToneMapping.ACES}[args.tonemap]
    r = AwsmRendererTorch(RendererConfig(
        width=args.width, height=args.height,
        post_processing=PostProcessing(tonemapping=tm, bloom=args.bloom, dof=args.dof),
        anti_aliasing=AntiAliasing(supersample=args.supersample,
                                   msaa=args.msaa, smaa=args.smaa,
                                   mipmap=not args.no_mips),
    ), device=args.device)

    eye, center = (2.5, 1.8, 3.5), (0, 0, 0)
    catalog_cam = False
    if not args.gltf and args.scene in SAMPLES:
        # generated sample-model catalog entry: write the GLB and route it
        # through the real loader path, exactly like --gltf (the reference
        # frontend fetches its catalog models the same way)
        from awsm_renderer_tpu_torch.gltf.samples import write_sample

        tmp = tempfile.NamedTemporaryFile(suffix=".glb", delete=False)
        tmp.close()
        cam = write_sample(args.scene, tmp.name)
        args.gltf = tmp.name
        eye, center = cam
        catalog_cam = True    # keep the catalog's tuned framing
    if args.gltf:
        from awsm_renderer_tpu_torch.gltf.loader import load_gltf
        from awsm_renderer_tpu_torch.gltf.populate import populate_gltf

        data = load_gltf(args.gltf)
        lookups = populate_gltf(r, data)
        print(f"loaded {args.gltf}: {len(lookups.node_transforms)} nodes, "
              f"{r.meshes.count} meshes, {len(lookups.material_keys)} materials",
              file=sys.stderr)
        # authored glTF camera wins (GltfKeyLookups.cameras — the
        # reference frontend consumes scene cameras the same way);
        # otherwise frame the scene by its bounds (AABB-fit camera)
        if lookups.cameras and not catalog_cam:
            cam = next(iter(lookups.cameras.values()))
            w = cam["world"]
            eye = w[:3, 3]
            center = eye - w[:3, 2]      # glTF cameras look down -Z
            print(f"using authored {cam['type']} camera", file=sys.stderr)
        else:
            mins, maxs, _ = r.meshes.world_bounds()
            if len(mins) and not catalog_cam:
                c = (mins.min(axis=0) + maxs.max(axis=0)) / 2
                radius = float(np.linalg.norm(
                    maxs.max(axis=0) - mins.min(axis=0)) / 2) or 1.0
                center = c
                eye = c + np.array([0.8, 0.5, 1.2]) * radius * 1.8
        if r.lights.count == 0:
            from awsm_renderer_tpu_torch import Light

            r.lights.insert(Light.directional([-0.5, -1, -0.3], intensity=3.0))
    else:
        scene_fn = SCENES[args.scene]
        info = scene_fn(r) or {}
        if "camera" in info:
            eye, center = info["camera"]

    if args.grid:
        from awsm_renderer_tpu_torch.editor import Grid

        Grid(r)

    if args.timings:
        r.logging_timings = True  # per-pass spans (reference render_timings)

    os.makedirs(args.out, exist_ok=True)
    proj = m3.perspective(np.pi / 3, args.width / args.height, 0.05, 500.0)
    eye = np.asarray(eye, np.float64)
    center = np.asarray(center, np.float64)

    from PIL import Image

    frames = []
    dt = 1.0 / args.fps
    for i in range(args.frames):
        if args.orbit and args.frames > 1:
            ang = 2 * np.pi * i / args.frames
            off = eye - center
            rad = np.linalg.norm(off[[0, 2]])
            ang0 = np.arctan2(off[2], off[0])
            e = center + np.array([rad * np.cos(ang0 + ang), off[1],
                                   rad * np.sin(ang0 + ang)])
        else:
            e = eye
        view = m3.look_at(e, center, (0, 1, 0))
        r.update_all(dt, view, proj)
        t0 = time.perf_counter()
        if args.debug != "none":
            img = (np.clip(r.render(debug_mode=args.debug), 0, 1) * 255 + 0.5).astype(np.uint8)
        else:
            img = r.render_u8()
        ms = (time.perf_counter() - t0) * 1000
        path = os.path.join(args.out, f"frame_{i:04d}.png")
        Image.fromarray(img).save(path)
        if args.timings:
            print(f"frame {i}: {ms:.1f} ms -> {path}", file=sys.stderr)
        frames.append(img)

    if args.timings and r.timings.frames:
        mean = r.timings.summary()
        print("per-pass mean: "
              + "  ".join(f"{k}={v*1000:.2f}ms" for k, v in sorted(mean.items())),
              file=sys.stderr)
        dev = r.timings.device_summary()     # CUDA events, on the card
        if dev:
            print("per-pass device mean: "
                  + "  ".join(f"{k}={v*1000:.2f}ms"
                              for k, v in sorted(dev.items())),
                  file=sys.stderr)

    if args.mp4 and frames:
        import cv2

        h, w = frames[0].shape[:2]
        vw = cv2.VideoWriter(args.mp4, cv2.VideoWriter_fourcc(*"mp4v"), args.fps, (w, h))
        for f in frames:
            vw.write(cv2.cvtColor(f, cv2.COLOR_RGBA2BGR))
        vw.release()
        print(f"wrote {args.mp4}", file=sys.stderr)

    if args.report:
        from awsm_renderer_tpu_torch.utils.exporter import (
            geometry_report, texture_report,
        )

        print(json.dumps({
            "geometry": geometry_report(r.meshes),
            "textures": texture_report(r.textures) | {"textures": "..."},
        }, default=str, indent=2), file=sys.stderr)

    print(os.path.join(args.out, "frame_0000.png"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
