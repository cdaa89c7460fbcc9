#!/usr/bin/env python3
"""Smoke run of the PyTorch port (awsm_renderer_tpu_torch) on one CUDA card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA device and exits non-zero without one (it never falls
back to the CPU). Phases:

  build    compile the port's CUDA kernels (csrc/) from the checkout;
  scene    build bench.py's whole 1080p stress scene "Stress-1080p-ibl-tex"
           through the port's API (15x15 colonnade of boxes and spheres,
           ~259k triangles, 12 random PBR materials with bench.py's three
           sRGB 128x128 checker base-colour textures and mip chains, seed
           42, the ring of 12 alpha-blended glass panes, 1 directional + 6
           point lights) under the procedural "env-ibl" equirect
           environment at size 128;
  kernels  run K1 raster, K2 resolve, K3 material fetch, K4 tap planner,
           K5 texel filter and K6 env-tap gather on the first frame's real
           (opaque-pass) intermediates, each against its plain PyTorch
           twin on the card (K1/K3/K5/K6 bit-equal, K2 ints equal and
           floats rtol 1e-5 atol 1e-6, K4 indices equal and weights within
           1e-6 except at taps whose LOD lies within 1e-5 of an integer,
           fewer than 0.01% of taps), and time both; K4 and K5 again on
           the helmet frame's five-tap batch;
  frame    render 12 stress frames under a camera orbit, check that every
           kernel of the path launched on each frame (K8's compacted peel
           for the panes included), that the image is finite with both sky
           and geometry, and that pick() agrees with the tri_id plane;
  overlay  (a) the stress frame's overlay: the compaction (C of n_tiles),
           layer clamp and crop band of its prep, K8 against its twin bit
           for bit on the first frame's first peel, timed, and the host
           syncs of two frames on a moving camera; (b) the same scene with
           the panes given KHR transmission + volume (thickness 0.5, which
           turns the crop and the compaction off) and one HUD box: 12
           orbit frames with K7 (peel and non-peel) and K6's f32 entry
           launched on every frame, each held bit for bit against its twin
           on the first frame's intermediates and timed, and pick() at the
           HUD box's centre returning its key;
  aa       bench.py's headline frame "Stress-1080p-msaa-bloom-dof": the
           stress scene, panes included, with MSAA-4x, bloom and depth of
           field (focus 16 m, f/1); K9 against its twin bit for bit on the
           first frame's own setup rows and bins, timed, with the bins'
           entry count, n_big and the tiles the reference's caps would
           clip; K2's coord_scale=2 and explicit-px/py entries against
           the twin; 12 orbit frames with K9 (and K8 for the panes)
           launched on each, the image, pick() against the sample plane,
           host syncs; then 3 supersample frames (peak device memory) and
           one SMAA frame of the stress scene;
  oracle   the dense raster K11a and dense peel K11b (no frame path runs
           them) as an independent check of the binned kernels on the
           frames' own 1080p intermediates: K11a fat against K1 + K2 on
           the stress frame's opaque setup, K11b against K7 on each peel
           of the volume + HUD frame and against K8 on each of the stress
           frame's pane peels at K8's covered tiles, K11a slim at
           3840x2160 against K9's four sample planes of the MSAA frame.
           Every tri_id mismatch must be an exact depth tie (the walk
           order picks) or, against K9, a sample where an edge value or
           the two candidates' z lie within 4 ulps (K9's e00 + a + b
           rounding). Where the ids agree, depth is bit-equal (against
           K9, whose min-sample depth rounds the same way, within 4 ulps
           of the z-plane terms) and the fat planes within 1e-4 (both
           flushes are K2's resolve_math.cuh; the twin check holds K11's
           against the plain flush). Then K11a fat (the stress frame's
           1080p setup) and slim (the MSAA frame's, at 3840x2160) and
           K11b (the volume + HUD frame's first peel), the oracle's own
           calls, K12 split_rows on an (8, 1920*1080) f32 table and K13
           channel_rows on a (1920*1080, 4) bf16 block against their
           twins, bit for bit, timed beside their bounds (K12 and K13
           also beside one torch call computing the same function);
  temporal bench.py's temporal headline "Stress-1080p-temporal-orbit": the
           stress scene with temporal AA (K1 jittered, K10 history
           reprojection, C = 243 of 2,025 (8, 128) units shaded a frame),
           bloom and DoF, on bench.py's orbit arc: one reset frame, then
           orbit frames; the valid and blendable shares on the boxes and
           on the spheres of the two frames after the reset; K10 against
           its twin bit for bit on a steady frame's own inputs, timed; 24
           timed orbit frames with K1, K2, K3, K4, K5, K6, K8 and K10
           launched on each, C and the valid and blendable shares printed
           per frame, host syncs on a moving camera; then
           tests/test_temporal.py's
           convergence check (the 128x32 box, 8 static temporal frames
           against the ordinary frame) on the card;
  gltf     build the glTF catalog's helmet (five 1024x1024 maps) with the
           port's gltf/samples.py, load_gltf + populate_gltf it at 1080p
           under the same environment, render 12 orbit frames and check
           launches and the image;
  golden   render the 128x64 "box", "env-ibl", "box-textured",
           "alpha-blend", "effect-refraction", "effect-bloom",
           "effect-dof", "effect-smaa" and "effect-msaa" probes, the
           1024x512 "parity-production-msaa-1024", the 256x128 glTF
           goldens "glb-helmet", "glb-texture-transform", "glb-multi-uv",
           "glb-ext-clearcoat", "glb-alpha-modes", "glb-ext-transmission"
           and "glb-sponza-lite", and the nine 512x256 parity goldens
           "parity-glb-helmet-512", "parity-glb-alpha-modes-512" and
           "parity-ext-{anisotropy,clearcoat,iridescence,sheen,specular,
           transmission,unlit}-512" on the card (26 goldens), each at the
           tolerance of the JAX test that owns it.

Prints one line per check, then a JSON line of per-kernel results (time,
twin time, the least time the card could take for the same work and
which of bytes or operations sets it, and a single PyTorch call's time
where one computes the same function), the card's name and power limit,
and last the ok line. Any failed phase raises, and the script exits
non-zero.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

W, H = 1920, 1080
N_FRAMES = 12
HUD_AT = (0.0, 2.5, 0.0)     # the overlay phase's HUD box, above the ring
STRESS_GRID = 7     # bench.py's colonnade: gx, gz in [-7, 7] (15 x 15)
DEVICE = "cuda"     # the card; a CPU rehearsal of the phases sets "cpu"
REPO = os.path.dirname(os.path.abspath(__file__))


def log(msg: str) -> None:
    print(msg, flush=True)


class CheckFailed(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)
    log(f"  ok: {msg}")


def cuda_ms(fn, reps: int) -> float:
    """Median ms of `fn()` over `reps` runs (after one warm-up), timed
    with CUDA events around each call."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# One H100 SXM's published peaks (NVIDIA's data sheet; at the 700 W
# limit): HBM bandwidth and float32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# float operations of one triangle-pixel coverage test: three edge
# functions and the z plane, each a*px + (b*py + c)
OPS_PER_TEST = 16
# K9's four samples of one triangle-pixel: the full test at the top-left
# sample, then per plane + a (top-right), + b (bottom-left), + a + b
# (bottom-right): 16 + 4 + 4 + 8
OPS_PER_MSAA_PIXEL = 32


def bound(nbytes: float, nops: float):
    """The least ms the card could take: the larger of `nbytes` over the
    memory rate and `nops` over the float32 rate, and which one it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def unique_rows(idx, n_rows: int) -> int:
    """Distinct rows that clamped indices `idx` touch in an n_rows table
    (what a gather must read at least once)."""
    import torch

    return int(torch.unique(idx.clamp(0, n_rows - 1)).numel())


def env_ibl_equirect(np):
    """The procedural equirect of demo/scenes.py scene_env_ibl."""
    eq = np.zeros((32, 64, 3), np.float32)
    v = np.linspace(0, 1, 32)[:, None]
    eq[..., 0] = 0.2 + 0.8 * v
    eq[..., 1] = 0.3 + 0.25 * v
    eq[..., 2] = 1.0 - 0.8 * v
    return eq


def build_stress_scene(P, np, device, textured=True, panes=True,
                       volume=False, hud=False, effects=False,
                       temporal=False):
    """bench.py build_stress_scene — geometry, textures, the ring of 12
    alpha-blended glass panes and lights — through the port's API, with
    effects=False unless `effects`: then bench.py's headline
    configuration, MSAA-4x with mipmaps, bloom and depth of field focused
    at 16 m with aperture f/1 (bench.py:121-126, :210-211); temporal=True
    swaps MSAA for temporal AA (bench.py's temporal=True).
    textured=False leaves the base-colour slots unbound (the untextured
    frame of earlier runs); panes=False leaves the panes out (the
    opaque-only scene of earlier runs); volume=True gives the panes'
    glass KHR transmission and volume (transmission 1, thickness 0.5, ior
    1.5: screen-space refraction); hud=True adds one HUD box above the
    ring. Returns (renderer, opaque mesh keys, HUD key or None)."""
    from awsm_renderer_tpu_torch.core.materials import TS_BASE_COLOR
    from awsm_renderer_tpu_torch.geometry import (
        box, checker_texture, uv_sphere,
    )

    r = P.AwsmRendererTorch(P.RendererConfig(
        width=W, height=H,
        post_processing=P.PostProcessing(bloom=effects, dof=effects),
        anti_aliasing=P.AntiAliasing(msaa=effects and not temporal,
                                     temporal=temporal, mipmap=True)),
        device=device)
    r.camera.dof.focus_distance = 16.0
    r.camera.dof.aperture = 1.0
    rng = np.random.default_rng(42)
    tex_ids = [r.textures.add_image(checker_texture(
        128, c, tuple(rng.integers(100, 255, 3)),
        tuple(rng.integers(0, 80, 3))), srgb=True) for c in (4, 8, 16)]
    mats = [r.materials.insert(P.PbrMaterial(
        base_color_factor=np.array([*rng.uniform(0.3, 1.0, 3), 1.0],
                                   np.float32),
        metallic_factor=float(rng.uniform(0, 1)),
        roughness_factor=float(rng.uniform(0.2, 0.9)),
        textures=({TS_BASE_COLOR: P.TextureRef(
            r.textures.row_of(tex_ids[i % 3]))} if textured else {})))
        for i in range(12)]
    vol = (dict(transmission_factor=1.0, thickness=0.5, ior=1.5)
           if volume else {})
    glass = r.materials.insert(P.PbrMaterial(
        base_color_factor=np.array([0.4, 0.7, 0.9, 0.4], np.float32),
        alpha_mode=P.AlphaMode.BLEND, roughness_factor=0.1,
        metallic_factor=0.0, **vol))
    box_res = r.meshes.insert_resource(box(0.8))
    sph_res = r.meshes.insert_resource(uv_sphere(0.45, rings=24, sectors=48))
    pane_res = r.meshes.insert_resource(box(0.9))
    keys = []
    for gx in range(-STRESS_GRID, STRESS_GRID + 1):
        for gz in range(-STRESS_GRID, STRESS_GRID + 1):
            res = box_res if (gx + gz) % 2 == 0 else sph_res
            mat = mats[(gx * 15 + gz) % 12]
            tk = r.transforms.insert(P.Transform(translation=np.array(
                [gx * 1.6, float(rng.uniform(-0.3, 0.3)), gz * 1.6],
                np.float32)))
            r.transforms.update_world()
            keys.append(r.meshes.insert(res, r.transforms.row_of(tk),
                                        r.materials.row_of(mat), tk, mat))
    for i in range(12 if panes else 0):
        a = 2 * np.pi * i / 12
        tk = r.transforms.insert(P.Transform(translation=np.array(
            [np.cos(a) * 4.5, 1.2, np.sin(a) * 4.5], np.float32)))
        r.transforms.update_world()
        r.meshes.insert(pane_res, r.transforms.row_of(tk),
                        r.materials.row_of(glass), tk, glass,
                        transparent=True)
    r.meshes.update_world(r.transforms)
    hud_key = None
    if hud:
        hud_key = r.add_mesh(box(0.6), r.materials.insert(P.UnlitMaterial(
            base_color_factor=np.array([0.1, 0.9, 0.2, 1], np.float32))),
            transform=P.Transform(translation=np.array(HUD_AT, np.float32)),
            hud=True)
    r.lights.insert(P.Light.directional([-0.5, -1, -0.3], intensity=2.0))
    for i in range(6):
        r.lights.insert(P.Light.point(
            [np.cos(i) * 6, 2.0, np.sin(i) * 6],
            color=tuple(rng.uniform(0.4, 1, 3)), intensity=10.0, range=15.0))
    r.environment.set_environment_from_equirect(env_ibl_equirect(np),
                                                size=128)
    return r, keys, hud_key


def orbit_camera(r, np, i: int, rad=None, height=7.0):
    from awsm_renderer_tpu_torch.utils import math3d as m3

    a = np.pi / 4 + 0.05 * i
    rad = float(np.hypot(10.0, 10.0)) if rad is None else rad
    view = m3.look_at([np.cos(a) * rad, height, np.sin(a) * rad], [0, 0, 0],
                      [0, 1, 0])
    r.camera.update(view, m3.perspective(np.pi / 3, W / H, 0.1, 200.0))


KERNEL_SITES = ("rasterize16_slim", "resolve_planes_fused",
                "onehot_split_rows", "tap_plan_fused", "filter_taps_fused",
                "gather_split_channels")


def capture_first_frame(r, names=KERNEL_SITES, calls=None):
    """Render one frame with recorders on the kernel wrappers `names`;
    return the arguments of each wrapper's first call on the main path
    (for rasterize_binned, of its first peel call under
    "rasterize_binned/peel" and of its first call without a peel under
    "rasterize_binned/nopeel"). A dict `calls` collects every call's
    arguments, in order, under the same keys."""
    from awsm_renderer_tpu_torch.ops import (
        cubemap, raster, relayout, shade, temporal, texsample,
    )
    from awsm_renderer_tpu_torch.passes import frame

    captured = {}
    # the modules whose global the main path calls each wrapper through
    where = {"rasterize16_slim": (raster,),
             "resolve_planes_fused": (shade, frame),
             "onehot_split_rows": (shade,), "tap_plan_fused": (texsample,),
             "filter_taps_fused": (texsample,),
             "gather_split_channels": (cubemap,),
             "rasterize_binned": (raster,),
             "_rasterize_binned_compact": (raster,),
             "gather_split_channels_f32": (relayout,),
             "rasterize16_msaa": (frame,),
             "reproject_history_planes": (temporal,)}
    sites = tuple((mod, n) for n in names for mod in where[n])
    originals = [getattr(mod, attr) for mod, attr in sites]

    def recorder(attr, fn):
        def wrapped(*args, **kwargs):
            key = attr
            if attr == "rasterize_binned":
                peel = (args[1] if len(args) > 1
                        else kwargs.get("zlo")) is not None
                key = f"{attr}/{'peel' if peel else 'nopeel'}"
            elif attr == "resolve_planes_fused" and \
                    kwargs.get("px") is not None:
                key = f"{attr}/xy"
            captured.setdefault(key, (args, kwargs))
            if calls is not None:
                calls.setdefault(key, []).append((args, kwargs))
            return fn(*args, **kwargs)
        return wrapped

    try:
        for (mod, attr), fn in zip(sites, originals):
            setattr(mod, attr, recorder(attr, fn))
        r.render_device()
    finally:
        for (mod, attr), fn in zip(sites, originals):
            setattr(mod, attr, fn)
    return captured


def bit_mismatches(a, b, torch) -> int:
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return int((a != b).sum())


def phase_kernels(r, np, torch):
    """First-frame intermediates -> each kernel vs its twin, timed.
    Returns (results, the first call's arguments per wrapper, the
    arguments of every K8 peel)."""
    from awsm_renderer_tpu_torch.ops import kernels
    from awsm_renderer_tpu_torch.ops.raster import (
        build_bins16, rasterize16_slim, rasterize16_slim_reference,
    )
    from awsm_renderer_tpu_torch.ops.relayout import (
        gather_split_channels, gather_split_channels_reference,
        onehot_split_rows, onehot_split_rows_reference,
    )
    from awsm_renderer_tpu_torch.ops.shade import (
        RESOLVE_NAMES, resolve_planes_fused, resolve_planes_reference,
    )

    log("phase kernels: the first frame's (opaque-pass) intermediates")
    calls = {}
    cap = capture_first_frame(r, KERNEL_SITES + ("_rasterize_binned_compact",),
                              calls)
    torch.cuda.synchronize()
    check(sorted(cap) == sorted(KERNEL_SITES + ("_rasterize_binned_compact",)),
          "the first frame called the six opaque-pass kernel wrappers and "
          "K8's")
    results = {}

    # ---- K1 ---------------------------------------------------------------
    (srows,), kw = cap["rasterize16_slim"]
    rw, rh = kw["width"], kw["height"]
    log(f"  setup rows {tuple(srows.shape)} f32, raster {rw}x{rh}")
    ref_bins = build_bins16(srows, width=-(-rw // 32) * 32,
                            height=-(-rh // 32) * 32)
    log(f"  tiles the reference's bin caps (65536 entries, 127 groups per "
        f"tile) would clip: {int(ref_bins[7].item())}")
    col, depth, bins = rasterize16_slim(srows, width=rw, height=rh)
    ccol, cdep = rasterize16_slim_reference(srows, bins, width=rw, height=rh)
    torch.cuda.synchronize()
    counts = bins[2]
    log(f"  bins: {counts.numel()} tiles, max {int(counts.max())} groups per "
        f"tile, {int(counts.sum())} pairs, {int(bins[6].item())} big groups, "
        f"clipped tiles {int(bins[7].item())}")
    n_bad = bit_mismatches(col, ccol, torch) + bit_mismatches(depth, cdep,
                                                              torch)
    err = float((depth - cdep).abs().max())
    log(f"  K1 rasterize16_slim col {tuple(col.shape)} int32 + depth "
        f"{tuple(depth.shape)} f32: {n_bad} mismatching values, max "
        f"|ddepth| {err}")
    check(n_bad == 0, "K1 col and depth bit-equal to the plain twin")
    check(int((col >= 0).sum()) > 0, "K1 covers pixels")
    # the coverage tests the bins ask for: every binned (tile, group)
    # pair, big groups against every tile
    n_tiles = counts.numel()
    tests = ((int(counts.sum()) + int(bins[6].item()) * n_tiles) * 16
             * 32 * 32)
    results["K1"] = dict(
        err=err,
        ms=cuda_ms(lambda: rasterize16_slim(srows, bins, width=rw,
                                            height=rh), 20),
        plain_ms=cuda_ms(lambda: rasterize16_slim_reference(
            srows, bins, width=rw, height=rh), 2),
        bound=bound(nbytes(srows, *bins, col, depth), tests * OPS_PER_TEST),
        library_ms=None)

    # ---- K2 ---------------------------------------------------------------
    (tid, srows2), kw = cap["resolve_planes_fused"]
    res = resolve_planes_fused(tid, srows2, **kw)
    ref = resolve_planes_reference(tid, srows2, **kw)
    torch.cuda.synchronize()
    check(torch.equal(res["tri_id"], ref["tri_id"]), "K2 tri_id equal")
    err, n_bad = 0.0, 0
    for name in RESOLVE_NAMES[1:]:
        a, b = res[name], ref[name]
        err = max(err, float((a - b).abs().max()))
        n_bad += int((~torch.isclose(a, b, rtol=1e-5, atol=1e-6)).sum())
    log(f"  K2 resolve_planes_fused tid {tuple(tid.shape)} -> 21 planes: "
        f"{n_bad} values outside rtol 1e-5 atol 1e-6, max |d| {err}")
    check(n_bad == 0, "K2 planes within rtol 1e-5, atol 1e-6 of the twin")
    # the winners' 256-byte setup rows, once each, the ids and 20 planes
    n_win = unique_rows(tid[tid >= 0], srows2.shape[0])
    results["K2"] = dict(
        err=err,
        ms=cuda_ms(lambda: resolve_planes_fused(tid, srows2, **kw), 20),
        plain_ms=cuda_ms(lambda: resolve_planes_reference(tid, srows2, **kw),
                         5),
        bound=bound(n_win * 256 + tid.numel() * 4 * 22, 0.0),
        library_ms=None)

    # ---- K3 ---------------------------------------------------------------
    (mat_row, table), _ = cap["onehot_split_rows"]
    a = onehot_split_rows(mat_row, table)
    b = onehot_split_rows_reference(mat_row, table)
    bad_rows = mat_row.clone()       # rows outside the table read zeros
    bad_rows[:6] = torch.tensor([-1, -5, table.shape[0], 10 ** 6, 0, 1],
                                dtype=torch.int32, device=r.device)
    ax = onehot_split_rows(bad_rows, table)
    bx = onehot_split_rows_reference(bad_rows, table)
    torch.cuda.synchronize()
    err = float((a - b).abs().max())
    n_bad = bit_mismatches(a, b, torch)
    n_bad_x = bit_mismatches(ax, bx, torch)
    log(f"  K3 onehot_split_rows rows {tuple(mat_row.shape)} x table "
        f"{tuple(table.shape)} -> {tuple(a.shape)}: {n_bad} mismatches "
        f"({n_bad_x} with out-of-range rows)")
    check(n_bad == 0 and n_bad_x == 0, "K3 bit-equal to the twin")
    # the library yardstick: one index_select of the transposed table
    # (in-range rows; K3 also zeroes rows outside the table)
    table_t = table.T.contiguous()
    safe = mat_row.clamp(0, table.shape[0] - 1)
    results["K3"] = dict(
        err=err,
        ms=cuda_ms(lambda: onehot_split_rows(mat_row, table), 20),
        plain_ms=cuda_ms(lambda: onehot_split_rows_reference(mat_row,
                                                             table), 20),
        bound=bound(nbytes(mat_row, table, a), 0.0),
        library_ms=cuda_ms(lambda: torch.index_select(table_t, 1, safe), 20))

    # ---- K6 ---------------------------------------------------------------
    (texels, idx, ncols), _ = cap["gather_split_channels"]
    a = gather_split_channels(texels, idx, ncols)
    b = gather_split_channels_reference(texels, idx, ncols)
    bad_idx = idx.clone()            # indices outside the pool are clipped
    bad_idx[:3] = torch.tensor([-9, texels.shape[0] + 5, 0],
                               dtype=torch.int32, device=r.device)
    ax = gather_split_channels(texels, bad_idx, ncols)
    bx = gather_split_channels_reference(texels, bad_idx, ncols)
    torch.cuda.synchronize()
    err = float((a - b).abs().max())
    n_bad = bit_mismatches(a, b, torch)
    n_bad_x = bit_mismatches(ax, bx, torch)
    log(f"  K6 gather_split_channels texels {tuple(texels.shape)} bf16 x idx"
        f" {tuple(idx.shape)} -> {tuple(a.shape)}: {n_bad} mismatches "
        f"({n_bad_x} with clipped indices)")
    check(n_bad == 0 and n_bad_x == 0, "K6 bit-equal to the twin")
    # the library yardstick: one index_select of the first ncols columns
    # (bf16 out: without K6's widening to f32)
    cols_t = texels[:, :ncols].T.contiguous()
    safe = idx.clamp(0, texels.shape[0] - 1)
    n_rows = unique_rows(idx, texels.shape[0])
    results["K6"] = dict(
        err=err,
        ms=cuda_ms(lambda: gather_split_channels(texels, idx, ncols), 20),
        plain_ms=cuda_ms(lambda: gather_split_channels_reference(
            texels, idx, ncols), 20),
        bound=bound(n_rows * ncols * 2 + nbytes(idx, a), 0.0),
        library_ms=cuda_ms(lambda: torch.index_select(cols_t, 1, safe), 20))
    results["K4"], results["K5"] = check_k4_k5(cap, "stress", torch)
    for k, v in results.items():
        log(f"  {k}: kernel {v['ms']:.4f} ms, plain twin "
            f"{v['plain_ms']:.4f} ms")
    kernels.reset_launch_counts()
    return results, cap, calls["_rasterize_binned_compact"]


def lod_near_integer(args, kw, torch):
    """Taps whose mip LOD (after the texture transform) lies within 1e-5
    of an integer; False everywhere without gradients."""
    from awsm_renderer_tpu_torch.ops import texsample as TS

    tex_id, u, v, duv, desc = args
    if duv is None:
        return torch.zeros_like(tex_id, dtype=torch.bool)
    if kw.get("tform_id") is not None:
        u, v, duv = TS.apply_texture_transform_with_grads_c(
            kw["tex_transforms"], kw["tform_id"], u, v, duv)
    rows = desc.index_select(0, tex_id.clamp(0, desc.shape[0] - 1).long())
    lv = TS._mip_level(rows, duv)
    return (lv - torch.round(lv)).abs() < 1e-5


def check_k4_k5(cap, label, torch, timed=True):
    """K4 and K5 against their twins on captured main-path arguments."""
    from awsm_renderer_tpu_torch.ops.texsample import (
        filter_taps_fused, filter_taps_reference, tap_plan_fused,
        tap_plan_reference,
    )

    args, kw = cap["tap_plan_fused"]
    idx, w = tap_plan_fused(*args, **kw)
    ridx, rw = tap_plan_reference(*args, **kw)
    torch.cuda.synchronize()
    N = idx.shape[0]
    boundary = lod_near_integer(args, kw, torch)
    bad = (idx != ridx) | ((w - rw).abs() > 1e-6).any(0)
    n_bad_inner = int((bad & ~boundary).sum())
    n_bad_lod = int((bad & boundary).sum())
    off = ~boundary
    err = float((w - rw).abs()[:, off].max()) if bool(off.any()) else 0.0
    log(f"  K4 tap_plan_fused [{label}] {N} taps (mips "
        f"{args[3] is not None}, transforms {kw.get('tform_id') is not None}"
        f") -> idx ({N},) int32 + weights {tuple(w.shape)} f32: "
        f"{n_bad_inner} mismatching taps off LOD boundaries, {n_bad_lod} at "
        f"LOD boundaries ({int(boundary.sum())} taps within 1e-5 of an "
        f"integer LOD), max |dw| off them {err}")
    check(n_bad_inner == 0, f"K4 [{label}] idx equal and weights within "
                            f"1e-6 of the twin off LOD boundaries")
    check(n_bad_lod < 1e-4 * N, f"K4 [{label}] LOD-boundary mismatches "
                                f"{n_bad_lod} < 0.01% of {N} taps")
    (texq, fidx, fw), fkw = cap["filter_taps_fused"]
    a = filter_taps_fused(texq, fidx, fw, **fkw)
    b = filter_taps_reference(texq, fidx, fw, **fkw)
    torch.cuda.synchronize()
    n_bad5 = bit_mismatches(a, b, torch)
    err5 = float((a - b).abs().max())
    log(f"  K5 filter_taps_fused [{label}] texq {tuple(texq.shape)} bf16 x "
        f"idx ({fidx.shape[0]},) ({fkw}) -> {tuple(a.shape)}: {n_bad5} "
        f"mismatching values, max |d| {err5}")
    check(n_bad5 == 0, f"K5 [{label}] bit-equal to the twin")
    if not timed:
        return None
    # bytes: every input plane and table once, idx + 11 weights out (the
    # planner's few dozen float operations per tap stay under a hundredth
    # of that); K5: idx and weights in, each distinct texel row's columns
    # once, rgba out
    ins = [t for t in list(args) + list(kw.values())
           if isinstance(t, torch.Tensor)]
    ins += [t for t in (args[3] or ()) if isinstance(t, torch.Tensor)]
    cols = 52 if fkw.get("mips") else 16
    n_rows = unique_rows(fidx, texq.shape[0])
    k4 = dict(err=err,
              ms=cuda_ms(lambda: tap_plan_fused(*args, **kw), 20),
              plain_ms=cuda_ms(lambda: tap_plan_reference(*args, **kw), 5),
              bound=bound(nbytes(*ins, idx, w), 0.0), library_ms=None)
    k5 = dict(err=err5,
              ms=cuda_ms(lambda: filter_taps_fused(texq, fidx, fw, **fkw),
                         20),
              plain_ms=cuda_ms(lambda: filter_taps_reference(
                  texq, fidx, fw, **fkw), 5),
              bound=bound(n_rows * cols * 2 + nbytes(fidx, fw, a), 0.0),
              library_ms=None)
    return k4, k5


def orbit_frames(r, np, torch, camera, expect, n_frames=N_FRAMES,
                 after=None):
    """Warm-up frame, then n_frames frames with the launch counts set to 0
    just before and read just after; every kernel in `expect` must have
    launched on each frame; after(r), if given, runs after each frame's
    render call (it must not wait for the device). Returns (last image,
    median ms, host wall ms/frame, counts over the n_frames)."""
    from awsm_renderer_tpu_torch.ops import kernels

    camera(0)
    r.render_device()            # warm-up (allocator, first-use paths)
    torch.cuda.synchronize()
    ev, per_frame = [], []
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    for i in range(n_frames):
        camera(i + 1)
        before = dict(kernels.launch_counts)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        img = r.render_device()
        b.record()
        ev.append((a, b))
        per_frame.append({k: n - before[k]
                          for k, n in kernels.launch_counts.items()})
        if after is not None:
            after(r)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / n_frames
    counts = dict(kernels.launch_counts)
    frame_ms = [a.elapsed_time(b) for a, b in ev]
    med = statistics.median(frame_ms)
    log(f"  frame ms (CUDA events): median {med:.3f}, min "
        f"{min(frame_ms):.3f}, max {max(frame_ms):.3f}; host wall "
        f"{wall:.3f} ms/frame")
    log(f"  launch counts over {n_frames} frames: {counts}")
    for name in expect:
        low = min(f[name] for f in per_frame)
        check(low >= 1, f"{name} launched on every frame ({counts[name]} "
                        f"launches, at least {low} a frame)")
    return img, med, wall, counts


def check_image(img, np, torch):
    check(tuple(img.shape) == (H, W, 4) and img.dtype == torch.float32,
          f"image shape {tuple(img.shape)} f32")
    check(bool(torch.isfinite(img).all()), "image finite")
    cov = img[..., 3]
    n_geo = int((cov > 0.5).sum())
    n_sky = int((cov < 0.5).sum())
    check(n_geo > 0.05 * W * H and n_sky > 0.01 * W * H,
          f"geometry ({n_geo} px) and sky ({n_sky} px) both present")
    sky_rgb = img[..., :3][cov < 0.5]
    check(float(sky_rgb.std()) > 0.0, "image environment sky varies")
    return cov


OPAQUE_PATH = ("rasterize16_slim", "resolve_planes_fused",
               "onehot_split_rows", "tap_plan_fused", "filter_taps_fused",
               "gather_split_channels")


def phase_frame(r, keys, np, torch):
    log(f"phase frame: Stress-1080p-ibl-tex (panes included), {N_FRAMES} "
        f"frames at {W}x{H} under an orbit")
    img, med, wall, counts = orbit_frames(
        r, np, torch, lambda i: orbit_camera(r, np, i),
        OPAQUE_PATH + ("rasterize_binned_compact",))
    cov = check_image(img, np, torch)
    tid = r._last_tri_id
    check(bool(((tid >= 0) == (cov > 0.5)).all()),
          "tri_id plane covers exactly the geometry pixels")
    x, y = W // 2, H // 2
    key = r.pick(x, y)
    t = int(tid[y, x])
    want = (None if t < 0 else
            r._mesh_row_to_key.get(int(r._tri_mesh_device_order[t])))
    check(key == want and (key is None or key in keys),
          f"pick({x}, {y}) = {key} matches tri_id {t}")
    return med, wall, counts


def count_syncs(r, torch, label: str, camera, start: int) -> int:
    """Host syncs of two consecutive frames on a moving camera (camera(i)
    for i = start, start + 1 before each; the renderer's per-frame prep
    reruns on every move): torch's sync debug mode warns at every call
    that waits for the device. Logs each frame's count and the source
    lines that made them; returns the larger count."""
    import collections
    import warnings

    counts = []
    for i in (start, start + 1):
        camera(i)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                r.render_device()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        sites = collections.Counter(
            f"{os.path.relpath(w.filename, REPO)}:{w.lineno}" for w in caught
            if "synchroniz" in str(w.message))
        counts.append(sum(sites.values()))
        log(f"  host syncs in a {label} frame on a moved camera (view {i}): "
            f"{counts[-1]}; by source line: {dict(sites.most_common())}")
    return max(counts)


def hold_planes(label, a, b, torch):
    """Bit-compare two plane dicts; returns the max |difference|."""
    check(sorted(a) == sorted(b), f"{label}: same planes")
    n_bad = sum(bit_mismatches(a[k].contiguous(), b[k].contiguous(), torch)
                for k in a)
    err = max(float((a[k].float() - b[k].float()).abs().max()) for k in a)
    n_hit = int((a["tri_id"] >= 0).sum())
    log(f"  {label}: {len(a)} planes of {tuple(a['tri_id'].shape)}, {n_hit} "
        f"fragments, {n_bad} mismatching values")
    check(n_bad == 0 and n_hit > 0, f"{label} bit-equal to the twin")
    return err


def binned_bound(rows, bins, tiles, n_px, planes, zb, torch):
    """K7/K8's least time: the overlay setup, bins and peel bounds read
    once and the planes written once; the coverage tests the bins ask for
    (each listed chunk's 128 triangles against a tile's 1024 pixels)."""
    bin_idx, counts, _B, zmin = bins
    listed = int(counts.long().index_select(0, tiles.long()).sum())
    return bound(nbytes(rows, bin_idx, counts, zmin, *zb)
                 + n_px * 4 * len(planes), listed * 128 * 1024 * OPS_PER_TEST)


def phase_overlay(P, np, torch, r_stress, cap_stress):
    """(a) the stress frame's overlay (K8), from the first frame's capture;
    (b) the volume + HUD variant (K7 peel and non-peel, K6-f32)."""
    from awsm_renderer_tpu_torch.ops import kernels
    from awsm_renderer_tpu_torch.ops.raster import (
        BT_H, BT_W, build_bins, plane_layout, rasterize_binned,
        rasterize_binned_compact_reference, rasterize_binned_reference,
        _rasterize_binned_compact,
    )
    from awsm_renderer_tpu_torch.ops.relayout import (
        gather_split_channels_f32, gather_split_channels_f32_reference,
    )

    results = {}
    log(f"phase overlay (a): the stress frame's 12 glass panes at {W}x{H}")
    prep = r_stress._prep[1]
    crop = prep["ov_crop"]
    band_h = crop[1] if crop else H
    n_tiles = (-(-band_h // BT_H)) * (-(-W // BT_W))
    (rows, zlo_c, zhi_c), kw = cap_stress["_rasterize_binned_compact"]
    C = int(kw["tile_idx"].shape[0])
    log(f"  prep: crop band {crop} (y0, rows), tile cap {prep['ov_tile_cap']}"
        f", layer clamp {prep['n_layers']} of "
        f"{r_stress.config.max_transparent_layers}, compacted pool "
        f"{int((prep['ov_idx'] >= 0).sum())} of {prep['ov_idx'].shape[0]} "
        f"triangle slots; setup rows {tuple(rows.shape)}")
    log(f"  K8 compaction: C = {C} covered tiles of the band's {n_tiles}")
    check(C < n_tiles, "the compacted peel is engaged (C < n_tiles)")
    names = plane_layout(kw["has_uv1"], kw["has_color"])
    a = _rasterize_binned_compact(rows, zlo_c, zhi_c, **kw)
    ref_kw = dict(bins=kw["bins"], tile_idx=kw["tile_idx"], n_tx=kw["n_tx"],
                  names=names)
    b = rasterize_binned_compact_reference(rows, zlo_c, zhi_c, **ref_kw)
    torch.cuda.synchronize()
    err = hold_planes("K8 _rasterize_binned_compact (first peel)", a, b,
                      torch)
    results["K8"] = dict(
        err=err, ms=cuda_ms(lambda: _rasterize_binned_compact(
            rows, zlo_c, zhi_c, **kw), 20),
        plain_ms=cuda_ms(lambda: rasterize_binned_compact_reference(
            rows, zlo_c, zhi_c, **ref_kw), 2),
        bound=binned_bound(rows, kw["bins"], kw["tile_idx"], C * 1024,
                           names, (zlo_c, zhi_c), torch),
        library_ms=None)
    results["syncs_a"] = count_syncs(
        r_stress, torch, "stress", lambda i: orbit_camera(r_stress, np, i),
        N_FRAMES + 1)

    log(f"phase overlay (b): the panes with KHR transmission + volume and a "
        f"HUD box, {N_FRAMES} frames at {W}x{H}")
    r, _keys, hud_key = build_stress_scene(P, np, DEVICE, volume=True,
                                           hud=True)
    orbit_camera(r, np, 0)
    calls = {}
    cap = capture_first_frame(r, ("rasterize_binned",
                                  "gather_split_channels_f32"), calls)
    results["k7_calls"] = calls["rasterize_binned/peel"]
    torch.cuda.synchronize()
    check(sorted(cap) == ["gather_split_channels_f32",
                          "rasterize_binned/nopeel", "rasterize_binned/peel"],
          "the first frame ran K7 peel, K7 without a peel and K6-f32")
    prep = r._prep[1]
    log(f"  prep: crop band {prep['ov_crop']} (off with volume in the "
        f"frame), layer clamp {prep['n_layers']}, ext {prep['ov_ext']}")

    (rows, zlo, zhi), kw = cap["rasterize_binned/peel"]
    names = plane_layout(kw["has_uv1"], kw["has_color"],
                         kw["analytic_derivs"])
    a = rasterize_binned(rows, zlo, zhi, **kw)
    ref_kw = dict(bins=kw["bins"], width=kw["width"], height=kw["height"],
                  names=names)
    b = rasterize_binned_reference(rows, zlo, zhi, **ref_kw)
    torch.cuda.synchronize()
    err = hold_planes("K7 rasterize_binned (first peel)", a, b, torch)
    n_tiles = (-(-kw["height"] // BT_H)) * (-(-kw["width"] // BT_W))
    all_tiles = torch.arange(n_tiles, device=rows.device)
    results["K7"] = dict(
        err=err, ms=cuda_ms(lambda: rasterize_binned(rows, zlo, zhi, **kw),
                            20),
        plain_ms=cuda_ms(lambda: rasterize_binned_reference(
            rows, zlo, zhi, **ref_kw), 2),
        bound=binned_bound(rows, kw["bins"], all_tiles, zlo.numel(), names,
                           (zlo, zhi), torch),
        library_ms=None)

    (h_rows,), hkw = cap["rasterize_binned/nopeel"]
    w32 = -(-hkw["width"] // BT_W) * BT_W
    h32 = -(-hkw["height"] // BT_H) * BT_H
    h_bins = build_bins(h_rows, width=w32, height=h32)
    hkw = dict(hkw, bins=h_bins)
    h_names = plane_layout(hkw["has_uv1"], hkw["has_color"],
                           hkw["analytic_derivs"])
    a = rasterize_binned(h_rows, **hkw)
    b = rasterize_binned_reference(h_rows, None, None, bins=h_bins,
                                   width=hkw["width"], height=hkw["height"],
                                   names=h_names)
    torch.cuda.synchronize()
    hold_planes("K7 rasterize_binned (HUD, no peel)", a, b, torch)
    results["K7_nopeel_ms"] = cuda_ms(lambda: rasterize_binned(h_rows, **hkw),
                                      20)

    (table, idx, ncols), _ = cap["gather_split_channels_f32"]
    a = gather_split_channels_f32(table, idx, ncols)
    b = gather_split_channels_f32_reference(table, idx, ncols)
    torch.cuda.synchronize()
    n_bad = bit_mismatches(a, b, torch)
    log(f"  K6-f32 gather_split_channels_f32 table {tuple(table.shape)} f32 "
        f"x idx {tuple(idx.shape)} -> {tuple(a.shape)}: {n_bad} mismatches")
    check(n_bad == 0, "K6-f32 bit-equal to the twin")
    cols_t = table[:, :ncols].T.contiguous()
    safe = idx.clamp(0, table.shape[0] - 1)
    results["K6f32"] = dict(
        err=float((a - b).abs().max()),
        ms=cuda_ms(lambda: gather_split_channels_f32(table, idx, ncols), 20),
        plain_ms=cuda_ms(lambda: gather_split_channels_f32_reference(
            table, idx, ncols), 20),
        bound=bound(unique_rows(idx, table.shape[0]) * ncols * 4
                    + nbytes(idx, a), 0.0),
        library_ms=cuda_ms(lambda: torch.index_select(cols_t, 1, safe), 20))
    kernels.reset_launch_counts()

    img, med, wall, counts = orbit_frames(
        r, np, torch, lambda i: orbit_camera(r, np, i),
        OPAQUE_PATH + ("rasterize_binned", "gather_split_channels_f32"))
    check_image(img, np, torch)
    check(counts["rasterize_binned_compact"] == 0,
          "volume refraction keeps the band-wide peel (no K8)")
    vp = np.asarray(r.camera.view_projection, np.float64)
    clip = vp @ np.array([*HUD_AT, 1.0])
    x = int((clip[0] / clip[3] * 0.5 + 0.5) * W)
    y = int((0.5 - 0.5 * clip[1] / clip[3]) * H)
    key = r.pick(x, y)
    check(key == hud_key, f"pick({x}, {y}) at the HUD box's centre = {key} "
                          f"(its key {hud_key})")
    results["syncs_b"] = count_syncs(
        r, torch, "volume + HUD", lambda i: orbit_camera(r, np, i),
        N_FRAMES + 1)
    results["frames_b"] = (med, wall, counts)
    return results


def msaa_pixel_tris(bins, n_tx: int) -> int:
    """(display pixel, triangle) pairs K9 tests on `bins`: each entry in
    the quadrants its mask names (256 display pixels each), each big group
    in every tile its bbox reaches (1024 pixels), x 16 triangles."""
    import torch

    entries, _offsets, counts, _z, big_packed, _ids, n_big, _ = bins
    n_tiles = counts.numel()
    e = entries[:int(counts.sum())]    # unclipped bins: tile after tile
    quads = sum(((e >> q) & 0x11) != 0 for q in range(4))
    px = int(quads.sum()) * 256
    t = torch.arange(n_tiles, device=entries.device)
    tx, ty = t % n_tx, torch.div(t, n_tx, rounding_mode="floor")
    bb = big_packed[:int(n_big.item())].long()[:, None]
    hits = (((bb & 255) <= tx) & (tx <= ((bb >> 16) & 255))
            & (((bb >> 8) & 255) <= ty) & (ty <= ((bb >> 24) & 255)))
    px += int(hits.sum()) * 1024
    return px * 16


def phase_aa(P, np, torch):
    """bench.py's headline frame: the stress scene (panes included) with
    MSAA-4x, bloom and DoF at 1080p. K9 and K2's MSAA entries against
    their twins on the first frame's own intermediates, 12 orbit frames,
    host syncs; then supersample and SMAA frames."""
    from awsm_renderer_tpu_torch.ops import kernels
    from awsm_renderer_tpu_torch.ops.raster import (
        BT_W, build_bins16, rasterize16_msaa, rasterize16_msaa_reference,
    )
    from awsm_renderer_tpu_torch.ops.shade import (
        RESOLVE_NAMES, resolve_planes_fused, resolve_planes_reference,
    )

    log(f"phase aa: Stress-1080p-msaa-bloom-dof (bench.py's headline "
        f"config, panes included), {N_FRAMES} frames at {W}x{H}")
    r, keys, _ = build_stress_scene(P, np, DEVICE, effects=True)
    orbit_camera(r, np, 0)
    cap = capture_first_frame(r, ("rasterize16_msaa", "resolve_planes_fused"))
    torch.cuda.synchronize()
    prep = r._prep[1]
    C = prep["op_tile_cap"]
    n_units = (-(-H // 8)) * (-(-W // 128))
    log(f"  prep: opaque tile cap {C} of {n_units} (8, 128) units "
        f"({'engaged' if C is not None else 'declined'}), DoF rings "
        f"{prep['dof_rings']}, overlay tile cap {prep['ov_tile_cap']}")
    check("rasterize16_msaa" in cap, "the MSAA frame called K9")
    results = {}

    # ---- K9 ---------------------------------------------------------------
    (srows,), kw = cap["rasterize16_msaa"]
    w2, h2 = kw["width2"], kw["height2"]
    results["msaa_in"] = (srows, w2, h2)
    samp, depth, bins = rasterize16_msaa(srows, width2=w2, height2=h2)
    # the twin takes seconds at this size: time the checking call itself
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    rsamp, rdepth = rasterize16_msaa_reference(srows, bins, width2=w2,
                                               height2=h2)
    ev[1].record()
    torch.cuda.synchronize()
    n_bad = sum(bit_mismatches(a, b, torch) for a, b in zip(samp, rsamp))
    n_bad += bit_mismatches(depth, rdepth, torch)
    err = float((depth - rdepth).abs().max())
    n_tx = -(-w2 // (2 * BT_W))
    counts = bins[2]
    log(f"  setup rows {tuple(srows.shape)} f32, supersampled raster "
        f"{w2}x{h2} -> display {tuple(depth.shape)}")
    log(f"  K9 bins: {counts.numel()} display tiles, {int(counts.sum())} "
        f"(tile, group) entries, max {int(counts.max())} a tile, "
        f"n_big {int(bins[6].item())} (cap 512)")
    ref = build_bins16(srows, width=-(-w2 // 64) * 64,
                       height=-(-h2 // 64) * 64, vis_cap=65536,
                       stash_cap=4096, tile_h=64, tile_w=64,
                       pack_submask=True)
    log(f"  under the reference's caps (vis_cap 65536, stash_cap 4096): "
        f"n_clipped {int(ref[7].item())} tiles, {int(ref[2].sum())} entries "
        f"kept of {int(counts.sum())}")
    log(f"  K9 rasterize16_msaa 4 sample planes + depth: {n_bad} "
        f"mismatching values, max |ddepth| {err}")
    check(n_bad == 0, "K9 sample ids and depth bit-equal to the plain twin")
    check(int((samp[0] >= 0).sum()) > 0, "K9 covers samples")
    pairs = msaa_pixel_tris(bins, n_tx)
    results["K9"] = dict(
        err=err,
        ms=cuda_ms(lambda: rasterize16_msaa(srows, bins, width2=w2,
                                            height2=h2), 20),
        plain_ms=ev[0].elapsed_time(ev[1]),
        bound=bound(nbytes(srows, *bins, *samp, depth),
                    pairs * OPS_PER_MSAA_PIXEL),
        library_ms=None)
    log(f"  K9 bound: {pairs} pixel-triangle pairs x {OPS_PER_MSAA_PIXEL} "
        f"operations, {results['K9']['bound'][0]:.4f} ms "
        f"({results['K9']['bound'][1]})")

    # ---- K2's MSAA entries --------------------------------------------------
    rw1 = -(-W // 128) * 128
    tid = samp[0][:, :rw1].contiguous().reshape(-1)
    k2 = {}
    entries = [("coord_scale", tid, dict(width=rw1, coord_scale=2))]
    if "resolve_planes_fused/xy" in cap:
        (t_c, rows_c), kw_c = cap["resolve_planes_fused/xy"]
        check(rows_c is srows, "the compacted shade resolves K9's setup rows")
        entries.append(("explicit_xy", t_c, kw_c))
    for label, t, kw2 in entries:
        a = resolve_planes_fused(t, srows, **kw2)
        b = resolve_planes_reference(t, srows, **kw2)
        torch.cuda.synchronize()
        check(torch.equal(a["tri_id"], b["tri_id"]),
              f"K2 [{label}] tri_id equal")
        e2, bad = 0.0, 0
        for name in RESOLVE_NAMES[1:]:
            e2 = max(e2, float((a[name] - b[name]).abs().max()))
            bad += int((~torch.isclose(a[name], b[name], rtol=1e-5,
                                       atol=1e-6)).sum())
        log(f"  K2 resolve_planes_fused [{label}] {t.numel()} pixels: {bad}"
            f" values outside rtol 1e-5 atol 1e-6, max |d| {e2}")
        check(bad == 0, f"K2 [{label}] within rtol 1e-5, atol 1e-6 of the "
                        f"twin")
        k2[label] = dict(
            ms=cuda_ms(lambda: resolve_planes_fused(t, srows, **kw2), 20),
            plain_ms=cuda_ms(lambda: resolve_planes_reference(t, srows,
                                                              **kw2), 5))
    results["K2_msaa"] = k2
    del rsamp, rdepth, ref
    kernels.reset_launch_counts()

    img, med, wall, counts_f = orbit_frames(
        r, np, torch, lambda i: orbit_camera(r, np, i),
        ("rasterize16_msaa", "resolve_planes_fused", "onehot_split_rows",
         "tap_plan_fused", "filter_taps_fused", "gather_split_channels",
         "rasterize_binned_compact"))
    check(counts_f["rasterize16_slim"] == 0, "MSAA frames launch no K1")
    cov = check_image(img, np, torch)
    tid_p = r._last_tri_id
    # the edge blend averages the 4 samples' coverage: a pixel whose
    # top-left sample hits keeps alpha >= 1/4, one whose sample misses
    # <= 3/4
    check(bool((cov[tid_p >= 0] > 0.2).all() and (cov[tid_p < 0]
                                                 < 0.8).all()),
          "tri_id plane (the top-left sample) agrees with the blended "
          "coverage")
    x, y = W // 2, H // 2
    key = r.pick(x, y)
    t = int(tid_p[y, x])
    want = (None if t < 0 else
            r._mesh_row_to_key.get(int(r._tri_mesh_device_order[t])))
    check(key == want and (key is None or key in keys),
          f"pick({x}, {y}) = {key} matches the sample plane's tri_id {t}")
    results["syncs"] = count_syncs(
        r, torch, "MSAA + bloom + DoF", lambda i: orbit_camera(r, np, i),
        N_FRAMES + 1)
    results["frames"] = (med, wall, counts_f)
    del r, cap, samp, depth, bins

    # ---- supersample and SMAA frames ---------------------------------------
    from dataclasses import replace

    for label, aa, n in (("supersample", dict(supersample=True), 3),
                         ("smaa", dict(smaa=True), 1)):
        r, _keys, _ = build_stress_scene(P, np, DEVICE)
        r.config = replace(r.config, anti_aliasing=P.AntiAliasing(**aa))
        orbit_camera(r, np, 0)
        r.render_device()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        times = []
        for i in range(n):
            orbit_camera(r, np, i + 1)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            img = r.render_device()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"  {label}: {n} frames at {W}x{H}, ms (CUDA events) "
            f"{[round(v, 3) for v in times]}, peak device memory "
            f"{peak:.2f} GiB, launches {dict(kernels.launch_counts)}")
        check_image(img, np, torch)
        check(kernels.launch_counts["rasterize16_slim"] == n,
              f"{label} frames take K1 once a frame")
        results[label] = (statistics.median(times), peak)
        del r
    kernels.reset_launch_counts()
    return results


# ---- the oracle: K11 against the binned kernels ----------------------------
#
# The dense raster (K11a) and dense peel (K11b) walk every chunk in index
# order; K1 and K9 walk 16-triangle groups in bin order (near first) and K7
# and K8 walk chunks near first. All evaluate a*px + (b*py + c) in f32 with
# the same rounding, so their winners may differ only where two triangles
# give a pixel bit-equal z (an exact depth tie: the walk order picks). K9
# adds a and b to its top-left sample's values, so at a sample it may also
# differ where an edge value, or the two candidates' z, lies within a few
# ulps of its threshold (K9's sample rounding). Anything else is a fault.

ORACLE_ULPS = 4
F32_EPS = 2.0 ** -23       # an ulp of x is at most F32_EPS * |x|


def _rows_of_ids(rows, ids, torch):
    """The setup rows that carry each id (S_ORIG_ID; a clipped triangle's
    two copies share one): [(row index (n,), found (n,) bool)] x 2."""
    from awsm_renderer_tpu_torch.ops.vertex import S_ORIG_ID

    oid = rows[:, S_ORIG_ID]
    order = torch.argsort(oid, stable=True)
    sid = oid[order]
    f = ids.float()
    out = []
    for k in (0, 1):
        pos = (torch.searchsorted(sid, f) + k).clamp(max=sid.numel() - 1)
        out.append((order[pos], (sid[pos] == f) & (ids >= 0)))
    return out


def _fragment(rows, r, px, py, zb, torch):
    """Rows r's fragments at (px, py), each step rounded as the kernels
    do: (covers, z, an edge value within ORACLE_ULPS ulps of its
    threshold, the z-plane terms' magnitude)."""
    from awsm_renderer_tpu_torch.ops.raster import _FMIN

    R = rows[r]
    cover = torch.ones_like(px, dtype=torch.bool)
    near = torch.zeros_like(cover)
    for k in range(4):
        a, b, c = R[:, 3 * k], R[:, 3 * k + 1], R[:, 3 * k + 2]
        v = a * px + (b * py + c)
        mag = (a * px).abs() + (b * py).abs() + c.abs()
        if k == 3:
            z, zmag = v, mag
            break
        tl = (a > 0) | ((a == 0) & (b > 0))
        thr = torch.where(tl, 0.0, _FMIN)
        cover &= v >= thr
        near |= (v - thr).abs() <= ORACLE_ULPS * F32_EPS * mag
    cover &= (z >= 0.0) & (z <= 1.0)
    if zb is not None:
        cover &= (z > zb[0]) & (z < zb[1])
    return cover, z, near, zmag


def classify_mismatches(rows, ids_a, ids_b, px, py, torch, zb=None,
                        k9=False):
    """Pixels (or samples) where setup ids ids_a and ids_b (n,) differ, at
    centres px, py (n,) f32, zb optional peel bounds (n,) each: counts of
    exact depth ties (both winners cover the point with bit-equal z), of
    K9 sample-rounding flips (k9 only: either winner has an edge value, or
    the two a z, within ORACLE_ULPS ulps) and of the rest."""
    n = ids_a.numel()
    tie = torch.zeros(n, dtype=torch.bool, device=px.device)
    flip = torch.zeros_like(tie)
    frags = []
    for ids in (ids_a, ids_b):
        side = []
        for r, ok in _rows_of_ids(rows, ids, torch):
            cover, z, near, zmag = _fragment(rows, r, px, py, zb, torch)
            side.append((ok, cover & ok, z, near & ok, zmag))
            flip |= near & ok
        frags.append(side)
    for ok_a, cov_a, z_a, _na, m_a in frags[0]:
        for ok_b, cov_b, z_b, _nb, m_b in frags[1]:
            tie |= cov_a & cov_b & (z_a.view(torch.int32)
                                    == z_b.view(torch.int32))
            flip |= (ok_a & ok_b & ((z_a - z_b).abs() <= ORACLE_ULPS
                                     * F32_EPS * torch.maximum(m_a, m_b)))
    if not k9:
        flip = torch.zeros_like(flip)
    flip &= ~tie
    rest = ~(tie | flip)
    return dict(ties=int(tie.sum()), k9_rounding=int(flip.sum()),
                unclassified=int(rest.sum()), rest=rest)


def pixel_centres(h: int, w: int, device, torch, step=1, di=0, dj=0):
    """(px, py) (h*w,) f32 centres of an h x w grid of pixels, each at
    step * index + offset + 0.5 (step 2 gives one MSAA sample plane)."""
    ys, xs = torch.meshgrid(torch.arange(h, device=device),
                            torch.arange(w, device=device), indexing="ij")
    return ((step * xs + dj).float().reshape(-1) + 0.5,
            (step * ys + di).float().reshape(-1) + 0.5)


def hold_oracle(label, rows, a, b, torch, px, py, zb=None, k9=False,
                depth=True, planes=()):
    """Oracle comparison of plane dicts a (the dense kernel) and b (the
    binned kernel) over the same pixels: id mismatches classified, depth
    bit-equal and the float `planes` within 1e-4 where the ids agree.
    Returns the counts."""
    ta, tb = a["tri_id"].reshape(-1), b["tri_id"].reshape(-1)
    off = ta != tb
    idx = off.nonzero()[:, 0]
    sel = None if zb is None else tuple(z.reshape(-1)[idx] for z in zb)
    c = classify_mismatches(rows, ta[idx], tb[idx], px[idx], py[idx], torch,
                            sel, k9)
    same = ~off
    n_depth = 0
    if depth:
        da, db = a["depth"].reshape(-1), b["depth"].reshape(-1)
        n_depth = int((da.view(torch.int32) != db.view(torch.int32))[same]
                      .sum())
    err = 0.0
    for k in planes:
        d = (a[k].reshape(-1) - b[k].reshape(-1)).abs()[same]
        err = max(err, float(d.max()) if d.numel() else 0.0)
    log(f"  oracle {label}: {ta.numel()} pixels compared, "
        f"{int((ta >= 0).sum())} covered (dense), {idx.numel()} tri_id "
        f"mismatches: {c['ties']} exact depth ties, {c['k9_rounding']} K9 "
        f"sample-rounding flips, {c['unclassified']} unclassified; depth "
        f"{'not compared' if not depth else f'{n_depth} not bit-equal'} "
        f"where the ids agree"
        + (f"; fat planes max |d| {err} (both flushes are K2's "
           f"resolve_math.cuh: this holds the winners, the twin check holds "
           f"K11's flush against the plain one)" if planes else ""))
    if c["unclassified"]:
        bad = idx[c["rest"]][:8]
        log(f"    unclassified at {bad.tolist()}: dense {ta[bad].tolist()}"
            f", binned {tb[bad].tolist()}")
    check(c["unclassified"] == 0, f"oracle {label}: every tri_id mismatch "
                                  f"is classified")
    check(int((ta >= 0).sum()) > 0, f"oracle {label}: the dense kernel "
                                    f"covers pixels")
    if depth:
        check(n_depth == 0, f"oracle {label}: depth bit-equal where the "
                            f"ids agree")
    if planes:
        check(err <= 1e-4, f"oracle {label}: fat planes within 1e-4")
    return dict(n=ta.numel(), mismatches=idx.numel(), ties=c["ties"],
                k9_rounding=c["k9_rounding"],
                unclassified=c["unclassified"])


def dense_padded(rows, zlo, zhi, *, width: int, height: int, torch, **kw):
    """K11a (zlo None) or K11b over a (height, width) frame padded up to
    the dense grid's 128 x 8 multiples (peel bounds 0 in the padding, which
    admits nothing), cropped back."""
    from awsm_renderer_tpu_torch.ops import raster as TR

    W1 = -(-width // TR.TILE_W) * TR.TILE_W
    H1 = -(-height // TR.TILE_H) * TR.TILE_H
    if zlo is None:
        out = TR.rasterize(rows, width=W1, height=H1, binned=False, **kw)
    else:
        def pad(z):
            full = torch.zeros((H1, W1), dtype=z.dtype, device=z.device)
            full[:height, :width] = z.reshape(height, width)
            return full

        out = TR.rasterize_peel(rows, pad(zlo), pad(zhi), width=W1,
                                height=H1, binned=False, **kw)
    return {k: v[:height, :width] for k, v in out.items()}


def dense_pairs(rows, width: int, height: int, group: int, torch) -> int:
    """(8x128 tile, `group`-triangle group) pairs whose bboxes overlap."""
    from awsm_renderer_tpu_torch.ops import raster as TR
    from awsm_renderer_tpu_torch.ops.vertex import (
        S_BB_MAXX, S_BB_MAXY, S_BB_MINX, S_BB_MINY,
    )

    g = rows.reshape(-1, group, rows.shape[1])
    mnx, mny = g[..., S_BB_MINX].amin(1), g[..., S_BB_MINY].amin(1)
    mxx, mxy = g[..., S_BB_MAXX].amax(1), g[..., S_BB_MAXY].amax(1)
    tx0 = torch.arange(width // TR.TILE_W, device=rows.device).float() \
        * TR.TILE_W
    ty0 = torch.arange(height // TR.TILE_H, device=rows.device).float() \
        * TR.TILE_H
    ox = ((mnx[None] < (tx0 + TR.TILE_W)[:, None])
          & (mxx[None] > tx0[:, None])).sum(0)
    oy = ((mny[None] < (ty0 + TR.TILE_H)[:, None])
          & (mxy[None] > ty0[:, None])).sum(0)
    return int((ox * oy).sum())


def dense_bound(rows, width: int, height: int, n_out_planes: int, torch,
                peel=False):
    """K11's least time: setup (and peel bounds) read once, the planes
    written once; OPS_PER_TEST per coverage test over the (tile, 8-triangle
    subgroup) pairs whose bboxes overlap (the reference merges no other
    subgroup), 1024 pixels x 8 triangles each."""
    from awsm_renderer_tpu_torch.ops import raster as TR

    n_px = width * height
    tests = dense_pairs(rows, width, height, TR.SUB, torch) * 1024 * TR.SUB
    return bound(nbytes(rows) + n_px * 4 * (n_out_planes + (2 if peel
                                                            else 0)),
                 tests * OPS_PER_TEST)


def _oracle_total():
    return dict(n=0, mismatches=0, ties=0, k9_rounding=0, unclassified=0)


def _oracle_add(tot, c):
    for k in tot:
        tot[k] += c[k]


def oracle_k1(srows, rw: int, rh: int, torch):
    """K11a fat against rasterize16 (K1 + K2) on opaque setup rows."""
    from awsm_renderer_tpu_torch.ops import raster as TR

    fat = TR.plane_layout(True, True, True)
    a = dense_padded(srows, None, None, width=rw, height=rh, torch=torch)
    b = TR.rasterize16(srows, width=rw, height=rh)
    b.pop("bins")
    px, py = pixel_centres(rh, rw, srows.device, torch)
    return hold_oracle(f"K11a fat vs K1 + K2 ({srows.shape[0]} setup rows, "
                       f"{rw}x{rh})", srows, a, b, torch, px, py,
                       planes=fat[2:])


def oracle_k7(rows, zlo, zhi, kw7, torch, label: str):
    """K11b against K7 on one peel's arguments (rows, zlo, zhi, and K7's
    keywords kw7)."""
    from awsm_renderer_tpu_torch.ops import raster as TR

    w7, h7 = kw7["width"], kw7["height"]
    lay = dict(has_uv1=kw7["has_uv1"], has_color=kw7["has_color"],
               analytic_derivs=kw7["analytic_derivs"])
    a = dense_padded(rows, zlo, zhi, width=w7, height=h7, torch=torch, **lay)
    b = TR.rasterize_binned(rows, zlo, zhi, **kw7)
    px, py = pixel_centres(h7, w7, rows.device, torch)
    return hold_oracle(f"K11b vs K7 ({label}, {rows.shape[0]} rows, "
                       f"{w7}x{h7})", rows, a, b, torch, px, py,
                       zb=(zlo, zhi), planes=TR.plane_layout(**lay)[2:])


def oracle_k8(rows, zlo_c, zhi_c, kw8, torch, label: str):
    """K11b against K8 on one compacted peel's arguments, at K8's covered
    32x32 tiles: the compact bounds go back to their tiles of the band
    (0 elsewhere, which admits nothing), K11b runs over the band, and its
    planes are compacted to the same tiles."""
    from awsm_renderer_tpu_torch.ops import raster as TR

    dev = rows.device
    t_idx, n_tx = kw8["tile_idx"].long(), kw8["n_tx"]
    n_ty = int(t_idx.max()) // n_tx + 1
    W32, H32 = n_tx * TR.BT_W, n_ty * TR.BT_H

    def band(zc):
        z = torch.zeros((n_ty * n_tx, TR.BT_H * TR.BT_W), device=dev)
        z[t_idx] = zc
        return TR._deswizzle32(z, H32, W32)

    lay = dict(has_uv1=kw8["has_uv1"], has_color=kw8["has_color"])
    d = dense_padded(rows, band(zlo_c), band(zhi_c), width=W32, height=H32,
                     torch=torch, **lay)
    a = {k: TR._pad_swizzle32(v, H32, W32).index_select(0, t_idx)
         for k, v in d.items()}
    b = TR._rasterize_binned_compact(rows, zlo_c, zhi_c, **kw8)
    px, py = TR._tile_pixels(t_idx, n_tx)
    return hold_oracle(f"K11b vs K8 ({label}, {t_idx.numel()} covered 32x32 "
                       f"tiles)", rows, a, b, torch, px.reshape(-1),
                       py.reshape(-1), zb=(zlo_c, zhi_c),
                       planes=TR.plane_layout(**lay)[2:])


def oracle_k9(m_rows, w2: int, h2: int, torch, label: str):
    """K11a slim at the supersampled size against K9: sample (i, j) of
    display pixel (y, x) is the dense raster's pixel (2y + i, 2x + j);
    K9's depth is the min over a pixel's four samples."""
    from awsm_renderer_tpu_torch.ops import raster as TR
    from awsm_renderer_tpu_torch.ops.vertex import S_ORIG_ID, S_ZA

    dev = m_rows.device
    samp, depth1, _bins = TR.rasterize16_msaa(m_rows, width2=w2, height2=h2)
    d = TR.rasterize(m_rows, width=w2, height=h2, binned=False, slim=True)
    H1, W1 = depth1.shape
    orig = m_rows[:, S_ORIG_ID]
    tot = _oracle_total()
    agree = torch.ones((H1, W1), dtype=torch.bool, device=dev)
    zmag = torch.zeros((H1, W1), device=dev)
    zr = m_rows[:, S_ZA:S_ZA + 3]
    for s_, (i, j) in enumerate(TR.MSAA_SAMPLES):
        kid = torch.where(samp[s_] >= 0,
                          orig[samp[s_].clamp(min=0).long()].to(torch.int32),
                          -1)
        did = d["tri_id"][i::2, j::2][:H1, :W1]
        agree &= did == kid
        px, py = pixel_centres(H1, W1, dev, torch, step=2, di=i, dj=j)
        _oracle_add(tot, hold_oracle(
            f"K11a slim {w2}x{h2} vs K9 sample {(i, j)} ({label}, "
            f"{m_rows.shape[0]} rows)", m_rows, {"tri_id": did},
            {"tri_id": kid}, torch, px, py, k9=True, depth=False))
        # the z-plane terms' magnitude at the dense winners (the opaque
        # pool's ids are its rows)
        t = zr[did.reshape(-1).clamp(min=0).long()]
        m = (t[:, 0] * px).abs() + (t[:, 1] * py).abs() + t[:, 2].abs()
        zmag = torch.maximum(zmag, torch.where(did.reshape(-1) >= 0, m, 0.0)
                             .reshape(H1, W1))
    # K9 rounds its sample z as z00 (+ za) (+ zb), the dense kernel
    # evaluates each sample's z directly
    dz = d["depth"]
    dmin = torch.minimum(torch.minimum(dz[0::2, 0::2], dz[0::2, 1::2]),
                         torch.minimum(dz[1::2, 0::2], dz[1::2, 1::2]))
    dmin = dmin[:H1, :W1]
    diff = (dmin.view(torch.int32) != depth1.view(torch.int32)) & agree
    far = ((dmin - depth1).abs() > ORACLE_ULPS * F32_EPS * zmag) & agree
    log(f"  oracle K11a slim vs K9 depth ({label}): of {int(agree.sum())} "
        f"pixels whose four sample ids agree, {int(diff.sum())} not "
        f"bit-equal, {int(far.sum())} beyond {ORACLE_ULPS} ulps of the "
        f"z-plane terms")
    check(int(far.sum()) == 0, f"oracle K11a vs K9 ({label}): min-sample "
                               f"depth within {ORACLE_ULPS} ulps where the "
                               f"ids agree")
    tot["depth_not_bit_equal"] = int(diff.sum())
    return tot


def phase_oracle(P, np, torch, cap_stress, calls_k8, calls_k7, msaa_in):
    """K11a / K11b against K1 + K2, K7, K8 and K9 on the card's own 1080p
    intermediates (the launch counts of these four comparisons are K11's
    path); then K12 and K13, and K11a (fat at 1080p, slim at 2x) and K11b
    on those comparisons' own inputs, against their twins, timed."""
    from awsm_renderer_tpu_torch.ops import kernels
    from awsm_renderer_tpu_torch.ops import raster as TR
    from awsm_renderer_tpu_torch.ops.relayout import (
        channel_rows, channel_rows_reference, split_rows,
        split_rows_reference,
    )

    t_phase = time.perf_counter()
    log("phase oracle: the dense raster K11a and dense peel K11b against "
        "K1 + K2, K7, K8 and K9 on the frames' own intermediates")
    dev = torch.device(DEVICE)
    kernels.reset_launch_counts()
    summary = {}

    (srows,), kw = cap_stress["rasterize16_slim"]
    rw, rh = kw["width"], kw["height"]
    summary["K1"] = oracle_k1(srows, rw, rh, torch)
    tot = _oracle_total()
    for i, ((rows, zlo, zhi), kw7) in enumerate(calls_k7):
        _oracle_add(tot, oracle_k7(rows, zlo, zhi, kw7, torch,
                                   f"volume + HUD frame, peel {i}"))
    check(len(calls_k7) >= 1, "the volume + HUD frame ran K7 peels")
    summary["K7"] = tot
    tot = _oracle_total()
    for i, ((rows, zlo_c, zhi_c), kw8) in enumerate(calls_k8):
        _oracle_add(tot, oracle_k8(rows, zlo_c, zhi_c, kw8, torch,
                                   f"stress frame, peel {i}"))
    check(len(calls_k8) >= 1, "the stress frame ran K8 peels")
    summary["K8"] = tot
    m_rows, w2, h2 = msaa_in
    summary["K9"] = oracle_k9(m_rows, w2, h2, torch, "MSAA frame")
    launches = dict(kernels.launch_counts)
    for name in ("rasterize_dense", "rasterize_peel_dense"):
        check(launches[name] >= 1, f"{name} launched on the oracle path "
                                   f"({launches[name]} launches)")

    # ---- K12 / K13, standalone at the reference's shapes ------------------
    g = torch.Generator(device=dev).manual_seed(12)
    tform = torch.rand((8, W * H), generator=g, device=dev)
    texels = torch.rand((W * H, 4), generator=g, device=dev).to(
        torch.bfloat16)
    kernels.reset_launch_counts()
    k12 = split_rows(tform)
    k13 = channel_rows(texels)
    launches.update((k, kernels.launch_counts[k]) for k in ("split_rows",
                                                            "channel_rows"))
    for name in ("split_rows", "channel_rows"):
        check(launches[name] >= 1, f"{name} launched ({launches[name]})")
    results = {}
    n_bad = sum(bit_mismatches(x, y, torch)
                for x, y in zip(k12, split_rows_reference(tform)))
    log(f"  K12 split_rows (8, {W * H}) f32 -> 8 rows: {n_bad} mismatches")
    check(n_bad == 0, "K12 bit-equal to the twin")
    n_bad = bit_mismatches(k13, channel_rows_reference(texels), torch)
    log(f"  K13 channel_rows ({W * H}, 4) bf16 -> (4, {W * H}) f32: "
        f"{n_bad} mismatches")
    check(n_bad == 0, "K13 bit-equal to the twin")
    results["K12"] = dict(
        err=0.0, ms=cuda_ms(lambda: split_rows(tform), 20),
        plain_ms=cuda_ms(lambda: split_rows_reference(tform), 20),
        bound=bound(2 * nbytes(tform), 0.0),
        library_ms=cuda_ms(lambda: tform.float().clone().unbind(0), 20))
    results["K13"] = dict(
        err=0.0, ms=cuda_ms(lambda: channel_rows(texels), 20),
        plain_ms=cuda_ms(lambda: channel_rows_reference(texels), 20),
        bound=bound(nbytes(texels) + 4 * texels.numel(), 0.0),
        library_ms=cuda_ms(lambda: texels.t().float().contiguous(), 20))
    del tform, texels, k12, k13

    # ---- K11a / K11b against their twins, on the oracle's own calls ------
    n_fat = len(TR.plane_layout(True, True, True))
    (rows, zlo, zhi), kw7 = calls_k7[0]
    w7, h7 = kw7["width"], kw7["height"]
    lay = dict(has_uv1=kw7["has_uv1"], has_color=kw7["has_color"],
               analytic_derivs=kw7["analytic_derivs"])
    twins = (
        ("K11a_fat", f"K11a fat on the stress frame's opaque setup ({rw}x"
                     f"{rh}, {srows.shape[0] // TR.CHUNK} chunks)",
         lambda: TR.rasterize(srows, width=rw, height=rh, binned=False),
         lambda: TR.rasterize_dense_reference(srows, width=rw, height=rh),
         dense_bound(srows, rw, rh, n_fat, torch), 5),
        ("K11a_slim", f"K11a slim on the MSAA frame's setup ({w2}x{h2}, "
                      f"{m_rows.shape[0] // TR.CHUNK} chunks)",
         lambda: TR.rasterize(m_rows, width=w2, height=h2, binned=False,
                              slim=True),
         lambda: TR.rasterize_dense_reference(m_rows, width=w2, height=h2,
                                              slim=True),
         dense_bound(m_rows, w2, h2, 2, torch), 3),
        ("K11b", f"K11b on the volume + HUD frame's peel 0 ({w7}x{h7})",
         lambda: TR.rasterize_peel(rows, zlo, zhi, width=w7, height=h7,
                                   binned=False, **lay),
         lambda: TR.rasterize_peel_dense_reference(
             rows, zlo, zhi, width=w7, height=h7, **lay),
         dense_bound(rows, w7, h7, len(TR.plane_layout(**lay)), torch,
                     peel=True), 10),
    )
    for key, label, kern, twin, bd, reps in twins:
        a = kern()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        b = twin()
        ev[1].record()
        torch.cuda.synchronize()
        err = hold_planes(label, a, b, torch)
        del a, b
        results[key] = dict(err=err, ms=cuda_ms(kern, reps),
                            plain_ms=ev[0].elapsed_time(ev[1]), bound=bd,
                            library_ms=None)
        log(f"  {label}: kernel {results[key]['ms']:.4f} ms, twin "
            f"{results[key]['plain_ms']:.4f} ms, bound {bd[0]:.4f} ms "
            f"({bd[1]})")
    results["launches"] = launches
    results["summary"] = summary
    kernels.reset_launch_counts()
    secs = time.perf_counter() - t_phase
    log(f"  phase oracle took {secs:.1f} s")
    results["seconds"] = secs
    return results


def temporal_camera(r, np, i: int):
    """bench.py _temporal_headline's orbit arc: view i of 32, 0.008 rad a
    view at radius 14.14 (about 13 px of reprojection a frame)."""
    from awsm_renderer_tpu_torch.utils import math3d as m3

    a = 0.7854 + 0.008 * (i % 32)
    r.camera.update(m3.look_at([14.14 * np.sin(a), 7.0, 14.14 * np.cos(a)],
                               [0, 0, 0], [0, 1, 0]),
                    m3.perspective(np.pi / 3, W / H, 0.1, 200.0))


TEMPORAL_FRAMES = 24
TEMPORAL_PATH = ("rasterize16_slim", "reproject_history",
                 "resolve_planes_fused", "onehot_split_rows",
                 "tap_plan_fused", "filter_taps_fused",
                 "gather_split_channels", "rasterize_binned_compact")


def valid_by_mesh(r, cur_tid, v, np, torch):
    """Valid and blendable shares of the covered pixels whose winner
    belongs to a mesh of at most 12 triangles (the stress scene's boxes)
    and to a larger one (its 2,304-triangle spheres)."""
    tm = np.asarray(r._tri_mesh_device_order)
    n_tris = np.bincount(tm[tm >= 0], minlength=int(tm.max()) + 1)
    small = torch.as_tensor(n_tris <= 12, device=v.device)
    tm_dev = torch.as_tensor(tm, device=v.device).long()
    tid = cur_tid.reshape(v.shape)
    rows = tm_dev[(tid.clamp(min=0) % tm.shape[0]).long()]
    box = small[rows.clamp(min=0)] & (rows >= 0)
    out = []
    for sel in ((tid >= 0) & box, (tid >= 0) & ~box):
        n = max(int(sel.sum()), 1)
        out.append((n, int(((v & 1) > 0)[sel].sum()) / n,
                    int(((v & 2) > 0)[sel].sum()) / n))
    return out


def check_convergence(P, np, torch):
    """tests/test_temporal.py test_temporal_static_converges_to_plain on
    the card: the 128x32 box, 8 static temporal frames against the
    ordinary frame."""
    from awsm_renderer_tpu_torch.geometry import box
    from awsm_renderer_tpu_torch.utils import math3d as m3

    Wc, Hc = 128, 32

    def make(temporal):
        r = P.AwsmRendererTorch(P.RendererConfig(
            width=Wc, height=Hc,
            anti_aliasing=P.AntiAliasing(temporal=temporal),
            post_processing=P.PostProcessing(
                tonemapping=P.ToneMapping.NONE)), device=DEVICE)
        r.camera.update(m3.look_at([0, 0.5, 3], [0, 0, 0], [0, 1, 0]),
                        m3.perspective(np.pi / 3, Wc / Hc, 0.1, 100.0))
        r.add_mesh(box(), r.materials.insert(P.PbrMaterial()))
        return r

    rt = make(True)
    for _ in range(8):
        img = rt.render()
    ref = make(False).render()
    err = np.abs(img[..., :3] - ref[..., :3])
    mean, p95, mx = (float(err.mean()), float(np.percentile(err, 95)),
                     float(err.max()))
    check(np.isfinite(img).all() and mean < 2e-3 and p95 < 1e-2 and mx < 0.6,
          f"temporal convergence (128x32 box, 8 static frames vs the "
          f"ordinary frame): mean |d| {mean:.6f} (< 2e-3), 95th percentile "
          f"{p95:.6f} (< 1e-2), max {mx:.4f} (< 0.6)")


def phase_temporal(P, np, torch):
    """bench.py's temporal headline: the stress scene (panes included)
    with temporal AA, bloom and DoF at 1080p on bench.py's orbit arc. K10
    against its twin on a steady frame's own inputs, 24 timed orbit
    frames, host syncs, then the convergence check."""
    from awsm_renderer_tpu_torch.ops import kernels, temporal
    from awsm_renderer_tpu_torch.ops.temporal import (
        history_sources, reproject_history_planes,
        reproject_history_reference,
    )

    log(f"phase temporal: Stress-1080p-temporal-orbit (bench.py's temporal "
        f"headline, panes included) at {W}x{H}")
    r, keys, _ = build_stress_scene(P, np, DEVICE, effects=True,
                                    temporal=True)
    n_units = (-(-H // 8)) * (-(-W // 128))
    temporal_camera(r, np, 0)
    r.render_device()              # the reset frame: every unit shaded
    for i in (1, 2):
        temporal_camera(r, np, i)
        cap = capture_first_frame(r, ("reproject_history_planes",))
        torch.cuda.synchronize()
        check("reproject_history_planes" in cap,
              f"temporal frame {i} called K10")
        args, _ = cap["reproject_history_planes"]
        v_i = reproject_history_reference(*args)[3]
        for label, (n, val, bl) in zip(
                ("boxes", "spheres"), valid_by_mesh(r, args[4], v_i, np,
                                                    torch)):
            log(f"  frame {i} (view {i}) after the reset: {n} covered "
                f"pixels on {label}: valid {val:.4f}, blendable {bl:.4f}")
    prep = r._prep[1]
    log(f"  prep: DoF rings {prep['dof_rings']}, overlay tile cap "
        f"{prep['ov_tile_cap']}, crop {prep['ov_crop']}")
    results = {}

    # ---- K10 on frame 2's own inputs ---------------------------------------
    args, _ = cap["reproject_history_planes"]
    hist, off_x, off_y, exp_z, cur_tid, scal = args
    Hh, Wh = hist.shape[1:]
    a = reproject_history_planes(*args)
    b = reproject_history_reference(*args)
    torch.cuda.synchronize()
    n_bad = sum(bit_mismatches(x, y, torch) for x, y in zip(a, b))
    err = max(float((x - y).abs().max()) for x, y in zip(a[:3], b[:3]))
    v = a[3]
    cov = cur_tid.reshape(Hh, Wh) >= 0
    n_cov = int(cov.sum())
    src, inr = history_sources(off_x, off_y, scal, Hh, Wh)
    blend = (v & 2) > 0
    n_valid_cov = int(((v & 1) > 0)[cov].sum())
    log(f"  K10 reproject_history_planes history {tuple(hist.shape)} f32, "
        f"{scal.shape[0]} units ({int((scal[:, 4] > 0).sum())} ok): "
        f"{n_bad} mismatching values; in range {int(inr.sum())}, blendable "
        f"{int(blend.sum())}, valid {int(((v & 1) > 0).sum())} of "
        f"{v.numel()} pixels; of the {n_cov} covered, valid {n_valid_cov}")
    check(n_bad == 0, "K10 bit-equal to the plain twin on frame 2's inputs")
    check(n_valid_cov > 0, "the steady frame reuses covered pixels")
    # bytes: the planes in and out once, the history's tid at each
    # distinct in-range source, its colours and depth at each distinct
    # blendable source
    n_tid = int(torch.unique(src[inr.reshape(-1)]).numel())
    n_col = int(torch.unique(src[blend.reshape(-1)]).numel())
    hist2 = hist.reshape(5, -1)
    results["K10"] = dict(
        err=err,
        ms=cuda_ms(lambda: reproject_history_planes(*args), 50),
        plain_ms=cuda_ms(lambda: reproject_history_reference(*args), 10),
        bound=bound(nbytes(off_x, off_y, exp_z, cur_tid, scal, *a)
                    + 4 * n_tid + 16 * n_col, 0.0),
        library_ms=cuda_ms(lambda: torch.index_select(hist2, 1, src), 50))
    log(f"  K10: kernel {results['K10']['ms']:.4f} ms, twin "
        f"{results['K10']['plain_ms']:.4f} ms, bound "
        f"{results['K10']['bound'][0]:.4f} ms ({results['K10']['bound'][1]})"
        f", index_select {results['K10']['library_ms']:.4f} ms")
    del cap, args, hist, a, b, src, inr, hist2
    kernels.reset_launch_counts()

    # ---- 24 timed orbit frames ---------------------------------------------
    seen, ages = [], []
    orig = temporal.reproject_history_planes

    def recorder(*a_):
        out = orig(*a_)
        seen.append((a_[4], out[3]))         # cur_tid, v
        return out

    temporal.reproject_history_planes = recorder
    try:
        img, med, wall, counts = orbit_frames(
            r, np, torch, lambda i: temporal_camera(r, np, 3 + i),
            TEMPORAL_PATH, n_frames=TEMPORAL_FRAMES,
            after=lambda rr: ages.append(rr._temporal["age"]))
    finally:
        temporal.reproject_history_planes = orig
    cap_c = max(1, min(n_units, round(r.config.temporal.cap_frac * n_units)))
    cs = []
    for i, ((ctid, vv), age) in enumerate(zip(seen[1:], ages)):
        cv = ctid.reshape(vv.shape) >= 0
        n = max(int(cv.sum()), 1)
        C = int((age == 0).sum())
        cs.append(C)
        log(f"  orbit frame {i + 1} (view {4 + i}): C = {C} of {n_units} "
            f"units; covered pixels {n}: valid "
            f"{int(((vv & 1) > 0)[cv].sum()) / n:.4f}, blendable "
            f"{int(((vv & 2) > 0)[cv].sum()) / n:.4f}")
    check(all(c == cap_c for c in cs),
          f"C = {cap_c} units shaded on each of {len(cs)} orbit frames")
    check_image(img, np, torch)
    tid = r._last_tri_id
    x, y = W // 2, H // 2
    key = r.pick(x, y)
    t = int(tid[y, x])
    want = (None if t < 0 else
            r._mesh_row_to_key.get(int(r._tri_mesh_device_order[t])))
    check(key == want and (key is None or key in keys),
          f"pick({x}, {y}) = {key} matches tri_id {t}")
    del seen, ages
    results["syncs"] = count_syncs(
        r, torch, "temporal (steady)", lambda i: temporal_camera(r, np, i),
        3 + TEMPORAL_FRAMES + 1)
    results["frames"] = (med, wall, counts)
    del r
    check_convergence(P, np, torch)
    kernels.reset_launch_counts()
    return results


def build_helmet_scene(P, np, device):
    """The glTF catalog's helmet (gltf/samples.py glb_helmet) written to
    build/chip_smoke/, loaded with load_gltf + populate_gltf at W x H
    under the env-ibl equirect at size 128. Returns (renderer, orbit
    camera setter, (glb build s, load + populate s, glb bytes))."""
    from awsm_renderer_tpu_torch.gltf.samples import glb_helmet

    out_dir = os.path.join(REPO, "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    glb, _cam = glb_helmet()
    path = os.path.join(out_dir, "glb-helmet.glb")
    with open(path, "wb") as f:
        f.write(glb)
    t1 = time.perf_counter()
    r = P.AwsmRendererTorch(P.RendererConfig(width=W, height=H),
                            device=device)
    P.populate_gltf(r, P.load_gltf(path))
    r.environment.set_environment_from_equirect(env_ibl_equirect(np),
                                                size=128)
    t2 = time.perf_counter()

    def camera(i):      # the catalog camera's distance and height
        orbit_camera(r, np, i, rad=2.55, height=0.9)

    return r, camera, (t1 - t0, t2 - t1, len(glb))


def phase_gltf(P, np, torch):
    """The glTF catalog's helmet through load_gltf + populate_gltf at
    1080p: load time, the native host library, 12 orbit frames."""
    from awsm_renderer_tpu_torch.utils import native

    log(f"phase gltf: glb-helmet at {W}x{H} under the env-ibl equirect")
    r, camera, (t_glb, t_load, n_bytes) = build_helmet_scene(P, np, DEVICE)
    lib = native._load()
    log(f"  glb built in {t_glb:.2f} s ({n_bytes} bytes); load_gltf + "
        f"populate_gltf in {t_load:.2f} s; native host library "
        f"{'loaded' if lib is not None else 'missing: numpy fallback'} "
        f"({os.path.relpath(native._LIB_PATH, REPO)})")
    n_tex = int((r.materials.tex_slots[:, :, 0] >= 0).sum())
    log(f"  {r.meshes.count} meshes, {int((r.meshes.tri_mesh >= 0).sum())} "
        f"triangles, {n_tex} bound texture slots, texel pool "
        f"{r.textures.texels_packed.shape[0]} rows")
    check(n_tex == 5, "the helmet binds five texture slots")
    cap = capture_first_frame(r, ("tap_plan_fused", "filter_taps_fused"))
    torch.cuda.synchronize()
    P_px = W * H
    check(cap["tap_plan_fused"][0][0].shape[0] == 5 * P_px,
          "the helmet frame plans five taps per pixel in one K4 launch")
    k45 = check_k4_k5(cap, "helmet", torch)
    img, med, wall, counts = orbit_frames(r, np, torch, camera, OPAQUE_PATH)
    check_image(img, np, torch)
    count_syncs(r, torch, "glb-helmet (opaque only)", camera, N_FRAMES + 1)
    return med, wall, counts, k45


def phase_golden(P, np, torch):
    """Small probe scenes on the card against the checked-in goldens, at
    tests/test_golden.py's tolerance (< 0.5% of channel values off by
    more than 4/255)."""
    from PIL import Image

    from awsm_renderer_tpu_torch.geometry import box, uv_sphere
    from awsm_renderer_tpu_torch.utils import math3d as m3

    def scene_box(r):
        mat = r.materials.insert(P.PbrMaterial(
            base_color_factor=np.array([0.7, 0.2, 0.2, 1], np.float32),
            roughness_factor=0.5))
        r.add_mesh(box(), mat)
        r.lights.insert(P.Light.directional([-0.5, -1.0, -0.3],
                                            intensity=2.5))
        return [1.5, 1.2, 2.2]

    def scene_env_ibl(r):
        r.environment.set_environment_from_equirect(env_ibl_equirect(np),
                                                    size=32)
        for x, rough in ((-0.75, 0.08), (0.75, 0.7)):
            c = 1.0 if rough < 0.5 else 0.9
            mat = r.materials.insert(P.PbrMaterial(
                base_color_factor=np.array([c, c, c, 1], np.float32),
                metallic_factor=1.0, roughness_factor=rough))
            r.add_mesh(uv_sphere(0.55), mat, transform=P.Transform(
                translation=np.array([x, 0, 0], np.float32)))
        r.lights.insert(P.Light.directional([-0.5, -1.0, -0.3],
                                            intensity=2.5))
        return [0, 0.3, 3.0]

    def scene_box_textured(r):
        from awsm_renderer_tpu_torch.core.materials import TS_BASE_COLOR
        from awsm_renderer_tpu_torch.geometry import checker_texture

        tex = r.textures.add_image(checker_texture(128, 8), srgb=True)
        mat = r.materials.insert(P.PbrMaterial(
            roughness_factor=0.7, textures={TS_BASE_COLOR: P.TextureRef(
                r.textures.row_of(tex))}))
        r.add_mesh(box(), mat)
        r.lights.insert(P.Light.directional([-0.5, -1.0, -0.3],
                                            intensity=2.5))
        return [1.5, 1.2, 2.2]

    def scene_alpha_blend(r):
        """demo/scenes.py scene_alpha_blend: opaque, mask and blend boxes
        over a backdrop."""
        from awsm_renderer_tpu_torch.core.materials import TS_BASE_COLOR
        from awsm_renderer_tpu_torch.geometry import plane

        img = np.zeros((32, 32, 4), np.uint8)
        img[:, :, :3] = 200
        img[:, :, 3] = 255
        img[8:24, 8:24] = [80, 220, 80, 100]
        ref = P.TextureRef(r.textures.row_of(r.textures.add_image(
            img, srgb=True)))
        for i, mode in enumerate((P.AlphaMode.OPAQUE, P.AlphaMode.MASK,
                                  P.AlphaMode.BLEND)):
            mat = r.materials.insert(P.UnlitMaterial(
                alpha_mode=mode, textures={TS_BASE_COLOR: ref}))
            r.add_mesh(box(0.8), mat, transform=P.Transform(
                translation=np.array([(i - 1) * 1.2, 0, 0], np.float32)))
        back = r.materials.insert(P.UnlitMaterial(
            base_color_factor=np.array([0.9, 0.2, 0.2, 1], np.float32)))
        r.add_mesh(plane(6), back, transform=P.Transform(
            translation=np.array([0, 0, -1.5], np.float32),
            rotation=np.array([0.7071, 0, 0, 0.7071], np.float32)))
        return [0, 0.6, 3.5]

    def hold(name, img, tight=False):
        golden = np.asarray(Image.open(os.path.join(
            REPO, "tests", "goldens", f"{name}.png"))).astype(np.int16)
        check(golden.shape == img.shape, f"{name}: shape {img.shape}")
        diff = np.abs(golden - img.astype(np.int16))
        if tight:     # tests/test_parity_golden.py
            frac = float((diff > 2).mean())
            check(diff.mean() <= 1.0 and frac <= 0.003,
                  f"{name}: mean |diff| {diff.mean():.4f} (limit 1), "
                  f"{frac:.4%} off by > 2/255 (limit 0.3%)")
            return
        frac = float((diff > 4).mean())
        check(frac < 0.005, f"{name}: {frac:.4%} of channel values off "
                            f"by > 4/255 (limit 0.5%)")

    log("phase golden: 128x64 probes and effect goldens, 256x128 glTF "
        "goldens, 512x256 and 1024x512 parity goldens on the card")
    for name, fn in (("box", scene_box), ("env-ibl", scene_env_ibl),
                     ("box-textured", scene_box_textured),
                     ("alpha-blend", scene_alpha_blend)):
        r = P.AwsmRendererTorch(P.RendererConfig(width=128, height=64),
                                device=DEVICE)
        eye = fn(r)
        r.update_all(0.35, m3.look_at(eye, [0, 0, 0], [0, 1, 0]),
                     m3.perspective(np.pi / 3, 2.0, 0.05, 500.0))
        hold(name, r.render_u8())

    from awsm_renderer_tpu_torch.gltf.samples import SAMPLES

    out_dir = os.path.join(REPO, "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    # tests/test_parity_golden.py test_effect_golden_refraction
    from awsm_renderer_tpu_torch.core.materials import TS_BASE_COLOR
    from awsm_renderer_tpu_torch.geometry import checker_texture, plane

    r = P.AwsmRendererTorch(P.RendererConfig(width=128, height=64),
                            device=DEVICE)
    r.camera.update(m3.look_at([0, 0.6, 3.0], [0, 0, 0], [0, 1, 0]),
                    m3.perspective(np.pi / 3, 2.0, 0.1, 100.0))
    tex = r.textures.add_image(
        checker_texture(64, 8, (230, 80, 40), (240, 235, 220)), srgb=True)
    back = r.materials.insert(P.PbrMaterial(
        base_color_factor=np.ones(4, np.float32), roughness_factor=0.9,
        textures={TS_BASE_COLOR: P.TextureRef(r.textures.row_of(tex))}))
    glass = r.materials.insert(P.PbrMaterial(
        base_color_factor=np.array([1, 1, 1, 1], np.float32),
        transmission_factor=1.0, thickness=0.3, ior=1.5,
        roughness_factor=0.05, metallic_factor=0.0))
    r.add_mesh(plane(3.5), back, transform=P.Transform(
        translation=np.array([0, 0, -0.8], np.float32),
        rotation=m3.quat_from_axis_angle([1, 0, 0], np.pi / 2)))
    r.add_mesh(uv_sphere(0.55), glass)
    r.lights.insert(P.Light.directional([-0.5, -1, -0.3], intensity=2.0))
    hold("effect-refraction", r.render_u8(), tight=True)

    # tests/test_parity_golden.py's effect goldens: bloom, DoF, SMAA, MSAA
    def effect_renderer(width=128, height=64, **cfg):
        r = P.AwsmRendererTorch(P.RendererConfig(width=width, height=height,
                                                 **cfg), device=DEVICE)
        r.camera.update(m3.look_at([0, 0.6, 3.0], [0, 0, 0], [0, 1, 0]),
                        m3.perspective(np.pi / 3, width / height, 0.1,
                                       100.0))
        return r

    F = np.float32
    r = effect_renderer(post_processing=P.PostProcessing(
        tonemapping=P.ToneMapping.ACES, bloom=True))
    glow = r.materials.insert(P.PbrMaterial(
        base_color_factor=np.array([0.1, 0.1, 0.1, 1], F),
        emissive_factor=np.array([4.0, 3.2, 1.2], F), roughness_factor=0.8))
    dark = r.materials.insert(P.PbrMaterial(
        base_color_factor=np.array([0.2, 0.2, 0.25, 1], F)))
    r.add_mesh(uv_sphere(0.45), glow)
    r.add_mesh(box(0.5), dark, transform=P.Transform(
        translation=np.array([-1.1, 0, 0], F)))
    r.lights.insert(P.Light.directional([-0.5, -1, -0.3], intensity=1.0))
    hold("effect-bloom", r.render_u8(), tight=True)

    r = effect_renderer(post_processing=P.PostProcessing(
        tonemapping=P.ToneMapping.KHRONOS_PBR_NEUTRAL, dof=True))
    r.camera.dof.focus_distance = 3.0
    r.camera.dof.aperture = 0.1
    for size, rgba, z in ((0.5, (0.9, 0.3, 0.2, 1), 0.0),
                          (2.0, (0.2, 0.6, 0.9, 1), -14.0)):
        mat = r.materials.insert(P.UnlitMaterial(
            base_color_factor=np.array(rgba, F)))
        r.add_mesh(box(size), mat, transform=P.Transform(
            translation=np.array([0.8 if z else 0.0, 0, z], F)))
    hold("effect-dof", r.render_u8(), tight=True)

    for name, aa in (("effect-smaa", dict(smaa=True)),
                     ("effect-msaa", dict(msaa=True))):
        r = effect_renderer(anti_aliasing=P.AntiAliasing(**aa))
        mat = r.materials.insert(P.UnlitMaterial(
            base_color_factor=np.array([1, 1, 1, 1], F)))
        r.add_mesh(box(0.8), mat, transform=P.Transform(
            rotation=m3.quat_from_axis_angle([0, 0, 1], 0.3)))
        hold(name, r.render_u8(), tight=True)

    # tests/test_parity_golden.py test_parity_production_msaa_1024 (slow
    # on the CPU): MSAA with a real opaque tile cap, the overlay crop and
    # compaction, K-layer panes, bloom + DoF at 1024x512
    Wp, Hp = 1024, 512
    r = P.AwsmRendererTorch(P.RendererConfig(
        width=Wp, height=Hp,
        anti_aliasing=P.AntiAliasing(msaa=True, mipmap=True),
        post_processing=P.PostProcessing(
            tonemapping=P.ToneMapping.ACES, bloom=True, dof=True)),
        device=DEVICE)
    rng = np.random.default_rng(5)
    tex = r.textures.add_image(
        checker_texture(64, 8, (210, 160, 90), (60, 50, 45)), srgb=True)
    mats = [r.materials.insert(P.PbrMaterial(
        base_color_factor=np.array([*rng.uniform(0.3, 1.0, 3), 1.0], F),
        metallic_factor=float(rng.uniform(0, 1)),
        roughness_factor=float(rng.uniform(0.25, 0.9)),
        textures={TS_BASE_COLOR: P.TextureRef(r.textures.row_of(tex))}))
        for _ in range(6)]
    glass = r.materials.insert(P.PbrMaterial(
        base_color_factor=np.array([0.35, 0.6, 0.9, 0.45], F),
        alpha_mode=P.AlphaMode.BLEND, roughness_factor=0.1))
    box_res = r.meshes.insert_resource(box(0.7))
    sph_res = r.meshes.insert_resource(uv_sphere(0.4, rings=12, sectors=24))
    for gx in range(-3, 4):
        for gz in range(-3, 4):
            res = box_res if (gx + gz) % 2 == 0 else sph_res
            tk = r.transforms.insert(P.Transform(translation=np.array(
                [gx * 1.3, float(rng.uniform(-0.25, 0.25)), gz * 1.3], F)))
            r.transforms.update_world()
            r.meshes.insert(res, r.transforms.row_of(tk),
                            r.materials.row_of(mats[(gx * 7 + gz) % 6]),
                            tk, mats[(gx * 7 + gz) % 6])
    pane = r.meshes.insert_resource(box(0.8))
    for i in range(6):
        a = 2 * np.pi * i / 6
        tk = r.transforms.insert(P.Transform(translation=np.array(
            [np.cos(a) * 2.6, 0.9, np.sin(a) * 2.6], F)))
        r.transforms.update_world()
        r.meshes.insert(pane, r.transforms.row_of(tk),
                        r.materials.row_of(glass), tk, glass,
                        transparent=True)
    r.meshes.update_world(r.transforms)
    r.lights.insert(P.Light.directional([-0.5, -1, -0.3], intensity=2.0))
    r.lights.insert(P.Light.point([3, 2, 3], intensity=8.0, range=12.0))
    r.camera.update(m3.look_at([6, 4.2, 6], [0, 0, 0], [0, 1, 0]),
                    m3.perspective(np.pi / 3, Wp / Hp, 0.1, 120.0))
    r.camera.dof.focus_distance = 9.0
    r.camera.dof.aperture = 1.0
    masks = r._mesh_masks()
    check(r._bucket_tile_cap(masks, "opaque") is not None
          and r._bucket_tile_cap(masks, "transparent", tile_h=32,
                                 tile_w=32) is not None,
          "parity-production-msaa-1024: the opaque and transparent tile "
          "caps engage")
    img = r.render_u8()
    hold("parity-production-msaa-1024", img, tight=True)
    cov = (np.abs(np.diff(img[..., 1].astype(np.int16), axis=0)) > 6).mean()
    check(cov > 0.02, f"parity-production-msaa-1024: dense coverage {cov:.3f}")

    for name in ("glb-helmet", "glb-texture-transform", "glb-multi-uv",
                 "glb-ext-clearcoat", "glb-alpha-modes",
                 "glb-ext-transmission", "glb-sponza-lite"):
        glb, (eye, center) = SAMPLES[name]()
        path = os.path.join(out_dir, f"{name}.glb")
        with open(path, "wb") as f:
            f.write(glb)
        r = P.AwsmRendererTorch(P.RendererConfig(width=256, height=128),
                                device=DEVICE)
        P.populate_gltf(r, P.load_gltf(path))
        r.update_all(0.35, m3.look_at(eye, center, (0, 1, 0)),
                     m3.perspective(np.pi / 3, 2.0, 0.05, 100.0))
        hold(name, r.render_u8())

    # tests/test_parity_golden.py _render_glb at 512x256, tight tolerance
    # (test_parity_glb_512, test_parity_ext_512), with their coverage checks
    exts = ("anisotropy", "clearcoat", "iridescence", "sheen", "specular",
            "transmission", "unlit")
    for name, golden in (
            [("glb-helmet", "parity-glb-helmet-512"),
             ("glb-alpha-modes", "parity-glb-alpha-modes-512")]
            + [(f"glb-ext-{v}", f"parity-ext-{v}-512") for v in exts]):
        glb, (eye, center) = SAMPLES[name]()
        path = os.path.join(out_dir, f"{name}.glb")
        with open(path, "wb") as f:
            f.write(glb)
        r = P.AwsmRendererTorch(P.RendererConfig(width=512, height=256),
                                device=DEVICE)
        P.populate_gltf(r, P.load_gltf(path))
        r.lights.insert(P.Light.directional([-0.4, -1.0, -0.35],
                                            intensity=2.5))
        r.lights.insert(P.Light.point([2.0, 1.5, 2.0], color=(1.0, 0.9, 0.8),
                                      intensity=6.0))
        r.update_all(0.0, m3.look_at(eye, center, (0, 1, 0)),
                     m3.perspective(np.pi / 3, 2.0, 0.05, 500.0))
        img = r.render_u8()
        hold(golden, img, tight=True)
        if name.startswith("glb-ext-"):
            bg = img[2, 2, :3].astype(np.int16)
            cov = float((np.abs(img[..., :3].astype(np.int16) - bg)
                         .max(axis=-1) > 8).mean())
            check(cov > 0.05, f"{golden}: the sphere covers {cov:.3f} of "
                              f"the frame (> 0.05)")
        else:
            cov = float((np.abs(np.diff(img[..., 0].astype(np.int16),
                                        axis=1)) > 8).mean())
            check(cov > 0.01, f"{golden}: edge coverage {cov:.3f} (> 0.01)")


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; the port's smoke run "
              "needs one card", file=sys.stderr)
        return 2
    try:
        import awsm_renderer_tpu_torch as P
        from awsm_renderer_tpu_torch.ops import kernels
    except ImportError as e:
        print(f"chip_smoke: the port package is missing ({e})",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    log(f"device: {torch.cuda.get_device_name(0)}, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    path = kernels.build()
    kernels.lib()
    log(f"phase build: {os.path.relpath(path, REPO)} in "
        f"{time.perf_counter() - t0:.1f} s")
    for line in kernels.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    t0 = time.perf_counter()
    r, keys, _ = build_stress_scene(P, np, DEVICE)
    orbit_camera(r, np, 0)
    n_tris = int((r.meshes.tri_mesh >= 0).sum())
    log(f"phase scene: Stress-1080p-ibl-tex, {r.meshes.count} meshes "
        f"({len(keys)} opaque, 12 glass panes), {n_tris} triangles, "
        f"{r.lights.count} lights, 3 base-colour textures, built in "
        f"{time.perf_counter() - t0:.1f} s")

    results, cap, k8_calls = phase_kernels(r, np, torch)
    med, wall, counts = phase_frame(r, keys, np, torch)
    ov = phase_overlay(P, np, torch, r, cap)
    results.update((k, ov[k]) for k in ("K7", "K8", "K6f32"))
    cap_k1 = {"rasterize16_slim": cap["rasterize16_slim"]}
    del r, cap
    aa = phase_aa(P, np, torch)
    results["K9"] = aa["K9"]
    orc = phase_oracle(P, np, torch, cap_k1, k8_calls, ov.pop("k7_calls"),
                       aa.pop("msaa_in"))
    del cap_k1, k8_calls
    results.update((k, orc[k]) for k in ("K11a_fat", "K11b", "K12", "K13"))
    tm = phase_temporal(P, np, torch)
    results["K10"] = tm["K10"]
    h_med, h_wall, _h_counts, (h_k4, h_k5) = phase_gltf(P, np, torch)
    phase_golden(P, np, torch)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else \
        "nvidia-smi unavailable"
    b_med, b_wall, b_counts = ov["frames_b"]
    log(f"frame Stress-1080p-ibl-tex: median {med:.3f} ms/frame (CUDA "
        f"events), host wall {wall:.3f} ms/frame, {ov['syncs_a']} host "
        f"syncs/frame, at {W}x{H} ({card})")
    log(f"frame Stress-1080p-ibl-tex + volume panes + HUD: median "
        f"{b_med:.3f} ms/frame (CUDA events), host wall {b_wall:.3f} "
        f"ms/frame, {ov['syncs_b']} host syncs/frame, at {W}x{H} ({card})")
    log(f"frame glb-helmet: median {h_med:.3f} ms/frame (CUDA events), host "
        f"wall {h_wall:.3f} ms/frame, at {W}x{H} ({card})")
    log(f"helmet batch: K4 {h_k4['ms']:.4f} ms (twin {h_k4['plain_ms']:.4f}"
        f"), K5 {h_k5['ms']:.4f} ms (twin {h_k5['plain_ms']:.4f}) ({card})")
    log(f"K7 without a peel (the HUD): {ov['K7_nopeel_ms']:.4f} ms ({card})")
    a_med, a_wall, a_counts = aa["frames"]
    log(f"frame Stress-1080p-msaa-bloom-dof: median {a_med:.3f} ms/frame "
        f"(CUDA events), host wall {a_wall:.3f} ms/frame, {aa['syncs']} host"
        f" syncs/frame, at {W}x{H} ({card})")
    t_med, t_wall, t_counts = tm["frames"]
    log(f"frame Stress-1080p-temporal-orbit: median {t_med:.3f} ms/frame "
        f"(CUDA events), host wall {t_wall:.3f} ms/frame, {tm['syncs']} "
        f"host syncs/frame, over {TEMPORAL_FRAMES} orbit frames at {W}x{H} "
        f"({card})")
    for label in ("supersample", "smaa"):
        ms, peak = aa[label]
        log(f"frame Stress-1080p-ibl-tex + {label}: median {ms:.3f} ms/frame"
            f", peak device memory {peak:.2f} GiB, at {W}x{H} ({card})")
    for label, v in aa["K2_msaa"].items():
        log(f"K2 [{label}] entry: kernel {v['ms']:.4f} ms, twin "
            f"{v['plain_ms']:.4f} ms ({card})")
    sl = orc["K11a_slim"]
    log(f"K11a slim on the MSAA frame's setup at 2x: kernel {sl['ms']:.4f} "
        f"ms, twin {sl['plain_ms']:.4f} ms, bound {sl['bound'][0]:.4f} ms "
        f"({sl['bound'][1]}) ({card})")
    for k, v in orc["summary"].items():
        log(f"oracle vs {k}: {v['n']} pixels compared, {v['mismatches']} "
            f"tri_id mismatches: {v['ties']} exact depth ties, "
            f"{v['k9_rounding']} K9 sample-rounding flips, "
            f"{v['unclassified']} unclassified")
    log(f"phase oracle: {orc['seconds']:.1f} s ({card})")
    sources = {
        "K1": ("rasterize16_slim", "awsm_renderer_tpu_torch/csrc/raster16.cu",
               "awsm_renderer_tpu/ops/raster.py:1615"),
        "K2": ("resolve_planes_fused",
               "awsm_renderer_tpu_torch/csrc/resolve.cu",
               "awsm_renderer_tpu/ops/shade.py:499"),
        "K3": ("onehot_split_rows", "awsm_renderer_tpu_torch/csrc/relayout.cu",
               "awsm_renderer_tpu/ops/relayout.py:157"),
        "K4": ("tap_plan_fused", "awsm_renderer_tpu_torch/csrc/texsample.cu",
               "awsm_renderer_tpu/ops/texsample.py:403"),
        "K5": ("filter_taps_fused",
               "awsm_renderer_tpu_torch/csrc/texsample.cu",
               "awsm_renderer_tpu/ops/texsample.py:448"),
        "K6": ("gather_split_channels",
               "awsm_renderer_tpu_torch/csrc/relayout.cu",
               "awsm_renderer_tpu/ops/relayout.py:69"),
        "K6f32": ("gather_split_channels_f32",
                  "awsm_renderer_tpu_torch/csrc/relayout.cu",
                  "awsm_renderer_tpu/ops/relayout.py:69"),
        "K7": ("rasterize_binned", "awsm_renderer_tpu_torch/csrc/binned.cu",
               "awsm_renderer_tpu/ops/raster.py:705"),
        "K8": ("rasterize_binned_compact",
               "awsm_renderer_tpu_torch/csrc/binned.cu",
               "awsm_renderer_tpu/ops/raster.py:1001"),
        "K9": ("rasterize16_msaa",
               "awsm_renderer_tpu_torch/csrc/raster_msaa.cu",
               "awsm_renderer_tpu/ops/raster.py:1966"),
        "K10": ("reproject_history",
                "awsm_renderer_tpu_torch/csrc/temporal.cu",
                "awsm_renderer_tpu/ops/temporal.py:430"),
        "K11a_fat": ("rasterize_dense",
                     "awsm_renderer_tpu_torch/csrc/dense.cu",
                     "awsm_renderer_tpu/ops/raster.py:807"),
        "K11b": ("rasterize_peel_dense",
                 "awsm_renderer_tpu_torch/csrc/dense.cu",
                 "awsm_renderer_tpu/ops/raster.py:872"),
        "K12": ("split_rows", "awsm_renderer_tpu_torch/csrc/relayout.cu",
                "awsm_renderer_tpu/ops/relayout.py:106"),
        "K13": ("channel_rows", "awsm_renderer_tpu_torch/csrc/relayout.cu",
                "awsm_renderer_tpu/ops/relayout.py:188"),
    }
    out = []
    for k, (name, src, rep) in sources.items():
        res = results[k]
        # launches on the main path that runs the kernel: the stress
        # frames, or (K7, K6-f32) the volume + HUD frames, or (K9) the
        # MSAA frames, or (K10) the temporal frames; K11-K13 run on no
        # frame path: the oracle phase's comparisons (K11) and its
        # standalone calls (K12, K13)
        n = (counts[name] or b_counts[name] or a_counts[name]
             or t_counts[name] or orc["launches"][name])
        bound_ms, bound_by = res["bound"]
        lib = res["library_ms"]
        log(f"  {k} {name}: kernel {res['ms']:.4f} ms, twin "
            f"{res['plain_ms']:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})"
            f", library {'-' if lib is None else f'{lib:.4f} ms'}, "
            f"{n} launches over the path's timed frames ({card})")
        out.append({"name": name, "route": "cuda", "source": src,
                    "replaces": rep, "launches": n,
                    "max_abs_err": res["err"], "ms": res["ms"],
                    "plain_ms": res["plain_ms"], "bound_ms": bound_ms,
                    "bound_by": bound_by, "library_ms": lib})
    print(json.dumps({"kernels": out}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
