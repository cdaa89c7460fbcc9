#!/usr/bin/env python3
"""Smoke run of the PyTorch port (awsm_renderer_tpu_torch) on one CUDA card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA device and exits non-zero without one (it never falls
back to the CPU). Phases:

  build    compile the port's CUDA kernels (csrc/) from the checkout;
  scene    build bench.py's 1080p stress scene "Stress-1080p-ibl-tex"
           through the port's API (15x15 colonnade of boxes and spheres,
           ~259k triangles, 12 random PBR materials with bench.py's three
           sRGB 128x128 checker base-colour textures and mip chains, seed
           42, 1 directional + 6 point lights) without the glass panes,
           under the procedural "env-ibl" equirect environment at size
           128;
  kernels  run K1 raster, K2 resolve, K3 material fetch, K4 tap planner,
           K5 texel filter and K6 env-tap gather on the first frame's real
           intermediates, each against its plain PyTorch twin on the card
           (K1/K3/K5/K6 bit-equal, K2 ints equal and floats rtol 1e-5 atol
           1e-6, K4 indices equal and weights within 1e-6 except at taps
           whose LOD lies within 1e-5 of an integer, fewer than 0.01% of
           taps), and time both; K4 and K5 again on the helmet frame's
           five-tap batch;
  frame    render 12 stress frames under a camera orbit, check that every
           kernel launched on each frame, that the image is finite with
           both sky and geometry, and that pick() agrees with the tri_id
           plane;
  gltf     build the glTF catalog's helmet (five 1024x1024 maps) with the
           port's gltf/samples.py, load_gltf + populate_gltf it at 1080p
           under the same environment, render 12 orbit frames and check
           launches and the image;
  golden   render the 128x64 "box", "env-ibl" and "box-textured" probes
           and the 256x128 glTF goldens "glb-helmet",
           "glb-texture-transform", "glb-multi-uv" and "glb-ext-clearcoat"
           on the card and hold them against tests/goldens at the golden
           tolerance.

Prints one line per check, then a JSON line of per-kernel results, the
card's name and power limit, and last the ok line. Any failed phase
raises, and the script exits non-zero.
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


def env_ibl_equirect(np):
    """The procedural equirect of demo/scenes.py scene_env_ibl."""
    eq = np.zeros((32, 64, 3), np.float32)
    v = np.linspace(0, 1, 32)[:, None]
    eq[..., 0] = 0.2 + 0.8 * v
    eq[..., 1] = 0.3 + 0.25 * v
    eq[..., 2] = 1.0 - 0.8 * v
    return eq


def build_stress_scene(P, np, device, textured=True):
    """bench.py build_stress_scene(effects=False) geometry, textures and
    lights, through the port's API; the glass panes left out (the
    transparent overlay is not ported). textured=False leaves the
    base-colour slots unbound (the untextured frame of earlier runs)."""
    from awsm_renderer_tpu_torch.core.materials import TS_BASE_COLOR
    from awsm_renderer_tpu_torch.geometry import (
        box, checker_texture, uv_sphere,
    )

    r = P.AwsmRendererTorch(P.RendererConfig(width=W, height=H),
                            device=device)
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
    box_res = r.meshes.insert_resource(box(0.8))
    sph_res = r.meshes.insert_resource(uv_sphere(0.45, rings=24, sectors=48))
    keys = []
    for gx in range(-7, 8):
        for gz in range(-7, 8):
            res = box_res if (gx + gz) % 2 == 0 else sph_res
            mat = mats[(gx * 15 + gz) % 12]
            tk = r.transforms.insert(P.Transform(translation=np.array(
                [gx * 1.6, float(rng.uniform(-0.3, 0.3)), gz * 1.6],
                np.float32)))
            r.transforms.update_world()
            keys.append(r.meshes.insert(res, r.transforms.row_of(tk),
                                        r.materials.row_of(mat), tk, mat))
    r.meshes.update_world(r.transforms)
    r.lights.insert(P.Light.directional([-0.5, -1, -0.3], intensity=2.0))
    for i in range(6):
        r.lights.insert(P.Light.point(
            [np.cos(i) * 6, 2.0, np.sin(i) * 6],
            color=tuple(rng.uniform(0.4, 1, 3)), intensity=10.0, range=15.0))
    r.environment.set_environment_from_equirect(env_ibl_equirect(np),
                                                size=128)
    return r, keys


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


def capture_first_frame(r, names=KERNEL_SITES):
    """Render one frame with recorders on the kernel wrappers `names`;
    return the arguments each was called with on the main path."""
    from awsm_renderer_tpu_torch.ops import cubemap, raster, shade, texsample

    captured = {}
    where = {"rasterize16_slim": raster, "resolve_planes_fused": shade,
             "onehot_split_rows": shade, "tap_plan_fused": texsample,
             "filter_taps_fused": texsample,
             "gather_split_channels": cubemap}
    sites = tuple((where[n], n) for n in names)
    originals = [getattr(mod, attr) for mod, attr in sites]

    def recorder(attr, fn):
        def wrapped(*args, **kwargs):
            captured[attr] = (args, kwargs)
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
    """First-frame intermediates -> each kernel vs its twin, timed."""
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

    log("phase kernels: the first frame's intermediates")
    cap = capture_first_frame(r)
    torch.cuda.synchronize()
    check(sorted(cap) == sorted(KERNEL_SITES),
          "the first frame called all six kernel wrappers")
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
    results["K1"] = dict(
        err=err,
        ms=cuda_ms(lambda: rasterize16_slim(srows, bins, width=rw,
                                            height=rh), 20),
        plain_ms=cuda_ms(lambda: rasterize16_slim_reference(
            srows, bins, width=rw, height=rh), 2))

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
    results["K2"] = dict(
        err=err,
        ms=cuda_ms(lambda: resolve_planes_fused(tid, srows2, **kw), 20),
        plain_ms=cuda_ms(lambda: resolve_planes_reference(tid, srows2, **kw),
                         5))

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
    results["K3"] = dict(
        err=err,
        ms=cuda_ms(lambda: onehot_split_rows(mat_row, table), 20),
        plain_ms=cuda_ms(lambda: onehot_split_rows_reference(mat_row,
                                                             table), 20))

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
    results["K6"] = dict(
        err=err,
        ms=cuda_ms(lambda: gather_split_channels(texels, idx, ncols), 20),
        plain_ms=cuda_ms(lambda: gather_split_channels_reference(
            texels, idx, ncols), 20))
    results["K4"], results["K5"] = check_k4_k5(cap, "stress", torch)
    for k, v in results.items():
        log(f"  {k}: kernel {v['ms']:.4f} ms, plain twin "
            f"{v['plain_ms']:.4f} ms")
    kernels.reset_launch_counts()
    return results


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
    k4 = dict(err=err,
              ms=cuda_ms(lambda: tap_plan_fused(*args, **kw), 20),
              plain_ms=cuda_ms(lambda: tap_plan_reference(*args, **kw), 5))
    k5 = dict(err=err5,
              ms=cuda_ms(lambda: filter_taps_fused(texq, fidx, fw, **fkw),
                         20),
              plain_ms=cuda_ms(lambda: filter_taps_reference(
                  texq, fidx, fw, **fkw), 5))
    return k4, k5


def orbit_frames(r, np, torch, camera):
    """Warm-up frame, then N_FRAMES frames with the launch counts set to 0
    just before and read just after. Returns (last image, median ms,
    host wall ms/frame, counts)."""
    from awsm_renderer_tpu_torch.ops import kernels

    camera(0)
    r.render_device()            # warm-up (allocator, first-use paths)
    torch.cuda.synchronize()
    ev = []
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    for i in range(N_FRAMES):
        camera(i + 1)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        img = r.render_device()
        b.record()
        ev.append((a, b))
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / N_FRAMES
    counts = dict(kernels.launch_counts)
    frame_ms = [a.elapsed_time(b) for a, b in ev]
    med = statistics.median(frame_ms)
    log(f"  frame ms (CUDA events): median {med:.3f}, min "
        f"{min(frame_ms):.3f}, max {max(frame_ms):.3f}; host wall "
        f"{wall:.3f} ms/frame")
    log(f"  launch counts over {N_FRAMES} frames: {counts}")
    for name, n in counts.items():
        check(n >= N_FRAMES, f"{name} launched {n} >= {N_FRAMES} times")
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


def phase_frame(r, keys, np, torch):
    log(f"phase frame: Stress-1080p-ibl-tex, {N_FRAMES} frames at {W}x{H} "
        f"under an orbit")
    img, med, wall, counts = orbit_frames(
        r, np, torch, lambda i: orbit_camera(r, np, i))
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
    img, med, wall, counts = orbit_frames(r, np, torch, camera)
    check_image(img, np, torch)
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

    def hold(name, img):
        golden = np.asarray(Image.open(os.path.join(
            REPO, "tests", "goldens", f"{name}.png"))).astype(np.int16)
        check(golden.shape == img.shape, f"{name}: shape {img.shape}")
        frac = float((np.abs(golden - img.astype(np.int16)) > 4).mean())
        check(frac < 0.005, f"{name}: {frac:.4%} of channel values off "
                            f"by > 4/255 (limit 0.5%)")

    log("phase golden: 128x64 probes and 256x128 glTF goldens on the card")
    for name, fn in (("box", scene_box), ("env-ibl", scene_env_ibl),
                     ("box-textured", scene_box_textured)):
        r = P.AwsmRendererTorch(P.RendererConfig(width=128, height=64),
                                device=DEVICE)
        eye = fn(r)
        r.update_all(0.35, m3.look_at(eye, [0, 0, 0], [0, 1, 0]),
                     m3.perspective(np.pi / 3, 2.0, 0.05, 500.0))
        hold(name, r.render_u8())

    from awsm_renderer_tpu_torch.gltf.samples import SAMPLES

    out_dir = os.path.join(REPO, "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    for name in ("glb-helmet", "glb-texture-transform", "glb-multi-uv",
                 "glb-ext-clearcoat"):
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
    r, keys = build_stress_scene(P, np, DEVICE)
    orbit_camera(r, np, 0)
    n_tris = int((r.meshes.tri_mesh >= 0).sum())
    log(f"phase scene: Stress-1080p-ibl-tex, {len(keys)} meshes, {n_tris} "
        f"triangles, {r.lights.count} lights, 3 base-colour textures, built "
        f"in {time.perf_counter() - t0:.1f} s")

    results = phase_kernels(r, np, torch)
    med, wall, counts = phase_frame(r, keys, np, torch)
    del r
    h_med, h_wall, _h_counts, (h_k4, h_k5) = phase_gltf(P, np, torch)
    phase_golden(P, np, torch)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else \
        "nvidia-smi unavailable"
    log(f"frame Stress-1080p-ibl-tex: median {med:.3f} ms/frame (CUDA "
        f"events), host wall {wall:.3f} ms/frame, at {W}x{H} ({card})")
    log(f"frame glb-helmet: median {h_med:.3f} ms/frame (CUDA events), host "
        f"wall {h_wall:.3f} ms/frame, at {W}x{H} ({card})")
    log(f"helmet batch: K4 {h_k4['ms']:.4f} ms (twin {h_k4['plain_ms']:.4f}"
        f"), K5 {h_k5['ms']:.4f} ms (twin {h_k5['plain_ms']:.4f}) ({card})")
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
    }
    out = []
    for k, (name, src, rep) in sources.items():
        res = results[k]
        out.append({"name": name, "route": "cuda", "source": src,
                    "replaces": rep, "launches": counts[name],
                    "max_abs_err": res["err"], "ms": res["ms"],
                    "plain_ms": res["plain_ms"]})
    print(json.dumps({"kernels": out}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
