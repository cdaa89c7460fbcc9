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
           HUD box's centre returning its key. K7 and K8 are timed three
           ways (kernel_ms, the wrapper's host_us, device_ms: a CUDA graph
           of 50 calls), beside their registers, CTAs an SM and waves, the
           tests their warps' cull leaves and two bounds (the listed
           tests; the tests inside the triangles' bboxes);
  aa       bench.py's headline frame "Stress-1080p-msaa-bloom-dof": the
           stress scene, panes included, with MSAA-4x, bloom and depth of
           field (focus 16 m, f/1); K9 against its twin bit for bit on the
           first frame's own setup rows and bins, timed, with the bins'
           shape (groups a tile, big groups, empty and split tiles,
           slices), the tiles the reference's caps would clip and two
           bounds (the reference's walk; the tests inside the triangles'
           bboxes); K2's coord_scale=2 and explicit-px/py entries against
           the twin; 12 orbit frames with K9 (and K8 for the panes)
           launched on each, the image, pick() against the sample plane,
           host syncs; then 3 supersample frames (peak device memory) and
           one SMAA frame of the stress scene;
  animated bench.py's animated probe "Stress-1080p-animated-msaa-bloom-dof"
           (build_stress_scene(animated=True), bench.py:180-201 and
           add_animation): the headline frame plus six morph-target
           spheres, rotation players on every tenth grid node and one
           2-joint skinned pillar. First the checks: the animated
           subset's setup rows of the split vertex stage against the
           whole pool's morph/skin stage (integer columns bit-equal,
           floats within tests/test_torch_animated.py's tolerance), K9,
           K2's MSAA entries, K3, K4, K5, K6 and K8 against their twins on
           this frame's own intermediates, the image finite and moving
           with time; then 12 static frames and 12 with update_all(1/60)
           before each (median ms by CUDA events, host wall ms, launches
           of every kernel of the path on each frame), the host syncs of
           an animated frame (no more than the MSAA orbit's) and the
           subset's triangle count;
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
  lights   bench.py's 64-light probe "Stress-1080p-64-lights"
           (_lights_probe, bench.py:482-518): the stress scene's 7 lights
           plus 57 point lights on rings of radius 3-11 (rng seed 9,
           intensity 4, range 4), tiled light lists by the renderer's
           rule. K1-K6 and K8 against their twins on its intermediates;
           each shade's list lengths, the units more than 16 lights reach
           (overflow) and cull_lights(tile_h=1, tile_w=128) on the frame's
           depth plane; the tiled image against the dense loop's (within
           1e-4 off the overflowing units, whose error is printed); 12
           orbit frames tiled and 12 dense (ms/frame, host wall, kernels
           a frame under torch.profiler), host syncs no more than the
           stress frame's;
  hooks    the stress frame with a full RenderHooks set: pre_render /
           post_render counters, an identity first_pass, a
           before_transparent drawing a 200-triangle world-space grid
           through extra_geometry_pass with the depth test, a last_pass
           stamping a pixel. Each hook fires once, the image differs from
           the hookless frame only under the grid and the stamp, pick()
           after a camera move replays the in-frame hooks without the host
           ones; ms/frame with and without hooks, the extra pass's ms a
           triangle;
  tools    the facade's tool members and the tools on the stress scene at
           1080p: warmup([bloom], [msaa]) (3 frames, the config restored,
           also when a variant raises ConfigError) and the first bloom
           frame cold (a fresh renderer) against after warmup; an
           InteractiveSession(editor=True, grid=True) driven by scripted
           events: a pointer-down on a colonnade pixel (found from the
           tri_id plane) selects its mesh and attaches the gizmo, a drag
           on a translate handle (found the same way) moves the target
           along that axis only, an empty-sky drag orbits, a wheel zooms,
           "set" turns bloom on, then MSAA (K9 launches), then the grid, a
           resize to 1280x720 and back; every image finite and of its
           shape; 12 pointer-free steps on a moving camera with timings
           off, on, on and off (ms/step by CUDA events and host wall,
           launches a step; then the host syncs of two more by source
           line, no more than the stress frame's; the same syncs and
           launches both ways), kernels a step under torch.profiler,
           the spans' host and device ms; the host
           syncs of a pointer-down step; the host time a frame gains
           (_log_retrace, a span with timings off); check_compatibility
           beside the step's peak allocated memory; export_image read
           back with PIL equal to the tensor's u8, export_depth;
           save_scene + load_scene(device="cuda") rendering bit-equal;
           two add_atlas_image entries as distinct quads;
           generate_brdf_lut(256, 512) timed and held against the CPU's;
  gltf     build the glTF catalog's helmet (five 1024x1024 maps) with the
           port's gltf/samples.py, load_gltf + populate_gltf it at 1080p
           under the same environment, render 12 orbit frames and check
           launches and the image;
  golden   render the 128x64 "box", "env-ibl", "box-textured",
           "alpha-blend", "morph-cube", "rigged-simple", "instanced",
           "effect-refraction", "effect-bloom",
           "effect-dof", "effect-smaa" and "effect-msaa" probes, the
           1024x512 "parity-production-msaa-1024", the 256x128 glTF
           goldens "glb-helmet", "glb-texture-transform", "glb-multi-uv",
           "glb-ext-clearcoat", "glb-alpha-modes", "glb-ext-transmission"
           "glb-sponza-lite", "glb-fox", "glb-instanced",
           "glb-many-influences", "glb-morph-stress", "glb-morphed",
           "glb-recursive-skeletons", "glb-skinned" and "glb-two-skins",
           and the nine 512x256 parity goldens
           "parity-glb-helmet-512", "parity-glb-alpha-modes-512" and
           "parity-ext-{anisotropy,clearcoat,iridescence,sheen,specular,
           transmission,unlit}-512" on the card (37 goldens), each at the
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


def kernel_ms(fn, n: int = 50) -> float:
    """Device ms of one `fn()`: one pair of CUDA events around `n`
    back-to-back calls (after two warm-up calls), elapsed / n. While the
    host enqueues faster than the card runs, the wrapper's host cost
    (allocation, the ctypes call) hides behind the launches before it;
    events around a single call count it (cuda_ms)."""
    import torch

    fn()
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def host_us(fn, n: int = 200) -> float:
    """Host microseconds of one `fn()` (mean of `n` calls on the host's
    clock, after a warm-up): what a launch costs before the card sees it.
    Where it exceeds the kernel's time, kernel_ms reads host time."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return t


def device_ms(fn, n: int = 50) -> float:
    """Device-only ms of one `fn()`: `n` calls captured in one CUDA graph,
    replayed (after a warm-up replay) between one pair of CUDA events,
    elapsed / n. A replay does no host work a call, so the wrapper's host
    cost cannot show; what remains besides the kernels is the graph's gap
    between two of its launches."""
    import torch

    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(n):
            fn()
    g.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    g.replay()
    b.record()
    b.synchronize()
    del g
    return a.elapsed_time(b) / n


def cuda_ms(fn, reps: int) -> float:
    """Median ms of `fn()` over `reps` runs (after one warm-up), timed
    with CUDA events around each call (the plain twins, which take up to
    seconds; a kernel's time is kernel_ms)."""
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
                       temporal=False, animated=False):
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
    ring; animated=True adds bench.py's animated probe content
    (add_stress_animation). Returns (renderer, opaque mesh keys, HUD key
    or None)."""
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
    keys, grid_tks = [], []
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
            grid_tks.append(tk)
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
    if animated:
        add_stress_animation(P, np, r, mats, grid_tks)
    r.environment.set_environment_from_equirect(env_ibl_equirect(np),
                                                size=128)
    return r, keys, hud_key


def add_stress_animation(P, np, r, mats, grid_tks):
    """bench.py build_stress_scene(animated=True) through the port's API
    (bench.py:180-201 and add_animation, :27-92): six morph spheres
    (uv_sphere(0.4, 12, 24), a bulge and a squash target) on a ring of
    radius 2.5 with weight players, rotation players (a full turn about y
    over 4 s) on every tenth grid node (grid_tks[::10][:24]), and one
    2-joint skinned box pillar whose top joint sways about z."""
    from awsm_renderer_tpu_torch.core.animation import (
        AnimationChannel, AnimationClip, AnimationPlayer, AnimationSampler,
        TargetPath,
    )
    from awsm_renderer_tpu_torch.geometry import box, uv_sphere

    F = np.float32
    morph_keys = []
    for i in range(6):
        g = uv_sphere(0.4, rings=12, sectors=24)
        V = g.positions.shape[0]
        bulge = (g.positions * 0.35).reshape(1, V, 3)
        squash = np.zeros((1, V, 3), F)
        squash[0, :, 1] = -0.6 * g.positions[:, 1]
        geo = P.MeshGeometry(
            positions=g.positions, indices=g.indices, normals=g.normals,
            uv0=g.uv0,
            morph_positions=np.concatenate([bulge, squash]).astype(F),
            morph_normals=np.zeros((2, V, 3), F))
        a = 2 * np.pi * i / 6
        morph_keys.append(r.add_mesh(geo, mats[i % 12], P.Transform(
            translation=np.array([np.cos(a) * 2.5, 2.2, np.sin(a) * 2.5],
                                 F))))
    times = np.array([0.0, 1.0, 2.0, 3.0, 4.0], F)
    quats = np.array([[0, np.sin(a / 2), 0, np.cos(a / 2)]
                      for a in np.linspace(0, 2 * np.pi, 5)], F)
    for tk in grid_tks[::10][:24]:
        r.animations.insert(AnimationPlayer(clip=AnimationClip(channels=[
            AnimationChannel(sampler=AnimationSampler(times=times,
                                                      values=quats),
                             path=TargetPath.ROTATION, transform_key=tk)]),
            speed=1.0))
    wvals = np.array([[0.0, 1.0], [1.0, 0.0], [0.0, 1.0]], F)
    for mk in morph_keys:
        r.animations.insert(AnimationPlayer(clip=AnimationClip(channels=[
            AnimationChannel(sampler=AnimationSampler(
                times=np.array([0.0, 1.0, 2.0], F), values=wvals),
                path=TargetPath.WEIGHTS, mesh_key=mk)]), speed=1.3))
    g = box(0.5)
    V = g.positions.shape[0]
    joints = np.zeros((V, 4), F)
    joints[:, 0] = (g.positions[:, 1] > 0).astype(F)   # joint 1 on top
    weights = np.zeros((V, 4), F)
    weights[:, 0] = 1.0
    root = r.transforms.insert(P.Transform(
        translation=np.array([0.0, 2.5, 0.0], F)))
    j1 = r.transforms.insert(P.Transform(), parent=root)
    r.transforms.update_world()
    skin = r.skins.insert([root, j1], np.tile(np.eye(4, dtype=F), (2, 1, 1)))
    mat = r.materials.insert(P.PbrMaterial(
        base_color_factor=np.array([0.9, 0.8, 0.2, 1.0], F)))
    r.add_mesh(P.MeshGeometry(positions=g.positions, indices=g.indices,
                              normals=g.normals, uv0=g.uv0, joints=joints,
                              weights=weights),
               mat, transform_key=root, skin_key=skin)
    sway = np.array([[0, 0, np.sin(a / 2), np.cos(a / 2)]
                     for a in (np.pi / 6) * np.sin(
                         np.linspace(0, 2 * np.pi, 5))], F)
    r.animations.insert(AnimationPlayer(clip=AnimationClip(channels=[
        AnimationChannel(sampler=AnimationSampler(times=times, values=sway),
                         path=TargetPath.ROTATION, transform_key=j1)])))
    r.meshes.update_world(r.transforms)


def orbit_camera(r, np, i: int, rad=None, height=7.0):
    from awsm_renderer_tpu_torch.utils import math3d as m3

    a = np.pi / 4 + 0.05 * i
    rad = float(np.hypot(10.0, 10.0)) if rad is None else rad
    view = m3.look_at([np.cos(a) * rad, height, np.sin(a) * rad], [0, 0, 0],
                      [0, 1, 0])
    r.camera.update(view, m3.perspective(np.pi / 3, W / H, 0.1, 200.0))


KERNEL_SITES = ("vertex_stage", "rasterize16_slim", "resolve_planes_fused",
                "onehot_split_rows", "tap_plan_fused", "filter_taps_fused",
                "shade_surface_fused")
# the op-by-op shade chain's sites instead of K14's (a frame outside
# K14's scope: tiled lights, a debug view, an extension)
CHAIN_SITES = KERNEL_SITES[:-1] + ("gather_split_channels",)


def kernel_sites():
    """{wrapper name: the modules whose global the main path calls it
    through}."""
    from awsm_renderer_tpu_torch.ops import (
        cubemap, raster, relayout, shade, temporal, texsample,
    )
    from awsm_renderer_tpu_torch.passes import frame

    return {"rasterize16_slim": (raster, frame),
            "resolve_planes_fused": (shade, frame),
            "onehot_split_rows": (shade,), "tap_plan_fused": (texsample,),
            "filter_taps_fused": (texsample,),
            "gather_split_channels": (cubemap, shade),
            "shade_surface_fused": (shade,),
            "vertex_stage": (frame,),
            "rasterize_binned": (raster,),
            "_rasterize_binned_compact": (raster,),
            "gather_split_channels_f32": (relayout,),
            "rasterize16_msaa": (frame,),
            "reproject_history_planes": (temporal,)}


def capture_first_frame(r, names=KERNEL_SITES, calls=None,
                        debug_mode="none"):
    """Render one frame (in debug_mode) with recorders on the kernel
    wrappers `names`; return the arguments of each wrapper's first call
    on the main path (for rasterize_binned, of its first peel call under
    "rasterize_binned/peel" and of its first call without a peel under
    "rasterize_binned/nopeel"). A dict `calls` collects every call's
    arguments, in order, under the same keys."""
    captured = {}
    where = kernel_sites()
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
        r.render_device(debug_mode)
    finally:
        for (mod, attr), fn in zip(sites, originals):
            setattr(mod, attr, fn)
    return captured


def bit_mismatches(a, b, torch) -> int:
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return int((a != b).sum())


def k1_big_touch(bins, n_tx: int, torch):
    """(n_tiles, n_big) bool: big group i's tile box holds tile t."""
    _e, _o, counts, _z, big_packed, _ids, n_big, _c = bins
    t = torch.arange(counts.numel(), device=counts.device)
    tx, ty = t % n_tx, torch.div(t, n_tx, rounding_mode="floor")
    bb = big_packed[:int(n_big.item())].long()
    return (((bb & 255)[None] <= tx[:, None])
            & (tx[:, None] <= ((bb >> 16) & 255)[None])
            & (((bb >> 8) & 255)[None] <= ty[:, None])
            & (ty[:, None] <= ((bb >> 24) & 255)[None]))


def walk_pairs(bins, n_tx: int, torch, packed: bool = False):
    """The walks on `bins`: each tile's walk length (binned entries + big
    groups whose box holds it), and the walk's (tile, group, quadrant
    gate) pairs. packed: K9's entries (g << 8) | gates; a big group, and
    every K1 entry, gates no quadrant out (0xFF)."""
    entries, offsets, counts, _z, _bp, big_ids, _nb, _c = bins
    dev = counts.device
    touch = k1_big_touch(bins, n_tx, torch)
    walk = counts.long() + touch.sum(dim=1)
    cl = counts.long()
    tile = torch.repeat_interleave(torch.arange(cl.numel(), device=dev), cl)
    first = torch.cumsum(cl, 0) - cl
    e = entries.long()[offsets.long()[tile]
                       + torch.arange(tile.numel(), device=dev)
                       - first[tile]]
    bt, bi = touch.nonzero(as_tuple=True)
    tile = torch.cat([tile, bt])
    grp = torch.cat([e >> 8 if packed else e, big_ids.long()[bi]])
    gate = torch.cat([e & 0xFF if packed else torch.full_like(e, 0xFF),
                      torch.full_like(bi, 0xFF)])
    return walk, tile, grp, gate


def walk_bytes(srows, bins, grp, torch) -> int:
    """What a walk must read: floats 0..11 (three edges, the z plane) of
    every row its pairs reach and the bins, each once."""
    counts, n_big = bins[2], int(bins[6].item())
    return (torch.unique(grp).numel() * 16 * 12 * 4
            + 4 * (int(counts.sum()) + 2 * counts.numel() + 2 * n_big + 1))


def _centres(lo, hi, o, n: int, scale: int):
    """Pixels k in [0, n) from pixel o with a (sample) centre in [lo, hi]:
    pixel x holds the centres scale * x + s + 0.5, s < scale (scale 1:
    pixel centres; 2: K9's samples in supersampled pixels)."""
    import torch

    m0 = torch.maximum(torch.ceil(lo - 0.5), scale * o)
    m1 = torch.minimum(torch.floor(hi - 0.5), scale * (o + n) - 1)
    c = torch.floor(m1 / scale) - torch.floor(m0 / scale) + 1
    return torch.where(m1 >= m0, c, torch.zeros_like(c))


def k1_walk(srows, bins, n_tx: int, torch):
    """K1's work on these bins: each tile's walk length, the (tile,
    group) pairs of those walks, the coverage tests they need (pixel
    centres of the tile inside each of the group's 16 triangle bboxes),
    and the bytes K1 must read (walk_bytes)."""
    walk, tile, grp, _gate = walk_pairs(bins, n_tx, torch)
    bb = srows[:, 15:19].reshape(-1, 16, 4)[grp]          # (pairs, 16, 4)
    X = ((tile % n_tx) * 32).float()[:, None]
    Y = (torch.div(tile, n_tx, rounding_mode="floor") * 32).float()[:, None]
    n = (_centres(bb[..., 0], bb[..., 2], X, 32, 1)
         * _centres(bb[..., 1], bb[..., 3], Y, 32, 1))
    return (walk, int(tile.numel()), int(n.double().sum()),
            walk_bytes(srows, bins, grp, torch))


# raster_msaa.cu: warp w owns the 16 x K9_BLOCK_ROWS display block (w % 2,
# w / 2) of a tile
K9_BLOCK_ROWS = 2


def k9_walk(srows, bins, n_tx: int, torch):
    """K9's work on its bins: each tile's walk length, the (tile, group)
    pairs, the (display pixel, triangle) tests of the reference's walk
    (each pair's 16 triangles against the 256 display pixels of each
    quadrant its gate names), those the kernel's warps make (the pixels
    of each warp block of those quadrants that a triangle's bbox, widened
    by one supersampled pixel, reaches: raster_msaa.cu's cull), those
    inside the triangles' bboxes (pixels of those quadrants one of whose
    sample centres lies in the supersampled bbox), and the bytes K9 must
    read (walk_bytes)."""
    walk, tile, grp, gate = walk_pairs(bins, n_tx, torch, packed=True)
    bb = srows[:, 15:19].reshape(-1, 16, 4)[grp]          # (pairs, 16, 4)
    n = torch.zeros(bb.shape[:2], dtype=torch.float64, device=bb.device)
    n_warp = torch.zeros_like(n)
    n_walk = 0
    rows = K9_BLOCK_ROWS
    for q in range(4):
        X = ((tile % n_tx) * 32 + 16 * (q & 1)).float()[:, None]
        Y = (torch.div(tile, n_tx, rounding_mode="floor") * 32
             + 16 * (q >> 1)).float()[:, None]
        on = (((gate >> q) & 0x11) != 0)[:, None]
        n_walk += int(on.sum()) * 16 * 256
        n += torch.where(on, _centres(bb[..., 0], bb[..., 2], X, 16, 2)
                         * _centres(bb[..., 1], bb[..., 3], Y, 16, 2),
                         0.0).double()
        # the quadrant's blocks r = 0 .. 16 / rows - 1, sample centres
        # 2 X + [0.5, 31.5] and 2 (Y + rows r) + [0.5, 2 rows - 0.5]
        x_ok = ((bb[..., 0] - 1 <= 2 * X + 31.5)
                & (bb[..., 2] + 1 >= 2 * X + 0.5))
        r0 = torch.ceil((bb[..., 1] - 1 - 2 * Y - 2 * rows + 0.5)
                        / (2 * rows)).clamp(0, 16 // rows)
        r1 = torch.floor((bb[..., 3] + 1 - 2 * Y - 0.5)
                         / (2 * rows)).clamp(-1, 16 // rows - 1)
        blocks = (r1 + 1 - r0).clamp(min=0)
        n_warp += torch.where(on & x_ok, blocks * 16 * rows, 0.0).double()
    return (walk, int(tile.numel()), n_walk, int(n_warp.sum()),
            int(n.sum()), walk_bytes(srows, bins, grp, torch))


def bins_log(label, bins, walk, slice_groups: int, torch):
    """Print the shape of a sliced walk's work: tiles, groups a tile, big
    groups, walk lengths, empty and split tiles, slices."""
    counts, n_big = bins[2].float(), int(bins[6].item())
    q = torch.quantile(counts, torch.tensor([0.25, 0.5, 0.75],
                                            device=counts.device))
    wq = torch.quantile(walk.float(), torch.tensor([0.5, 0.99],
                                                   device=walk.device))
    slices = int(((walk + slice_groups - 1) // slice_groups).sum())
    log(f"  {label} bins: {counts.numel()} tiles, groups a tile quartiles "
        f"{q[0]:.0f} / {q[1]:.0f} / {q[2]:.0f}, max {int(counts.max())}, "
        f"{int(counts.sum())} binned pairs, {n_big} big groups in "
        f"{int(walk.sum() - counts.sum())} (tile, big group) pairs; walk a "
        f"tile median {wq[0]:.0f}, 99th percentile {wq[1]:.0f}, max "
        f"{int(walk.max())}, empty tiles {int((walk == 0).sum())}, split "
        f"tiles {int((walk > slice_groups).sum())}, {slices} slices of at "
        f"most {slice_groups} groups; clipped tiles {int(bins[7].item())}")


def phase_kernels(r, np, torch):
    """First-frame intermediates -> each kernel vs its twin, timed.
    Returns (results, the first call's arguments per wrapper, the
    arguments of every K8 peel)."""
    from awsm_renderer_tpu_torch.ops import kernels
    from awsm_renderer_tpu_torch.ops.raster import (
        K1_SLICE, build_bins16, rasterize16_slim, rasterize16_slim_reference,
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
    # K6 serves the op-by-op chain only: an "ibl" view frame runs it
    cap.update(capture_first_frame(r, ("gather_split_channels",),
                                   debug_mode="ibl"))
    check("gather_split_channels" in cap,
          "an ibl-view frame (the chain) calls K6")
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
    n_bad = bit_mismatches(col, ccol, torch) + bit_mismatches(depth, cdep,
                                                              torch)
    err = float((depth - cdep).abs().max())
    log(f"  K1 rasterize16_slim col {tuple(col.shape)} int32 + depth "
        f"{tuple(depth.shape)} f32: {n_bad} mismatching values, max "
        f"|ddepth| {err}")
    check(n_bad == 0, "K1 col and depth bit-equal to the plain twin")
    check(int((col >= 0).sum()) > 0, "K1 covers pixels")
    n_tx = -(-rw // 32)
    walk, n_pairs_bbox, n_tests_bbox, in_bytes = k1_walk(srows, bins, n_tx,
                                                         torch)
    bins_log("K1", bins, walk, K1_SLICE, torch)
    # the function's tests: every binned (tile, group) pair, big groups
    # against every tile (the reference's walk); the tests these inputs
    # need: pixel centres inside each triangle's bbox over the binned and
    # the big (tile, group) pairs
    n_tiles = counts.numel()
    tests = ((int(counts.sum()) + int(bins[6].item()) * n_tiles) * 16
             * 32 * 32)
    k1_bytes = in_bytes + nbytes(col, depth)
    walk_bound = bound(k1_bytes, tests * OPS_PER_TEST)
    bbox_bound = bound(k1_bytes, n_tests_bbox * OPS_PER_TEST)

    def k1_run(b):
        return rasterize16_slim(srows, b, width=rw, height=rh)

    results["K1"] = dict(
        err=err, ms=kernel_ms(lambda: k1_run(bins)),
        plain_ms=cuda_ms(lambda: rasterize16_slim_reference(
            srows, bins, width=rw, height=rh), 2),
        bound=min(walk_bound, bbox_bound), library_ms=None)
    # the heaviest-tile test: the same bins, every tile cut to at most 16
    # binned entries (the big groups stay)
    cut = (bins[0], bins[1], counts.clamp(max=16), *bins[3:])
    walk_cut = walk - counts.long() + counts.long().clamp(max=16)
    ms, ms_call = results["K1"]["ms"], cuda_ms(lambda: k1_run(bins), 20)
    ms_cut = kernel_ms(lambda: k1_run(cut))
    log(f"  K1: {ms:.4f} ms ({ms_call:.4f} ms with events around each call)"
        f"; bound {walk_bound[0]:.4f} ms ({walk_bound[1]}) over the "
        f"reference's walk, {bbox_bound[0]:.4f} ms ({bbox_bound[1]}) over "
        f"the {n_tests_bbox} tests inside the triangles' bboxes "
        f"({n_pairs_bbox} (tile, group) pairs), both over the {k1_bytes} "
        f"bytes K1 must move; share of the smaller "
        f"{100 * min(walk_bound, bbox_bound)[0] / ms:.1f}%")
    log(f"  K1 on the bins cut to <= 16 entries a tile: {ms_cut:.4f} ms; if "
        f"time followed the heaviest tile: "
        f"{ms * int(walk_cut.max()) / int(walk.max()):.4f} ms (max walk "
        f"{int(walk.max())} -> {int(walk_cut.max())}); if it followed the "
        f"sum of work: {ms * int(walk_cut.sum()) / int(walk.sum()):.4f} ms "
        f"(walks {int(walk.sum())} -> {int(walk_cut.sum())})")

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
        ms=kernel_ms(lambda: resolve_planes_fused(tid, srows2, **kw)),
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
        ms=kernel_ms(lambda: onehot_split_rows(mat_row, table)),
        plain_ms=cuda_ms(lambda: onehot_split_rows_reference(mat_row,
                                                             table), 20),
        bound=bound(nbytes(mat_row, table, a), 0.0),
        library_ms=kernel_ms(lambda: torch.index_select(table_t, 1, safe)))

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
        ms=kernel_ms(lambda: gather_split_channels(texels, idx, ncols)),
        plain_ms=cuda_ms(lambda: gather_split_channels_reference(
            texels, idx, ncols), 20),
        bound=bound(n_rows * ncols * 2 + nbytes(idx, a), 0.0),
        library_ms=kernel_ms(lambda: torch.index_select(cols_t, 1, safe)))
    results["K4"], results["K5"] = check_k4_k5(cap, "stress", torch)
    k14 = calls["shade_surface_fused"]
    check(len(k14) == 2, f"the frame called K14 twice (the opaque shade, "
                         f"the panes' shade): {len(k14)}")
    results["K14"] = check_k14(k14[0], "stress opaque", torch)
    results["K14_panes"] = check_k14(k14[1], "stress panes", torch)
    k15 = calls["vertex_stage"]
    check(len(k15) == 2, f"the frame called K15 twice (the opaque pass, the "
                         f"panes' compacted pass): {len(k15)}")
    results["K15"] = check_k15(k15[0], "stress opaque", torch)
    results["K15_panes"] = check_k15(k15[1], "stress panes", torch)
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
    mips = bool(fkw.get("mips"))
    cols, n_w = (52, 11) if mips else (16, 4)   # columns, weight planes
    n_rows = unique_rows(fidx, texq.shape[0])
    k4 = dict(err=err,
              ms=kernel_ms(lambda: tap_plan_fused(*args, **kw)),
              plain_ms=cuda_ms(lambda: tap_plan_reference(*args, **kw), 5),
              bound=bound(nbytes(*ins, idx, w), 0.0), library_ms=None)
    k5 = dict(err=err5,
              ms=kernel_ms(lambda: filter_taps_fused(texq, fidx, fw, **fkw)),
              plain_ms=cuda_ms(lambda: filter_taps_reference(
                  texq, fidx, fw, **fkw), 5),
              bound=bound(n_rows * cols * 2 + nbytes(fidx, fw[:n_w], a),
                          0.0),
              library_ms=None)
    for k, v in (("K4", k4), ("K5", k5)):
        log(f"  {k} [{label}]: {v['ms']:.4f} ms, bound {v['bound'][0]:.4f} "
            f"ms ({v['bound'][1]}), share {100 * v['bound'][0] / v['ms']:.1f}"
            f"%")
    return k4, k5


# channels of each slot K14 reads (ops/shade.py K14_SLOTS' order)
K14_CHANNELS = (4, 2, 3, 1, 3, 1, 3)
K14_ATOL = 1e-5          # and rtol: the card test's tolerance and reason


def k14_mismatches(got, ref, torch):
    """(values outside K14_ATOL, max |d|) over K14's outputs against the
    twin's, NaN equal to NaN."""
    pairs = list(zip(got[0], ref[0])) + [(got[1], ref[1])]
    if got[2] is not None:
        pairs += list(zip(got[2], ref[2]))
    n_bad, err = 0, 0.0
    for a, b in pairs:
        both_nan = torch.isnan(a) & torch.isnan(b)
        ok = torch.isclose(a, b, rtol=K14_ATOL, atol=K14_ATOL) | both_nan
        n_bad += int((~ok).sum())
        d = (a - b).abs()[~both_nan]
        err = max(err, float(d.max()) if d.numel() else 0.0)
    return n_bad, err


def k14_bytes(args, kw, env_idx, torch) -> int:
    """The least bytes a K14 call moves: each plane it reads once; each
    tapped channel it reads at the pixels whose material binds the slot;
    the distinct material rows and the lit light rows once; the distinct
    32-byte env rows its taps address (env_idx: the twin's gather, sky
    rows counted at misses only); rgb + alpha (and the transmission
    factor) out."""
    from awsm_renderer_tpu_torch.core import materials as M
    from awsm_renderer_tpu_torch.ops.shade import K14_SLOTS

    planes, ds, _taps = args
    P = planes["tri_id"].numel()
    mask = kw["slot_mask"]
    n_planes = 6 + 4 * bool(mask[M.TS_NORMAL]) + 4 * ("color_r" in planes) \
        + 2 * ("ndc_x" in planes)
    rows = planes["mat_row"].to(torch.int64).clamp(
        0, ds["mat_float"].shape[0] - 1)
    n = 4 * P * n_planes
    for s, ch in zip(K14_SLOTS, K14_CHANNELS):
        if mask[s]:
            n += 4 * ch * int((ds["mat_tex"][rows, s, 0] >= 0).sum())
    n += int(rows.unique().numel()) * 4 * (M.NUM_F32 + 2 + sum(mask))
    n += ds["n_lights"] * 4 * 16
    if env_idx is not None:
        parts = list(env_idx.reshape(-1, P))
        if kw["want_sky"]:
            parts[1] = parts[1][planes["tri_id"] < 0]
        n += 32 * int(torch.cat(parts).unique().numel())
    return n + P * 4 * (4 + 3 * kw["transparent_pass"])


def check_k14(call, label, torch, timed=True):
    """K14 against its twin, within K14_ATOL (absolute and relative);
    timed: kernel_ms, the twin's ms and the byte bound."""
    from awsm_renderer_tpu_torch.ops import shade as S

    args, kw = call
    got = S.shade_surface_fused(*args, **kw)
    seen = []
    real = S.gather_split_channels_reference

    def gather(texq, idx, ncols):
        seen.append(idx)
        return real(texq, idx, ncols)

    S.gather_split_channels_reference = gather
    try:
        ref = S.shade_surface_fused_reference(*args, **kw)
    finally:
        S.gather_split_channels_reference = real
    n_bad, err = k14_mismatches(got, ref, torch)
    P = args[0]["tri_id"].numel()
    log(f"  K14 shade_surface_fused [{label}] {P} pixels, slots "
        f"{[s for s, b in enumerate(kw['slot_mask']) if b]}, "
        f"{args[1]['n_lights']} lights, solid env {kw['solid_env']}, "
        f"transparent {kw['transparent_pass']}: {n_bad} values outside "
        f"{K14_ATOL} of the twin, max |d| {err}")
    check(n_bad == 0, f"K14 [{label}] within {K14_ATOL} of the twin")
    if not timed:
        return None
    res = dict(err=err,
               ms=kernel_ms(lambda: S.shade_surface_fused(*args, **kw)),
               plain_ms=cuda_ms(lambda: S.shade_surface_fused_reference(
                   *args, **kw), 2),
               bound=bound(k14_bytes(args, kw, seen[0] if seen else None,
                                     torch), 0.0),
               library_ms=None)
    log(f"  K14 [{label}]: {res['ms']:.4f} ms, twin {res['plain_ms']:.4f} "
        f"ms, bound {res['bound'][0]:.4f} ms ({res['bound'][1]}), share "
        f"{100 * res['bound'][0] / res['ms']:.1f}%")
    return res


def k15_pair(args, kw):
    """K15 and its twin on one captured vertex_stage call; a call that
    writes into the pool's rows (the animated subset) gets a copy of them
    each."""
    from awsm_renderer_tpu_torch.ops import vertex as V

    out = kw.get("out")
    kws = [dict(kw, out=None if out is None else out.clone())
           for _ in range(2)]
    return (V.vertex_stage(*args, **kws[0]),
            V.vertex_stage_reference(*args, **kws[1]))


def k15_mismatches(got, ref, kw, torch):
    """(values of K15's rows that are not the twin's bit for bit, NaN for
    NaN, where no morph or skin sum is taken, else rows outside
    tests/test_torch_vertex_fused.py's tolerance; values not bit-equal)."""
    from awsm_renderer_tpu_torch.ops.vertex import (
        S_BB_MINX, S_MAT_ROW, S_ORIG_ID, S_TANGENT_W, S_ZA, S_ZC,
    )

    nan = torch.isnan(got) & torch.isnan(ref)
    n_bits = int((got.view(torch.int32) != ref.view(torch.int32))
                 .logical_and(~nan).sum()) + int((nan != torch.isnan(got))
                                                 .sum())
    if not (kw.get("has_morphs") or kw.get("skin_sets")):
        return n_bits, n_bits
    va, vb = got[:, S_BB_MINX] < 1e37, ref[:, S_BB_MINX] < 1e37
    ints = [S_MAT_ROW, S_TANGENT_W, S_ORIG_ID]
    n_bad = int((va != vb).sum()) + int(
        (got[:, ints] != ref[:, ints]).logical_and(~nan[:, ints]).sum())
    a, b = got[vb].double(), ref[vb].double()
    err = (a - b).abs() / b.abs().clamp(min=1.0)
    z = torch.zeros(got.shape[1], dtype=torch.bool, device=got.device)
    z[S_ZA:S_ZC + 1] = True
    area = (b[:, 2] + b[:, 5] + b[:, 8]).abs().clamp(max=1.0)
    n_bad += int((err[:, ~z] > 3e-5).any(dim=1).sum())
    n_bad += int((err[:, z].max(dim=1).values * area > 1e-4).sum())
    return n_bad, n_bits


def k15_bytes(args, kw, torch) -> tuple:
    """(The least bytes a K15 call moves, triangles, rows written): each
    computed triangle's mesh row and, with an index, its index entry;
    its three corners' 18 floats (and morph base, joint and weight
    entries when animated); the distinct morph delta rows (9 floats) its
    live targets address; its rows (and a padding tail) out."""
    from awsm_renderer_tpu_torch.core.meshes import (
        MI_MORPH_STRIDE, MI_N_MORPH_TARGETS,
    )
    from awsm_renderer_tpu_torch.ops.vertex import NSETUP

    (c_pos, *_pools, c_joints, _w, c_morph_base, morph_deltas, tri_mesh,
     mesh_info) = args[:12]
    index = args[18] if len(args) > 18 else kw.get("index")
    out, clip = kw.get("out"), kw.get("needs_clip", True)
    T = c_pos.shape[1]
    n = T if index is None else (kw["n_index"] if out is not None
                                 else index.shape[0])
    per_corner = 18 * 4
    if kw.get("has_morphs"):
        per_corner += 4
    if kw.get("skin_sets"):
        per_corner += 8 * 4 * kw["skin_sets"]
    b = n * (4 + 3 * per_corner + (4 if index is not None else 0))
    if kw.get("has_morphs"):
        cols = (torch.arange(T, device=c_pos.device) if index is None
                else index[:n].clamp(min=0).long())
        mesh = tri_mesh[cols].clamp(0, mesh_info.shape[0] - 1).long()
        n_t = mesh_info[mesh, MI_N_MORPH_TARGETS].long()
        base = c_morph_base[:, cols].long()
        stride = mesh_info[mesh, MI_MORPH_STRIDE].long()
        rows = [(base + m * stride)[(base >= 0) & (m < n_t)]
                for m in range(int(n_t.max()) if n else 0)]
        if rows:
            b += 36 * unique_rows(torch.cat(rows), morph_deltas.shape[0])
    n_rows = (2 * n if clip else n)
    if out is None:
        n_rows = -(-n_rows // kw.get("pad_to", 1)) * kw.get("pad_to", 1)
    return b + n_rows * NSETUP * 4, n, n_rows


def check_k15(call, label, torch, timed=True):
    """K15 against its twin: bit-equal where no morph or skin sum is taken,
    else within the CPU test's tolerance (its bit mismatches logged);
    timed: kernel_ms, the twin's ms and the byte bound."""
    from awsm_renderer_tpu_torch.ops import vertex as V

    args, kw = call
    got, ref = k15_pair(args, kw)
    n_bad, n_bits = k15_mismatches(got, ref, kw, torch)
    anim = bool(kw.get("has_morphs") or kw.get("skin_sets"))
    index = args[18] if len(args) > 18 else None
    log(f"  K15 vertex_stage [{label}] {tuple(got.shape)} rows, index "
        f"{'none' if index is None else tuple(index.shape)}, clip "
        f"{kw.get('needs_clip')}, morphs {bool(kw.get('has_morphs'))},"
        f" skin sets {kw.get('skin_sets', 0)}: {n_bits} values not "
        f"bit-equal to the twin" + (f", {n_bad} rows outside the tolerance"
                                   if anim else ""))
    check(n_bad == 0, f"K15 [{label}] " + ("within the stated tolerance of"
                                           if anim else "bit-equal to")
          + " the twin")
    if not timed:
        return None
    nb, n_tri, n_rows = k15_bytes(args, kw, torch)
    res = dict(err=float(n_bits),
               ms=kernel_ms(lambda: V.vertex_stage(*args, **kw)),
               plain_ms=cuda_ms(lambda: V.vertex_stage_reference(
                   *args, **kw), 2),
               bound=bound(nb, 0.0), library_ms=None, tris=n_tri,
               rows=n_rows)
    log(f"  K15 [{label}]: {res['ms']:.4f} ms, twin {res['plain_ms']:.4f} "
        f"ms, bound {res['bound'][0]:.4f} ms ({res['bound'][1]}), share "
        f"{100 * res['bound'][0] / res['ms']:.1f}%")
    return res


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


OPAQUE_PATH = ("vertex_stage", "rasterize16_slim", "resolve_planes_fused",
               "onehot_split_rows", "tap_plan_fused", "filter_taps_fused",
               "shade_surface_fused")
# a frame outside K14's scope (the tiled light loop): the chain's K3 and K6
CHAIN_PATH = OPAQUE_PATH[:-1] + ("gather_split_channels",)


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


def binned_info(kernels) -> dict:
    """K7/K8's compiled kernel (csrc/binned.cu awsm_binned_info):
    registers a thread, local (spill) bytes a thread, CTAs resident an
    SM, threads a CTA and the rows of a warp's 16-pixel-wide cull block
    (0: no per-warp cull)."""
    import ctypes

    out = (ctypes.c_int * 5)()
    rc = kernels.lib().awsm_binned_info(ctypes.addressof(out), None)
    if rc != 0:
        raise RuntimeError(f"awsm_binned_info failed: cudaError_t {rc}")
    return dict(zip(("regs", "local_bytes", "ctas_per_sm", "threads",
                     "block_rows"), out))


def binned_work(rows, bins, tiles, n_tx: int, n_px: int, planes, zb, torch,
                block_rows: int = 0):
    """K7/K8's work on these bins, over the (tile, chunk) pairs that the
    tiles `tiles` list: the bytes the function must move (the overlay
    setup, bins and peel bounds read once, the planes written once); the
    reference's tests (each listed chunk's 128 triangles against the
    tile's 1024 pixels); the tests binned.cu's warps make (the pixels of
    each 16 x block_rows warp block that a triangle's bbox, widened by one
    pixel, reaches; block_rows 0: no cull, every listed test); the tests
    inside the triangles' bboxes; and two bounds, over the listed tests
    and over the tests inside the bboxes, both with those bytes."""
    bin_idx, counts, B, zmin = bins
    tiles = tiles.long()
    cnt = counts.long().index_select(0, tiles)
    pair_tile = torch.repeat_interleave(tiles, cnt)
    first = torch.repeat_interleave(torch.cumsum(cnt, 0) - cnt, cnt)
    pos = torch.arange(pair_tile.numel(), device=tiles.device) - first
    chunk = bin_idx.long()[pair_tile * B + pos]
    bb = rows[:, 15:19].reshape(-1, 128, 4)[chunk]        # (pairs, 128, 4)
    X = ((pair_tile % n_tx) * 32).float()[:, None]
    Y = (torch.div(pair_tile, n_tx, rounding_mode="floor") * 32).float()[
        :, None]
    n_bbox = (_centres(bb[..., 0], bb[..., 2], X, 32, 1)
              * _centres(bb[..., 1], bb[..., 3], Y, 32, 1))
    listed = int(pair_tile.numel()) * 128 * 1024
    if block_rows:
        x0, x1 = bb[..., 0] - 1, bb[..., 2] + 1
        cols = sum(((x0 <= X + 16 * c + 15.5) & (x1 >= X + 16 * c + 0.5))
                   .double() for c in (0, 1))
        # block rows r = 0 .. 32 / block_rows - 1, pixel centres Y +
        # block_rows r + [0.5, block_rows - 0.5]
        r0 = torch.ceil((bb[..., 1] - 1 - Y - block_rows + 0.5)
                        / block_rows).clamp(0, 32 // block_rows)
        r1 = torch.floor((bb[..., 3] + 1 - Y - 0.5)
                         / block_rows).clamp(-1, 32 // block_rows - 1)
        cull = int((cols * (r1 + 1 - r0).clamp(min=0)).sum()) * 16 \
            * block_rows
    else:
        cull = listed
    n_bytes = (nbytes(rows, bin_idx, counts, zmin, *zb)
               + n_px * 4 * len(planes))
    n_in = int(n_bbox.double().sum())
    return dict(bytes=n_bytes, listed=listed, cull=cull, bbox=n_in,
                pairs=int(pair_tile.numel()),
                bound_listed=bound(n_bytes, listed * OPS_PER_TEST),
                bound_bbox=bound(n_bytes, n_in * OPS_PER_TEST))


def binned_times(label, fn, work, info, n_blocks: int, sms: int) -> dict:
    """K7/K8's row of one call: kernel_ms, host_us and device_ms of `fn`,
    the smaller of the two bounds, the registers, residency and waves,
    and the tests the warps' cull leaves (binned_log prints them)."""
    res = dict(ms=kernel_ms(fn), host_us=host_us(fn), device_ms=device_ms(fn),
               bound=min(work["bound_listed"], work["bound_bbox"]),
               library_ms=None, cull=work["cull"],
               waves=binned_log(label, work, info, n_blocks, sms), **info)
    log(f"  {label}: kernel_ms {res['ms']:.4f} ms (one event pair around 50 "
        f"calls), host_us {res['host_us']:.1f} µs a call, device_ms "
        f"{res['device_ms']:.4f} ms (50 calls in one CUDA graph)")
    return res


def binned_log(label, work, info, n_blocks: int, sms: int) -> int:
    """Print K7/K8's work, bounds, registers and waves on one call;
    returns the waves."""
    waves = -(-n_blocks // max(info["ctas_per_sm"] * sms, 1))
    bl, bb = work["bound_listed"], work["bound_bbox"]
    lo, hi = sorted((("the tests inside the bboxes", bb),
                     ("the listed tests", bl)), key=lambda v: v[1][0])
    log(f"  {label}: {work['pairs']} listed (tile, chunk) pairs; tests: "
        f"{work['listed']} listed, {work['cull']} left by the warps' cull, "
        f"{work['bbox']} inside the triangles' bboxes; bound {lo[1][0]:.4f}"
        f" ms ({lo[1][1]}) over {lo[0]}, {hi[1][0]:.4f} ms ({hi[1][1]}) "
        f"over {hi[0]}, {work['bytes']} bytes; {info['regs']} registers, "
        f"{info['local_bytes']} local bytes a thread, {info['threads']} "
        f"threads, {info['ctas_per_sm']} CTAs an SM: {n_blocks} tiles in "
        f"{waves} waves on {sms} SMs")
    return waves


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
    info = binned_info(kernels)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    results["K8"] = binned_times(
        "K8 (first peel)", lambda: _rasterize_binned_compact(
            rows, zlo_c, zhi_c, **kw),
        binned_work(rows, kw["bins"], kw["tile_idx"], kw["n_tx"], C * 1024,
                    names, (zlo_c, zhi_c), torch, info["block_rows"]),
        info, C, sms)
    results["K8"].update(err=err, plain_ms=cuda_ms(
        lambda: rasterize_binned_compact_reference(rows, zlo_c, zhi_c,
                                                   **ref_kw), 2))
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
    n_tx = -(-kw["width"] // BT_W)
    n_tiles = (-(-kw["height"] // BT_H)) * n_tx
    all_tiles = torch.arange(n_tiles, device=rows.device)
    results["K7"] = binned_times(
        "K7 (first peel)", lambda: rasterize_binned(rows, zlo, zhi, **kw),
        binned_work(rows, kw["bins"], all_tiles, n_tx, zlo.numel(), names,
                    (zlo, zhi), torch, info["block_rows"]),
        info, n_tiles, sms)
    results["K7"].update(err=err, plain_ms=cuda_ms(
        lambda: rasterize_binned_reference(rows, zlo, zhi, **ref_kw), 2))

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
    results["K7_nopeel"] = binned_times(
        "K7 (the HUD, no peel)", lambda: rasterize_binned(h_rows, **hkw),
        binned_work(h_rows, h_bins, all_tiles, n_tx, hkw["width"]
                    * hkw["height"], h_names, (), torch, info["block_rows"]),
        info, n_tiles, sms)

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
        ms=kernel_ms(lambda: gather_split_channels_f32(table, idx, ncols)),
        plain_ms=cuda_ms(lambda: gather_split_channels_f32_reference(
            table, idx, ncols), 20),
        bound=bound(unique_rows(idx, table.shape[0]) * ncols * 4
                    + nbytes(idx, a), 0.0),
        library_ms=kernel_ms(lambda: torch.index_select(cols_t, 1, safe)))
    kernels.reset_launch_counts()

    img, med, wall, counts = orbit_frames(
        r, np, torch, lambda i: orbit_camera(r, np, i),
        OPAQUE_PATH + ("rasterize_binned", "gather_split_channels",
                       "gather_split_channels_f32"))
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


def phase_aa(P, np, torch):
    """bench.py's headline frame: the stress scene (panes included) with
    MSAA-4x, bloom and DoF at 1080p. K9 and K2's MSAA entries against
    their twins on the first frame's own intermediates, 12 orbit frames,
    host syncs; then supersample and SMAA frames."""
    from awsm_renderer_tpu_torch.ops import kernels
    from awsm_renderer_tpu_torch.ops.raster import (
        BT_W, K9_SLICE, build_bins16, rasterize16_msaa,
        rasterize16_msaa_reference,
    )
    from awsm_renderer_tpu_torch.ops.shade import (
        RESOLVE_NAMES, resolve_planes_fused, resolve_planes_reference,
    )

    log(f"phase aa: Stress-1080p-msaa-bloom-dof (bench.py's headline "
        f"config, panes included), {N_FRAMES} frames at {W}x{H}")
    r, keys, _ = build_stress_scene(P, np, DEVICE, effects=True)
    orbit_camera(r, np, 0)
    k14_calls = {}
    cap = capture_first_frame(r, ("rasterize16_msaa", "resolve_planes_fused",
                                  "shade_surface_fused", "vertex_stage"),
                              k14_calls)
    torch.cuda.synchronize()
    prep = r._prep[1]
    C = prep["op_tile_cap"]
    n_units = (-(-H // 8)) * (-(-W // 128))
    log(f"  prep: opaque tile cap {C} of {n_units} (8, 128) units "
        f"({'engaged' if C is not None else 'declined'}), DoF rings "
        f"{prep['dof_rings']}, overlay tile cap {prep['ov_tile_cap']}")
    check("rasterize16_msaa" in cap, "the MSAA frame called K9")
    results = {}
    # K14 on the benchmark's colonnade-msaa frame: the compacted opaque
    # shade (7 lights, the image environment's taps and sky) and the panes
    k14 = k14_calls["shade_surface_fused"]
    check(len(k14) == 2, f"the MSAA frame called K14 twice: {len(k14)}")
    results["K14_msaa"] = check_k14(k14[0], "MSAA opaque", torch)
    results["K14_msaa_panes"] = check_k14(k14[1], "MSAA panes", torch)
    k15 = k14_calls["vertex_stage"]
    check(len(k15) == 2, f"the MSAA frame called K15 twice: {len(k15)}")
    results["K15_msaa"] = check_k15(k15[0], "MSAA opaque", torch)
    results["K15_msaa_panes"] = check_k15(k15[1], "MSAA panes", torch)
    del k14_calls, k14, k15

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
    # the function's tests: each entry in the quadrants its gate names,
    # each big group in every tile its box holds (the reference's walk);
    # the tests these inputs need: display pixels of those quadrants with
    # a sample centre inside a triangle's bbox
    walk, n_pairs_bbox, pairs, n_tests_warp, n_tests_bbox, in_bytes = \
        k9_walk(srows, bins, n_tx, torch)
    bins_log("K9", bins, walk, K9_SLICE, torch)
    k9_bytes = in_bytes + nbytes(*samp, depth)
    walk_bound = bound(k9_bytes, pairs * OPS_PER_MSAA_PIXEL)
    bbox_bound = bound(k9_bytes, n_tests_bbox * OPS_PER_MSAA_PIXEL)
    results["K9"] = dict(
        err=err,
        ms=kernel_ms(lambda: rasterize16_msaa(srows, bins, width2=w2,
                                            height2=h2)),
        plain_ms=ev[0].elapsed_time(ev[1]),
        bound=min(walk_bound, bbox_bound), library_ms=None)
    bounds = sorted([
        (bbox_bound, f"over the {n_tests_bbox} (display pixel, triangle) "
                     f"tests inside the triangles' bboxes ({n_pairs_bbox} "
                     f"(tile, group) pairs)"),
        (walk_bound, f"over the reference's walk ({pairs} tests)")])
    log(f"  K9: {results['K9']['ms']:.4f} ms; bound "
        + ", ".join(f"{b[0]:.4f} ms ({b[1]}) {what}" for b, what in bounds)
        + f", both x {OPS_PER_MSAA_PIXEL} operations and over the {k9_bytes} "
        f"bytes K9 must move; share of the smaller "
        f"{100 * min(walk_bound, bbox_bound)[0] / results['K9']['ms']:.1f}"
        f"%; the warps' cull leaves {n_tests_warp} tests, "
        f"{n_tests_warp / max(n_tests_bbox, 1):.1f}x those inside the "
        f"bboxes")

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
            ms=kernel_ms(lambda: resolve_planes_fused(t, srows, **kw2)),
            plain_ms=cuda_ms(lambda: resolve_planes_reference(t, srows,
                                                              **kw2), 5))
    results["K2_msaa"] = k2
    del rsamp, rdepth, ref
    kernels.reset_launch_counts()

    img, med, wall, counts_f = orbit_frames(
        r, np, torch, lambda i: orbit_camera(r, np, i),
        ("rasterize16_msaa", "resolve_planes_fused", "onehot_split_rows",
         "tap_plan_fused", "filter_taps_fused", "gather_split_channels",
         "shade_surface_fused", "rasterize_binned_compact"))
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


ANIM_PATH = ("vertex_stage", "rasterize16_msaa", "resolve_planes_fused",
             "onehot_split_rows", "tap_plan_fused", "filter_taps_fused",
             "gather_split_channels", "shade_surface_fused",
             "rasterize_binned_compact")


def hold_split(label, split, whole, idx, n_rows: int, torch):
    """The animated subset's rows of the split stage against the whole
    pool's morph/skin stage: validity equal; material row and tangent
    handedness bit-equal; S_ORIG_ID equal on the primaries (a secondary
    row T + t of the subset carries t); the other columns within 3e-5 of
    max(|v|, 1), the z-plane within 1e-4 / min(2*area in px^2, 1) (the
    CPU test's tolerance, tests/test_torch_animated.py)."""
    from awsm_renderer_tpu_torch.ops.vertex import (
        NSETUP, S_BB_MINX, S_MAT_ROW, S_ORIG_ID, S_TANGENT_W, S_ZA, S_ZC,
    )

    T = n_rows
    rows = torch.cat([idx, idx + T]) if split.shape[0] == 2 * T else idx
    a, b = split.index_select(0, rows), whole.index_select(0, rows)
    va, vb = a[:, S_BB_MINX] < 1e37, b[:, S_BB_MINX] < 1e37
    n_valid = int(va.sum())
    check(bool(torch.equal(va, vb)) and n_valid > 0,
          f"{label}: the same {n_valid} of {rows.numel()} subset rows valid")
    a, b = a[va], b[va]
    n_int = sum(bit_mismatches(a[:, c].contiguous(), b[:, c].contiguous(),
                               torch) for c in (S_MAT_ROW, S_TANGENT_W))
    prim = rows[va] < T
    n_int += int((a[prim, S_ORIG_ID] != b[prim, S_ORIG_ID]).sum())
    err = (a - b).abs() / b.abs().clamp(min=1.0)
    zc = torch.zeros(NSETUP, dtype=torch.bool, device=a.device)
    zc[S_ZA:S_ZC + 1] = True
    area = (b[:, 2] + b[:, 5] + b[:, 8]).abs().clamp(max=1.0)
    e_rest = float(err[:, ~zc].max())
    e_z = float((err[:, zc].max(dim=1).values * area).max())
    log(f"  {label}: {n_int} integer mismatches; max relative error "
        f"{e_rest:.3g} (limit 3e-5), z-plane {e_z:.3g} (limit 1e-4)")
    check(n_int == 0 and e_rest <= 3e-5 and e_z <= 1e-4,
          f"{label}: integer columns bit-equal, floats within tolerance")
    return max(e_rest, e_z)


def phase_animated(P, np, torch, aa_syncs: int):
    """bench.py's animated probe (_animated_probe, bench.py:449-479): the
    stress scene with its animated content, MSAA-4x, bloom and DoF at
    1080p. The split against the whole-pool morph/skin stage; the
    frame's kernels against their twins on its own intermediates; the
    image moves with time; static and animated (update_all(1/60) before
    each frame) timed frames; host syncs."""
    from awsm_renderer_tpu_torch.ops import kernels
    from awsm_renderer_tpu_torch.ops.raster import (
        _rasterize_binned_compact, plane_layout, rasterize16_msaa,
        rasterize16_msaa_reference, rasterize_binned_compact_reference,
    )
    from awsm_renderer_tpu_torch.ops.relayout import (
        gather_split_channels, gather_split_channels_reference,
        onehot_split_rows, onehot_split_rows_reference,
    )
    from awsm_renderer_tpu_torch.ops.shade import (
        RESOLVE_NAMES, resolve_planes_fused, resolve_planes_reference,
    )
    from awsm_renderer_tpu_torch.passes.frame import _run_vertex

    t0 = time.perf_counter()
    r, _keys, _ = build_stress_scene(P, np, DEVICE, effects=True,
                                     animated=True)
    orbit_camera(r, np, 0)
    info = r.meshes.mesh_info
    n_tris = int((r.meshes.tri_mesh >= 0).sum())
    log(f"phase animated: Stress-1080p-animated-msaa-bloom-dof (bench.py's "
        f"animated probe: {sum(1 for _ in r.animations.items())} players, "
        f"{int((info[:, 3] > 0).sum())} morphed meshes, "
        f"{int((info[:, 5] > 0).sum())} skinned), {r.meshes.count} meshes, "
        f"{n_tris} triangles, built in {time.perf_counter() - t0:.1f} s")
    names = ("rasterize16_msaa", "resolve_planes_fused", "onehot_split_rows",
             "tap_plan_fused", "filter_taps_fused", "gather_split_channels",
             "shade_surface_fused", "_rasterize_binned_compact",
             "vertex_stage")
    calls = {}
    cap = capture_first_frame(r, names, calls)
    torch.cuda.synchronize()
    prep, ds = r._prep[1], r._device
    check(prep["has_morphs"] and prep["skin_sets"] == 1
          and "anim_tri_idx" in ds,
          f"the prep specializes morphs and {prep['skin_sets']} skin set and "
          f"ships the animated set")
    n_anim = ds["anim_tri_n"]
    log(f"  animated subset: {n_anim} triangles in {ds['anim_tri_idx'].shape[0]}"
        f" slots, of {ds['tri_mesh'].shape[0]} pool rows; morph bucket "
        f"{ds['morph_weights'].shape[1]}")
    res = {"n_anim": n_anim, "players": sum(1 for _ in r.animations.items())}

    # ---- the split against the whole pool's morph/skin stage ------------
    (srows,), kw9 = cap["rasterize16_msaa"]
    w2, h2 = kw9["width2"], kw9["height2"]
    vkw = dict(rw=w2, rh_full=h2, needs_clip=prep["masks"]["needs_clip"],
               has_morphs=True, skin_sets=prep["skin_sets"])
    split = _run_vertex(ds, prep["opaque_dev"], **vkw)
    check(bool(torch.equal(split, srows[:split.shape[0]])),
          "the frame's setup rows are the split stage's")
    whole = _run_vertex({k: v for k, v in ds.items()
                         if k not in ("anim_tri_idx", "anim_tri_n")},
                        prep["opaque_dev"], **vkw)
    torch.cuda.synchronize()
    res["split_err"] = hold_split(
        "split vs whole-pool morph/skin stage", split, whole,
        ds["anim_tri_idx"][:n_anim].long(), ds["tri_mesh"].shape[0], torch)
    del whole

    # ---- the frame's kernels against their twins -------------------------
    samp, depth, bins = rasterize16_msaa(srows, width2=w2, height2=h2)
    rsamp, rdepth = rasterize16_msaa_reference(srows, bins, width2=w2,
                                               height2=h2)
    torch.cuda.synchronize()
    n_bad = sum(bit_mismatches(a, b, torch) for a, b in zip(samp, rsamp))
    n_bad += bit_mismatches(depth, rdepth, torch)
    check(n_bad == 0, "K9 sample ids and depth bit-equal to the twin")
    rw1 = -(-W // 128) * 128
    entries = [("coord_scale", samp[0][:, :rw1].contiguous().reshape(-1),
                srows, dict(width=rw1, coord_scale=2))]
    if "resolve_planes_fused/xy" in cap:
        (t_c, rows_c), kw_c = cap["resolve_planes_fused/xy"]
        entries.append(("explicit_xy", t_c, rows_c, kw_c))
    for label, t, rows_k, kw2 in entries:
        a = resolve_planes_fused(t, rows_k, **kw2)
        b = resolve_planes_reference(t, rows_k, **kw2)
        bad = int((a["tri_id"] != b["tri_id"]).sum()) + sum(
            int((~torch.isclose(a[k], b[k], rtol=1e-5, atol=1e-6)).sum())
            for k in RESOLVE_NAMES[1:])
        check(bad == 0, f"K2 [{label}] tri_id equal, planes within rtol "
                        f"1e-5, atol 1e-6 of the twin")
    (mat_row, table), _ = cap["onehot_split_rows"]
    check(bit_mismatches(onehot_split_rows(mat_row, table),
                         onehot_split_rows_reference(mat_row, table),
                         torch) == 0, "K3 bit-equal to the twin")
    (texels, idx, ncols), _ = cap["gather_split_channels"]
    check(bit_mismatches(gather_split_channels(texels, idx, ncols),
                         gather_split_channels_reference(texels, idx, ncols),
                         torch) == 0, "K6 bit-equal to the twin")
    check_k4_k5(cap, "animated", torch, timed=False)
    check_k14(cap["shade_surface_fused"], "animated", torch, timed=False)
    k15 = calls["vertex_stage"]
    check(len(k15) == 3, f"the animated frame called K15 three times (the "
                         f"whole pool, the animated subset, the panes): "
                         f"{len(k15)}")
    res["K15_pool"] = check_k15(k15[0], "animated pool", torch)
    res["K15_subset"] = check_k15(k15[1], "animated subset", torch)
    (rows, zlo_c, zhi_c), kw8 = cap["_rasterize_binned_compact"]
    hold_planes("K8 _rasterize_binned_compact (first peel)",
                _rasterize_binned_compact(rows, zlo_c, zhi_c, **kw8),
                rasterize_binned_compact_reference(
                    rows, zlo_c, zhi_c, bins=kw8["bins"],
                    tile_idx=kw8["tile_idx"], n_tx=kw8["n_tx"],
                    names=plane_layout(kw8["has_uv1"], kw8["has_color"])),
                torch)
    del cap, calls, k15, samp, depth, bins, rsamp, rdepth, split

    # ---- the image moves with time -----------------------------------------
    img0 = r.render_device().clone()
    r.update_all(0.5)
    img1 = r.render_device()
    check_image(img1, np, torch)
    moved = int((img0 != img1).any(dim=-1).sum())
    check(bool(torch.isfinite(img0).all()) and moved > 0,
          f"the image moves with time: {moved} pixels differ after "
          f"update_all(0.5)")

    # ---- timed frames, host syncs -------------------------------------------
    kernels.reset_launch_counts()
    log(f"  static: {N_FRAMES} frames, no update")
    res["static"] = orbit_frames(r, np, torch, lambda i: None, ANIM_PATH)[1:]
    log(f"  animated: {N_FRAMES} frames, update_all(1/60) before each")
    res["animated"] = orbit_frames(
        r, np, torch, lambda i: r.update_all(1.0 / 60.0), ANIM_PATH)[1:]
    res["syncs"] = count_syncs(r, torch, "animated MSAA + bloom + DoF",
                               lambda i: r.update_all(1.0 / 60.0), 0)
    check(res["syncs"] <= aa_syncs,
          f"animated frame host syncs {res['syncs']} <= the MSAA orbit's "
          f"{aa_syncs}")
    check(ds["anim_tri_n"] == n_anim and r._anim_tri_idx()[1] == n_anim,
          "the animated set stayed cached across animated frames")
    kernels.reset_launch_counts()
    return res


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


def _dense_overlaps(rows, width: int, height: int, group: int, torch):
    """(x, y) overlaps of each `group`-triangle group's bbox with the
    8x128 tiles' columns (width / 128, groups) and rows (height / 8,
    groups): the tile test is separable."""
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
    ox = (mnx[None] < (tx0 + TR.TILE_W)[:, None]) & (mxx[None] > tx0[:, None])
    oy = (mny[None] < (ty0 + TR.TILE_H)[:, None]) & (mxy[None] > ty0[:, None])
    return ox, oy


def dense_tile_counts(rows, width: int, height: int, group: int, torch):
    """(height / 8, width / 128) counts of the `group`-triangle groups whose
    bboxes overlap each 8x128 tile: with group 128 the chunks K11's scan
    lists for the tile, with 8 the subgroups it merges."""
    ox, oy = _dense_overlaps(rows, width, height, group, torch)
    # float64: exact for any count
    return oy.double() @ ox.double().T


def dense_flush_columns(names) -> set:
    """Setup columns K11's flush reads of a winner's row for output planes
    `names`, beyond the edges, z and bbox: S_ORIG_ID for tri_id, the
    attribute and the perspective weights (S_IW0..2) for each interpolated
    plane (the uv0 derivatives read uv0's)."""
    from awsm_renderer_tpu_torch.ops import vertex as V

    single = {"tri_id": V.S_ORIG_ID, "mat_row": V.S_MAT_ROW,
              "tangent_w": V.S_TANGENT_W, "depth": None}
    spans = {"uv0": (V.S_UV0, 6), "du0": (V.S_UV0, 6),
             "dv0": (V.S_UV0, 6), "uv1": (V.S_UV1, 6),
             "color": (V.S_COLOR, 12), "normal": (V.S_NORMAL, 9),
             "tangent": (V.S_TANGENT, 9)}
    cols = set()
    for n in names:
        if n in single:
            cols |= {single[n]} - {None}
        else:
            b, k = spans[n.split("_")[0]]
            cols |= set(range(b, b + k)) | {V.S_IW0, V.S_IW1, V.S_IW2}
    return cols - set(range(V.S_ZC + 1)) - set(range(V.S_BB_MINX,
                                                     V.S_BB_MAXY + 1))


def dense_info(lib, peel: bool) -> dict:
    """K11's compiled kernel (csrc/dense.cu awsm_dense_info of `lib`,
    kernels.lib() or a build with the same entry bound; the peel's where
    `peel`): registers a thread, local (spill) bytes a thread, CTAs
    resident an SM, threads a CTA, pixels a thread."""
    import ctypes

    out = (ctypes.c_int * 5)()
    rc = lib.awsm_dense_info(ctypes.addressof(out), int(peel), None)
    if rc != 0:
        raise RuntimeError(f"awsm_dense_info failed: cudaError_t {rc}")
    return dict(zip(("regs", "local_bytes", "ctas_per_sm", "threads", "px"),
                    out))


def dense_log(label, rows, width: int, height: int, info, sms: int, torch):
    """Print K11's lists on one call (the chunks and the subgroups each
    8x128 tile lists: mean and max), registers, residency and waves (a
    CTA owns threads x px pixels of a tile); returns the waves."""
    n_ctas = width * height // (info["threads"] * info["px"])
    waves = -(-n_ctas // max(info["ctas_per_sm"] * sms, 1))
    lists = [dense_tile_counts(rows, width, height, g, torch)
             for g in (128, 8)]
    log(f"  {label}: {rows.shape[0] // 128} chunks; chunks a tile lists: "
        f"mean {float(lists[0].mean()):.2f}, max {int(lists[0].max())}; "
        f"subgroups a tile merges: mean {float(lists[1].mean()):.2f}, max "
        f"{int(lists[1].max())}; {info['regs']} registers, "
        f"{info['local_bytes']} local bytes a thread, {info['threads']} "
        f"threads of {info['px']} pixels, {info['ctas_per_sm']} CTAs an SM:"
        f" {n_ctas} CTAs in {waves} waves on {sms} SMs")
    return waves


def dense_bound(rows, out, width: int, height: int, torch, peel=False):
    """K11's least time on setup `rows` whose twin gave planes `out`.
    Bytes: the bbox (4 floats) of every row; the edges and z (12 floats)
    of the rows in 8-triangle subgroups whose bbox overlaps some tile (the
    reference tests no other); the flush's columns (dense_flush_columns) of
    each distinct winner (out's tri_id); the peel bounds read once; out's
    planes written once. Operations: OPS_PER_TEST a coverage test over the
    (tile, 8-triangle subgroup) pairs whose bboxes overlap (the reference
    merges no other subgroup), 1024 pixels x 8 triangles each."""
    from awsm_renderer_tpu_torch.ops import raster as TR

    n_px = width * height
    ox, oy = _dense_overlaps(rows, width, height, TR.SUB, torch)
    pairs = int((oy.double() @ ox.double().T).sum())
    live = int((ox.any(0) & oy.any(0)).sum())
    tid = out["tri_id"]
    winners = int(torch.unique(tid[tid >= 0]).numel())
    nb = 4 * (4 * rows.shape[0] + 12 * TR.SUB * live
              + len(dense_flush_columns(out)) * winners
              + n_px * (len(out) + (2 if peel else 0)))
    return bound(nb, pairs * 1024 * TR.SUB * OPS_PER_TEST)


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
    def k12_fn():
        return split_rows(tform)

    def clone_fn():
        return tform.float().clone().unbind(0)

    # K12 against one clone, in turns (K12, clone, clone, K12): the two
    # are within a microsecond, less than kernel_ms's spread between runs
    turns = [kernel_ms(f) for f in (k12_fn, clone_fn, clone_fn, k12_fn)]
    results["K12"] = dict(
        err=0.0, ms=(turns[0] + turns[3]) / 2,
        plain_ms=cuda_ms(lambda: split_rows_reference(tform), 20),
        bound=bound(2 * nbytes(tform), 0.0),
        library_ms=(turns[1] + turns[2]) / 2)
    r12 = results["K12"]
    small = tform[:, :1024].contiguous()
    log(f"  K12 {r12['ms']:.4f} ms, x.float().clone() "
        f"{r12['library_ms']:.4f} ms (kernel_ms, one event pair around 50 "
        f"calls, in turns K12 / clone / clone / K12: "
        f"{' / '.join(f'{t:.4f}' for t in turns)}); with events around "
        f"each call (cuda_ms): K12 {cuda_ms(k12_fn, 20):.4f} ms, clone "
        f"{cuda_ms(clone_fn, 20):.4f} ms; bound {r12['bound'][0]:.4f} ms "
        f"({r12['bound'][1]}); host time a call on an (8, 1024) table: "
        f"K12 {host_us(lambda: split_rows(small)):.1f} us, clone "
        f"{host_us(lambda: small.float().clone().unbind(0)):.1f} us")
    results["K13"] = dict(
        err=0.0, ms=kernel_ms(lambda: channel_rows(texels)),
        plain_ms=cuda_ms(lambda: channel_rows_reference(texels), 20),
        bound=bound(nbytes(texels) + 4 * texels.numel(), 0.0),
        library_ms=kernel_ms(lambda: texels.t().float().contiguous()))
    del tform, texels, k12, k13

    # ---- K11a / K11b against their twins, on the oracle's own calls ------
    (rows, zlo, zhi), kw7 = calls_k7[0]
    w7, h7 = kw7["width"], kw7["height"]
    lay = dict(has_uv1=kw7["has_uv1"], has_color=kw7["has_color"],
               analytic_derivs=kw7["analytic_derivs"])
    twins = (
        ("K11a_fat", f"K11a fat on the stress frame's opaque setup ({rw}x"
                     f"{rh}, {srows.shape[0] // TR.CHUNK} chunks)",
         lambda: TR.rasterize(srows, width=rw, height=rh, binned=False),
         lambda: TR.rasterize_dense_reference(srows, width=rw, height=rh),
         (srows, rw, rh, False)),
        ("K11a_slim", f"K11a slim on the MSAA frame's setup ({w2}x{h2}, "
                      f"{m_rows.shape[0] // TR.CHUNK} chunks)",
         lambda: TR.rasterize(m_rows, width=w2, height=h2, binned=False,
                              slim=True),
         lambda: TR.rasterize_dense_reference(m_rows, width=w2, height=h2,
                                              slim=True),
         (m_rows, w2, h2, False)),
        ("K11b", f"K11b on the volume + HUD frame's peel 0 ({w7}x{h7})",
         lambda: TR.rasterize_peel(rows, zlo, zhi, width=w7, height=h7,
                                   binned=False, **lay),
         lambda: TR.rasterize_peel_dense_reference(
             rows, zlo, zhi, width=w7, height=h7, **lay),
         (rows, w7, h7, True)),
    )
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for key, label, kern, twin, (k_rows, kw, kh, peel) in twins:
        a = kern()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        b = twin()
        ev[1].record()
        torch.cuda.synchronize()
        err = hold_planes(label, a, b, torch)
        bd = dense_bound(k_rows, b, kw, kh, torch, peel)
        del a, b
        info = dense_info(kernels.lib(), peel)
        res = results[key] = dict(
            err=err, ms=kernel_ms(kern), host_us=host_us(kern),
            device_ms=device_ms(kern), plain_ms=ev[0].elapsed_time(ev[1]),
            bound=bd, library_ms=None, **info)
        res["waves"] = dense_log(label, k_rows, kw, kh, info, sms, torch)
        log(f"  {label}: kernel_ms {res['ms']:.4f} ms (one event pair "
            f"around 50 calls), host_us {res['host_us']:.1f} µs a call, "
            f"device_ms {res['device_ms']:.4f} ms (50 calls in one CUDA "
            f"graph), twin {res['plain_ms']:.4f} ms, bound {bd[0]:.4f} ms "
            f"({bd[1]}; {bd[0] / res['device_ms']:.1%} of device_ms)")
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
TEMPORAL_PATH = ("vertex_stage", "rasterize16_slim", "reproject_history",
                 "resolve_planes_fused", "onehot_split_rows",
                 "tap_plan_fused", "filter_taps_fused",
                 "shade_surface_fused", "rasterize_binned_compact")


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
    from awsm_renderer_tpu_torch.ops.raster import (
        rasterize16_slim, rasterize16_slim_reference,
    )
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
        cap = capture_first_frame(r, ("reproject_history_planes",
                                      "rasterize16_slim"))
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

    # ---- K1 on frame 2's own (jittered) setup ------------------------------
    (srows,), kw = cap["rasterize16_slim"]
    col, depth, bins = rasterize16_slim(srows, **kw)
    ccol, cdep = rasterize16_slim_reference(srows, bins, width=kw["width"],
                                            height=kw["height"])
    torch.cuda.synchronize()
    n_bad = bit_mismatches(col, ccol, torch) + bit_mismatches(depth, cdep,
                                                              torch)
    log(f"  K1 on temporal frame 2's jittered setup {tuple(srows.shape)}: "
        f"{n_bad} mismatching values, {int((col >= 0).sum())} covered "
        f"pixels, max {int(bins[2].max())} groups a tile")
    check(n_bad == 0, "K1 bit-equal to the plain twin on the temporal "
                      "frame")
    del srows, col, depth, bins, ccol, cdep

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
        ms=kernel_ms(lambda: reproject_history_planes(*args)),
        plain_ms=cuda_ms(lambda: reproject_history_reference(*args), 10),
        bound=bound(nbytes(off_x, off_y, exp_z, cur_tid, scal, *a)
                    + 4 * n_tid + 16 * n_col, 0.0),
        library_ms=kernel_ms(lambda: torch.index_select(hist2, 1, src)))
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
    cap = capture_first_frame(r, ("tap_plan_fused", "filter_taps_fused",
                                  "shade_surface_fused", "vertex_stage"))
    torch.cuda.synchronize()
    P_px = W * H
    check(cap["tap_plan_fused"][0][0].shape[0] == 5 * P_px,
          "the helmet frame plans five taps per pixel in one K4 launch")
    k45 = check_k4_k5(cap, "helmet", torch)
    k14 = check_k14(cap["shade_surface_fused"], "helmet", torch)
    k15 = check_k15(cap["vertex_stage"], "helmet", torch)
    img, med, wall, counts = orbit_frames(r, np, torch, camera, OPAQUE_PATH)
    check_image(img, np, torch)
    count_syncs(r, torch, "glb-helmet (opaque only)", camera, N_FRAMES + 1)
    return med, wall, counts, k45 + (k14, k15)


def phase_golden(P, np, torch):
    """Small probe scenes on the card against the checked-in goldens, at
    tests/test_golden.py's tolerance (< 0.5% of channel values off by
    more than 4/255)."""
    from PIL import Image

    from awsm_renderer_tpu_torch.core import animation as A
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

    def scene_morph_cube(r):
        """demo/scenes.py scene_morph_cube: a box whose +y half stretches
        by one morph target under a looping weight clip."""
        geo = box()
        deltas = np.zeros((1, geo.vertex_count, 3), np.float32)
        deltas[0, :, 1] = np.where(geo.positions[:, 1] > 0, 1.0, 0.0)
        geo.morph_positions = deltas
        key = r.add_mesh(geo, r.materials.insert(P.PbrMaterial(
            base_color_factor=np.array([0.3, 0.5, 0.9, 1], np.float32))))
        r.animations.insert(A.AnimationPlayer(A.AnimationClip([
            A.AnimationChannel(A.AnimationSampler(
                times=[0, 1, 2], values=[[0.0], [1.0], [0.0]]),
                A.TargetPath.WEIGHTS, mesh_key=key)])))
        r.lights.insert(P.Light.directional([-0.5, -1.0, -0.3],
                                            intensity=2.5))
        return [2, 1.5, 3], [0, 0.3, 0]

    def scene_rigged_simple(r):
        """demo/scenes.py scene_rigged_simple: a 2-joint skinned column
        that bends."""
        h, seg = 2.0, 8
        pos, idx = [], []
        for yi, y in enumerate(np.linspace(0, h, seg + 1)):
            pos += [[-0.25, y, 0], [0.25, y, 0]]
            if yi:
                a = (yi - 1) * 2
                idx += [[a, a + 1, a + 2], [a + 2, a + 1, a + 3]]
        pos = np.array(pos, np.float32)
        V = len(pos)
        w1 = np.clip(pos[:, 1] / h, 0, 1)
        joints = np.zeros((V, 4), np.int32)
        joints[:, 1] = 1
        weights = np.zeros((V, 4), np.float32)
        weights[:, 0] = 1 - w1
        weights[:, 1] = w1
        geo = P.MeshGeometry(
            positions=pos, indices=np.array(idx, np.int32),
            normals=np.tile(np.array([[0, 0, 1]], np.float32), (V, 1)),
            joints=joints, weights=weights)
        j0 = r.transforms.insert(P.Transform())
        j1 = r.transforms.insert(P.Transform(
            translation=np.array([0, h / 2, 0], np.float32)), parent=j0)
        r.transforms.update_world()
        ibm = np.stack([np.eye(4, dtype=np.float32)] * 2)
        ibm[1, 1, 3] = -h / 2
        skin = r.skins.insert([j0, j1], ibm)
        r.add_mesh(geo, r.materials.insert(P.PbrMaterial(
            base_color_factor=np.array([0.9, 0.6, 0.3, 1], np.float32),
            double_sided=True)), skin_key=skin)
        q0 = m3.quat_identity()
        q1 = m3.quat_from_axis_angle([0, 0, 1], np.pi / 3)
        r.animations.insert(A.AnimationPlayer(A.AnimationClip([
            A.AnimationChannel(A.AnimationSampler(times=[0, 1, 2],
                                                  values=[q0, q1, q0]),
                               A.TargetPath.ROTATION, transform_key=j1)])))
        r.lights.insert(P.Light.directional([-0.5, -1.0, -0.3],
                                            intensity=2.5))
        return [1.5, 1.4, 3.5], [0, 1, 0]

    def scene_instanced(r):
        """demo/scenes.py scene_instanced: one box resource, a ring of 12
        instances."""
        mat = r.materials.insert(P.PbrMaterial(
            base_color_factor=np.array([0.4, 0.7, 0.9, 1], np.float32),
            roughness_factor=0.5))
        r.add_instanced_mesh(box(0.5), mat, [P.Transform(
            translation=np.array([np.cos(a) * 2.2, 0, np.sin(a) * 2.2],
                                 np.float32))
            for a in 2 * np.pi * np.arange(12) / 12])
        r.lights.insert(P.Light.directional([-0.5, -1.0, -0.3],
                                            intensity=2.5))
        return [0, 3.5, 5.0], [0, 0, 0]

    log("phase golden: 128x64 probes (morph-cube, rigged-simple and "
        "instanced included) and effect goldens, 256x128 glTF goldens "
        "(the skinned, morphed and instanced entries included), 512x256 "
        "and 1024x512 parity goldens on the card")
    for name, fn in (("box", scene_box), ("env-ibl", scene_env_ibl),
                     ("box-textured", scene_box_textured),
                     ("alpha-blend", scene_alpha_blend),
                     ("morph-cube", scene_morph_cube),
                     ("rigged-simple", scene_rigged_simple),
                     ("instanced", scene_instanced)):
        r = P.AwsmRendererTorch(P.RendererConfig(width=128, height=64),
                                device=DEVICE)
        view = fn(r)        # the eye, or (eye, centre)
        eye, center = view if isinstance(view, tuple) else (view, [0, 0, 0])
        r.update_all(0.35, m3.look_at(eye, center, [0, 1, 0]),
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
                 "glb-ext-transmission", "glb-sponza-lite", "glb-fox",
                 "glb-instanced", "glb-many-influences", "glb-morph-stress",
                 "glb-morphed", "glb-recursive-skeletons", "glb-skinned",
                 "glb-two-skins"):
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


# ---- M12: the 64-light probe and the hooks frame ----------------------------

LIGHTS_PATH = CHAIN_PATH + ("rasterize_binned_compact",)
MAX_LIST = 16            # passes/light_culling.py MAX_LIGHTS_PER_TILE
# tiled against dense on the display image, off the overflowing units: the
# CPU tests hold 12 lights at 1e-6; here up to 64 terms a pixel sum in
# other orders (the tiled lists by priority, the dense loop by index)
LIGHTS_ATOL = 1e-4


def add_probe_lights(P, np, r):
    """bench.py _lights_probe's lights (bench.py:492-500): point lights on
    rings of radius 3-11 (rng seed 9, intensity 4, range 4) until the
    scene holds 64."""
    rng = np.random.default_rng(9)
    for i in range(64 - r.lights.count):
        a = 2 * np.pi * i / 57.0
        rad = 3.0 + (i % 5) * 2.0
        r.lights.insert(P.Light.point(
            [np.cos(a) * rad, 0.5 + (i % 3), np.sin(a) * rad],
            color=tuple(rng.uniform(0.3, 1.0, 3)), intensity=4.0,
            range=4.0))
    check(r.lights.count == 64, "the probe scene holds 64 lights")


def check_path_kernels(cap, label, torch):
    """K1, K2, K3, K4, K5, K6 and K8 against their twins on a frame's
    captured first calls (capture_first_frame(CHAIN_SITES + K8): the
    tiled light loop runs the op-by-op chain)."""
    from awsm_renderer_tpu_torch.ops.raster import (
        _rasterize_binned_compact, plane_layout, rasterize16_slim,
        rasterize16_slim_reference, rasterize_binned_compact_reference,
    )
    from awsm_renderer_tpu_torch.ops.relayout import (
        gather_split_channels, gather_split_channels_reference,
        onehot_split_rows, onehot_split_rows_reference,
    )
    from awsm_renderer_tpu_torch.ops.shade import (
        RESOLVE_NAMES, resolve_planes_fused, resolve_planes_reference,
    )

    (srows,), kw = cap["rasterize16_slim"]
    col, depth, bins = rasterize16_slim(srows, **kw)
    ccol, cdep = rasterize16_slim_reference(srows, bins, **kw)
    check(bit_mismatches(col, ccol, torch) + bit_mismatches(depth, cdep, torch)
          == 0, f"K1 [{label}] col and depth bit-equal to the twin")
    (tid, rows2), kw2 = cap["resolve_planes_fused"]
    a = resolve_planes_fused(tid, rows2, **kw2)
    b = resolve_planes_reference(tid, rows2, **kw2)
    bad = int((a["tri_id"] != b["tri_id"]).sum()) + sum(
        int((~torch.isclose(a[k], b[k], rtol=1e-5, atol=1e-6)).sum())
        for k in RESOLVE_NAMES[1:])
    check(bad == 0, f"K2 [{label}] tri_id equal, planes within rtol 1e-5, "
                    f"atol 1e-6 of the twin")
    (mat_row, table), _ = cap["onehot_split_rows"]
    check(bit_mismatches(onehot_split_rows(mat_row, table),
                         onehot_split_rows_reference(mat_row, table),
                         torch) == 0, f"K3 [{label}] bit-equal to the twin")
    check_k4_k5(cap, label, torch, timed=False)
    (texels, idx, ncols), _ = cap["gather_split_channels"]
    check(bit_mismatches(gather_split_channels(texels, idx, ncols),
                         gather_split_channels_reference(texels, idx, ncols),
                         torch) == 0, f"K6 [{label}] bit-equal to the twin")
    (rows, zlo_c, zhi_c), kw8 = cap["_rasterize_binned_compact"]
    hold_planes(f"K8 [{label}] _rasterize_binned_compact (first peel)",
                _rasterize_binned_compact(rows, zlo_c, zhi_c, **kw8),
                rasterize_binned_compact_reference(
                    rows, zlo_c, zhi_c, bins=kw8["bins"],
                    tile_idx=kw8["tile_idx"], n_tx=kw8["n_tx"],
                    names=plane_layout(kw8["has_uv1"], kw8["has_color"])),
                torch)
    return depth


def device_kernels(fn, torch):
    """(CUDA kernels, device ms) of one fn() under torch.profiler, or
    (None, None) when the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    n = sum(e.count for e in kern)
    if not n:
        return None, None
    return n, sum(e.self_device_time_total for e in kern) / 1e3


def kernels_a_frame(r, camera, torch, n: int = 3):
    """Device kernels a frame and device ms a frame over n frames under
    torch.profiler (device_kernels), or (None, None) when the profiler
    records no device time."""
    def frames():
        for i in range(n):
            camera(i)
            r.render_device()

    n_kern, ms = device_kernels(frames, torch)
    return (None, None) if n_kern is None else (n_kern / n, ms / n)


def record_lists(r, torch):
    """Render one frame recording every light_lists_from_bounds call of
    its shades: [(the call's unit->pixel map, its arguments, (lidx,
    valid))], the map a (n_units, 128) int64 tensor of flat (rh1 * rw1)
    pixel indices (rh1 * rw1: a pad row). The opaque shade's units are
    band rows; the compacted
    peel's (shade_transparent_compact32) are 4-row groups of its 32x32
    blocks, the same pixels in every stacked layer."""
    from awsm_renderer_tpu_torch.passes import frame, light_culling as LC

    calls, ctx = [], {}
    orig_lists = LC.light_lists_from_bounds
    orig_c32 = frame.shade_transparent_compact32
    rw1 = -(-W // 128) * 128
    rh1 = -(-H // 8) * 8

    def lists(mn, mx, lights, n, K):
        out = orig_lists(mn, mx, lights, n, K)
        n_units = mn[0].shape[0]
        flat = torch.arange(n_units * 128, device=mn[0].device)
        if ctx:
            t_idx, n_tx, y0 = ctx["tiles"]
            within = flat % (t_idx.shape[0] * 1024)
            tile = t_idx.long()[torch.div(within, 1024, rounding_mode="floor")]
            p = within % 1024
            y = (y0 + torch.div(tile, n_tx, rounding_mode="floor") * 32
                 + torch.div(p, 32, rounding_mode="floor"))
            x = (tile % n_tx) * 32 + p % 32
            # the 32-row blocks' pad rows below the frame: index rh1 * rw1
            flat = torch.where(y < rh1, y * rw1 + x, rh1 * rw1)
        calls.append((flat.reshape(n_units, 128), (mn, mx, lights, n, K),
                      out))
        return out

    def c32(layers, tile_idx, opaque_ch, ds, spec, **kw):
        ctx["tiles"] = (tile_idx, kw["n_tx"], kw["row_offset"])
        try:
            return orig_c32(layers, tile_idx, opaque_ch, ds, spec, **kw)
        finally:
            ctx.clear()

    LC.light_lists_from_bounds = lists
    frame.shade_transparent_compact32 = c32
    try:
        r.render_device()
    finally:
        LC.light_lists_from_bounds = orig_lists
        frame.shade_transparent_compact32 = orig_c32
    return calls


def phase_lights(P, np, torch, stress_syncs: int):
    """bench.py's 64-light probe (_lights_probe, bench.py:482-518) on the
    stress frame: the kernels against their twins on its intermediates,
    the lists (lengths, overflowing units, the standalone cull_lights on
    the frame's depth plane), the tiled image against the dense one,
    N_FRAMES orbit frames each way, kernels a frame and host syncs."""
    from dataclasses import replace

    from awsm_renderer_tpu_torch.passes.light_culling import (
        cull_lights, light_lists_from_bounds,
    )

    t0 = time.perf_counter()
    r, _keys, _ = build_stress_scene(P, np, DEVICE)
    add_probe_lights(P, np, r)
    orbit_camera(r, np, 0)
    log(f"phase lights: Stress-1080p-64-lights (bench.py's lights probe: "
        f"the stress scene's 7 lights + 57 point lights), {r.meshes.count} "
        f"meshes, built in {time.perf_counter() - t0:.1f} s")
    cap = capture_first_frame(r, CHAIN_SITES + ("_rasterize_binned_compact",))
    torch.cuda.synchronize()
    depth = check_path_kernels(cap, "64 lights", torch)
    del cap

    # ---- the lists ---------------------------------------------------------
    calls = record_lists(r, torch)
    check(len(calls) >= 2, f"the frame's shades built {len(calls)} list sets "
                           f"(the opaque shade and the panes' peel)")
    rh1, rw1 = -(-H // 8) * 8, -(-W // 128) * 128
    over_px = torch.zeros(rh1 * rw1 + 1, dtype=torch.bool,
                          device=depth.device)
    res = {"lists": []}
    for i, (pix, (mn, mx, lights, n, K), (lidx, valid)) in enumerate(calls):
        lengths = valid.sum(dim=1)
        _all, reach = light_lists_from_bounds(mn, mx, lights, n,
                                              lights.shape[0])
        n_reach = reach.sum(dim=1)
        over = n_reach > MAX_LIST
        over_px[pix[over].reshape(-1)] = True
        res["lists"].append((float(lengths.float().mean()),
                             int(lengths.max()), int(over.sum()),
                             int(over.numel())))
        log(f"  shade {i}: {over.numel()} units, list length mean "
            f"{float(lengths.float().mean()):.3f}, max {int(lengths.max())}"
            f"; lights reaching a unit mean "
            f"{float(n_reach.float().mean()):.3f}, max {int(n_reach.max())}"
            f"; {int(over.sum())} units overflow (> {MAX_LIST} lights)")
    op_pix, (mn, mx, lights, n, K), (lidx, valid) = calls[0]
    cl, counts = cull_lights(lights, n, depth, r._device["camera"], width=rw1,
                             height=rh1, tile_h=1, tile_w=128)
    same = int((counts == valid.sum(dim=1)).sum())
    log(f"  cull_lights(tile_h=1, tile_w=128) on the frame's depth plane: "
        f"{counts.numel()} tiles, length mean "
        f"{float(counts.float().mean()):.3f}"
        f", max {int(counts.max())}; {same} of {counts.numel()} tiles list as "
        f"many lights as the opaque shade's units")
    res["cull"] = (float(counts.float().mean()), int(counts.max()), same,
                   counts.numel())

    # ---- tiled against dense ----------------------------------------------
    tiled = r.render_device().clone()
    auto = r.config
    r.config = replace(auto, light_tiles=False)
    dense = r.render_device()
    r.config = auto
    torch.cuda.synchronize()
    over_img = over_px[:-1].reshape(rh1, rw1)[:H, :W]
    err = (tiled - dense).abs().amax(dim=-1)
    e_in = float(err[~over_img].max()) if bool((~over_img).any()) else 0.0
    e_over = float(err[over_img].max()) if bool(over_img.any()) else 0.0
    log(f"  tiled against dense: max |d| {e_in:.3g} on the "
        f"{int((~over_img).sum())} pixels of units that do not overflow, "
        f"{e_over:.3g} on the {int(over_img.sum())} pixels of overflowing units (not held)")
    check(e_in <= LIGHTS_ATOL, f"tiled equals dense within {LIGHTS_ATOL} off "
                               f"the overflowing units")
    res["err"] = (e_in, e_over, int(over_img.sum()))

    # ---- timed frames, kernels a frame, host syncs -------------------------
    from awsm_renderer_tpu_torch.ops import kernels

    def cam(i):
        orbit_camera(r, np, i)

    for label, dense_loop in (("tiled", False), ("dense", True)):
        r.config = replace(auto, light_tiles=False) if dense_loop else auto
        log(f"  {label}: {N_FRAMES} orbit frames")
        img, med, wall, counts_ = orbit_frames(
            r, np, torch, cam, OPAQUE_PATH + ("rasterize_binned_compact",)
            if dense_loop else LIGHTS_PATH)
        check_image(img, np, torch)
        n_k, dev_ms = kernels_a_frame(r, cam, torch)
        log(f"  {label}: {'not measured' if n_k is None else f'{n_k:.0f}'} "
            f"kernels a frame, device "
            f"{'not measured' if dev_ms is None else f'{dev_ms:.3f}'} ms a "
            f"frame (torch.profiler, 3 frames)")
        res[label] = (med, wall, n_k, dev_ms)
    r.config = auto
    res["syncs"] = count_syncs(r, torch, "64-light tiled", cam, N_FRAMES + 2)
    check(res["syncs"] <= stress_syncs,
          f"64-light frame host syncs {res['syncs']} <= the stress frame's "
          f"{stress_syncs}")
    kernels.reset_launch_counts()
    return res


GRID_LINES = 50          # per direction: 2 x 50 quads, 200 triangles
GRID_Y = -0.55           # under the colonnade's boxes and spheres


def grid_triangles(np, torch, device):
    """A world-space editor grid on the plane y = GRID_Y: GRID_LINES
    thin quads along x and as many along z over [-12, 12], two triangles
    each -> ((T, 3, 3) corners, (T, 4) colours) on `device`."""
    half, w = 12.0, 0.04
    quads = []
    for v in np.linspace(-half, half, GRID_LINES):
        quads.append([[-half, v - w], [half, v - w], [half, v + w],
                      [-half, v + w]])
        quads.append([[v - w, -half], [v + w, -half], [v + w, half],
                      [v - w, half]])
    q = np.array(quads, np.float32)                   # (Q, 4, 2): (x, z)
    xyz = np.stack([q[..., 0], np.full(q.shape[:2], GRID_Y, np.float32),
                    q[..., 1]], axis=-1)
    tris = np.concatenate([xyz[:, [0, 1, 2]], xyz[:, [0, 2, 3]]])
    cols = np.tile(np.array([[0.9, 0.9, 0.2, 0.8]], np.float32),
                   (tris.shape[0], 1))
    return (torch.tensor(tris, device=device),
            torch.tensor(cols, device=device))


def phase_hooks(P, np, torch):
    """The stress frame at 1080p with a full hook set: pre_render /
    post_render counters, an identity first_pass, a before_transparent
    that draws a 200-triangle world-space grid through
    extra_geometry_pass with the depth test, and a last_pass that stamps
    a pixel. Each hook fires once; the image differs from the hookless
    frame only where the grid and the stamp land; pick() after a camera
    move replays the in-frame hooks without the host ones; the frame's
    ms with and without hooks and the extra pass's ms per triangle."""
    from awsm_renderer_tpu_torch.passes.extra import extra_geometry_pass
    from awsm_renderer_tpu_torch.passes.frame import RenderHooks

    r, _keys, _ = build_stress_scene(P, np, DEVICE)
    orbit_camera(r, np, 0)
    tris, cols = grid_triangles(np, torch, r.device)
    log(f"phase hooks: Stress-1080p-ibl-tex with a full hook set, a "
        f"{tris.shape[0]}-triangle grid through extra_geometry_pass")
    calls = {}

    def count(name):
        calls[name] = calls.get(name, 0) + 1

    def first_pass(ds):
        count("first_pass")
        return ds

    def before_transparent(hdr, depth, ds):
        count("before_transparent")
        return extra_geometry_pass(hdr, depth, ds["camera"], tris, cols,
                                   depth_test=True)[0]

    stamp = (7, 5)

    def last_pass(ldr, ds):
        count("last_pass")
        out = ldr.clone()
        out[stamp] = torch.tensor([1.0, 0.0, 1.0, 1.0], device=ldr.device)
        return out

    hooks = RenderHooks(pre_render=lambda _r: count("pre_render"),
                        post_render=lambda _r: count("post_render"),
                        first_pass=first_pass,
                        before_transparent=before_transparent,
                        last_pass=last_pass)
    base = r.render_device().clone()
    img = r.render_device(hooks=hooks)
    torch.cuda.synchronize()
    check(calls == {k: 1 for k in ("pre_render", "post_render", "first_pass",
                                   "before_transparent", "last_pass")},
          f"each hook fired once: {calls}")
    # where the grid can land: its triangles' coverage without a depth test
    probe = torch.zeros((H, W, 4), device=r.device)
    cover = extra_geometry_pass(probe, None, r._device["camera"], tris,
                                torch.ones_like(cols),
                                depth_test=False)[0][..., 3] > 0
    cover[stamp] = True
    diff = (img - base).abs().amax(dim=-1) > 2.0 / 255.0
    outside = int((diff & ~cover).sum())
    log(f"  hooked against hookless: {int(diff.sum())} pixels differ by more "
        f"than 2/255, {int((diff & cover).sum())} of them under the grid or "
        f"the stamp, {outside} elsewhere; the grid covers "
        f"{int(cover.sum())} pixels without the depth test")
    check(outside == 0 and int(diff.sum()) > 1000,
          "the image differs from the hookless frame only where the grid "
          "and the stamp land")
    check(bool((img[stamp] == torch.tensor([1.0, 0.0, 1.0, 1.0],
                                           device=r.device)).all()),
          "last_pass stamped its pixel")

    orbit_camera(r, np, 1)
    before = dict(calls)
    key = r.pick(W // 2, H // 2)
    check(calls["pre_render"] == before["pre_render"]
          and calls["post_render"] == before["post_render"]
          and all(calls[k] == before[k] + 1 for k in (
              "first_pass", "before_transparent", "last_pass")),
          f"pick() after a camera move ({key}) replayed the in-frame hooks "
          f"without the host ones: {calls}")

    res = {}
    for label, hk in (("hookless", None), ("hooks", hooks)):
        ev = []
        r.render_device(hooks=hk)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(N_FRAMES):
            orbit_camera(r, np, i + 2)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            r.render_device(hooks=hk)
            b.record()
            ev.append((a, b))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / N_FRAMES
        med = statistics.median(a.elapsed_time(b) for a, b in ev)
        log(f"  {label}: median {med:.3f} ms/frame (CUDA events), host wall "
            f"{wall:.3f} ms/frame over {N_FRAMES} orbit frames")
        res[label] = (med, wall)
    hdr = torch.rand((H, W, 4), device=r.device)
    dep = torch.full((H, W), 0.999, device=r.device)
    cam = r._device["camera"]
    pass_ms = cuda_ms(lambda: extra_geometry_pass(hdr, dep, cam, tris, cols,
                                                  depth_test=True), 5)
    t0 = time.perf_counter()
    for _ in range(3):
        extra_geometry_pass(hdr, dep, cam, tris, cols, depth_test=True)
    torch.cuda.synchronize()
    pass_wall = (time.perf_counter() - t0) * 1e3 / 3
    log(f"  extra_geometry_pass, {tris.shape[0]} triangles at {W}x{H}: "
        f"{pass_ms:.3f} ms (CUDA events), host wall {pass_wall:.3f} ms; "
        f"{pass_ms / tris.shape[0]:.4f} ms a triangle")
    res["pass"] = (pass_ms, pass_wall, int(tris.shape[0]))
    return res


# the card's generate_brdf_lut(256, 512) against the CPU's, off the
# grazing NdotV column 0: f32 rounding, amplified by 1 / n_dot_v, puts the
# CPU table up to 9.1e-4 from a float64 evaluation of the same sums there
# (3.0e-3 on column 0, 5.4e-7 in mean); the card's table may round
# another way as far, so twice that
TOOLS_LUT_ATOL = 2e-3


def first_frame_ms(r, torch):
    """(CUDA-event ms, host wall ms) of one render_device() call started
    on an idle card."""
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    a.record()
    r.render_device()
    b.record()
    b.synchronize()
    return a.elapsed_time(b), (time.perf_counter() - t0) * 1e3


def syncs_of(fn, torch):
    """(fn()'s result, host syncs while it ran, their source lines): torch's
    sync debug mode warns at every call that waits for the device."""
    import collections
    import warnings

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    sites = collections.Counter(
        f"{os.path.relpath(w.filename, REPO)}:{w.lineno}" for w in caught
        if "synchroniz" in str(w.message))
    return out, sum(sites.values()), dict(sites.most_common())


def key_plane(r, np):
    """(H, W) mesh keys of the last frame's tri_id plane (-1: sky), read
    back once."""
    tid = r._last_tri_id.cpu().numpy()
    tm = r._tri_mesh_device_order
    row_key = np.full(int(tm.max()) + 2, -1, np.int64)
    for row, key in r._mesh_row_to_key.items():
        if row < row_key.size:
            row_key[row] = key
    rows = np.where(tid >= 0, tm[np.clip(tid, 0, tm.size - 1)], -1)
    return np.where(rows >= 0, row_key[rows], -1)


def pick_pixel(plane, wanted, np, r=3):
    """The pixel nearest the plane's centre whose (2r+1)^2 window shows a
    single key of `wanted`: (x, y, key), or None."""
    h, w = plane.shape
    ys, xs = np.nonzero(np.isin(plane, np.fromiter(wanted, np.int64)))
    keep = (ys >= r) & (ys < h - r) & (xs >= r) & (xs < w - r)
    ys, xs = ys[keep], xs[keep]
    for i in np.argsort((xs - w / 2) ** 2 + (ys - h / 2) ** 2):
        x, y = int(xs[i]), int(ys[i])
        if (plane[y - r:y + r + 1, x - r:x + r + 1] == plane[y, x]).all():
            return x, y, int(plane[y, x])
    return None


def atlas_scene(P, np):
    """tests/test_mega_texture.py's atlas scene on the card: a red and a
    green image packed into one atlas page through add_atlas_image, on
    two quads at 128x64."""
    from awsm_renderer_tpu_torch.core.materials import TS_BASE_COLOR
    from awsm_renderer_tpu_torch.core.mega_texture import TextureType
    from awsm_renderer_tpu_torch.geometry import plane
    from awsm_renderer_tpu_torch.utils import math3d as m3

    F = np.float32
    r = P.AwsmRendererTorch(P.RendererConfig(width=128, height=64),
                            device=DEVICE)
    refs = []
    for ch, n in ((0, 16), (1, 24)):
        img = np.zeros((n, n, 4), F)
        img[..., ch] = 1.0
        img[..., 3] = 1.0
        refs.append(r.add_atlas_image(img, TextureType.ALBEDO))
    check(refs[0].texture_id == refs[1].texture_id
          and refs[0].transform_id != refs[1].transform_id,
          "two add_atlas_image entries share one atlas page")
    for ref, x in zip(refs, (-1.1, 1.1)):
        mat = r.materials.insert(P.UnlitMaterial(
            base_color_factor=np.ones(4, F), textures={TS_BASE_COLOR: ref}))
        r.add_mesh(plane(2.0), mat, transform=P.Transform(
            translation=np.array([x, 0, 0], F),
            rotation=m3.quat_from_axis_angle([1, 0, 0], np.pi / 2)))
    r.camera.update(m3.look_at([0, 0, 3.2], [0, 0, 0], [0, 1, 0]),
                    m3.perspective(np.pi / 3, 2.0, 0.1, 100.0))
    return r


def phase_tools(P, np, torch, stress_syncs: int):
    """The facade's tool members and the tools on bench.py's stress scene
    at 1080p: warmup (a toggled variant's first frame cold, on a fresh
    renderer, and after warmup), an InteractiveSession(editor=True,
    grid=True) driven by a scripted event list (select a box, drag a
    translate handle, orbit from the sky, wheel, the bloom / MSAA / grid
    toggles, a resize to 1280x720 and back), its steps' ms, host syncs
    and launches, timings on against off, check_compatibility beside the
    measured peak, the exporter, a snapshot round trip, the atlas scene
    and the BRDF LUT against the CPU's."""
    import dataclasses

    from PIL import Image

    from awsm_renderer_tpu_torch.core.snapshot import load_scene, save_scene
    from awsm_renderer_tpu_torch.editor import GizmoMode
    from awsm_renderer_tpu_torch.errors import ConfigError
    from awsm_renderer_tpu_torch.ops import kernels
    from awsm_renderer_tpu_torch.ops.brdf_lut import _lut
    from awsm_renderer_tpu_torch.passes.frame import RenderHooks
    from awsm_renderer_tpu_torch.session import InteractiveSession, OrbitCamera
    from awsm_renderer_tpu_torch.utils.compatibility import (
        check_compatibility,
    )
    from awsm_renderer_tpu_torch.utils.exporter import (
        export_depth, export_image,
    )

    t_phase = time.perf_counter()
    out_dir = os.path.join(REPO, "build", "chip_smoke", "tools")
    os.makedirs(out_dir, exist_ok=True)
    res = {}

    def pp(r, **kw):
        return dataclasses.replace(r.config.post_processing, **kw)

    def aa(r, **kw):
        return dataclasses.replace(r.config.anti_aliasing, **kw)

    # warmup: a toggled variant's first frame, cold and after warmup
    cold_r = build_stress_scene(P, np, DEVICE)[0]
    orbit_camera(cold_r, np, 0)
    cold_r.set_post_processing(pp(cold_r, bloom=True))
    res["cold"] = first_frame_ms(cold_r, torch)
    del cold_r
    r, keys, _ = build_stress_scene(P, np, DEVICE)
    orbit_camera(r, np, 0)
    log(f"phase tools: Stress-1080p-ibl-tex through InteractiveSession("
        f"editor=True, grid=True), {r.meshes.count} meshes before the "
        f"editor's")
    cfg0 = r.config
    n = r.warmup([{"bloom": True}, {"msaa": True}])
    check(n == 3 and r.config is cfg0,
          "warmup([bloom], [msaa]) rendered 3 frames and restored the config")
    try:
        r.warmup([{"msaa": True, "supersample": True}])
        raised = False
    except ConfigError:
        raised = True
    check(raised and r.config is cfg0,
          "a variant that raises (MSAA + supersample) leaves the config as "
          "it was")
    r.set_post_processing(pp(r, bloom=True))
    res["warm"] = first_frame_ms(r, torch)
    r.set_post_processing(pp(r, bloom=False))
    log(f"  first bloom frame: cold (a fresh renderer, uploads included) "
        f"{res['cold'][0]:.3f} ms (CUDA events), {res['cold'][1]:.3f} ms "
        f"host wall; after warmup {res['warm'][0]:.3f} ms, "
        f"{res['warm'][1]:.3f} ms host wall")

    rad = float(np.sqrt(10.0 ** 2 * 2 + 7.0 ** 2))
    s = InteractiveSession(r, editor=True, grid=True, camera=OrbitCamera(
        center=(0.0, 0.0, 0.0), radius=rad, yaw=float(np.pi / 4),
        pitch=float(np.arcsin(7.0 / rad)), near=0.1, far=200.0))
    tk_of = {k: r.meshes.get(k).transform_key for k in keys}

    def hold(img, w=W, h=H):
        check(tuple(img.shape) == (h, w, 4) and bool(torch.isfinite(img)
                                                     .all()),
              f"step image finite, shape {tuple(img.shape)}")
        return img

    hold(s.step(0.0, [("set", "grid", False)]))
    plane = key_plane(r, np)
    box = pick_pixel(plane, set(keys), np)
    check(box is not None, f"a colonnade mesh pixel found: {box}")
    bx, by, bkey = box
    _img, n_down, down_sites = syncs_of(lambda: hold(s.step(0.0, [
        ("pointer_down", bx, by), ("pointer_up",)])), torch)
    check(s.selected == bkey and s.controller.target == tk_of[bkey]
          and bool(r._mesh_masks()["hud"].any()),
          f"pointer_down at ({bx}, {by}) selected mesh {bkey} and attached "
          f"the gizmo (HUD handles visible)")
    log(f"  host syncs of a pointer-down step (two picks: the gizmo's and "
        f"the session's): {n_down}; by source line: {down_sites}")

    parts = s.controller._parts
    handles = {k for k, (m, _a) in parts.items()
               if m == GizmoMode.TRANSLATE}
    plane = key_plane(r, np)
    hnd = (pick_pixel(plane, handles, np, r=1)
           or pick_pixel(plane, handles, np, r=0))
    check(hnd is not None, f"a translate-handle pixel found: {hnd}")
    hx, hy, hkey = hnd
    axis = parts[hkey][1]
    tk = tk_of[bkey]
    t0 = r.transforms.get_local(tk).translation.copy()
    hold(s.step(0.0, [("pointer_down", hx, hy)]))
    check(s.controller.dragging, f"pointer_down on handle {hkey} (axis "
                                 f"{axis}) started a gizmo drag")
    hold(s.step(0.0, [("pointer_move", hx + 60, hy + 30)]))
    hold(s.step(0.0, [("pointer_up",)]))
    d = r.transforms.get_local(tk).translation - t0
    check(abs(float(d[axis])) > 1e-3
          and all(float(d[i]) == 0.0 for i in range(3) if i != axis),
          f"the drag moved the target along axis {axis} only: {d}")

    sky = pick_pixel(key_plane(r, np)[: H // 4], {-1}, np)
    check(sky is not None, f"a sky pixel found: {sky}")
    sx, sy, _ = sky
    eye0 = s.camera.eye().copy()
    hold(s.step(0.0, [("pointer_down", sx, sy)]))
    hold(s.step(0.0, [("pointer_move", sx + 80, sy + 10)]))
    hold(s.step(0.0, [("pointer_up",)]))
    check(float(np.abs(s.camera.eye() - eye0).max()) > 1e-2
          and s.selected == bkey,
          f"an empty-sky drag orbited the camera (eye {eye0} -> "
          f"{s.camera.eye()}), the selection kept")
    r0 = s.camera.radius
    hold(s.step(0.0, [("wheel", -1.0)]))
    check(s.camera.radius < r0, f"wheel zoomed ({r0:.3f} -> "
                                f"{s.camera.radius:.3f})")

    # pointer-free steps on a moving camera, timings off then on: the
    # same frames, the same syncs and launches
    yaw0 = s.camera.yaw
    runs = []          # (timings on, median, wall, syncs, sites, counts)
    for on in (False, True, True, False):       # in turns
        r.logging_timings = on
        kernels.reset_launch_counts()
        ev = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(N_FRAMES):
            s.camera.yaw = yaw0 + 0.01 * (i + 1)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            img = s.step(1.0 / 60)
            b.record()
            ev.append((a, b))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / N_FRAMES
        counts = dict(kernels.launch_counts)
        med = statistics.median(a.elapsed_time(b) for a, b in ev)
        hold(img)

        def two_more():
            for i in (N_FRAMES, N_FRAMES + 1):
                s.camera.yaw = yaw0 + 0.01 * (i + 1)
                s.step(1.0 / 60)

        _, n_sync, sites = syncs_of(two_more, torch)
        runs.append((on, med, wall, n_sync / 2, sites, counts))
        log(f"  {N_FRAMES} pointer-free steps on a moving camera, timings "
            f"{'on' if on else 'off'}: median {med:.3f} ms/step (CUDA "
            f"events), host wall {wall:.3f} ms/step; launches {counts}; "
            f"{n_sync} host syncs in two more ({sites})")
    r.logging_timings = False
    check(all(run[3] == runs[0][3] and run[5] == runs[0][5] for run in runs),
          "timings on: the same host syncs and kernel launches as off")
    check(runs[0][3] <= stress_syncs,
          f"a pointer-free step waits on the device no more often than the "
          f"stress frame ({runs[0][3]:g} a step against {stress_syncs})")
    for name in OPAQUE_PATH:
        check(runs[0][5][name] >= N_FRAMES,
              f"{name} launched on every step")
    def session_camera(i):
        s.camera.yaw = yaw0 + 0.01 * (i + 1)
        r.update_all(0.0, *s.camera.matrices(W / H))

    n_kern, kern_ms = kernels_a_frame(r, session_camera, torch)
    log(f"  kernels a pointer-free step (profiler): "
        f"{'not measured' if n_kern is None else f'{n_kern:.0f}'}, device "
        f"{'not measured' if kern_ms is None else f'{kern_ms:.3f}'} ms")
    host = r.timings.summary()
    dev = r.timings.device_summary()
    check(set(dev) >= {"write_gpu", "collect_renderables",
                       "render_frame/dispatch"} and len(r.timings.frames)
          == 2 * N_FRAMES + 4, f"timings recorded {len(r.timings.frames)} "
                               f"frames with device times for {sorted(dev)}")
    spans = {k: (host[k] * 1e3, dev.get(k, 0.0) * 1e3) for k in sorted(host)}
    log("  spans (host ms, device ms) a step: " + ", ".join(
        f"{k} {h:.3f} / {d:.3f}" for k, (h, d) in spans.items()))
    res.update(steps=runs, spans=spans, down_syncs=n_down,
               kernels=(n_kern, kern_ms))

    # the host work the tools add to every frame: the retrace signature
    # (on every frame, as in the reference) and a span with timings off
    captured = []
    log_retrace = r._log_retrace
    r._log_retrace = lambda *args: (captured.append(args),
                                    log_retrace(*args))[1]
    s.step(0.0)
    del r._log_retrace
    sig_us = host_us(lambda: log_retrace(*captured[0]))

    def span_off():
        with r.timings.span("write_gpu"):
            pass

    span_us = host_us(span_off)
    log(f"  host work a frame gains: _log_retrace {sig_us:.1f} µs, a span "
        f"with timings off {span_us:.2f} µs")
    res["host_us"] = (sig_us, span_us)

    # compatibility report beside the measured peak
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    img = hold(s.step(0.0))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    rep = check_compatibility(r)
    est = rep.scene_bytes + rep.framebuffer_bytes
    check(rep.ok and rep.device_kind == torch.cuda.get_device_name(0)
          and rep.hbm_bytes == torch.cuda.get_device_properties(0)
          .total_memory, f"check_compatibility: {rep}")
    log(f"  compatibility: scene {rep.scene_bytes / 2**20:.1f} MiB + "
        f"framebuffers {rep.framebuffer_bytes / 2**20:.1f} MiB = "
        f"{est / 2**20:.1f} MiB estimated; the stress step's peak "
        f"allocated {peak / 2**20:.1f} MiB: the estimate "
        f"{'covers' if est >= peak else 'does not cover'} it")
    res["compat"] = (rep, peak)

    # exporter: a session frame and the frame's depth plane
    path = os.path.join(out_dir, "frame.png")
    export_image(img, path)
    back = np.asarray(Image.open(path))
    want = (img.double().nan_to_num().clamp(0, 1) * 255 + 0.5).to(
        torch.uint8).cpu().numpy()
    check(back.shape == (H, W, 4) and np.array_equal(back, want),
          "export_image: the PNG read back equals the tensor's u8")
    depth = []
    r.render_device(hooks=RenderHooks(before_transparent=(
        lambda hdr, dep, ds: depth.append(dep.clone()) or hdr)))
    dpath = os.path.join(out_dir, "depth.png")
    export_depth(depth[0], dpath)
    dback = np.asarray(Image.open(dpath))
    sky_px = (depth[0] >= 1.0).cpu().numpy()
    check(dback.shape == (H, W, 3) and (dback[sky_px] == 255).all()
          and (dback[~sky_px] < 255).any(),
          "export_depth: sky white, geometry graded")

    # snapshot round trip onto the card
    spath = os.path.join(out_dir, "scene.awsm")
    t0 = time.perf_counter()
    save_scene(r, spath)
    t1 = time.perf_counter()
    r2 = load_scene(spath, device=DEVICE)
    t2 = time.perf_counter()
    a1 = r.render_device()
    a2 = r.render_device()
    b1 = r2.render_device()
    same = bool(torch.equal(a1, a2))
    check(same and bool(torch.equal(a1, b1)),
          f"snapshot: the reloaded frame is bit-equal to the original "
          f"({os.path.getsize(spath) / 2**20:.1f} MiB, saved in "
          f"{t1 - t0:.2f} s, loaded in {t2 - t1:.2f} s)")
    os.remove(spath)
    del r2, a1, a2, b1

    # the sidebar toggles and a resize
    hold(s.step(0.0, [("set", "bloom", True)]))
    check(r.config.post_processing.bloom, "set bloom: on")
    kernels.reset_launch_counts()
    hold(s.step(0.0, [("set", "msaa", True)]))
    check(r.config.anti_aliasing.msaa
          and kernels.launch_counts["rasterize16_msaa"] >= 1,
          "set msaa: on, K9 launched")
    hold(s.step(0.0, [("set", "grid", True)]))
    check(bool(r._mesh_masks()["transparent"][
        r.meshes._mesh_alloc.row_of(s.grid.mesh_key)]), "set grid: visible")
    hold(s.step(0.0, [("resize", 1280, 720)]), 1280, 720)
    hold(s.step(0.0, [("resize", W, H)]))
    check(s.frames == 24 + 4 * N_FRAMES, f"{s.frames} session steps")

    # the atlas through the facade
    ra = atlas_scene(P, np)
    img = ra.render_device()
    left, right = img[32, 32, :3].tolist(), img[32, 96, :3].tolist()
    check(left[0] > 0.5 and left[1] < 0.3 and right[1] > 0.5
          and right[0] < 0.3, f"atlas quads distinct: left {left}, right "
                              f"{right}")
    rep = ra.mega_texture.report()["albedo"][0]
    check(rep["entries"] == 2, f"atlas report: {rep}")

    # the BRDF LUT on the card against the CPU's
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    a.record()
    lut = _lut.__wrapped__(256, 512, "cuda")
    b.record()
    b.synchronize()
    lut_wall = (time.perf_counter() - t0) * 1e3
    lut_ms = a.elapsed_time(b)
    t0 = time.perf_counter()
    ref = _lut.__wrapped__(256, 512, "cpu")
    cpu_s = time.perf_counter() - t0
    diff = (lut.cpu() - ref).abs()
    err0, err, mean = (float(diff[:, 0].max()), float(diff[:, 1:].max()),
                       float(diff.mean()))
    check(tuple(lut.shape) == (256, 256, 2) and err <= TOOLS_LUT_ATOL
          and mean <= 1e-5,
          f"generate_brdf_lut(256, 512) on the card against the CPU: max "
          f"|d| {err:.3g} off NdotV column 0 (atol {TOOLS_LUT_ATOL:g}), "
          f"{err0:.3g} on it, mean {mean:.3g}")
    log(f"  generate_brdf_lut(256, 512): {lut_ms:.3f} ms (CUDA events), "
        f"{lut_wall:.3f} ms host wall on the card; {cpu_s:.2f} s on the "
        f"CPU")
    res["lut"] = (lut_ms, lut_wall, err, err0, mean)
    res["seconds"] = time.perf_counter() - t_phase
    log(f"phase tools: {res['seconds']:.1f} s")
    return res


# ---- sharded: the multi-GPU frame (parallel/sharding.py) ------------------

# 1080 rows split into TILE_H-aligned bands only for n dividing 135, 1920
# columns into TILE_W-aligned ones only for n dividing 15
SHARD_N = 3
SHARD_PATH = ("vertex_stage", "rasterize16_slim", "resolve_planes_fused",
              "onehot_split_rows", "tap_plan_fused", "filter_taps_fused",
              "shade_surface_fused", "gather_split_channels",
              "gather_split_channels_f32",
              "rasterize_binned", "rasterize16_msaa")
SHARD_TIMEOUT = 600      # s, the spawned ranks' join


def shard_inputs(r):
    """Renderer r's current frame as the sharded functions take it: (ds,
    (opaque, transparent, hud) device masks, None where a bucket is empty,
    the frame's FrameSpec). The renderer's own specialization, with the
    overlay's slot and extension masks merged into the frame's (the
    sharded frame has one set of each) and no overlay compaction, crop,
    tile cap or DoF ring set (it has none)."""
    from dataclasses import replace

    ds = r._flush()
    prep = r._prepare()
    spec = r._frame_spec(prep)

    def merged(a, b):
        return a if b is None else tuple(x or y for x, y in zip(a, b))

    spec = replace(
        spec, slot_mask=merged(spec.slot_mask, spec.overlay_slot_mask),
        ext=merged(spec.ext, spec.overlay_ext), overlay_slot_mask=None,
        overlay_ext=None, overlay_crop_y0=None, overlay_crop_h=None,
        overlay_tile_cap=None, opaque_tile_cap=None, dof_rings=None)
    return ds, (prep["opaque_dev"], prep["transparent_dev"],
                prep["hud_dev"]), spec


def sharded_kw(fn, spec, masks) -> dict:
    """The keywords of the public sharded function fn for spec's frame:
    the fields it takes, and whether each overlay bucket has content."""
    import inspect

    params = inspect.signature(fn).parameters
    kw = {k: getattr(spec, k) for k in params if hasattr(spec, k)}
    return dict(kw, has_transparent=masks[1] is not None,
                has_hud=masks[2] is not None)


def record_band_calls(fn, names=SHARD_PATH):
    """fn() with recorders on the kernel wrappers `names` and on the
    sharded frame's _pack -> (fn's result, segments): a segment ends where
    a band's planes are packed for an exchange, so it holds one band's
    calls of one stage, {wrapper name: [(args, kwargs)]}."""
    from awsm_renderer_tpu_torch.parallel import sharding

    where = kernel_sites()
    sites = [(mod, n) for n in names for mod in where[n]]
    originals = [getattr(mod, n) for mod, n in sites]
    orig_pack = sharding._pack
    segs = [{}]

    def recorder(name, f):
        def wrapped(*args, **kwargs):
            segs[-1].setdefault(name, []).append((args, kwargs))
            return f(*args, **kwargs)
        return wrapped

    def pack(planes):
        segs.append({})
        return orig_pack(planes)

    try:
        for (mod, n), f in zip(sites, originals):
            setattr(mod, n, recorder(n, f))
        sharding._pack = pack
        out = fn()
    finally:
        for (mod, n), f in zip(sites, originals):
            setattr(mod, n, f)
        sharding._pack = orig_pack
    return out, [s for s in segs if s]


def launches_of(kernels) -> dict:
    """The launch counts that are not 0."""
    return {k: v for k, v in kernels.launch_counts.items() if v}


def shard_diagnose(label, ds, masks, spec, tid_b, tid_1, d, dz, border,
                   torch) -> None:
    """Where a band assembly's ldr departs from the whole frame's off the
    border rows: the pixels within 2 of a tri_id mismatch, those the
    transparent panes cover (K1 over the transparent bucket at 1x), the
    rest; depth where the ids agree."""
    from awsm_renderer_tpu_torch.ops.raster import rasterize16_slim
    from awsm_renderer_tpu_torch.passes.frame import _pad_to, _run_vertex

    h, w = tid_b.shape
    mis = (tid_b != tid_1).float()[None, None]
    near = torch.nn.functional.max_pool2d(mis, 5, 1, 2)[0, 0] > 0
    panes = torch.zeros_like(near)
    if masks[1] is not None:
        rows = _run_vertex(ds, masks[1], rw=_pad_to(w, 128),
                           rh_full=_pad_to(h, 8), needs_clip=spec.needs_clip,
                           pad=True)
        col, _dep, _b = rasterize16_slim(rows, width=_pad_to(w, 128),
                                         height=_pad_to(h, 8))
        panes = (col.reshape(_pad_to(h, 8), -1)[:h, :w] >= 0)
    big = (d > 1e-3) & ~border
    rest = big & ~near & ~panes
    same = tid_b == tid_1
    log(f"    {label} ldr off the borders: {int(big.sum())} pixels > 1e-3, "
        f"{int((big & near).sum())} within 2 of a tri_id mismatch, "
        f"{int((big & panes & ~near).sum())} under the panes, "
        f"{int(rest.sum())} elsewhere (max |d| "
        f"{float(d[~border & ~near & ~panes].max()):.3g} off all three); "
        f"depth max |d| {float(dz[same].max()):.3g} where the ids agree")
    for y, x in rest.nonzero()[:6].tolist():
        log(f"      ({y}, {x}): tri_id {int(tid_b[y, x])} / "
            f"{int(tid_1[y, x])}, |d| {float(d[y, x]):.3g}, depth |d| "
            f"{float(dz[y, x]):.3g}")


def hold_band_kernels(seg, torch, spent=None) -> dict:
    """Each kernel's first call of a band segment against its twin on the
    same arguments (K1, K3, K5, K6, K6-f32, K7, K9 bit for bit; K2 ids
    equal and planes within rtol 1e-5, atol 1e-6; K4 as check_k4_k5).
    Returns {wrapper name: mismatches}."""
    from awsm_renderer_tpu_torch.ops.raster import (
        plane_layout, rasterize16_msaa, rasterize16_msaa_reference,
        rasterize16_slim, rasterize16_slim_reference, rasterize_binned,
        rasterize_binned_reference,
    )
    from awsm_renderer_tpu_torch.ops.relayout import (
        gather_split_channels, gather_split_channels_f32,
        gather_split_channels_f32_reference, gather_split_channels_reference,
        onehot_split_rows, onehot_split_rows_reference,
    )
    from awsm_renderer_tpu_torch.ops.shade import (
        RESOLVE_NAMES, resolve_planes_fused, resolve_planes_reference,
        shade_surface_fused, shade_surface_fused_reference,
    )
    from awsm_renderer_tpu_torch.ops.texsample import (
        filter_taps_fused, filter_taps_reference, tap_plan_fused,
        tap_plan_reference,
    )

    bad = {}
    spent = {} if spent is None else spent
    for name, calls in seg.items():
        args, kw = calls[0]
        t0 = time.perf_counter()
        if name == "rasterize16_slim":
            col, depth, bins = rasterize16_slim(*args, **kw)
            ccol, cdep = rasterize16_slim_reference(args[0], bins, **kw)
            n = bit_mismatches(col, ccol, torch) + bit_mismatches(
                depth, cdep, torch)
        elif name == "rasterize16_msaa":
            samp, depth, bins = rasterize16_msaa(*args, **kw)
            rsamp, rdepth = rasterize16_msaa_reference(args[0], bins, **kw)
            n = bit_mismatches(depth, rdepth, torch) + sum(
                bit_mismatches(a, b, torch) for a, b in zip(samp, rsamp))
        elif name == "resolve_planes_fused":
            a = resolve_planes_fused(*args, **kw)
            b = resolve_planes_reference(*args, **kw)
            n = int((a["tri_id"] != b["tri_id"]).sum()) + sum(
                int((~torch.isclose(a[k], b[k], rtol=1e-5, atol=1e-6)).sum())
                for k in RESOLVE_NAMES[1:])
        elif name == "rasterize_binned":
            rows, zlo, zhi = args
            names = plane_layout(kw["has_uv1"], kw["has_color"],
                                 kw["analytic_derivs"])
            a = rasterize_binned(rows, zlo, zhi, **kw)
            b = rasterize_binned_reference(
                rows, zlo, zhi, bins=kw["bins"], width=kw["width"],
                height=kw["height"], names=names)
            n = sum(bit_mismatches(a[k].contiguous(), b[k].contiguous(),
                                   torch) for k in a)
        elif name == "shade_surface_fused":
            n = k14_mismatches(shade_surface_fused(*args, **kw),
                               shade_surface_fused_reference(*args, **kw),
                               torch)[0]
        elif name == "vertex_stage":
            n = k15_mismatches(*k15_pair(args, kw), kw, torch)[0]
        elif name == "tap_plan_fused":
            idx, w = tap_plan_fused(*args, **kw)
            ridx, rw = tap_plan_reference(*args, **kw)
            off = ((idx != ridx) | ((w - rw).abs() > 1e-6).any(0))
            near = lod_near_integer(args, kw, torch)
            # taps whose LOD lies within 1e-5 of an integer may round to
            # either level: fewer than 0.01% of them may differ
            n = int((off & ~near).sum()) + int(
                int((off & near).sum()) >= 1e-4 * idx.shape[0])
        else:
            fn, ref = {
                "onehot_split_rows": (onehot_split_rows,
                                      onehot_split_rows_reference),
                "filter_taps_fused": (filter_taps_fused,
                                      filter_taps_reference),
                "gather_split_channels": (gather_split_channels,
                                          gather_split_channels_reference),
                "gather_split_channels_f32": (
                    gather_split_channels_f32,
                    gather_split_channels_f32_reference)}[name]
            n = bit_mismatches(fn(*args, **kw), ref(*args, **kw), torch)
        bad[name] = n
        spent[name] = spent.get(name, 0.0) + time.perf_counter() - t0
    return bad


def classify_band_ids(ds, masks, spec, tid_b, tid_1, torch):
    """tri_id mismatches between a band assembly and the whole frame:
    classify_mismatches in its rounding mode (an edge value or the two z
    within 4 ulps of their terms: a band's setup constants c + k * offset
    round once more than the frame's) against the opaque setup at the
    raster's scale, then the HUD's at 1x. Returns (mismatch indices,
    counts)."""
    from awsm_renderer_tpu_torch.passes.frame import _pad_to, _run_vertex

    a, b = tid_b.reshape(-1), tid_1.reshape(-1)
    idx = (a != b).nonzero()[:, 0]
    counts = dict(ties=0, rounding=0, unclassified=int(idx.numel()))
    if not idx.numel():
        return idx, counts
    h, w = tid_b.shape
    scale = 2 if (spec.supersample or spec.msaa) else 1
    left = torch.ones(idx.numel(), dtype=torch.bool, device=idx.device)
    for mask, s in ((masks[0], scale), (masks[2], 1)):
        if mask is None or not bool(left.any()):
            continue
        rows = _run_vertex(ds, mask, rw=_pad_to(w * s, 128),
                           rh_full=_pad_to(h * s, 8),
                           needs_clip=spec.needs_clip, pad=True)
        px, py = pixel_centres(h, w, idx.device, torch, step=s)
        sel = idx[left]
        c = classify_mismatches(rows, a[sel], b[sel], px[sel], py[sel],
                                torch, k9=True)
        counts["ties"] += c["ties"]
        counts["rounding"] += c["k9_rounding"]
        left[left.clone()] = c["rest"]
    counts["unclassified"] = int(left.sum())
    return idx, counts


def border_mask(h: int, w: int, grid, rh: int, rw: int, device, torch):
    """(h, w) bool: the pixels of the rows and columns on either side of
    each band or tile boundary of a grid over the padded rh x rw frame."""
    m = torch.zeros((h, w), dtype=torch.bool, device=device)
    for y in range(rh // grid[0], rh, rh // grid[0]):
        m[max(y - 1, 0):y + 1] = True
    for x in range(rw // grid[1], rw, rw // grid[1]):
        m[:, max(x - 1, 0):x + 1] = True
    return m


def hold_sharded(label, r, grid, torch, profile=False) -> dict:
    """The in-process band assembly of r's frame over `grid` against the
    whole frame (render_frame with the same FrameSpec): tri_id mismatches
    classified (0 unclassified), ldr's and depth's max |d| off and on the
    border rows, hand-kernel launches of the bands against the frame's,
    each band's kernels against their twins. Returns the assembly (on the
    host) and the counts."""
    from awsm_renderer_tpu_torch.ops import kernels
    from awsm_renderer_tpu_torch.parallel.sharding import _band_frame
    from awsm_renderer_tpu_torch.passes.frame import render_frame

    t0 = time.perf_counter()
    ds, masks, spec = shard_inputs(r)
    n = grid[0] * grid[1]
    profiled = None
    if profile and DEVICE == "cuda":
        profiled = [device_kernels(f, torch) for f in (
            lambda: _band_frame(ds, *masks, spec, bands=range(n), grid=grid),
            lambda: render_frame(ds, *masks, spec=spec))]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    kernels.reset_launch_counts()
    out, segs = record_band_calls(lambda: _band_frame(
        ds, *masks, spec, bands=range(n), grid=grid))
    torch.cuda.synchronize()
    band_counts = launches_of(kernels)
    band_launches = sum(band_counts.values())
    kernels.reset_launch_counts()
    whole = render_frame(ds, *masks, spec=spec)[:3]
    torch.cuda.synchronize()
    frame_counts = launches_of(kernels)
    frame_launches = sum(frame_counts.values())
    ldr_b, tid_b, dep_b = out
    ldr_1, tid_1, dep_1 = whole
    check(bool(torch.isfinite(ldr_b).all()) and ldr_b.shape == ldr_1.shape,
          f"{label}: the assembled frame is finite, {tuple(ldr_b.shape)}")
    t2 = time.perf_counter()
    idx, c = classify_band_ids(ds, masks, spec, tid_b, tid_1, torch)
    h, w = tid_b.shape
    border = border_mask(h, w, grid, -(-h // 8) * 8, -(-w // 128) * 128,
                         tid_b.device, torch)
    on_border = int(border.reshape(-1)[idx].sum())
    d = (ldr_b - ldr_1).abs().amax(dim=-1)
    dz = (dep_b - dep_1).abs()
    off_b = float(d[~border].max())
    on_b = float(d[border].max()) if bool(border.any()) else 0.0
    shard_diagnose(label, ds, masks, spec, tid_b, tid_1, d, dz, border,
                   torch)
    t3 = time.perf_counter()
    held, spent = {}, {}
    for seg in segs:
        for k, v in hold_band_kernels(seg, torch, spent).items():
            held.setdefault(k, []).append(v)
    t4 = time.perf_counter()
    log(f"  {label}: s: inputs + profile {t1 - t0:.1f}, frames {t2 - t1:.1f},"
        f" ids {t3 - t2:.1f}, twins {t4 - t3:.1f} ("
        + ", ".join(f"{k} {v:.1f}" for k, v in spent.items()) + ")")
    log(f"  {label}: tri_id {idx.numel()} mismatches of {h * w} pixels "
        f"({c['ties']} exact ties, {c['rounding']} edge or z within 4 ulps "
        f"of the shifted setup's rounding, {c['unclassified']} "
        f"unclassified; {on_border} on border rows or columns); ldr max "
        f"|d| {off_b:.3g} off the border rows and columns, {on_b:.3g} on "
        f"them, {int((d > 1e-3).sum())} pixels off by > 1e-3; depth max "
        f"|d| {float(dz.max()):.3g}; hand-kernel launches {band_launches} "
        f"for the {n} bands ({band_launches / n:.1f} a band), "
        f"{frame_launches} for the whole frame ({band_counts} against "
        f"{frame_counts}); twins held on "
        + ", ".join(f"{k} x{len(v)}" for k, v in held.items()))
    check(c["unclassified"] == 0,
          f"{label}: every tri_id mismatch is classified")
    check(all(x == 0 for v in held.values() for x in v),
          f"{label}: every band's kernel calls equal their twins "
          f"({sum(len(v) for v in held.values())} calls held)")
    return dict(out=tuple(x.cpu() for x in out), kernels=set(held),
                launches=(band_launches, frame_launches), off=off_b,
                on=on_b, mismatches=idx.numel(), counts=c,
                depth=float(dz.max()), profiled=profiled)


def scene_checksum(ds, torch):
    """(n,) float64 on the host: sum and sum of |x| of every tensor,
    array and number in the device dict, by sorted key."""
    import numpy as np

    out = []

    def add(v):
        if isinstance(v, dict):
            for k in sorted(v):
                if k != "mat_columns":
                    add(v[k])
        elif isinstance(v, torch.Tensor):
            x = v.detach().double().cpu()
            out.extend([float(x.sum()), float(x.abs().sum())])
        elif isinstance(v, np.ndarray):
            x = v.astype(np.float64)
            out.extend([float(x.sum()), float(np.abs(x).sum())])
        elif isinstance(v, (int, float)):
            out.append(float(v))

    add(ds)
    return torch.tensor(out, dtype=torch.float64)


SHARD_RUNS = (("stress-rows", False, 1), ("stress-tiles", False, 2),
              ("msaa-rows", True, 1))


def shard_rank(rank: int, world: int, port: int, out_dir: str,
               cfg: dict) -> None:
    """One rank of the sharded phase's gloo group on the one card (a
    spawned process; the kernels are the parent's build; cfg: the
    parent's W, H, STRESS_GRID, N_FRAMES and DEVICE): build the stress
    scene from seed 42, show by a checksum all-gather that every rank
    holds the same scene, render the SHARD_RUNS frames through
    render_frame_sharded (rows) and render_frame_sharded_2d (1 x world
    tiles) and save each; on the card, time 12 frames of each (CUDA
    events), its exchanges (synchronized) and count its launches and peak
    memory."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    import awsm_renderer_tpu_torch as P
    from awsm_renderer_tpu_torch.ops import kernels
    from awsm_renderer_tpu_torch.parallel import sharding as S

    globals().update(cfg)
    cuda = DEVICE == "cuda"
    torch.set_num_threads(2)
    if cuda:
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        if cuda:
            kernels.lib()
        meshes = {1: DeviceMesh(DEVICE, list(range(world)),
                                mesh_dim_names=("rows",)),
                  2: DeviceMesh(DEVICE, [list(range(world))],
                                mesh_dim_names=("rows", "cols"))}
        res = {}
        scenes = {}
        for label, effects, dims in SHARD_RUNS:
            if effects not in scenes:
                scenes.clear()
                r, _k, _h = build_stress_scene(P, np, DEVICE,
                                               effects=effects)
                orbit_camera(r, np, 0)
                scenes[effects] = shard_inputs(r)
                sums = scene_checksum(scenes[effects][0], torch)
                got = [torch.empty_like(sums) for _ in range(world)]
                dist.all_gather(got, sums)
                res[f"scene_equal_{int(effects)}"] = all(
                    torch.equal(g, got[0]) for g in got)
            ds, masks, spec = scenes[effects]
            fn = (S.render_frame_sharded if dims == 1
                  else S.render_frame_sharded_2d)
            kw = sharded_kw(fn, spec, masks)

            def frame():
                return fn(meshes[dims], ds, *masks, **kw)

            out = frame()
            torch.save([x.cpu() for x in out],
                       os.path.join(out_dir, f"{label}-{rank}.pt"))
            if cuda:
                res[label] = time_rank_frame(frame, S, kernels, torch)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def time_rank_frame(frame, S, kernels, torch) -> dict:
    """A rank's frame on the card: N_FRAMES frames timed by CUDA events,
    the peak memory over them, one frame's all-gathers timed alone
    (synchronized before, the gathered tensors read after) and one
    frame's hand-kernel launches."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for _ in range(N_FRAMES):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        frame()
        b.record()
        b.synchronize()
        ms.append(a.elapsed_time(b))
    peak = torch.cuda.max_memory_allocated()
    ex = []
    orig = S._all_gather

    def timed(t, group):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        o = orig(t, group)
        for x in o:
            x.sum().item()
        ex.append((time.perf_counter() - t0) * 1e3)
        return o

    S._all_gather = timed
    try:
        frame()
    finally:
        S._all_gather = orig
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    frame()
    torch.cuda.synchronize()
    return dict(ms=ms, peak=peak, exchange_ms=ex,
                launches=launches_of(kernels))


def run_shard_ranks(n: int) -> str:
    """Spawn n ranks of shard_rank over gloo (localhost, a free port) and
    wait for them; every rank must exit 0. Returns their output dir."""
    import multiprocessing
    import shutil
    import socket

    out_dir = os.path.join(REPO, "build", "sharded")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    cfg = dict(W=W, H=H, STRESS_GRID=STRESS_GRID, N_FRAMES=N_FRAMES,
               DEVICE=DEVICE)
    procs = [ctx.Process(target=shard_rank,
                         args=(i, n, port, out_dir, cfg))
             for i in range(n)]
    for p in procs:
        p.start()
    try:
        deadline = time.perf_counter() + SHARD_TIMEOUT
        for p in procs:
            p.join(max(1.0, deadline - time.perf_counter()))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(10)
    codes = [p.exitcode for p in procs]
    check(all(c == 0 for c in codes), f"the {n} gloo ranks exited 0 "
                                      f"(exit codes {codes})")
    return out_dir


def phase_sharded(P, np, torch) -> dict:
    """The multi-GPU frame on the one card. (1) In process: the stress
    frame in SHARD_N row bands, SHARD_N x SHARD_N and 1 x SHARD_N tiles,
    the MSAA + bloom + DoF headline, supersample and the volume + HUD
    variant in SHARD_N row bands, each assembled from every band
    (sharding._band_frame) and held against the whole frame. (2) SHARD_N
    spawned ranks on the card over gloo: the stress rows, the stress 1 x
    SHARD_N tiles and the MSAA rows through the public functions,
    bit-equal to (1)'s assemblies; ms/frame, exchange ms, launches and
    peak memory per rank."""
    from dataclasses import replace

    t0 = time.perf_counter()
    n = SHARD_N
    log(f"phase sharded: {n} row bands and screen tiles at {W}x{H}, every "
        f"band in this process, then {n} gloo ranks on the one card")
    res = {}
    r, _k, _h = build_stress_scene(P, np, DEVICE)
    orbit_camera(r, np, 0)
    log(f"  scene built in {time.perf_counter() - t0:.1f} s")
    for label, grid in (("stress-rows", (n, 1)), ("stress-tiles3x3", (n, n)),
                        ("stress-tiles", (1, n))):
        res[label] = hold_sharded(f"{label} {grid}", r, grid, torch,
                                  profile=label == "stress-rows")
    r.config = replace(r.config, anti_aliasing=P.AntiAliasing(
        supersample=True))
    res["supersample-rows"] = hold_sharded("supersample-rows", r, (n, 1),
                                           torch)
    del r
    r, _k, _h = build_stress_scene(P, np, DEVICE, effects=True)
    orbit_camera(r, np, 0)
    res["msaa-rows"] = hold_sharded("msaa-rows (bloom, DoF)", r, (n, 1),
                                    torch)
    del r
    r, _k, _h = build_stress_scene(P, np, DEVICE, volume=True, hud=True)
    orbit_camera(r, np, 0)
    res["volume-hud-rows"] = hold_sharded("volume-hud-rows", r, (n, 1),
                                          torch)
    del r
    ran = set().union(*(v["kernels"] for v in res.values()))
    check(ran == set(SHARD_PATH), f"the band frames ran every kernel of the "
                                  f"path ({sorted(ran)})")
    t1 = time.perf_counter()
    torch.cuda.empty_cache()
    out_dir = run_shard_ranks(n)
    ranks = []
    for i in range(n):
        with open(os.path.join(out_dir, f"rank{i}.json")) as f:
            ranks.append(json.load(f))
        check(ranks[-1]["scene_equal_0"] and ranks[-1]["scene_equal_1"],
              f"rank {i}: the {n} ranks' scenes have equal checksums")
        for label, _e, _d in SHARD_RUNS:
            got = torch.load(os.path.join(out_dir, f"{label}-{i}.pt"))
            want = res[label]["out"]
            nbad = sum(bit_mismatches(a, b, torch) for a, b in zip(got, want))
            check(nbad == 0, f"rank {i} {label}: the whole frame bit-equal "
                             f"to the in-process assembly")
    t2 = time.perf_counter()
    log(f"  phase sharded: in process {t1 - t0:.1f} s, ranks {t2 - t1:.1f} s")
    res["ranks"] = ranks
    return res


def log_sharded(sh, card: str) -> None:
    """The sharded phase's numbers, each beside the card."""
    for label in ("stress-rows", "stress-tiles3x3", "stress-tiles",
                  "supersample-rows", "msaa-rows", "volume-hud-rows"):
        v = sh[label]
        log(f"sharded {label} (in process): {v['mismatches']} tri_id "
            f"mismatches ({v['counts']}), ldr max |d| {v['off']:.3g} off "
            f"the borders, {v['on']:.3g} on them, depth max |d| "
            f"{v['depth']:.3g}; hand-kernel launches {v['launches'][0]} "
            f"for {SHARD_N if 'x3' not in label else SHARD_N ** 2} bands "
            f"against {v['launches'][1]} for the whole frame ({card})")
    (nb, msb), (n1, ms1) = sh["stress-rows"]["profiled"] or ((None,) * 2,) * 2
    log(f"sharded stress-rows (in process, torch.profiler): "
        f"{nb} CUDA kernels and {msb} device ms for the {SHARD_N} bands "
        f"({'not measured' if nb is None else f'{nb / SHARD_N:.0f}'} a "
        f"band), {n1} kernels and {ms1} device ms for the whole frame "
        f"({card})")
    for i, rk in enumerate(sh["ranks"]):
        for label, _e, _d in SHARD_RUNS:
            v = rk[label]
            ex = v["exchange_ms"]
            log(f"sharded rank {i}/{SHARD_N} {label} (gloo, one card): "
                f"median {statistics.median(v['ms']):.3f} ms/frame (CUDA "
                f"events, {len(v['ms'])} frames, min {min(v['ms']):.3f}, "
                f"max {max(v['ms']):.3f}); {len(ex)} all-gathers a frame, "
                f"{sum(ex):.3f} ms (synchronized: "
                f"{', '.join(f'{x:.3f}' for x in ex)}); "
                f"{sum(v['launches'].values())} hand-kernel launches a "
                f"frame ({v['launches']}); peak {v['peak'] / 2 ** 30:.2f} "
                f"GiB ({card})")


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
    an = phase_animated(P, np, torch, aa["syncs"])
    orc = phase_oracle(P, np, torch, cap_k1, k8_calls, ov.pop("k7_calls"),
                       aa.pop("msaa_in"))
    del cap_k1, k8_calls
    results.update((k, orc[k]) for k in ("K11a_fat", "K11b", "K12", "K13"))
    tm = phase_temporal(P, np, torch)
    results["K10"] = tm["K10"]
    t0 = time.perf_counter()
    li = phase_lights(P, np, torch, ov["syncs_a"])
    t1 = time.perf_counter()
    hk = phase_hooks(P, np, torch)
    log(f"phases lights and hooks: {t1 - t0:.1f} s and "
        f"{time.perf_counter() - t1:.1f} s")
    tl = phase_tools(P, np, torch, ov["syncs_a"])
    h_med, h_wall, h_counts, (h_k4, h_k5, h_k14, h_k15) = phase_gltf(
        P, np, torch)
    phase_golden(P, np, torch)
    sh = phase_sharded(P, np, torch)

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
        f", bound {h_k4['bound'][0]:.4f} ms ({h_k4['bound'][1]})), K5 "
        f"{h_k5['ms']:.4f} ms (twin {h_k5['plain_ms']:.4f}, bound "
        f"{h_k5['bound'][0]:.4f} ms ({h_k5['bound'][1]})) ({card})")
    for k, label in (("K8", "K8 (the stress frame's first peel)"),
                     ("K7", "K7 (the volume + HUD frame's first peel)"),
                     ("K7_nopeel", "K7 without a peel (the HUD)")):
        v = ov[k]
        log(f"{label}: kernel_ms {v['ms']:.4f} ms, host_us {v['host_us']:.1f}"
            f" µs a call, device_ms {v['device_ms']:.4f} ms, bound "
            f"{v['bound'][0]:.4f} ms ({v['bound'][1]}); {v['regs']} "
            f"registers, {v['ctas_per_sm']} CTAs an SM, {v['waves']} waves; "
            f"{v['cull']} tests left by the warps' cull ({card})")
    a_med, a_wall, a_counts = aa["frames"]
    for v, label, n in (
            (results["K14_panes"], "the stress frame's panes", None),
            (aa["K14_msaa"], "the MSAA frame's compacted opaque shade",
             a_counts["shade_surface_fused"]),
            (aa["K14_msaa_panes"], "the MSAA frame's panes", None),
            (h_k14, "the helmet", h_counts["shade_surface_fused"])):
        log(f"K14 on {label}: kernel_ms {v['ms']:.4f} ms, twin "
            f"{v['plain_ms']:.4f} ms, bound {v['bound'][0]:.4f} ms "
            f"({v['bound'][1]}), share {100 * v['bound'][0] / v['ms']:.1f}%"
            f"{'' if n is None else f', {n} launches over {N_FRAMES} frames'}"
            f" ({card})")
    for v, label, n in (
            (results["K15"], "the stress frame's opaque pass",
             counts["vertex_stage"]),
            (results["K15_panes"], "the stress frame's panes", None),
            (aa["K15_msaa"], "the MSAA frame's opaque pass",
             a_counts["vertex_stage"]),
            (aa["K15_msaa_panes"], "the MSAA frame's panes", None),
            (an["K15_pool"], "the animated frame's whole pool",
             an["animated"][2]["vertex_stage"]),
            (an["K15_subset"], "the animated frame's morphed and skinned "
                               "subset", None),
            (h_k15, "the helmet", h_counts["vertex_stage"])):
        log(f"K15 on {label}: kernel_ms {v['ms']:.4f} ms, twin "
            f"{v['plain_ms']:.4f} ms, bound {v['bound'][0]:.4f} ms "
            f"({v['bound'][1]}), share "
            f"{100 * v['bound'][0] / v['ms']:.1f}%, {v['rows']} rows from "
            f"{v['tris']} triangles"
            f"{'' if n is None else f', {n} launches over {N_FRAMES} frames'}"
            f" ({card})")
    log(f"frame Stress-1080p-msaa-bloom-dof: median {a_med:.3f} ms/frame "
        f"(CUDA events), host wall {a_wall:.3f} ms/frame, {aa['syncs']} host"
        f" syncs/frame, at {W}x{H} ({card})")
    for label in ("static", "animated"):
        m_, w_, c_ = an[label]
        log(f"frame Stress-1080p-animated-msaa-bloom-dof, {label}: median "
            f"{m_:.3f} ms/frame (CUDA events), host wall {w_:.3f} ms/frame, "
            f"{sum(c_.values())} kernel launches over {N_FRAMES} frames, at "
            f"{W}x{H} ({card})")
    log(f"frame Stress-1080p-animated-msaa-bloom-dof: {an['syncs']} host "
        f"syncs/frame with update_all before each frame, {an['players']} "
        f"players, {an['n_anim']} triangles in the animated subset, split "
        f"vs whole-pool max relative error {an['split_err']:.3g} ({card})")
    t_med, t_wall, t_counts = tm["frames"]
    log(f"frame Stress-1080p-temporal-orbit: median {t_med:.3f} ms/frame "
        f"(CUDA events), host wall {t_wall:.3f} ms/frame, {tm['syncs']} "
        f"host syncs/frame, over {TEMPORAL_FRAMES} orbit frames at {W}x{H} "
        f"({card})")
    for label in ("tiled", "dense"):
        m_, w_, n_k, d_ms = li[label]
        log(f"frame Stress-1080p-64-lights, {label}: median {m_:.3f} "
            f"ms/frame (CUDA events), host wall {w_:.3f} ms/frame, "
            f"{'not measured' if n_k is None else f'{n_k:.0f}'} kernels a "
            f"frame, device "
            f"{'not measured' if d_ms is None else f'{d_ms:.3f}'} ms a frame "
            f"(profiler), at {W}x{H} ({card})")
    log(f"frame Stress-1080p-64-lights: {li['syncs']} host syncs/frame "
        f"(tiled); lists mean/max/overflowing units/units per shade "
        f"{li['lists']}; cull_lights(1x128) mean/max/agreeing/tiles "
        f"{li['cull']}; tiled vs dense max |d| {li['err'][0]:.3g} off "
        f"overflow, {li['err'][1]:.3g} on {li['err'][2]} overflow pixels "
        f"({card})")
    log(f"frame Stress-1080p-ibl-tex with hooks: median "
        f"{hk['hooks'][0]:.3f} ms/frame (host wall {hk['hooks'][1]:.3f}), "
        f"hookless {hk['hookless'][0]:.3f} (host wall "
        f"{hk['hookless'][1]:.3f}); extra_geometry_pass {hk['pass'][2]} "
        f"triangles {hk['pass'][0]:.3f} ms, "
        f"{hk['pass'][0] / hk['pass'][2]:.4f} ms a triangle, at {W}x{H} "
        f"({card})")
    for on, m_, w_, n_s, _sites, c_ in tl["steps"]:
        log(f"session step Stress-1080p-ibl-tex (editor, gizmo attached, "
            f"grid hidden), timings {'on' if on else 'off'}: median "
            f"{m_:.3f} ms/step (CUDA events), host wall {w_:.3f} ms/step, "
            f"{n_s:g} host syncs/step, "
            f"{sum(c_.values()) / N_FRAMES:g} hand-kernel launches/step "
            f"({c_}), over {N_FRAMES} steps at {W}x{H} ({card})")
    n_k, d_ms = tl["kernels"]
    log(f"session step: "
        f"{'not measured' if n_k is None else f'{n_k:.0f}'} kernels a step, "
        f"device {'not measured' if d_ms is None else f'{d_ms:.3f}'} ms a "
        f"step (profiler) ({card})")
    log(f"session pointer-down step: {tl['down_syncs']} host syncs; spans "
        f"a step, host ms / device ms: " + ", ".join(
            f"{k} {h_:.3f} / {d_:.3f}" for k, (h_, d_) in tl["spans"].items())
        + f" ({card})")
    log(f"host work a frame gains: _log_retrace {tl['host_us'][0]:.1f} µs,"
        f" a span with timings off {tl['host_us'][1]:.2f} µs ({card})")
    log(f"first bloom frame: cold (a fresh renderer) {tl['cold'][0]:.3f} ms "
        f"(CUDA events), {tl['cold'][1]:.3f} ms host wall; after warmup "
        f"{tl['warm'][0]:.3f} ms, {tl['warm'][1]:.3f} ms host wall ({card})")
    rep, peak = tl["compat"]
    log(f"check_compatibility: {rep.device_kind}, {rep.hbm_bytes / 2**30:.2f}"
        f" GiB, scene {rep.scene_bytes / 2**20:.1f} MiB, framebuffers "
        f"{rep.framebuffer_bytes / 2**20:.1f} MiB, ok {rep.ok}; the stress "
        f"step's peak allocated {peak / 2**20:.1f} MiB ({card})")
    lut_ms, lut_wall, lut_err, lut_err0, lut_mean = tl["lut"]
    log(f"generate_brdf_lut(256, 512): {lut_ms:.3f} ms (CUDA events), "
        f"{lut_wall:.3f} ms host wall; against the CPU max |d| "
        f"{lut_err:.3g} off NdotV column 0, {lut_err0:.3g} on it, mean "
        f"{lut_mean:.3g} ({card})")
    for label in ("supersample", "smaa"):
        ms, peak = aa[label]
        log(f"frame Stress-1080p-ibl-tex + {label}: median {ms:.3f} ms/frame"
            f", peak device memory {peak:.2f} GiB, at {W}x{H} ({card})")
    for label, v in aa["K2_msaa"].items():
        log(f"K2 [{label}] entry: kernel {v['ms']:.4f} ms, twin "
            f"{v['plain_ms']:.4f} ms ({card})")
    for key, label in (("K11a_fat", "K11a fat on the stress frame's setup"),
                       ("K11a_slim", "K11a slim on the MSAA frame's setup "
                                     "at 2x"),
                       ("K11b", "K11b on the volume + HUD frame's peel 0")):
        v = orc[key]
        log(f"{label}: kernel {v['ms']:.4f} ms, device {v['device_ms']:.4f}"
            f" ms, host {v['host_us']:.1f} us, twin {v['plain_ms']:.4f} ms, "
            f"bound {v['bound'][0]:.4f} ms ({v['bound'][1]}), "
            f"{v['regs']} registers, {v['ctas_per_sm']} CTAs an SM, "
            f"{v['waves']} waves ({card})")
    for k, v in orc["summary"].items():
        log(f"oracle vs {k}: {v['n']} pixels compared, {v['mismatches']} "
            f"tri_id mismatches: {v['ties']} exact depth ties, "
            f"{v['k9_rounding']} K9 sample-rounding flips, "
            f"{v['unclassified']} unclassified")
    log(f"phase oracle: {orc['seconds']:.1f} s ({card})")
    log_sharded(sh, card)
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
        "K14": ("shade_surface_fused", "awsm_renderer_tpu_torch/csrc/shade.cu",
                "none: XLA fused the reference's shade math"),
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
