"""Procedural scene catalog — stand-ins for the Khronos glTF sample models.

Port of demo/scenes.py: the same scenes, built with the port's classes.

The reference frontend enumerates ~80 sample assets as progressive feature
probes (frontend/src/models/collections.rs:32-123, sets Standard /
Animation / Basics / Extensions). This environment has no network access,
so the same probe matrix is generated procedurally; real .gltf/.glb files
load through `--gltf PATH` in the demo app.
"""

from __future__ import annotations

import numpy as np

from awsm_renderer_tpu_torch import (
    AlphaMode, AnimationChannel, AnimationClip, AnimationPlayer,
    AnimationSampler, AwsmRendererTorch, Light, PbrMaterial, TargetPath,
    Transform, UnlitMaterial,
)
from awsm_renderer_tpu_torch.core.materials import TS_BASE_COLOR, TextureRef
from awsm_renderer_tpu_torch.geometry import (
    box, checker_texture, plane, triangle, uv_sphere,
)

F = np.float32


def _default_light(r):
    r.lights.insert(Light.directional([-0.5, -1.0, -0.3], intensity=2.5))


def scene_triangle(r: AwsmRendererTorch):
    """Basics/Triangle."""
    mat = r.materials.insert(UnlitMaterial(base_color_factor=np.array([1, 0.4, 0.1, 1], F)))
    r.add_mesh(triangle(), mat, transform=Transform(translation=np.array([-0.5, -0.5, 0], F)))
    return {"camera": ([0, 0, 2.2], [0, 0, 0])}


def scene_box(r: AwsmRendererTorch):
    """Basics/Box."""
    mat = r.materials.insert(PbrMaterial(
        base_color_factor=np.array([0.7, 0.2, 0.2, 1], F), roughness_factor=0.5))
    r.add_mesh(box(), mat)
    _default_light(r)
    return {"camera": ([1.5, 1.2, 2.2], [0, 0, 0])}


def scene_box_textured(r: AwsmRendererTorch):
    """Basics/BoxTextured."""
    tex = r.textures.add_image(checker_texture(128, 8), srgb=True)
    mat = r.materials.insert(PbrMaterial(
        roughness_factor=0.7,
        textures={TS_BASE_COLOR: TextureRef(r.textures.row_of(tex))}))
    r.add_mesh(box(), mat)
    _default_light(r)
    return {"camera": ([1.5, 1.2, 2.2], [0, 0, 0])}


def scene_metal_rough_spheres(r: AwsmRendererTorch):
    """Basics/MetalRoughSpheres: 5x5 grid sweeping metallic x roughness."""
    n = 5
    for i in range(n):
        for j in range(n):
            mat = r.materials.insert(PbrMaterial(
                base_color_factor=np.array([0.8, 0.6, 0.2, 1], F),
                metallic_factor=i / (n - 1), roughness_factor=max(j / (n - 1), 0.05)))
            r.add_mesh(uv_sphere(0.4), mat, transform=Transform(
                translation=np.array([(j - n // 2) * 1.1, (i - n // 2) * 1.1, 0], F)))
    _default_light(r)
    return {"camera": ([0, 0, 7.5], [0, 0, 0])}


def scene_morph_cube(r: AwsmRendererTorch):
    """Animation/AnimatedMorphCube: morph target driven by a looping clip."""
    geo = box()
    # target: stretch +y
    deltas = np.zeros((1, geo.vertex_count, 3), F)
    deltas[0, :, 1] = np.where(geo.positions[:, 1] > 0, 1.0, 0.0)
    geo.morph_positions = deltas
    mat = r.materials.insert(PbrMaterial(base_color_factor=np.array([0.3, 0.5, 0.9, 1], F)))
    key = r.add_mesh(geo, mat)
    sampler = AnimationSampler(times=[0, 1, 2], values=[[0.0], [1.0], [0.0]])
    clip = AnimationClip([AnimationChannel(sampler, TargetPath.WEIGHTS, mesh_key=key)])
    r.animations.insert(AnimationPlayer(clip))
    _default_light(r)
    return {"camera": ([2, 1.5, 3], [0, 0.3, 0])}


def scene_rigged_simple(r: AwsmRendererTorch):
    """Animation/SimpleSkin-style: a 2-joint skinned column that bends."""
    from awsm_renderer_tpu_torch.core.meshes import MeshGeometry

    h, seg = 2.0, 8
    ys = np.linspace(0, h, seg + 1)
    pos, idx = [], []
    for yi, y in enumerate(ys):
        pos += [[-0.25, y, 0], [0.25, y, 0]]
        if yi:
            a = (yi - 1) * 2
            idx += [[a, a + 1, a + 2], [a + 2, a + 1, a + 3]]
    pos = np.array(pos, F)
    V = len(pos)
    w1 = np.clip(pos[:, 1] / h, 0, 1)
    joints = np.zeros((V, 4), np.int32)
    joints[:, 1] = 1
    weights = np.zeros((V, 4), F)
    weights[:, 0] = 1 - w1
    weights[:, 1] = w1
    geo = MeshGeometry(
        positions=pos, indices=np.array(idx, np.int32),
        normals=np.tile(np.array([[0, 0, 1]], F), (V, 1)),
        joints=joints, weights=weights)

    j0 = r.transforms.insert(Transform())
    j1 = r.transforms.insert(Transform(translation=np.array([0, h / 2, 0], F)), parent=j0)
    r.transforms.update_world()
    ibm = np.stack([np.eye(4, dtype=F)] * 2)
    ibm[1, 1, 3] = -h / 2
    skin = r.skins.insert([j0, j1], ibm)
    mat = r.materials.insert(PbrMaterial(
        base_color_factor=np.array([0.9, 0.6, 0.3, 1], F), double_sided=True))
    r.add_mesh(geo, mat, skin_key=skin)

    from awsm_renderer_tpu_torch.utils import math3d as m3

    q0 = m3.quat_identity()
    q1 = m3.quat_from_axis_angle([0, 0, 1], np.pi / 3)
    sampler = AnimationSampler(times=[0, 1, 2], values=[q0, q1, q0])
    clip = AnimationClip([AnimationChannel(sampler, TargetPath.ROTATION, transform_key=j1)])
    r.animations.insert(AnimationPlayer(clip))
    _default_light(r)
    return {"camera": ([1.5, 1.4, 3.5], [0, 1, 0])}


def scene_alpha_blend(r: AwsmRendererTorch):
    """Standard/AlphaBlendModeTest: opaque + mask + blend side by side."""
    img = np.zeros((32, 32, 4), np.uint8)
    img[:, :, :3] = 200
    img[:, :, 3] = 255
    img[8:24, 8:24] = [80, 220, 80, 100]
    tex = r.textures.add_image(img, srgb=True)
    ref = TextureRef(r.textures.row_of(tex))
    modes = [AlphaMode.OPAQUE, AlphaMode.MASK, AlphaMode.BLEND]
    for i, mode in enumerate(modes):
        mat = r.materials.insert(UnlitMaterial(
            alpha_mode=mode, textures={TS_BASE_COLOR: ref}))
        r.add_mesh(box(0.8), mat, transform=Transform(
            translation=np.array([(i - 1) * 1.2, 0, 0], F)))
    back = r.materials.insert(UnlitMaterial(base_color_factor=np.array([0.9, 0.2, 0.2, 1], F)))
    r.add_mesh(plane(6), back, transform=Transform(
        translation=np.array([0, 0, -1.5], F),
        rotation=np.array([0.7071, 0, 0, 0.7071], F)))
    return {"camera": ([0, 0.6, 3.5], [0, 0, 0])}


def scene_env_ibl(r: AwsmRendererTorch):
    """Extensions/EnvironmentTest-style: metal/rough spheres under an
    image environment (equirect -> cubemap -> prefiltered IBL + skybox)."""
    eq = np.zeros((32, 64, 3), F)
    v = np.linspace(0, 1, 32)[:, None]
    eq[..., 0] = 0.2 + 0.8 * v
    eq[..., 1] = 0.3 + 0.25 * v
    eq[..., 2] = 1.0 - 0.8 * v
    r.environment.set_environment_from_equirect(eq, size=32)
    mirror = r.materials.insert(PbrMaterial(
        base_color_factor=np.array([1, 1, 1, 1], F),
        metallic_factor=1.0, roughness_factor=0.08))
    rough = r.materials.insert(PbrMaterial(
        base_color_factor=np.array([0.9, 0.9, 0.9, 1], F),
        metallic_factor=1.0, roughness_factor=0.7))
    r.add_mesh(uv_sphere(0.55), mirror, transform=Transform(
        translation=np.array([-0.75, 0, 0], F)))
    r.add_mesh(uv_sphere(0.55), rough, transform=Transform(
        translation=np.array([0.75, 0, 0], F)))
    _default_light(r)
    return {"camera": ([0, 0.3, 3.0], [0, 0, 0])}


def scene_instanced(r: AwsmRendererTorch):
    """Extensions/SimpleInstancing: one box resource, a ring of instances."""
    mat = r.materials.insert(PbrMaterial(
        base_color_factor=np.array([0.4, 0.7, 0.9, 1], F), roughness_factor=0.5))
    transforms = []
    for i in range(12):
        a = 2 * np.pi * i / 12
        transforms.append(Transform(
            translation=np.array([np.cos(a) * 2.2, 0, np.sin(a) * 2.2], F)))
    r.add_instanced_mesh(box(0.5), mat, transforms)
    _default_light(r)
    return {"camera": ([0, 3.5, 5.0], [0, 0, 0])}


SCENES = {
    "triangle": scene_triangle,
    "box": scene_box,
    "box-textured": scene_box_textured,
    "metal-rough-spheres": scene_metal_rough_spheres,
    "morph-cube": scene_morph_cube,
    "rigged-simple": scene_rigged_simple,
    "alpha-blend": scene_alpha_blend,
    "instanced": scene_instanced,
    "env-ibl": scene_env_ibl,
}
