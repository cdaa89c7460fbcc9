"""colonnade-msaa: the renderer's headline frame (MSAA-4x with mipmaps,
bloom, depth of field) on a procedural colonnade of 259,548 triangles,
built from the seed. The seed draws colours, roughness, metalness,
heights and light colours; every size, count and setting comes from
colonnade-msaa.json and never from the seed."""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import _shapes  # noqa: E402

from port_bench.scene import (  # noqa: E402
    Light, Material, Mesh, Scene, Texture, translation,
)

F = np.float32


def build_scene(cfg: dict, seed: int) -> Scene:
    rng = np.random.default_rng(seed)
    ck = cfg["checker"]
    textures = [Texture(_shapes.checker(
        ck["size"], c, tuple(rng.integers(100, 255, 3)),
        tuple(rng.integers(0, 80, 3))), srgb=True, kind="color")
        for c in ck["cells"]]
    materials = [Material(
        base_color=np.array([*rng.uniform(0.3, 1.0, 3), 1.0], F),
        metallic=float(rng.uniform(0, 1)),
        roughness=float(rng.uniform(0.2, 0.9)),
        textures={"base": i % len(textures)})
        for i in range(cfg["materials"])]
    materials.append(Material(base_color=np.array([0.4, 0.7, 0.9, 0.4], F),
                              metallic=0.0, roughness=0.1,
                              alpha_mode="blend"))
    glass = len(materials) - 1
    sp = cfg["sphere"]
    box = _shapes.box(cfg["box_size"])
    sph = _shapes.uv_sphere(sp["radius"], sp["rings"], sp["sectors"])
    pn = cfg["panes"]
    pane = _shapes.box(pn["size"])
    g, s = cfg["grid"], cfg["spacing"]
    meshes = []
    for gx in range(-g, g + 1):
        for gz in range(-g, g + 1):
            geo = box if (gx + gz) % 2 == 0 else sph
            meshes.append(Mesh(**geo, world=translation(
                [gx * s, float(rng.uniform(-0.3, 0.3)), gz * s]),
                material=(gx * (2 * g + 1) + gz) % cfg["materials"]))
    for i in range(pn["count"]):
        a = 2 * np.pi * i / pn["count"]
        meshes.append(Mesh(**pane, world=translation(
            [np.cos(a) * pn["ring_radius"], pn["height"],
             np.sin(a) * pn["ring_radius"]]), material=glass,
            transparent=True))
    sun = cfg["sun"]
    d = np.asarray(sun["direction"], F)
    lights = [Light("directional", np.ones(3, F), sun["intensity"],
                    direction=(d / np.linalg.norm(d)).astype(F))]
    pl = cfg["point_lights"]
    for i in range(pl["count"]):
        lights.append(Light(
            "point", rng.uniform(0.4, 1, 3).astype(F), pl["intensity"],
            position=np.array([np.cos(i) * pl["ring_radius"], pl["height"],
                               np.sin(i) * pl["ring_radius"]], F),
            range=pl["range"]))
    return Scene(meshes=meshes, materials=materials, textures=textures,
                 lights=lights, env_equirect=_shapes.sky_equirect(),
                 env_size=cfg["env_size"], settings=dict(cfg["render"]),
                 camera=dict(cfg["camera"]))
