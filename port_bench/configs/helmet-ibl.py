"""helmet-ibl: a glTF asset at DamagedHelmet's sizes through the
program's glTF ingest (load_gltf + populate_gltf), five texture slots a
pixel, image-based light only, no MSAA and no effects. The seed draws
the maps' scratches and panel tint; sizes come from helmet-ibl.json."""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import _glb  # noqa: E402
import _shapes  # noqa: E402

from port_bench.scene import Material, Mesh, Scene, Texture  # noqa: E402

F = np.float32


def build_scene(cfg: dict, seed: int) -> Scene:
    geo, maps = _glb.helmet(cfg, seed)
    kinds = (("base", True, "color"), ("mr", False, "mr"),
             ("normal", False, "normal"), ("occlusion", False, "scalar"),
             ("emissive", True, "color"))
    textures = [Texture(m, srgb=s, kind=k) for m, (_, s, k) in zip(maps, kinds)]
    mat = Material(base_color=np.ones(4, F), metallic=1.0, roughness=1.0,
                   emissive=np.ones(3, F),
                   textures={slot: i for i, (slot, _, _) in enumerate(kinds)})
    return Scene(meshes=[Mesh(**geo, world=np.eye(4, dtype=F), material=0)],
                 materials=[mat], textures=textures, lights=[],
                 env_equirect=_shapes.sky_equirect(),
                 env_size=cfg["env_size"], settings=dict(cfg["render"]),
                 camera=dict(cfg["camera"]),
                 meta={"glb": lambda: _glb.helmet_glb(geo, maps)})


def load_program(scene: Scene, device, workdir: str):
    """The asset as a GLB file through load_gltf + populate_gltf."""
    import awsm_renderer_tpu_torch as P

    from port_bench import program

    path = os.path.join(workdir, "helmet-ibl.glb")
    with open(path, "wb") as f:
        f.write(scene.meta["glb"]())
    try:
        r = program.renderer(scene.settings, device)
        P.populate_gltf(r, P.load_gltf(path))
    finally:
        os.remove(path)
    program.add_lights_and_env(r, scene)
    return r
