"""Hands a scene description to the system under test through its public
API (the renderer facade and its stores). The only module of the
benchmark, besides the configurations' own loaders, that builds the
program's objects."""

from __future__ import annotations

import numpy as np

_KINDS = {"color": "COLOR", "normal": "NORMAL", "mr": "METALLIC_ROUGHNESS",
          "scalar": "SCALAR"}
_SLOTS = {"base": "TS_BASE_COLOR", "mr": "TS_METALLIC_ROUGHNESS",
          "normal": "TS_NORMAL", "occlusion": "TS_OCCLUSION",
          "emissive": "TS_EMISSIVE"}


def renderer(settings: dict, device):
    """An empty renderer configured by a configuration's "render" group."""
    import awsm_renderer_tpu_torch as P

    st = settings
    r = P.AwsmRendererTorch(P.RendererConfig(
        width=int(st["width"]), height=int(st["height"]),
        post_processing=P.PostProcessing(
            bloom=bool(st.get("bloom")), dof=bool(st.get("dof")),
            tonemapping=P.ToneMapping(st.get("tonemap",
                                             "khronos_pbr_neutral"))),
        anti_aliasing=P.AntiAliasing(msaa=bool(st.get("msaa")),
                                     mipmap=bool(st.get("mipmap", True))),
        max_transparent_layers=int(st.get("max_transparent_layers", 4))),
        device=device)
    if st.get("dof"):
        r.camera.dof.focus_distance = float(st["dof_focus"])
        r.camera.dof.aperture = float(st["dof_aperture"])
    return r


def add_lights_and_env(r, scene) -> None:
    import awsm_renderer_tpu_torch as P

    for L in scene.lights:
        if L.kind == "directional":
            r.lights.insert(P.Light.directional(L.direction, color=L.color,
                                                intensity=L.intensity))
        else:
            r.lights.insert(P.Light.point(L.position, color=L.color,
                                          intensity=L.intensity,
                                          range=L.range))
    r.environment.set_environment_from_equirect(scene.env_equirect,
                                                size=scene.env_size)


def load(scene, device):
    """Build the scene through the stores: one texture per image, one
    material each, one resource per distinct geometry, one transform and
    mesh per instance (translation-only world matrices)."""
    import awsm_renderer_tpu_torch as P
    from awsm_renderer_tpu_torch.core import materials as M
    from awsm_renderer_tpu_torch.core.textures import MipmapKind

    r = renderer(scene.settings, device)
    tex_rows = [r.textures.row_of(r.textures.add_image(
        t.image, srgb=t.srgb, kind=getattr(MipmapKind, _KINDS[t.kind])))
        for t in scene.textures]
    mats = []
    for m in scene.materials:
        key = r.materials.insert(P.PbrMaterial(
            base_color_factor=np.asarray(m.base_color, np.float32),
            metallic_factor=float(m.metallic),
            roughness_factor=float(m.roughness),
            emissive_factor=np.asarray(m.emissive, np.float32),
            occlusion_strength=float(m.occlusion_strength),
            normal_scale=float(m.normal_scale),
            alpha_mode=(P.AlphaMode.BLEND if m.alpha_mode == "blend"
                        else P.AlphaMode.OPAQUE),
            textures={getattr(M, _SLOTS[s]): P.TextureRef(tex_rows[i])
                      for s, i in m.textures.items()}))
        mats.append(key)
    resources = {}
    for mesh in scene.meshes:
        world = np.asarray(mesh.world, np.float32)
        if not np.allclose(world[:3, :3], np.eye(3)):
            raise ValueError("program.load takes translation-only meshes")
        rk = resources.get(id(mesh.positions))
        if rk is None:
            rk = r.meshes.insert_resource(P.MeshGeometry(
                positions=mesh.positions, indices=mesh.indices,
                normals=mesh.normals, tangents=mesh.tangents, uv0=mesh.uv0))
            resources[id(mesh.positions)] = rk
        tk = r.transforms.insert(P.Transform(translation=world[:3, 3]))
        r.transforms.update_world()
        mk = mats[mesh.material]
        r.meshes.insert(rk, r.transforms.row_of(tk), r.materials.row_of(mk),
                        tk, mk, transparent=mesh.transparent,
                        double_sided=mesh.double_sided)
    r.meshes.update_world(r.transforms)
    add_lights_and_env(r, scene)
    return r
