"""Populate renderer stores from a parsed glTF document.

Port of the reference's population pipeline (crates/renderer/src/gltf/
populate.rs:145-208 — 5 passes over scene nodes: transforms →
EXT_mesh_gpu_instancing → skins → animations → meshes; populate/material.rs
maps glTF PBR + all KHR extensions; populate/mesh.rs inserts primitives).
Returns key lookups like the reference's GltfKeyLookups.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.materials import (
    AlphaMode, PbrMaterial, TextureRef, UnlitMaterial,
    TS_BASE_COLOR, TS_METALLIC_ROUGHNESS, TS_NORMAL, TS_OCCLUSION, TS_EMISSIVE,
    TS_CLEARCOAT, TS_CLEARCOAT_ROUGHNESS, TS_CLEARCOAT_NORMAL,
    TS_SHEEN_COLOR, TS_SHEEN_ROUGHNESS, TS_TRANSMISSION, TS_THICKNESS,
    TS_SPECULAR, TS_SPECULAR_COLOR, TS_IRIDESCENCE, TS_IRIDESCENCE_THICKNESS,
    TS_ANISOTROPY,
)
from ..core.meshes import MeshGeometry
from ..core.animation import (
    AnimationChannel, AnimationClip, AnimationPlayer, AnimationSampler,
    Interpolation, TargetPath,
)
from ..core.textures import (
    MipmapKind, Sampler, WRAP_CLAMP, WRAP_MIRROR, WRAP_REPEAT,
)
from ..core.transforms import Transform
from ..errors import GltfError
from ..utils import math3d as m3
from .accessors import read_accessor, triangulate
from .loader import GltfData
from .tangents import flat_normals, generate_tangents

F = np.float32

_WRAP_MAP = {10497: WRAP_REPEAT, 33071: WRAP_CLAMP, 33648: WRAP_MIRROR}


@dataclass
class GltfKeyLookups:
    """Reference: gltf/populate.rs:38-46."""

    node_transforms: Dict[int, int] = field(default_factory=dict)
    node_meshes: Dict[int, List[int]] = field(default_factory=dict)
    mesh_primitives: Dict[Tuple[int, int], List[int]] = field(default_factory=dict)
    animation_players: List[int] = field(default_factory=list)
    material_keys: Dict[int, int] = field(default_factory=dict)
    light_keys: Dict[int, int] = field(default_factory=dict)      # node -> LightKey
    cameras: Dict[int, dict] = field(default_factory=dict)        # node -> camera params


class _TextureCache:
    """glTF texture index → renderer texture key, deduped by (index, srgb,
    kind) — the reference dedups pool entries per image the same way."""

    def __init__(self, renderer, data: GltfData):
        self.r = renderer
        self.data = data
        self.cache: Dict[Tuple[int, bool, int], int] = {}

    def get(self, tex_info: Optional[dict], srgb: bool, kind: MipmapKind) -> Optional[TextureRef]:
        if not tex_info:
            return None
        tex_index = tex_info.get("index")
        textures = self.data.gltf.get("textures", [])
        if tex_index is None or not 0 <= tex_index < len(textures):
            raise GltfError(
                f"texture reference index {tex_index} out of range "
                f"(document has {len(textures)} textures)")
        tex = textures[tex_index]
        img_index = tex.get("source")
        if img_index is None:
            return None
        if not 0 <= img_index < len(self.data.images):
            raise GltfError(
                f"texture {tex_index} references image {img_index}, but the "
                f"document has {len(self.data.images)} images")
        ck = (tex_index, srgb, kind.value)
        if ck not in self.cache:
            samplers = self.data.gltf.get("samplers", [])
            if "sampler" in tex and not 0 <= tex["sampler"] < len(samplers):
                raise GltfError(
                    f"texture {tex_index} references sampler "
                    f"{tex['sampler']}, but the document has "
                    f"{len(samplers)} samplers")
            s = samplers[tex["sampler"]] if "sampler" in tex else {}
            sampler = Sampler(
                wrap_s=_WRAP_MAP.get(s.get("wrapS", 10497), WRAP_REPEAT),
                wrap_t=_WRAP_MAP.get(s.get("wrapT", 10497), WRAP_REPEAT),
                filter_linear=s.get("magFilter", 9729) != 9728,
                mip_filter_linear=s.get("minFilter", 9987) in (9987, 9985, 9729),
            )
            key = self.r.textures.add_image(
                self.data.images[img_index], srgb=srgb, sampler=sampler, kind=kind
            )
            self.cache[ck] = self.r.textures.row_of(key)
        row = self.cache[ck]

        transform_id = -1
        ext = tex_info.get("extensions", {}).get("KHR_texture_transform")
        if ext:
            tk = self.r.textures.add_texture_transform(
                offset=ext.get("offset", [0, 0]),
                rotation=ext.get("rotation", 0.0),
                scale=ext.get("scale", [1, 1]),
            )
            transform_id = self.r.textures.transform_row_of(tk)
        return TextureRef(row, uv_set=tex_info.get("texCoord", 0), transform_id=transform_id)


def _convert_material(renderer, data: GltfData, mat_index: Optional[int],
                      tex_cache: _TextureCache):
    """glTF material (+ extensions) → PbrMaterial/UnlitMaterial.

    Reference: gltf/populate/material.rs (981 LoC)."""
    mats = data.gltf.get("materials", [])
    if mat_index is not None and not 0 <= mat_index < len(mats):
        raise GltfError(
            f"primitive references material {mat_index}, but the document "
            f"has {len(mats)} materials")
    gm = mats[mat_index] if mat_index is not None else {}
    ext = gm.get("extensions", {})
    textures: Dict[int, TextureRef] = {}

    def put(slot, ref):
        if ref is not None:
            textures[slot] = ref

    try:
        alpha_mode = {"OPAQUE": AlphaMode.OPAQUE, "MASK": AlphaMode.MASK,
                      "BLEND": AlphaMode.BLEND}[gm.get("alphaMode", "OPAQUE")]
    except KeyError:
        raise GltfError(
            f"unknown alphaMode {gm.get('alphaMode')!r}") from None

    pbr = gm.get("pbrMetallicRoughness", {})
    put(TS_BASE_COLOR, tex_cache.get(pbr.get("baseColorTexture"), True, MipmapKind.ALBEDO))

    if "KHR_materials_unlit" in ext:
        mat = UnlitMaterial(
            base_color_factor=np.array(pbr.get("baseColorFactor", [1, 1, 1, 1]), F),
            alpha_mode=alpha_mode,
            alpha_cutoff=gm.get("alphaCutoff", 0.5),
            double_sided=gm.get("doubleSided", False),
            textures=textures,
        )
        return renderer.materials.insert(mat)

    put(TS_METALLIC_ROUGHNESS,
        tex_cache.get(pbr.get("metallicRoughnessTexture"), False, MipmapKind.METALLIC_ROUGHNESS))
    put(TS_NORMAL, tex_cache.get(gm.get("normalTexture"), False, MipmapKind.NORMAL))
    put(TS_OCCLUSION, tex_cache.get(gm.get("occlusionTexture"), False, MipmapKind.OCCLUSION))
    put(TS_EMISSIVE, tex_cache.get(gm.get("emissiveTexture"), True, MipmapKind.EMISSIVE))

    kw = dict(
        base_color_factor=np.array(pbr.get("baseColorFactor", [1, 1, 1, 1]), F),
        metallic_factor=pbr.get("metallicFactor", 1.0),
        roughness_factor=pbr.get("roughnessFactor", 1.0),
        normal_scale=gm.get("normalTexture", {}).get("scale", 1.0),
        occlusion_strength=gm.get("occlusionTexture", {}).get("strength", 1.0),
        emissive_factor=np.array(gm.get("emissiveFactor", [0, 0, 0]), F),
        alpha_mode=alpha_mode,
        alpha_cutoff=gm.get("alphaCutoff", 0.5),
        double_sided=gm.get("doubleSided", False),
    )

    if "KHR_materials_emissive_strength" in ext:
        kw["emissive_strength"] = ext["KHR_materials_emissive_strength"].get("emissiveStrength", 1.0)
    if "KHR_materials_ior" in ext:
        kw["ior"] = ext["KHR_materials_ior"].get("ior", 1.5)
    if "KHR_materials_clearcoat" in ext:
        cc = ext["KHR_materials_clearcoat"]
        kw["clearcoat_factor"] = cc.get("clearcoatFactor", 0.0)
        kw["clearcoat_roughness"] = cc.get("clearcoatRoughnessFactor", 0.0)
        kw["clearcoat_normal_scale"] = cc.get("clearcoatNormalTexture", {}).get("scale", 1.0)
        put(TS_CLEARCOAT, tex_cache.get(cc.get("clearcoatTexture"), False, MipmapKind.SCALAR))
        put(TS_CLEARCOAT_ROUGHNESS,
            tex_cache.get(cc.get("clearcoatRoughnessTexture"), False, MipmapKind.SCALAR))
        put(TS_CLEARCOAT_NORMAL,
            tex_cache.get(cc.get("clearcoatNormalTexture"), False, MipmapKind.NORMAL))
    if "KHR_materials_sheen" in ext:
        sh = ext["KHR_materials_sheen"]
        kw["sheen_color"] = np.array(sh.get("sheenColorFactor", [0, 0, 0]), F)
        kw["sheen_roughness"] = sh.get("sheenRoughnessFactor", 0.0)
        put(TS_SHEEN_COLOR, tex_cache.get(sh.get("sheenColorTexture"), True, MipmapKind.COLOR))
        put(TS_SHEEN_ROUGHNESS,
            tex_cache.get(sh.get("sheenRoughnessTexture"), False, MipmapKind.SCALAR))
    if "KHR_materials_transmission" in ext:
        tr = ext["KHR_materials_transmission"]
        kw["transmission_factor"] = tr.get("transmissionFactor", 0.0)
        put(TS_TRANSMISSION, tex_cache.get(tr.get("transmissionTexture"), False, MipmapKind.TRANSMISSION))
    if "KHR_materials_volume" in ext:
        vol = ext["KHR_materials_volume"]
        kw["thickness"] = vol.get("thicknessFactor", 0.0)
        kw["attenuation_distance"] = vol.get("attenuationDistance", 0.0)
        kw["attenuation_color"] = np.array(vol.get("attenuationColor", [1, 1, 1]), F)
        put(TS_THICKNESS, tex_cache.get(vol.get("thicknessTexture"), False, MipmapKind.VOLUME_THICKNESS))
    if "KHR_materials_specular" in ext:
        sp = ext["KHR_materials_specular"]
        kw["specular_factor"] = sp.get("specularFactor", 1.0)
        kw["specular_color"] = np.array(sp.get("specularColorFactor", [1, 1, 1]), F)
        put(TS_SPECULAR, tex_cache.get(sp.get("specularTexture"), False, MipmapKind.SPECULAR))
        put(TS_SPECULAR_COLOR, tex_cache.get(sp.get("specularColorTexture"), True, MipmapKind.SPECULAR_COLOR))
    if "KHR_materials_iridescence" in ext:
        ir = ext["KHR_materials_iridescence"]
        kw["iridescence_factor"] = ir.get("iridescenceFactor", 0.0)
        kw["iridescence_ior"] = ir.get("iridescenceIor", 1.3)
        kw["iridescence_thickness_min"] = ir.get("iridescenceThicknessMinimum", 100.0)
        kw["iridescence_thickness_max"] = ir.get("iridescenceThicknessMaximum", 400.0)
        put(TS_IRIDESCENCE, tex_cache.get(ir.get("iridescenceTexture"), False, MipmapKind.SCALAR))
        put(TS_IRIDESCENCE_THICKNESS,
            tex_cache.get(ir.get("iridescenceThicknessTexture"), False, MipmapKind.SCALAR))
    if "KHR_materials_anisotropy" in ext:
        an = ext["KHR_materials_anisotropy"]
        kw["anisotropy_strength"] = an.get("anisotropyStrength", 0.0)
        kw["anisotropy_rotation"] = an.get("anisotropyRotation", 0.0)
        put(TS_ANISOTROPY, tex_cache.get(an.get("anisotropyTexture"), False, MipmapKind.COLOR))
    if "KHR_materials_dispersion" in ext:
        kw["dispersion"] = ext["KHR_materials_dispersion"].get("dispersion", 0.0)
    if "KHR_materials_diffuse_transmission" in ext:
        dt = ext["KHR_materials_diffuse_transmission"]
        kw["diffuse_transmission_factor"] = dt.get("diffuseTransmissionFactor", 0.0)
        kw["diffuse_transmission_color"] = np.array(
            dt.get("diffuseTransmissionColorFactor", [1, 1, 1]), F)

    return renderer.materials.insert(PbrMaterial(textures=textures, **kw))


def _node_transform(node: dict) -> Transform:
    if "matrix" in node:
        return Transform.from_matrix(np.array(node["matrix"], F).reshape(4, 4).T)
    return Transform(
        translation=np.array(node.get("translation", [0, 0, 0]), F),
        rotation=np.array(node.get("rotation", [0, 0, 0, 1]), F),
        scale=np.array(node.get("scale", [1, 1, 1]), F),
    )


def _convert_primitive(data: GltfData, prim: dict) -> MeshGeometry:
    """glTF primitive → indexed MeshGeometry (reference: gltf/buffers.rs)."""
    g = data.gltf
    attrs = prim.get("attributes", {})
    if "POSITION" not in attrs:
        raise GltfError("primitive has no POSITION attribute")
    pos = read_accessor(g, data.buffers, attrs["POSITION"]).astype(F)
    idx_arr = (
        read_accessor(g, data.buffers, prim["indices"]).reshape(-1)
        if "indices" in prim else None
    )
    indices = triangulate(idx_arr, prim.get("mode", 4), pos.shape[0])

    normals = read_accessor(g, data.buffers, attrs["NORMAL"]).astype(F) \
        if "NORMAL" in attrs else None
    tangents = read_accessor(g, data.buffers, attrs["TANGENT"]).astype(F) \
        if "TANGENT" in attrs else None
    uv0 = read_accessor(g, data.buffers, attrs["TEXCOORD_0"]).astype(F) \
        if "TEXCOORD_0" in attrs else None
    uv1 = read_accessor(g, data.buffers, attrs["TEXCOORD_1"]).astype(F) \
        if "TEXCOORD_1" in attrs else None
    color0 = None
    if "COLOR_0" in attrs:
        c = read_accessor(g, data.buffers, attrs["COLOR_0"]).astype(F)
        if c.shape[1] == 3:
            c = np.concatenate([c, np.ones((c.shape[0], 1), F)], axis=1)
        color0 = c
    joints = weights = None
    sets = []
    si = 0
    while f"JOINTS_{si}" in attrs and f"WEIGHTS_{si}" in attrs:
        j = read_accessor(g, data.buffers, attrs[f"JOINTS_{si}"])
        w = read_accessor(g, data.buffers, attrs[f"WEIGHTS_{si}"]).astype(F)
        sets.append((j.astype(np.int32), w))
        si += 1
    if sets:
        joints = np.concatenate([s[0] for s in sets], axis=1)
        weights = np.concatenate([s[1] for s in sets], axis=1)

    # morph targets (reference: buffers/morph.rs — 10 f32/target/vtx)
    morph_pos = morph_nrm = morph_tan = None
    targets = prim.get("targets", [])
    if targets:
        mp, mn, mt = [], [], []
        for t in targets:
            V = pos.shape[0]
            mp.append(read_accessor(g, data.buffers, t["POSITION"]).astype(F)
                      if "POSITION" in t else np.zeros((V, 3), F))
            mn.append(read_accessor(g, data.buffers, t["NORMAL"]).astype(F)
                      if "NORMAL" in t else np.zeros((V, 3), F))
            mt.append(read_accessor(g, data.buffers, t["TANGENT"]).astype(F)
                      if "TANGENT" in t else np.zeros((V, 3), F))
        morph_pos = np.stack(mp)
        morph_nrm = np.stack(mn)
        morph_tan = np.stack(mt)

    # ensure normals (flat fallback explodes vertices; reference normals.rs)
    if normals is None:
        if morph_pos is not None:
            morph_pos = morph_pos[:, indices.reshape(-1), :]
            morph_nrm = morph_nrm[:, indices.reshape(-1), :]
            morph_tan = morph_tan[:, indices.reshape(-1), :]
        exploded = {}
        for name, v in (("uv0", uv0), ("uv1", uv1), ("color0", color0),
                        ("tangents", tangents), ("joints", joints), ("weights", weights)):
            exploded[name] = v[indices.reshape(-1)] if v is not None else None
        pos, indices, normals = flat_normals(pos, indices)
        uv0, uv1, color0 = exploded["uv0"], exploded["uv1"], exploded["color0"]
        tangents, joints, weights = exploded["tangents"], exploded["joints"], exploded["weights"]

    # ensure tangents when a normal map will need them (reference tangents.rs)
    if tangents is None and uv0 is not None:
        tangents = generate_tangents(pos, normals, uv0, indices)

    acc = g["accessors"][attrs["POSITION"]]
    aabb = None
    if "min" in acc and "max" in acc:
        from ..core.bounds import Aabb

        aabb = Aabb(np.array(acc["min"], F), np.array(acc["max"], F))

    return MeshGeometry(
        positions=pos, indices=indices, normals=normals, tangents=tangents,
        uv0=uv0, uv1=uv1, color0=color0, joints=joints, weights=weights,
        morph_positions=morph_pos, morph_normals=morph_nrm, morph_tangents=morph_tan,
        aabb=aabb,
    )


def populate_gltf(renderer, data: GltfData, scene_index: Optional[int] = None,
                  autoplay_animations: bool = True) -> GltfKeyLookups:
    """Reference: gltf/populate.rs:145-208 populate_gltf."""
    g = data.gltf
    lookups = GltfKeyLookups()
    tex_cache = _TextureCache(renderer, data)

    scenes = g.get("scenes", [])
    si = scene_index if scene_index is not None else g.get("scene", 0)
    if not 0 <= si < len(scenes):
        raise GltfError(
            f"scene index {si} out of range (document has {len(scenes)} scenes)")
    scene = scenes[si]
    nodes = g.get("nodes", [])

    # pass 1: transforms (recursive)
    def walk(node_index: int, parent_key: Optional[int]):
        if not 0 <= node_index < len(nodes):
            raise GltfError(
                f"node index {node_index} out of range "
                f"(document has {len(nodes)} nodes)")
        node = nodes[node_index]
        key = renderer.transforms.insert(_node_transform(node), parent_key)
        lookups.node_transforms[node_index] = key
        for child in node.get("children", []):
            walk(child, key)

    for root in scene.get("nodes", []):
        walk(root, None)
    renderer.transforms.update_world()

    # pass 2: EXT_mesh_gpu_instancing — one transform child per instance
    instancing: Dict[int, List[int]] = {}
    for node_index in lookups.node_transforms:
        node = nodes[node_index]
        ext = node.get("extensions", {}).get("EXT_mesh_gpu_instancing")
        if not ext or "mesh" not in node:
            continue
        attrs = ext.get("attributes", {})
        t = read_accessor(g, data.buffers, attrs["TRANSLATION"]).astype(F) \
            if "TRANSLATION" in attrs else None
        rq = read_accessor(g, data.buffers, attrs["ROTATION"]).astype(F) \
            if "ROTATION" in attrs else None
        s = read_accessor(g, data.buffers, attrs["SCALE"]).astype(F) \
            if "SCALE" in attrs else None
        count = next(x.shape[0] for x in (t, rq, s) if x is not None)
        keys = []
        parent = lookups.node_transforms[node_index]
        for i in range(count):
            keys.append(renderer.transforms.insert(Transform(
                translation=t[i] if t is not None else np.zeros(3, F),
                rotation=rq[i] if rq is not None else m3.quat_identity(),
                scale=s[i] if s is not None else np.ones(3, F),
            ), parent))
        instancing[node_index] = keys
    renderer.transforms.update_world()

    # pass 3: skins
    skin_keys: Dict[int, int] = {}
    for node_index in lookups.node_transforms:
        node = nodes[node_index]
        if "skin" not in node or node["skin"] in skin_keys:
            continue
        skin = g["skins"][node["skin"]]
        joint_tks = [lookups.node_transforms[j] for j in skin["joints"]]
        if "inverseBindMatrices" in skin:
            ibm = read_accessor(g, data.buffers, skin["inverseBindMatrices"])
            ibm = ibm.reshape(-1, 4, 4).transpose(0, 2, 1)  # column-major → row-major
        else:
            ibm = np.tile(np.eye(4, dtype=F), (len(joint_tks), 1, 1))
        skin_keys[node["skin"]] = renderer.skins.insert(joint_tks, ibm)
    renderer.skins.update_transforms(renderer.transforms)

    # pass 5 (meshes) runs before animations so weight channels can bind
    # primitive-resource dedup: N nodes referencing one glTF mesh share
    # ONE converted MeshResource (the reference's MeshResource refcount
    # sharing, meshes.rs:303) — without this a Sponza-class scene
    # re-runs indices/normals/tangents conversion per node
    prim_resources: Dict[Tuple[int, int], Tuple[int, int]] = {}
    for node_index, tk in list(lookups.node_transforms.items()):
        node = nodes[node_index]
        if "mesh" not in node:
            continue
        mesh = g["meshes"][node["mesh"]]
        mesh_keys = []
        for pi, prim in enumerate(mesh.get("primitives", [])):
            mat_index = prim.get("material")
            if mat_index not in lookups.material_keys:
                lookups.material_keys[mat_index] = _convert_material(
                    renderer, data, mat_index, tex_cache)
            mat_key = lookups.material_keys[mat_index]
            weights0 = mesh.get("weights") or nodes[node_index].get("weights")
            skin_key = skin_keys.get(node.get("skin"))

            target_tks = instancing.get(node_index, [tk])
            rk = (node["mesh"], pi)
            if rk not in prim_resources:
                geo = _convert_primitive(data, prim)
                prim_resources[rk] = (renderer.meshes.insert_resource(geo),
                                      geo.morph_target_count)
            resource, morph_targets = prim_resources[rk]
            prim_keys = []
            if (node_index in instancing and skin_key is None
                    and morph_targets == 0):
                # shared-geometry instanced draw: corners stored/uploaded
                # ONCE, per-instance transforms only (instances.rs:22-203)
                prim_keys = renderer.meshes.insert_instanced(
                    resource,
                    [(renderer.transforms.row_of(t), t) for t in target_tks],
                    renderer.materials.row_of(mat_key), mat_key,
                    double_sided=getattr(
                        renderer.materials.get(mat_key), "double_sided", False),
                    transparent=renderer.materials.is_transparency_pass(mat_key),
                    hud=data.hud,
                )
            else:
                for instance_tk in target_tks:
                    mk = renderer.meshes.insert(
                        resource,
                        renderer.transforms.row_of(instance_tk),
                        renderer.materials.row_of(mat_key),
                        instance_tk, mat_key,
                        double_sided=getattr(renderer.materials.get(mat_key), "double_sided", False),
                        transparent=renderer.materials.is_transparency_pass(mat_key),
                        hud=data.hud,
                        skin_key=skin_key,
                        skin_joint_rows=(renderer.skins.joint_rows(skin_key)
                                         if skin_key is not None else None),
                        initial_morph_weights=weights0,
                    )
                    prim_keys.append(mk)
            mesh_keys.extend(prim_keys)
            lookups.mesh_primitives[(node["mesh"], pi)] = prim_keys
        lookups.node_meshes[node_index] = mesh_keys
    renderer.meshes.update_world(renderer.transforms)

    # KHR_lights_punctual: node-attached lights, world placement from the
    # node transform (same parity scope as the reference's lights store)
    doc_lights = g.get("extensions", {}).get("KHR_lights_punctual", {}).get("lights", [])
    for node_index, tk in lookups.node_transforms.items():
        node = nodes[node_index]
        li = node.get("extensions", {}).get("KHR_lights_punctual", {}).get("light")
        if li is None or li >= len(doc_lights):
            continue
        from ..core.lights import Light

        spec = doc_lights[li]
        world = renderer.transforms.world_of(tk)
        pos = world[:3, 3]
        direction = -world[:3, 2]  # lights point down -Z in glTF
        color = np.array(spec.get("color", [1, 1, 1]), F)
        intensity = spec.get("intensity", 1.0)
        rng = spec.get("range", 0.0)
        kind = spec.get("type", "directional")
        if kind == "directional":
            light = Light.directional(direction, color, intensity)
        elif kind == "point":
            light = Light.point(pos, color, intensity, range=rng)
        else:
            s = spec.get("spot", {})
            light = Light.spot(
                pos, direction, color, intensity, range=rng,
                inner_cone_angle=s.get("innerConeAngle", 0.0),
                outer_cone_angle=s.get("outerConeAngle", np.pi / 4))
        lookups.light_keys[node_index] = renderer.lights.insert(light)

    # cameras: expose params for the app layer (frontend chooses/uses them)
    for node_index, tk in lookups.node_transforms.items():
        node = nodes[node_index]
        if "camera" not in node:
            continue
        cam = g["cameras"][node["camera"]]
        world = renderer.transforms.world_of(tk)
        lookups.cameras[node_index] = {
            "type": cam.get("type"),
            "params": cam.get(cam.get("type"), {}),
            "world": np.array(world),
        }

    # pass 4: animations
    for anim in g.get("animations", []):
        channels = []
        for ch in anim.get("channels", []):
            target = ch["target"]
            node_index = target.get("node")
            if node_index is None or node_index not in lookups.node_transforms:
                continue
            sampler = anim["samplers"][ch["sampler"]]
            times = read_accessor(g, data.buffers, sampler["input"]).reshape(-1)
            values = read_accessor(g, data.buffers, sampler["output"])
            interp = Interpolation(sampler.get("interpolation", "LINEAR"))
            path = TargetPath(target["path"])
            if path == TargetPath.WEIGHTS:
                n_targets = values.shape[0] // max(len(times), 1)
                values = values.reshape(len(times), n_targets)
            if interp == Interpolation.CUBIC_SPLINE:
                values = values.reshape(len(times), 3, -1)
            samp = AnimationSampler(times=times, values=values, interpolation=interp)
            if path == TargetPath.WEIGHTS:
                for mk in lookups.node_meshes.get(node_index, []):
                    channels.append(AnimationChannel(samp, path, mesh_key=mk))
            else:
                channels.append(AnimationChannel(
                    samp, path, transform_key=lookups.node_transforms[node_index]))
        if channels:
            player = AnimationPlayer(AnimationClip(channels, name=anim.get("name", "")),
                                     playing=autoplay_animations)
            lookups.animation_players.append(renderer.animations.insert(player))

    return lookups
