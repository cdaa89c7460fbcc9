"""Sample-model catalog: spec-conformant binary GLBs generated in-process.

The reference frontend's integration spine is a catalog of ~80 Khronos
glTF sample assets fetched over the network
(crates/frontend/src/models/collections.rs:32-123). This TPU build runs
with zero egress, so the catalog is GENERATED: each entry below builds a
real binary GLB (12-byte header + JSON chunk + BIN chunk, glTF 2.0 §4)
probing one loader/populate feature — sparse accessors, interleaved
vertex buffers, strip/fan topology, normalized integer attributes,
EXT_mesh_gpu_instancing, mirrored-UV tangent generation
(NormalTangentMirrorTest-class), skinning + animation, morph targets,
KHR_texture_transform, alpha modes, arbitrary morph/skin-set counts.

Used by the demo app (``python -m demo.app --scene glb-skinned``) and the
golden test suite (tests/test_gltf_golden.py). Every builder returns
``(glb_bytes, (eye, center))`` — the bytes plus a camera framing.
"""

from __future__ import annotations

import io
import json
import struct

import numpy as np

F = np.float32

_CTYPE = {
    np.dtype(np.int8): 5120, np.dtype(np.uint8): 5121,
    np.dtype(np.int16): 5122, np.dtype(np.uint16): 5123,
    np.dtype(np.uint32): 5125, np.dtype(np.float32): 5126,
}
_TYPE = {1: "SCALAR", 2: "VEC2", 3: "VEC3", 4: "VEC4", 16: "MAT4"}


class _GlbBuilder:
    """Accumulates bufferViews/accessors over one BIN chunk, then packs a
    spec-conformant GLB container (glTF 2.0 §4: magic 0x46546C67, JSON
    chunk 0x4E4F534A, BIN chunk 0x004E4942, 4-byte chunk alignment)."""

    def __init__(self):
        self.bin = bytearray()
        self.views = []
        self.accessors = []
        self.images = []

    def view(self, data: bytes, stride=None):
        self.bin += b"\x00" * ((-len(self.bin)) % 4)
        v = {"buffer": 0, "byteOffset": len(self.bin), "byteLength": len(data)}
        if stride is not None:
            v["byteStride"] = stride
        self.bin += data
        self.views.append(v)
        return len(self.views) - 1

    def acc(self, arr, normalized=False, minmax=False, view=None,
            byte_offset=0, count=None):
        arr = np.ascontiguousarray(arr)
        if view is None:
            view = self.view(arr.tobytes())
        ncomp = 1 if arr.ndim == 1 else arr.shape[1]
        a = {
            "bufferView": view, "byteOffset": byte_offset,
            "componentType": _CTYPE[arr.dtype],
            "count": count if count is not None else arr.shape[0],
            "type": _TYPE[ncomp],
        }
        if normalized:
            a["normalized"] = True
        if minmax:
            a["min"] = np.min(arr.reshape(a["count"], -1), axis=0).tolist()
            a["max"] = np.max(arr.reshape(a["count"], -1), axis=0).tolist()
        self.accessors.append(a)
        return len(self.accessors) - 1

    def image_png(self, rgba: np.ndarray):
        """Embed an RGBA uint8 image as a PNG in the BIN chunk."""
        from PIL import Image

        buf = io.BytesIO()
        Image.fromarray(rgba).save(buf, format="PNG")
        self.images.append({
            "bufferView": self.view(buf.getvalue()),
            "mimeType": "image/png",
        })
        return len(self.images) - 1

    def glb(self, gltf: dict) -> bytes:
        gltf = dict(gltf)
        gltf["asset"] = {"version": "2.0"}
        self.bin += b"\x00" * ((-len(self.bin)) % 4)
        gltf["buffers"] = [{"byteLength": len(self.bin)}]
        gltf["bufferViews"] = self.views
        gltf["accessors"] = self.accessors
        if self.images:
            gltf["images"] = self.images
        js = json.dumps(gltf).encode()
        js += b" " * ((-len(js)) % 4)
        out = struct.pack("<4sII", b"glTF", 2,
                          12 + 8 + len(js) + 8 + len(self.bin))
        out += struct.pack("<II", len(js), 0x4E4F534A) + js
        out += struct.pack("<II", len(self.bin), 0x004E4942) + bytes(self.bin)
        return out


def _checker_rgba(size=64, a=(220, 60, 40), b=(240, 230, 210)):
    yy, xx = np.mgrid[0:size, 0:size]
    c = ((yy // 8 + xx // 8) % 2).astype(bool)
    img = np.empty((size, size, 4), np.uint8)
    img[..., :3] = np.where(c[..., None], np.uint8(a), np.uint8(b))
    img[..., 3] = 255
    return img


def _bump_normal_map(size=64):
    """Tangent-space normal map: a grid of circular bumps."""
    yy, xx = np.mgrid[0:size, 0:size] / size * 4 * np.pi
    hx = np.cos(xx) * np.sin(yy) * 0.6
    hy = np.sin(xx) * np.cos(yy) * 0.6
    n = np.stack([-hx, -hy, np.ones_like(hx)], axis=-1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    img = np.empty((size, size, 4), np.uint8)
    img[..., :3] = np.clip((n * 0.5 + 0.5) * 255, 0, 255).astype(np.uint8)
    img[..., 3] = 255
    return img


# ---------------------------------------------------------------- fixtures

def glb_sparse_displaced():
    """Sparse POSITION override: flat grid, sparse accessor raises the
    center vertices into a pyramid (accessor.rs sparse substitution)."""
    b = _GlbBuilder()
    n = 7
    g = np.mgrid[0:n, 0:n].astype(F) / (n - 1) - 0.5
    pos = np.stack([g[1] * 2, np.zeros_like(g[0]), g[0] * 2],
                   axis=-1).reshape(-1, 3)
    quads = []
    for i in range(n - 1):
        for j in range(n - 1):
            v = i * n + j
            quads += [[v, v + n, v + 1], [v + 1, v + n, v + n + 1]]
    idx = np.asarray(quads, np.uint16).reshape(-1)

    # sparse: lift the 3x3 center block
    sel = [i * n + j for i in range(2, 5) for j in range(2, 5)]
    sp_idx = np.asarray(sel, np.uint16)
    sp_val = pos[sel].copy()
    sp_val[:, 1] = 0.55
    sp_val[4, 1] = 0.9

    pos_acc = b.acc(pos, minmax=True)
    b.accessors[pos_acc]["sparse"] = {
        "count": len(sel),
        "indices": {"bufferView": b.view(sp_idx.tobytes()),
                    "componentType": 5123},
        "values": {"bufferView": b.view(sp_val.tobytes())},
    }
    idx_acc = b.acc(idx)
    return b.glb({
        "scene": 0, "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": [{
            "attributes": {"POSITION": pos_acc}, "indices": idx_acc,
            "material": 0}]}],
        "materials": [{"pbrMetallicRoughness": {
            "baseColorFactor": [0.85, 0.2, 0.15, 1.0],
            "roughnessFactor": 0.6, "metallicFactor": 0.0}}],
    }), ((0.0, 2.2, 2.6), (0.0, 0.2, 0.0))


def glb_mirrored_tangent():
    """NormalTangentMirrorTest-class probe: two quads, the right one with
    mirrored U, no TANGENT attribute → generated tangents must flip
    handedness across the seam for the normal-mapped lighting to stay
    continuous (gltf/buffers/tangents.rs mikktspace path)."""
    b = _GlbBuilder()
    #  quad L: u 0→1,  quad R: u 1→0 (mirror)
    pos = np.array([
        [-1, -0.5, 0], [0, -0.5, 0], [0, 0.5, 0], [-1, 0.5, 0],
        [0, -0.5, 0], [1, -0.5, 0], [1, 0.5, 0], [0, 0.5, 0],
    ], F)
    uv = np.array([
        [0, 1], [1, 1], [1, 0], [0, 0],
        [1, 1], [0, 1], [0, 0], [1, 0],
    ], F)
    nrm = np.tile(np.array([[0, 0, 1]], F), (8, 1))
    idx = np.array([0, 1, 2, 0, 2, 3, 4, 5, 6, 4, 6, 7], np.uint16)
    img = b.image_png(_bump_normal_map())
    return b.glb({
        "scene": 0, "scenes": [{"nodes": [0, 1]}],
        "nodes": [
            {"mesh": 0},
            {"extensions": {"KHR_lights_punctual": {"light": 0}},
             "rotation": [-0.3826834, 0, 0, 0.9238795]},  # pitch -45°
        ],
        "meshes": [{"primitives": [{
            "attributes": {"POSITION": b.acc(pos, minmax=True),
                           "NORMAL": b.acc(nrm), "TEXCOORD_0": b.acc(uv)},
            "indices": b.acc(idx), "material": 0}]}],
        "materials": [{
            "pbrMetallicRoughness": {
                "baseColorFactor": [0.6, 0.6, 0.65, 1.0],
                "roughnessFactor": 0.35, "metallicFactor": 0.0},
            "normalTexture": {"index": 0}}],
        "textures": [{"source": img, "sampler": 0}],
        "samplers": [{"magFilter": 9729, "minFilter": 9987,
                      "wrapS": 10497, "wrapT": 10497}],
        "extensionsUsed": ["KHR_lights_punctual"],
        "extensions": {"KHR_lights_punctual": {"lights": [
            {"type": "directional", "intensity": 3.0,
             "color": [1.0, 0.95, 0.9]}]}},
    }), ((0.0, 0.35, 2.1), (0.0, 0.0, 0.0))


def glb_interleaved():
    """One interleaved bufferView (byteStride=32: pos+normal+uv per
    vertex) for a textured cube (accessor.rs interleaved stride path)."""
    b = _GlbBuilder()
    faces = []
    for axis in range(3):
        for sgn in (1.0, -1.0):
            n = np.zeros(3, F)
            n[axis] = sgn
            u = np.zeros(3, F)
            u[(axis + 1) % 3] = 1.0
            v = np.cross(n, u)
            c = n * 0.5
            quad = [c - 0.5 * u - 0.5 * v, c + 0.5 * u - 0.5 * v,
                    c + 0.5 * u + 0.5 * v, c - 0.5 * u + 0.5 * v]
            faces.append((quad, n))
    V = len(faces) * 4
    inter = np.zeros((V, 8), F)
    idx = []
    for fi, (quad, n) in enumerate(faces):
        for vi, p in enumerate(quad):
            inter[fi * 4 + vi, :3] = p
            inter[fi * 4 + vi, 3:6] = n
            inter[fi * 4 + vi, 6:] = [(0, 1, 1, 0)[vi], (1, 1, 0, 0)[vi]]
        v0 = fi * 4
        idx += [v0, v0 + 1, v0 + 2, v0, v0 + 2, v0 + 3]
    view = b.view(inter.tobytes(), stride=32)
    pos_acc = b.acc(inter[:, :3], view=view, byte_offset=0, count=V)
    b.accessors[pos_acc]["min"] = [-0.5, -0.5, -0.5]
    b.accessors[pos_acc]["max"] = [0.5, 0.5, 0.5]
    nrm_acc = b.acc(inter[:, 3:6], view=view, byte_offset=12, count=V)
    uv_acc = b.acc(inter[:, 6:], view=view, byte_offset=24, count=V)
    img = b.image_png(_checker_rgba())
    return b.glb({
        "scene": 0, "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0,
                   "rotation": [0.0, 0.3826834, 0.0, 0.9238795]}],
        "meshes": [{"primitives": [{
            "attributes": {"POSITION": pos_acc, "NORMAL": nrm_acc,
                           "TEXCOORD_0": uv_acc},
            "indices": b.acc(np.asarray(idx, np.uint16)), "material": 0}]}],
        "materials": [{"pbrMetallicRoughness": {
            "baseColorTexture": {"index": 0},
            "roughnessFactor": 0.8, "metallicFactor": 0.0}}],
        "textures": [{"source": img}],
    }), ((1.2, 1.0, 1.8), (0.0, 0.0, 0.0))


def glb_strip_fan():
    """Two primitives: a triangle-strip ribbon (mode 5) and a
    triangle-fan disk (mode 6) — accessor.rs triangulation paths."""
    b = _GlbBuilder()
    # strip: zig-zag ribbon along x
    ns = 8
    xs = np.linspace(-1.2, 1.2, ns, dtype=F)
    strip = np.zeros((ns * 2, 3), F)
    strip[0::2, 0] = xs
    strip[1::2, 0] = xs
    # top row first: GL strip convention (i, i+1, i+2, odd swapped) then
    # yields CCW front faces toward +z
    strip[0::2, 1] = -0.15 + 0.12 * np.sin(xs * 4)
    strip[1::2, 1] = -0.55 + 0.12 * np.sin(xs * 4)
    # fan: disk above
    nf = 12
    ang = np.linspace(0, 2 * np.pi, nf, dtype=F)
    fan = np.zeros((nf + 1, 3), F)
    fan[0] = [0, 0.45, 0]
    fan[1:, 0] = 0.7 * np.cos(ang)
    fan[1:, 1] = 0.45 + 0.45 * np.sin(ang)
    return b.glb({
        "scene": 0, "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": [
            {"attributes": {"POSITION": b.acc(strip, minmax=True)},
             "mode": 5, "material": 0},
            {"attributes": {"POSITION": b.acc(fan, minmax=True)},
             "mode": 6, "material": 1},
        ]}],
        "materials": [
            {"pbrMetallicRoughness": {
                "baseColorFactor": [0.2, 0.7, 0.3, 1.0],
                "roughnessFactor": 0.7}},
            {"pbrMetallicRoughness": {
                "baseColorFactor": [0.9, 0.6, 0.1, 1.0],
                "roughnessFactor": 0.4}},
        ],
    }), ((0.0, 0.2, 2.6), (0.0, 0.1, 0.0))


def glb_instanced():
    """EXT_mesh_gpu_instancing: a 5x3 grid of one box via per-instance
    TRANSLATION/ROTATION/SCALE accessors (instances.rs:22-203)."""
    b = _GlbBuilder()
    s = 0.22
    pos = np.array([[x, y, z] for x in (-s, s) for y in (-s, s)
                    for z in (-s, s)], F)
    idx = np.array([0, 1, 3, 0, 3, 2, 4, 6, 7, 4, 7, 5,
                    0, 4, 5, 0, 5, 1, 2, 3, 7, 2, 7, 6,
                    0, 2, 6, 0, 6, 4, 1, 5, 7, 1, 7, 3], np.uint16)
    nx, ny = 5, 3
    t, rot, sc = [], [], []
    for iy in range(ny):
        for ix in range(nx):
            t.append([(ix - (nx - 1) / 2) * 0.75,
                      (iy - (ny - 1) / 2) * 0.75, 0.0])
            a = 0.5 * (ix + iy * nx)
            rot.append([0.0, np.sin(a / 2), 0.0, np.cos(a / 2)])
            k = 0.6 + 0.4 * ((ix + iy) % 3) / 2
            sc.append([k, k, k])
    return b.glb({
        "scene": 0, "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0, "extensions": {"EXT_mesh_gpu_instancing": {
            "attributes": {
                "TRANSLATION": b.acc(np.asarray(t, F)),
                "ROTATION": b.acc(np.asarray(rot, F)),
                "SCALE": b.acc(np.asarray(sc, F)),
            }}}}],
        "meshes": [{"primitives": [{
            "attributes": {"POSITION": b.acc(pos, minmax=True)},
            "indices": b.acc(idx), "material": 0}]}],
        "materials": [{"pbrMetallicRoughness": {
            "baseColorFactor": [0.3, 0.45, 0.9, 1.0],
            "roughnessFactor": 0.5, "metallicFactor": 0.3}}],
        "extensionsUsed": ["EXT_mesh_gpu_instancing"],
    }), ((0.0, 0.8, 3.4), (0.0, 0.0, 0.0))


def glb_normalized_attrs():
    """Normalized integer attributes: COLOR_0 as normalized u8 VEC4,
    TEXCOORD_0 as normalized u16, u8 indices (accessor.rs normalize)."""
    b = _GlbBuilder()
    pos = np.array([[-1, -0.6, 0], [1, -0.6, 0], [1, 0.6, 0], [-1, 0.6, 0]], F)
    col = np.array([[255, 40, 40, 255], [40, 255, 40, 255],
                    [40, 40, 255, 255], [255, 255, 40, 255]], np.uint8)
    uv = (np.array([[0, 1], [1, 1], [1, 0], [0, 0]], F) * 65535).astype(np.uint16)
    idx = np.array([0, 1, 2, 0, 2, 3], np.uint8)
    img = b.image_png(_checker_rgba(a=(200, 200, 200), b=(90, 90, 90)))
    return b.glb({
        "scene": 0, "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": [{
            "attributes": {"POSITION": b.acc(pos, minmax=True),
                           "COLOR_0": b.acc(col, normalized=True),
                           "TEXCOORD_0": b.acc(uv, normalized=True)},
            "indices": b.acc(idx), "material": 0}]}],
        "materials": [{"pbrMetallicRoughness": {
            "baseColorTexture": {"index": 0}, "roughnessFactor": 0.9}}],
        "textures": [{"source": img}],
    }), ((0.0, 0.0, 1.9), (0.0, 0.0, 0.0))


def glb_skinned():
    """RiggedSimple-class: a 2-bone vertical strip, skin with
    inverseBindMatrices + a rotation animation on the top bone (skins
    pass 3 + animations pass 4 through real GLB accessors)."""
    b = _GlbBuilder()
    # strip of quads along +y, weights blend from bone0 to bone1
    n = 5
    pos, jnts, wts = [], [], []
    for i in range(n + 1):
        y = i / n * 2.0
        w1 = i / n
        for x in (-0.25, 0.25):
            pos.append([x, y, 0])
            jnts.append([0, 1, 0, 0])
            wts.append([1 - w1, w1, 0, 0])
    idx = []
    for i in range(n):
        v = i * 2
        idx += [v, v + 1, v + 3, v, v + 3, v + 2]
    ibm = np.stack([np.eye(4, dtype=F), np.eye(4, dtype=F)])
    ibm[1][1, 3] = -1.0      # bone1 sits at y=1
    ibm_cm = np.ascontiguousarray(ibm.transpose(0, 2, 1)).reshape(2, 16)
    t_in = np.array([0.0, 1.0], F)
    ang = np.pi / 4
    t_out = np.array([[0, 0, 0, 1],
                      [0, 0, np.sin(ang / 2), np.cos(ang / 2)]], F)
    return b.glb({
        "scene": 0, "scenes": [{"nodes": [0, 1]}],
        "nodes": [
            {"mesh": 0, "skin": 0},
            {"children": [2]},                       # bone0 (root)
            {"translation": [0, 1, 0]},              # bone1
        ],
        "skins": [{"joints": [1, 2],
                   "inverseBindMatrices": b.acc(ibm_cm.reshape(2, 16))}],
        "meshes": [{"primitives": [{
            "attributes": {
                "POSITION": b.acc(np.asarray(pos, F), minmax=True),
                "JOINTS_0": b.acc(np.asarray(jnts, np.uint8)),
                "WEIGHTS_0": b.acc(np.asarray(wts, F))},
            "indices": b.acc(np.asarray(idx, np.uint16)), "material": 0}]}],
        "materials": [{"pbrMetallicRoughness": {
            "baseColorFactor": [0.8, 0.4, 0.1, 1.0],
            "roughnessFactor": 0.6}}],
        "animations": [{
            "samplers": [{"input": b.acc(t_in), "interpolation": "LINEAR",
                          "output": b.acc(t_out)}],
            "channels": [{"sampler": 0,
                          "target": {"node": 2, "path": "rotation"}}]}],
    }), ((0.4, 1.2, 3.2), (0.0, 1.0, 0.0))


def glb_two_skins():
    """BrainStem-class structure probe: TWO independent skinned meshes
    with SEPARATE skeletons in one scene, each driven by its own
    animation channel (one bends +z, one -z). Pins multi-skin joint-row
    offsetting (core/skins.py) and per-skin animation routing through a
    real GLB — the recursive-skeletons and many-influences probes each
    exercise one skeleton only."""
    b = _GlbBuilder()
    n = 5
    pos, jnts, wts = [], [], []
    for i in range(n + 1):
        y = i / n * 2.0
        w1 = i / n
        for x in (-0.2, 0.2):
            pos.append([x, y, 0])
            jnts.append([0, 1, 0, 0])
            wts.append([1 - w1, w1, 0, 0])
    idx = []
    for i in range(n):
        v = i * 2
        idx += [v, v + 1, v + 3, v, v + 3, v + 2]
    pos_acc = b.acc(np.asarray(pos, F), minmax=True)
    j_acc = b.acc(np.asarray(jnts, np.uint8))
    w_acc = b.acc(np.asarray(wts, F))
    i_acc = b.acc(np.asarray(idx, np.uint16))
    ibm = np.stack([np.eye(4, dtype=F), np.eye(4, dtype=F)])
    ibm[1][1, 3] = -1.0
    ibm_cm = np.ascontiguousarray(ibm.transpose(0, 2, 1)).reshape(2, 16)
    ibm_acc = b.acc(ibm_cm)
    t_in = b.acc(np.array([0.0, 1.0], F))
    ang = np.pi / 4
    rot_p = b.acc(np.array([[0, 0, 0, 1],
                            [0, 0, np.sin(ang / 2), np.cos(ang / 2)]], F))
    rot_n = b.acc(np.array([[0, 0, 0, 1],
                            [0, 0, -np.sin(ang / 2), np.cos(ang / 2)]], F))
    mesh = {"primitives": [{
        "attributes": {"POSITION": pos_acc, "JOINTS_0": j_acc,
                       "WEIGHTS_0": w_acc},
        "indices": i_acc, "material": 0}]}
    return b.glb({
        "scene": 0, "scenes": [{"nodes": [0, 1, 3, 4]}],
        "nodes": [
            {"mesh": 0, "skin": 0, "translation": [-0.8, 0, 0]},
            {"children": [2]},                       # skeleton A root
            {"translation": [0, 1, 0]},              # skeleton A tip
            {"mesh": 0, "skin": 1, "translation": [0.8, 0, 0]},
            {"children": [5]},                       # skeleton B root
            {"translation": [0, 1, 0]},              # skeleton B tip
        ],
        "skins": [
            {"joints": [1, 2], "inverseBindMatrices": ibm_acc},
            {"joints": [4, 5], "inverseBindMatrices": ibm_acc},
        ],
        "meshes": [mesh],
        "materials": [{"pbrMetallicRoughness": {
            "baseColorFactor": [0.3, 0.6, 0.9, 1.0],
            "roughnessFactor": 0.6}}],
        "animations": [{
            "samplers": [
                {"input": t_in, "interpolation": "LINEAR", "output": rot_p},
                {"input": t_in, "interpolation": "LINEAR", "output": rot_n},
            ],
            "channels": [
                {"sampler": 0, "target": {"node": 2, "path": "rotation"}},
                {"sampler": 1, "target": {"node": 5, "path": "rotation"}},
            ]}],
    }), ((0.0, 1.2, 3.6), (0.0, 1.0, 0.0))


def glb_morphed():
    """MorphPrimitivesTest-class: a quad with two POSITION morph targets
    and non-zero initial mesh weights, plus a weights animation."""
    b = _GlbBuilder()
    pos = np.array([[-1, -0.5, 0], [1, -0.5, 0], [1, 0.5, 0], [-1, 0.5, 0]], F)
    idx = np.array([0, 1, 2, 0, 2, 3], np.uint16)
    t0 = np.array([[0, 0.8, 0], [0, 0, 0], [0, 0, 0], [0, 0.8, 0]], F)
    t1 = np.array([[0, 0, 0], [0, 0.8, 0], [0, 0.8, 0], [0, 0, 0]], F)
    t_in = np.array([0.0, 1.0], F)
    t_out = np.array([0.0, 0.0, 1.0, 0.4], F)   # (t, weights[2]) pairs
    return b.glb({
        "scene": 0, "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0}],
        "meshes": [{
            "primitives": [{
                "attributes": {"POSITION": b.acc(pos, minmax=True)},
                "indices": b.acc(idx), "material": 0,
                "targets": [{"POSITION": b.acc(t0, minmax=True)},
                            {"POSITION": b.acc(t1, minmax=True)}]}],
            "weights": [0.3, 0.0]}],
        "materials": [{"pbrMetallicRoughness": {
            "baseColorFactor": [0.2, 0.6, 0.8, 1.0],
            "roughnessFactor": 0.5}}],
        "animations": [{
            "samplers": [{"input": b.acc(t_in), "interpolation": "LINEAR",
                          "output": b.acc(t_out)}],
            "channels": [{"sampler": 0,
                          "target": {"node": 0, "path": "weights"}}]}],
    }), ((0.0, 0.6, 2.6), (0.0, 0.2, 0.0))


def glb_texture_transform():
    """TextureTransformTest-class: same texture bound with three
    different KHR_texture_transform (offset / scale / rotation)."""
    b = _GlbBuilder()
    img = b.image_png(_checker_rgba(a=(30, 90, 200), b=(240, 240, 240)))
    quad = np.array([[-0.5, -0.5, 0], [0.5, -0.5, 0],
                     [0.5, 0.5, 0], [-0.5, 0.5, 0]], F)
    uv = np.array([[0, 1], [1, 1], [1, 0], [0, 0]], F)
    idx = np.array([0, 1, 2, 0, 2, 3], np.uint16)
    quad_acc = b.acc(quad, minmax=True)
    uv_acc = b.acc(uv)
    idx_acc = b.acc(idx)
    transforms = [
        {"offset": [0.25, 0.25]},
        {"scale": [2.0, 2.0]},
        {"rotation": 0.6},
    ]
    mats, meshes, nodes = [], [], []
    for i, tf in enumerate(transforms):
        mats.append({"pbrMetallicRoughness": {
            "baseColorTexture": {"index": 0,
                                 "extensions": {"KHR_texture_transform": tf}},
            "roughnessFactor": 0.9}})
        meshes.append({"primitives": [{
            "attributes": {"POSITION": quad_acc, "TEXCOORD_0": uv_acc},
            "indices": idx_acc, "material": i}]})
        nodes.append({"mesh": i, "translation": [(i - 1) * 1.15, 0, 0]})
    return b.glb({
        "scene": 0, "scenes": [{"nodes": list(range(3))}],
        "nodes": nodes, "meshes": meshes, "materials": mats,
        "textures": [{"source": img}],
        "extensionsUsed": ["KHR_texture_transform"],
    }), ((0.0, 0.25, 2.2), (0.0, 0.0, 0.0))


def glb_alpha_modes():
    """AlphaBlendModeTest-class: OPAQUE / MASK(cutoff) / BLEND side by
    side over a backdrop."""
    b = _GlbBuilder()
    # checker with alpha variation: red squares are translucent (90/255)
    rgba = _checker_rgba(a=(255, 60, 60), b=(60, 200, 60))
    rgba[..., 3] = np.where(rgba[..., 0] > 128, 90, 255).astype(np.uint8)
    img = b.image_png(rgba)
    quad = np.array([[-0.45, -0.45, 0], [0.45, -0.45, 0],
                     [0.45, 0.45, 0], [-0.45, 0.45, 0]], F)
    uv = np.array([[0, 1], [1, 1], [1, 0], [0, 0]], F)
    idx = np.array([0, 1, 2, 0, 2, 3], np.uint16)
    quad_acc = b.acc(quad, minmax=True)
    uv_acc = b.acc(uv)
    idx_acc = b.acc(idx)
    modes = [{"alphaMode": "OPAQUE"},
             {"alphaMode": "MASK", "alphaCutoff": 0.5},
             {"alphaMode": "BLEND"}]
    mats, meshes, nodes = [], [], []
    for i, m in enumerate(modes):
        mats.append({"pbrMetallicRoughness": {
            "baseColorTexture": {"index": 0},
            "baseColorFactor": [1, 1, 1, 0.7] if m["alphaMode"] == "BLEND"
            else [1, 1, 1, 1],
            "roughnessFactor": 0.9}, **m})
        meshes.append({"primitives": [{
            "attributes": {"POSITION": quad_acc, "TEXCOORD_0": uv_acc},
            "indices": idx_acc, "material": i}]})
        nodes.append({"mesh": i, "translation": [(i - 1) * 1.05, 0, 0]})
    # backdrop
    back = np.array([[-2, -1, -0.5], [2, -1, -0.5],
                     [2, 1, -0.5], [-2, 1, -0.5]], F)
    meshes.append({"primitives": [{
        "attributes": {"POSITION": b.acc(back, minmax=True)},
        "indices": idx_acc, "material": 3}]})
    mats.append({"pbrMetallicRoughness": {
        "baseColorFactor": [0.9, 0.8, 0.2, 1.0], "roughnessFactor": 0.9}})
    nodes.append({"mesh": 3})
    return b.glb({
        "scene": 0, "scenes": [{"nodes": list(range(4))}],
        "nodes": nodes, "meshes": meshes, "materials": mats,
        "textures": [{"source": img}],
    }), ((0.0, 0.0, 2.4), (0.0, 0.0, 0.0))


def glb_many_influences():
    """MorphStressTest-class arbitrary-N probe: 12 POSITION morph targets
    (only #11 active) AND 3 joint-influence sets (JOINTS_0/1/2) where half
    the weight rides a SET-3 joint — both beyond the initial pow2 buckets
    (core/meshes.py _ensure_morph_width/_ensure_skin_width; reference
    morph.wgsl unroll-then-loop + skins.rs arbitrary sets). If either the
    12th target or the third set were truncated, the quad would render at
    the wrong place/size."""
    b = _GlbBuilder()
    quad = np.array([[-0.6, -0.4, 0], [0.6, -0.4, 0],
                     [0.6, 0.4, 0], [-0.6, 0.4, 0]], F)
    idx = np.array([0, 1, 2, 0, 2, 3], np.uint16)
    nv = 4
    # morph targets: #11 lifts +0.5y, all earlier ones would sink -5y
    # (so accidentally activating a truncated-away index is visible too)
    zero = np.zeros((nv, 3), F)
    sink = np.tile(np.array([0, -5.0, 0], F), (nv, 1))
    lift = np.tile(np.array([0, 0.5, 0], F), (nv, 1))
    targets = [{"POSITION": b.acc(sink if t < 11 else lift, minmax=True)}
               for t in range(12)]
    # 12 joints over 3 sets; influence 0 (set 1, joint 0 = identity) and
    # influence 8 (SET 3, joint 8 translated +0.4x+0.6y) split the weight:
    # final = p + 0.5*(0.4, 0.6) — set-3 truncation would halve the quad
    j0 = np.tile(np.array([0, 0, 0, 0], np.uint8), (nv, 1))
    w0 = np.tile(np.array([0.5, 0, 0, 0], F), (nv, 1))
    j2 = np.tile(np.array([8, 0, 0, 0], np.uint8), (nv, 1))
    w2 = np.tile(np.array([0.5, 0, 0, 0], F), (nv, 1))
    jz = np.zeros((nv, 4), np.uint8)
    wz = np.zeros((nv, 4), F)
    ibm = np.tile(np.eye(4, dtype=F)[None], (12, 1, 1))
    ibm_cm = np.ascontiguousarray(ibm.transpose(0, 2, 1)).reshape(12, 16)
    joint_nodes = [{"translation": [0.4, 0.6, 0.0]} if j == 8 else {}
                   for j in range(12)]
    return b.glb({
        "scene": 0, "scenes": [{"nodes": list(range(13))}],
        "nodes": [{"mesh": 0, "skin": 0}] + joint_nodes,
        "skins": [{"joints": list(range(1, 13)),
                   "inverseBindMatrices": b.acc(ibm_cm)}],
        "meshes": [{
            "primitives": [{
                "attributes": {
                    "POSITION": b.acc(quad, minmax=True),
                    "JOINTS_0": b.acc(j0), "WEIGHTS_0": b.acc(w0),
                    "JOINTS_1": b.acc(jz), "WEIGHTS_1": b.acc(wz),
                    "JOINTS_2": b.acc(j2), "WEIGHTS_2": b.acc(w2)},
                "indices": b.acc(idx), "material": 0,
                "targets": targets}],
            "weights": [0.0] * 11 + [1.0]}],
        "materials": [{"pbrMetallicRoughness": {
            "baseColorFactor": [0.85, 0.3, 0.5, 1.0],
            "roughnessFactor": 0.6}}],
    }), ((0.2, 0.6, 2.6), (0.2, 0.55, 0.0))



def glb_helmet():
    """DamagedHelmet-grade PBR probe AT REAL ASSET SCALE (r4): a
    ~51k-triangle helmet dome (Khronos DamagedHelmet is ~15k) with the
    full five-map set — baseColor, metallicRoughness, tangent-space
    normal, occlusion, emissive — as 1024x1024 textures through one PBR
    material (DamagedHelmet ships 2k^2 maps; 1k^2 keeps the in-process
    PNG encode tractable while exercising the same mip-chain depth
    class). The dome is procedurally DENTED (radial displacement with
    grid-recomputed normals), so the triangle density carries real
    geometric signal, and tangents are pipeline-generated at full mesh
    scale. Loader-time budget: see
    tests/test_gltf.py::test_helmet_loader_time_budget."""
    b = _GlbBuilder()
    S = 1024
    yy, xx = np.mgrid[0:S, 0:S].astype(np.float64) / S

    # panel grid + scratches
    panel = ((xx * 6).astype(int) + (yy * 3).astype(int)) % 2
    rng = np.random.default_rng(1234)
    scratch = rng.random((S, S)) < 0.02
    scratch = scratch | np.roll(scratch, 1, axis=1) | np.roll(scratch, 2, axis=1)
    visor = (yy > 0.55) & (yy < 0.72) & (np.abs(xx - 0.5) < 0.22)

    base = np.empty((S, S, 4), np.uint8)
    base[..., 0] = np.where(panel, 140, 90)
    base[..., 1] = np.where(panel, 110, 75)
    base[..., 2] = np.where(panel, 70, 60)
    base[scratch] = (200, 190, 180, 255)
    base[visor] = (25, 30, 40, 255)
    base[..., 3] = 255

    # metallicRoughness: G = roughness, B = metallic (glTF channel layout)
    mr = np.zeros((S, S, 4), np.uint8)
    mr[..., 1] = np.where(panel, 90, 200)          # panels polished
    mr[..., 1][scratch] = 60
    mr[..., 2] = np.where(panel, 255, 40)
    mr[..., 2][visor] = 255
    mr[..., 1][visor] = 30
    mr[..., 3] = 255

    # rivet-bump normal map + matching AO
    ry = np.minimum(yy * 3 % 1, 1 - yy * 3 % 1)
    rx = np.minimum(xx * 6 % 1, 1 - xx * 6 % 1)
    d = np.sqrt((rx * 6) ** 2 + (ry * 3) ** 2)
    bump = np.clip(1.0 - d / 0.35, 0.0, 1.0) ** 2
    hx = np.gradient(bump, axis=1) * 40
    hy = np.gradient(bump, axis=0) * 40
    nz = 1.0 / np.sqrt(hx * hx + hy * hy + 1.0)
    nrm = np.empty((S, S, 4), np.uint8)
    nrm[..., 0] = np.clip((-hx * nz * 0.5 + 0.5) * 255, 0, 255)
    nrm[..., 1] = np.clip((-hy * nz * 0.5 + 0.5) * 255, 0, 255)
    nrm[..., 2] = np.clip((nz * 0.5 + 0.5) * 255, 0, 255)
    nrm[..., 3] = 255

    occ = np.empty((S, S, 4), np.uint8)
    occ[..., 0] = np.clip((1.0 - 0.5 * bump) * 255, 0, 255)
    occ[..., 1] = occ[..., 2] = occ[..., 0]
    occ[..., 3] = 255

    emis = np.zeros((S, S, 4), np.uint8)
    band = (yy > 0.545) & (yy < 0.565) & (np.abs(xx - 0.5) < 0.24)
    emis[band] = (40, 220, 255, 255)
    emis[..., 3] = 255

    # helmet dome: partial sphere (polar cap through the face region),
    # slightly elongated, at DamagedHelmet-plus density (160x160 grid =
    # 51,200 triangles vs the Khronos asset's ~15k)
    NLAT, NLON = 160, 160
    th = np.linspace(0.12 * np.pi, 0.78 * np.pi, NLAT + 1)
    ph = np.linspace(0.0, 2 * np.pi, NLON + 1)
    T, P = np.meshgrid(th, ph, indexing="ij")
    grid = np.stack([np.sin(T) * np.cos(P),
                     np.cos(T) * 1.15,
                     np.sin(T) * np.sin(P)], axis=-1)
    # procedural battle damage: a few gaussian dents + a soft weld seam
    # ripple, as RADIAL displacement — real geometric detail the 51k
    # triangles resolve (DamagedHelmet's silhouette is likewise dented)
    dents = [((0.35, 1.2), 0.18, 0.06), ((2.4, 1.8), 0.25, 0.08),
             ((4.6, 0.9), 0.15, 0.05), ((5.5, 2.0), 0.30, 0.04)]
    disp = np.zeros_like(T)
    for (p0, t0), w, depth in dents:
        dp = np.minimum(np.abs(P - p0), 2 * np.pi - np.abs(P - p0))
        disp -= depth * np.exp(-((dp / w) ** 2 + ((T - t0) / w) ** 2))
    disp += 0.008 * np.sin(P * 24) * np.sin(T * 18)      # paneling ripple
    grid = grid * (1.0 + disp)[..., None]
    pos = grid.reshape(-1, 3).astype(F)
    uvs = np.stack([P / (2 * np.pi), (T - th[0]) / (th[-1] - th[0])],
                   axis=-1).reshape(-1, 2).astype(F)
    nlon1 = NLON + 1
    ii = np.arange(NLAT)[:, None] * nlon1 + np.arange(NLON)[None, :]
    a = ii.reshape(-1)
    idx = np.stack([a, a + 1, a + nlon1, a + 1, a + nlon1 + 1, a + nlon1],
                   axis=1).reshape(-1).astype(np.uint32)
    # grid-exact normals of the DISPLACED surface: cross of the two
    # parameter-direction tangents (np.gradient over the position grid)
    du = np.gradient(grid, axis=1)
    dv = np.gradient(grid, axis=0)
    nrm_g = np.cross(dv, du)
    nrm_g /= np.maximum(np.linalg.norm(nrm_g, axis=-1, keepdims=True), 1e-9)
    # orient outward
    sgn = np.sign(np.sum(nrm_g * grid, axis=-1, keepdims=True))
    nrm_g *= np.where(sgn == 0, 1.0, sgn)
    normals = nrm_g.reshape(-1, 3).astype(F)

    imgs = [b.image_png(im) for im in (base, mr, nrm, occ, emis)]
    return b.glb({
        "scene": 0, "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": [{
            "attributes": {"POSITION": b.acc(pos, minmax=True),
                           "NORMAL": b.acc(normals),
                           "TEXCOORD_0": b.acc(uvs)},
            "indices": b.acc(idx), "material": 0}]}],
        "materials": [{
            "pbrMetallicRoughness": {
                "baseColorTexture": {"index": 0},
                "metallicRoughnessTexture": {"index": 1},
            },
            "normalTexture": {"index": 2},
            "occlusionTexture": {"index": 3},
            "emissiveTexture": {"index": 4},
            "emissiveFactor": [1.0, 1.0, 1.0],
        }],
        "textures": [{"source": i} for i in imgs],
    }), ((1.7, 0.9, 1.9), (0.0, 0.1, 0.0))


def _sphere_mesh(b, radius=0.42, rings=12, sectors=24):
    th = np.linspace(0.0, np.pi, rings + 1)
    ph = np.linspace(0.0, 2 * np.pi, sectors + 1)
    T, P = np.meshgrid(th, ph, indexing="ij")
    pos = (np.stack([np.sin(T) * np.cos(P), np.cos(T),
                     np.sin(T) * np.sin(P)], axis=-1)
           .reshape(-1, 3).astype(F) * radius)
    nrm = (pos / np.maximum(np.linalg.norm(pos, axis=1, keepdims=True), 1e-9)
           ).astype(F)
    s1 = sectors + 1
    idx = []
    for i in range(rings):
        for j in range(sectors):
            a = i * s1 + j
            idx += [a, a + 1, a + s1, a + 1, a + s1 + 1, a + s1]
    return (b.acc(pos, minmax=True), b.acc(nrm),
            b.acc(np.asarray(idx, np.uint32)))


def glb_metal_rough_spheres():
    """MetalRoughSpheres-class: a 5x5 grid sweeping metallic (rows) x
    roughness (columns) factors over one shared sphere mesh."""
    b = _GlbBuilder()
    pos_acc, nrm_acc, idx_acc = _sphere_mesh(b)
    mats, meshes, nodes = [], [], []
    n = 5
    for mi in range(n):
        for ri in range(n):
            k = mi * n + ri
            mats.append({"pbrMetallicRoughness": {
                "baseColorFactor": [0.8, 0.6, 0.3, 1.0],
                "metallicFactor": mi / (n - 1),
                "roughnessFactor": ri / (n - 1)}})
            meshes.append({"primitives": [{
                "attributes": {"POSITION": pos_acc, "NORMAL": nrm_acc},
                "indices": idx_acc, "material": k}]})
            nodes.append({"mesh": k, "translation": [
                (ri - (n - 1) / 2) * 1.0, ((n - 1) / 2 - mi) * 1.0, 0.0]})
    return b.glb({
        "scene": 0, "scenes": [{"nodes": list(range(n * n))}],
        "nodes": nodes, "meshes": meshes, "materials": mats,
    }), ((0.0, 0.0, 6.5), (0.0, 0.0, 0.0))


def glb_extensions_compare():
    """Compare*-grid-class: one sphere per KHR material extension —
    clearcoat, sheen, transmission+volume+IOR, specular, iridescence,
    anisotropy, emissive_strength, dispersion — against a plain PBR
    control (the reference's Extensions model set in one scene)."""
    b = _GlbBuilder()
    pos_acc, nrm_acc, idx_acc = _sphere_mesh(b)
    base = {"baseColorFactor": [0.7, 0.2, 0.2, 1.0],
            "metallicFactor": 0.0, "roughnessFactor": 0.4}
    variants = [
        ("control", {}),
        ("clearcoat", {"KHR_materials_clearcoat": {
            "clearcoatFactor": 1.0, "clearcoatRoughnessFactor": 0.1}}),
        ("sheen", {"KHR_materials_sheen": {
            "sheenColorFactor": [0.9, 0.8, 0.3],
            "sheenRoughnessFactor": 0.5}}),
        ("transmission", {"KHR_materials_transmission": {
            "transmissionFactor": 1.0},
            "KHR_materials_volume": {"thicknessFactor": 0.3},
            "KHR_materials_ior": {"ior": 1.5}}),
        ("specular", {"KHR_materials_specular": {
            "specularFactor": 0.3,
            "specularColorFactor": [0.2, 0.6, 1.0]}}),
        ("iridescence", {"KHR_materials_iridescence": {
            "iridescenceFactor": 1.0, "iridescenceIor": 1.3,
            "iridescenceThicknessMaximum": 400.0}}),
        ("anisotropy", {"KHR_materials_anisotropy": {
            "anisotropyStrength": 0.8, "anisotropyRotation": 0.5}}),
        ("emissive", {"KHR_materials_emissive_strength": {
            "emissiveStrength": 3.0}}),
        ("dispersion", {"KHR_materials_dispersion": {"dispersion": 0.1},
                        "KHR_materials_transmission": {
                            "transmissionFactor": 1.0},
                        "KHR_materials_ior": {"ior": 1.5}}),
    ]
    mats, meshes, nodes = [], [], []
    for k, (name, ext) in enumerate(variants):
        m = {"pbrMetallicRoughness": dict(base), "name": name}
        if name == "emissive":
            m["emissiveFactor"] = [1.0, 0.8, 0.2]
        if ext:
            m["extensions"] = ext
        mats.append(m)
        meshes.append({"primitives": [{
            "attributes": {"POSITION": pos_acc, "NORMAL": nrm_acc},
            "indices": idx_acc, "material": k}]})
        nodes.append({"mesh": k, "translation": [
            (k % 3 - 1) * 1.0, (1 - k // 3) * 1.0, 0.0]})
    used = sorted({e for _, ext in variants for e in ext})
    return b.glb({
        "scene": 0, "scenes": [{"nodes": list(range(len(variants)))}],
        "nodes": nodes, "meshes": meshes, "materials": mats,
        "extensionsUsed": used,
    }), ((0.0, 0.0, 4.6), (0.0, 0.0, 0.0))


_EXT_PROBE_VARIANTS = {
    # reference: dedicated per-extension Khronos scenes (frontend
    # collections.rs:96-123 Extensions set: ClearCoat*, Sheen*,
    # Transmission/IOR, Iridescence*, Anisotropy*, SpecularTest,
    # UnlitTest) — one close-up sphere per extension, tight-parity
    # golden targets (tests/test_parity_golden.py parity-ext-*-512)
    "clearcoat": {"KHR_materials_clearcoat": {
        "clearcoatFactor": 1.0, "clearcoatRoughnessFactor": 0.08}},
    "sheen": {"KHR_materials_sheen": {
        "sheenColorFactor": [0.9, 0.75, 0.3],
        "sheenRoughnessFactor": 0.45}},
    "transmission": {"KHR_materials_transmission": {
        "transmissionFactor": 1.0},
        "KHR_materials_volume": {
            "thicknessFactor": 0.4,
            "attenuationColor": [0.6, 0.8, 0.9],
            "attenuationDistance": 2.0},
        "KHR_materials_ior": {"ior": 1.5}},
    "specular": {"KHR_materials_specular": {
        "specularFactor": 0.35,
        "specularColorFactor": [0.2, 0.55, 1.0]}},
    # metallic base: thin-film interference modulates f0, so the effect
    # is strongest on metals (the reference probes it with
    # IridescenceMetallicSpheres)
    "iridescence": {"KHR_materials_iridescence": {
        "iridescenceFactor": 1.0, "iridescenceIor": 1.8,
        "iridescenceThicknessMinimum": 100.0,
        "iridescenceThicknessMaximum": 400.0}},
    "anisotropy": {"KHR_materials_anisotropy": {
        "anisotropyStrength": 0.9, "anisotropyRotation": 0.6}},
    "unlit": {"KHR_materials_unlit": {}},
}


def glb_ext_probe(variant: str):
    """Single-extension close-up: one sphere carrying exactly one KHR
    material extension (`variant` from _EXT_PROBE_VARIANTS), framed to
    fill the view — the per-extension analog of the reference's
    dedicated extension test scenes, as tight-golden material."""
    ext = _EXT_PROBE_VARIANTS[variant]
    b = _GlbBuilder()
    pos_acc, nrm_acc, idx_acc = _sphere_mesh(b)
    m = {"pbrMetallicRoughness": {
        "baseColorFactor": [0.72, 0.22, 0.18, 1.0],
        "metallicFactor": 0.0, "roughnessFactor": 0.35},
        "name": variant, "extensions": ext}
    if variant in ("anisotropy", "iridescence"):
        # specular-dominant extensions read best on metal (anisotropy
        # additionally needs tangents; the loader generates them from
        # UVs)
        m["pbrMetallicRoughness"]["metallicFactor"] = 0.9
        m["pbrMetallicRoughness"]["roughnessFactor"] = 0.45
    mats = [m]
    meshes = [{"primitives": [{
        "attributes": {"POSITION": pos_acc, "NORMAL": nrm_acc},
        "indices": idx_acc, "material": 0}]}]
    nodes = [{"mesh": 0, "scale": [1.6, 1.6, 1.6]}]
    if variant == "transmission":
        # a checkered backdrop BEHIND the glass: against a uniform sky a
        # smooth fully-transmissive sphere is (correctly) near-invisible;
        # refraction of a patterned background is what the probe must pin
        # (reference TransmissionTest poses its spheres over test cards)
        img = b.image_png(_checker_rgba(a=(40, 90, 180), b=(235, 235, 225)))
        quad = np.array([[-2.4, -1.4, 0], [2.4, -1.4, 0],
                         [2.4, 1.4, 0], [-2.4, 1.4, 0]], F)
        uvq = np.array([[0, 1], [3, 1], [3, 0], [0, 0]], F)
        nq = np.tile(np.array([[0, 0, 1]], F), (4, 1))
        qidx = np.array([0, 1, 2, 0, 2, 3], np.uint16)
        mats.append({"pbrMetallicRoughness": {
            "baseColorTexture": {"index": 0},
            "metallicFactor": 0.0, "roughnessFactor": 0.9}})
        meshes.append({"primitives": [{
            "attributes": {"POSITION": b.acc(quad, minmax=True),
                           "NORMAL": b.acc(nq),
                           "TEXCOORD_0": b.acc(uvq)},
            "indices": b.acc(qidx), "material": 1}]})
        nodes.append({"mesh": 1, "translation": [0.0, 0.0, -1.6]})
    doc = {
        "scene": 0, "scenes": [{"nodes": list(range(len(nodes)))}],
        "nodes": nodes, "meshes": meshes, "materials": mats,
        "extensionsUsed": sorted(ext),
    }
    if b.images:
        doc["textures"] = [{"source": 0}]
    return b.glb(doc), ((0.0, 0.35, 2.4), (0.0, 0.0, 0.0))


def glb_npot_texture():
    """BoxTexturedNonPowerOfTwo-class: a textured quad whose base-color
    map is 100x75 — NON-power-of-two on both axes. Pins the mip-chain
    fallback path (non-integer area ratios route through the cv2/numpy
    chain, never the native integer-ratio packer) and NPOT descriptor
    wiring end to end."""
    b = _GlbBuilder()
    yy, xx = np.mgrid[0:75, 0:100]
    c = ((yy // 10 + xx // 10) % 2).astype(bool)
    img = np.empty((75, 100, 4), np.uint8)
    img[c] = (230, 60, 40, 255)
    img[~c] = (40, 80, 220, 255)
    tex = b.image_png(img)
    quad = np.array([[-0.8, -0.6, 0], [0.8, -0.6, 0],
                     [0.8, 0.6, 0], [-0.8, 0.6, 0]], F)
    uv = np.array([[0, 1], [1, 1], [1, 0], [0, 0]], F)
    nrm = np.tile(np.array([[0, 0, 1]], F), (4, 1))
    idx = np.array([0, 1, 2, 0, 2, 3], np.uint16)
    return b.glb({
        "scene": 0, "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": [{
            "attributes": {"POSITION": b.acc(quad, minmax=True),
                           "NORMAL": b.acc(nrm), "TEXCOORD_0": b.acc(uv)},
            "indices": b.acc(idx), "material": 0}]}],
        "materials": [{"pbrMetallicRoughness": {
            "baseColorTexture": {"index": 0},
            "metallicFactor": 0.0, "roughnessFactor": 0.9}}],
        "textures": [{"source": tex}],
    }), ((0.0, 0.0, 1.8), (0.0, 0.0, 0.0))


def glb_sponza_lite():
    """Sponza-class open-world probe through the FULL glTF path: a
    textured floor, a 7x7 colonnade of shared-mesh columns and spheres
    (many nodes referencing few meshes — exercises the populate
    primitive-resource dedup), a ring of alpha-blended glass panes, and
    KHR_lights_punctual directional + point lights. ~21k triangles —
    the benchmark protocol's config-5 scene shape at CPU-testable
    scale (bench.py measures the 260k-triangle procedural analog)."""
    b = _GlbBuilder()
    tex0 = b.image_png(_checker_rgba(a=(200, 160, 110), b=(90, 70, 50)))
    tex1 = b.image_png(_checker_rgba(a=(70, 90, 140), b=(210, 210, 220)))

    # shared meshes: column (box), sphere, pane, floor
    col = np.array([[-0.3, 0, -0.3], [0.3, 0, -0.3], [0.3, 1.6, -0.3],
                    [-0.3, 1.6, -0.3], [-0.3, 0, 0.3], [0.3, 0, 0.3],
                    [0.3, 1.6, 0.3], [-0.3, 1.6, 0.3]], F)
    col_uv = np.array([[0, 1], [1, 1], [1, 0], [0, 0],
                       [0, 1], [1, 1], [1, 0], [0, 0]], F)
    col_idx = np.array([0, 2, 1, 0, 3, 2, 4, 5, 6, 4, 6, 7,
                        0, 1, 5, 0, 5, 4, 3, 7, 6, 3, 6, 2,
                        0, 4, 7, 0, 7, 3, 1, 2, 6, 1, 6, 5], np.uint16)
    pos_s, nrm_s, idx_s = _sphere_mesh(b, radius=0.45, rings=16, sectors=32)
    pane = np.array([[-0.45, 0, 0], [0.45, 0, 0],
                     [0.45, 1.2, 0], [-0.45, 1.2, 0]], F)
    pane_idx = np.array([0, 1, 2, 0, 2, 3], np.uint16)
    floor = np.array([[-8, 0, -8], [8, 0, -8], [8, 0, 8], [-8, 0, 8]], F)
    floor_uv = np.array([[0, 8], [8, 8], [8, 0], [0, 0]], F)
    floor_idx = np.array([0, 2, 1, 0, 3, 2], np.uint16)  # up-facing

    meshes = [
        {"primitives": [{"attributes": {
            "POSITION": b.acc(col, minmax=True), "TEXCOORD_0": b.acc(col_uv)},
            "indices": b.acc(col_idx), "material": 0}]},          # 0 column
        {"primitives": [{"attributes": {
            "POSITION": pos_s, "NORMAL": nrm_s},
            "indices": idx_s, "material": 1}]},                   # 1 sphere
        {"primitives": [{"attributes": {
            "POSITION": b.acc(pane, minmax=True)},
            "indices": b.acc(pane_idx), "material": 2}]},         # 2 pane
        {"primitives": [{"attributes": {
            "POSITION": b.acc(floor, minmax=True),
            "TEXCOORD_0": b.acc(floor_uv)},
            "indices": b.acc(floor_idx), "material": 3}]},        # 3 floor
    ]
    mats = [
        {"pbrMetallicRoughness": {"baseColorTexture": {"index": 0},
                                  "metallicFactor": 0.1,
                                  "roughnessFactor": 0.7}},
        {"pbrMetallicRoughness": {"baseColorFactor": [0.8, 0.7, 0.4, 1.0],
                                  "metallicFactor": 0.8,
                                  "roughnessFactor": 0.25}},
        {"pbrMetallicRoughness": {"baseColorFactor": [0.4, 0.7, 0.9, 0.4],
                                  "roughnessFactor": 0.1},
         "alphaMode": "BLEND", "doubleSided": True},
        {"pbrMetallicRoughness": {"baseColorTexture": {"index": 1},
                                  "roughnessFactor": 0.9}},
    ]
    nodes = [{"mesh": 3}]
    for gx in range(-3, 4):
        for gz in range(-3, 4):
            m = 0 if (gx + gz) % 2 == 0 else 1
            y = 0.0 if m == 0 else 0.6
            nodes.append({"mesh": m,
                          "translation": [gx * 2.0, y, gz * 2.0]})
    for i in range(10):
        a = 2 * np.pi * i / 10
        nodes.append({"mesh": 2,
                      "translation": [np.cos(a) * 5.2, 0.2, np.sin(a) * 5.2],
                      "rotation": [0.0, float(np.sin(-a / 2)), 0.0,
                                   float(np.cos(-a / 2))]})
    # KHR_lights_punctual: 1 directional + 3 points
    lights = [{"type": "directional", "intensity": 2.0}]
    light_nodes = [{"rotation": [0.35, 0.1, 0.0, 0.93],
                    "extensions": {"KHR_lights_punctual": {"light": 0}}}]
    for i in range(3):
        lights.append({"type": "point", "intensity": 12.0, "range": 12.0,
                       "color": [1.0, 0.8 - 0.2 * i, 0.5 + 0.15 * i]})
        a = 2 * np.pi * i / 3
        light_nodes.append({
            "translation": [np.cos(a) * 3.5, 2.2, np.sin(a) * 3.5],
            "extensions": {"KHR_lights_punctual": {"light": i + 1}}})
    nodes.extend(light_nodes)
    return b.glb({
        "scene": 0, "scenes": [{"nodes": list(range(len(nodes)))}],
        "nodes": nodes, "meshes": meshes, "materials": mats,
        "textures": [{"source": tex0}, {"source": tex1}],
        "extensions": {"KHR_lights_punctual": {"lights": lights}},
        "extensionsUsed": ["KHR_lights_punctual"],
    }), ((7.5, 4.5, 7.5), (0.0, 0.6, 0.0))


def glb_multi_uv():
    """MultiUVTest-class: one quad with TWO uv sets — baseColor samples
    TEXCOORD_0, emissive samples TEXCOORD_1 (shifted/scaled), so a wrong
    uv-set route shows immediately."""
    b = _GlbBuilder()
    img0 = b.image_png(_checker_rgba(a=(40, 120, 220), b=(235, 235, 235)))
    emis = np.zeros((64, 64, 4), np.uint8)
    emis[24:40, :, 1] = 200                      # horizontal green band
    emis[..., 3] = 255
    img1 = b.image_png(emis)
    quad = np.array([[-0.8, -0.5, 0], [0.8, -0.5, 0],
                     [0.8, 0.5, 0], [-0.8, 0.5, 0]], F)
    uv0 = np.array([[0, 1], [1, 1], [1, 0], [0, 0]], F)
    uv1 = np.array([[0, 2], [2, 2], [2, 0], [0, 0]], F)   # 2x tiled band
    idx = np.array([0, 1, 2, 0, 2, 3], np.uint16)
    return b.glb({
        "scene": 0, "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": [{
            "attributes": {"POSITION": b.acc(quad, minmax=True),
                           "TEXCOORD_0": b.acc(uv0),
                           "TEXCOORD_1": b.acc(uv1)},
            "indices": b.acc(idx), "material": 0}]}],
        "materials": [{
            "pbrMetallicRoughness": {
                "baseColorTexture": {"index": 0, "texCoord": 0},
                "roughnessFactor": 0.9},
            "emissiveTexture": {"index": 1, "texCoord": 1},
            "emissiveFactor": [1.0, 1.0, 1.0],
        }],
        "textures": [{"source": img0}, {"source": img1}],
    }), ((0.0, 0.0, 1.9), (0.0, 0.0, 0.0))


def glb_negative_scale():
    """NegativeScaleTest-class: the same box under positive and negative
    node scale — mirrored geometry flips triangle winding, and the
    populate/vertex path must keep the mirrored mesh visible (the
    reference fixes winding at conversion; here the orientation swap in
    finish_setup handles it)."""
    b = _GlbBuilder()
    col = np.array([[-0.4, -0.4, -0.4], [0.4, -0.4, -0.4],
                    [0.4, 0.4, -0.4], [-0.4, 0.4, -0.4],
                    [-0.4, -0.4, 0.4], [0.4, -0.4, 0.4],
                    [0.4, 0.4, 0.4], [-0.4, 0.4, 0.4]], F)
    idx = np.array([0, 2, 1, 0, 3, 2, 4, 5, 6, 4, 6, 7,
                    0, 1, 5, 0, 5, 4, 3, 7, 6, 3, 6, 2,
                    0, 4, 7, 0, 7, 3, 1, 2, 6, 1, 6, 5], np.uint16)
    return b.glb({
        "scene": 0, "scenes": [{"nodes": [0, 1]}],
        "nodes": [
            {"mesh": 0, "translation": [-0.7, 0, 0]},
            {"mesh": 0, "translation": [0.7, 0, 0],
             "scale": [-1.0, 1.0, 1.0]},
        ],
        "meshes": [{"primitives": [{
            "attributes": {"POSITION": b.acc(col, minmax=True)},
            "indices": b.acc(idx), "material": 0}]}],
        "materials": [{"pbrMetallicRoughness": {
            "baseColorFactor": [0.3, 0.7, 0.4, 1.0],
            "roughnessFactor": 0.5, "metallicFactor": 0.1}}],
    }), ((0.0, 0.8, 2.6), (0.0, 0.0, 0.0))


def glb_cameras():
    """Cameras-class: a scene carrying its own glTF perspective camera
    node — populate surfaces it through GltfKeyLookups.cameras so the
    app can frame the scene exactly as authored."""
    b = _GlbBuilder()
    tri = np.array([[-0.6, -0.4, 0], [0.6, -0.4, 0], [0.0, 0.6, 0]], F)
    return b.glb({
        "scene": 0, "scenes": [{"nodes": [0, 1]}],
        "nodes": [
            {"mesh": 0},
            {"camera": 0, "translation": [0.4, 0.3, 2.2],
             "rotation": [0.0, 0.08715574, 0.0, 0.9961947]},  # yaw 10°
        ],
        "cameras": [{"type": "perspective", "perspective": {
            "yfov": 0.9, "znear": 0.05, "zfar": 50.0}}],
        "meshes": [{"primitives": [{
            "attributes": {"POSITION": b.acc(tri, minmax=True)},
            "material": 0}]}],
        "materials": [{"pbrMetallicRoughness": {
            "baseColorFactor": [0.9, 0.5, 0.1, 1.0],
            "roughnessFactor": 0.7}}],
    }), ((0.4, 0.3, 2.2), (0.0, 0.0, 0.0))


def glb_box_animated():
    """BoxAnimated-class: one node driven by THREE channels, one per
    glTF interpolation mode — LINEAR rotation, CUBICSPLINE translation
    (in-tangent/value/out-tangent triples), STEP scale — so every
    sampler path of animation parsing and playback shows in one probe."""
    b = _GlbBuilder()
    col = np.array([[-0.3, -0.3, -0.3], [0.3, -0.3, -0.3],
                    [0.3, 0.3, -0.3], [-0.3, 0.3, -0.3],
                    [-0.3, -0.3, 0.3], [0.3, -0.3, 0.3],
                    [0.3, 0.3, 0.3], [-0.3, 0.3, 0.3]], F)
    idx = np.array([0, 2, 1, 0, 3, 2, 4, 5, 6, 4, 6, 7,
                    0, 1, 5, 0, 5, 4, 3, 7, 6, 3, 6, 2,
                    0, 4, 7, 0, 7, 3, 1, 2, 6, 1, 6, 5], np.uint16)
    t_in = np.array([0.0, 0.5, 1.0], F)
    # LINEAR rotation: identity -> yaw 90 -> yaw 180 (shortest-path slerp)
    rot = np.array([[0, 0, 0, 1],
                    [0, np.sin(np.pi / 4), 0, np.cos(np.pi / 4)],
                    [0, 1, 0, 0]], F)
    # CUBICSPLINE translation: (in_tangent, value, out_tangent) per key
    trans = np.array([
        [[0, 0, 0], [0.0, -0.2, 0], [0, 2.4, 0]],
        [[0, 2.4, 0], [0.0, 0.4, 0], [0, -2.4, 0]],
        [[0, -2.4, 0], [0.0, -0.2, 0], [0, 0, 0]],
    ], F).reshape(9, 3)
    # STEP scale: 1 -> 1.4 -> 0.8
    scl = np.array([[1, 1, 1], [1.4, 1.4, 1.4], [0.8, 0.8, 0.8]], F)
    t_acc = b.acc(t_in, minmax=True)
    return b.glb({
        "scene": 0, "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": [{
            "attributes": {"POSITION": b.acc(col, minmax=True)},
            "indices": b.acc(idx), "material": 0}]}],
        "materials": [{"pbrMetallicRoughness": {
            "baseColorFactor": [0.9, 0.45, 0.15, 1.0],
            "roughnessFactor": 0.5}}],
        "animations": [{
            "samplers": [
                {"input": t_acc, "interpolation": "LINEAR",
                 "output": b.acc(rot)},
                {"input": t_acc, "interpolation": "CUBICSPLINE",
                 "output": b.acc(trans)},
                {"input": t_acc, "interpolation": "STEP",
                 "output": b.acc(scl)},
            ],
            "channels": [
                {"sampler": 0, "target": {"node": 0, "path": "rotation"}},
                {"sampler": 1, "target": {"node": 0, "path": "translation"}},
                {"sampler": 2, "target": {"node": 0, "path": "scale"}},
            ]}],
    }), ((0.9, 0.7, 1.9), (0.0, 0.1, 0.0))


def glb_unlit():
    """KHR_materials_unlit probe: an unlit textured quad next to a lit
    PBR quad of the same base color — the unlit one must ignore the
    oblique directional light entirely."""
    b = _GlbBuilder()
    img = b.image_png(_checker_rgba(a=(220, 60, 150), b=(245, 235, 235)))
    quad = np.array([[-0.45, -0.45, 0], [0.45, -0.45, 0],
                     [0.45, 0.45, 0], [-0.45, 0.45, 0]], F)
    uv = np.array([[0, 1], [1, 1], [1, 0], [0, 0]], F)
    idx = np.array([0, 1, 2, 0, 2, 3], np.uint16)
    q = b.acc(quad, minmax=True)
    u = b.acc(uv)
    i = b.acc(idx)
    return b.glb({
        "scene": 0, "scenes": [{"nodes": [0, 1, 2]}],
        "nodes": [
            {"mesh": 0, "translation": [-0.55, 0, 0]},
            {"mesh": 1, "translation": [0.55, 0, 0]},
            {"extensions": {"KHR_lights_punctual": {"light": 0}},
             "rotation": [-0.3826834, 0.0, 0.0, 0.9238795]},
        ],
        "meshes": [
            {"primitives": [{"attributes": {"POSITION": q, "TEXCOORD_0": u},
                             "indices": i, "material": 0}]},
            {"primitives": [{"attributes": {"POSITION": q, "TEXCOORD_0": u},
                             "indices": i, "material": 1}]},
        ],
        "materials": [
            {"pbrMetallicRoughness": {"baseColorTexture": {"index": 0}},
             "extensions": {"KHR_materials_unlit": {}}},
            {"pbrMetallicRoughness": {"baseColorTexture": {"index": 0},
                                      "roughnessFactor": 0.6}},
        ],
        "textures": [{"source": 0}],
        "extensions": {"KHR_lights_punctual": {"lights": [
            {"type": "directional", "intensity": 1.2}]}},
        "extensionsUsed": ["KHR_materials_unlit", "KHR_lights_punctual"],
    }), ((0.0, 0.15, 1.9), (0.0, 0.0, 0.0))


def glb_fox():
    """Fox-class (collections.rs Animation set): THREE named clips on ONE
    skeleton — the skeleton is a 3-bone chain skinning a vertical strip,
    and the clips (\"Survey\", \"Walk\", \"Run\") bend it by different
    amounts at different rates. Probes multiple-animations-per-skin
    parsing, per-clip players, runtime clip switching and crossfade
    (Animations.crossfade)."""
    b = _GlbBuilder()
    n = 6
    pos, jnts, wts = [], [], []
    for i in range(n + 1):
        y = i / n * 3.0
        # hard-assign vertices to the nearest bone (y=0/1/2), blend 50/50
        # midway — keeps expected tip positions analytic for the tests
        fb = min(y, 2.0)
        b0 = int(np.floor(fb + 0.5)) if fb < 2.0 else 2
        for x in (-0.2, 0.2):
            pos.append([x, y, 0])
            jnts.append([b0, 0, 0, 0])
            wts.append([1.0, 0, 0, 0])
    idx = []
    for i in range(n):
        v = i * 2
        idx += [v, v + 1, v + 3, v, v + 3, v + 2]
    ibm = np.stack([np.eye(4, dtype=F) for _ in range(3)])
    ibm[1][1, 3] = -1.0
    ibm[2][1, 3] = -2.0
    ibm_cm = np.ascontiguousarray(ibm.transpose(0, 2, 1)).reshape(3, 16)
    t_in = np.array([0.0, 1.0, 2.0], F)

    def bend_clip(max_angle, node):
        """rotation channel around z on `node`: 0 -> max -> 0."""
        h = max_angle / 2
        quats = np.array([
            [0, 0, 0, 1],
            [0, 0, np.sin(h), np.cos(h)],
            [0, 0, 0, 1]], F)
        return quats

    anims = []
    for name, ang in (("Survey", 0.15), ("Walk", 0.5), ("Run", 1.0)):
        anims.append({
            "name": name,
            "samplers": [
                {"input": b.acc(t_in, minmax=True),
                 "interpolation": "LINEAR",
                 "output": b.acc(bend_clip(ang, 2))},
                {"input": b.acc(t_in, minmax=True),
                 "interpolation": "LINEAR",
                 "output": b.acc(bend_clip(ang * 0.7, 3))},
            ],
            "channels": [
                {"sampler": 0, "target": {"node": 2, "path": "rotation"}},
                {"sampler": 1, "target": {"node": 3, "path": "rotation"}},
            ]})
    return b.glb({
        "scene": 0, "scenes": [{"nodes": [0, 1]}],
        "nodes": [
            {"mesh": 0, "skin": 0},
            {"children": [2]},                         # bone0 root at y=0
            {"translation": [0, 1, 0], "children": [3]},   # bone1
            {"translation": [0, 1, 0]},                    # bone2 (y=2)
        ],
        "skins": [{"joints": [1, 2, 3],
                   "inverseBindMatrices": b.acc(ibm_cm.reshape(3, 16))}],
        "meshes": [{"primitives": [{
            "attributes": {
                "POSITION": b.acc(np.asarray(pos, F), minmax=True),
                "JOINTS_0": b.acc(np.asarray(jnts, np.uint8)),
                "WEIGHTS_0": b.acc(np.asarray(wts, F))},
            "indices": b.acc(np.asarray(idx, np.uint16)), "material": 0}]}],
        "materials": [{"pbrMetallicRoughness": {
            "baseColorFactor": [0.85, 0.45, 0.15, 1.0],
            "roughnessFactor": 0.6}}],
        "animations": anims,
    }), ((0.5, 1.6, 4.4), (0.0, 1.5, 0.0))


def glb_recursive_skeletons():
    """RecursiveSkeletons-class: a 12-deep joint chain (each joint a
    child of the previous, unit y-offsets) skinning a tall strip, every
    vertex bound to its nearest single joint. Probes deep hierarchy
    world propagation + joint-matrix recompute along long dirty chains;
    bending the ROOT must move the tip by the full chain length."""
    b = _GlbBuilder()
    depth = 12
    pos, jnts, wts = [], [], []
    for i in range(depth + 1):
        y = float(i)
        for x in (-0.15, 0.15):
            pos.append([x, y, 0])
            jnts.append([min(i, depth - 1), 0, 0, 0])
            wts.append([1.0, 0, 0, 0])
    idx = []
    for i in range(depth):
        v = i * 2
        idx += [v, v + 1, v + 3, v, v + 3, v + 2]
    ibm = np.stack([np.eye(4, dtype=F) for _ in range(depth)])
    for j in range(depth):
        ibm[j][1, 3] = -float(j)
    ibm_cm = np.ascontiguousarray(ibm.transpose(0, 2, 1)).reshape(depth, 16)
    # node 0 = mesh; nodes 1..depth = joint chain
    nodes = [{"mesh": 0, "skin": 0}]
    for j in range(depth):
        nd = {"translation": [0, 0 if j == 0 else 1, 0]}
        if j < depth - 1:
            nd["children"] = [j + 2]
        nodes.append(nd)
    return b.glb({
        "scene": 0, "scenes": [{"nodes": [0, 1]}],
        "nodes": nodes,
        "skins": [{"joints": list(range(1, depth + 1)),
                   "inverseBindMatrices": b.acc(ibm_cm.reshape(depth, 16))}],
        "meshes": [{"primitives": [{
            "attributes": {
                "POSITION": b.acc(np.asarray(pos, F), minmax=True),
                "JOINTS_0": b.acc(np.asarray(jnts, np.uint8)),
                "WEIGHTS_0": b.acc(np.asarray(wts, F))},
            "indices": b.acc(np.asarray(idx, np.uint16)), "material": 0}]}],
        "materials": [{"pbrMetallicRoughness": {
            "baseColorFactor": [0.3, 0.7, 0.5, 1.0],
            "roughnessFactor": 0.7}}],
    }), ((2.0, 6.0, 16.0), (0.0, 6.0, 0.0))


def glb_orientation():
    """OrientationTest-class: boxes under COMPOSED non-identity TRS —
    parent (translate + 90° yaw + scale 2) × child (translate + 45°
    roll + scale 0.5). The composed world positions are analytic, so
    the test asserts the loader/propagation applies T·R·S in glTF
    order through the hierarchy."""
    b = _GlbBuilder()
    col = np.array([[-0.5, -0.5, -0.5], [0.5, -0.5, -0.5],
                    [0.5, 0.5, -0.5], [-0.5, 0.5, -0.5],
                    [-0.5, -0.5, 0.5], [0.5, -0.5, 0.5],
                    [0.5, 0.5, 0.5], [-0.5, 0.5, 0.5]], F)
    idx = np.array([0, 2, 1, 0, 3, 2, 4, 5, 6, 4, 6, 7,
                    0, 1, 5, 0, 5, 4, 3, 7, 6, 3, 6, 2,
                    0, 4, 7, 0, 7, 3, 1, 2, 6, 1, 6, 5], np.uint16)
    s2 = float(np.sin(np.pi / 4))
    c2 = float(np.cos(np.pi / 4))
    s8 = float(np.sin(np.pi / 8))
    c8 = float(np.cos(np.pi / 8))
    p = b.acc(col, minmax=True)
    i = b.acc(idx)
    return b.glb({
        "scene": 0, "scenes": [{"nodes": [0, 2]}],
        "nodes": [
            # parent: translate(1,0,0), yaw 90 (quat y), scale 2, child 1
            {"translation": [1, 0, 0], "rotation": [0, s2, 0, c2],
             "scale": [2, 2, 2], "children": [1]},
            # child: translate(0,1,0), roll 45 (quat z), scale 0.5
            {"mesh": 0, "translation": [0, 1, 0],
             "rotation": [0, 0, s8, c8], "scale": [0.5, 0.5, 0.5]},
            # reference box at origin, identity
            {"mesh": 1},
        ],
        "meshes": [
            {"primitives": [{"attributes": {"POSITION": p}, "indices": i,
                             "material": 0}]},
            {"primitives": [{"attributes": {"POSITION": p}, "indices": i,
                             "material": 1}]},
        ],
        "materials": [
            {"pbrMetallicRoughness": {
                "baseColorFactor": [0.9, 0.2, 0.2, 1.0],
                "roughnessFactor": 0.6}},
            {"pbrMetallicRoughness": {
                "baseColorFactor": [0.2, 0.2, 0.9, 1.0],
                "roughnessFactor": 0.6}},
        ],
    }), ((2.5, 3.2, 7.0), (0.6, 1.0, 0.0))


def glb_texture_settings():
    """TextureSettingsTest-class: one texture bound through SIX distinct
    glTF samplers — {REPEAT, CLAMP_TO_EDGE, MIRRORED_REPEAT} wrap ×
    {LINEAR, NEAREST} mag filter — on a 3×2 grid of quads whose UVs run
    [-0.25, 2.25] so out-of-range behavior is visible. Probes the full
    loader sampler path (populate _WRAP_MAP + filter flags), which r3
    only covered at op level."""
    b = _GlbBuilder()
    img = b.image_png(_checker_rgba(size=32, a=(200, 40, 40),
                                    b=(245, 245, 245)))
    quad = np.array([[-0.45, -0.45, 0], [0.45, -0.45, 0],
                     [0.45, 0.45, 0], [-0.45, 0.45, 0]], F)
    uv = np.array([[-0.25, 2.25], [2.25, 2.25],
                   [2.25, -0.25], [-0.25, -0.25]], F)
    idx = np.array([0, 1, 2, 0, 2, 3], np.uint16)
    q = b.acc(quad, minmax=True)
    u = b.acc(uv)
    i = b.acc(idx)
    wraps = [10497, 33071, 33648]             # repeat / clamp / mirror
    mags = [9729, 9728]                       # linear / nearest
    samplers, textures, mats, meshes, nodes = [], [], [], [], []
    k = 0
    for row, mag in enumerate(mags):
        for colm, wrap in enumerate(wraps):
            samplers.append({"magFilter": mag, "minFilter": mag,
                             "wrapS": wrap, "wrapT": wrap})
            textures.append({"source": img, "sampler": k})
            mats.append({"pbrMetallicRoughness": {
                "baseColorTexture": {"index": k}, "roughnessFactor": 0.9}})
            meshes.append({"primitives": [{
                "attributes": {"POSITION": q, "TEXCOORD_0": u},
                "indices": i, "material": k}]})
            nodes.append({"mesh": k,
                          "translation": [(colm - 1) * 1.05,
                                          (0.5 - row) * 1.05, 0]})
            k += 1
    return b.glb({
        "scene": 0, "scenes": [{"nodes": list(range(6))}],
        "nodes": nodes, "meshes": meshes, "materials": mats,
        "textures": textures, "samplers": samplers,
    }), ((0.0, 0.0, 2.6), (0.0, 0.0, 0.0))


def glb_morph_stress():
    """MorphStressTest-class: EIGHT position morph targets on one grid
    mesh with ALL EIGHT weights animated simultaneously by one weights
    channel (8 values per keyframe). Probes wide-weight parsing, the
    pow2 morph-bucket widening, and per-frame many-target playback."""
    b = _GlbBuilder()
    n = 4
    xs = np.linspace(-1, 1, n + 1, dtype=F)
    ys = np.linspace(-0.5, 0.5, n + 1, dtype=F)
    pos = np.array([[x, y, 0] for y in ys for x in xs], F)
    idx = []
    for r in range(n):
        for c in range(n):
            v = r * (n + 1) + c
            idx += [v, v + 1, v + n + 2, v, v + n + 2, v + n + 1]
    idx = np.asarray(idx, np.uint16)
    targets = []
    rng = np.random.default_rng(11)
    for t in range(8):
        d = np.zeros_like(pos)
        # each target pushes a distinct bump in +z
        cx, cy = rng.uniform(-0.8, 0.8), rng.uniform(-0.4, 0.4)
        w = np.exp(-(((pos[:, 0] - cx) / 0.4) ** 2
                     + ((pos[:, 1] - cy) / 0.3) ** 2))
        d[:, 2] = 0.4 * w
        targets.append({"POSITION": b.acc(d.astype(F), minmax=True)})
    t_in = np.array([0.0, 1.0, 2.0], F)
    w0 = np.zeros(8, F)
    w1 = np.linspace(0.1, 1.0, 8).astype(F)
    t_out = np.concatenate([w0, w1, w0])
    return b.glb({
        "scene": 0, "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": [{
            "attributes": {"POSITION": b.acc(pos, minmax=True)},
            "indices": b.acc(idx), "material": 0,
            "targets": targets}],
            "weights": [0.0] * 8}],
        "materials": [{"pbrMetallicRoughness": {
            "baseColorFactor": [0.4, 0.6, 0.9, 1.0],
            "roughnessFactor": 0.5}}],
        "animations": [{
            "samplers": [{"input": b.acc(t_in, minmax=True),
                          "interpolation": "LINEAR",
                          "output": b.acc(t_out)}],
            "channels": [{"sampler": 0,
                          "target": {"node": 0, "path": "weights"}}]}],
    }), ((0.0, 0.7, 2.6), (0.0, 0.0, 0.0))


def glb_non_indexed():
    """TriangleWithoutIndices/VertexColorTest-class: a NON-INDEXED
    primitive (no `indices` accessor — glTF 2.0 §3.7.2.1 independent
    triangles) carrying a normalized-u8 COLOR_0 attribute. Probes the
    loader's implicit-index triangulation and vertex-color modulation
    in one asset."""
    b = _GlbBuilder()
    # two triangles forming a quad, written OUT-OF-ORDER as raw corners
    pos = np.array([
        [-0.6, -0.4, 0], [0.6, -0.4, 0], [0.6, 0.4, 0],      # tri 0
        [-0.6, -0.4, 0], [0.6, 0.4, 0], [-0.6, 0.4, 0],      # tri 1
    ], F)
    col = np.array([
        [255, 40, 40, 255], [40, 255, 40, 255], [40, 40, 255, 255],
        [255, 40, 40, 255], [40, 40, 255, 255], [255, 255, 40, 255],
    ], np.uint8)
    return b.glb({
        "scene": 0, "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": [{
            "attributes": {
                "POSITION": b.acc(pos, minmax=True),
                "COLOR_0": b.acc(col, normalized=True)},
            "material": 0}]}],   # NO indices key
        "materials": [{"pbrMetallicRoughness": {
            "baseColorFactor": [1.0, 1.0, 1.0, 1.0],
            "roughnessFactor": 0.9}}],
    }), ((0.0, 0.15, 1.7), (0.0, 0.0, 0.0))


SAMPLES = {
    "glb-fox": glb_fox,
    "glb-non-indexed": glb_non_indexed,
    "glb-recursive-skeletons": glb_recursive_skeletons,
    "glb-orientation": glb_orientation,
    "glb-texture-settings": glb_texture_settings,
    "glb-morph-stress": glb_morph_stress,
    "glb-box-animated": glb_box_animated,
    "glb-unlit": glb_unlit,
    "glb-helmet": glb_helmet,
    "glb-metal-rough-spheres": glb_metal_rough_spheres,
    "glb-extensions-compare": glb_extensions_compare,
    "glb-sponza-lite": glb_sponza_lite,
    "glb-multi-uv": glb_multi_uv,
    "glb-negative-scale": glb_negative_scale,
    "glb-cameras": glb_cameras,
    "glb-many-influences": glb_many_influences,
    "glb-sparse-displaced": glb_sparse_displaced,
    "glb-mirrored-tangent": glb_mirrored_tangent,
    "glb-interleaved": glb_interleaved,
    "glb-strip-fan": glb_strip_fan,
    "glb-instanced": glb_instanced,
    "glb-normalized-attrs": glb_normalized_attrs,
    "glb-skinned": glb_skinned,
    "glb-morphed": glb_morphed,
    "glb-texture-transform": glb_texture_transform,
    "glb-alpha-modes": glb_alpha_modes,
    "glb-npot-texture": glb_npot_texture,
    "glb-two-skins": glb_two_skins,
}

import functools as _ft

for _v in _EXT_PROBE_VARIANTS:
    SAMPLES[f"glb-ext-{_v}"] = _ft.partial(glb_ext_probe, _v)
del _ft, _v


def write_sample(name: str, path: str) -> tuple:
    """Build catalog entry `name` as a .glb file; returns (eye, center)."""
    glb_bytes, cam = SAMPLES[name]()
    with open(path, "wb") as f:
        f.write(glb_bytes)
    return cam
