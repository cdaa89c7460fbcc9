"""A GLB writer and the generated helmet asset: a dented, panelled dome at
DamagedHelmet's sizes with the full five-map PBR set. Frozen here
so the asset is the benchmark's own; the seed draws the scratches and
the panel tint, never a size."""

from __future__ import annotations

import io
import json
import struct

import numpy as np

F = np.float32
_CTYPE = {np.dtype(np.uint8): 5121, np.dtype(np.uint16): 5123,
          np.dtype(np.uint32): 5125, np.dtype(np.float32): 5126}
_TYPE = {1: "SCALAR", 2: "VEC2", 3: "VEC3", 4: "VEC4"}


class GlbBuilder:
    """bufferViews and accessors over one BIN chunk, packed as a GLB
    (glTF 2.0 section 4: magic, JSON chunk, BIN chunk, 4-byte aligned)."""

    def __init__(self):
        self.bin = bytearray()
        self.views, self.accessors, self.images = [], [], []

    def view(self, data: bytes) -> int:
        self.bin += b"\x00" * ((-len(self.bin)) % 4)
        self.views.append({"buffer": 0, "byteOffset": len(self.bin),
                           "byteLength": len(data)})
        self.bin += data
        return len(self.views) - 1

    def acc(self, arr, minmax=False) -> int:
        arr = np.ascontiguousarray(arr)
        a = {"bufferView": self.view(arr.tobytes()), "byteOffset": 0,
             "componentType": _CTYPE[arr.dtype], "count": arr.shape[0],
             "type": _TYPE[1 if arr.ndim == 1 else arr.shape[1]]}
        if minmax:
            a["min"] = np.min(arr.reshape(arr.shape[0], -1), 0).tolist()
            a["max"] = np.max(arr.reshape(arr.shape[0], -1), 0).tolist()
        self.accessors.append(a)
        return len(self.accessors) - 1

    def image_png(self, rgba: np.ndarray) -> int:
        from PIL import Image

        buf = io.BytesIO()
        Image.fromarray(rgba).save(buf, format="PNG", compress_level=1)
        self.images.append({"bufferView": self.view(buf.getvalue()),
                            "mimeType": "image/png"})
        return len(self.images) - 1

    def glb(self, gltf: dict) -> bytes:
        gltf = dict(gltf, asset={"version": "2.0"})
        self.bin += b"\x00" * ((-len(self.bin)) % 4)
        gltf.update(buffers=[{"byteLength": len(self.bin)}],
                    bufferViews=self.views, accessors=self.accessors)
        if self.images:
            gltf["images"] = self.images
        js = json.dumps(gltf).encode()
        js += b" " * ((-len(js)) % 4)
        out = struct.pack("<4sII", b"glTF", 2,
                          12 + 8 + len(js) + 8 + len(self.bin))
        out += struct.pack("<II", len(js), 0x4E4F534A) + js
        out += struct.pack("<II", len(self.bin), 0x004E4942) + bytes(self.bin)
        return out


def tangents(pos, nrm, uv, idx) -> np.ndarray:
    """Per-vertex tangents (Lengyel's accumulation, Gram-Schmidt against
    the normal, handedness from the bitangent) -> (V, 4)."""
    i0, i1, i2 = idx[:, 0], idx[:, 1], idx[:, 2]
    e1 = (pos[i1] - pos[i0]).astype(np.float64)
    e2 = (pos[i2] - pos[i0]).astype(np.float64)
    d1 = (uv[i1] - uv[i0]).astype(np.float64)
    d2 = (uv[i2] - uv[i0]).astype(np.float64)
    det = d1[:, 0] * d2[:, 1] - d2[:, 0] * d1[:, 1]
    r = np.where(np.abs(det) > 1e-12,
                 1.0 / np.where(det == 0, 1.0, det), 0.0)[:, None]
    tf = (e1 * d2[:, 1:2] - e2 * d1[:, 1:2]) * r
    bf = (e2 * d1[:, 0:1] - e1 * d2[:, 0:1]) * r
    V = pos.shape[0]
    tan, bit = np.zeros((V, 3)), np.zeros((V, 3))
    for i in (i0, i1, i2):
        np.add.at(tan, i, tf)
        np.add.at(bit, i, bf)
    n = nrm.astype(np.float64)
    t = tan - n * np.sum(n * tan, -1, keepdims=True)
    ln = np.linalg.norm(t, axis=-1, keepdims=True)
    fb = np.cross(n, np.where(np.abs(n[:, 0:1]) < 0.9, [1.0, 0, 0], [0, 1.0, 0]))
    t = np.where(ln > 1e-9, t / np.maximum(ln, 1e-9), fb)
    w = np.where(np.sum(np.cross(n, t) * bit, -1) < 0.0, -1.0, 1.0)
    return np.concatenate([t, w[:, None]], -1).astype(F)


def helmet(cfg: dict, seed: int):
    """The helmet's arrays: (dict of vertex data, [base, mr, normal,
    occlusion, emissive] RGBA uint8 maps)."""
    S = int(cfg["map_size"])
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:S, 0:S].astype(np.float64) / S
    panel = ((xx * 6).astype(int) + (yy * 3).astype(int)) % 2
    scratch = rng.random((S, S)) < 0.02
    scratch = scratch | np.roll(scratch, 1, 1) | np.roll(scratch, 2, 1)
    visor = (yy > 0.55) & (yy < 0.72) & (np.abs(xx - 0.5) < 0.22)
    tint = rng.integers(-20, 21, 3)
    base = np.empty((S, S, 4), np.uint8)
    for c, (lit, dark) in enumerate(((140, 90), (110, 75), (70, 60))):
        base[..., c] = np.where(panel, lit + tint[c], dark + tint[c])
    base[scratch] = (200, 190, 180, 255)
    base[visor] = (25, 30, 40, 255)
    base[..., 3] = 255
    mr = np.zeros((S, S, 4), np.uint8)
    mr[..., 1] = np.where(panel, 90, 200)
    mr[..., 1][scratch] = 60
    mr[..., 2] = np.where(panel, 255, 40)
    mr[..., 2][visor] = 255
    mr[..., 1][visor] = 30
    mr[..., 3] = 255
    ry = np.minimum(yy * 3 % 1, 1 - yy * 3 % 1)
    rx = np.minimum(xx * 6 % 1, 1 - xx * 6 % 1)
    bump = np.clip(1.0 - np.sqrt((rx * 6) ** 2 + (ry * 3) ** 2) / 0.35,
                   0.0, 1.0) ** 2
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

    NLAT, NLON = int(cfg["lat"]), int(cfg["lon"])
    th = np.linspace(0.12 * np.pi, 0.78 * np.pi, NLAT + 1)
    ph = np.linspace(0.0, 2 * np.pi, NLON + 1)
    T, P = np.meshgrid(th, ph, indexing="ij")
    grid = np.stack([np.sin(T) * np.cos(P), np.cos(T) * 1.15,
                     np.sin(T) * np.sin(P)], axis=-1)
    dents = [((0.35, 1.2), 0.18, 0.06), ((2.4, 1.8), 0.25, 0.08),
             ((4.6, 0.9), 0.15, 0.05), ((5.5, 2.0), 0.30, 0.04)]
    disp = np.zeros_like(T)
    for (p0, t0), w, depth in dents:
        dp = np.minimum(np.abs(P - p0), 2 * np.pi - np.abs(P - p0))
        disp -= depth * np.exp(-((dp / w) ** 2 + ((T - t0) / w) ** 2))
    disp += 0.008 * np.sin(P * 24) * np.sin(T * 18)
    grid = grid * (1.0 + disp)[..., None]
    pos = grid.reshape(-1, 3).astype(F)
    uvs = np.stack([P / (2 * np.pi), (T - th[0]) / (th[-1] - th[0])],
                   axis=-1).reshape(-1, 2).astype(F)
    n1 = NLON + 1
    a = (np.arange(NLAT)[:, None] * n1 + np.arange(NLON)[None, :]).reshape(-1)
    idx = np.stack([a, a + 1, a + n1, a + 1, a + n1 + 1, a + n1],
                   axis=1).reshape(-1, 3).astype(np.uint32)
    nrm_g = np.cross(np.gradient(grid, axis=0), np.gradient(grid, axis=1))
    nrm_g /= np.maximum(np.linalg.norm(nrm_g, axis=-1, keepdims=True), 1e-9)
    sgn = np.sign(np.sum(nrm_g * grid, axis=-1, keepdims=True))
    nrm_g *= np.where(sgn == 0, 1.0, sgn)
    normals = nrm_g.reshape(-1, 3).astype(F)
    geo = dict(positions=pos, normals=normals, uv0=uvs,
               tangents=tangents(pos, normals, uvs, idx), indices=idx)
    return geo, [base, mr, nrm, occ, emis]


def helmet_glb(geo: dict, maps) -> bytes:
    b = GlbBuilder()
    imgs = [b.image_png(m) for m in maps]
    return b.glb({
        "scene": 0, "scenes": [{"nodes": [0]}], "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": [{
            "attributes": {"POSITION": b.acc(geo["positions"], minmax=True),
                           "NORMAL": b.acc(geo["normals"]),
                           "TANGENT": b.acc(geo["tangents"]),
                           "TEXCOORD_0": b.acc(geo["uv0"])},
            "indices": b.acc(geo["indices"].reshape(-1)), "material": 0}]}],
        "materials": [{
            "pbrMetallicRoughness": {
                "baseColorTexture": {"index": 0},
                "metallicRoughnessTexture": {"index": 1}},
            "normalTexture": {"index": 2},
            "occlusionTexture": {"index": 3},
            "emissiveTexture": {"index": 4},
            "emissiveFactor": [1.0, 1.0, 1.0]}],
        "textures": [{"source": i} for i in imgs],
    })
