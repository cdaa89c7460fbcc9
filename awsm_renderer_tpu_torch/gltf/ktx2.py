"""KTX2 container parsing (cubemaps + 2D textures).

Mirrors reference behavior: renderer-core/src/cubemap/ktx.rs (KTX2 cubemap
parsing/upload with mips, incl. the B10G11R11_UFLOAT format the reference
uses for prefiltered environments). Supports uncompressed payloads and
zlib supercompression; Basis/zstd payloads are rejected with a clear error
(the reference only consumes uncompressed/UASTC-transcoded data too).
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass, field
from typing import List

import numpy as np

_MAGIC = bytes([0xAB, 0x4B, 0x54, 0x58, 0x20, 0x32, 0x30, 0xBB, 0x0D, 0x0A, 0x1A, 0x0A])

# VkFormat subset
VK_R8G8B8_UNORM = 23
VK_R8G8B8_SRGB = 29
VK_R8G8B8A8_UNORM = 37
VK_R8G8B8A8_SRGB = 43
VK_R16G16B16A16_SFLOAT = 97
VK_B10G11R11_UFLOAT = 122
VK_R32G32B32A32_SFLOAT = 109


@dataclass
class Ktx2Image:
    width: int
    height: int
    faces: int
    levels: List[List[np.ndarray]]   # [level][face] -> (h, w, 4) f32 linear
    srgb_encoded: bool

    @property
    def is_cubemap(self) -> bool:
        return self.faces == 6

    def cubemap_faces(self, level: int = 0) -> np.ndarray:
        assert self.is_cubemap
        return np.stack(self.levels[level])


def _decode_11f(bits: np.ndarray, mant_bits: int) -> np.ndarray:
    """Decode packed small floats (5-bit exponent, no sign)."""
    m = (bits & ((1 << mant_bits) - 1)).astype(np.float64)
    e = (bits >> mant_bits).astype(np.int64)
    norm = np.exp2(e - 15.0) * (1.0 + m / (1 << mant_bits))
    denorm = np.exp2(-14.0) * (m / (1 << mant_bits))
    return np.where(e > 0, norm, denorm).astype(np.float32)


def _decode_pixels(data: bytes, vkformat: int, w: int, h: int) -> np.ndarray:
    """→ (h, w, 4) f32 (linear for float formats; sRGB formats stay encoded
    here — the caller decides, matching Textures.add_image(srgb=...))."""
    if vkformat in (VK_R8G8B8A8_UNORM, VK_R8G8B8A8_SRGB):
        arr = np.frombuffer(data, np.uint8, w * h * 4).reshape(h, w, 4)
        return arr.astype(np.float32) / 255.0
    if vkformat in (VK_R8G8B8_UNORM, VK_R8G8B8_SRGB):
        arr = np.frombuffer(data, np.uint8, w * h * 3).reshape(h, w, 3)
        out = np.ones((h, w, 4), np.float32)
        out[..., :3] = arr.astype(np.float32) / 255.0
        return out
    if vkformat == VK_R16G16B16A16_SFLOAT:
        arr = np.frombuffer(data, np.float16, w * h * 4).reshape(h, w, 4)
        return arr.astype(np.float32)
    if vkformat == VK_R32G32B32A32_SFLOAT:
        return np.frombuffer(data, np.float32, w * h * 4).reshape(h, w, 4).copy()
    if vkformat == VK_B10G11R11_UFLOAT:
        u = np.frombuffer(data, np.uint32, w * h).reshape(h, w)
        r = _decode_11f(u & 0x7FF, 6)
        g = _decode_11f((u >> 11) & 0x7FF, 6)
        b = _decode_11f((u >> 22) & 0x3FF, 5)
        return np.stack([r, g, b, np.ones_like(r)], axis=-1)
    raise ValueError(f"unsupported KTX2 vkFormat {vkformat}")


def load_ktx2(path_or_bytes) -> Ktx2Image:
    if isinstance(path_or_bytes, (bytes, bytearray)):
        raw = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            raw = f.read()
    if raw[:12] != _MAGIC:
        raise ValueError("not a KTX2 file (bad magic)")

    (vkformat, _type_size, w, h, _depth, layer_count, face_count,
     level_count, scheme) = struct.unpack_from("<9I", raw, 12)
    level_count = max(level_count, 1)
    face_count = max(face_count, 1)
    layer_count = max(layer_count, 1)
    if layer_count != 1:
        raise ValueError("KTX2 array layers not supported")
    if scheme not in (0, 3):
        raise ValueError(
            f"KTX2 supercompression scheme {scheme} not supported "
            "(only none/zlib)")

    # index (after 9 u32 header fields at offset 12+36=48)
    off = 48
    _dfd_off, _dfd_len, _kvd_off, _kvd_len = struct.unpack_from("<4I", raw, off)
    off += 16
    _sgd_off, _sgd_len = struct.unpack_from("<2Q", raw, off)
    off += 16
    level_index = []
    for _ in range(level_count):
        b_off, b_len, u_len = struct.unpack_from("<3Q", raw, off)
        off += 24
        level_index.append((b_off, b_len, u_len))

    srgb = vkformat in (VK_R8G8B8_SRGB, VK_R8G8B8A8_SRGB)
    levels: List[List[np.ndarray]] = []
    for li, (b_off, b_len, _u_len) in enumerate(level_index):
        lw, lh = max(w >> li, 1), max(h >> li, 1)
        payload = raw[b_off : b_off + b_len]
        if scheme == 3:
            payload = zlib.decompress(payload)
        face_bytes = len(payload) // face_count
        faces = [
            _decode_pixels(payload[f * face_bytes : (f + 1) * face_bytes],
                           vkformat, lw, lh)
            for f in range(face_count)
        ]
        levels.append(faces)

    return Ktx2Image(width=w, height=h, faces=face_count, levels=levels,
                     srgb_encoded=srgb)


def write_ktx2(levels: List[List[np.ndarray]], vkformat: int = VK_R8G8B8A8_UNORM) -> bytes:
    """Minimal KTX2 writer (tests + cubemap export). levels[level][face]."""
    face_count = len(levels[0])
    h, w = levels[0][0].shape[:2]

    def encode(img):
        if vkformat in (VK_R8G8B8A8_UNORM, VK_R8G8B8A8_SRGB):
            return (np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8).tobytes()
        if vkformat == VK_R32G32B32A32_SFLOAT:
            return np.ascontiguousarray(img, np.float32).tobytes()
        raise ValueError(f"writer does not support vkFormat {vkformat}")

    header = _MAGIC + struct.pack(
        "<9I", vkformat, 1, w, h, 0, 0, face_count, len(levels), 0)
    index_size = 16 + 16 + 24 * len(levels)
    data_start = len(header) + index_size
    payloads = [b"".join(encode(f) for f in faces) for faces in levels]
    level_entries = b""
    off = data_start
    # KTX2 stores levels smallest-first in the file; keep simple order and
    # rely on the index (readers must use offsets)
    offsets = []
    for p in payloads:
        offsets.append(off)
        off += len(p)
    for (o, p) in zip(offsets, payloads):
        level_entries += struct.pack("<3Q", o, len(p), len(p))
    index = struct.pack("<4I", 0, 0, 0, 0) + struct.pack("<2Q", 0, 0) + level_entries
    return header + index + b"".join(payloads)
