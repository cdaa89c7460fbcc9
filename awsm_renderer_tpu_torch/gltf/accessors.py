"""glTF 2.0 accessor reading: typed, normalized, interleaved, sparse.

Port of the reference's accessor conversion layer
(crates/renderer/src/gltf/buffers/accessor.rs, 661 LoC — incl. sparse
accessors per the SimpleSparseAccessor sample) as vectorized numpy.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

COMPONENT_DTYPES = {
    5120: np.int8,
    5121: np.uint8,
    5122: np.int16,
    5123: np.uint16,
    5125: np.uint32,
    5126: np.float32,
}
TYPE_COUNTS = {
    "SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4,
    "MAT2": 4, "MAT3": 9, "MAT4": 16,
}


def _normalize(arr: np.ndarray, component_type: int) -> np.ndarray:
    """KHR normalized-component decode rules."""
    if component_type == 5121:
        return arr.astype(np.float32) / 255.0
    if component_type == 5123:
        return arr.astype(np.float32) / 65535.0
    if component_type == 5120:
        return np.maximum(arr.astype(np.float32) / 127.0, -1.0)
    if component_type == 5122:
        return np.maximum(arr.astype(np.float32) / 32767.0, -1.0)
    return arr.astype(np.float32)


def read_accessor(gltf: dict, buffers: List[bytes], accessor_index: int) -> np.ndarray:
    """Returns (count, components) array — float32 if normalized/float,
    original integer dtype otherwise."""
    acc = gltf["accessors"][accessor_index]
    count = acc["count"]
    n_comp = TYPE_COUNTS[acc["type"]]
    dtype = COMPONENT_DTYPES[acc["componentType"]]
    itemsize = np.dtype(dtype).itemsize

    if "bufferView" in acc:
        bv = gltf["bufferViews"][acc["bufferView"]]
        buf = buffers[bv["buffer"]]
        base = bv.get("byteOffset", 0) + acc.get("byteOffset", 0)
        stride = bv.get("byteStride", 0) or n_comp * itemsize
        if stride == n_comp * itemsize:
            raw = np.frombuffer(buf, dtype=dtype, count=count * n_comp, offset=base)
            out = raw.reshape(count, n_comp).copy()
        else:
            # interleaved: gather strided bytes per component
            out = np.zeros((count, n_comp), dtype=dtype)
            view = np.frombuffer(buf, dtype=np.uint8)
            for i in range(n_comp):
                off = base + i * itemsize
                idx = off + stride * np.arange(count)
                bytes_ = np.stack([view[idx + b] for b in range(itemsize)], axis=-1)
                out[:, i] = np.ascontiguousarray(bytes_).view(dtype).reshape(count)
    else:
        out = np.zeros((count, n_comp), dtype=dtype)

    # sparse substitution
    sparse = acc.get("sparse")
    if sparse:
        s_count = sparse["count"]
        si = sparse["indices"]
        sbv = gltf["bufferViews"][si["bufferView"]]
        sbuf = buffers[sbv["buffer"]]
        s_dtype = COMPONENT_DTYPES[si["componentType"]]
        s_off = sbv.get("byteOffset", 0) + si.get("byteOffset", 0)
        indices = np.frombuffer(sbuf, dtype=s_dtype, count=s_count, offset=s_off).astype(np.int64)
        sv = sparse["values"]
        vbv = gltf["bufferViews"][sv["bufferView"]]
        vbuf = buffers[vbv["buffer"]]
        v_off = vbv.get("byteOffset", 0) + sv.get("byteOffset", 0)
        values = np.frombuffer(
            vbuf, dtype=dtype, count=s_count * n_comp, offset=v_off
        ).reshape(s_count, n_comp)
        out[indices] = values

    if acc.get("normalized") or dtype == np.float32:
        out = _normalize(out, acc["componentType"])
    return out


def triangulate(indices: Optional[np.ndarray], mode: int, vertex_count: int) -> np.ndarray:
    """Indices (or implicit range) + primitive mode → (T,3) i32 triangle list.

    Reference: gltf/buffers/index.rs (strip/fan → list conversion)."""
    if indices is None:
        idx = np.arange(vertex_count, dtype=np.int32)
    else:
        idx = np.asarray(indices, dtype=np.int32).reshape(-1)
    if mode == 4:  # TRIANGLES
        return idx[: len(idx) // 3 * 3].reshape(-1, 3)
    if mode == 5:  # TRIANGLE_STRIP
        n = len(idx) - 2
        if n <= 0:
            return np.zeros((0, 3), np.int32)
        tris = np.stack([idx[:-2], idx[1:-1], idx[2:]], axis=-1)
        # every odd triangle flips winding
        odd = np.arange(n) % 2 == 1
        tris[odd] = tris[odd][:, [0, 2, 1]]
        return tris
    if mode == 6:  # TRIANGLE_FAN
        n = len(idx) - 2
        if n <= 0:
            return np.zeros((0, 3), np.int32)
        return np.stack([np.full(n, idx[0]), idx[1:-1], idx[2:]], axis=-1).astype(np.int32)
    raise ValueError(f"unsupported primitive mode {mode} (points/lines)")
