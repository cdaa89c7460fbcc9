"""Tangent + normal generation for primitives missing them.

The reference generates missing tangents with mikktspace
(gltf/buffers/tangents.rs:101-347) and missing normals with a
flat-shading fallback (gltf/buffers/normals.rs). Here:

- normals: flat fallback after vertex explosion (same semantics)
- tangents: native C++ MikkTSpace-convention generation
  (native/awsm_host.cpp mikktspace_tangents — welded corners,
  orientation-separated groups so mirrored-UV seams keep per-side
  handedness, angle-weighted accumulation, reference-style per-vertex
  collapse with majority handedness vote). Falls back to per-triangle
  Lengyel accumulation with Gram-Schmidt orthogonalization when the
  native library is unavailable.
"""

from __future__ import annotations

import numpy as np

F = np.float32


def flat_normals(positions: np.ndarray, indices: np.ndarray):
    """Explode vertices per triangle and assign face normals.

    Returns (positions', indices', normals') — vertex count becomes 3T.
    Reference: buffers/normals.rs ensure_normals fallback."""
    tris = positions[indices]                      # (T,3,3)
    n = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    ln = np.linalg.norm(n, axis=-1, keepdims=True)
    n = np.where(ln > 1e-12, n / np.maximum(ln, 1e-12), [0, 0, 1])
    T = indices.shape[0]
    new_pos = tris.reshape(T * 3, 3).astype(F)
    new_idx = np.arange(T * 3, dtype=np.int32).reshape(T, 3)
    new_nrm = np.repeat(n, 3, axis=0).astype(F)
    return new_pos, new_idx, new_nrm


def generate_tangents(
    positions: np.ndarray, normals: np.ndarray, uvs: np.ndarray, indices: np.ndarray
) -> np.ndarray:
    """Returns (V,4) tangents (xyz + handedness w).

    Native MikkTSpace path first (reference parity: tangents.rs embeds
    mikktspace); Lengyel numpy accumulation as fallback."""
    from ..utils.native import mikktspace_tangents

    mikk = mikktspace_tangents(positions, normals, uvs, indices)
    if mikk is not None:
        return mikk
    V = positions.shape[0]
    tan = np.zeros((V, 3), np.float64)
    bit = np.zeros((V, 3), np.float64)

    i0, i1, i2 = indices[:, 0], indices[:, 1], indices[:, 2]
    p0, p1, p2 = positions[i0], positions[i1], positions[i2]
    u0, u1, u2 = uvs[i0], uvs[i1], uvs[i2]

    e1 = (p1 - p0).astype(np.float64)
    e2 = (p2 - p0).astype(np.float64)
    d1 = (u1 - u0).astype(np.float64)
    d2 = (u2 - u0).astype(np.float64)
    det = d1[:, 0] * d2[:, 1] - d2[:, 0] * d1[:, 1]
    r = np.where(np.abs(det) > 1e-12, 1.0 / np.where(det == 0, 1.0, det), 0.0)[:, None]
    t_face = (e1 * d2[:, 1:2] - e2 * d1[:, 1:2]) * r
    b_face = (e2 * d1[:, 0:1] - e1 * d2[:, 0:1]) * r

    for i in (i0, i1, i2):
        np.add.at(tan, i, t_face)
        np.add.at(bit, i, b_face)

    n = normals.astype(np.float64)
    # Gram-Schmidt
    t_ortho = tan - n * np.sum(n * tan, axis=-1, keepdims=True)
    ln = np.linalg.norm(t_ortho, axis=-1, keepdims=True)
    fallback = np.cross(n, np.where(np.abs(n[:, 0:1]) < 0.9, [1.0, 0, 0], [0, 1.0, 0]))
    t_unit = np.where(ln > 1e-9, t_ortho / np.maximum(ln, 1e-9), fallback)
    w = np.where(np.sum(np.cross(n, t_unit) * bit, axis=-1) < 0.0, -1.0, 1.0)
    return np.concatenate([t_unit, w[:, None]], axis=-1).astype(F)
