"""Procedural test geometry (box, plane, uv-sphere, triangle).

Stand-ins for the Khronos glTF sample "Basics" probes (Triangle, Box,
BoxTextured, MetalRoughSpheres — frontend/src/models/collections.rs) since
this environment has no network access to the sample assets. Shapes follow
glTF conventions: CCW front faces, right-handed Y-up, +Z toward viewer.
"""

from __future__ import annotations

import numpy as np

from .core.meshes import MeshGeometry

F = np.float32


def triangle() -> MeshGeometry:
    return MeshGeometry(
        positions=np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], F),
        indices=np.array([[0, 1, 2]], np.int32),
        normals=np.array([[0, 0, 1]] * 3, F),
        uv0=np.array([[0, 1], [1, 1], [0, 0]], F),
    )


def plane(size: float = 1.0) -> MeshGeometry:
    s = size / 2
    return MeshGeometry(
        positions=np.array([[-s, 0, -s], [s, 0, -s], [s, 0, s], [-s, 0, s]], F),
        indices=np.array([[0, 2, 1], [0, 3, 2]], np.int32),
        normals=np.array([[0, 1, 0]] * 4, F),
        uv0=np.array([[0, 0], [1, 0], [1, 1], [0, 1]], F),
    )


def box(size: float = 1.0) -> MeshGeometry:
    """Unit box with per-face normals/uvs (24 verts, 12 tris), glTF-style."""
    s = size / 2
    faces = [
        # (normal, up, right) per face
        ([0, 0, 1], [0, 1, 0], [1, 0, 0]),    # +z
        ([0, 0, -1], [0, 1, 0], [-1, 0, 0]),  # -z
        ([1, 0, 0], [0, 1, 0], [0, 0, -1]),   # +x
        ([-1, 0, 0], [0, 1, 0], [0, 0, 1]),   # -x
        ([0, 1, 0], [0, 0, -1], [1, 0, 0]),   # +y
        ([0, -1, 0], [0, 0, 1], [1, 0, 0]),   # -y
    ]
    pos, nrm, uv, tan, idx = [], [], [], [], []
    for fi, (n, up, right) in enumerate(faces):
        n, up, right = np.array(n, F), np.array(up, F), np.array(right, F)
        base = fi * 4
        for cy, cx, (u, v) in [(-1, -1, (0, 1)), (-1, 1, (1, 1)), (1, 1, (1, 0)), (1, -1, (0, 0))]:
            pos.append(n * s + right * (cx * s) + up * (cy * s))
            nrm.append(n)
            uv.append([u, v])
            tan.append([*right, 1.0])
        idx += [[base, base + 1, base + 2], [base, base + 2, base + 3]]
    return MeshGeometry(
        positions=np.array(pos, F),
        indices=np.array(idx, np.int32),
        normals=np.array(nrm, F),
        tangents=np.array(tan, F),
        uv0=np.array(uv, F),
    )


def uv_sphere(radius: float = 0.5, rings: int = 16, sectors: int = 32) -> MeshGeometry:
    phi = np.linspace(0, np.pi, rings + 1)
    theta = np.linspace(0, 2 * np.pi, sectors + 1)
    pp, tt = np.meshgrid(phi, theta, indexing="ij")
    x = np.sin(pp) * np.cos(tt)
    y = np.cos(pp)
    z = np.sin(pp) * np.sin(tt)
    pos = np.stack([x, y, z], axis=-1).reshape(-1, 3) * radius
    nrm = pos / radius
    u = (tt / (2 * np.pi)).reshape(-1)
    v = (pp / np.pi).reshape(-1)
    uv = np.stack([u, v], axis=-1)
    # tangent along +theta
    tx = -np.sin(tt)
    tz = np.cos(tt)
    tan = np.stack([tx, np.zeros_like(tx), tz, np.ones_like(tx)], axis=-1).reshape(-1, 4)

    idx = []
    cols = sectors + 1
    for r in range(rings):
        for c in range(sectors):
            a = r * cols + c
            b = a + cols
            idx += [[a, a + 1, b], [a + 1, b + 1, b]]
    return MeshGeometry(
        positions=pos.astype(F),
        indices=np.array(idx, np.int32),
        normals=nrm.astype(F),
        tangents=tan.astype(F),
        uv0=uv.astype(F),
    )


def cylinder(radius: float = 0.05, height: float = 1.0, sectors: int = 12,
             axis: int = 1) -> MeshGeometry:
    """Capped cylinder along `axis`, base at origin extending +axis."""
    theta = np.linspace(0, 2 * np.pi, sectors + 1)
    ring = np.stack([np.cos(theta), np.sin(theta)], axis=-1) * radius  # (S+1,2)
    n = sectors + 1
    bottom = np.zeros((n, 3), F)
    top = np.zeros((n, 3), F)
    bottom[:, 0], bottom[:, 2] = ring[:, 0], ring[:, 1]
    top[:, 0], top[:, 2] = ring[:, 0], ring[:, 1]
    top[:, 1] = height
    pos = np.concatenate([bottom, top, [[0, 0, 0]], [[0, height, 0]]])
    nrm = np.concatenate([
        np.stack([ring[:, 0], np.zeros(n), ring[:, 1]], -1) / radius,
        np.stack([ring[:, 0], np.zeros(n), ring[:, 1]], -1) / radius,
        [[0, -1, 0]], [[0, 1, 0]],
    ])
    idx = []
    for i in range(sectors):
        a, b = i, i + 1
        idx += [[a, n + a, b], [b, n + a, n + b]]
        idx += [[2 * n, a, b], [2 * n + 1, n + b, n + a]]
    geo = MeshGeometry(
        positions=pos.astype(F), indices=np.array(idx, np.int32),
        normals=nrm.astype(F), uv0=np.zeros((pos.shape[0], 2), F))
    if axis != 1:
        _swap_axis(geo, axis)
    return geo


def cone(radius: float = 0.1, height: float = 0.3, sectors: int = 12,
         base_y: float = 0.0, axis: int = 1) -> MeshGeometry:
    theta = np.linspace(0, 2 * np.pi, sectors + 1)
    n = sectors + 1
    base = np.zeros((n, 3), F)
    base[:, 0] = np.cos(theta) * radius
    base[:, 2] = np.sin(theta) * radius
    base[:, 1] = base_y
    pos = np.concatenate([base, [[0, base_y + height, 0]], [[0, base_y, 0]]])
    slant = np.sqrt(radius * radius + height * height)
    nrm = np.concatenate([
        np.stack([np.cos(theta) * height / slant,
                  np.full(n, radius / slant),
                  np.sin(theta) * height / slant], -1),
        [[0, 1, 0]], [[0, -1, 0]],
    ])
    idx = []
    for i in range(sectors):
        idx += [[i, n, i + 1], [n + 1, i, i + 1]]
    geo = MeshGeometry(
        positions=pos.astype(F), indices=np.array(idx, np.int32),
        normals=nrm.astype(F), uv0=np.zeros((pos.shape[0], 2), F))
    if axis != 1:
        _swap_axis(geo, axis)
    return geo


def torus(radius: float = 0.7, tube: float = 0.03, sectors: int = 32,
          sides: int = 8, axis: int = 1) -> MeshGeometry:
    """Torus in the plane perpendicular to `axis` (rotation-gizmo ring)."""
    u = np.linspace(0, 2 * np.pi, sectors + 1)
    v = np.linspace(0, 2 * np.pi, sides + 1)
    uu, vv = np.meshgrid(u, v, indexing="ij")
    cx = np.cos(uu) * (radius + tube * np.cos(vv))
    cz = np.sin(uu) * (radius + tube * np.cos(vv))
    cy = tube * np.sin(vv)
    pos = np.stack([cx, cy, cz], -1).reshape(-1, 3)
    nx = np.cos(uu) * np.cos(vv)
    nz = np.sin(uu) * np.cos(vv)
    ny = np.sin(vv)
    nrm = np.stack([nx, ny, nz], -1).reshape(-1, 3)
    idx = []
    cols = sides + 1
    for i in range(sectors):
        for j in range(sides):
            a = i * cols + j
            b = a + cols
            idx += [[a, a + 1, b], [a + 1, b + 1, b]]
    geo = MeshGeometry(
        positions=pos.astype(F), indices=np.array(idx, np.int32),
        normals=nrm.astype(F), uv0=np.zeros((pos.shape[0], 2), F))
    if axis != 1:
        _swap_axis(geo, axis)
    return geo


def _swap_axis(geo: MeshGeometry, axis: int) -> None:
    """Remap +Y-aligned geometry onto +X (axis=0) or +Z (axis=2) in place."""
    order = {0: [1, 0, 2], 2: [0, 2, 1]}[axis]
    geo.positions = geo.positions[:, order]
    geo.normals = geo.normals[:, order]
    # axis swap mirrors; flip winding to keep faces outward
    geo.indices = geo.indices[:, [0, 2, 1]]
    geo.aabb = None
    geo.__post_init__()


def checker_texture(size: int = 64, cells: int = 8, c0=(255, 255, 255), c1=(30, 30, 30)) -> np.ndarray:
    """RGBA uint8 checkerboard for BoxTextured-style probes."""
    yy, xx = np.mgrid[0:size, 0:size]
    mask = ((xx * cells // size) + (yy * cells // size)) % 2 == 0
    img = np.zeros((size, size, 4), np.uint8)
    img[..., 3] = 255
    img[mask, :3] = c0
    img[~mask, :3] = c1
    return img
