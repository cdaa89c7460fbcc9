"""Procedural inputs the configurations build: a box, a uv sphere, a
checker image and the procedural sky panorama; and the editor's shapes
at the tessellation the program's editor builds them with (the gizmo's
cylinder, cone and torus, the grid's plane). Frozen here so that the
scene both sides receive is the benchmark's own, whatever later changes
the program's generators."""

from __future__ import annotations

import numpy as np

F = np.float32


def box(size: float):
    """24 vertices, 12 triangles, per-face normals, uvs and tangents."""
    s = size / 2
    faces = [([0, 0, 1], [0, 1, 0], [1, 0, 0]), ([0, 0, -1], [0, 1, 0], [-1, 0, 0]),
             ([1, 0, 0], [0, 1, 0], [0, 0, -1]), ([-1, 0, 0], [0, 1, 0], [0, 0, 1]),
             ([0, 1, 0], [0, 0, -1], [1, 0, 0]), ([0, -1, 0], [0, 0, 1], [1, 0, 0])]
    pos, nrm, uv, tan, idx = [], [], [], [], []
    for fi, (n, up, right) in enumerate(faces):
        n, up, right = np.array(n, F), np.array(up, F), np.array(right, F)
        b = fi * 4
        for cy, cx, (u, v) in [(-1, -1, (0, 1)), (-1, 1, (1, 1)),
                               (1, 1, (1, 0)), (1, -1, (0, 0))]:
            pos.append(n * s + right * (cx * s) + up * (cy * s))
            nrm.append(n)
            uv.append([u, v])
            tan.append([*right, 1.0])
        idx += [[b, b + 1, b + 2], [b, b + 2, b + 3]]
    return dict(positions=np.array(pos, F), normals=np.array(nrm, F),
                uv0=np.array(uv, F), tangents=np.array(tan, F),
                indices=np.array(idx, np.int32))


def uv_sphere(radius: float, rings: int, sectors: int):
    phi = np.linspace(0, np.pi, rings + 1)
    theta = np.linspace(0, 2 * np.pi, sectors + 1)
    pp, tt = np.meshgrid(phi, theta, indexing="ij")
    pos = np.stack([np.sin(pp) * np.cos(tt), np.cos(pp),
                    np.sin(pp) * np.sin(tt)], axis=-1).reshape(-1, 3) * radius
    uv = np.stack([(tt / (2 * np.pi)).reshape(-1), (pp / np.pi).reshape(-1)],
                  axis=-1)
    tan = np.stack([-np.sin(tt), np.zeros_like(tt), np.cos(tt),
                    np.ones_like(tt)], axis=-1).reshape(-1, 4)
    cols = sectors + 1
    idx = []
    for r in range(rings):
        for c in range(sectors):
            a = r * cols + c
            idx += [[a, a + 1, a + cols], [a + 1, a + cols + 1, a + cols]]
    return dict(positions=pos.astype(F), normals=(pos / radius).astype(F),
                uv0=uv.astype(F), tangents=tan.astype(F),
                indices=np.array(idx, np.int32))


def checker(size: int, cells: int, c0, c1) -> np.ndarray:
    yy, xx = np.mgrid[0:size, 0:size]
    mask = ((xx * cells // size) + (yy * cells // size)) % 2 == 0
    img = np.zeros((size, size, 4), np.uint8)
    img[..., 3] = 255
    img[mask, :3] = c0
    img[~mask, :3] = c1
    return img


def sky_equirect() -> np.ndarray:
    """A 32 x 64 vertical-gradient panorama (warm horizon, blue zenith)."""
    eq = np.zeros((32, 64, 3), F)
    v = np.linspace(0, 1, 32)[:, None]
    eq[..., 0] = 0.2 + 0.8 * v
    eq[..., 1] = 0.3 + 0.25 * v
    eq[..., 2] = 1.0 - 0.8 * v
    return eq


def _mesh(pos, nrm, idx):
    """A shape with no uvs and a +x tangent (its materials bind no map)."""
    n = pos.shape[0]
    tan = np.zeros((n, 4), F)
    tan[:, 0] = tan[:, 3] = 1.0
    return dict(positions=np.asarray(pos, F), normals=np.asarray(nrm, F),
                uv0=np.zeros((n, 2), F), tangents=tan,
                indices=np.asarray(idx, np.int32))


def _along(geo, axis: int):
    """A +y shape turned onto +x (axis 0) or +z (axis 2): two coordinates
    swapped, a mirror, so the winding flips to keep the faces outward."""
    if axis == 1:
        return geo
    order = {0: [1, 0, 2], 2: [0, 2, 1]}[axis]
    return dict(geo, positions=geo["positions"][:, order],
                normals=geo["normals"][:, order],
                indices=geo["indices"][:, [0, 2, 1]])


def plane(size: float):
    """A size x size square in y = 0, facing +y, two triangles."""
    s = size / 2
    return dict(_mesh(np.array([[-s, 0, -s], [s, 0, -s], [s, 0, s],
                                [-s, 0, s]]), np.array([[0, 1, 0]] * 4),
                      [[0, 2, 1], [0, 3, 2]]),
                uv0=np.array([[0, 0], [1, 0], [1, 1], [0, 1]], F))


def cylinder(radius: float, height: float, axis: int, sectors: int = 12):
    """A capped cylinder from the origin to height along the axis."""
    theta = np.linspace(0, 2 * np.pi, sectors + 1)
    ring = np.stack([np.cos(theta), np.sin(theta)], axis=-1) * radius
    n = sectors + 1
    bottom = np.zeros((n, 3), F)
    top = np.zeros((n, 3), F)
    bottom[:, 0], bottom[:, 2] = ring[:, 0], ring[:, 1]
    top[:, 0], top[:, 2] = ring[:, 0], ring[:, 1]
    top[:, 1] = height
    pos = np.concatenate([bottom, top, [[0, 0, 0]], [[0, height, 0]]])
    side = np.stack([ring[:, 0], np.zeros(n), ring[:, 1]], -1) / radius
    nrm = np.concatenate([side, side, [[0, -1, 0]], [[0, 1, 0]]])
    idx = []
    for i in range(sectors):
        a, b = i, i + 1
        idx += [[a, n + a, b], [b, n + a, n + b]]
        idx += [[2 * n, a, b], [2 * n + 1, n + b, n + a]]
    return _along(_mesh(pos.astype(F), nrm, idx), axis)


def cone(radius: float, height: float, base: float, axis: int,
         sectors: int = 12):
    """A cone whose base circle lies at `base` along the axis, its tip
    `height` further."""
    theta = np.linspace(0, 2 * np.pi, sectors + 1)
    n = sectors + 1
    ring = np.zeros((n, 3), F)
    ring[:, 0] = np.cos(theta) * radius
    ring[:, 2] = np.sin(theta) * radius
    ring[:, 1] = base
    pos = np.concatenate([ring, [[0, base + height, 0]], [[0, base, 0]]])
    slant = np.sqrt(radius * radius + height * height)
    nrm = np.concatenate([
        np.stack([np.cos(theta) * height / slant, np.full(n, radius / slant),
                  np.sin(theta) * height / slant], -1),
        [[0, 1, 0]], [[0, -1, 0]]])
    idx = []
    for i in range(sectors):
        idx += [[i, n, i + 1], [n + 1, i, i + 1]]
    return _along(_mesh(pos.astype(F), nrm, idx), axis)


def torus(radius: float, tube: float, axis: int, sectors: int = 32,
          sides: int = 8):
    """A ring of the given radius about the axis, in the plane normal to
    it."""
    u = np.linspace(0, 2 * np.pi, sectors + 1)
    v = np.linspace(0, 2 * np.pi, sides + 1)
    uu, vv = np.meshgrid(u, v, indexing="ij")
    pos = np.stack([np.cos(uu) * (radius + tube * np.cos(vv)),
                    tube * np.sin(vv),
                    np.sin(uu) * (radius + tube * np.cos(vv))], -1)
    nrm = np.stack([np.cos(uu) * np.cos(vv), np.sin(vv),
                    np.sin(uu) * np.cos(vv)], -1)
    cols = sides + 1
    idx = []
    for i in range(sectors):
        for j in range(sides):
            a = i * cols + j
            b = a + cols
            idx += [[a, a + 1, b], [a + 1, b + 1, b]]
    return _along(_mesh(pos.reshape(-1, 3).astype(F), nrm.reshape(-1, 3),
                        idx), axis)
