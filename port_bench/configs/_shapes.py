"""Procedural inputs the configurations build: a box, a uv sphere, a
checker image and the procedural sky panorama. Frozen here so that the
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
