"""View-frustum extraction and AABB culling.

Mirrors reference behavior: crates/renderer/src/frustum.rs:35-120
(6 planes extracted from the view-projection matrix, Gribb-Hartmann style;
AABB test uses the positive-vertex trick). The only CPU culling in the
reference; here it runs host-side per frame before building the draw list.
"""

from __future__ import annotations

import numpy as np

from .bounds import Aabb

F = np.float32


class Frustum:
    def __init__(self, view_proj: np.ndarray):
        """Extract 6 planes (left/right/bottom/top/near/far) from a
        view-projection matrix with depth range [0,1] (WebGPU convention)."""
        m = np.asarray(view_proj, dtype=np.float64)
        rows = [m[0], m[1], m[2], m[3]]
        planes = np.stack(
            [
                rows[3] + rows[0],  # left
                rows[3] - rows[0],  # right
                rows[3] + rows[1],  # bottom
                rows[3] - rows[1],  # top
                rows[2],            # near  (z >= 0 in [0,1] clip)
                rows[3] - rows[2],  # far
            ]
        )
        # normalize plane normals
        n = np.linalg.norm(planes[:, :3], axis=1, keepdims=True)
        n[n == 0] = 1.0
        self.planes = (planes / n).astype(F)  # (6, 4): (nx, ny, nz, d)

    def intersects_aabb(self, aabb: Aabb) -> bool:
        """True if the AABB is at least partially inside the frustum."""
        for p in self.planes:
            normal = p[:3]
            # positive vertex: the AABB corner furthest along the plane normal
            pv = np.where(normal >= 0.0, aabb.max, aabb.min)
            if float(np.dot(normal, pv)) + float(p[3]) < 0.0:
                return False
        return True

    def fully_in_front_of_near(self, mins: np.ndarray, maxs: np.ndarray,
                               margin: float = 1e-3) -> np.ndarray:
        """(N,) mask: AABB entirely on the inner side of the near plane —
        the host-side proof that lets the vertex stage skip near-plane
        clipping (its static needs_clip specialization)."""
        p = self.planes[4]
        normal = p[:3]
        # negative vertex: the corner LEAST along the plane normal
        nv = np.where(normal[None, :] >= 0.0, mins, maxs)
        return (nv @ normal + p[3]) > margin

    def intersects_aabbs(self, mins: np.ndarray, maxs: np.ndarray) -> np.ndarray:
        """Vectorized test: mins/maxs (N,3) -> (N,) bool mask."""
        mins = np.asarray(mins, dtype=F)
        maxs = np.asarray(maxs, dtype=F)
        inside = np.ones(mins.shape[0], dtype=bool)
        for p in self.planes:
            normal = p[:3]
            pv = np.where(normal[None, :] >= 0.0, maxs, mins)
            inside &= (pv @ normal + p[3]) >= 0.0
        return inside
