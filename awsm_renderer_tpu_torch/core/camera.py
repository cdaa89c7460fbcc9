"""Camera state.

Mirrors reference behavior: crates/renderer/src/camera.rs (512-byte uniform
with view/proj/view-proj + inverses, camera position, frame count, frustum
corner rays, viewport, DoF params; epsilon-based camera_moved detection).
Here the uniform is a small pytree of f32 arrays assembled at flush.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

F = np.float32
_EPS = 1e-6


def halton(index: int, base: int) -> float:
    """Halton low-discrepancy sequence (reference: camera.rs:257
    `halton`)."""
    result, f = 0.0, 1.0
    while index > 0:
        f /= base
        result += f * (index % base)
        index //= base
    return result


def get_halton_jitter(frame_count: int) -> np.ndarray:
    """Centered Halton(2,3) subpixel jitter in [-0.5, 0.5]² pixels
    (reference: camera.rs `get_halton_jitter`). frame_count 0 maps to
    (-0.5,-0.5)-free zero-index; the renderer's TAA path offsets by 1 so
    a freshly reset history starts at the (0,0)-closest sample."""
    return np.array([halton(frame_count, 2) - 0.5,
                     halton(frame_count, 3) - 0.5], dtype=F)


def compute_view_frustum_rays(inv_projection: np.ndarray) -> np.ndarray:
    """4 normalized view-space ray directions at the near-plane corners
    (reference: camera.rs compute_view_frustum_rays — screen-space
    reconstruction helpers, NOT culling planes). Order: bottom-left,
    bottom-right, top-left, top-right; rows are vec4 with w=0."""
    corners = np.array([[-1.0, -1.0, 0.0, 1.0],
                        [1.0, -1.0, 0.0, 1.0],
                        [-1.0, 1.0, 0.0, 1.0],
                        [1.0, 1.0, 0.0, 1.0]], dtype=np.float64)
    rays = np.zeros((4, 4), dtype=F)
    for i, c in enumerate(corners):
        v = inv_projection.astype(np.float64) @ c
        w = v[3] if abs(v[3]) > 1e-12 else 1e-12
        d = v[:3] / w
        n = np.linalg.norm(d)
        rays[i, :3] = (d / (n if n > 0 else 1.0)).astype(F)
    return rays


@dataclass
class DofParams:
    """Reference: camera.rs dof fields. `aperture` is the f-stop number
    (dof.wgsl calculate_coc: 'e.g., 2.8, 5.6, 8.0 — lower = shallower')."""

    focus_distance: float = 10.0
    aperture: float = 5.6


class CameraState:
    def __init__(self):
        self.view = np.eye(4, dtype=F)
        self.projection = np.eye(4, dtype=F)
        self.position = np.zeros(3, dtype=F)
        self.frame_count = 0
        self.dof = DofParams()
        self.gpu_dirty = True
        self._moved = True

    def update(self, view: np.ndarray, projection: np.ndarray,
               position: Optional[np.ndarray] = None) -> None:
        """Reference: camera.rs:111 `update` with moved-epsilon check."""
        from ..errors import CameraError

        view = np.asarray(view, dtype=F)
        projection = np.asarray(projection, dtype=F)
        if view.shape != (4, 4) or projection.shape != (4, 4):
            raise CameraError(
                f"view/projection must be 4x4 matrices, got {view.shape} "
                f"and {projection.shape}")
        if not (np.isfinite(view).all() and np.isfinite(projection).all()):
            raise CameraError("view/projection contain non-finite values")
        moved = (
            np.abs(view - self.view).max() > _EPS
            or np.abs(projection - self.projection).max() > _EPS
        )
        self._moved = bool(moved)
        if moved:
            self.view = view
            self.projection = projection
            if position is not None:
                self.position = np.asarray(position, dtype=F)
            else:
                # derive eye position from inverse view
                try:
                    inv = np.linalg.inv(view.astype(np.float64))
                except np.linalg.LinAlgError:
                    raise CameraError("view matrix is singular") from None
                self.position = inv[:3, 3].astype(F)
            self.gpu_dirty = True

    @property
    def moved(self) -> bool:
        return self._moved

    @property
    def view_projection(self) -> np.ndarray:
        return (self.projection @ self.view).astype(F)

    def next_frame(self) -> None:
        self.frame_count += 1

    def packed(self, viewport=None, jitter_px=None) -> dict:
        """Device-facing dict of arrays (the '512-byte uniform',
        camera.rs:73-86 layout: 6 mat4s, position, frame_count, 4
        frustum corner rays, viewport, dof params).

        viewport: optional (width, height) — emitted as the reference's
        [0, 0, w, h] vec4 (the renderer passes its canvas size at flush).
        jitter_px: optional (jx, jy) TAA subpixel jitter in PIXELS
        (camera.rs APPLY_JITTER): the projection — and every matrix
        derived from it — is pre-translated by the NDC offset
        (2*jx/w, 2*jy/h); 'view_proj_nj'/'inv_view_proj_nj' keep the
        unjittered versions for temporal reprojection."""
        proj = self.projection
        if jitter_px is not None and viewport is not None:
            jx, jy = float(jitter_px[0]), float(jitter_px[1])
            jm = np.eye(4, dtype=np.float64)
            jm[0, 3] = 2.0 * jx / float(viewport[0])
            jm[1, 3] = 2.0 * jy / float(viewport[1])
            proj = (jm @ self.projection.astype(np.float64)).astype(F)
        vp_nj = self.view_projection
        vp = (proj.astype(np.float64)
              @ self.view.astype(np.float64)).astype(F)
        inv_vp = np.linalg.inv(vp.astype(np.float64)).astype(F)
        inv_view = np.linalg.inv(self.view.astype(np.float64)).astype(F)
        inv_proj = np.linalg.inv(proj.astype(np.float64)).astype(F)
        out = {
            "view": self.view,
            "proj": proj,
            "view_proj": vp,
            "inv_view": inv_view,
            "inv_proj": inv_proj,
            "inv_view_proj": inv_vp,
            "position": self.position,
            "frame_count": np.array([self.frame_count], dtype=np.int32),
            "frustum_rays": compute_view_frustum_rays(inv_proj),
            "viewport": np.array(
                [0.0, 0.0,
                 float(viewport[0]) if viewport is not None else 0.0,
                 float(viewport[1]) if viewport is not None else 0.0],
                dtype=F),
            "dof": np.array([self.dof.focus_distance, self.dof.aperture], dtype=F),
        }
        if jitter_px is not None and viewport is not None:
            out["view_proj_nj"] = vp_nj
            out["inv_view_proj_nj"] = np.linalg.inv(
                vp_nj.astype(np.float64)).astype(F)
            out["jitter"] = np.array([jitter_px[0], jitter_px[1]], dtype=F)
        return out
