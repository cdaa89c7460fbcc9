"""Texture / framebuffer export to PNG + store occupancy reports.

Port of awsm_renderer_tpu/utils/exporter.py; export_image and
export_depth also take a torch tensor on any device. Mirrors reference
behavior: renderer-core/src/texture/exporter.rs (read
back any GPU texture → PNG for offline inspection) and
texture_pool/report.rs + mega_texture/report.rs (serde occupancy reports
surfaced in the demo sidebar).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def _host(array) -> np.ndarray:
    """numpy view of an array or of a torch tensor on any device."""
    if hasattr(array, "detach"):
        return array.detach().cpu().numpy()
    return np.asarray(array)


def export_image(array, path: str, *, srgb_encoded: bool = True) -> None:
    """Save an (H,W,3|4) float [0,1] or uint8 array or tensor as PNG.

    For linear HDR input set srgb_encoded=False to apply the transfer
    function (exporter.rs handles f16 HDR targets the same way)."""
    from PIL import Image

    img = _host(array)
    if img.dtype != np.uint8:
        img = np.nan_to_num(np.asarray(img, dtype=np.float64))
        if not srgb_encoded:
            img = np.where(img <= 0.0031308, img * 12.92,
                           1.055 * np.maximum(img, 1e-12) ** (1 / 2.4) - 0.055)
        img = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=2)
    Image.fromarray(img).save(path)


def export_depth(depth, path: str) -> None:
    """Depth plane → normalized grayscale PNG (debug aid)."""
    d = _host(depth).astype(np.float64)
    finite = d[np.isfinite(d) & (d < 1.0)]
    if finite.size:
        lo, hi = finite.min(), finite.max()
        d = np.where(d >= 1.0, 1.0, (d - lo) / max(hi - lo, 1e-9))
    export_image(d, path)


def texture_report(textures) -> Dict:
    """Occupancy report for the flat texel buffer
    (reference: texture_pool/report.rs TexturePoolReport)."""
    alloc = textures._texel_alloc
    descs = []
    for key, off in textures._tex_offset.items():
        row = textures.row_of(key)
        d = textures.descriptors[row]
        descs.append({
            "key": key, "width": int(d[0]), "height": int(d[1]),
            "mips": int(d[2]), "offset": int(off),
            "texels": int(alloc.size_of(off)),
        })
    return {
        "capacity_texels": alloc.capacity,
        "used_texels": alloc.used,
        "occupancy": alloc.used / max(alloc.capacity, 1),
        "bytes": alloc.capacity * 16,
        "textures": sorted(descs, key=lambda d: d["offset"]),
    }


def geometry_report(meshes) -> Dict:
    """Pool occupancy for vertex/triangle/morph buffers
    (reference exposes the same via buffer reports)."""
    return {
        "triangles": {"capacity": meshes._t_alloc.capacity, "used": meshes._t_alloc.used},
        "corners": {"capacity": 3 * meshes._t_alloc.capacity,
                    "used": 3 * meshes._t_alloc.used},
        "morph_rows": {"capacity": meshes._m_alloc.capacity, "used": meshes._m_alloc.used},
        "meshes": meshes.count,
    }
