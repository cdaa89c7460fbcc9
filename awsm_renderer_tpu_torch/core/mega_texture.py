"""MegaTexture: atlas packing of many small images into shared pages.

Mirrors reference behavior: crates/renderer-core/src/texture/
mega_texture.rs:69-211 (collection of atlases, rect packing per layer,
grows layer → atlas → new atlas, per-entry UV offset/scale, texture-type
filtering, occupancy report). TPU redesign: each atlas page is ONE texture
in the flat texel buffer (core/textures.py); entries resolve to a
TextureRef whose KHR-transform row carries the offset/scale (+ a
wrap-before-transform flag so REPEAT works inside the sub-rect). Packing
is MaxRects with the best-area-fit heuristic per page — the reference's
packer exactly (mega_texture.rs:422 `insert_list(&items,
Heuristic::BestAreaFit)` via binpack2d); r5 replaced the earlier skyline
packer so growth behavior and placements track the reference class.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..errors import TextureError
from .materials import TextureRef
from .textures import MipmapKind, Sampler, Textures, WRAP_CLAMP

F = np.float32


class TextureType(enum.Enum):
    """Reference: mega_texture.rs TextureType — pages are segregated per
    semantic kind so mip filtering stays correct."""

    ALBEDO = "albedo"
    NORMAL = "normal"
    METALLIC_ROUGHNESS = "metallic_roughness"
    OCCLUSION = "occlusion"
    EMISSIVE = "emissive"

    @property
    def srgb(self) -> bool:
        return self in (TextureType.ALBEDO, TextureType.EMISSIVE)

    @property
    def mip_kind(self) -> MipmapKind:
        if self == TextureType.NORMAL:
            return MipmapKind.NORMAL
        if self == TextureType.METALLIC_ROUGHNESS:
            return MipmapKind.METALLIC_ROUGHNESS
        return MipmapKind.COLOR


@dataclass
class MegaTextureEntry:
    """Reference: MegaTextureIndex (atlas id + uv offset/scale)."""

    page_index: int
    x: int
    y: int
    width: int
    height: int
    texture_ref: TextureRef


def _split_free(fr: Tuple[int, int, int, int],
                pl: Tuple[int, int, int, int]):
    """MaxRects split: remove the placed rect from one free rect,
    yielding up to 4 MAXIMAL remainder rects (full-extent left/right/
    top/bottom strips — the defining property of the MaxRects scheme:
    remainders overlap each other but each is as large as possible)."""
    fx, fy, fw, fh = fr
    px, py, pw, ph = pl
    if px >= fx + fw or px + pw <= fx or py >= fy + fh or py + ph <= fy:
        return [fr]
    out = []
    if px > fx:
        out.append((fx, fy, px - fx, fh))                  # left strip
    if px + pw < fx + fw:
        out.append((px + pw, fy, fx + fw - (px + pw), fh))  # right strip
    if py > fy:
        out.append((fx, fy, fw, py - fy))                  # bottom strip
    if py + ph < fy + fh:
        out.append((fx, py + ph, fw, fy + fh - (py + ph)))  # top strip
    return out


def _contains(a, b) -> bool:
    """rect a contains rect b."""
    ax, ay, aw, ah = a
    bx, by, bw, bh = b
    return ax <= bx and ay <= by and bx + bw <= ax + aw and by + bh <= ay + ah


class _Page:
    """One atlas page with a MaxRects best-area-fit packer — the
    reference's packing exactly (mega_texture.rs:422: binpack2d
    `Heuristic::BestAreaFit` per layer). Free space is a list of
    maximal free rectangles; placement picks the free rect whose
    leftover AREA is smallest (ties: smaller leftover short side, then
    bottom-left), then re-splits every intersecting free rect and
    prunes contained ones."""

    def __init__(self, size: int, ttype: TextureType):
        self.size = size
        self.ttype = ttype
        self.free: List[Tuple[int, int, int, int]] = [(0, 0, size, size)]
        self.pixels = np.zeros((size, size, 4), F)
        self.dirty = True
        self.texture_key: Optional[int] = None
        self.used_area = 0

    def try_alloc(self, w: int, h: int) -> Optional[Tuple[int, int]]:
        if w > self.size or h > self.size:
            return None
        best = None  # key = (leftover area, leftover short side, y, x)
        for fx, fy, fw, fh in self.free:
            if w <= fw and h <= fh:
                key = (fw * fh - w * h, min(fw - w, fh - h), fy, fx)
                if best is None or key < best[0]:
                    best = (key, fx, fy)
        if best is None:
            return None
        _, x, y = best
        self._place(x, y, w, h)
        return x, y

    def _place(self, x: int, y: int, w: int, h: int) -> None:
        placed = (x, y, w, h)
        new: List[Tuple[int, int, int, int]] = []
        for fr in self.free:
            new.extend(_split_free(fr, placed))
        pruned: List[Tuple[int, int, int, int]] = []
        for i, a in enumerate(new):
            redundant = False
            for j, b in enumerate(new):
                if i == j:
                    continue
                if _contains(b, a) and (a != b or j < i):
                    redundant = True
                    break
            if not redundant:
                pruned.append(a)
        self.free = pruned


class MegaTexture:
    """Atlas collection; `finalize()` uploads dirty pages (the analog of
    the reference's write/update flow + finalize_gpu_textures)."""

    def __init__(self, textures: Textures, page_size: int = 1024, padding: int = 4):
        self.textures = textures
        self.page_size = page_size
        self.padding = padding
        self._pages: Dict[TextureType, List[_Page]] = {}
        self.entries: List[MegaTextureEntry] = []

    def add_image(self, image: np.ndarray, ttype: TextureType = TextureType.ALBEDO,
                  wrap: bool = True) -> MegaTextureEntry:
        img = np.asarray(image)
        if img.dtype == np.uint8:
            img = img.astype(F) / 255.0
        if img.shape[-1] == 3:
            img = np.concatenate([img, np.ones((*img.shape[:2], 1), F)], axis=-1)
        h, w = img.shape[:2]
        pad = self.padding
        pages = self._pages.setdefault(ttype, [])

        spot = None
        page = None
        for pg in pages:
            spot = pg.try_alloc(w + 2 * pad, h + 2 * pad)
            if spot is not None:
                page = pg
                break
        if spot is None:
            page = _Page(self.page_size, ttype)
            pages.append(page)
            spot = page.try_alloc(w + 2 * pad, h + 2 * pad)
            if spot is None:
                raise TextureError(
                    f"image {w}x{h} larger than mega-texture page {self.page_size}")
        x, y = spot[0] + pad, spot[1] + pad

        # write pixels with an edge-extended gutter (mip bleed control)
        padded = np.pad(img, ((pad, pad), (pad, pad), (0, 0)), mode="edge")
        page.pixels[y - pad : y + h + pad, x - pad : x + w + pad] = padded
        page.dirty = True
        page.used_area += (w + 2 * pad) * (h + 2 * pad)

        entry = MegaTextureEntry(
            page_index=pages.index(page), x=x, y=y, width=w, height=h,
            texture_ref=None,  # filled by finalize
        )
        entry._ttype = ttype  # type: ignore[attr-defined]
        entry._wrap = wrap    # type: ignore[attr-defined]
        self.entries.append(entry)
        return entry

    def finalize(self) -> None:
        """Upload dirty pages and resolve entry TextureRefs."""
        for ttype, pages in self._pages.items():
            for pg in pages:
                if pg.dirty:
                    if pg.texture_key is None:
                        pg.texture_key = self.textures.add_image(
                            pg.pixels, srgb=False,  # stored linear already
                            sampler=Sampler(wrap_s=WRAP_CLAMP, wrap_t=WRAP_CLAMP),
                            kind=ttype.mip_kind,
                        )
                    else:
                        # in-place texel rewrite: existing entry refs and
                        # packed materials keep pointing at the same row
                        self.textures.update_image(
                            pg.texture_key, pg.pixels, srgb=False,
                            kind=ttype.mip_kind)
                    pg.dirty = False
        S = self.page_size
        for entry in self.entries:
            if entry.texture_ref is not None:
                continue
            ttype = entry._ttype  # type: ignore[attr-defined]
            pg = self._pages[ttype][entry.page_index]
            tk = self.textures.add_texture_transform(
                offset=(entry.x / S, entry.y / S),
                scale=(entry.width / S, entry.height / S),
            )
            row = self.textures.transform_row_of(tk)
            if entry._wrap:  # type: ignore[attr-defined]
                self.textures.tex_transforms[row, 6] = 1.0
            entry.texture_ref = TextureRef(
                self.textures.row_of(pg.texture_key), uv_set=0, transform_id=row)

    def report(self) -> dict:
        """Occupancy report (reference: mega_texture/report.rs)."""
        out = {}
        for ttype, pages in self._pages.items():
            out[ttype.value] = [
                {"occupancy": pg.used_area / (pg.size * pg.size),
                 "size": pg.size, "entries": sum(
                     1 for e in self.entries
                     if getattr(e, "_ttype", None) == ttype and e.page_index == i)}
                for i, pg in enumerate(pages)
            ]
        return out
