"""Texture registry: a flat HBM texel buffer + descriptor table.

TPU-native redesign of the reference's TexturePool
(crates/renderer-core/src/texture/texture_pool.rs:26-188 groups images into
2D-array textures keyed by (w,h,format)) and the renderer-level registry
(crates/renderer/src/textures.rs: sampler cache, texture transforms,
finalize_gpu_textures). A GPU needs same-shape array layers to sample
uniformly; a TPU gather does not — so instead of N pool arrays whose count
is baked into shaders (a recompile trigger in the reference,
textures.rs:43-100), ALL textures live in ONE flat (n_texels, 4) f32 buffer
with full mip chains, and a small i32 descriptor row per texture carries
size, sampler state, and per-mip offsets. Shading gathers through the
descriptor — one code path for every size mix, recompiles only when the
buffer capacity grows.

Mip generation mirrors the semantic filtering of the reference's compute
mipmapper (renderer-core/src/texture/mipmap.rs:26-62, MipmapTextureKind):
normal maps re-normalize after downsampling; metallic-roughness averages
roughness perceptually (r^2); color is plain box/area filtering in linear
space. sRGB→linear conversion happens at upload (the reference runs a
convert_srgb compute pass at pool upload: texture/convert_srgb.rs).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from ..errors import TextureError
from ..utils.allocator import BuddyAllocator, SlotAllocator

F = np.float32
# bf16 texel pool held as its uint16 bit patterns (no ml_dtypes); the
# device side views them as torch.bfloat16
BF = np.uint16


def f32_to_bf16_bits(x) -> np.ndarray:
    """float32 -> bfloat16 bit patterns (uint16), round-to-nearest-even;
    NaNs stay quiet NaNs. The same bits as ml_dtypes' f32 -> bf16 cast."""
    u = np.ascontiguousarray(x, dtype=F).view(np.uint32)
    rounded = (u + np.uint32(0x7FFF) + ((u >> 16) & np.uint32(1))) >> 16
    nan = (u & np.uint32(0x7FFFFFFF)) > np.uint32(0x7F800000)
    out = np.where(nan, (u >> 16) | np.uint32(0x40), rounded)
    return out.astype(np.uint16)
# texel row layout (TPU gather economics: cost is per ROW and flat up to
# ~128 B/row, so pack everything a trilinear tap needs into one 128-B row):
#   [0:16]  bilinear quad at this texel's mip: self/right/down/diag x RGBA
#   [16:52] the NEXT mip's 3x3 neighborhood around this texel's parent
#           anchor (row-major dy,dx x RGBA) — the parent bilinear 2x2 for
#           any sample point landing in this texel is inside it
#   [52:64] pad to 64 bf16 = 128 B
# One gather row = one EXACT trilinear tap (the old two-level layout paid
# two gather rows; ops/texsample.py holds the matching sample math).
TEXEL_COLS = 64

# descriptor i32 layout
TD_WIDTH = 0
TD_HEIGHT = 1
TD_N_MIPS = 2
TD_WRAP_S = 3
TD_WRAP_T = 4
TD_FILTER_LINEAR = 5      # mag/min filter
TD_MIP_FILTER_LINEAR = 6  # trilinear when 1
TD_MAX_ANISO = 7          # effective max anisotropy (1 = isotropic)
TD_MIP_OFFSETS = 8        # 14 entries of absolute texel offsets
MAX_MIPS = 14
DESC_I32 = 24

WRAP_REPEAT = 0
WRAP_CLAMP = 1
WRAP_MIRROR = 2


class MipmapKind(enum.Enum):
    """Semantic texture kind for mip generation — the reference's 9
    MipmapTextureKind variants (texture/mipmap.rs:26-62) plus the 4
    condensed filter classes they resolve to. The reference's compute
    shader box-filters every kind identically (mipmap/shader.wgsl); here
    the semantic kind selects a FILTER CLASS that can do better:
    NORMAL renormalizes per level, METALLIC_ROUGHNESS propagates
    perceptual roughness, everything else box-filters (COLOR in linear
    light, SCALAR componentwise — identical math, kept distinct for the
    semantic mapping)."""

    # filter classes (round-1 condensed kinds, still accepted everywhere)
    COLOR = 0
    NORMAL = 1
    METALLIC_ROUGHNESS = 2
    SCALAR = 3
    # reference MipmapTextureKind variants (mipmap.rs Albedo..VolumeThickness)
    ALBEDO = 10
    OCCLUSION = 11
    EMISSIVE = 12
    SPECULAR = 13
    SPECULAR_COLOR = 14
    TRANSMISSION = 15
    VOLUME_THICKNESS = 16

    @property
    def filter_class(self) -> "MipmapKind":
        return _MIP_FILTER_CLASS.get(self, self)


_MIP_FILTER_CLASS = {
    MipmapKind.ALBEDO: MipmapKind.COLOR,
    MipmapKind.EMISSIVE: MipmapKind.COLOR,
    MipmapKind.SPECULAR_COLOR: MipmapKind.COLOR,
    MipmapKind.OCCLUSION: MipmapKind.SCALAR,
    MipmapKind.SPECULAR: MipmapKind.SCALAR,
    MipmapKind.TRANSMISSION: MipmapKind.SCALAR,
    MipmapKind.VOLUME_THICKNESS: MipmapKind.SCALAR,
}


@dataclass(frozen=True)
class Sampler:
    """Reference: textures.rs SamplerCacheKey (wrap modes, filters)."""

    wrap_s: int = WRAP_REPEAT
    wrap_t: int = WRAP_REPEAT
    filter_linear: bool = True
    mip_filter_linear: bool = True
    # reference textures.rs:186-220: SamplerCacheKey.max_anisotropy with
    # filter-compatibility gating (anisotropy > 1 requires all-linear
    # filters, per the WebGPU sampler validity rules the reference encodes)
    max_anisotropy: int = 1

    @property
    def effective_anisotropy(self) -> int:
        if self.filter_linear and self.mip_filter_linear:
            return max(1, int(self.max_anisotropy))
        return 1


def srgb_to_linear(c: np.ndarray) -> np.ndarray:
    """Exact sRGB EOTF (matches WGSL color_space.wgsl math)."""
    c = np.asarray(c, dtype=F)
    return np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4).astype(F)


def linear_to_srgb(c: np.ndarray) -> np.ndarray:
    c = np.asarray(c, dtype=np.float64)
    out = np.where(c <= 0.0031308, c * 12.92, 1.055 * np.maximum(c, 1e-12) ** (1 / 2.4) - 0.055)
    return out.astype(F)


def _downsample_area(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """Area downsample to (h, w). Fast path for exact /2; cv2 otherwise."""
    H, W = img.shape[:2]
    if W == 2 * w and H == 2 * h:
        return img.reshape(h, 2, w, 2, img.shape[2]).mean(axis=(1, 3)).astype(F)
    import cv2

    return cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA).reshape(h, w, -1).astype(F)


def calculate_mip_levels(width: int, height: int) -> int:
    """Reference: mipmap.rs calculate_mipmap_levels."""
    return min(MAX_MIPS, int(np.floor(np.log2(max(width, height)))) + 1)


def _pack_quads(mip: np.ndarray, wrap_s: int, wrap_t: int) -> np.ndarray:
    """Bake each texel's bilinear footprint into one row: (h,w,4) → (h,w,16).

    Row = [T(y,x), T(y,x+1), T(y+1,x), T(y+1,x+1)] with the +1 neighbors
    pre-wrapped by the sampler mode (REPEAT → modular, CLAMP/MIRROR →
    edge-clamped; mirrored sampling folds the continuous coordinate into
    [0,1] at sample time, after which neighbor semantics are clamp).
    This turns a bilinear tap into ONE device gather instead of four —
    XLA TPU gathers are latency-bound per ROW, not per byte, so 4x the
    texel bytes buys a ~4x cut in sampling time (see ops/texsample.py)."""
    h, w = mip.shape[:2]
    if wrap_s == WRAP_REPEAT:
        xn = (np.arange(w) + 1) % w
    else:
        xn = np.minimum(np.arange(w) + 1, w - 1)
    if wrap_t == WRAP_REPEAT:
        yn = (np.arange(h) + 1) % h
    else:
        yn = np.minimum(np.arange(h) + 1, h - 1)
    down = mip[yn]
    return np.concatenate([mip, mip[:, xn], down, down[:, xn]], axis=-1)


def _pack_rows(mip: np.ndarray, parent: np.ndarray, wrap_s: int,
               wrap_t: int) -> np.ndarray:
    """One (h*w, TEXEL_COLS) bf16 row block for a mip level (see header).

    parent: the next mip level (h1, w1, 4); pass zeros for the last level
    (its parent block is never read — the lod clamp forces frac = 0 there).
    The parent anchor baked per texel is base = (x-1)>>1 wrapped into the
    parent dims; the device recomputes the same base from the wrapped L
    anchor and selects its bilinear 2x2 out of the 3x3 (ops/texsample.py
    _parent_blend)."""
    h, w = mip.shape[:2]
    quad = _pack_quads(mip, wrap_s, wrap_t)
    h1, w1 = parent.shape[:2]

    def wrapv(i, n, mode):
        if mode == WRAP_REPEAT:
            return i % n
        return np.clip(i, 0, n - 1)

    bx = (np.arange(w) - 1) >> 1
    by = (np.arange(h) - 1) >> 1
    cells = []
    for dy in range(3):
        prow = parent[wrapv(by + dy, h1, wrap_t)]          # (h, w1, 4)
        for dx in range(3):
            cells.append(prow[:, wrapv(bx + dx, w1, wrap_s)])
    out = np.zeros((h, w, TEXEL_COLS), dtype=F)
    out[..., :16] = quad
    out[..., 16:52] = np.concatenate(cells, axis=-1)
    return f32_to_bf16_bits(out.reshape(-1, TEXEL_COLS))


def generate_mip_chain(img: np.ndarray, kind: MipmapKind) -> List[np.ndarray]:
    """Full chain [level0, level1, ...] with semantic filtering per kind."""
    kind = kind.filter_class
    img = np.asarray(img, dtype=F)
    h, w = img.shape[:2]
    chain = [img]
    levels = calculate_mip_levels(w, h)
    cur = img
    for _ in range(1, levels):
        nw, nh = max(1, w // 2), max(1, h // 2)
        if kind == MipmapKind.NORMAL:
            vec = cur[..., :3] * 2.0 - 1.0
            down = _downsample_area(np.concatenate([vec, cur[..., 3:4]], axis=-1), nw, nh)
            n = down[..., :3]
            norm = np.linalg.norm(n, axis=-1, keepdims=True)
            n = np.where(norm > 1e-6, n / np.maximum(norm, 1e-6), np.array([0, 0, 1], F))
            nxt = np.concatenate([(n + 1.0) * 0.5, down[..., 3:4]], axis=-1).astype(F)
        elif kind == MipmapKind.METALLIC_ROUGHNESS:
            # roughness lives in G; average r^2 then sqrt (perceptual)
            tmp = cur.copy()
            tmp[..., 1] = cur[..., 1] ** 2
            down = _downsample_area(tmp, nw, nh)
            down[..., 1] = np.sqrt(np.maximum(down[..., 1], 0.0))
            nxt = down.astype(F)
        else:
            nxt = _downsample_area(cur, nw, nh)
        chain.append(nxt)
        cur, w, h = nxt, nw, nh
    return chain


class Textures:
    """Flat texel buffer + descriptors + KHR_texture_transform table."""

    def __init__(self, initial_texels: int = 1 << 16, initial_descriptors: int = 32):
        self._texel_alloc = BuddyAllocator(initial_texels, min_block=256)
        # packed texel rows: bilinear quad + parent-mip 3x3 (_pack_rows)
        self.texels_packed = np.zeros((self._texel_alloc.capacity, TEXEL_COLS),
                                      dtype=BF)
        self._desc_alloc = SlotAllocator(initial_descriptors)
        self.descriptors = np.zeros((self._desc_alloc.capacity, DESC_I32), dtype=np.int32)
        self._tex_offset: Dict[int, int] = {}  # key -> texel buffer offset
        # KHR_texture_transform 2x3 matrices (reference: textures.rs texture transforms buffer)
        self._tt_alloc = SlotAllocator(8)
        self.tex_transforms = np.tile(
            np.array([1, 0, 0, 1, 0, 0, 0, 0], dtype=F), (self._tt_alloc.capacity, 1)
        )
        self.gpu_dirty = True

    @property
    def texel_capacity(self) -> int:
        return self._texel_alloc.capacity

    @property
    def descriptor_capacity(self) -> int:
        return self._desc_alloc.capacity

    def add_image(
        self,
        image: np.ndarray,
        srgb: bool = True,
        sampler: Sampler = Sampler(),
        kind: MipmapKind = MipmapKind.COLOR,
        generate_mips: bool = True,
    ) -> int:
        """Upload an image (H,W,3|4) uint8 or float; returns a texture key.

        Reference flow: textures.rs:339 add_image → pool upload with
        srgb-convert + mipmap generation (texture_pool.rs:26-188).
        """
        img = np.asarray(image)
        if img.ndim not in (2, 3) or img.size == 0:
            raise TextureError(
                f"image must be (H,W) or (H,W,C) and non-empty, got shape "
                f"{img.shape}")
        if img.ndim == 3 and img.shape[2] not in (1, 3, 4):
            raise TextureError(
                f"image must have 1, 3 or 4 channels, got {img.shape[2]}")
        native_rgba = None
        if img.dtype == np.uint8:
            from ..utils import native as _native

            # exact-LUT native conversion (u8 -> f32 RGBA + sRGB EOTF):
            # the numpy chain costs ~0.25 s per 1024x1024 upload
            native_rgba = _native.u8_to_f32_rgba(img, srgb)
        if native_rgba is not None:
            img = native_rgba
        else:
            if img.dtype == np.uint8:
                img = img.astype(F) / 255.0
            img = img.astype(F)
            if img.ndim == 2:
                img = img[..., None]
            if img.shape[2] == 1:
                img = np.repeat(img, 3, axis=2)
            if img.shape[2] == 3:
                img = np.concatenate(
                    [img, np.ones((*img.shape[:2], 1), F)], axis=2)
            if srgb:
                img = np.concatenate(
                    [srgb_to_linear(img[..., :3]), img[..., 3:4]], axis=2)

        levels = calculate_mip_levels(img.shape[1], img.shape[0]) \
            if generate_mips else 1
        dims = [(img.shape[0], img.shape[1])]
        while len(dims) < levels:
            ph, pw = dims[-1]
            dims.append((max(1, ph // 2), max(1, pw // 2)))
        total = sum(h * w for h, w in dims)
        offset = self._texel_alloc.alloc(total)
        if self._texel_alloc.take_needs_resize():
            old = self.texels_packed
            self.texels_packed = np.zeros(
                (self._texel_alloc.capacity, TEXEL_COLS), dtype=BF)
            # uint16 bit-copy: bf16->bf16 numpy assignment is an
            # element-wise ml_dtypes cast, ~10x slower than memcpy
            self.texels_packed[: old.shape[0]].view(np.uint16)[:] = \
                old.view(np.uint16)

        key = self._desc_alloc.insert()
        if self._desc_alloc.take_needs_resize():
            old_d = self.descriptors
            self.descriptors = np.zeros((self._desc_alloc.capacity, DESC_I32), dtype=np.int32)
            self.descriptors[: old_d.shape[0]] = old_d
        row = self._desc_alloc.row_of(key)
        self._tex_offset[key] = offset

        d = np.zeros(DESC_I32, dtype=np.int32)
        d[TD_WIDTH] = img.shape[1]
        d[TD_HEIGHT] = img.shape[0]
        d[TD_N_MIPS] = levels
        d[TD_WRAP_S] = sampler.wrap_s
        d[TD_WRAP_T] = sampler.wrap_t
        d[TD_FILTER_LINEAR] = int(sampler.filter_linear)
        d[TD_MIP_FILTER_LINEAR] = int(sampler.mip_filter_linear)
        d[TD_MAX_ANISO] = sampler.effective_anisotropy
        off = offset
        for i, (mh, mw) in enumerate(dims):
            d[TD_MIP_OFFSETS + i] = off
            off += mh * mw
        # clamp remaining mip offsets to the last mip (simplifies device clamping)
        for i in range(levels, MAX_MIPS):
            d[TD_MIP_OFFSETS + i] = d[TD_MIP_OFFSETS + levels - 1]
        self._pack_into(img, kind, sampler, levels, offset, total)
        self.descriptors[row] = d
        self.gpu_dirty = True
        return key

    def update_image(
        self,
        key: int,
        image: np.ndarray,
        srgb: bool = True,
        kind: MipmapKind = MipmapKind.COLOR,
    ) -> None:
        """Rewrite an existing texture's texels in place (same dimensions
        — the descriptor row, mip offsets and allocation are reused, so
        TextureRefs and packed materials stay valid). This is the
        reference's atlas-page update flow (mega_texture writer re-writes
        a layer without re-binding)."""
        if key not in self._tex_offset:
            raise TextureError(f"unknown or removed texture key {key}")
        row = self._desc_alloc.row_of(key)
        d = self.descriptors[row]
        img = np.asarray(image)
        if img.dtype == np.uint8:
            img = img.astype(F) / 255.0
        img = img.astype(F)
        if img.ndim == 2:
            img = img[..., None]
        if img.shape[2] == 1:
            img = np.repeat(img, 3, axis=2)
        if img.shape[2] == 3:
            img = np.concatenate([img, np.ones((*img.shape[:2], 1), F)], axis=2)
        if (img.shape[1], img.shape[0]) != (d[TD_WIDTH], d[TD_HEIGHT]):
            raise TextureError(
                f"update_image size mismatch: texture is "
                f"{d[TD_WIDTH]}x{d[TD_HEIGHT]}, image is "
                f"{img.shape[1]}x{img.shape[0]}")
        if srgb:
            img = np.concatenate([srgb_to_linear(img[..., :3]), img[..., 3:4]], axis=2)
        n_mips = int(d[TD_N_MIPS])
        sampler = Sampler(wrap_s=int(d[TD_WRAP_S]), wrap_t=int(d[TD_WRAP_T]))
        off = self._tex_offset[key]
        total = sum(
            max(1, img.shape[0] >> i) * max(1, img.shape[1] >> i)
            for i in range(n_mips))
        self._pack_into(img, kind, sampler, n_mips, off, total)
        self.gpu_dirty = True

    def _pack_into(self, img: np.ndarray, kind: MipmapKind, sampler,
                   levels: int, offset: int, total: int) -> None:
        """Generate the mip chain and write its packed 128-B texel rows
        into texels_packed[offset : offset + total].

        Native single-pass path first (utils/native.py pack_texture_mips
        — chain + quad/parent packing + f32->bf16 in C++; the numpy
        packer measured ~60 s for five 1024x1024 maps, ~98% of
        DamagedHelmet-class glTF ingest). numpy fallback when the .so is
        missing or a level transition is not an integer area ratio
        (non-power-of-two tails go through cv2 INTER_AREA)."""
        from ..utils import native as _native

        kind_c = {MipmapKind.COLOR: 0, MipmapKind.SCALAR: 0,
                  MipmapKind.NORMAL: 1,
                  MipmapKind.METALLIC_ROUGHNESS: 2}[kind.filter_class]
        dest = self.texels_packed[offset : offset + total]
        if _native.pack_texture_mips(img, kind_c, sampler.wrap_s,
                                     sampler.wrap_t, levels,
                                     dest.view(np.uint16)):
            return
        chain = generate_mip_chain(img, kind) if levels > 1 else [img]
        off = offset
        for i, mip in enumerate(chain):
            parent = (chain[i + 1] if i + 1 < len(chain)
                      else np.zeros((1, 1, 4), F))
            packed = _pack_rows(mip, parent, sampler.wrap_s, sampler.wrap_t)
            n = mip.shape[0] * mip.shape[1]
            # uint16 bit-copy: ml_dtypes bf16->bf16 assignment is an
            # element-wise cast loop, ~10x slower than this memcpy
            self.texels_packed[off : off + n].view(np.uint16)[:] = \
                packed.view(np.uint16)
            off += n

    def remove(self, key: int) -> None:
        if key not in self._tex_offset:
            raise TextureError(f"unknown or removed texture key {key}")
        self._texel_alloc.free(self._tex_offset.pop(key))
        self._desc_alloc.remove(key)
        self.gpu_dirty = True

    def row_of(self, key: int) -> int:
        try:
            return self._desc_alloc.row_of(key)
        except Exception:
            raise TextureError(
                f"unknown or removed texture key {key}") from None

    def add_texture_transform(self, offset=(0, 0), rotation: float = 0.0, scale=(1, 1)) -> int:
        """KHR_texture_transform: uv' = R*S*uv + offset. Returns transform key."""
        key = self._tt_alloc.insert()
        if self._tt_alloc.take_needs_resize():
            old = self.tex_transforms
            self.tex_transforms = np.tile(
                np.array([1, 0, 0, 1, 0, 0, 0, 0], dtype=F), (self._tt_alloc.capacity, 1)
            )
            self.tex_transforms[: old.shape[0]] = old
        c, s = np.cos(rotation), np.sin(rotation)
        sx, sy = scale
        # glTF spec: uv' = T * R * S * uv
        m = np.array([[c * sx, -s * sy], [s * sx, c * sy]], dtype=F)
        row = self._tt_alloc.row_of(key)
        self.tex_transforms[row] = [m[0, 0], m[0, 1], m[1, 0], m[1, 1], offset[0], offset[1], 0, 0]
        self.gpu_dirty = True
        return key

    def transform_row_of(self, key: int) -> int:
        try:
            return self._tt_alloc.row_of(key)
        except Exception:
            raise TextureError(
                f"unknown or removed texture-transform key {key}") from None
