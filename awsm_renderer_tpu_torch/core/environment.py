"""Environment: skybox cubemap + image-based lighting (IBL).

Mirrors reference behavior: crates/renderer/src/environment.rs (skybox
cubemap, per-face update) and lights/ibl.rs (prefiltered specular env +
irradiance cubemaps + BRDF LUT). Defaults are solid-color cubemaps exactly
like the reference builder (`Environment::new(Skybox colors)`,
`Lights::new(Ibl colors)` — lib.rs:297-312).

TPU representation: cubemaps are (6, S, S, 4) f32 arrays. The prefiltered
specular chain is stored as (N_SPEC_MIPS, 6, S, S, 4) with every roughness
level kept at full S resolution — memory is trivial at S=64 and uniform
indexing keeps the shading gather path branch-free.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

F = np.float32

SKYBOX_SIZE = 64
SPEC_SIZE = 64
N_SPEC_MIPS = 5
IRRADIANCE_SIZE = 16


def load_hdr_image(path: str) -> np.ndarray:
    """Load an HDR/LDR environment image as linear float RGB.

    Reference: renderer-core/src/image/exr.rs (EXR decode) + image.rs.
    Tries cv2 (EXR/HDR support), falls back to imageio, then PIL (LDR,
    sRGB-decoded)."""
    from .textures import srgb_to_linear

    def _to_linear(img: np.ndarray, src_dtype) -> np.ndarray:
        """Integer-coded files are sRGB-encoded LDR: normalize to [0,1]
        and decode; float files (EXR/HDR) are already linear radiance."""
        if src_dtype == np.uint8:
            return srgb_to_linear(img / 255.0)
        if src_dtype == np.uint16:
            return srgb_to_linear(img / 65535.0)
        return img

    try:
        import cv2

        img = cv2.imread(path, cv2.IMREAD_ANYDEPTH | cv2.IMREAD_ANYCOLOR)
        if img is not None:
            src_dtype = img.dtype
            if img.ndim == 2:
                img = np.repeat(img[..., None], 3, axis=2)
            img = cv2.cvtColor(img.astype(np.float32), cv2.COLOR_BGR2RGB)
            return np.asarray(_to_linear(img, src_dtype), dtype=F)
    except Exception:
        pass
    try:
        import imageio.v3 as iio

        raw = iio.imread(path)
        img = np.asarray(raw, dtype=F)
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=2)
        return np.asarray(_to_linear(img[..., :3], raw.dtype), dtype=F)
    except Exception:
        pass
    from PIL import Image

    arr = np.asarray(Image.open(path).convert("RGB"), dtype=F) / 255.0
    from .textures import srgb_to_linear

    return srgb_to_linear(arr)


def equirect_to_cubemap(equirect: np.ndarray, size: int = 128) -> np.ndarray:
    """Equirectangular (H, W, 3|4) → (6, size, size, 4) cubemap, bilinear.

    Face order/orientation matches ops/cubemap.py sampling."""
    eq = np.asarray(equirect, dtype=F)
    if eq.shape[-1] == 3:
        eq = np.concatenate([eq, np.ones((*eq.shape[:-1], 1), F)], axis=-1)
    Hs, Ws = eq.shape[:2]

    # per-face direction construction mirrors cubemap_face_uv inverted
    uv = (np.arange(size, dtype=np.float64) + 0.5) / size * 2.0 - 1.0
    u, v = np.meshgrid(uv, uv, indexing="xy")   # u: x (sc), v: y (tc)
    ones = np.ones_like(u)
    faces_dirs = [
        np.stack([ones, -v, -u], -1),    # +X: sc=-z, tc=-y
        np.stack([-ones, -v, u], -1),    # -X
        np.stack([u, ones, v], -1),      # +Y: sc=x, tc=z
        np.stack([u, -ones, -v], -1),    # -Y
        np.stack([u, -v, ones], -1),     # +Z
        np.stack([-u, -v, -ones], -1),   # -Z
    ]
    out = np.zeros((6, size, size, 4), F)
    for f, d in enumerate(faces_dirs):
        dn = d / np.linalg.norm(d, axis=-1, keepdims=True)
        theta = np.arctan2(dn[..., 0], -dn[..., 2])       # azimuth
        phi = np.arcsin(np.clip(dn[..., 1], -1, 1))        # elevation
        x = (theta / (2 * np.pi) + 0.5) * Ws - 0.5
        y = (0.5 - phi / np.pi) * Hs - 0.5
        x0 = np.floor(x).astype(np.int64)
        y0 = np.clip(np.floor(y).astype(np.int64), 0, Hs - 1)
        fx = (x - x0)[..., None]
        fy = (y - y0)[..., None]
        x0m = np.mod(x0, Ws)
        x1m = np.mod(x0 + 1, Ws)
        y1 = np.clip(y0 + 1, 0, Hs - 1)
        out[f] = (
            eq[y0, x0m] * (1 - fx) * (1 - fy) + eq[y0, x1m] * fx * (1 - fy)
            + eq[y1, x0m] * (1 - fx) * fy + eq[y1, x1m] * fx * fy
        )
    return out


def _resize_faces(faces: np.ndarray, size: int) -> np.ndarray:
    """(6, H, W, 4) → (6, size, size, 4), area/bilinear."""
    faces = np.asarray(faces, dtype=F)
    if faces.shape[1] == size and faces.shape[2] == size:
        return faces
    try:
        import cv2

        interp = cv2.INTER_AREA if faces.shape[1] > size else cv2.INTER_LINEAR
        return np.stack([cv2.resize(f, (size, size), interpolation=interp)
                         for f in faces])
    except Exception:
        # numpy bilinear fallback
        Hs = faces.shape[1]
        t = (np.arange(size, dtype=np.float64) + 0.5) * Hs / size - 0.5
        i0 = np.clip(np.floor(t).astype(np.int64), 0, Hs - 1)
        i1 = np.clip(i0 + 1, 0, Hs - 1)
        fr = (t - i0).astype(F)
        rows = (faces[:, i0] * (1 - fr)[None, :, None, None]
                + faces[:, i1] * fr[None, :, None, None])
        cols = (rows[:, :, i0] * (1 - fr)[None, None, :, None]
                + rows[:, :, i1] * fr[None, None, :, None])
        return cols.astype(F)


def _coerce_ktx2(src):
    """Accept a Ktx2Image, raw bytes, or a filesystem path."""
    from ..gltf.ktx2 import Ktx2Image, load_ktx2

    if isinstance(src, Ktx2Image):
        return src
    if isinstance(src, memoryview):
        src = bytes(src)
    return load_ktx2(src)


def solid_cubemap(color, size: int) -> np.ndarray:
    c = np.asarray(color, dtype=F)
    if c.shape[0] == 3:
        c = np.concatenate([c, [1.0]]).astype(F)
    return np.broadcast_to(c, (6, size, size, 4)).copy()


class Environment:
    def __init__(self, skybox_color=(0.1, 0.1, 0.12), ibl_color=(1.0, 1.0, 1.0),
                 ibl_intensity: float = 1.0):
        # solid environments let shading compile IBL/sky reads to constants
        self.is_solid = True
        self.skybox = solid_cubemap(skybox_color, SKYBOX_SIZE)
        # prefiltered specular: solid color at every roughness level
        self.prefiltered = np.broadcast_to(
            solid_cubemap(np.asarray(ibl_color, F) * ibl_intensity, SPEC_SIZE),
            (N_SPEC_MIPS, 6, SPEC_SIZE, SPEC_SIZE, 4),
        ).copy()
        self.irradiance = solid_cubemap(np.asarray(ibl_color, F) * ibl_intensity, IRRADIANCE_SIZE)
        self.ibl_intensity = ibl_intensity
        self.gpu_dirty = True

    def set_skybox_cubemap(self, faces: np.ndarray) -> None:
        """faces: (6, S, S, 3|4) linear float. Reference: environment.rs
        update_skybox_all_faces."""
        faces = np.asarray(faces, dtype=F)
        if faces.shape[-1] == 3:
            faces = np.concatenate([faces, np.ones((*faces.shape[:-1], 1), F)], axis=-1)
        self.skybox = faces
        self.is_solid = False
        self.gpu_dirty = True

    def set_environment_from_equirect(self, image_or_path, size: int = 128) -> None:
        """Load an equirect panorama (EXR/HDR/PNG path or array) as skybox
        AND IBL source in one call (the usual frontend flow: pick an env →
        skybox + prefiltered + irradiance)."""
        img = load_hdr_image(image_or_path) if isinstance(image_or_path, str) \
            else np.asarray(image_or_path, dtype=F)
        faces = equirect_to_cubemap(img, size)
        self.set_skybox_cubemap(faces)
        self.set_ibl_from_cubemap(faces)

    def set_skybox_from_ktx2(self, src) -> None:
        """Skybox from a KTX2 cubemap (path, bytes, or Ktx2Image).
        Reference: cubemap/ktx.rs → environment.rs update_skybox."""
        img = _coerce_ktx2(src)
        if not img.is_cubemap:
            raise ValueError("KTX2 image is not a cubemap (6 faces required)")
        self.set_skybox_cubemap(img.cubemap_faces(0))

    def set_ibl_from_ktx2(self, prefiltered, irradiance=None) -> None:
        """IBL from pre-baked KTX2 cubemaps, the reference's production
        path (lights/ibl.rs: prefiltered_env + irradiance loaded from
        KTX2 with mip chains, cubemap/ktx.rs).

        prefiltered: KTX2 cubemap whose mip chain is the roughness
        ladder; each level is resampled to the uniform (SPEC_SIZE,
        SPEC_SIZE) representation (shading indexes mips at full res,
        see module docstring). irradiance: optional KTX2 cubemap
        (level 0 used); when absent, a heavily blurred last prefiltered
        level stands in."""
        img = _coerce_ktx2(prefiltered)
        if not img.is_cubemap:
            raise ValueError("prefiltered KTX2 is not a cubemap")
        n_src = len(img.levels)
        mips = []
        for m in range(N_SPEC_MIPS):
            lvl = img.cubemap_faces(min(m, n_src - 1))
            if lvl.shape[-1] == 3:
                lvl = np.concatenate(
                    [lvl, np.ones((*lvl.shape[:-1], 1), F)], axis=-1)
            mips.append(_resize_faces(lvl, SPEC_SIZE))
        self.prefiltered = np.stack(mips)
        if irradiance is not None:
            irr_img = _coerce_ktx2(irradiance)
            if not irr_img.is_cubemap:
                raise ValueError("irradiance KTX2 is not a cubemap")
            irr = irr_img.cubemap_faces(0)
            if irr.shape[-1] == 3:
                irr = np.concatenate(
                    [irr, np.ones((*irr.shape[:-1], 1), F)], axis=-1)
            self.irradiance = _resize_faces(irr, IRRADIANCE_SIZE)
        else:
            self.irradiance = _resize_faces(mips[-1], IRRADIANCE_SIZE)
        self.is_solid = False
        self.gpu_dirty = True

    def set_environment_from_ktx2(self, skybox, prefiltered=None,
                                  irradiance=None) -> None:
        """One-call environment setup from KTX2 assets (the frontend's
        env-picker flow): skybox cubemap + optional pre-baked IBL; when
        no prefiltered chain is given, IBL is synthesized from the
        skybox via set_ibl_from_cubemap."""
        img = _coerce_ktx2(skybox)
        if not img.is_cubemap:
            raise ValueError("skybox KTX2 is not a cubemap")
        self.set_skybox_cubemap(img.cubemap_faces(0))
        if prefiltered is not None:
            self.set_ibl_from_ktx2(prefiltered, irradiance)
        else:
            self.set_ibl_from_cubemap(self.skybox)

    def set_ibl_from_cubemap(self, env_faces: np.ndarray) -> None:
        """Build prefiltered + irradiance maps from an environment cubemap.

        Host-side cosine/GGX-ish prefiltering via progressive blurring —
        the reference loads these pre-baked from KTX2 (lights/ibl.rs); we
        synthesize them. Uses simple repeated box filtering per mip as a
        GGX approximation (adequate for parity-level IBL).
        """
        import cv2

        env_faces = np.asarray(env_faces, dtype=F)
        if env_faces.shape[-1] == 3:
            env_faces = np.concatenate(
                [env_faces, np.ones((*env_faces.shape[:-1], 1), F)], axis=-1
            )
        S = SPEC_SIZE
        base = np.stack([
            cv2.resize(f, (S, S), interpolation=cv2.INTER_AREA) for f in env_faces
        ])
        mips = [base]
        cur = base
        for _ in range(1, N_SPEC_MIPS):
            blurred = np.stack([cv2.GaussianBlur(f, (0, 0), sigmaX=2.0) for f in cur])
            cur = blurred
            mips.append(cur)
        self.prefiltered = np.stack(mips)
        irr = np.stack([
            cv2.resize(
                cv2.GaussianBlur(f, (0, 0), sigmaX=8.0), (IRRADIANCE_SIZE, IRRADIANCE_SIZE),
                interpolation=cv2.INTER_AREA,
            )
            for f in mips[-1]
        ])
        self.irradiance = irr
        self.is_solid = False
        self.gpu_dirty = True
