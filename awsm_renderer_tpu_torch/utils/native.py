"""ctypes bindings for the native host runtime (native/awsm_host.cpp).

The reference's host tier is native Rust; ours is C++ behind a C ABI with
numpy fallbacks (`HAVE_NATIVE` False) so nothing hard-depends on the .so.

The port builds its own copy of the library from the repository's
``native/awsm_host.cpp`` with ``native/Makefile``'s compiler flags into
``<repo>/build/host/`` at first use, under a name keyed by a hash of the
source, the flags and the host CPU (``-march=native`` code must not run
on another machine that shares the directory; an edit rebuilds). Without
a C++ compiler, or when the build fails, every entry point takes its
numpy fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
from typing import Optional

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SOURCE = os.path.join(_REPO, "native", "awsm_host.cpp")
_BUILD_DIR = os.path.join(_REPO, "build", "host")
# native/Makefile's CXXFLAGS
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17", "-Wall")


def _cpu_tag() -> bytes:
    """The CPU's model and feature flags (what -march=native compiles
    for), or the machine type where /proc/cpuinfo is unreadable."""
    try:
        with open("/proc/cpuinfo") as f:
            lines = [ln for ln in f if ln.startswith(("model name", "flags"))]
        return "".join(lines[:2]).encode()
    except OSError:
        return platform.machine().encode()


def _lib_path() -> str:
    h = hashlib.sha256(" ".join(CXXFLAGS).encode() + _cpu_tag())
    if os.path.exists(_SOURCE):
        with open(_SOURCE, "rb") as f:
            h.update(f.read())
    return os.path.join(_BUILD_DIR, f"libawsm_host_{h.hexdigest()[:16]}.so")


_LIB_PATH = _lib_path()

_lib: Optional[ctypes.CDLL] = None


def _try_build() -> None:
    """Compile the source into _LIB_PATH (through a temporary name, so
    concurrent first uses never load a half-written file)."""
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None or not os.path.exists(_SOURCE):
        return
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    try:
        proc = subprocess.run([cxx, *CXXFLAGS, "-o", tmp, _SOURCE],
                              capture_output=True, timeout=300)
        if proc.returncode == 0:
            os.replace(tmp, _LIB_PATH)
    except (OSError, subprocess.TimeoutExpired):
        pass
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH):
        _try_build()
    if not os.path.exists(_LIB_PATH):
        return None
    try:
        lib = ctypes.CDLL(os.path.abspath(_LIB_PATH))
    except OSError:
        return None
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int32)
    lp = ctypes.POINTER(ctypes.c_int64)
    up = ctypes.POINTER(ctypes.c_uint8)
    lib.compose_trs.argtypes = [fp, fp, ctypes.c_int64]
    lib.world_propagate.argtypes = [ip, ctypes.c_int64, ip, fp, fp, fp, up, up]
    lib.transform_aabbs.argtypes = [ip, fp, fp, fp, fp, fp, ctypes.c_int64]
    lib.sample_channels.argtypes = [fp, fp, lp, ip, lp, ip, ip, fp, lp, fp, ctypes.c_int64]
    try:
        lib.mikktspace_tangents.argtypes = [
            fp, fp, fp, ip, ctypes.c_int64, ctypes.c_int64, fp]
    except AttributeError:
        pass  # stale .so from before the symbol existed; callers fall back
    try:
        lib.pack_texture_mips.argtypes = [
            fp, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_uint16)]
        lib.u8_to_f32_rgba.argtypes = [
            up, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int32, fp]
    except AttributeError:
        pass
    _lib = lib
    return lib


def _fp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _ip(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _lp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _up(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


HAVE_NATIVE = _load() is not None


def compose_trs(trs: np.ndarray) -> np.ndarray:
    """(n, 10) [t3 q4 s3] -> (n, 4, 4) row-major world-of-local matrices."""
    trs = np.ascontiguousarray(trs, dtype=np.float32)
    n = trs.shape[0]
    out = np.empty((n, 4, 4), dtype=np.float32)
    lib = _load()
    if lib is not None and n:
        lib.compose_trs(_fp(trs), _fp(out), n)
        return out
    # numpy fallback
    from . import math3d as m3

    for i in range(n):
        out[i] = m3.trs_to_mat4(trs[i, 0:3], trs[i, 3:7], trs[i, 7:10])
    return out


def world_propagate(order: np.ndarray, parent: np.ndarray, local: np.ndarray,
                    world: np.ndarray, normal: np.ndarray,
                    dirty: np.ndarray) -> np.ndarray:
    """Topo-ordered scene-graph propagation; mutates world/normal in place.

    Returns the `changed` mask (cap,) u8."""
    changed = np.zeros(parent.shape[0], dtype=np.uint8)
    lib = _load()
    order = np.ascontiguousarray(order, dtype=np.int32)
    parent = np.ascontiguousarray(parent, dtype=np.int32)
    dirty = np.ascontiguousarray(dirty, dtype=np.uint8)
    assert local.flags.c_contiguous and world.flags.c_contiguous and normal.flags.c_contiguous
    if lib is not None:
        lib.world_propagate(
            _ip(order), len(order), _ip(parent), _fp(local), _fp(world),
            _fp(normal), _up(dirty), _up(changed),
        )
        return changed
    # numpy fallback
    from . import math3d as m3

    lw = local.reshape(-1, 4, 4)
    ww = world.reshape(-1, 4, 4)
    nn = normal.reshape(-1, 3, 3)
    for row in order:
        par = parent[row]
        ch = dirty[row] | (changed[par] if par >= 0 else 0)
        changed[row] = ch
        if not ch:
            continue
        ww[row] = ww[par] @ lw[row] if par >= 0 else lw[row]
        nn[row] = m3.normal_matrix(ww[row])
    return changed


def sample_channels(times, values, t_off, t_len, v_off, dim, mode, t, out_off,
                    out: np.ndarray) -> bool:
    """Batched keyframe sampling (LINEAR/STEP/SLERP). Returns False when the
    native library is unavailable (caller falls back to python samplers)."""
    lib = _load()
    if lib is None:
        return False
    n = len(t_len)
    if n == 0:
        return True
    lib.sample_channels(
        _fp(times), _fp(values), _lp(t_off),
        _ip(t_len), _lp(v_off), _ip(dim), _ip(mode), _fp(t),
        _lp(out_off), _fp(out), n,
    )
    return True


def mikktspace_tangents(pos: np.ndarray, nrm: np.ndarray, uv: np.ndarray,
                        indices: np.ndarray):
    """MikkTSpace-convention per-vertex tangents (xyz + handedness w),
    reference-collapsed (gltf/buffers/tangents.rs finalize_tangents).
    Returns None when the native library (or symbol) is unavailable —
    the caller falls back to Lengyel accumulation."""
    lib = _load()
    if lib is None or not hasattr(lib, "mikktspace_tangents"):
        return None
    pos = np.ascontiguousarray(pos, dtype=np.float32)
    nrm = np.ascontiguousarray(nrm, dtype=np.float32)
    uv = np.ascontiguousarray(uv[..., :2], dtype=np.float32)
    idx = np.ascontiguousarray(indices.reshape(-1, 3), dtype=np.int32)
    n_verts = pos.shape[0]
    out = np.empty((n_verts, 4), dtype=np.float32)
    lib.mikktspace_tangents(_fp(pos), _fp(nrm), _fp(uv), _ip(idx),
                            idx.shape[0], n_verts, _fp(out))
    return out


def u8_to_f32_rgba(img: np.ndarray, srgb: bool):
    """uint8 (h, w[, c]) image -> (h, w, 4) f32 RGBA with an exact
    256-entry sRGB EOTF LUT (bit-identical to srgb_to_linear on byte
    inputs). Returns None when unavailable (caller runs the numpy
    chain)."""
    lib = _load()
    if lib is None or not hasattr(lib, "u8_to_f32_rgba"):
        return None
    if img.ndim == 2:
        img = img[..., None]
    c = img.shape[2]
    if c not in (1, 3, 4):
        return None
    img = np.ascontiguousarray(img, dtype=np.uint8)
    out = np.empty((img.shape[0], img.shape[1], 4), dtype=np.float32)
    lib.u8_to_f32_rgba(_up(img), img.shape[0], img.shape[1], c,
                       int(srgb), _fp(out))
    return out


def pack_texture_mips(img: np.ndarray, kind: int, wrap_s: int, wrap_t: int,
                      n_levels: int, out_u16: np.ndarray) -> bool:
    """Full mip chain + 128-B texel-row packing in one native pass
    (core/textures.py add_image hot path — the numpy packer measured
    ~60 s for a DamagedHelmet-class texture set). `out_u16` is the
    (total_texels, 64) uint16 VIEW of the destination bf16 rows, written
    in place. Returns False when the native library (or symbol) is
    unavailable or a level transition is not an integer area ratio
    (caller falls back to the numpy chain)."""
    lib = _load()
    if lib is None or not hasattr(lib, "pack_texture_mips"):
        return False
    h, w = img.shape[:2]
    ph, pw = h, w
    for _ in range(1, n_levels):
        nh, nw = max(1, ph // 2), max(1, pw // 2)
        if ph % nh or pw % nw:
            return False
        ph, pw = nh, nw
    img = np.ascontiguousarray(img, dtype=np.float32)
    assert out_u16.dtype == np.uint16 and out_u16.flags.c_contiguous
    lib.pack_texture_mips(
        _fp(img), h, w, kind, wrap_s, wrap_t, n_levels,
        out_u16.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)))
    return True


def transform_aabbs(rows: np.ndarray, world: np.ndarray,
                    mins: np.ndarray, maxs: np.ndarray):
    """Batch world-space AABBs: center/extent method. Returns (omin, omax)."""
    rows = np.ascontiguousarray(rows, dtype=np.int32)
    mins = np.ascontiguousarray(mins, dtype=np.float32)
    maxs = np.ascontiguousarray(maxs, dtype=np.float32)
    n = rows.shape[0]
    omin = np.empty((n, 3), dtype=np.float32)
    omax = np.empty((n, 3), dtype=np.float32)
    lib = _load()
    if lib is not None and n:
        lib.transform_aabbs(_ip(rows), _fp(world), _fp(mins), _fp(maxs),
                            _fp(omin), _fp(omax), n)
        return omin, omax
    # numpy fallback (vectorized center/extent)
    m = world.reshape(-1, 4, 4)[rows]
    c = (mins + maxs) * 0.5
    e = (maxs - mins) * 0.5
    wc = np.einsum("nij,nj->ni", m[:, :3, :3], c) + m[:, :3, 3]
    we = np.einsum("nij,nj->ni", np.abs(m[:, :3, :3]), e)
    return (wc - we).astype(np.float32), (wc + we).astype(np.float32)
