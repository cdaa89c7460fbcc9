"""Build, load and launch the package's hand-written CUDA kernels.

The sources under ``awsm_renderer_tpu_torch/csrc/`` are compiled at first
use with ``nvcc`` for Hopper (``sm_90a``), one ``nvcc`` per source, all
started together, then linked into one shared library with a plain C
interface, bound through ctypes. The library lands in
``<repo>/build/kernels/`` under a name keyed by a hash of the sources and
flags, so an edit rebuilds and an unchanged tree reuses the last build.
Nothing here runs at import time: the CPU tests import every module, and
a host without CUDA may have no ``nvcc`` at all.

Each kernel wrapper (ops/raster.py, ops/shade.py, ops/relayout.py,
ops/texsample.py, ops/temporal.py) calls
``launch`` exactly where it launches its kernel; ``launch`` raises on a
non-zero ``cudaError_t`` and adds one to ``launch_counts[name]``, which is
how a run shows that the main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Optional

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
SOURCES = ("raster16.cu", "resolve.cu", "relayout.cu", "texsample.cu",
           "binned.cu", "raster_msaa.cu", "temporal.cu", "dense.cu")
# -fmad=false: no FMA contraction anywhere. The edge functions and the
# resolve ALU must round exactly like their plain PyTorch twins (separate
# mul and add kernels); a contracted edge function opens pinholes along
# shared edges. Denormals stay on (no --use_fast_math, no ftz).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: name -> argtypes, the stream last (every one returns
# cudaError_t as int)
_SIGNATURES = {
    "awsm_raster16": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P],
    "awsm_resolve": [_P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    "awsm_onehot_split_rows": [_P, _P, _I, _I, _I, _P, _P],
    "awsm_gather_split_channels": [_P, _I, _I, _P, _I, _I, _P, _P],
    "awsm_gather_split_channels_f32": [_P, _I, _I, _P, _I, _I, _P, _P],
    "awsm_tap_plan": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P, _I, _I,
                      _I, _I, _I, _P, _P, _P],
    "awsm_filter_taps": [_P, _I, _I, _P, _P, _I, _I, _P, _P],
    "awsm_binned": [_P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _P, _P, _I, _I,
                    _P, _P, _P],
    "awsm_raster_msaa": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P,
                         _P],
    "awsm_reproject": [_P, _P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P],
    "awsm_dense": [_P, _I, _P, _I, _I, _P, _P, _I, _P, _P, _P],
    "awsm_split_rows": [_P, _I, _I, _I, _P, _P],
    "awsm_channel_rows": [_P, _I, _I, _I, _P, _P],
}

launch_counts: Dict[str, int] = {
    "rasterize16_slim": 0,
    "resolve_planes_fused": 0,
    "onehot_split_rows": 0,
    "gather_split_channels": 0,
    "tap_plan_fused": 0,
    "filter_taps_fused": 0,
    "gather_split_channels_f32": 0,
    "rasterize_binned": 0,
    "rasterize_binned_compact": 0,
    "rasterize16_msaa": 0,
    "reproject_history": 0,
    "rasterize_dense": 0,
    "rasterize_peel_dense": 0,
    "split_rows": 0,
    "channel_rows": 0,
}

_lib: Optional[ctypes.CDLL] = None
build_log: str = ""


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(CSRC)):
        if name.endswith((".cu", ".cuh")):
            with open(os.path.join(CSRC, name), "rb") as f:
                h.update(name.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"libawsm_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the kernels unless this exact source set is already built:
    one nvcc per source in parallel, then one link. Returns the library
    path; raises with nvcc's output on failure."""
    global build_log
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc, tag = _nvcc(), f"{os.getpid()}.tmp"
    objs = [os.path.join(BUILD_DIR, f"{os.path.splitext(s)[0]}.{tag}.o")
            for s in SOURCES]
    procs = [subprocess.Popen(
        [nvcc, *NVCC_FLAGS, "-c", "-o", obj, os.path.join(CSRC, src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src, obj in zip(SOURCES, objs)]
    logs = [p.communicate()[0] for p in procs]
    build_log = "".join(logs)
    try:
        failed = [s for s, p in zip(SOURCES, procs) if p.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{build_log}")
        tmp = f"{out}.{tag}"
        proc = subprocess.run([nvcc, NVCC_FLAGS[0], NVCC_FLAGS[1], "-shared",
                               "-o", tmp, *objs], capture_output=True,
                              text=True)
        build_log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{build_log}")
        os.replace(tmp, out)
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    return out


def lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(build())
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def check_cuda(*tensors: torch.Tensor) -> None:
    """All tensors on one CUDA device and contiguous."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")


def launch(name: str, entry: str, *args) -> None:
    """Call C entry point `entry` on the current stream; raise on a
    non-zero cudaError_t, then count one launch of kernel `name`."""
    stream = torch.cuda.current_stream().cuda_stream
    rc = getattr(lib(), entry)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{entry} failed: cudaError_t {rc}")
    launch_counts[name] += 1
