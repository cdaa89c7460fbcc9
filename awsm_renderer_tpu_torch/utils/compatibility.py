"""Device capability check.

Port of awsm_renderer_tpu/utils/compatibility.py (reference:
renderer-core/src/compatibility.rs, CompatibilityRequirements against the
device limits). The port's analog checks that the scene's device tensors
and the framebuffers fit the card's memory with headroom: device_kind is
the CUDA device's name and hbm_bytes its total memory; on a CPU renderer
they are "cpu" and the host's physical memory.
"""

from __future__ import annotations

import os
from dataclasses import dataclass


@dataclass
class CompatibilityReport:
    device_kind: str
    hbm_bytes: int
    scene_bytes: int
    framebuffer_bytes: int
    ok: bool
    detail: str = ""


def scene_tensor_bytes(ds) -> int:
    """Bytes of every tensor in a (nested) device dict."""
    import torch

    if isinstance(ds, dict):
        return sum(scene_tensor_bytes(v) for v in ds.values())
    if isinstance(ds, torch.Tensor):
        return ds.numel() * ds.element_size()
    return 0


def check_compatibility(renderer) -> CompatibilityReport:
    """scene_bytes counts what the port uploads: every tensor of the
    device dict after a flush of the dirty stores (the flush the next
    frame would run). That differs from the reference's count, which sums
    the capacity-padded host pools and counts the environment maps as
    quad-packed f32 (the port uploads the live triangles only, and an
    image environment as bf16 rows of the texel pool; a solid one stays
    on the host)."""
    import torch

    dev = renderer.device
    if dev.type == "cuda":
        idx = dev.index if dev.index is not None else \
            torch.cuda.current_device()
        kind = torch.cuda.get_device_name(idx)
        mem = torch.cuda.get_device_properties(idx).total_memory
    else:
        kind = "cpu"
        mem = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    scene = scene_tensor_bytes(renderer._flush())

    cfg = renderer.config
    n_planes = 22
    fb = cfg.render_width * cfg.render_height * 4 * (n_planes + 8)

    ok = scene + fb < mem * 0.8
    return CompatibilityReport(
        device_kind=kind, hbm_bytes=int(mem), scene_bytes=int(scene),
        framebuffer_bytes=int(fb), ok=ok,
        detail="" if ok else "scene + framebuffers exceed 80% of device memory",
    )
