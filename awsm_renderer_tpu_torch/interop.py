"""Scene state carried across from the JAX renderer (for parity tests)."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .renderer import _CORNERS, _bf16_tensor

# host-side entries of the port's device dict: uniforms read as Python
# floats, and the packed env maps (constants / row counts)
_HOST = ("skybox", "irradiance", "prefiltered")


def device_scene_from_jax(ds_numpy: Dict[str, object],
                          device="cuda") -> Dict[str, object]:
    """The JAX renderer's flushed `_device` dict, as numpy arrays (bf16 as
    uint16 bit patterns, the camera as a dict of arrays), -> the port's
    device dict on `device` (the card unless the caller asks for the
    CPU), so both implementations can shade identical scene state."""
    device = torch.device(device)
    out: Dict[str, object] = {}
    for name in ("world", "normal_mat", "tri_mesh", "mesh_info",
                 "mat_float", "mat_tex", "mat_flags", "lights",
                 "tex_desc", "tex_transforms", "c_morph_base",
                 "morph_deltas", "morph_weights", "joint_matrices",
                 *[n for n, _ in _CORNERS]):
        out[name] = torch.tensor(np.asarray(ds_numpy[name]), device=device)
    out["lights_host"] = np.asarray(ds_numpy["lights"], np.float32)
    out["n_lights"] = int(np.asarray(ds_numpy["n_lights"]))
    texels = np.asarray(ds_numpy["texels"])
    if texels.dtype != np.uint16:
        raise ValueError("texels must arrive as uint16 bf16 bit patterns")
    out["texels"] = _bf16_tensor(texels, device)
    if "env_pool_base" in ds_numpy:
        out["env_pool_base"] = int(np.asarray(ds_numpy["env_pool_base"]))
    for name in _HOST:
        out[name] = np.asarray(ds_numpy[name], np.float32)
    out["camera"] = {k: np.asarray(v) for k, v in ds_numpy["camera"].items()}
    return out
