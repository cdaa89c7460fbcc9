"""The yardstick for the hand-written kernels: one H100's published peaks
and the least bytes each kernel role must move for a frame of the
configuration's sizes.

A role counts the work a frame's sizes compel, whatever kernel does it
today: each input byte read once, each output byte written once, nothing
read from the program's intermediates. Every count is a lower bound on
what any implementation moves, so the share of the bound in the kernels'
measured time cannot pass 100%; a fused or renamed kernel leaves the
count standing. Operations are not counted (a kernel's tests depend on
the data), so every bound is the byte bound.
"""

from __future__ import annotations

import re

# One H100 SXM (NVIDIA's data sheet, at the 700 W limit): HBM bandwidth
# and float32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# the kernels of each role, by the name their CUDA function has in a
# device trace
ROLES = {
    # K1 and K9 with the two plan kernels of their tile walk
    "visibility raster": ("raster16_kernel", "raster_msaa_kernel",
                          "plan_count_kernel", "plan_scan_kernel"),
    "resolve": ("resolve_kernel",),
    "relayout": ("onehot_split_rows_kernel", "gather_split_kernel",
                 "gather_split_f32_kernel"),
    "texture taps": ("tap_plan_kernel", "filter_taps_kernel"),
    "overlay raster": ("binned_kernel",),
}

# a screen triangle: three corners' x, y, z (f32)
TRI_BYTES = 36
# the material parameters shading reads a pixel: base colour 4, metallic,
# roughness, emissive 3, occlusion strength, normal scale (f32)
MAT_BYTES = 44
# environment colours a pixel: irradiance and prefiltered rgb (f32)
ENV_BYTES = 24
# a texture tap in: u, v, four screen gradients, texture id; out: rgba
TAP_BYTES = 44
# attributes a pixel's shading reads: uv 2, normal 3, material id 1,
# plus the tangent 4 when a normal map is bound (f32)
ATTR_FLOATS = 6
TANGENT_FLOATS = 4


def bound_s(nbytes: float, nops: float = 0.0) -> float:
    """The least seconds the card could take."""
    return max(nbytes / HBM_BYTES_PER_S, nops / F32_OPS_PER_S)


def role_bytes(sizes: dict) -> dict:
    """Least bytes a frame moves in each role. sizes: pixels, samples (a
    pixel), tri_opaque, tri_transparent, slots (texture slots bound in
    the opaque bucket), normal_map (bool), transparent (bool)."""
    P = sizes["pixels"]
    attrs = ATTR_FLOATS + (TANGENT_FLOATS if sizes["normal_map"] else 0)
    out = {
        # corners in; a winner id a sample and a depth a pixel out
        "visibility raster": TRI_BYTES * sizes["tri_opaque"]
        + 4 * P * sizes["samples"] + 4 * P,
        # a winner id in, the shading attributes out, a pixel
        "resolve": 4 * P + 4 * attrs * P,
        # a material id in, its parameters out; the environment colours
        "relayout": P * (4 + MAT_BYTES + ENV_BYTES),
        "texture taps": TAP_BYTES * P * sizes["slots"],
    }
    if sizes["transparent"]:
        # corners in; one layer's winner id a pixel out
        out["overlay raster"] = (TRI_BYTES * sizes["tri_transparent"]
                                 + 4 * P)
    return out


def kernel_role(name: str):
    """The role of a device kernel by its trace name (the CUDA function,
    with any return type, namespace, template arguments and parameters
    around it), or None."""
    for role, kernels in ROLES.items():
        for k in kernels:
            if re.search(r"(?:^|[\s:])" + k + r"\s*[<(]", name):
                return role
    return None
