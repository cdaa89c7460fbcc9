"""K14 (csrc/shade.cu awsm_shade_surface) on the CPU: its plain twin
(ops/shade.py shade_surface_fused_reference, which a CPU tensor takes in
K14's scope) against the op-by-op chain that K14 replaces on the card
(ops/shade.py shade_surface with _in_k14_scope false), and the routing
between them.

The twin runs the chain's math on K14's inputs: the material tables read
by mat_row, K5's raw tap block, the light table and the texel pool's env
rows. On the same planes the two are bit-equal, NaN for NaN, over the
slot masks (none, base colour, the helmet's five, all seven K14 reads),
random material rows that mix PBR, mask, blend, unlit and editor-grid
materials with and without their textures, 0, 1 and 7 lights (spot and
ranged point included), solid and image environments, the opaque pass
with its sky, the transparent pass with its transmission factor and the
HUD's plain pass, the band geometry (row / column offsets of a larger
frame, stacked layers) and compacted planes with their NDC coordinates,
vertex colours, uv1 and the normals view. Calls outside K14's scope
(each extension flag, a debug view, tiled lights, volume refraction)
take the chain and count `shade/chain`. The kernel's constants and its
parameter block are held to the Python side here too; the kernel itself
runs only on the card (tests/test_torch_cuda.py)."""

import ctypes
import dataclasses
import os
import re

import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (torch's thread share under xdist)

from awsm_renderer_tpu_torch import (
    AwsmRendererTorch, Light, PbrMaterial, RendererConfig, Transform,
)
from awsm_renderer_tpu_torch.core import lights as LT
from awsm_renderer_tpu_torch.core import materials as M
from awsm_renderer_tpu_torch.core import textures as TX
from awsm_renderer_tpu_torch.core.materials import (
    AlphaMode, GridMaterial, TextureRef, UnlitMaterial,
)
from awsm_renderer_tpu_torch.geometry import box, checker_texture
from awsm_renderer_tpu_torch.ops import kernels
from awsm_renderer_tpu_torch.ops import shade as S
from awsm_renderer_tpu_torch.utils import math3d as m3
from awsm_renderer_tpu_torch.utils.profiling import RenderTimings, active

F = np.float32
W, H = 64, 32
HELMET5 = (M.TS_BASE_COLOR, M.TS_METALLIC_ROUGHNESS, M.TS_NORMAL,
           M.TS_OCCLUSION, M.TS_EMISSIVE)
MASKS = {"none": (), "base": (M.TS_BASE_COLOR,), "helmet5": HELMET5,
         "k14": S.K14_SLOTS}


def _mask(slots):
    return tuple(s in slots for s in range(M.NUM_TEX_SLOTS))


def _lights(r, n):
    specs = [
        Light.directional([-0.5, -1.0, -0.3], intensity=2.5),
        Light.spot([0.0, 2.0, 3.0], [0.0, -0.4, -1.0], color=(0.4, 0.7, 1.0),
                   intensity=20.0, range=12.0, inner_cone_angle=0.1,
                   outer_cone_angle=0.35),
        Light.point([1.0, 1.5, 2.0], color=(1.0, 0.6, 0.3), intensity=6.0,
                    range=5.0),
        Light.point([-2.0, -1.0, 1.5], intensity=3.0),
        Light.directional([0.3, -0.2, 1.0], color=(0.2, 0.9, 0.4)),
        Light.spot([-1.0, 1.0, -2.0], [0.2, -0.2, 1.0], intensity=9.0),
        Light.point([0.0, 0.2, 0.5], intensity=0.5, range=0.8),
    ]
    for lt in specs[:n]:
        r.lights.insert(lt)


def _scene(env: str, n_lights: int):
    """A CPU renderer's flushed state: textures for every slot K14 reads,
    a texture transform, materials of every kind and alpha mode."""
    r = AwsmRendererTorch(RendererConfig(width=W, height=H), device="cpu")
    if env == "image":
        eq = np.zeros((16, 32, 3), F)
        v = np.linspace(0, 1, 16)[:, None]
        eq[..., 0] = 0.2 + 0.8 * v
        eq[..., 1] = 0.3 + np.linspace(0, 0.5, 32)[None, :]
        eq[..., 2] = 1.0 - 0.8 * v
        r.environment.set_environment_from_equirect(eq, size=16)
    rng = np.random.default_rng(3)
    color = r.textures.add_image(checker_texture(32, 4), srgb=True)
    data = r.textures.add_image(
        (rng.uniform(0, 255, (16, 16, 4))).astype(np.uint8), srgb=False)
    nrm = np.zeros((16, 16, 4), np.uint8)
    nrm[..., :3] = (rng.normal(0, 0.3, (16, 16, 3)) * 127 + [128, 128, 200]
                    ).clip(0, 255)
    nrm[..., 3] = 255
    normal = r.textures.add_image(nrm, srgb=False)
    tform = r.textures.transform_row_of(r.textures.add_texture_transform(
        offset=(0.1, -0.2), rotation=0.3, scale=(1.5, 0.75)))
    row = r.textures.row_of

    def ref(key, **kw):
        return TextureRef(row(key), **kw)

    mats = [
        PbrMaterial(base_color_factor=np.array([0.8, 0.3, 0.2, 1], F),
                    metallic_factor=0.2, roughness_factor=0.6),
        PbrMaterial(alpha_mode=AlphaMode.MASK, alpha_cutoff=0.45,
                    textures={M.TS_BASE_COLOR: ref(color, uv_set=1)}),
        PbrMaterial(
            alpha_mode=AlphaMode.BLEND, ior=1.45, specular_factor=0.7,
            specular_color=np.array([1.0, 0.8, 0.6], F), normal_scale=0.8,
            occlusion_strength=0.6, emissive_factor=np.array([0.3, 0.1, 0], F),
            emissive_strength=2.0, attenuation_distance=0.5, thickness=0.2,
            attenuation_color=np.array([0.9, 0.5, 0.2], F),
            textures={
                M.TS_BASE_COLOR: ref(color, transform_id=tform),
                M.TS_METALLIC_ROUGHNESS: ref(data),
                M.TS_NORMAL: ref(normal),
                M.TS_OCCLUSION: ref(data),
                M.TS_EMISSIVE: ref(color),
                M.TS_SPECULAR: ref(data),
                M.TS_SPECULAR_COLOR: ref(color, uv_set=1)}),
        UnlitMaterial(base_color_factor=np.array([0.2, 0.9, 0.4, 0.7], F),
                      alpha_mode=AlphaMode.BLEND,
                      textures={M.TS_BASE_COLOR: ref(color)}),
        GridMaterial(spacing=0.5, major_every=4.0, fade_distance=20.0),
        PbrMaterial(metallic_factor=1.0, roughness_factor=0.05,
                    textures={M.TS_NORMAL: ref(normal),
                              M.TS_METALLIC_ROUGHNESS: ref(data)}),
    ]
    keys = [r.materials.insert(m) for m in mats]
    rows = [r.materials.row_of(k) for k in keys]
    r.add_mesh(box(0.5), keys[0], transform=Transform())
    _lights(r, n_lights)
    r.camera.update(m3.look_at([1.5, 1.2, 3.0], [0, 0, 0], [0, 1, 0]),
                    m3.perspective(np.pi / 3, W / H, 0.1, 50.0))
    return r._flush(), rows


def _planes(rows, P, seed, *, color=False, uv1=False, ndc=False,
            derivs=False):
    """G-buffer planes as a raster leaves them: 15% misses with zero
    planes and depth 1, random material rows, normals, tangents, uvs."""
    g = torch.Generator().manual_seed(seed)

    def u(lo, hi, n=P):
        return torch.rand(n, generator=g) * (hi - lo) + lo

    tid = torch.randint(0, 1000, (P,), generator=g, dtype=torch.int32)
    miss = torch.rand(P, generator=g) < 0.15
    tid = torch.where(miss, torch.full_like(tid, -1), tid)
    pick = torch.randint(0, len(rows), (P,), generator=g)
    p = {"tri_id": tid, "depth": torch.where(miss, 1.0, u(0.3, 0.999)),
         "mat_row": torch.tensor(rows, dtype=torch.float32)[pick]}
    names = ["uv0_u", "uv0_v", "normal_x", "normal_y", "normal_z",
             "tangent_x", "tangent_y", "tangent_z"]
    if uv1:
        names += ["uv1_u", "uv1_v"]
    if color:
        names += ["color_r", "color_g", "color_b", "color_a"]
    if derivs:
        names += ["du0_dx", "dv0_dx", "du0_dy", "dv0_dy"]
    for k in names:
        lo, hi = ((-0.05, 0.05) if k.startswith(("du", "dv"))
                  else (0.0, 1.0) if k.startswith("color")
                  else (-1.0, 1.5))
        p[k] = u(lo, hi)
    p["tangent_w"] = torch.where(torch.rand(P, generator=g) < 0.5, -1.0, 1.0)
    for k in names + ["tangent_w", "mat_row"]:
        p[k] = torch.where(miss, 0.0, p[k])
    if ndc:
        p["ndc_x"], p["ndc_y"] = u(-1.0, 1.0), u(-1.0, 1.0)
    return p


PASSES = {"opaque": dict(want_sky=True), "transparent":
          dict(transparent_pass=True), "hud": {}}
GEOMS = {
    "band": dict(width=W, height=H),
    "offsets": dict(width=W, height=H, height_full=3 * H, row_offset=H,
                    width_full=2 * W, col_offset=W),
    "layers": dict(width=W, height=H, n_layer_tiles=2, height_full=H // 2),
    "ndc": dict(width=128, height=W * H // 128, height_full=H),
}
CASES = [(mask, nl, ("solid", "image")[i % 2], list(PASSES)[i % 3],
          list(GEOMS)[i % 4], ())
         for i, (mask, nl) in enumerate(
             (m, n) for m in MASKS for n in (0, 1, 7))]
CASES += [
    ("helmet5", 0, "image", "opaque", "band", ("normals",)),
    ("k14", 7, "solid", "opaque", "offsets", ("normals", "color")),
    ("base", 1, "image", "transparent", "layers", ("color", "uv1")),
    ("k14", 7, "image", "transparent", "ndc", ("uv1", "derivs")),
    ("helmet5", 1, "image", "hud", "band", ("nomips", "color")),
]


def _ids(case):
    mask, nl, env, pas, geom, extra = case
    return "-".join([mask, f"{nl}l", env, pas, geom, *extra])


@pytest.fixture(scope="module")
def scenes():
    return {(env, nl): _scene(env, nl) for env in ("solid", "image")
            for nl in (0, 1, 7)}


def _same(a, b, what):
    """Bit-equal, NaN for NaN."""
    assert a.shape == b.shape and a.dtype == b.dtype, what
    both_nan = torch.isnan(a) & torch.isnan(b)
    bad = ~((a == b) | both_nan)
    assert not bool(bad.any()), (
        f"{what}: {int(bad.sum())} of {a.numel()} differ, max "
        f"{float((a - b).abs()[bad].max())}")


@pytest.mark.parametrize("case", CASES, ids=[_ids(c) for c in CASES])
def test_twin_equals_chain(scenes, monkeypatch, case):
    mask, nl, env, pas, geom, extra = case
    ds, rows = scenes[(env, nl)]
    kw = dict(GEOMS[geom], **PASSES[pas])
    P = kw["width"] * kw["height"]
    planes = _planes(rows, P, seed=len(CASES) + CASES.index(case),
                     color="color" in extra, uv1="uv1" in extra,
                     ndc=geom == "ndc", derivs="derivs" in extra)
    spec = S.ShadeSpec(
        solid_env=env == "solid", slot_mask=_mask(MASKS[mask]),
        use_mips="nomips" not in extra, has_nearest=True, ext=S.NO_EXT,
        debug_mode="normals" if "normals" in extra else "none",
        light_tiles=False)
    twin = S.shade_surface(planes, ds, spec, **kw)
    monkeypatch.setattr(S, "_in_k14_scope", lambda *a: False)
    chain = S.shade_surface(planes, ds, spec, **kw)
    assert len(chain) == len(twin)
    for c in range(3):
        _same(twin[0][c], chain[0][c], f"rgb[{c}]")
    _same(twin[1], chain[1], "alpha")
    assert torch.equal(twin[2], chain[2])
    if kw.get("transparent_pass"):
        for c in range(3):
            _same(twin[3][c], chain[3][c], f"trans[{c}]")
        assert twin[4] is None and chain[4] is None
    # the sky on misses, shading elsewhere: both sides vary
    assert bool(torch.isfinite(twin[0][0][twin[2]]).all())
    assert float(twin[0][0].std()) > 0.0


def _spy(monkeypatch):
    calls = []

    def fused(*a, **kw):
        calls.append(kw)
        return S.shade_surface_fused_reference(*a, **kw)

    monkeypatch.setattr(S, "shade_surface_fused", fused)
    return calls


SPEC_FIELDS = {f.name for f in dataclasses.fields(S.ShadeSpec)}
ROUTES = {
    "none": ({}, True), "normals": (dict(debug_mode="normals"), True),
    **{f"ext{e}": (dict(ext=tuple(i == e for i in range(6))), False)
       for e in range(6)},
    "ibl": (dict(debug_mode="ibl"), False),
    "punctual": (dict(debug_mode="punctual"), False),
    "material": (dict(debug_mode="material"), False),
    "channel": (dict(debug_mode="channel:basecolor"), False),
    "light_tiles": (dict(light_tiles=True), False),
    "volume": (dict(ext=(False,) * 4 + (True, True),
                    transparent_pass=True), False),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_routing(scenes, monkeypatch, route):
    """In K14's scope a call takes shade_surface_fused and counts nothing;
    any other takes the chain and counts shade/chain."""
    ds, rows = scenes[("image", 7)]
    calls = _spy(monkeypatch)
    extra, fused = ROUTES[route]
    planes = _planes(rows, W * H, seed=7)
    t = RenderTimings(enabled=True)
    kw = dict(width=W, height=H, want_sky=True)
    spec = dict(solid_env=False, slot_mask=_mask(HELMET5))
    for k, v in extra.items():
        (spec if k in SPEC_FIELDS else kw)[k] = v
    if kw.get("transparent_pass"):
        kw.pop("want_sky")
    with active(t):
        out = S.shade_surface(planes, ds, S.ShadeSpec(**spec), **kw)
    assert len(calls) == int(fused)
    assert t.counts.get("shade/chain", 0) == int(not fused)
    assert len(out) == (5 if kw.get("transparent_pass") else 3)
    if route == "volume":
        assert out[4] is not None      # the refraction info: the chain's


def test_cpu_takes_the_twin_and_launches_nothing(scenes):
    ds, rows = scenes[("solid", 1)]
    kernels.reset_launch_counts()
    planes = _planes(rows, W * H, seed=9)
    S.shade_surface(planes, ds, S.ShadeSpec(solid_env=True,
                                            slot_mask=_mask(HELMET5)),
                    width=W, height=H, want_sky=True)
    assert all(n == 0 for n in kernels.launch_counts.values())


def _cu():
    with open(os.path.join(kernels.CSRC, "shade.cu")) as f:
        return f.read()


def test_kernel_constants_match_the_tables():
    """csrc/shade.cu's layout constants equal core/materials.py's,
    core/lights.py's and core/textures.py's, and its tapped-slot order
    K14_SLOTS."""
    consts = {m.group(1): int(m.group(2)) for m in re.finditer(
        r"constexpr int (\w+) = (-?\d+);", _cu())}
    assert len(consts) > 30
    for name, v in consts.items():
        mod = next(m for m in (M, LT, TX) if hasattr(m, name))
        assert getattr(mod, name) == v, name
    enum = re.search(r"enum \{([^}]*)\}", _cu()).group(1)
    names = [n.strip() for n in enum.split(",")][:-1]
    slots = {"T_BASE": M.TS_BASE_COLOR, "T_MR": M.TS_METALLIC_ROUGHNESS,
             "T_NORMAL": M.TS_NORMAL, "T_OCCLUSION": M.TS_OCCLUSION,
             "T_EMISSIVE": M.TS_EMISSIVE, "T_SPECULAR": M.TS_SPECULAR,
             "T_SPECULAR_COLOR": M.TS_SPECULAR_COLOR}
    assert [slots[n] for n in names] == list(S.K14_SLOTS)


def test_param_block_matches_the_kernel():
    """ops/shade.py _ShadeParams mirrors csrc/shade.cu's ShadeParams
    field for field (a pointer is c_void_p, int64_t c_int64)."""
    body = re.search(r"struct ShadeParams \{(.*?)\n\};", _cu(), re.S)
    types = {"int": ctypes.c_int, "float": ctypes.c_float,
             "int64_t": ctypes.c_int64}
    fields = []
    for line in body.group(1).strip().splitlines():
        m = re.fullmatch(r"\s*(const )?(\w+)(\*)? (\w+)(\[(\d+)\])?;", line)
        assert m, line
        t = ctypes.c_void_p if m.group(3) else types[m.group(2)]
        if m.group(6):
            t = t * int(m.group(6))
        fields.append((m.group(4), t))
    got = S._ShadeParams._fields_
    assert [n for n, _ in got] == [n for n, _ in fields]
    for (n, a), (_, b) in zip(got, fields):
        assert ctypes.sizeof(a) == ctypes.sizeof(b), n
        assert getattr(a, "_type_", a) == getattr(b, "_type_", b), n
