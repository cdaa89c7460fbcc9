"""K15 (csrc/vertex.cu awsm_vertex_stage) on the CPU: its plain twin
(ops/vertex.py vertex_stage_reference, which vertex_stage takes on a CPU
tensor) on K15's inputs against the op-by-op chain (vertex_stage_chain)
that the frame ran before K15, and the routing.

A synthetic pool of 320 triangles over seven meshes: plain, double-sided,
morphed, skinned, morphed and skinned, masked out of the pass, and one
whose transform row lies outside the table; 8% dead triangles; random
corners in front of the camera, with planted ones wholly behind the near
plane, with one or two corners behind it, zero-area slivers, back faces
of single- and double-sided meshes, and joint indices outside the joint
table. On it the twin is bit-equal to the chain, NaN for NaN, on the
plain and clipped stage, with the raster's padding written by the stage,
on a compacted pool read through an index (the overlay's), with
instanced groups tiled after the pool, and with a band shift after the
stage. Where the stage takes a morph or skin sum (the animated-subset
split with morph only, skin only and both), the twin is bit-equal to the
chain with the sums in K15's order (target by target, influence by
influence; the split's rows written at their pool rows), and within the
tolerance of tests/test_torch_vertex.py of the chain's torch.sum over
the bucket: validity and every integer-valued column equal, every other
column within 3e-5 of max(|value|, 1), the z-plane within 1e-4 /
min(2*area in px^2, 1). It holds because the two orders differ only in
the rounding of a sum of at most 64 (morph) or 8 (skin) products, a few
ulps of a corner's position, normal and tangent; the setup rows carry
those ulps through the products and differences that the FMA-free port
and XLA's FMAs already differ by, which is what that tolerance covers.
The kernel's constants and its parameter block are held to the Python
side here too; the kernel runs only on the card (tests/test_torch_cuda.py).
"""

import ctypes
import os
import re

import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (torch's thread share under xdist)

from awsm_renderer_tpu_torch.core import meshes as MS
from awsm_renderer_tpu_torch.ops import kernels
from awsm_renderer_tpu_torch.ops import vertex as V
from awsm_renderer_tpu_torch.ops.raster import CHUNK, pad_setup_rows
from awsm_renderer_tpu_torch.passes import frame as TF
from awsm_renderer_tpu_torch.utils import math3d as m3

F = np.float32
W, H = 96, 72
N_TRI, N_JOINTS, SETS = 320, 6, 2          # the pool's skin bucket: 2 sets
NAMES = TF._CORNER_NAMES


def _affine(rng, scale=0.3):
    m = np.eye(4, dtype=F)
    m[:3, :3] += rng.uniform(-scale, scale, (3, 3)).astype(F)
    m[:3, 3] = rng.uniform(-0.5, 0.5, 3)
    return m


def _ds(seed: int, inst: bool = False):
    """A flushed-scene-like device dict on the CPU."""
    rng = np.random.default_rng(seed)
    T = N_TRI
    # meshes: 0 plain, 1 double-sided, 2 morph, 3 skin, 4 morph + skin,
    # 5 masked out, 6 transform row outside the table
    n_vert, n_targets = 40, (0, 0, 5, 0, 7, 0, 0)
    info = np.zeros((7, 8), np.int32)
    info[:, MS.MI_TRANSFORM_ROW] = [0, 1, 2, 3, 1, 2, 9]
    info[:, MS.MI_MATERIAL_ROW] = np.arange(7) * 3 + 1
    info[1, MS.MI_FLAGS] = MS.MESH_FLAG_DOUBLE_SIDED
    info[:, MS.MI_N_MORPH_TARGETS] = n_targets
    info[:, MS.MI_MORPH_STRIDE] = n_vert
    info[[3, 4], MS.MI_SKIN_SETS] = [1, SETS]
    mask = torch.tensor([True] * 5 + [False, True])
    tri = rng.integers(0, 7, T).astype(np.int32)
    tri[rng.random(T) < 0.08] = -1
    world = np.stack([np.eye(4, dtype=F)] + [_affine(rng)
                                             for _ in range(3)])
    nmat = np.stack([np.linalg.inv(w[:3, :3]).T for w in world]).astype(F)
    pos = rng.uniform(-1.2, 1.2, (T, 3, 3)).astype(F)
    # planted: all three corners behind the eye (z = 4.5, camera at z =
    # 4), two behind, one behind, a sliver, a point, a back face of a
    # single-sided and of a double-sided mesh
    tri[:8] = [0, 0, 0, 0, 0, 0, 1, 4]
    pos[0] = [[0, 0, 4.5], [0.5, 0, 4.6], [0, 0.5, 4.7]]
    pos[1] = [[0, 0, 0], [0, 0.5, 4.7], [0.5, 0, 4.6]]
    pos[2] = [[0, 0, 0], [0.5, 0, 0.2], [0, 0.5, 4.7]]
    pos[3] = [[0, 0, 0], [0.5, 0.5, 0], [1.0, 1.0, 0]]
    pos[4] = [[0.2, 0.1, 0]] * 3
    pos[5] = [[0, 0, 0], [0, 0.5, 0], [0.5, 0, 0]]
    pos[6] = pos[5]
    pos[7] = [[0, 0, 3.9], [0.5, 0, 4.3], [0, 0.5, -0.5]]

    def cm(a):          # (T, 3, C) -> component-major (3C, T)
        return torch.as_tensor(np.ascontiguousarray(
            a.transpose(1, 2, 0).reshape(-1, T)))

    nrm = rng.normal(size=(T, 3, 3)).astype(F)
    tan = np.concatenate([rng.normal(size=(T, 3, 3)),
                          rng.choice([-1.0, 1.0], (T, 3, 1))], 2).astype(F)
    joints = rng.integers(-1, N_JOINTS + 1, (T, 3, 4 * SETS)).astype(np.int32)
    weights = rng.uniform(0, 1, (T, 3, 4 * SETS)).astype(F)
    weights /= weights.sum(-1, keepdims=True)
    base = rng.integers(0, n_vert, (T, 3)).astype(np.int32)
    base[~np.isin(tri, [2, 4])] = -1
    base[rng.random((T, 3)) < 0.05] = -1
    jm = np.stack([_affine(rng, 0.1) for _ in range(N_JOINTS)])
    ds = {
        "c_pos": cm(pos), "c_norm": cm(nrm), "c_tang": cm(tan),
        "c_uv0": cm(rng.uniform(0, 1, (T, 3, 2)).astype(F)),
        "c_uv1": cm(rng.uniform(0, 1, (T, 3, 2)).astype(F)),
        "c_color": cm(rng.uniform(0, 1, (T, 3, 4)).astype(F)),
        "c_joints": cm(joints), "c_weights": cm(weights),
        "c_morph_base": torch.as_tensor(np.ascontiguousarray(base.T)),
        "tri_mesh": torch.as_tensor(tri),
        "mesh_info": torch.as_tensor(info),
        "morph_deltas": torch.as_tensor(rng.uniform(
            -0.08, 0.08, (n_vert * 8, 10)).astype(F)),
        "morph_weights": torch.as_tensor(rng.uniform(
            0, 1, (7, 8)).astype(F)),
        "world": torch.as_tensor(world), "normal_mat": torch.as_tensor(nmat),
        "joint_matrices": torch.as_tensor(jm),
        "camera": {"view_proj": m3.perspective(np.pi / 3, W / H, 0.1, 50.0)
                   @ m3.look_at([0.3, 0.4, 4.0], [0, 0, 0], [0, 1, 0])},
    }
    anim = np.nonzero(np.isin(tri, [2, 3, 4]))[0].astype(np.int32)
    padded = np.full(256, -1, np.int32)
    padded[:anim.size] = anim
    ds["anim_tri_idx"], ds["anim_tri_n"] = torch.as_tensor(padded), anim.size
    if inst:
        # one instanced group: 24 triangles of its own, three instances
        # (mesh rows 0, 1 and the masked 5), 3 of its triangles dead
        sub = _ds(seed + 1)[0]
        tp = 24
        for n in NAMES:
            ds[f"inst0_{n}"] = sub[n][:, :tp].contiguous()
        live = torch.ones(tp, dtype=torch.bool)
        live[[2, 9, 17]] = False
        ds["inst0_rows"] = torch.tensor([0, 1, 5], dtype=torch.int32)
        ds["inst0_live"] = live
    return ds, mask


def _tables(ds):
    return (ds["mesh_info"], ds["morph_weights"], ds["world"],
            ds["normal_mat"], ds["joint_matrices"], ds["camera"]["view_proj"])


def _chain(ds, geo, tri, mask, orig_ids=None, **kw):
    mi, mw, wo, nm, jm, vp = _tables(ds)
    return V.vertex_stage_chain(
        *(geo[n] for n in NAMES), ds["morph_deltas"], tri, mi, mw, wo, nm,
        jm, vp, mask, orig_ids, width=W, height=H, **kw)


def _chain_run_vertex(ds, mask, *, needs_clip, has_morphs=False,
                      skin_sets=0, ordered=False):
    """passes/frame.py _run_vertex as it ran before K15: the chain over
    the combined pool, then over the gathered animated subset, its live
    rows copied over the pool's."""
    geo, tri = TF._combined_geometry(ds)
    kw = dict(needs_clip=needs_clip, ordered=ordered)
    anim = ds.get("anim_tri_idx") if (has_morphs or skin_sets) else None
    if anim is None:
        return _chain(ds, geo, tri, mask, has_morphs=has_morphs,
                      skin_sets=skin_sets, **kw)
    rows = _chain(ds, geo, tri, mask, **kw)
    safe = anim.clamp(min=0).long()
    a_tri = torch.where(anim >= 0, tri[safe], torch.full_like(anim, -1))
    rows_a = _chain(ds, {n: g[:, safe] for n, g in geo.items()}, a_tri,
                    mask, anim, has_morphs=has_morphs, skin_sets=skin_sets,
                    **kw)
    n, cap, T = ds["anim_tri_n"], anim.shape[0], tri.shape[0]
    rows.index_copy_(0, safe[:n], rows_a[:n])
    if needs_clip:
        rows.index_copy_(0, safe[:n] + T, rows_a[cap:cap + n])
    return rows


def _same(a, b, what):
    """Bit-equal, NaN for NaN."""
    assert a.shape == b.shape and a.dtype == b.dtype, what
    bad = ~((a == b) | (torch.isnan(a) & torch.isnan(b)))
    assert not bool(bad.any()), (
        f"{what}: {int(bad.sum())} of {a.numel()} differ, max "
        f"{float((a - b).abs()[bad].max())}")


def _close(a, b, what):
    """tests/test_torch_vertex.py's tolerance (the module docstring)."""
    assert a.shape == b.shape, what
    va, vb = a[:, V.S_BB_MINX] < 1e37, b[:, V.S_BB_MINX] < 1e37
    assert torch.equal(va, vb), what
    ints = [V.S_MAT_ROW, V.S_TANGENT_W, V.S_ORIG_ID]
    _same(a[:, ints], b[:, ints], what)
    a, b = a[vb].double(), b[vb].double()
    err = (a - b).abs() / b.abs().clamp(min=1.0)
    z = torch.zeros(V.NSETUP, dtype=torch.bool)
    z[V.S_ZA:V.S_ZC + 1] = True
    assert float(err[:, ~z].max()) <= 3e-5, what
    area = (b[:, 2] + b[:, 5] + b[:, 8]).abs().clamp(max=1.0)
    assert float((err[:, z].max(dim=1).values * area).max()) <= 1e-4, what


@pytest.fixture(scope="module")
def scenes():
    return {"pool": _ds(5), "inst": _ds(11, inst=True)}


@pytest.mark.parametrize("needs_clip", [False, True], ids=["plain", "clip"])
@pytest.mark.parametrize("pad", [False, True], ids=["rows", "padded"])
def test_twin_equals_chain(scenes, needs_clip, pad):
    """The whole pool: every row bit-equal; padded, the tail is
    pad_setup_rows'. The planted triangles land where they should."""
    ds, mask = scenes["pool"]
    twin = TF._run_vertex(ds, mask, rw=W, rh_full=H, needs_clip=needs_clip,
                          pad=pad)
    chain = _chain_run_vertex(ds, mask, needs_clip=needs_clip)
    _same(twin, pad_setup_rows(chain) if pad else chain, "rows")
    T = N_TRI
    assert twin.shape[0] == ((-(-2 * T // CHUNK) * CHUNK if needs_clip
                              else -(-T // CHUNK) * CHUNK) if pad
                             else 2 * T if needs_clip else T)
    valid = twin[:, V.S_BB_MINX] < 1e37
    assert 50 < int(valid.sum()) < T
    dead = torch.nonzero((ds["tri_mesh"] < 0)
                         | ~mask[ds["tri_mesh"].clamp(min=0)
                                 .long()]).flatten()
    assert not bool(valid[dead].any())
    assert not bool(valid[[4, 5]].any())        # a point, a back face
    assert bool(valid[6])                       # double-sided back face
    if needs_clip:
        assert not bool(valid[0]) and not bool(valid[T])   # wholly behind
        assert bool(valid[1]) and not bool(valid[T + 1])   # two behind
        assert bool(valid[2]) and bool(valid[T + 2])       # one behind
        assert torch.equal(twin[T:2 * T, V.S_ORIG_ID],
                           torch.arange(T, 2 * T, dtype=torch.float32))


@pytest.mark.parametrize("needs_clip", [False, True], ids=["plain", "clip"])
def test_compacted_pool_equals_chain(scenes, needs_clip):
    """The overlay's compacted pool read through an index (pads -1 read
    column 0 as dead triangles), padded, against the chain over the
    gathered columns with the index as orig_ids."""
    ds, mask = scenes["pool"]
    idx = torch.full((128,), -1, dtype=torch.int32)
    pick = torch.tensor([1, 2, 5, 6, 7] + list(range(9, 300, 3)),
                        dtype=torch.int32)
    idx[:pick.numel()] = pick
    twin = TF._run_vertex_compact(ds, mask, idx, rw=W, rh_full=H,
                                  needs_clip=needs_clip)
    safe = idx.clamp(min=0).long()
    tri = torch.where(idx >= 0, ds["tri_mesh"][safe],
                      torch.full_like(idx, -1))
    chain = _chain(ds, {n: ds[n][:, safe] for n in NAMES}, tri, mask, idx,
                   needs_clip=needs_clip)
    _same(twin, pad_setup_rows(chain), "rows")
    assert torch.equal(twin[:128, V.S_ORIG_ID], idx.float())


@pytest.mark.parametrize("needs_clip", [False, True], ids=["plain", "clip"])
def test_instanced_groups_and_band_shift(scenes, needs_clip):
    """Instanced groups tiled after the pool, then a row band's shift
    (with its empty bboxes) and a column tile's shift of the padded rows:
    bit-equal to the chain's rows shifted, then padded."""
    ds, mask = scenes["inst"]
    twin = TF._run_vertex(ds, mask, rw=W, rh_full=H, needs_clip=needs_clip,
                          row_offset=24, shift_rows=True, col_offset=32,
                          shift_cols=True, band=(24, 32), pad=True)
    chain = _chain_run_vertex(ds, mask, needs_clip=needs_clip)
    chain = TF._shift_cols_band(TF._shift_rows_band(chain, 24, 24), 32, 32)
    _same(twin, pad_setup_rows(chain), "rows")
    assert TF._total_triangles(ds) == N_TRI + 3 * 24


ANIM = {"morph": dict(has_morphs=True), "skin": dict(skin_sets=SETS),
        "skin1": dict(skin_sets=1),
        "both": dict(has_morphs=True, skin_sets=SETS)}


@pytest.mark.parametrize("needs_clip", [False, True], ids=["plain", "clip"])
@pytest.mark.parametrize("anim", list(ANIM))
def test_animated_split_equals_chain(scenes, anim, needs_clip):
    """The animated-subset split: the subset's rows written at their pool
    rows (T + row for the secondaries) by the second launch, bit-equal to
    the chain with K15's sum order and within the stated tolerance of
    the chain's torch.sum; every unanimated row bit-equal to both. The
    pads are never written."""
    ds, mask = scenes["pool"]
    kw = dict(needs_clip=needs_clip, **ANIM[anim])
    twin = TF._run_vertex(ds, mask, rw=W, rh_full=H, **kw)
    _same(twin, _chain_run_vertex(ds, mask, ordered=True, **kw), "ordered")
    chain = _chain_run_vertex(ds, mask, **kw)
    _close(twin, chain, "torch.sum")
    anim_rows = ds["anim_tri_idx"][:ds["anim_tri_n"]].long()
    if needs_clip:
        anim_rows = torch.cat([anim_rows, anim_rows + N_TRI])
    still = torch.ones(twin.shape[0], dtype=torch.bool)
    still[anim_rows] = False
    _same(twin[still], chain[still], "unanimated rows")
    plain = _chain_run_vertex(ds, mask, needs_clip=needs_clip)
    assert not torch.equal(twin[anim_rows], plain[anim_rows])
    if needs_clip:
        sec = anim_rows[anim_rows >= N_TRI]
        assert torch.equal(twin[sec, V.S_ORIG_ID], (sec - N_TRI).float())


def test_morph_and_skin_orders_agree():
    """_morph and _skin in K15's order against torch.sum over the bucket:
    within the bound of a sum of n <= 8 products in two orders, 2 (n -
    1) ulps of the sum of |products| (plus an ulp of the corner the sum
    is added to); morph moves exactly the corners of the morphed meshes
    that have a delta row."""
    ds, _mask = _ds(5)
    tri = ds["tri_mesh"]
    mesh = tri.clamp(0, 6)
    minfo = V.onehot_gather(mesh, ds["mesh_info"].float())
    out = []
    for ordered in (False, True):
        pos = V._corner_comps(ds["c_pos"], 3)
        nrm = V._corner_comps(ds["c_norm"], 3)
        tan = V._corner_comps(ds["c_tang"], 4)
        V._morph(pos, nrm, tan, ds["c_morph_base"], ds["morph_deltas"],
                 ds["morph_weights"], minfo, mesh, ordered)
        skin = V._skin(ds["c_joints"], ds["c_weights"],
                       ds["joint_matrices"], SETS, ordered)
        out.append((torch.stack([torch.stack(p) for p in pos]), skin))
    eps = float(np.finfo(F).eps)
    (p0, s0), (p1, s1) = out
    assert float((p0 - p1).abs().max()) <= 2 * 7 * eps * (0.08 * 7 + 4.7)
    assert float((s0 - s1).abs().max()) <= 2 * 7 * eps * 2.0
    moved = (p1 != ds["c_pos"].reshape(3, 3, -1)).any(dim=(0, 1))
    assert torch.equal(moved, (ds["c_morph_base"] >= 0).any(dim=0)
                       & torch.isin(tri, torch.tensor([2, 4])))


def test_cpu_call_launches_nothing(scenes):
    ds, mask = scenes["pool"]
    kernels.reset_launch_counts()
    TF._run_vertex(ds, mask, rw=W, rh_full=H, needs_clip=True,
                   has_morphs=True, skin_sets=SETS, pad=True)
    assert all(n == 0 for n in kernels.launch_counts.values())


def _cu():
    with open(os.path.join(kernels.CSRC, "vertex.cu")) as f:
        return f.read()


def test_kernel_constants_match_the_tables():
    """csrc/vertex.cu's setup columns, corner channels and mesh-table
    constants equal ops/vertex.py's and core/meshes.py's; its float
    constants are the chain's, rounded to f32."""
    consts = {m.group(1): int(m.group(2)) for m in re.finditer(
        r"constexpr int (\w+) = (-?\d+);", _cu())}
    consts.pop("BLOCK")
    assert {k for k in consts if k.startswith("S_")} >= {
        "S_E0A", "S_ZA", "S_IW0", "S_BB_MINX", "S_MAT_ROW", "S_TANGENT_W",
        "S_UV0", "S_ORIG_ID"}
    for name, v in consts.items():
        mod = next(m for m in (V, MS) if hasattr(m, name))
        assert getattr(mod, name) == v, name
    floats = dict(re.findall(r"constexpr float (\w+) = \(float\)([\d.e+-]+);",
                             _cu()))
    assert float(floats["Z_EPS"]) == V._Z_EPS
    assert float(floats["BIG"]) == V._BIG
    # the row's attribute blocks follow S_UV0 in finish_setup's order
    assert (V.S_UV1, V.S_COLOR, V.S_NORMAL, V.S_TANGENT) == (
        V.S_UV0 + 6, V.S_UV0 + 12, V.S_UV0 + 24, V.S_UV0 + 33)


def test_param_block_matches_the_kernel():
    """ops/vertex.py _VertexParams mirrors csrc/vertex.cu's VertexParams
    field for field (a pointer is c_void_p, int64_t c_int64)."""
    body = re.search(r"struct VertexParams \{(.*?)\n\};", _cu(), re.S)
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
    got = V._VertexParams._fields_
    assert [n for n, _ in got] == [n for n, _ in fields]
    for (n, a), (_, b) in zip(got, fields):
        assert ctypes.sizeof(a) == ctypes.sizeof(b), n
        assert getattr(a, "_type_", a) == getattr(b, "_type_", b), n
