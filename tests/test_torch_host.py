"""PyTorch port, host tier: the copied stores, the ml_dtypes-free bf16
texel pool, the device flush (textured scenes included), the no-JAX
import rule and the refusal of content outside the ported slice.

The flushed scene must equal the JAX renderer's `_device` arrays bit for
bit (the port flushes the same host mirrors with the same packers)."""

import os
import subprocess
import sys

import ml_dtypes
import numpy as np
import pytest
import torch

import _torch_port as T

SCENES = ("triangle", "box", "metal-rough-spheres", "env-ibl",
          "box-textured")
# device-dict entries both renderers upload (the JAX side also carries
# the BRDF LUT)
COMPARED = ("world", "normal_mat", "c_pos", "c_norm", "c_tang", "c_uv0",
            "c_uv1", "c_color", "c_joints", "c_weights", "c_morph_base",
            "tri_mesh", "mesh_info", "morph_deltas", "morph_weights",
            "joint_matrices", "mat_float", "mat_tex", "mat_flags", "lights",
            "n_lights", "tex_desc", "tex_transforms", "texels", "skybox",
            "irradiance", "prefiltered")


@pytest.fixture(scope="module")
def flushed():
    """{scene: (JAX _device as numpy, port _flush() as numpy)}; the demo
    scenes, and the glTF helmet (five 1024-texel maps with mip chains)
    under an image environment."""
    from awsm_renderer_tpu import AwsmRendererTpu, RendererConfig
    import awsm_renderer_tpu_torch as P

    out = {}
    for scene in SCENES:
        dj = T.to_numpy(dict(T.jax_renderer(scene)._flush()))
        dt = T.to_numpy(dict(T.torch_renderer(scene)._flush()))
        out[scene] = (dj, dt)
    rj = T.gltf_scene(AwsmRendererTpu(RendererConfig(width=T.W, height=T.H)),
                      "glb-helmet", image_env=True)
    rt = T.gltf_scene(P.AwsmRendererTorch(P.RendererConfig(
        width=T.W, height=T.H), device="cpu"), "glb-helmet", image_env=True)
    out["glb-helmet"] = (T.to_numpy(dict(rj._flush())),
                         T.to_numpy(dict(rt._flush())))
    return out


def test_bf16_bits_match_ml_dtypes():
    from awsm_renderer_tpu_torch.core.textures import f32_to_bf16_bits

    rng = np.random.default_rng(3)
    x = np.concatenate([
        rng.standard_normal(4096).astype(np.float32) * 1e3,
        rng.uniform(0, 1, 4096).astype(np.float32),
        # round-to-nearest-even ties, denormals, limits, specials
        np.array([1.00390625, 1.01171875, -1.00390625, 1e-40, -1e-45,
                  3.0e38, 3.4028235e38, -3.4028235e38, 0.0, -0.0,
                  np.inf, -np.inf, np.nan, -np.nan], np.float32),
    ])
    want = x.astype(ml_dtypes.bfloat16).view(np.uint16)
    got = f32_to_bf16_bits(x)
    nan = np.isnan(x)
    np.testing.assert_array_equal(got[~nan], want[~nan])
    # NaN payloads may differ; both must stay quiet NaNs of the same sign
    back = got[nan].astype(np.uint32) << 16
    assert np.isnan(back.view(np.float32)).all()


@pytest.mark.parametrize("scene", SCENES + ("glb-helmet",))
def test_flushed_scene_bit_equal(flushed, scene):
    dj, dt = flushed[scene]
    for name in COMPARED:
        a, b = np.asarray(dj[name]), np.asarray(dt[name])
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(a.view(np.uint8) if a.ndim else a,
                                      b.view(np.uint8) if b.ndim else b,
                                      err_msg=name)
    assert ("env_pool_base" in dj) == ("env_pool_base" in dt)
    if "env_pool_base" in dj:
        assert int(dj["env_pool_base"]) == int(dt["env_pool_base"])
    for k, v in dj["camera"].items():
        np.testing.assert_array_equal(v, dt["camera"][k], err_msg=k)


@pytest.mark.parametrize("scene", ("box", "env-ibl", "box-textured",
                                   "glb-helmet"))
def test_device_scene_from_jax_matches_port_flush(flushed, scene):
    from awsm_renderer_tpu_torch import device_scene_from_jax

    dj, dt = flushed[scene]
    ds = T.to_numpy(device_scene_from_jax(dj, "cpu"))
    for name in COMPARED:
        np.testing.assert_array_equal(
            np.asarray(ds[name]).view(np.uint8)
            if np.ndim(ds[name]) else ds[name],
            np.asarray(dt[name]).view(np.uint8)
            if np.ndim(dt[name]) else dt[name], err_msg=name)
    np.testing.assert_array_equal(ds["lights_host"], dt["lights_host"])


def _edit_and_flush(r, uv_sphere):
    """Flush, append a mesh (a dirty-range append), flush, remove the
    first mesh (a tombstone), flush; returns the last device dict."""
    r._flush()
    key2 = r.add_mesh(uv_sphere(0.3), next(iter(r.materials._materials)))
    r._flush()
    first = min(k for k, _ in r.meshes.items())
    assert first != key2
    r.meshes.remove(first)
    return r._flush()


def test_flush_range_updates_bit_equal():
    """The port's in-place dirty-range path (append + tombstone) leaves
    the same device pools as the JAX renderer's dynamic_update_slice."""
    from awsm_renderer_tpu.geometry import uv_sphere as jax_sphere
    from awsm_renderer_tpu_torch.geometry import uv_sphere

    dj = T.to_numpy(dict(_edit_and_flush(T.jax_renderer("box"),
                                         jax_sphere)))
    rt = T.torch_renderer("box")
    dt = T.to_numpy(dict(_edit_and_flush(rt, uv_sphere)))
    for name in ("c_pos", "c_norm", "c_uv0", "c_color", "tri_mesh",
                 "mesh_info"):
        np.testing.assert_array_equal(dj[name], dt[name], err_msg=name)
    assert (dt["tri_mesh"] == -1).any()
    np.testing.assert_array_equal(rt._tri_mesh_device_order, dt["tri_mesh"])


def test_native_host_library_path():
    """The port builds its own copy of the host library from
    native/awsm_host.cpp into build/host/ and loads nothing under the JAX
    package; where no compiler exists the stores fall back to numpy."""
    from awsm_renderer_tpu_torch.utils import native

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.path.normpath(native._LIB_PATH)
    assert os.path.dirname(path) == os.path.join(repo, "build", "host")
    assert not path.startswith(os.path.join(repo, "awsm_renderer_tpu") +
                               os.sep)
    assert native._SOURCE == os.path.join(repo, "native", "awsm_host.cpp")
    if os.path.exists(native._LIB_PATH):
        assert native._load() is not None
        assert native.HAVE_NATIVE


def test_import_without_jax_and_cuda_refused():
    """The port imports with jax and ml_dtypes blocked, renders the
    triangle probe and a textured glTF sample on the CPU, and refuses
    device='cuda' on a host without a card."""
    code = r"""
import sys
sys.modules['jax'] = None
sys.modules['ml_dtypes'] = None
import numpy as np
import awsm_renderer_tpu_torch as P
from awsm_renderer_tpu_torch.geometry import triangle
from awsm_renderer_tpu_torch.utils import math3d as m3
assert not any(m.startswith('awsm_renderer_tpu.') or m == 'awsm_renderer_tpu'
               for m in sys.modules if sys.modules[m] is not None)
r = P.AwsmRendererTorch(P.RendererConfig(width=128, height=64), device='cpu')
mat = r.materials.insert(P.UnlitMaterial(
    base_color_factor=np.array([1, 0.4, 0.1, 1], np.float32)))
r.add_mesh(triangle(), mat, transform=P.Transform(
    translation=np.array([-0.5, -0.5, 0], np.float32)))
r.camera.update(m3.look_at([0, 0, 2.2], [0, 0, 0], [0, 1, 0]),
                m3.perspective(np.pi / 3, 2.0, 0.05, 500.0))
img = r.render_u8()
assert img.shape == (64, 128, 4) and (img[..., 3] == 255).sum() > 100
import os, tempfile
from awsm_renderer_tpu_torch.gltf.samples import glb_texture_transform
glb, (eye, center) = glb_texture_transform()
path = os.path.join(tempfile.mkdtemp(), 't.glb')
open(path, 'wb').write(glb)
r = P.AwsmRendererTorch(P.RendererConfig(width=128, height=64), device='cpu')
P.populate_gltf(r, P.load_gltf(path))
r.camera.update(m3.look_at(eye, center, [0, 1, 0]),
                m3.perspective(np.pi / 3, 2.0, 0.05, 100.0))
assert (r.render_u8()[..., 3] == 255).sum() > 100
assert not any(m.startswith('awsm_renderer_tpu.') or m == 'awsm_renderer_tpu'
               for m in sys.modules if sys.modules[m] is not None)
import torch
if not torch.cuda.is_available():
    try:
        P.AwsmRendererTorch(device='cuda')
    except RuntimeError:
        pass
    else:
        raise SystemExit('cuda renderer constructed without a card')
print('ok')
"""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")


def _msaa(r):
    from dataclasses import replace

    r.config = replace(r.config, anti_aliasing=replace(
        r.config.anti_aliasing, msaa=True))


def _bloom(r):
    from dataclasses import replace

    r.config = replace(r.config, post_processing=replace(
        r.config.post_processing, bloom=True))


def _transparent(r):
    import awsm_renderer_tpu_torch as P
    from awsm_renderer_tpu_torch.geometry import box

    mat = r.materials.insert(P.PbrMaterial(alpha_mode=P.AlphaMode.BLEND))
    r.add_mesh(box(0.3), mat, transform=P.Transform(
        translation=np.array([0, 0.9, 0], np.float32)))


def _transmission(r):
    import awsm_renderer_tpu_torch as P
    from awsm_renderer_tpu_torch.geometry import box

    r.add_mesh(box(0.3), r.materials.insert(P.PbrMaterial(
        transmission_factor=1.0)), transform=P.Transform(
            translation=np.array([0, 0.9, 0], np.float32)))


def _supersample(r):
    from dataclasses import replace

    r.config = replace(r.config, anti_aliasing=replace(
        r.config.anti_aliasing, supersample=True))


def _temporal(r):
    from dataclasses import replace

    r.config = replace(r.config, anti_aliasing=replace(
        r.config.anti_aliasing, temporal=True))


@pytest.mark.parametrize("scene, edit", [("box", _msaa),
                                         ("box", _supersample),
                                         ("env-ibl", _bloom)],
                         ids=["msaa", "supersample", "bloom"])
def test_aa_and_effects_render(scene, edit):
    """MSAA, supersample and bloom render (they raised before the AA and
    effects slice was ported): finite, and not the plain frame (bloom on
    a scene with HDR values above its threshold)."""
    r = T.torch_renderer(scene)
    base = r.render()
    edit(r)
    img = r.render()
    assert img.shape == base.shape and np.isfinite(img).all()
    assert not np.array_equal(img, base)


@pytest.mark.parametrize("other, debug_mode", [
    (_msaa, "none"), (None, "normals")], ids=["msaa", "debug-view"])
def test_temporal_falls_back_to_the_ordinary_frame(other, debug_mode):
    """Temporal AA with MSAA, or under a debug view, renders the ordinary
    frame, as the JAX renderer's use_temporal rule (renderer.py:970) does,
    and keeps no history."""
    plain = T.torch_renderer("box")
    r = T.torch_renderer("box")
    _temporal(r)
    if other is not None:
        other(plain)
        other(r)
    want = plain.render(debug_mode=debug_mode)
    got = r.render(debug_mode=debug_mode)
    assert r._temporal is None
    np.testing.assert_array_equal(got, want)


def test_temporal_frame_that_raises_resets_the_next():
    """The history leaves the renderer while a temporal frame runs: a
    frame that raises leaves none, and the next frame resets (shades
    every unit) instead of reusing a half-updated history."""
    from awsm_renderer_tpu_torch import renderer as R

    r = T.torch_renderer("box")
    _temporal(r)
    r.render()
    r.render()
    assert int((r._temporal["age"] == 0).sum()) == 1

    def fail(*a, **k):
        raise RuntimeError("frame failed")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(R, "render_frame_temporal", fail)
        with pytest.raises(RuntimeError, match="frame failed"):
            r.render()
    assert r._temporal is None
    r.render()
    assert bool((r._temporal["age"] == 0).all())


def _move_camera(r, eye=(2.2, 1.6, 3.8)):
    from awsm_renderer_tpu_torch.utils import math3d as m3

    r.camera.update(m3.look_at(eye, (0, 0, 0), (0, 1, 0)),
                    r.camera.projection)


def test_bucket_masks_upload_once_across_camera_moves():
    """After a camera move (the per-frame prep reruns) the renderer reuses
    the opaque, transparent and HUD masks' device tensors and uploads
    none of them again (reference: renderer.py _device_mask); a content
    edit that changes a mask uploads it anew."""
    import awsm_renderer_tpu_torch as P
    from awsm_renderer_tpu_torch.geometry import box

    r = T.torch_renderer("box")
    _transparent(r)
    r.add_mesh(box(0.2), r.materials.insert(P.UnlitMaterial()),
               transform=P.Transform(translation=np.array(
                   [0.6, 0.6, 0], np.float32)), hud=True)
    r.render_device()
    first = r._prep[1]
    names = ("opaque_dev", "transparent_dev", "hud_dev")
    assert all(first[n] is not None for n in names)
    uploads = []
    orig = r._tensor

    def recording(a):
        uploads.append(np.asarray(a))
        return orig(a)

    r._tensor = recording
    _move_camera(r)
    r.render_device()
    second = r._prep[1]
    assert second is not first                  # the prep did rerun
    for n in names:
        assert second[n] is first[n], n
    n_meshes = first["masks"]["opaque"].shape[0]
    assert not [a for a in uploads
                if a.dtype == bool and a.shape == (n_meshes,)]
    _transparent(r)                              # a second blend mesh
    r.render_device()
    third = r._prep[1]
    assert third["transparent_dev"] is not first["transparent_dev"]
    assert torch.equal(third["transparent_dev"].cpu(), torch.as_tensor(
        third["masks"]["transparent"]))


def test_pick_replays_the_last_render_call():
    """With temporal AA on, a pick after a moved camera re-renders the
    last frame's debug view (the ordinary frame: a debug view turns
    temporal reuse off), as the JAX renderer does (renderer.py:1205,
    :1249-1255), not a jittered temporal frame: the picks agree at the
    mesh edges, where the jitter would move them."""
    from awsm_renderer_tpu import AntiAliasing as JAA
    from awsm_renderer_tpu.utils import math3d as jm3

    import awsm_renderer_tpu_torch as P

    jr = T.jax_renderer("box", anti_aliasing=JAA(temporal=True))
    tr = T.torch_renderer("box", anti_aliasing=P.AntiAliasing(temporal=True))
    for r in (jr, tr):
        r.render(debug_mode="normals")
    eye = (2.2, 1.6, 3.8)
    jr.camera.update(jm3.look_at(eye, (0, 0, 0), (0, 1, 0)),
                     jr.camera.projection)
    _move_camera(tr, eye)
    assert tr._last_debug_mode == "normals"
    tr.pick(T.W // 2, T.H // 2)
    jr.pick(T.W // 2, T.H // 2)
    assert tr._temporal is None        # the replay was no temporal frame
    tid = np.asarray(jr._last_tri_id)
    edge = np.zeros(tid.shape, bool)
    edge[:, 1:] |= tid[:, 1:] != tid[:, :-1]
    edge[1:, :] |= tid[1:, :] != tid[:-1, :]
    ys, xs = np.nonzero(edge)
    assert len(ys) > 50
    picks_j = [jr.pick(int(x), int(y)) for y, x in zip(ys, xs)]
    picks_t = [tr.pick(int(x), int(y)) for y, x in zip(ys, xs)]
    assert picks_t == picks_j
    assert len(set(picks_j)) >= 2      # mesh and background (None)


def test_msaa_with_supersample_is_refused():
    """One AA mode at a time, as the JAX frame's assert (frame.py:961)."""
    from awsm_renderer_tpu_torch.errors import ConfigError

    r = T.torch_renderer("box")
    _msaa(r)
    _supersample(r)
    with pytest.raises(ConfigError, match="msaa"):
        r.render_device()


@pytest.mark.parametrize("edit", [_transparent, _transmission],
                         ids=["transparent", "transmission"])
def test_overlay_content_renders(edit):
    """Transparent and transmissive meshes take the overlay pass (they
    raised before the overlay slice was ported)."""
    r = T.torch_renderer("box")
    base = r.render()
    edit(r)
    img = r.render()
    assert np.isfinite(img).all()
    assert r._prep[1]["transparent_dev"] is not None
    assert not np.array_equal(img, base)


def test_edges_view_needs_msaa():
    """The MSAA edge view needs MSAA (a ConfigError, as in the JAX
    renderer). Every other debug view renders (tests/test_torch_frame.py)."""
    from awsm_renderer_tpu_torch.errors import ConfigError

    r = T.torch_renderer("box")
    with pytest.raises(ConfigError, match="msaa"):
        r.render_device(debug_mode="edges")


def test_cpu_tensors_take_the_plain_twins():
    """Kernel wrappers on CPU tensors run the twin and count no launch."""
    from awsm_renderer_tpu_torch.ops import kernels

    kernels.reset_launch_counts()
    T.torch_renderer("box").render_device()
    assert all(n == 0 for n in kernels.launch_counts.values())
    assert torch.cuda.is_available() or kernels._lib is None


def test_entry_points_default_to_the_card():
    """device_scene_from_jax and reset_history, like the renderer, run on
    the card unless the caller asks for the CPU."""
    import inspect

    from awsm_renderer_tpu_torch import device_scene_from_jax
    from awsm_renderer_tpu_torch.ops.temporal import reset_history

    for fn in (device_scene_from_jax, reset_history):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_kernel_signatures_match_sources():
    """Every C entry point's ctypes argtypes (ops/kernels.py) follow its
    prototype in csrc/: a pointer or the stream is c_void_p, an int c_int
    (a missing argtype would pass the stream as a 32-bit int)."""
    import ctypes
    import re

    from awsm_renderer_tpu_torch.ops import kernels

    protos = {}
    for name in kernels.SOURCES:
        with open(os.path.join(kernels.CSRC, name)) as f:
            src = f.read()
        for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', src):
            protos[m.group(1)] = [
                ctypes.c_void_p if ("*" in a or "cudaStream_t" in a)
                else ctypes.c_int for a in m.group(2).split(",")]
    assert protos == kernels._SIGNATURES
