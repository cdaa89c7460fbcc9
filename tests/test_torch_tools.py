"""PyTorch port, the facade's tool members and the tools: the runtime
setters and remove_all, warmup and the 'retrace:' note, the timings
spans, debug_once / debug_n, the compatibility report, the exporter and
the store reports, the scene snapshot, the mega-texture atlas through the
facade, the BRDF LUT and the port's demo CLI — against the JAX package.

Every JAX computation of the module starts in threads from one module
fixture (XLA compiles without the GIL). Images are held at
tests/test_torch_frame.py's tolerance (< 0.5% of channel values off by
more than 4/255); the demo's PNGs at tests/test_golden.py's (the same).
Reports, notes, span names, PNG bytes and framebuffer bytes are equal.
The LUT: the port adds the samples in the reference scan's order; XLA
contracts the per-sample terms into FMAs and evaluates pow and sqrt its
own way. At the grazing NdotV column (n_dot_v = 1/64) f32 rounding
dominates: both packages differ from a float64 evaluation of the same
sums by up to 2.5e-4 there, and from each other by 1.9e-4 (32x32, 64
samples). So the tables (values in [0, 1]) are held to 5e-4 absolute on
that column, 5e-5 elsewhere (observed 3.1e-5) and 2e-6 in mean (observed
5.6e-7); sample_brdf_lut on the same table to 1e-6.
scene_bytes is what each package counts: the reference sums its host
pools at capacity and the environment maps as quad-packed f32; the port
sums the tensors its flush put on the device (test_compatibility_report
states the difference)."""

import logging
import os

import numpy as np
import pytest

import _torch_port as T

F = np.float32
W2, H2 = 128, 32          # tests/test_aux.py's and test_debug_compat.py's


def _packages(jax_side: bool):
    import importlib

    return importlib.import_module("awsm_renderer_tpu" if jax_side
                                   else "awsm_renderer_tpu_torch")


def _renderer(jax_side: bool, device="cpu", **cfg):
    P = _packages(jax_side)
    c = P.RendererConfig(**cfg)
    return P.AwsmRendererTpu(c) if jax_side else \
        P.AwsmRendererTorch(c, device=device)


def _m3(jax_side):
    import importlib

    return importlib.import_module(
        f"{_packages(jax_side).__name__}.utils.math3d")


def _geometry(jax_side):
    import importlib

    return importlib.import_module(f"{_packages(jax_side).__name__}.geometry")


def _aux_scene(jax_side, device="cpu"):
    """tests/test_aux.py _scene: an unlit red box (a checker texture in
    the pool), one directional light, tonemapping NONE, 128x32."""
    P, g, m3 = _packages(jax_side), _geometry(jax_side), _m3(jax_side)
    r = _renderer(jax_side, device, width=W2, height=H2, post_processing=(
        P.PostProcessing(tonemapping=P.ToneMapping.NONE)))
    r.textures.add_image(g.checker_texture(16, 4), srgb=False)
    mat = r.materials.insert(P.UnlitMaterial(
        base_color_factor=np.array([1, 0, 0, 1], F)))
    r.add_mesh(g.box(), mat)
    r.lights.insert(P.Light.directional([0, -1, 0]))
    r.camera.update(m3.look_at([0, 0, 3], [0, 0, 0], [0, 1, 0]),
                    m3.perspective(np.pi / 3, W2 / H2, 0.1, 100.0))
    return r


def _add_green_box(r, jax_side):
    P, g = _packages(jax_side), _geometry(jax_side)
    m2 = r.materials.insert(P.UnlitMaterial(
        base_color_factor=np.array([0, 1, 0, 1], F)))
    r.add_mesh(g.box(0.3), m2, transform=P.Transform(
        translation=np.array([0, 0, 1.0], F)))


def _sphere_scene(jax_side):
    """tests/test_debug_compat.py _scene: a white PBR sphere under one
    directional light, tonemapping NONE, 128x32."""
    P, g, m3 = _packages(jax_side), _geometry(jax_side), _m3(jax_side)
    r = _renderer(jax_side, width=W2, height=H2, post_processing=(
        P.PostProcessing(tonemapping=P.ToneMapping.NONE)))
    mat = r.materials.insert(P.PbrMaterial(
        base_color_factor=np.array([1, 1, 1, 1], F), roughness_factor=0.6))
    r.add_mesh(g.uv_sphere(0.7), mat)
    r.lights.insert(P.Light.directional([0, 0, -1], intensity=3.0))
    r.camera.update(m3.look_at([0, 0, 3], [0, 0, 0], [0, 1, 0]),
                    m3.perspective(np.pi / 3, W2 / H2, 0.1, 100.0))
    return r


def _atlas_scene(jax_side):
    """tests/test_mega_texture.py TestRendererIntegration._scene: a red
    and a green image packed into one atlas page through add_atlas_image,
    on two quads, 128x64."""
    import importlib

    P, g, m3 = _packages(jax_side), _geometry(jax_side), _m3(jax_side)
    root = P.__name__
    TS_BASE_COLOR = importlib.import_module(
        f"{root}.core.materials").TS_BASE_COLOR
    TextureType = importlib.import_module(
        f"{root}.core.mega_texture").TextureType
    r = _renderer(jax_side, width=128, height=64)
    red = np.zeros((16, 16, 4), F)
    red[..., 0] = 1.0
    red[..., 3] = 1.0
    green = np.zeros((24, 24, 4), F)
    green[..., 1] = 1.0
    green[..., 3] = 1.0
    ref_r = r.add_atlas_image(red, TextureType.ALBEDO)
    ref_g = r.add_atlas_image(green, TextureType.ALBEDO)
    assert ref_r.texture_id == ref_g.texture_id
    assert ref_r.transform_id != ref_g.transform_id
    for ref, x in ((ref_r, -1.1), (ref_g, 1.1)):
        mat = r.materials.insert(P.UnlitMaterial(
            base_color_factor=np.ones(4, F), textures={TS_BASE_COLOR: ref}))
        r.add_mesh(g.plane(2.0), mat, transform=P.Transform(
            translation=np.array([x, 0, 0], F),
            rotation=m3.quat_from_axis_angle([1, 0, 0], np.pi / 2)))
    r.camera.update(m3.look_at([0, 0, 3.2], [0, 0, 0], [0, 1, 0]),
                    m3.perspective(np.pi / 3, 2.0, 0.1, 100.0))
    return r


# ---- the flows both packages run ---------------------------------------

def _setters_flow(jax_side):
    """tests/test_debug_compat.py test_runtime_setters_and_remove_all:
    (first image, SMAA image, empty-scene image, smaa flag, meshes after
    remove_all). The SMAA frame renders on the port only (None for JAX):
    tests/test_debug_compat.py renders JAX's, and test_torch_effects.py
    holds the port's SMAA to its golden."""
    P = _packages(jax_side)
    r = _sphere_scene(jax_side)
    img0 = T.to_numpy(r.render())
    r.set_anti_aliasing(P.AntiAliasing(smaa=True))
    smaa = r.config.anti_aliasing.smaa
    img1 = None if jax_side else T.to_numpy(r.render())
    r.remove_all()
    n = r.meshes.count
    return img0, img1, T.to_numpy(r.render()), smaa, n


def _warmup_flow(jax_side):
    """tests/test_debug_compat.py test_warmup_compiles_variants_and_
    retrace_note on the sphere scene, recorded: (frames warmup rendered,
    bloom after it, span names of a first and a second frame with
    timings on, notes after a bloom flip, notes at steady state, whether
    an unknown key raised ConfigError)."""
    import dataclasses

    P = _packages(jax_side)
    errors = __import__(f"{P.__name__}.errors", fromlist=["ConfigError"])
    spans = _sphere_scene(jax_side)
    spans.logging_timings = True
    spans.render_device()
    spans.render_device()
    span_names = [sorted(f) for f in spans.timings.frames]

    r = _sphere_scene(jax_side)
    n = r.warmup([{"bloom": True}])
    bloom = r.config.post_processing.bloom
    r.timings.enabled = True
    r.render_device()
    r.timings.frames.clear()
    r.set_post_processing(dataclasses.replace(r.config.post_processing,
                                              bloom=True))
    r.render_device()
    flip = [k for f in r.timings.frames for k in f if k.startswith("retrace")]
    r.timings.frames.clear()
    r.render_device()
    steady = [k for f in r.timings.frames for k in f
              if k.startswith("retrace")]
    try:
        r.warmup([{"not_a_field": 1}])
        raised = False
    except errors.ConfigError:
        raised = True
    return n, bloom, span_names, flip, steady, raised


def _snapshot_flow(jax_side, path):
    """tests/test_aux.py TestSnapshot, recorded: (image, reloaded image,
    the reloaded scene with a green box added, texture_report,
    geometry_report)."""
    import importlib

    root = _packages(jax_side).__name__
    snap = importlib.import_module(f"{root}.core.snapshot")
    exp = importlib.import_module(f"{root}.utils.exporter")
    r = _aux_scene(jax_side)
    img1 = T.to_numpy(r.render())
    snap.save_scene(r, path)
    r2 = (snap.load_scene(path) if jax_side
          else snap.load_scene(path, device="cpu"))
    img2 = T.to_numpy(r2.render())
    _add_green_box(r2, jax_side)
    img3 = T.to_numpy(r2.render())
    return (img1, img2, img3, exp.texture_report(r.textures),
            exp.geometry_report(r.meshes))


def _atlas_flow(jax_side):
    r = _atlas_scene(jax_side)
    return T.to_numpy(r.render()), r.mega_texture.report()


def _lut_flow(jax_side):
    import importlib

    lut_mod = importlib.import_module(
        f"{_packages(jax_side).__name__}.ops.brdf_lut")
    lut = (lut_mod.generate_brdf_lut(32, 64) if jax_side
           else lut_mod.generate_brdf_lut(32, 64, device="cpu"))
    return T.to_numpy(lut)


def _demo_flow(jax_side, scene, out):
    if jax_side:
        from demo.app import main
        argv = []
    else:
        from awsm_renderer_tpu_torch.demo.app import main
        argv = ["--device", "cpu"]
    rc = main(["--scene", scene, "--width", "128", "--height", "64",
               "--frames", "1", "--out", out] + argv)
    from PIL import Image

    return rc, np.asarray(Image.open(os.path.join(out, "frame_0000.png")))


LUT_IN = np.random.default_rng(5).uniform(-0.1, 1.1, (2, 500)).astype(F)
DEMOS = ("alpha-blend", "glb-strip-fan")


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """{name: result} of every JAX flow, run together in threads."""
    from concurrent.futures import ThreadPoolExecutor

    import awsm_renderer_tpu  # noqa: F401  (imported before the threads)
    import demo.app  # noqa: F401

    d = tmp_path_factory.mktemp("jax_side")
    jobs = {       # one thread for the sphere scene's flows: shared compiles
        "sphere": (lambda: (_setters_flow(True), _warmup_flow(True)),),
        "snapshot": (_snapshot_flow, True, str(d / "scene.awsm")),
        "atlas": (_atlas_flow, True),
        "lut": (_lut_flow, True),
        **{f"demo:{s}": (_demo_flow, True, s, str(d / s)) for s in DEMOS},
    }
    with ThreadPoolExecutor(len(jobs)) as ex:
        futs = {k: ex.submit(*v) for k, v in jobs.items()}
        out = {k: f.result() for k, f in futs.items()}
    out["setters"], out["warmup"] = out.pop("sphere")
    import awsm_renderer_tpu.ops.brdf_lut as J
    import jax.numpy as jnp

    lut = jnp.asarray(out["lut"])
    out["lut_samples"] = tuple(np.asarray(x) for x in J.sample_brdf_lut(
        lut, jnp.asarray(LUT_IN[0]), jnp.asarray(LUT_IN[1])))
    out["compat"] = _compat(True)
    return out


def _compat(jax_side):
    import importlib

    c = importlib.import_module(
        f"{_packages(jax_side).__name__}.utils.compatibility")
    r = _sphere_scene(jax_side)
    return r, c.check_compatibility(r)


def _hold_image(got, want):
    assert got.shape == want.shape
    diff = np.abs(np.round(got * 255) - np.round(want * 255))
    assert (diff > 4).mean() < 0.005, (diff > 4).mean()


# ---- runtime setters, remove_all, warmup, retrace, spans ---------------

def test_runtime_setters_and_remove_all(jax_side):
    j = jax_side["setters"]
    t = _setters_flow(False)
    _hold_image(t[0], j[0])
    _hold_image(t[2], j[2])
    assert t[3] and j[3] and t[4] == j[4] == 0
    assert np.isfinite(t[1]).all()
    empty = t[2]
    assert empty[..., 0].std() < 1e-4 and empty[..., 0].mean() > 0.1


def test_warmup_count_restore_and_retrace_note(jax_side):
    n, bloom, _spans, flip, steady, raised = _warmup_flow(False)
    jn, jbloom, _jspans, jflip, jsteady, jraised = jax_side["warmup"]
    assert n == jn == 2
    assert bloom is jbloom is False
    assert flip == jflip and len(flip) == 1 and "bloom" in flip[0]
    assert steady == jsteady == []
    assert raised and jraised


def test_warmup_restores_config_when_a_variant_raises():
    from awsm_renderer_tpu_torch.errors import ConfigError

    r = _sphere_scene(False)
    cfg = r.config
    with pytest.raises(ConfigError):
        r.warmup([{"msaa": True, "supersample": True}])
    assert r.config is cfg


# the port's spans beyond the reference's on the sphere scene's frames
# (tests/test_torch_spans.py): the facade's whole frame and its prep, and
# the frame graph's stages a single-sample frame without effects runs
PORT_SPANS = ["render_device", "prepare", "render_frame/vertex",
              "render_frame/raster", "render_frame/shade",
              "render_frame/display"]


def test_spans_at_jax_names(jax_side):
    _n, _b, spans, *_ = _warmup_flow(False)
    jax_spans = jax_side["warmup"][2]
    assert spans == [sorted(f + PORT_SPANS) for f in jax_spans]
    assert jax_spans[0] == sorted(["write_gpu", "write_gpu/meshes",
                                   "collect_renderables",
                                   "render_frame/dispatch"])


def test_timings_off_records_nothing():
    r = _sphere_scene(False)
    r.render_device()
    assert r.timings.frames == [] and r.timings.summary() == {}
    assert r.timings.counts == {}
    r.logging_timings = True
    r.render_device()
    s = r.timings.summary()
    assert set(s) == {"write_gpu", "render_frame/dispatch", *PORT_SPANS}
    assert all(v > 0 for v in s.values())
    assert r.timings.counts == {}               # the prep memo held
    assert r.timings.device_summary() == {}     # no CUDA events on the CPU


def test_render_timings_spans_and_noop():
    from awsm_renderer_tpu_torch.utils.profiling import RenderTimings

    t = RenderTimings(enabled=True)
    with t.span("raster"):
        pass
    with t.span("shade"):
        pass
    frame = t.end_frame()
    assert set(frame) == {"raster", "shade"}
    assert t.summary().keys() == frame.keys()
    off = RenderTimings(enabled=False)
    with off.span("x"):
        pass
    assert off.end_frame() == {} and off.frames == []


@pytest.mark.parametrize("pkg", ("awsm_renderer_tpu_torch",
                                 "awsm_renderer_tpu"))
def test_debug_once_and_n(caplog, pkg):
    import importlib

    prof = importlib.import_module(f"{pkg}.utils.profiling")
    with caplog.at_level(logging.WARNING, logger=prof.logger.name):
        prof.debug_once(f"once-{pkg}", "hello")
        prof.debug_once(f"once-{pkg}", "hello")
        for _ in range(5):
            prof.debug_n(f"n-{pkg}", "msg", 3)
        prof.debug_unique_string(f"u-{pkg}", "a")
        prof.debug_unique_string(f"u-{pkg}", "a")
        prof.debug_unique_string(f"u-{pkg}", "b")
    msgs = [r.message for r in caplog.records if r.name == prof.logger.name]
    assert msgs.count("hello") == 1 and msgs.count("msg") == 3
    assert msgs.count("a") == 1 and msgs.count("b") == 1


# ---- compatibility, exporter, reports ----------------------------------

def test_compatibility_report(jax_side):
    """framebuffer_bytes is JAX's formula, equal. scene_bytes: JAX's
    formula over the port's own host stores (copies of JAX's) gives JAX's
    count to the byte, so the two differ only in what is counted: the
    port's is the bytes of every tensor of its device dict after the
    flush. On this scene (one sphere, a solid environment) the reference
    counts 19,681,536 bytes and the port 10,201,600: the reference counts
    the environment maps four times over as quad-packed f32 (a solid
    environment stays on the host in the port) and the pools at capacity,
    the port the pools' live rows, the material, light and texture
    tables, the joint matrices and the BRDF LUT."""
    from awsm_renderer_tpu_torch.utils.compatibility import (
        check_compatibility, scene_tensor_bytes,
    )

    rj, cj = jax_side["compat"]
    r = _sphere_scene(False)
    c = check_compatibility(r)
    assert c.framebuffer_bytes == cj.framebuffer_bytes > 0
    assert c.ok and cj.ok and c.device_kind == "cpu"
    assert c.hbm_bytes == os.sysconf("SC_PAGE_SIZE") * os.sysconf(
        "SC_PHYS_PAGES")
    assert c.scene_bytes == scene_tensor_bytes(r._device) > 0
    m, e = r.meshes, r.environment
    host = sum(getattr(m, n).nbytes for n in (
        "c_pos", "c_norm", "c_tang", "c_uv0", "c_uv1", "c_color",
        "c_joints", "c_weights", "c_morph_base", "morph_deltas", "tri_mesh",
        "mesh_info", "morph_weights"))
    host += r.textures.texels_packed.nbytes
    host += 4 * (e.skybox.nbytes + e.irradiance.nbytes + e.prefiltered.nbytes)
    host += r.transforms.world.nbytes + r.transforms.normal.nbytes
    assert host == cj.scene_bytes
    assert c.scene_bytes < cj.scene_bytes


def test_export_png_bytes_equal_jax(tmp_path):
    from awsm_renderer_tpu.utils import exporter as J
    from awsm_renderer_tpu_torch.utils import exporter as P

    rng = np.random.default_rng(0)
    u8 = rng.integers(0, 256, (16, 16, 4), dtype=np.uint8)
    flt = rng.random((16, 16, 4)).astype(F)
    depth = np.linspace(0.1, 1.0, 64).reshape(8, 8).astype(F)
    import torch

    for name, fn, arg in (("u8", "export_image", u8),
                          ("f32", "export_image", flt),
                          ("depth", "export_depth", depth)):
        getattr(J, fn)(arg, str(tmp_path / f"{name}_j.png"))
        getattr(P, fn)(torch.from_numpy(arg), str(tmp_path / f"{name}_t.png"))
        assert ((tmp_path / f"{name}_j.png").read_bytes()
                == (tmp_path / f"{name}_t.png").read_bytes()), name


def test_store_reports_equal_jax(jax_side, tmp_path):
    *_imgs, tex, geo = _snapshot_flow(False, str(tmp_path / "s.awsm"))
    assert tex == jax_side["snapshot"][3]
    assert geo == jax_side["snapshot"][4]
    assert tex["used_texels"] > 0 and tex["textures"][0]["width"] == 16
    assert geo["meshes"] == 1 and geo["corners"]["used"] >= 36


# ---- snapshot ----------------------------------------------------------

def test_snapshot_roundtrip_bit_equal(jax_side, tmp_path):
    img1, img2, img3, _tex, _geo = _snapshot_flow(False,
                                                  str(tmp_path / "s.awsm"))
    np.testing.assert_array_equal(img1, img2)
    _hold_image(img1, jax_side["snapshot"][0])
    assert img3[H2 // 2, W2 // 2, 1] > 0.9       # the green box in front
    _hold_image(img3, jax_side["snapshot"][2])


def test_snapshot_loads_on_the_chosen_device(tmp_path):
    import torch

    from awsm_renderer_tpu_torch.core.snapshot import load_scene, save_scene

    p = str(tmp_path / "s.awsm")
    save_scene(_aux_scene(False), p)
    assert load_scene(p, device="cpu").device == torch.device("cpu")
    import inspect

    assert inspect.signature(load_scene).parameters["device"].default \
        == "cuda"


def test_snapshot_bad_file_rejected(tmp_path):
    import pickle

    from awsm_renderer_tpu_torch.core.snapshot import load_scene

    p = tmp_path / "bad.awsm"
    p.write_bytes(pickle.dumps({"magic": "nope"}))
    with pytest.raises(ValueError):
        load_scene(str(p), device="cpu")


# ---- mega texture through the facade -----------------------------------

def test_atlas_scene_matches_jax(jax_side):
    img, rep = _atlas_flow(False)
    jimg, jrep = jax_side["atlas"]
    _hold_image(img, jimg)
    assert rep == jrep and rep["albedo"][0]["entries"] == 2
    left, right = img[32, 32, :3], img[32, 96, :3]
    assert left[0] > 0.5 and left[1] < 0.3, left
    assert right[1] > 0.5 and right[0] < 0.3, right


# ---- BRDF LUT ------------------------------------------------------------

def test_brdf_lut_matches_jax(jax_side):
    import torch

    from awsm_renderer_tpu_torch.ops.brdf_lut import (
        generate_brdf_lut, sample_brdf_lut,
    )

    lut = _lut_flow(False)
    want = jax_side["lut"]
    assert lut.shape == want.shape == (32, 32, 2) and lut.dtype == np.float32
    d = np.abs(lut - want)
    assert d.max() <= 5e-4 and d[:, 1:].max() <= 5e-5 and d.mean() <= 2e-6, (
        d.max(), d[:, 1:].max(), d.mean())
    assert generate_brdf_lut(32, 64, device="cpu") is \
        generate_brdf_lut(32, 64, device="cpu")          # cached
    a, b = sample_brdf_lut(torch.tensor(want), torch.from_numpy(LUT_IN[0]),
                           torch.from_numpy(LUT_IN[1]))
    np.testing.assert_allclose(a.numpy(), jax_side["lut_samples"][0],
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(b.numpy(), jax_side["lut_samples"][1],
                               rtol=0, atol=1e-6)


def test_renderer_builds_the_lut_once():
    r = _sphere_scene(False)
    r.render_device()
    lut = r._device["brdf_lut"]
    assert tuple(lut.shape) == (64, 64, 2)          # the CPU size, as JAX
    r.render_device()
    assert r._device["brdf_lut"] is lut


# ---- the port's demo CLI -------------------------------------------------

@pytest.mark.parametrize("scene", DEMOS)
def test_demo_cli_matches_jax_cli(jax_side, scene, tmp_path):
    rc, img = _demo_flow(False, scene, str(tmp_path / scene))
    jrc, jimg = jax_side[f"demo:{scene}"]
    assert rc == jrc == 0 and img.shape == jimg.shape == (64, 128, 4)
    diff = np.abs(img.astype(np.int16) - jimg.astype(np.int16))
    assert (diff > 4).mean() < 0.005, (diff > 4).mean()


def test_demo_cli_defaults_to_the_card():
    from awsm_renderer_tpu_torch.demo.app import parse_args

    assert parse_args([]).device == "cuda"


def test_demo_cli_grid_timings_report(tmp_path, capsys):
    from awsm_renderer_tpu_torch.demo.app import main

    rc = main(["--scene", "box", "--width", "128", "--height", "64",
               "--out", str(tmp_path), "--device", "cpu", "--grid",
               "--timings", "--report"])
    assert rc == 0
    err = capsys.readouterr().err
    assert "per-pass mean:" in err and "write_gpu=" in err
    assert '"geometry"' in err and '"textures"' in err


def test_port_imports_no_jax():
    """The port's new modules import neither jax nor the JAX package."""
    import subprocess
    import sys

    code = ("import sys; import awsm_renderer_tpu_torch.demo.app, "
            "awsm_renderer_tpu_torch.demo.scenes, "
            "awsm_renderer_tpu_torch.session, awsm_renderer_tpu_torch.editor, "
            "awsm_renderer_tpu_torch.utils.compatibility, "
            "awsm_renderer_tpu_torch.utils.exporter, "
            "awsm_renderer_tpu_torch.ops.brdf_lut; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'awsm_renderer_tpu' or "
            "m.startswith('awsm_renderer_tpu.') or m == 'demo']; "
            "print(bad); sys.exit(1 if bad else 0)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_animation_classes_exported():
    import awsm_renderer_tpu as J
    import awsm_renderer_tpu_torch as P

    for n in ("AnimationPlayer", "AnimationClip", "AnimationChannel",
              "AnimationSampler", "Interpolation", "LoopStyle",
              "TargetPath"):
        assert n in J.__all__ and n in P.__all__
        assert getattr(P, n).__module__ == "awsm_renderer_tpu_torch.core.animation"
