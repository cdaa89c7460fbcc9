"""PyTorch port, render hooks and the extra geometry pass (M12): the
seven RenderHooks points and passes/extra.py, against the JAX renderer.

tests/test_hooks_lightcull.py's four hook tests run on both renderers,
the port's hooks written in torch and JAX's in jnp, and the images are
held to tests/test_torch_frame.py's tolerance (< 0.5% of channel values
off by more than 4/255) besides the JAX test's own checks. The four JAX
frames compile side by side in threads. extra_geometry_pass is held
against JAX's on seeded triangles: where the two differ, the pixel
centre lies on a triangle edge to within rounding (distance < 1e-3 px:
XLA:CPU contracts the edge functions into FMAs, the port rounds each
product; ROADMAP.md queue 3), and everywhere else the images agree to
1e-5 (the written depth to 1e-4). The port's own checks: every hook
point fires once in the ordinary, MSAA, supersample, temporal and
overlay frames and identity hooks
leave the image as it was (1e-6: the overlay hooks turn the overlay crop
off), first_pass's edits stay in their frame, the temporal frame falls
back for the opaque-stage hooks, and pick() replays the in-frame hooks
without the host ones."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port as T

F = np.float32


def _pkg(jax_side: bool):
    import awsm_renderer_tpu as J
    import awsm_renderer_tpu_torch as P

    return J if jax_side else P


def _sub(jax_side: bool, name: str):
    import importlib

    return importlib.import_module(
        f"{'awsm_renderer_tpu' if jax_side else 'awsm_renderer_tpu_torch'}"
        f".{name}")


def _unlit_box(jax_side: bool, rgba, height: int, aspect: float,
               size=1.0, device="cpu", **cfg):
    """tests/test_hooks_lightcull.py's scenes: one unlit box, tonemapping
    off, the camera at (0, 0, 3)."""
    m = _pkg(jax_side)
    m3 = _sub(jax_side, "utils.math3d")
    config = m.RendererConfig(width=128, height=height,
                              post_processing=m.PostProcessing(
                                  tonemapping=m.ToneMapping.NONE), **cfg)
    r = (m.AwsmRendererTpu(config) if jax_side
         else m.AwsmRendererTorch(config, device=device))
    mat = r.materials.insert(m.UnlitMaterial(
        base_color_factor=np.array(rgba, F)))
    r.add_mesh(_sub(jax_side, "geometry").box(size), mat)
    r.camera.update(m3.look_at([0, 0, 3], [0, 0, 0], [0, 1, 0]),
                    m3.perspective(np.pi / 3, aspect, 0.1, 100.0))
    return r, mat


# the JAX test's gizmo triangles: one left of the box, one behind it
GIZMO = np.array([[[-1.6, -0.5, 0.0], [-0.9, -0.5, 0.0], [-1.25, 0.5, 0.0]],
                  [[-0.3, -0.3, -2.0], [0.3, -0.3, -2.0], [0.0, 0.3, -2.0]]],
                 F)
GIZMO_RGBA = np.array([[0, 1, 0, 1], [1, 0, 1, 1]], F)
OVERLAY = np.array([[[-0.2, -0.2, 0.0], [0.2, -0.2, 0.0], [0.0, 0.2, 0.0]]],
                   F)
OVERLAY_RGBA = np.array([[1, 0, 0, 0.5]], F)


def _case(jax_side: bool, name: str, device="cpu"):
    """(renderer, hooks, calls) of JAX's hook test `name`, the hooks in
    jnp or torch (the port's renderer on `device`)."""
    m = _pkg(jax_side)
    RenderHooks = _sub(jax_side, "passes.frame").RenderHooks
    extra = _sub(jax_side, "passes.extra").extra_geometry_pass
    xp = jnp if jax_side else torch
    arr = (jnp.asarray if jax_side
           else lambda a: torch.as_tensor(a, device=device))
    calls = {"pre": 0, "post": 0}
    if name == "in_order":
        r, _ = _unlit_box(jax_side, [1, 0, 0, 1], 32, 128 / 32,
                          device=device)
        green = arr(np.array([0, 0.7, 0, 0], F))

        def stamp(ldr, ds):
            if jax_side:
                return ldr.at[0, 0].set(1.0)
            out = ldr.clone()
            out[0, 0] = 1.0
            return out

        hooks = RenderHooks(
            before_transparent=lambda hdr, depth, ds: hdr + green,
            last_pass=stamp)
    elif name in ("world_pass", "display_overlay"):
        r, _ = _unlit_box(jax_side, [1, 1, 1, 1], 64, 2.0, size=0.8,
                          device=device)
        if name == "world_pass":
            tris, cols = arr(GIZMO), arr(GIZMO_RGBA)

            def before_transparent(hdr, depth, ds):
                return extra(hdr, depth, ds["camera"], tris, cols,
                             depth_test=True)[0]

            hooks = RenderHooks(before_transparent=before_transparent)
        else:
            tris, cols = arr(OVERLAY), arr(OVERLAY_RGBA)

            def last_pass(ldr, ds):
                return extra(ldr, None, ds["camera"], tris, cols,
                             depth_test=False)[0]

            hooks = RenderHooks(last_pass=last_pass)
    else:
        r, mat = _unlit_box(jax_side, [0, 0, 1, 1], 32, 4.0, device=device)
        scale = arr(np.diag([0.5, 0.5, 0.5, 1.0]).astype(F))

        def pre_render(renderer):
            calls["pre"] += 1
            renderer.materials.update(mat, m.UnlitMaterial(
                base_color_factor=np.array([1, 0, 0, 1], F)))

        def first_pass(ds):
            ds = dict(ds)
            w = ds["world"]                 # JAX: (cap, 16); port (cap, 4, 4)
            ds["world"] = xp.reshape(xp.reshape(w, (-1, 4, 4)) @ scale,
                                     w.shape)
            return ds

        def post_render(renderer):
            calls["post"] += 1

        hooks = RenderHooks(pre_render=pre_render, first_pass=first_pass,
                            post_render=post_render)
    return r, hooks, calls


CASES = ("in_order", "world_pass", "display_overlay", "host_first_pass")


@pytest.fixture(scope="module")
def jax_side():
    """{case: (image with hooks, host hook calls)}: the JAX renderer's
    hook frames, compiled side by side in threads."""
    from concurrent.futures import ThreadPoolExecutor

    def run(name):
        r, hooks, calls = _case(True, name)
        return r.render(hooks=hooks), dict(calls)

    with ThreadPoolExecutor(len(CASES)) as ex:
        futs = {n: ex.submit(run, n) for n in CASES}
        return {n: f.result() for n, f in futs.items()}


def _hold_image(lt, lj):
    assert lt.shape == lj.shape and np.isfinite(lt).all()
    diff = np.abs(np.round(lt * 255) - np.round(lj * 255))
    assert (diff > 4).mean() < 0.005, (diff > 4).mean()


@pytest.mark.parametrize("name", CASES)
def test_hook_frame_matches_jax(jax_side, name):
    """tests/test_hooks_lightcull.py's hook tests on the port: its checks,
    and the image against JAX's with the same hooks."""
    lj, calls_j = jax_side[name]
    r, hooks, calls = _case(False, name)
    img = r.render(hooks=hooks)
    _hold_image(img, lj)
    H, W = img.shape[:2]
    if name == "in_order":
        c = img[H // 2, W // 2]
        assert c[1] > 0.5 and c[0] > 0.5            # red box + green tint
        np.testing.assert_allclose(img[0, 0], 1.0)
        assert r.render()[H // 2, W // 2, 1] < 0.1  # no hook, no green
    elif name == "world_pass":
        base = r.render()
        ys, xs = np.where((img[..., 1] > 0.8) & (img[..., 0] < 0.2))
        assert len(ys) > 20 and xs.max() < 64       # the left gizmo
        assert not ((img[..., 0] > 0.8) & (img[..., 2] > 0.8)
                    & (img[..., 1] < 0.2)).any()    # the hidden one
        np.testing.assert_allclose(img[32, 64], base[32, 64], atol=1e-5)
    elif name == "display_overlay":
        c = img[32, 64]
        assert c[0] > 0.7 and 0.3 < c[1] < 0.8, c   # 50% red over white
    else:
        assert calls == calls_j == {"pre": 1, "post": 1}
        c = img[16, 64, :3]
        assert c[0] > 0.8 and c[2] < 0.2, c         # pre_render's recolour
        cov_hook = (img[..., 0] > 0.5).sum()
        cov_plain = (r.render()[..., 0] > 0.5).sum()
        assert 0 < cov_hook < cov_plain * 0.5, (cov_hook, cov_plain)


# ---- extra_geometry_pass ----------------------------------------------------

def _edge_distance(clip, H: int, W: int):
    """(H, W) distance of each pixel centre to the nearest edge line of
    the (T, 3, 4) clip-space triangles, in pixels."""
    px = np.arange(W, dtype=np.float64)[None, :] + 0.5
    py = np.arange(H, dtype=np.float64)[:, None] + 0.5
    c = clip.astype(np.float64)
    sx = (c[..., 0] / c[..., 3] * 0.5 + 0.5) * W
    sy = (0.5 - c[..., 1] / c[..., 3] * 0.5) * H
    best = np.full((H, W), np.inf)
    for t in range(c.shape[0]):
        for a, b in ((0, 1), (1, 2), (2, 0)):
            A, B = sy[t, a] - sy[t, b], sx[t, b] - sx[t, a]
            C = sx[t, a] * sy[t, b] - sx[t, b] * sy[t, a]
            d = np.abs(A * px + B * py + C) / max(np.hypot(A, B), 1e-30)
            best = np.minimum(best, d)
    return best


@pytest.mark.parametrize("depth_test, depth_write, two_sided", [
    (True, False, True), (False, False, True), (True, True, True),
    (True, True, False)],
    ids=["depth-test", "no-depth-test", "depth-write", "one-sided"])
def test_extra_pass_matches_jax(depth_test, depth_write, two_sided):
    from awsm_renderer_tpu.passes.extra import (
        extra_geometry_pass as jax_pass, project_triangles as jax_project,
    )
    from awsm_renderer_tpu_torch.passes.extra import (
        extra_geometry_pass, project_triangles,
    )
    from awsm_renderer_tpu_torch.utils import math3d as m3

    H, W = 64, 128
    rng = np.random.default_rng(21)
    centres = rng.uniform([-2, -1, -3], [2, 1, 1], (24, 1, 3))
    tris = (centres + rng.uniform(-1.2, 1.2, (24, 3, 3))).astype(F)
    cols = rng.uniform(0.1, 1.0, (24, 3, 4)).astype(F)
    img = rng.uniform(0, 1, (H, W, 4)).astype(F)
    depth = rng.uniform(0.97, 1.0, (H, W)).astype(F)
    vp = (m3.perspective(np.pi / 3, W / H, 0.1, 100.0)
          @ m3.look_at([0, 0.3, 4], [0, 0, 0], [0, 1, 0])).astype(F)
    kw = dict(depth_test=depth_test, depth_write=depth_write,
              two_sided=two_sided)
    want_img, want_dep = jax.jit(
        lambda i, d, t, c: jax_pass(i, d, {"view_proj": jnp.asarray(vp)},
                                    t, c, **kw))(
        jnp.asarray(img), jnp.asarray(depth), jnp.asarray(tris),
        jnp.asarray(cols))
    got_img, got_dep = extra_geometry_pass(
        torch.as_tensor(img), torch.as_tensor(depth), {"view_proj": vp},
        torch.as_tensor(tris), torch.as_tensor(cols), **kw)
    clip = project_triangles({"view_proj": vp}, torch.as_tensor(tris))
    np.testing.assert_allclose(
        clip.numpy(), np.asarray(jax_project({"view_proj": jnp.asarray(vp)},
                                             jnp.asarray(tris))),
        rtol=1e-6, atol=1e-6)
    got_img, want_img = got_img.numpy(), np.asarray(want_img)
    off = np.abs(got_img - want_img).max(axis=-1) > 1e-5
    assert (np.abs(got_img - img).max(axis=-1) > 1e-3).mean() > 0.05
    on_edge = _edge_distance(clip.numpy(), H, W) < 1e-3
    assert not (off & ~on_edge).any(), int((off & ~on_edge).sum())
    assert off.mean() < 0.005
    if depth_write:
        # the written z interpolates by edge values over their sum: the
        # edge constants are products of screen coordinates (~W*H), so on
        # a small triangle the two roundings part by ~1e-5 of z
        np.testing.assert_allclose(got_dep.numpy(), np.asarray(want_dep),
                                   atol=1e-4)
        assert (got_dep.numpy() < depth).any()
    else:
        np.testing.assert_array_equal(got_dep.numpy(), depth)


# ---- the port's hook points in every frame ----------------------------------

def _counting_hooks(calls, opaque_stage=True):
    """A full RenderHooks whose every point counts its calls and changes
    nothing (first_pass / after_geometry left out with opaque_stage
    False)."""
    from awsm_renderer_tpu_torch.passes.frame import RenderHooks

    def count(name, out=None):
        def fn(*args):
            calls[name] = calls.get(name, 0) + 1
            return args[out] if out is not None else None
        return fn

    return RenderHooks(
        pre_render=count("pre_render"), post_render=count("post_render"),
        first_pass=count("first_pass", 0) if opaque_stage else None,
        after_geometry=count("after_geometry", 0) if opaque_stage else None,
        before_transparent=count("before_transparent", 0),
        after_transparent=count("after_transparent", 0),
        last_pass=count("last_pass", 0))


@pytest.mark.parametrize("mode", ["ordinary", "msaa", "supersample",
                                  "temporal", "overlay"])
def test_every_hook_point_fires_in_every_frame(mode):
    """Each hook point fires once a frame and identity hooks change
    nothing: the ordinary, MSAA (compacted without the hook), supersample
    and temporal frames, and a frame with transparent and HUD content."""
    import awsm_renderer_tpu_torch as P

    aa = {"msaa": dict(msaa=True), "supersample": dict(supersample=True),
          "temporal": dict(temporal=True)}.get(mode, {})
    from awsm_renderer_tpu_torch.geometry import box

    scene = "alpha-blend" if mode == "overlay" else "box"
    r = T.torch_renderer(scene, anti_aliasing=P.AntiAliasing(**aa))
    if mode == "overlay":
        r.add_mesh(box(0.2), r.materials.insert(P.UnlitMaterial(
            base_color_factor=np.array([0.1, 0.9, 0.2, 1], F))),
            transform=P.Transform(translation=np.array([0, 0.5, 1.5], F)),
            hud=True)
    r.render()
    base = r.render()
    r2 = T.torch_renderer(scene, anti_aliasing=P.AntiAliasing(**aa))
    if mode == "overlay":
        r2.add_mesh(box(0.2), r2.materials.insert(P.UnlitMaterial(
            base_color_factor=np.array([0.1, 0.9, 0.2, 1], F))),
            transform=P.Transform(translation=np.array([0, 0.5, 1.5], F)),
            hud=True)
    r2.render()
    calls = {}
    img = r2.render(hooks=_counting_hooks(calls, mode != "temporal"))
    names = {"pre_render", "post_render", "before_transparent",
             "after_transparent", "last_pass"}
    if mode != "temporal":
        names |= {"first_pass", "after_geometry"}
    assert calls == {n: 1 for n in names}
    np.testing.assert_allclose(img, base, atol=1e-6)
    if mode == "temporal":
        assert r2._temporal is not None        # overlay hooks keep it


def test_first_pass_edits_stay_in_their_frame():
    """The hook's ds is a copy: an entry it sets, or one it sets in the
    camera dict, is gone next frame (the renderer keeps its ds across
    frames)."""
    from awsm_renderer_tpu_torch.passes.frame import RenderHooks

    r = T.torch_renderer("box")
    base = r.render()
    half = torch.diag(torch.tensor([0.5, 0.5, 0.5, 1.0]))

    def scale_world(ds):
        ds["world"] = ds["world"] @ half
        return ds

    def squeeze_view(ds):
        vp = ds["camera"]["view_proj"].copy()
        vp[0] *= 0.5
        ds["camera"]["view_proj"] = vp
        return ds

    for fn in (scale_world, squeeze_view):
        hooked = r.render(hooks=RenderHooks(first_pass=fn))
        assert np.abs(hooked - base).max() > 0.1
        np.testing.assert_array_equal(r.render(), base)


def test_temporal_frame_falls_back_for_opaque_stage_hooks():
    """first_pass / after_geometry send a temporal renderer's frame to the
    ordinary one (JAX renderer.py:970-975): equal to the ordinary
    renderer's frame with the same hook; the history resets."""
    import awsm_renderer_tpu_torch as P
    from awsm_renderer_tpu_torch.passes.frame import RenderHooks

    def after_geometry(vis, ds):
        out = dict(vis)
        out["normal_y"] = vis["normal_y"] * -1.0
        return out

    hooks = RenderHooks(after_geometry=after_geometry)
    rt = T.torch_renderer("box", anti_aliasing=P.AntiAliasing(temporal=True))
    rt.render()
    assert rt._temporal is not None
    img = rt.render(hooks=hooks)
    assert rt._temporal is None
    want = T.torch_renderer("box").render(hooks=hooks)
    np.testing.assert_array_equal(img, want)
    assert np.abs(img - rt.render()).max() > 0.01


def test_pick_replays_in_frame_hooks_only():
    """pick() after a camera move re-renders with the last frame's
    in-frame hooks (an after_geometry hook that clears the left half:
    picks there find nothing) and without its host hooks."""
    from awsm_renderer_tpu_torch.passes.frame import RenderHooks

    calls = {"pre": 0, "post": 0, "geo": 0}

    def after_geometry(vis, ds):
        calls["geo"] += 1
        out = dict(vis)
        W = vis["tri_id"].shape[1]
        out["tri_id"] = vis["tri_id"].clone()
        out["tri_id"][:, :W // 2] = -1
        out["depth"] = vis["depth"].clone()
        out["depth"][:, :W // 2] = 1.0
        return out

    hooks = RenderHooks(
        pre_render=lambda r: calls.__setitem__("pre", calls["pre"] + 1),
        post_render=lambda r: calls.__setitem__("post", calls["post"] + 1),
        after_geometry=after_geometry)
    from awsm_renderer_tpu_torch.utils import math3d as m3

    r, plain = T.torch_renderer("box"), T.torch_renderer("box")
    r.render(hooks=hooks)
    x_l, x_r, y = T.W // 2 - 6, T.W // 2 + 6, T.H // 2
    assert r.pick(x_l, y) is None and r.pick(x_r, y) is not None
    view = m3.look_at((2.3, 1.9, 3.6), (0, 0, 0), (0, 1, 0))
    for rr in (r, plain):
        rr.camera.update(view, rr.camera.projection)
    assert calls == {"pre": 1, "post": 1, "geo": 1}
    assert r.pick(x_l, y) is None and plain.pick(x_l, y) is not None
    assert calls == {"pre": 1, "post": 1, "geo": 2}
    assert r.pick(x_r, y) == plain.pick(x_r, y) is not None
    assert dataclasses.is_dataclass(r._last_hooks)
    assert r._last_hooks.pre_render is None
