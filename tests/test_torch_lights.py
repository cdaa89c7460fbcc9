"""PyTorch port, tiled light lists (M12): passes/light_culling.py, the
tiled punctual loop, the lists in every shade layout, and the frames
that run them, against the JAX renderer.

Light lists are integer outputs and are held bit-equal: `valid` equal,
and the listed light rows equal wherever valid (slots past a unit's
count are padding). The reference's `jax.lax.top_k` lists the lower
index first among equal scores; the port's stable descending sort must
match it in the cases that make ties (equal directional lights, empty
units) and under overflow (more than MAX_LIGHTS_PER_TILE lights reach a
unit). The tiled loop's planes are held to rtol 1e-4 against jitted JAX:
the port sums the same factors in the same order, but XLA:CPU fuses the
16-slot loop and contracts products and sums into FMAs (2.4e-5 relative
observed on seeded planes). Frames are held to
tests/test_torch_frame.py's tolerance (< 0.5% of channel values off by
more than 4/255; tri_id planes agree on 99.5% of pixels), the port's
tiled frame against its own dense one at the JAX suite's 1e-6
(tests/test_hooks_lightcull.py).

The JAX frames (ordinary, MSAA with a forced opaque tile cap over 24
lights that overflow every unit, the temporal reset frame, the
compacted overlay) and a jitted transparent shade (band-wide and with a
tile cap) run side by side in threads; each logs the lists its shades
built through a jax.debug.callback on light_lists_from_bounds, keyed by
the scene's light count."""

import dataclasses
import importlib
import threading

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


def _renderer(jax_side: bool, device="cpu", **cfg):
    m = _pkg(jax_side)
    cfg.setdefault("post_processing", m.PostProcessing(
        tonemapping=m.ToneMapping.NONE))
    config = m.RendererConfig(width=T.W, height=T.H, **cfg)
    if jax_side:
        return m.AwsmRendererTpu(config)
    return m.AwsmRendererTorch(config, device=device)


def _ring(r, m, n_lights, ranged=True, radius=2.0, light_range=2.5):
    """tests/test_hooks_lightcull.py TestTiledLights's lights: one
    directional light and n_lights - 1 point lights on a ring."""
    r.lights.insert(m.Light.directional([-0.3, -1, -0.4], intensity=1.5))
    rng = np.random.default_rng(3)
    for i in range(n_lights - 1):
        a = 2 * np.pi * i / max(n_lights - 1, 1)
        r.lights.insert(m.Light.point(
            [np.cos(a) * radius, 0.6, np.sin(a) * radius + 1.0],
            color=tuple(rng.uniform(0.3, 1.0, 3)), intensity=3.0,
            range=(light_range if ranged else 0.0)))


def _scene(jax_side: bool, n_lights: int, overlay: str | None = None,
           radius=2.0, light_range=2.5, device="cpu", **cfg):
    """TestTiledLights's scene (three PBR boxes, the ring of lights);
    overlay "layers" adds two overlapping blended boxes and a PBR HUD box
    (a band-wide peel of two layers), "compact" one small blended box."""
    m = _pkg(jax_side)
    geometry = importlib.import_module(f"{m.__name__}.geometry")
    m3 = importlib.import_module(f"{m.__name__}.utils.math3d")
    r = _renderer(jax_side, device, **cfg)
    mat = r.materials.insert(m.PbrMaterial(
        base_color_factor=np.array([0.8, 0.7, 0.6, 1.0], F),
        roughness_factor=0.5))
    for gx in (-1.0, 0.0, 1.0):
        r.add_mesh(geometry.box(0.8), mat, m.Transform(
            translation=np.array([gx * 1.2, 0, 0], F)))
    if overlay is not None:
        glass = r.materials.insert(m.PbrMaterial(
            base_color_factor=np.array([0.5, 0.7, 0.9, 0.5], F),
            alpha_mode=m.AlphaMode.BLEND, roughness_factor=0.3))
        at = ([(-0.3, 0.1, 0.9), (0.2, 0.0, 1.3)] if overlay == "layers"
              else [(0.9, 0.45, 1.2)])
        for p in at:
            r.add_mesh(geometry.box(0.5 if overlay == "layers" else 0.25),
                       glass, m.Transform(translation=np.array(p, F)))
        if overlay == "hud":
            r.add_mesh(geometry.box(0.3), mat, m.Transform(
                translation=np.array([-1.2, 0.8, 1.5], F)), hud=True)
    _ring(r, m, n_lights, radius=radius, light_range=light_range)
    r.camera.update(m3.look_at([0, 0.6, 3.0], [0, 0, 0], [0, 1, 0]),
                    m3.perspective(np.pi / 3, T.W / T.H, 0.1, 50.0))
    return r


def _forced_caps(mp, cls):
    """Give renderers of class `cls` the tile caps in their attribute
    `forced_caps` ({bucket: cap}; the host bounds decline at 128x64:
    their 64-unit steps exceed the frame)."""
    orig = cls._bucket_tile_cap

    def patched(self, masks, bucket, **kw):
        cap = getattr(self, "forced_caps", {}).get(bucket)
        return orig(self, masks, bucket, **kw) if cap is None else cap

    mp.setattr(cls, "_bucket_tile_cap", patched)


# the JAX frames; each scene's light count keys the lists its shades log
FRAMES = {
    "band": dict(n_lights=12),
    # more than MAX_LIGHTS_PER_TILE lights reach every unit
    "msaa": dict(n_lights=24, radius=1.2, light_range=8.0,
                 anti_aliasing="msaa"),
    # at most 8 lights, tiled by the config: 8 list slots, a cheaper
    # JAX compile than 16
    "temporal": dict(n_lights=7, anti_aliasing="temporal",
                     light_tiles=True),
    "compact32": dict(n_lights=6, overlay="compact", light_tiles=True),
}
CAPS = {"msaa": dict(opaque=4), "compact32": dict(transparent=2)}
LAYERS_LIGHTS = 8       # the direct transparent shades' scene


def _frame_scene(jax_side: bool, name: str):
    kw = dict(FRAMES[name])
    aa = kw.pop("anti_aliasing", None)
    if aa is not None:
        kw["anti_aliasing"] = _pkg(jax_side).AntiAliasing(**{aa: True})
    r = _scene(jax_side, **kw)
    r.forced_caps = CAPS.get(name, {})
    return r


def _layers_inputs():
    """The transparent shade's inputs on the JAX renderer's flushed
    "layers" scene: (JAX device dict, the port's copy, two band-wide peels
    from the port's twin, the covered (8, 128) tiles of peel 0, a seeded
    opaque background, the shade specialization)."""
    from awsm_renderer_tpu_torch import device_scene_from_jax
    from awsm_renderer_tpu_torch.ops.raster import rasterize_layers_rows
    from awsm_renderer_tpu_torch.passes.frame import _run_vertex

    rj = _scene(True, LAYERS_LIGHTS, overlay="layers")
    dj = rj._flush()
    ds = device_scene_from_jax(T.to_numpy(dict(dj)), "cpu")
    masks = rj._mesh_masks()
    rows = rj._bucket_mat_rows(masks["transparent"])
    t_rows = _run_vertex(
        ds, torch.as_tensor(masks["transparent"]), rw=T.W, rh_full=T.H,
        needs_clip=masks["needs_clip"], pad=True)
    layers = rasterize_layers_rows(t_rows, torch.ones((T.H, T.W)),
                                   width=T.W, height=T.H, n_layers=2,
                                   has_uv1=False, has_color=False,
                                   analytic_derivs=False)
    tid0 = layers["tri_id"][0].reshape(T.H // 8, 8, 1, 128)
    n_cov = int((tid0 >= 0).any(dim=(1, 3)).sum())
    rng = np.random.default_rng(4)
    opaque = [torch.as_tensor(rng.uniform(0, 1, T.H * T.W).astype(F))
              for _ in range(3)] + [torch.ones(T.H * T.W)]
    spec = dict(use_mips=True, slot_mask=rj._slot_mask(rows), solid_env=True,
                has_nearest=False, ext=rj._ext_mask(rows))
    return dj, ds, layers, n_cov, opaque, spec


LAYERS_GEOM = dict(width=T.W, height=T.H, n_layers=2)


def _port_layers(inputs, tile_cap=None, light_tiles=False):
    """The port's shade_transparent_layers_c on the "layers" inputs."""
    from awsm_renderer_tpu_torch.ops.shade import (
        ShadeSpec, shade_transparent_layers_c,
    )

    _dj, ds, layers, _n_cov, opaque, spec = inputs
    return shade_transparent_layers_c(
        layers, opaque, ds, ShadeSpec(**spec, light_tiles=light_tiles),
        tile_cap=tile_cap, **LAYERS_GEOM)


def _jax_layers(inputs):
    """JAX's shade_transparent_layers_c with tiled lights, band-wide (the
    stacked layers) and with the tile cap (_shade_transparent_compact)."""
    from awsm_renderer_tpu.ops.shade import shade_transparent_layers_c

    dj, _ds, layers, n_cov, opaque, spec = inputs
    fn = jax.jit(shade_transparent_layers_c, static_argnames=(
        "width", "height", "use_mips", "slot_mask", "solid_env",
        "has_nearest", "ext", "n_layers", "tile_cap", "light_tiles"))
    args = ({k: jnp.asarray(v.numpy()) for k, v in layers.items()},
            [jnp.asarray(c.numpy()) for c in opaque], dj)
    return {cap: [np.asarray(c) for c in fn(*args, tile_cap=cap,
                                            light_tiles=True, **spec,
                                            **LAYERS_GEOM)]
            for cap in (None, n_cov)}


@pytest.fixture(scope="module")
def jax_side():
    """Every JAX result of the module, computed in threads started
    together: the frames {name: (renderer, image, tri_id)} ("band+4": the
    band renderer after four far lights, whose light capacity stays 16,
    so it compiles nothing new), the direct transparent shades {tile cap:
    rgba planes}, and the lists every shade built {name: [(lidx, valid)
    per call, in order]} ("layers": the band-wide call's, then the
    compacted call's)."""
    from concurrent.futures import ThreadPoolExecutor

    import awsm_renderer_tpu as J
    from awsm_renderer_tpu.passes import light_culling as LC

    lists, lock = {}, threading.Lock()
    orig = LC.light_lists_from_bounds

    def log(n, lidx, valid):
        with lock:
            lists.setdefault(int(n), []).append(
                (np.asarray(lidx), np.asarray(valid)))

    def logged(mn, mx, lights, n_lights, K):
        lidx, valid = orig(mn, mx, lights, n_lights, K)
        jax.debug.callback(log, n_lights, lidx, valid, ordered=True)
        return lidx, valid

    def run(name, r):
        out = {name: (r, r.render(), np.asarray(r._last_tri_id))}
        if name == "band":
            for i in range(4):
                r.lights.insert(J.Light.point([100.0 + i, 50.0, 100.0],
                                              intensity=50.0, range=3.0))
            out["band+4"] = (r, r.render(), np.asarray(r._last_tri_id))
        return out

    scenes = {n: _frame_scene(True, n) for n in FRAMES}
    inputs = _layers_inputs()
    jax.clear_caches()      # compile anew, with the callback traced in
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(LC, "light_lists_from_bounds", logged)
            _forced_caps(mp, J.AwsmRendererTpu)
            with ThreadPoolExecutor(len(scenes) + 1) as ex:
                futs = [ex.submit(run, n, r) for n, r in scenes.items()]
                shaded = ex.submit(_jax_layers, inputs)
                frames = {}
                for f in futs:
                    frames.update(f.result())
                shaded = shaded.result()
    finally:
        jax.clear_caches()
    by_name = {n: lists.get(FRAMES[n]["n_lights"], []) for n in FRAMES}
    by_name["layers"] = lists.get(LAYERS_LIGHTS, [])
    return frames, shaded, inputs, by_name


def _port_frame(name: str, monkeypatch, log=None):
    """The port's frame `name` (its tile caps forced as JAX's), logging
    the lists its shades build into `log`."""
    import awsm_renderer_tpu_torch as P

    _forced_caps(monkeypatch, P.AwsmRendererTorch)
    if log is not None:
        _log_port_lists(monkeypatch, log)
    r = _frame_scene(False, name)
    return r, r.render(), r._last_tri_id.numpy()


def _log_port_lists(monkeypatch, log):
    from awsm_renderer_tpu_torch.passes import light_culling as LC

    orig = LC.light_lists_from_bounds

    def logged(*args):
        out = orig(*args)
        log.append(tuple(t.numpy() for t in out))
        return out

    monkeypatch.setattr(LC, "light_lists_from_bounds", logged)


def _hold_lists(got, want):
    assert len(got) == len(want) > 0, (len(got), len(want))
    for (gi, gv), (wi, wv) in zip(got, want):
        assert gi.shape == wi.shape
        np.testing.assert_array_equal(gv, wv)
        np.testing.assert_array_equal(np.where(gv, gi, -1),
                                      np.where(wv, wi, -1))


def _hold_frame(lt, lj, tt, tj):
    assert lt.shape == lj.shape == (T.H, T.W, 4)
    assert np.isfinite(lt).all()
    diff = np.abs(np.round(lt * 255) - np.round(lj * 255))
    assert (diff > 4).mean() < 0.005, (diff > 4).mean()
    assert (tj >= 0).sum() > 200
    assert (tt != tj).mean() < 0.005


# ---- light_lists_from_bounds and cull_lights -------------------------------

def _bounds_case(case: str):
    """Seeded unit boxes and light rows: (mn, mx, rows, n_lights, K)."""
    from awsm_renderer_tpu_torch.core.lights import Light

    rng = np.random.default_rng({"ties": 5, "overflow": 6}[case])
    n_units = 96
    lo = rng.uniform(-4, 4, (3, n_units)).astype(F)
    hi = (lo + rng.uniform(0, 1.5, (3, n_units))).astype(F)
    lo[:, :8], hi[:, :8] = 3e38, -3e38          # empty units
    rows = []
    if case == "ties":
        # equal directional lights tie in every unit; an unlimited-range
        # point light is always on; equal point lights at one position
        rows += [Light.directional([0, -1, 0], intensity=2.0).pack()] * 3
        rows.append(Light.point([0, 0, 0], intensity=2.0).pack())
        for _ in range(2):
            rows.append(Light.point([1.0, 0.5, -1.0], intensity=3.0,
                                    range=2.0).pack())
        for p in rng.uniform(-4, 4, (10, 3)):
            rows.append(Light.point(p, intensity=float(rng.uniform(1, 5)),
                                    range=float(rng.uniform(0.5, 3))).pack())
        n_live = len(rows) - 2                  # two rows past the count
    else:
        for p in rng.uniform(-2, 2, (40, 3)):
            rows.append(Light.point(p, intensity=float(rng.uniform(1, 5)),
                                    range=6.0).pack())
        rows.insert(7, Light.spot([0, 2, 0], [0, -1, 0], intensity=4.0,
                                  range=8.0).pack())
        n_live = len(rows)
    rows = np.stack(rows).astype(F)
    cap = max(8, 1 << (len(rows) - 1).bit_length())
    table = np.zeros((cap, rows.shape[1]), F)
    table[:len(rows)] = rows
    return lo, hi, table, n_live, min(16, cap)


@pytest.mark.parametrize("case", ["ties", "overflow"])
def test_light_lists_bit_equal_to_jax(case):
    from awsm_renderer_tpu.passes.light_culling import (
        light_lists_from_bounds as jax_lists,
    )
    from awsm_renderer_tpu_torch.passes.light_culling import (
        light_lists_from_bounds,
    )

    lo, hi, table, n, K = _bounds_case(case)
    wi, wv = jax.jit(jax_lists, static_argnums=4)(
        [jnp.asarray(a) for a in lo], [jnp.asarray(a) for a in hi],
        jnp.asarray(table), jnp.int32(n), K)
    gi, gv = light_lists_from_bounds([torch.as_tensor(a) for a in lo],
                                     [torch.as_tensor(a) for a in hi],
                                     torch.as_tensor(table), n, K)
    _hold_lists([(gi.numpy(), gv.numpy())], [(np.asarray(wi),
                                               np.asarray(wv))])
    counts = gv.numpy().sum(axis=1)
    if case == "ties":
        # the empty units list exactly the always-on lights, lowest first
        np.testing.assert_array_equal(gi.numpy()[:8, :4],
                                      np.tile([0, 1, 2, 3], (8, 1)))
        assert (counts[:8] == 4).all()
    else:
        assert (counts == K).sum() > 40         # units that overflow


def test_cull_lights_bit_equal_to_jax():
    from awsm_renderer_tpu.passes.light_culling import (
        cull_lights as jax_cull,
    )
    from awsm_renderer_tpu_torch.passes.light_culling import cull_lights
    from awsm_renderer_tpu_torch.utils import math3d as m3

    lo, hi, table, n, K = _bounds_case("overflow")
    view = m3.look_at([0, 1, 5], [0, 0, 0], [0, 1, 0])
    proj = m3.perspective(np.pi / 3, T.W / T.H, 0.1, 100.0)
    ivp = np.linalg.inv((proj @ view).astype(F)).astype(F)
    rng = np.random.default_rng(8)
    depth = rng.uniform(0.9, 0.999, (T.H, T.W)).astype(F)
    depth[:, :40] = 1.0                                # uncovered pixels
    for th, tw in ((8, 128), (1, 128)):
        wl, wc = jax.jit(jax_cull, static_argnames=(
            "width", "height", "tile_h", "tile_w"))(
            jnp.asarray(table), jnp.int32(n), jnp.asarray(depth),
            {"inv_view_proj": jnp.asarray(ivp)}, width=T.W, height=T.H,
            tile_h=th, tile_w=tw)
        gl, gc = cull_lights(torch.as_tensor(table), n,
                             torch.as_tensor(depth), {"inv_view_proj": ivp},
                             width=T.W, height=T.H, tile_h=th, tile_w=tw)
        wc, gc = np.asarray(wc), gc.numpy()
        np.testing.assert_array_equal(gc, wc)
        slot = np.arange(gl.shape[1])[None, :] < gc[:, None]
        np.testing.assert_array_equal(np.where(slot, gl.numpy(), -1),
                                      np.where(slot, np.asarray(wl), -1))


def test_punctual_tiled_matches_jax():
    """The tiled loop on seeded planes (positions inside the lights'
    reach, a `valid` mask leaving misses out of the unit boxes) against
    JAX's, rtol 1e-4 / atol 1e-6 of the planes' scale."""
    from awsm_renderer_tpu.ops.shade import (
        _punctual_lights_tiled as jax_tiled,
    )
    from awsm_renderer_tpu_torch.ops.shade import _punctual_lights_tiled

    _lo, _hi, table, n, _K = _bounds_case("overflow")
    rng = np.random.default_rng(11)
    P = 16 * 128

    def unit(v):
        return (v / np.linalg.norm(v, axis=0, keepdims=True)).astype(F)

    pos = rng.uniform(-2, 2, (3, P)).astype(F)
    nrm = unit(rng.normal(size=(3, P)))
    view = unit(rng.normal(size=(3, P)) + 2 * nrm)
    bd = rng.uniform(0, 1, (3, P)).astype(F)
    f0 = rng.uniform(0.02, 0.9, (3, P)).astype(F)
    ar = rng.uniform(0.05, 1, P).astype(F)
    valid = rng.uniform(size=P) > 0.2
    pos[:, ~valid] = 50.0                     # far-plane misses
    want = jax.jit(jax_tiled)({"lights": jnp.asarray(table), "n_lights":
                      jnp.int32(n)}, *[[jnp.asarray(c) for c in a]
                                       for a in (pos, nrm, view, bd, f0)],
                     jnp.asarray(ar), valid=jnp.asarray(valid))
    got = _punctual_lights_tiled(
        {"lights": torch.as_tensor(table), "n_lights": n},
        *[[torch.as_tensor(c) for c in a] for a in (pos, nrm, view, bd, f0)],
        torch.as_tensor(ar), torch.as_tensor(valid))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(w).max() > 0.1
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-6 * np.abs(w).max())


# ---- the lists in every shade layout, and the frames -----------------------

@pytest.mark.parametrize("name", list(FRAMES) + ["layers"])
def test_lists_bit_equal_in_every_layout(jax_side, monkeypatch, name):
    """Each shade builds the same lists as JAX's, call for call: band
    rows (the ordinary frame), the (8, 128) units of the compacted MSAA
    and temporal shades, the 4-row groups of 32x32 blocks (compact32),
    the stacked layers of the band-wide peel and the (8, 128) tiles of
    the compacted one (layers)."""
    _frames, _shaded, inputs, lists = jax_side
    log = []
    if name == "layers":
        n_cov = inputs[3]
        _log_port_lists(monkeypatch, log)
        for cap in (None, n_cov):
            _port_layers(inputs, tile_cap=cap, light_tiles=True)
    else:
        _port_frame(name, monkeypatch, log)
    _hold_lists(log, lists[name])
    units = [l.shape[0] for l, _ in log]
    if name == "msaa":
        assert units == [4 * 8]                       # 4 (8, 128) units
        assert log[0][1].all(axis=1).sum() > 16       # overflowing units
    elif name == "compact32":
        assert units[-1] == 2 * 8                     # 2 32x32 blocks
    elif name == "layers":
        assert units == [2 * T.H, 2 * 8 * n_cov]      # 2 stacked layers


@pytest.mark.parametrize("name", list(FRAMES) + ["band+4"])
def test_tiled_frame_matches_jax(jax_side, monkeypatch, name):
    """The tiled frames against JAX's: the ordinary frame (12 lights, and
    12 + 4 out of reach), MSAA over 24 lights that overflow every unit,
    the temporal reset frame and the compacted transparent overlay."""
    frames = jax_side[0]
    _rj, lj, tj = frames[name]
    rt, lt, tt = _port_frame("band" if name == "band+4" else name,
                             monkeypatch)
    if name == "band+4":
        import awsm_renderer_tpu_torch as P

        for i in range(4):
            rt.lights.insert(P.Light.point([100.0 + i, 50.0, 100.0],
                                           intensity=50.0, range=3.0))
        lt, tt = rt.render(), rt._last_tri_id.numpy()
    _hold_frame(lt, lj, tt, tj)


def test_tiled_equals_dense_in_the_port():
    """<= MAX_LIGHTS_PER_TILE lights: the tiled frame equals the dense
    loop's to 1e-6, and lights out of every unit's reach change nothing
    (tests/test_hooks_lightcull.py TestTiledLights)."""
    import awsm_renderer_tpu_torch as P

    r = _scene(False, 12)
    tiled = r.render()
    r.config = dataclasses.replace(r.config, light_tiles=False)
    dense = r.render()
    np.testing.assert_allclose(tiled, dense, atol=1e-6)
    r.config = P.RendererConfig(width=T.W, height=T.H,
                                post_processing=r.config.post_processing,
                                light_tiles=True)
    np.testing.assert_array_equal(r.render(), tiled)
    for i in range(4):
        r.lights.insert(P.Light.point([100.0 + i, 50.0, 100.0],
                                      intensity=50.0, range=3.0))
    np.testing.assert_allclose(r.render(), tiled, atol=1e-6)


def test_light_tiles_rule():
    """Tiled above 8 lights; config.light_tiles overrides, either way;
    light_tiles=True at 3 lights equals the dense frame."""
    import awsm_renderer_tpu_torch as P
    from awsm_renderer_tpu_torch.passes import frame as TF

    seen = []
    orig = TF.render_frame

    def spy(*a, **kw):
        seen.append(kw["spec"].light_tiles)
        return orig(*a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr("awsm_renderer_tpu_torch.renderer.render_frame", spy)
        r = _scene(False, 3)
        dense = r.render()
        r.config = P.RendererConfig(width=T.W, height=T.H,
                                    post_processing=r.config.post_processing,
                                    light_tiles=True)
        np.testing.assert_allclose(r.render(), dense, atol=1e-6)
        r9 = _scene(False, 9)
        r9.render()
        r9.config = dataclasses.replace(r9.config, light_tiles=False)
        r9.render()
        r9.config = P.RendererConfig(width=T.W, height=T.H,
                                     light_tiles=False)
        r9.render()
    assert seen == [False, True, True, False, False]


def test_transparent_compact_matches_jax_and_band(jax_side):
    """shade_transparent_layers_c(tile_cap=...) (the (8, 128) compaction,
    _shade_transparent_compact; no frame path passes it): with the dense
    loop bit-equal to the port's band path on every pixel when the cap
    covers the tiles layer 0 touches; with tiled lists, band-wide and
    compacted, against jitted JAX's at rtol 1e-4, atol 1e-5: XLA's fused
    FMAs move a GGX specular peak by up to 4.7e-5 relative (3.6e-4 on a
    value of ~7.7 at 8 lights), as much as jitted JAX differs from eager
    JAX there; the port agrees with eager JAX to 2.4e-7."""
    _frames, shaded, inputs, _lists = jax_side
    n_cov, opaque = inputs[3], inputs[4]
    assert 0 < n_cov < 8
    band = _port_layers(inputs)
    comp = _port_layers(inputs, tile_cap=n_cov)
    for c in range(4):
        np.testing.assert_array_equal(comp[c].numpy(), band[c].numpy())
    assert float((band[0] - opaque[0]).abs().max()) > 0.05
    for cap in (None, n_cov):
        got = _port_layers(inputs, tile_cap=cap, light_tiles=True)
        for c in range(4):
            np.testing.assert_allclose(got[c].numpy(), shaded[cap][c],
                                       rtol=1e-4, atol=1e-5)
