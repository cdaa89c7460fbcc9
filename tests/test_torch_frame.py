"""PyTorch port, whole slice: render_u8() against the checked-in goldens,
one full frame against the JAX renderer's render() (textured, and under
debug views), and pick().

The goldens are held at tests/test_golden.py's tolerance (< 0.5% of
channel values off by more than 4/255). Against the JAX frame, the LDR
image must hold the same tolerance, and the tri_id planes must agree on
at least 99.5% of pixels: the JAX CPU frame rasterizes with the dense
kernel (every triangle in index order) under XLA's FMA-contracted edge
and depth planes, the port walks the binned near-first order with
separately rounded planes, so pixels on a shared edge (to within
rounding) or at exactly equal depth may pick the other triangle."""

import os

import numpy as np
import pytest

import _torch_port as T

GOLDENS = ("triangle", "box", "metal-rough-spheres", "env-ibl",
           "box-textured", "morph-cube", "rigged-simple", "instanced")
FRAMES = ("box", "metal-rough-spheres", "env-ibl", "box-textured")
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")


def _check(name, img):
    """tests/test_golden.py's comparison (read-only: the JAX renderer owns
    the goldens)."""
    from PIL import Image

    golden = np.asarray(Image.open(os.path.join(GOLDEN_DIR, f"{name}.png")))
    assert golden.shape == img.shape
    diff = np.abs(golden.astype(np.int16) - img.astype(np.int16))
    frac_off = (diff > 4).mean()
    assert frac_off < 0.005, (
        f"{name}: {frac_off:.2%} of channel values differ by >4/255 "
        f"(max diff {diff.max()})")


@pytest.mark.parametrize("scene", GOLDENS)
def test_port_matches_golden(scene):
    _check(scene, T.torch_renderer(scene).render_u8())


@pytest.fixture(scope="module")
def frames():
    """{scene: (JAX renderer, port renderer, JAX ldr, port ldr)}"""
    out = {}
    for scene in FRAMES:
        rj, rt = T.jax_renderer(scene), T.torch_renderer(scene)
        out[scene] = (rj, rt, rj.render(), rt.render())
    return out


@pytest.mark.parametrize("scene", FRAMES)
def test_frame_matches_jax_render(frames, scene):
    rj, rt, lj, lt = frames[scene]
    assert lt.shape == lj.shape == (T.H, T.W, 4)
    diff = np.abs(np.round(lt * 255) - np.round(lj * 255))
    assert (diff > 4).mean() < 0.005
    tj = np.asarray(rj._last_tri_id)
    tt = rt._last_tri_id.numpy()
    assert (tj >= 0).sum() > 200
    assert (tt != tj).mean() < 0.005
    np.testing.assert_array_equal(tt >= 0, lt[..., 3] > 0.5)


@pytest.mark.parametrize("scene", FRAMES)
def test_pick_agrees_with_jax(frames, scene):
    rj, rt, _, _ = frames[scene]
    tj = np.asarray(rj._last_tri_id)
    tt = rt._last_tri_id.numpy()
    hits = 0
    for y in range(1, T.H, 3):
        for x in range(2, T.W, 4):
            kj, kt = rj.pick(x, y), rt.pick(x, y)
            if tj[y, x] == tt[y, x]:
                assert kj == kt, (x, y)
            hits += kt is not None
    assert hits > 20
    assert rt.pick(-1, 0) is None and rt.pick(T.W, 0) is None


def test_pick_rerenders_after_a_camera_move():
    from awsm_renderer_tpu_torch.utils import math3d as m3

    r = T.torch_renderer("box")
    r.render_device()
    key = r.pick(T.W // 2, T.H // 2)
    assert key is not None
    # look away: the cached tri_id plane is stale, pick re-renders
    r.camera.update(m3.look_at([0, 0, 3], [0, 0, 10], [0, 1, 0]),
                    r.camera.projection)
    assert r.pick(T.W // 2, T.H // 2) is None


@pytest.mark.parametrize("mode", ["normals", "punctual",
                                  "channel:basecolor"])
def test_debug_view_matches_jax_render(mode):
    rj, rt = T.jax_renderer("box-textured"), T.torch_renderer("box-textured")
    lj = rj.render(debug_mode=mode)
    lt = rt.render(debug_mode=mode)
    diff = np.abs(np.round(lt * 255) - np.round(lj * 255))
    assert (diff > 4).mean() < 0.005
    assert np.abs(lt - rt.render()).max() > 0.05      # the view differs
