"""Shared fixtures for the PyTorch-port parity tests (tests/test_torch_*.py):
the same probe scene built into the JAX renderer and into the port, at the
128x64 size the JAX suite uses, and the JAX side's flushed device state as
numpy (bf16 as uint16 bit patterns)."""

from __future__ import annotations

import os

import numpy as np
import torch

W, H = 128, 64


def _share_cores():
    """Under pytest-xdist, give torch's intra-op pool each worker's share
    of the cores (rounded up). By default every worker takes every core,
    and its spinning threads stall one another: on an 8-core host kept
    busy by six other processes, the 512x256 golden renders of
    tests/test_torch_overlay.py took 65-91 s each with 8 threads and
    1.2-1.3 s with 2."""
    n = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0"))
    if n > 1:
        torch.set_num_threads(max(1, -(-(os.cpu_count() or 1) // n)))


_share_cores()


def camera(scene_info):
    from awsm_renderer_tpu.utils import math3d as m3

    eye, center = (scene_info or {}).get("camera",
                                         ((2.5, 1.8, 3.5), (0, 0, 0)))
    return (m3.look_at(eye, center, (0, 1, 0)),
            m3.perspective(np.pi / 3, W / H, 0.05, 500.0))


# demo/scenes.py's animation classes: a port renderer's players must be
# the port's own (its sampler and channel code compare the port's enums)
_ANIMATION = ("AnimationChannel", "AnimationClip", "AnimationPlayer",
              "AnimationSampler", "TargetPath")


def build(renderer, scene: str):
    """Populate `renderer` with demo scene `scene` and the golden-test
    camera (tests/test_golden.py), advancing animations by 0.35 s. For a
    port renderer the scene is built with the port's animation classes
    in place of the JAX package's."""
    from demo import scenes

    saved = {n: getattr(scenes, n) for n in _ANIMATION}
    if type(renderer).__module__.startswith("awsm_renderer_tpu_torch"):
        from awsm_renderer_tpu_torch.core import animation

        for n in _ANIMATION:
            setattr(scenes, n, getattr(animation, n))
    try:
        info = scenes.SCENES[scene](renderer)
    finally:
        for n, v in saved.items():
            setattr(scenes, n, v)
    view, proj = camera(info)
    renderer.update_all(0.35, view, proj)
    return renderer


def jax_renderer(scene: str, **cfg):
    from awsm_renderer_tpu import AwsmRendererTpu, RendererConfig

    return build(AwsmRendererTpu(RendererConfig(width=W, height=H, **cfg)),
                 scene)


def torch_renderer(scene: str, **cfg):
    import awsm_renderer_tpu_torch as P

    return build(P.AwsmRendererTorch(
        P.RendererConfig(width=W, height=H, **cfg), device="cpu"), scene)


def to_numpy(x):
    """jax array / torch tensor / nested camera dict -> numpy; bf16 ->
    uint16 bit patterns."""
    if isinstance(x, dict):
        return {k: to_numpy(v) for k, v in x.items()}
    if hasattr(x, "detach"):                    # torch
        import torch

        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).cpu().numpy().view(np.uint16)
        return x.cpu().numpy()
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16)
    return a


def gltf_scene(renderer, name: str, image_env: bool = False):
    """Populate `renderer` (either package's) with glTF catalog entry
    `name` through its own load_gltf + populate_gltf, with the catalog's
    camera; image_env adds demo/scenes.py's env-ibl equirect."""
    import importlib
    import os
    import tempfile

    pkg = type(renderer).__module__.split(".")[0]
    samples = importlib.import_module(f"{pkg}.gltf.samples")
    loader = importlib.import_module(f"{pkg}.gltf.loader")
    populate = importlib.import_module(f"{pkg}.gltf.populate")
    m3 = importlib.import_module(f"{pkg}.utils.math3d")
    glb, (eye, center) = samples.SAMPLES[name]()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, f"{name}.glb")
        with open(path, "wb") as f:
            f.write(glb)
        populate.populate_gltf(renderer, loader.load_gltf(path))
    if image_env:
        renderer.environment.set_environment_from_equirect(env_equirect(),
                                                           size=32)
    w, h = renderer.config.width, renderer.config.height
    renderer.update_all(0.35, m3.look_at(eye, center, (0, 1, 0)),
                        m3.perspective(np.pi / 3, w / h, 0.05, 100.0))
    return renderer


def env_equirect():
    """demo/scenes.py scene_env_ibl's procedural equirect."""
    eq = np.zeros((32, 64, 3), np.float32)
    v = np.linspace(0, 1, 32)[:, None]
    eq[..., 0] = 0.2 + 0.8 * v
    eq[..., 1] = 0.3 + 0.25 * v
    eq[..., 2] = 1.0 - 0.8 * v
    return eq


GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")


def golden_renderer(width=128, height=64, **cfg):
    """tests/test_parity_golden.py _base_renderer on the port: the effect
    goldens' camera at [0, 0.6, 3] looking at the origin."""
    import awsm_renderer_tpu_torch as P
    from awsm_renderer_tpu_torch.utils import math3d as m3

    r = P.AwsmRendererTorch(P.RendererConfig(width=width, height=height,
                                             **cfg), device="cpu")
    r.camera.update(m3.look_at([0, 0.6, 3.0], [0, 0, 0], [0, 1, 0]),
                    m3.perspective(np.pi / 3, width / height, 0.1, 100.0))
    return r


def hold_tight(name, img):
    """tests/test_parity_golden.py _check_tight, read-only: mean |diff| <=
    1/255 and <= 0.3% of channel values off by more than 2/255."""
    from PIL import Image

    golden = np.asarray(Image.open(os.path.join(GOLDEN_DIR, f"{name}.png")))
    assert golden.shape == img.shape
    diff = np.abs(golden.astype(np.int16) - img.astype(np.int16))
    assert diff.mean() <= 1.0, f"{name}: mean diff {diff.mean():.3f}"
    frac = (diff > 2).mean()
    assert frac <= 0.003, f"{name}: {frac:.3%} off by > 2/255"
