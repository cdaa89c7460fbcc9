"""Shared fixtures for the PyTorch-port parity tests (tests/test_torch_*.py):
the same probe scene built into the JAX renderer and into the port, at the
128x64 size the JAX suite uses, and the JAX side's flushed device state as
numpy (bf16 as uint16 bit patterns)."""

from __future__ import annotations

import numpy as np

W, H = 128, 64


def camera(scene_info):
    from awsm_renderer_tpu.utils import math3d as m3

    eye, center = (scene_info or {}).get("camera",
                                         ((2.5, 1.8, 3.5), (0, 0, 0)))
    return (m3.look_at(eye, center, (0, 1, 0)),
            m3.perspective(np.pi / 3, W / H, 0.05, 500.0))


def build(renderer, scene: str):
    """Populate `renderer` with demo scene `scene` and the golden-test
    camera (tests/test_golden.py), advancing animations by 0.35 s."""
    from demo.scenes import SCENES

    view, proj = camera(SCENES[scene](renderer))
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
