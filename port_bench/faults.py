"""Faults planted under the timed path, and the control, each a
wrap(renderer, scene) -> render entry that run.run_cell puts in the
program's place before the warm-up. control.py reads them at a cell's
own size through run_cell; tests/test_pb_faults.py sees `correct` come
out false for each at a test's size. The benchmark's runs use none."""

from __future__ import annotations

import dataclasses


def stale(r, scene):
    """A step that returns its state unchanged: the frame shows the image
    of the frame before."""
    last = {}

    def render():
        img = r.render_device()
        prev = last.get("img", img)
        last["img"] = img
        return prev
    return render


def altered(r, scene):
    """An answer altered where it is produced: one 32 x 32 block of the
    image inverted."""
    def render():
        img = r.render_device().clone()
        img[16:48, 16:48, :3] = 1.0 - img[16:48, 16:48, :3]
        return img
    return render


def half(r, scene):
    """Half of the batch left out: the lower half of the rows never
    rendered."""
    def render():
        img = r.render_device().clone()
        img[img.shape[0] // 2:] = 0.0
        return img
    return render


def panes_dropped(r, scene):
    """The transparent bucket left out: every blended mesh hidden."""
    for key, mesh in list(r.meshes.items()):
        if mesh.transparent:
            r.meshes.set_hidden(key, True)
    return r.render_device


def _post(r, **kw):
    r.set_post_processing(dataclasses.replace(r.config.post_processing, **kw))
    return r.render_device


def bloom_off(r, scene):
    return _post(r, bloom=False)


def dof_off(r, scene):
    return _post(r, dof=False)


def _aa(r, **kw):
    r.set_anti_aliasing(dataclasses.replace(r.config.anti_aliasing, **kw))
    return r.render_device


def msaa_off(r, scene):
    """One sample a pixel: no edge blend."""
    return _aa(r, msaa=False)


def mipmap_off(r, scene):
    """Texture taps from the base level alone."""
    return _aa(r, mipmap=False)


def control_bf16(r, scene):
    """The control: the plain reference computed in bfloat16, the next
    precision below the float32 the renderer computes in, rendering the
    program's camera in its place."""
    import torch

    from .reference.render import Reference

    ref = Reference(scene, r.device, torch.bfloat16)

    def render():
        return ref.render(r.camera.view, r.camera.projection)
    return render


WRAPS = {f.__name__: f for f in (stale, altered, half, panes_dropped,
                                 bloom_off, dof_off, msaa_off, mipmap_off,
                                 control_bf16)}
