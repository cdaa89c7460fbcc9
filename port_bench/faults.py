"""Faults planted under the timed path, and the control, each a
wrap(renderer, scene) -> render entry that run.run_cell puts in the
program's place before the warm-up; the control takes the run's
run.Frame too (the configuration's reference, and what the driver says
the frame being stepped shows). control.py reads them at a cell's own
size through run_cell; tests/test_pb_faults.py and tests/test_pb_edit.py
see `correct` come out false for each at a test's size. The benchmark's
runs use none."""

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


def _hidden_while_drawn(r, which):
    """The meshes which(key, mesh) picks, hidden for the frame's render
    and shown again after it: the session's pick, which renders again
    when the scene changed since the last frame, still finds them."""
    def render():
        keys = [k for k, m in list(r.meshes.items())
                if not m.hidden and which(k, m)]
        for k in keys:
            r.meshes.set_hidden(k, True)
        try:
            return r.render_device()
        finally:
            for k in keys:
                r.meshes.set_hidden(k, False)
    return render


def gizmo_hidden(r, scene):
    """The editor's gizmo left out of the image: the HUD meshes hidden
    while the frame is drawn."""
    return _hidden_while_drawn(r, lambda k, m: m.hud)


def grid_hidden(r, scene):
    """The editor's ground grid left out of the image."""
    from awsm_renderer_tpu_torch.core.materials import GridMaterial

    return _hidden_while_drawn(r, lambda k, m: isinstance(
        r.materials.get(m.material_key), GridMaterial))


def drag_dropped(r, scene):
    """The drag's transform edit dropped: a translation set through the
    transform store never lands, so the dragged mesh and its gizmo stay
    where the drag started."""
    r.transforms.set_translation = lambda key, t: None
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


def control_bf16(r, scene, *, frame):
    """The control: the configuration's plain reference computed in
    bfloat16, the next precision below the float32 the renderer computes
    in, rendering in the program's place what the driver says the frame
    shows (its scene, edits included, and its camera). Outside the window
    (the warm-up) the program renders. The configuration's scene has its
    reference built here, in set-up: a cell whose frames all show it
    builds none in the window."""
    import torch

    refs = {id(scene): frame.reference(scene, r.device, torch.bfloat16)}

    def render():
        shown = frame.shown()
        if shown is None:
            return r.render_device()
        sc, view, proj = shown
        if id(sc) not in refs:
            refs.clear()
            refs[id(sc)] = frame.reference(sc, r.device, torch.bfloat16)
        return refs[id(sc)].render(view, proj)
    return render


WRAPS = {f.__name__: f for f in (stale, altered, half, panes_dropped,
                                 gizmo_hidden, grid_hidden, drag_dropped,
                                 bloom_off, dof_off, msaa_off, mipmap_off,
                                 control_bf16)}
