"""Scene snapshot: save/restore the full host-side scene state.

The reference has NO scene serialization (SURVEY §5.4 — assets are
re-fetched and caches rebuilt); this is the planned TPU-side addition:
key-indexed stores are cheap to snapshot, giving instant scene reload
without re-running the glTF pipeline. Device arrays are NOT saved — the
next flush rebuilds them from the mirrors (same as after load).
"""

from __future__ import annotations

import pickle

_MAGIC = "awsm_renderer_tpu.snapshot.v1"

_STORES = (
    "transforms", "meshes", "materials", "lights", "textures",
    "skins", "animations", "camera", "environment",
)


def save_scene(renderer, path: str) -> None:
    state = {"magic": _MAGIC, "config": renderer.config}
    for name in _STORES:
        state[name] = getattr(renderer, name)
    with open(path, "wb") as f:
        pickle.dump(state, f, protocol=pickle.HIGHEST_PROTOCOL)


def load_scene(path: str, config=None, *, device="cuda"):
    """A renderer on `device` holding the saved scene (the snapshot is a
    pickle: load only files this program wrote)."""
    from ..renderer import AwsmRendererTorch

    with open(path, "rb") as f:
        state = pickle.load(f)
    if state.get("magic") != _MAGIC:
        raise ValueError(f"{path} is not an awsm_renderer_tpu snapshot")
    r = AwsmRendererTorch(config or state["config"], device=device)
    for name in _STORES:
        setattr(r, name, state[name])
    # force full device re-upload on next render (the pickled Meshes
    # remembers a device layout for arrays that don't exist in this
    # fresh renderer — drop it or range updates would patch nothing)
    r.meshes.invalidate_device()
    r.transforms.gpu_dirty = True
    r.meshes.gpu_dirty = True
    r.materials.gpu_dirty = True
    r.lights.gpu_dirty = True
    r.textures.gpu_dirty = True
    r.skins.gpu_dirty = True
    r.camera.gpu_dirty = True
    r.environment.gpu_dirty = True
    return r
