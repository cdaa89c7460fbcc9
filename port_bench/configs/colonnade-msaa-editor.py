"""colonnade-msaa-editor: an editing session on the colonnade-msaa
scene. The scene is colonnade-msaa's, built by colonnade-msaa.py from
the seed; this configuration adds the editor's gizmo and grid (its
"editor" group), the session's camera about the selected box and a
depth of field focused on it. The session itself is the program's, set
up by the mix's driver (drivers/edit.py). Its reference is
reference/editor.py: the shared one plus unlit handles, the grid and the
HUD pass."""

from __future__ import annotations

import importlib.util
import os

from port_bench.reference.editor import Reference  # noqa: F401

_HERE = os.path.dirname(os.path.abspath(__file__))


def _colonnade():
    spec = importlib.util.spec_from_file_location(
        "port_bench_config_colonnade_msaa_base",
        os.path.join(_HERE, "colonnade-msaa.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build_scene(cfg: dict, seed: int):
    scene = _colonnade().build_scene(cfg, seed)
    scene.meta["editor"] = cfg["editor"]
    return scene
