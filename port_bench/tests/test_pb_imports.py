"""What the benchmark loads: no JAX and no JAX package in a run (the
port's name begins with the JAX package's, so names are compared whole
by their top-level part), and nothing of the program in the reference."""

import ast
import json
import os
import subprocess
import sys

from port_bench import run

ROOT = run.ROOT
PB = os.path.join(ROOT, "port_bench")


def test_top_level_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "awsm_renderer_tpu_torch_probe", None)
    assert "awsm_renderer_tpu_torch_probe" not in run.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "jaxlib.probe", None)
    assert "jaxlib.probe" in run.forbidden_loaded()


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            yield node.module


def _sources(sub=""):
    for d, _, files in os.walk(os.path.join(PB, sub)):
        if "tests" in d.split(os.sep) or "__pycache__" in d:
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources():
        for mod in _imports(path):
            assert mod.split(".")[0] not in run.FORBIDDEN, (path, mod)


def test_the_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        for mod in _imports(path):
            assert mod.split(".")[0] not in (
                "awsm_renderer_tpu_torch",) + run.FORBIDDEN, (path, mod)
    for f in ("check.py", "scene.py"):
        for mod in _imports(os.path.join(PB, f)):
            assert not mod.startswith("awsm_renderer_tpu"), (f, mod)


def test_a_run_loads_no_jax_and_the_reference_no_program():
    """A whole CPU run in a fresh interpreter leaves no forbidden module
    loaded; rendering the reference alone loads nothing of the program."""
    code = f"""
import json, sys
sys.path.insert(0, {ROOT!r})
sys.path.insert(0, {os.path.join(PB, 'tests')!r})
from _small import small
from port_bench import check, run
w, cfg, mix, mod = run.cell("helmet-ibl.orbit")
small(cfg, mix, 128, 64)
scene = mod.build_scene(cfg, 5)
next(check.render_reference([run.driver(mix, scene, 5).shown(0)], "cpu"))
ref_loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] == "awsm_renderer_tpu_torch")
run.run_cell("helmet-ibl.orbit", 5, 1.0, False, device="cpu",
             edit_cfg=lambda c, m: small(c, m, 128, 64))
print(json.dumps([ref_loaded, run.forbidden_loaded()]))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    ref_loaded, forbidden = json.loads(out.stdout.strip().splitlines()[-1])
    assert ref_loaded == []
    assert forbidden == []


def test_no_card_no_result():
    """On a host without a CUDA card the command exits non-zero and
    prints no result."""
    import torch

    if torch.cuda.is_available():
        import pytest

        pytest.skip("this host has a CUDA card")
    out = subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload",
         "helmet-ibl.orbit", "--seed", str(2 ** 33 + 1), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
