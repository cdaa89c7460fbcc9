"""BENCHMARK.json against the limits its format keeps, and the data-driven
layout: every name resolves to its own file, and a new configuration,
mix or per-layer metric is files plus manifest entries, nothing else."""

import json
import math
import os
import re
import shutil
import subprocess
import sys

import pytest

from port_bench import run

ROOT = run.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_keys_and_names(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
        names += [w["name"], w["config"], w["traffic"]]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    for n in names:
        assert NAME.match(n), n
    for group in ("configs", "workloads"):
        ns = [x["name"] for x in bench[group]]
        assert len(ns) == len(set(ns))
    metric_names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(metric_names) == len(set(metric_names))
    texts = [c["source"] for c in bench["configs"]] + [
        x["why"] for x in bench["configs"] + bench["workloads"]] + [
        m["layer"] for m in bench["per_layer"]] + bench["command"]
    for t in texts:
        assert 1 <= len(t) <= 200 and "\n" not in t and "\t" not in t, t


def test_bounds_and_window(bench):
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])
    rs = bench["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of the full 24 cells fits in its 43,200 seconds
    assert 2 * (rs + 60) + 24 * (14 * (rs + 60) + 2 * 90) + 1200 <= 43200


def test_each_name_finds_its_file(bench):
    for w in bench["workloads"]:
        _w, cfg, mix, mod = run.cell(w["name"], bench)
        assert cfg["name"] == w["config"]
        assert hasattr(mod, "build_scene")
        assert os.path.isfile(os.path.join(ROOT, "port_bench", "drivers",
                                           mix["driver"] + ".py"))
    for c in bench["configs"]:
        assert c["file"] == f"port_bench/configs/{c['name']}.json"
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]
        assert any(w["config"] == c["name"] for w in bench["workloads"])
    rd = run.readers([m["name"] for m in bench["per_layer"]])
    assert all(callable(r.read) for r in rd.values())


def test_every_per_layer_metric_moves_a_reported_metric(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    cells = [w["name"] for w in bench["workloads"]]
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        for c in m.get("workloads", cells):
            assert c in cells
            assert c in e2e[m["moves"]].get("workloads", cells)
    for c in cells:
        reported = [n for n, m in e2e.items() if c in m.get("workloads", cells)]
        assert "setup_s" in reported and len(reported) >= 2
        assert any(c in m.get("workloads", cells) for m in bench["per_layer"])
    layers = {}
    for m in bench["per_layer"]:
        layers.setdefault(m["layer"], set()).add(m["name"].split(".")[0])
    assert all(len(v) == 1 for v in layers.values())


def test_paths_hold_the_benchmark_alone(bench):
    assert bench["paths"] == ["port_bench"]
    assert bench["command"][1] == "port_bench/run.py"
    for p in bench["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) and ".." not in p
        assert not p.endswith("_torch")


def test_every_cell_takes_one_chip(bench):
    assert all(w["chips"] == 1 for w in bench["workloads"])


def test_existing_cells_keep_their_limits_and_bounds(bench):
    """What the cells before the editing session were held to: no bound
    and no limit of theirs loosened."""
    bounds = {m["name"]: m["bound"] for m in bench["end_to_end"]}
    assert bounds == {"frame_ms": 0.25, "frame_ms_p95": 0.25,
                      "peak_mem_mib": 0.01, "setup_s": 0.25}
    want = {"colonnade-msaa": {"bad_tile": 0.35, "bad_px": 0.005,
                               "mean_abs": 0.001},
            "helmet-ibl": {"bad_tile": 0.08, "bad_px": 7e-05,
                           "mean_abs": 0.0015}}
    for name, limits in want.items():
        with open(os.path.join(ROOT, "port_bench", "configs",
                               name + ".json")) as f:
            ck = json.load(f)["check"]
        assert ck["limits"] == limits and ck["frames"] == 3
        assert ck["pixel_tol"] == pytest.approx(4 / 255)


def test_the_edit_cell_is_the_queued_one(bench):
    """colonnade-msaa-editor.edit as it was queued: colonnade-msaa's scene
    keys verbatim, its render group but for the focus, the session's
    camera, the editor's defaults and 30-step drags of 4 px."""
    _w, cfg, mix, _mod = run.cell("colonnade-msaa-editor.edit", bench)
    with open(os.path.join(ROOT, "port_bench", "configs",
                           "colonnade-msaa.json")) as f:
        base = json.load(f)
    for k in ("grid", "spacing", "box_size", "sphere", "panes", "checker",
              "materials", "point_lights", "sun", "env_size"):
        assert cfg[k] == base[k], k
    assert cfg["reduced"] == [] and cfg["render"] == dict(base["render"],
                                                          dof_focus=5.0)
    cam = cfg["camera"]
    assert (cam["radius"], cam["pitch"], cam["near"], cam["far"]) == (
        5.0, 0.6, 0.1, 200.0)
    assert cam["fov_y"] == pytest.approx(math.pi / 3)
    assert cam["yaw_step"] == pytest.approx(math.pi / 8)
    ed = cfg["editor"]
    assert (ed["gizmo"]["mode"], ed["gizmo"]["space"],
            ed["gizmo"]["scale"]) == ("translate", "world", 1.0)
    assert {k: ed["grid"][k] for k in ("size", "spacing", "major_every",
                                       "fade_distance")} == {
        "size": 200.0, "spacing": 1.0, "major_every": 10.0,
        "fade_distance": 60.0}
    assert mix["driver"] == "edit"
    assert (mix["period"], mix["move_px"], mix["handle_at"],
            mix["warmup_drags"]) == (30, 4, 0.55, 2)
    assert mix["dt"] == pytest.approx(1 / 60)


LIFT = '''"""lift: a still camera while every mesh is moved up and down
through the transform store, one edit a frame."""
import math

import numpy as np

from port_bench.scene import look_at, perspective


class Lift:
    def __init__(self, mix, scene, seed, renderer=None, render=None):
        self.scene, self.r, self.render = scene, renderer, render
        self.amp = float(mix["amplitude"])
        cam, st = scene.camera, scene.settings
        eye = [cam["radius"], cam["height"], 0.0]
        self.view = look_at(eye, [0, 0, 0], [0, 1, 0])
        self.proj = perspective(cam["fov_y"], st["width"] / st["height"],
                                cam["near"], cam["far"])

    def _dy(self, i):
        return self.amp * math.sin(0.7 * i)

    def _move(self, i):
        for _key, m in self.r.meshes.items():
            self.r.transforms.set_translation(m.transform_key,
                                              [0.0, self._dy(i), 0.0])
        self.r.update_all(0.0, self.view, self.proj)

    def warmup(self):
        self._move(0)
        self.render()

    def step(self, i):
        self._move(i)
        return self.render()

    def shown(self, i):
        t = np.eye(4, dtype=np.float32)
        t[1, 3] = self._dy(i)
        sc = self.scene
        meshes = [type(m)(**dict(vars(m), world=t @ m.world))
                  for m in sc.meshes]
        return type(sc)(**dict(vars(sc), meshes=meshes)), self.view, self.proj


def make(mix, scene, seed, renderer=None, render=None):
    return Lift(mix, scene, seed, renderer, render)
'''


def test_adding_is_adding_files(tmp_path, bench):
    """New mixes (a still camera, data for the orbit driver; and a mesh
    edit each frame, data for a new driver module), a new per-layer
    metric and a new configuration, as new files and manifest entries
    only, run end to end on the CPU, each `correct`."""
    dst = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "port_bench"), dst / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    pb = dst / "port_bench"
    (pb / "traffic" / "still.json").write_text(json.dumps(
        {"driver": "orbit", "start_rad": 0.5, "seed_offset_rad": 0.0,
         "step_rad": 0.0, "warmup_views": 1}))
    (pb / "drivers" / "lift.py").write_text(LIFT)
    (pb / "traffic" / "lift.json").write_text(json.dumps(
        {"driver": "lift", "amplitude": 0.3}))
    (pb / "metrics" / "facade.frames.py").write_text(
        "def read(rec):\n    return rec['frames']\n")
    cfg = json.loads((pb / "configs" / "helmet-ibl.json").read_text())
    cfg["name"] = "helmet-ibl-lowres"
    cfg["map_size"] = 64
    (pb / "configs" / "helmet-ibl-lowres.json").write_text(json.dumps(cfg))
    (pb / "configs" / "helmet-ibl-lowres.py").write_text(
        (pb / "configs" / "helmet-ibl.py").read_text())
    b = json.loads(json.dumps(bench))
    b["configs"].append(dict(b["configs"][1], name="helmet-ibl-lowres",
                             file="port_bench/configs/helmet-ibl-lowres.json"))
    for mix in ("still", "lift"):
        b["workloads"].append({"name": "helmet-ibl-lowres." + mix,
                               "config": "helmet-ibl-lowres", "traffic": mix,
                               "chips": 1, "why": "a " + mix + " mix"})
    b["per_layer"].append({"name": "facade.frames", "unit": "frames",
                           "better": "higher", "source": "host_clock",
                           "layer": "facade", "moves": "frame_ms"})
    (dst / "BENCHMARK.json").write_text(json.dumps(b))
    code = f"""
import json, sys
sys.path.insert(0, {str(dst)!r})
sys.path.insert(1, {ROOT!r})
from port_bench import run
assert run.ROOT == {str(dst)!r}, run.ROOT
def small(cfg, mix):
    cfg["render"].update(width=128, height=64)
    cfg.update(lat=16, lon=16)
    cfg["check"]["frames"] = 2
out = [run.run_cell("helmet-ibl-lowres." + m, 3, 0.5, True, device="cpu",
                    edit_cfg=small) for m in ("still", "lift")]
print(json.dumps(out))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=str(dst))
    assert out.returncode == 0, out.stderr[-3000:]
    for res in json.loads(out.stdout.strip().splitlines()[-1]):
        assert res["correct"], res["check"]
        assert res["metrics"]["facade.frames"]["value"] >= 2
        assert "facade.host_ms" in res["metrics"]
