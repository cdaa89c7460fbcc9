"""avatar-room-msaa.animate: the cell resolves and its readers read; the
driver's shown(i) poses the scene at the players' own times; the asset
round-trips through the program's glTF loader at the cell's full size.
On the CPU."""

import os

import numpy as np
import torch

from port_bench import run
from port_bench.reference import pose

CELL = "avatar-room-msaa.animate"
NEW = {"anim.update_host_ms": ("update_all", 1e3),
       "anim.skins_host_ms": ("update_all/skins", 1e3),
       "frame.morph_host_ms": ("render_frame/vertex/morph", 1e3),
       "frame.skin_host_ms": ("render_frame/vertex/skin", 1e3),
       "flush.anim_host_ms": ("write_gpu/animation", 1e3),
       "anim.channels": ("animation/channels", 1),
       "anim.joints": ("skins/joints", 1)}


def test_the_cell_resolves_and_its_readers_read():
    bench = run.manifest()
    w, cfg, mix, mod = run.cell(CELL, bench)
    assert (w["config"], w["traffic"], w["chips"]) == (
        "avatar-room-msaa", "animate", 1)
    assert cfg["reduced"] == [] and mix["driver"] == "animate"
    assert (cfg["joints"], cfg["influences"], cfg["face_targets"]) == (
        65, 4, 52)
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    for name in NEW:
        assert per_layer[name]["workloads"] == [CELL]
        assert per_layer[name]["moves"] == "frame_ms"
    rd = run.readers(list(NEW))
    spans = {k: 0.002 for k, s in NEW.values() if s == 1e3}
    counts = {k: 804.0 for k, s in NEW.values() if s == 1}
    for name, (key, scale) in NEW.items():
        rec = {"spans_host": spans, "counts": counts}
        got = rd[name].read(rec)
        assert got == (spans.get(key, 0) * scale if scale != 1
                       else counts[key])
        # the parent's program has neither the spans nor the counters
        assert rd[name].read({"spans_host": {}, "counts": {}}) is None
        assert rd[name].read({"spans_host": {}, "counts": None}) is None


def _small(cfg, mix):
    cfg["render"].update(width=128, height=72)
    cfg["layout"].update(rows=1, per_row=2)
    cfg["body"].update(ring=6, segments=1)
    cfg["head"].update(lat=10, lon=12)
    cfg["map_size"] = 64
    mix["warmup_frames"] = 3


def test_shown_times_are_the_players_times(tmp_path):
    """After the warm-up and frames 0..i, every player's time is the
    time shown(i) poses the scene at, and the posed scene is the bind
    pose's meshes moved, never the program's state."""
    w, cfg, mix, mod = run.cell(CELL)
    _small(cfg, mix)
    scene = mod.build_scene(cfg, 2 ** 33 + 9)
    r = mod.load_program(scene, torch.device("cpu"), str(tmp_path))
    drv = run.driver(mix, scene, 2 ** 33 + 9, r, lambda: None)
    drv.warmup()
    for i in range(5):
        drv.step(i)
        times = drv.times(i)
        assert all(p.time == times[0][0] for _, p in r.animations.items())
        assert times[0][0] == pose.player_time(3 + i + 1, mix["dt"], 4.0)
    shown, view, proj = drv.shown(4)
    assert shown is not scene and shown.materials is scene.materials
    assert all(np.array_equal(m.world, np.eye(4)) for m in shown.meshes)
    moved = [float(np.abs(a.positions - b.positions).max())
             for a, b in zip(shown.meshes, scene.meshes)]
    assert min(moved) > 0.0


def test_the_asset_round_trips_through_the_loader(tmp_path):
    """The full-size GLB through load_gltf + populate_gltf: 12 skins of
    65 joints, 12 heads of 52 targets, 24 clips of 66 and 1 channels,
    240,000 triangles."""
    import awsm_renderer_tpu_torch as P

    w, cfg, mix, mod = run.cell(CELL)
    scene = mod.build_scene(cfg, 2 ** 32 + 3)
    assert scene.triangles() == 240_000
    path = os.path.join(str(tmp_path), "avatars.glb")
    with open(path, "wb") as f:
        f.write(scene.meta["glb"]())
    data = P.load_gltf(path)
    g = data.gltf
    assert len(g["skins"]) == 12
    assert all(len(s["joints"]) == 65 for s in g["skins"])
    assert len(g["meshes"][1]["primitives"][0]["targets"]) == 52
    assert len(g["animations"]) == 24
    r = P.AwsmRendererTorch(P.RendererConfig(width=128, height=72),
                            device="cpu")
    look = P.populate_gltf(r, data)
    assert r.skins.count == 12
    assert len(look.animation_players) == 24
    n_channels = sorted(len(p.clip.channels) for _, p in r.animations.items())
    assert n_channels == [1] * 12 + [66] * 12
    res = [r.meshes._resources[m.resource_key] for _, m in r.meshes.items()]
    assert r.meshes.count == 24
    assert sorted(x.n_morph_targets for x in res) == [0] * 12 + [52] * 12
    assert all(x.skin_sets == 1 for x in res)
    assert sum(x.tri_count for x in res) == 240_000
