"""PyTorch port, the spans and counters inside a frame: the facade's
render_device and prepare spans, the frame graph's seven stage spans
(render_frame/vertex, raster, shade, resolve, overlay, effects,
display) under render_frame/dispatch, and the counters prepare/rerun
and render_frame/peel_sync, reached through the active RenderTimings
(utils/profiling.py). The port's own; the JAX package has none of them.
128x64 frames on the CPU."""

import numpy as np
import pytest
import torch

import _torch_port as T

STAGES = {"render_frame/vertex", "render_frame/raster", "render_frame/shade",
          "render_frame/resolve", "render_frame/overlay",
          "render_frame/effects", "render_frame/display"}
# a first frame's facade spans: the flush (meshes included), the prep
# (its memo misses), the dispatch
FACADE = {"render_device", "write_gpu", "write_gpu/meshes", "prepare",
          "collect_renderables", "render_frame/dispatch"}


def _renderer(full: bool):
    """full: the alpha-blend scene (a BLEND box over opaque ones) with
    MSAA, bloom and DoF; else the opaque box, single-sample, no effect."""
    import awsm_renderer_tpu_torch as P
    from awsm_renderer_tpu_torch.demo import scenes

    cfg = P.RendererConfig(width=T.W, height=T.H)
    if full:
        cfg = P.RendererConfig(
            width=T.W, height=T.H, anti_aliasing=P.AntiAliasing(msaa=True),
            post_processing=P.PostProcessing(bloom=True, dof=True))
    r = P.AwsmRendererTorch(cfg, device="cpu")
    info = scenes.SCENES["alpha-blend" if full else "box"](r)
    r.update_all(0.0, *T.camera(info))
    return r


def _move(r, i):
    from awsm_renderer_tpu_torch.utils import math3d as m3

    r.camera.update(m3.look_at([0.3 * i, 0.6, 3.5], [0, 0, 0], [0, 1, 0]),
                    r.camera.projection)


@pytest.fixture(scope="module")
def full_frame():
    """The full frame's first frame with timings on, under torch.profiler:
    (its timings frame, its image, the profiler's events, the counts, the
    host checks each _peel_layers call made, seen from outside it)."""
    from torch.profiler import ProfilerActivity, profile

    from awsm_renderer_tpu_torch.ops import raster

    real, checks = raster._peel_layers, []

    def spy(peel, zlo, n_layers):
        peels = []

        def counted(z):
            peels.append(z)
            return peel(z)

        out = real(counted, zlo, n_layers)
        # a check before each peel after the first, and one that stops
        checks.append(min(len(peels), n_layers - 1))
        return out

    r = _renderer(True)
    r.logging_timings = True
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(raster, "_peel_layers", spy)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            img = r.render_device()
    return (r.timings.frames[-1], img, prof.events(),
            dict(r.timings.counts), checks)


@pytest.mark.parametrize("full", (True, False), ids=("msaa-effects-overlay",
                                                     "single-sample"))
def test_a_frame_records_exactly_its_spans(full, full_frame):
    if full:
        frame = full_frame[0]
        want = FACADE | STAGES
    else:
        r = _renderer(False)
        r.logging_timings = True
        r.render_device()
        frame = r.timings.frames[-1]
        want = FACADE | STAGES - {"render_frame/resolve",
                                  "render_frame/overlay",
                                  "render_frame/effects"}
    assert set(frame) == want
    assert all(v > 0 for v in frame.values())


def test_stages_never_nest_and_sum_within_dispatch(full_frame):
    frame, _img, events, *_ = full_frame
    stage_events = [e for e in events if e.name in STAGES]
    assert {e.name for e in stage_events} == STAGES
    for e in stage_events:
        up, parents = e.cpu_parent, []
        while up is not None:
            parents.append(up.name)
            up = up.cpu_parent
        assert not STAGES & set(parents), (e.name, parents)
        assert {"render_frame/dispatch", "render_device"} <= set(parents)
    assert sum(frame[k] for k in STAGES) <= frame["render_frame/dispatch"]
    # the facade's spans: prepare and the dispatch sit in render_device
    for e in events:
        if e.name in ("prepare", "write_gpu", "render_frame/dispatch"):
            assert e.cpu_parent is not None
            assert e.cpu_parent.name == "render_device"


def test_timings_off_records_nothing_and_renders_the_same(full_frame):
    from torch.profiler import ProfilerActivity, profile

    from awsm_renderer_tpu_torch.utils import profiling

    r = _renderer(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        img = r.render_device()
    names = {e.name for e in prof.events()}
    assert not names & (FACADE | STAGES)
    assert r.timings.frames == [] and r.timings.counts == {}
    assert r.timings.summary() == {}
    assert torch.equal(img, full_frame[1])
    # the off path is one shared no-op context, whatever the name
    assert profiling.span("render_frame/raster") is profiling._NOOP
    assert r.timings.span("write_gpu") is profiling._NOOP
    profiling.count("render_frame/peel_sync")
    with profiling.active(r.timings):
        assert profiling.span("render_frame/shade") is profiling._NOOP
        profiling.count("render_frame/peel_sync")
    assert r.timings.counts == {}


@pytest.mark.parametrize("moving", (False, True), ids=("still", "moving"))
def test_prepare_reruns_with_the_camera(moving):
    r = _renderer(False)
    r.render_device()                     # fills the prep memo, untimed
    r.logging_timings = True
    n = 3
    for i in range(n):
        if moving:
            _move(r, i + 1)
        r.render_device()
    assert len(r.timings.frames) == n
    assert r.timings.counts.get("prepare/rerun", 0) == (n if moving else 0)
    assert all(("collect_renderables" in f) == moving
               for f in r.timings.frames)


def _layer(hit: bool):
    n = 8
    return {"tri_id": torch.full((n,), 3 if hit else -1, dtype=torch.int32),
            "depth": torch.full((n,), 0.5)}


@pytest.mark.parametrize("hits, n_layers, checks, peels", [
    ((True, True, False), 4, 3, 3),   # two full peels, an empty one: stop
    ((False,), 4, 1, 1),              # the first peel is empty: stop
    ((True,) * 4, 4, 3, 4),           # every layer peels
    ((True,), 1, 0, 1),               # one layer: no check
])
def test_peel_sync_counts_each_host_check(hits, n_layers, checks, peels):
    from awsm_renderer_tpu_torch.ops.raster import _peel_layers
    from awsm_renderer_tpu_torch.utils.profiling import (
        RenderTimings, active,
    )

    calls = []

    def peel(zlo):
        calls.append(zlo)
        return _layer(hits[len(calls) - 1])

    t = RenderTimings(enabled=True)
    with active(t):
        out = _peel_layers(peel, torch.zeros(8), n_layers)
    assert t.counts.get("render_frame/peel_sync", 0) == checks
    assert len(calls) == peels
    assert out["tri_id"].shape == (n_layers, 8)


def test_full_frame_counts_its_peel_checks(full_frame):
    """The transparent box's peel runs on the frame: each of its host
    checks is counted; the first frame's prep memo missed once."""
    counts, checks = full_frame[3], full_frame[4]
    assert counts["prepare/rerun"] == 1
    assert sum(checks) >= 1
    assert counts["render_frame/peel_sync"] == sum(checks)


def test_active_restores_on_raise():
    from awsm_renderer_tpu_torch.utils import profiling

    a = profiling.RenderTimings(enabled=True)
    b = profiling.RenderTimings(enabled=True)
    with profiling.active(a):
        with pytest.raises(RuntimeError):
            with profiling.active(b):
                raise RuntimeError("frame")
        profiling.count("x")
    assert a.counts == {"x": 1} and b.counts == {}
    assert profiling.span("y") is profiling._NOOP


def test_a_frame_that_raises_leaves_no_active_timings():
    from awsm_renderer_tpu_torch.errors import ConfigError
    from awsm_renderer_tpu_torch.utils import profiling

    r = _renderer(False)
    r.logging_timings = True
    with pytest.raises(ConfigError):
        r.render_device(debug_mode="edges")     # needs MSAA
    assert profiling._ACTIVE.get() is None
    r.render_device()
    assert "render_device" in r.timings.frames[-1]
    assert np.isfinite(r.timings.summary()["render_device"])


def test_kernels_by_range_takes_the_innermost_range_at_launch():
    """scripts/stage_breakdown.py's attribution on synthetic Chrome-trace
    events: a kernel goes to the innermost range open when the runtime
    call with its correlation id began, wherever the kernel itself ran;
    a kernel with no matching launch is unattributed."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts", "stage_breakdown.py")
    spec = importlib.util.spec_from_file_location("stage_breakdown", path)
    sb = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sb)

    def ev(cat, name, ts, dur, corr=None):
        e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
        if corr is not None:
            e["args"] = {"correlation": corr}
        return e

    events = [
        ev("user_annotation", "render_device", 0, 100),
        ev("user_annotation", "render_frame/dispatch", 10, 80),
        ev("user_annotation", "render_frame/raster", 20, 10),
        ev("user_annotation", "render_frame/shade", 40, 30),
        ev("cuda_runtime", "cudaLaunchKernel", 22, 1, corr=1),
        ev("cuda_driver", "cuLaunchKernel", 45, 1, corr=2),
        ev("cuda_runtime", "cudaLaunchKernel", 35, 1, corr=3),
        ev("cuda_runtime", "cudaLaunchKernel", 5, 1, corr=4),
        # the kernels run later, under other ranges' times
        ev("kernel", "k_raster", 200, 5, corr=1),
        ev("kernel", "k_shade", 210, 5, corr=2),
        ev("kernel", "k_gap", 220, 5, corr=3),
        ev("kernel", "k_facade", 230, 5, corr=4),
        ev("kernel", "k_lost", 240, 5, corr=99),
        ev("kernel", "k_lost", 250, 5),
        ev("gpu_memcpy", "Memcpy HtoD", 260, 5, corr=5),
    ]
    by_range, lost = sb.kernels_by_range(events)
    assert by_range == {"render_frame/raster": 1, "render_frame/shade": 1,
                        "render_frame/dispatch": 1, "render_device": 1,
                        sb.UNATTRIBUTED: 2}
    assert lost == {"k_lost": 2}
