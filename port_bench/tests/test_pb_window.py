"""The arithmetic of the metrics on synthetic readings: the window's
frame time and tail with stalls in them, the trace reduction, the
roofline roles and the per-layer readers."""

import pytest

from port_bench import roofline, run, trace, window


def _frames(durations, t_open=100.0):
    finishes, t = [], t_open
    for d in durations:
        t += d
        finishes.append(t)
    return t_open, finishes


def test_frame_ms_takes_the_whole_window_stalls_included():
    ds = [0.010] * 99 + [0.500]
    t_open, fin = _frames(ds)
    assert window.frame_ms(t_open, fin) == pytest.approx(1e3 * sum(ds) / 100)
    assert window.frame_ms(t_open, fin) == pytest.approx(14.9)


def test_p95_is_of_every_frame():
    ds = [0.010] * 95 + [0.500] * 5
    assert window.percentile_ms(ds, 95.0) == pytest.approx(10.0)
    ds = [0.010] * 94 + [0.500] * 6
    assert window.percentile_ms(ds, 95.0) == pytest.approx(500.0)
    # order does not matter: a stall early in the window counts the same
    assert window.percentile_ms(list(reversed(ds)), 95.0) == pytest.approx(
        500.0)


def test_empty_window_raises():
    with pytest.raises(ValueError):
        window.frame_ms(0.0, [])
    with pytest.raises(ValueError):
        window.percentile_ms([], 95.0)


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_trace_reduce_busy_idle_and_labels():
    events = [
        _ev("user_annotation", "bench/frame", 0, 100),
        _ev("user_annotation", "write_gpu", 0, 20),
        _ev("user_annotation", "render_frame/dispatch", 20, 70),
        _ev("kernel", "raster16_kernel(float const*)", 25, 10),
        _ev("kernel", "resolve_kernel(int const*)", 30, 10),   # overlaps
        _ev("gpu_memcpy", "Memcpy DtoD", 60, 5),
        _ev("gpu_user_annotation", "render_frame/dispatch", 20, 80),
        _ev("kernel", "elementwise", 80, 10),
    ]
    p = trace.reduce(events, 1)
    assert p["window_s"] == pytest.approx(100e-6)
    assert p["busy_s"] == pytest.approx((15 + 5 + 10) * 1e-6)
    assert p["n_kernels"] == 3
    idle = dict(p["idle_by_range"])
    # 0-25 starts inside write_gpu; 40-60, 65-80 inside the dispatch span;
    # 90-100 inside the frame only
    assert idle["write_gpu"] == pytest.approx(25e-6)
    assert idle["render_frame/dispatch"] == pytest.approx(35e-6)
    assert idle["bench/frame"] == pytest.approx(10e-6)


def test_kernel_roles_by_trace_name():
    assert roofline.kernel_role("raster_msaa_kernel(float const*, int)") \
        == "visibility raster"
    assert roofline.kernel_role("void binned_kernel<2>(float const*)") \
        == "overlay raster"
    assert roofline.kernel_role("gather_split_f32_kernel(float const*)") \
        == "relayout"
    assert roofline.kernel_role(
        "void (anonymous namespace)::filter_taps_kernel<true>(uint4 const*)") \
        == "texture taps"
    assert roofline.kernel_role(
        "(anonymous namespace)::tap_plan_kernel(int const*, int)") \
        == "texture taps"
    assert roofline.kernel_role("void at::native::elementwise_kernel<128>") \
        is None


SIZES = dict(pixels=1920 * 1080, samples=4, tri_opaque=259404,
             tri_transparent=144, slots=1, normal_map=False, transparent=True)


def test_role_bounds_are_byte_bounds_of_the_sizes():
    b = roofline.role_bytes(SIZES)
    assert set(b) == set(roofline.ROLES)
    P = SIZES["pixels"]
    assert b["visibility raster"] == 36 * 259404 + 4 * P * 4 + 4 * P
    assert b["texture taps"] == 44 * P
    no_overlay = dict(SIZES, transparent=False)
    assert "overlay raster" not in roofline.role_bytes(no_overlay)


def _rec(prof):
    return dict(frames=10, host_render_s=[0.05] * 10,
                spans_host={"write_gpu": 1e-4,
                            "render_frame/dispatch": 0.049},
                spans_device={"render_frame/dispatch": 0.02},
                launches={"rasterize16_msaa": 10, "resolve_planes_fused": 10},
                syncs=[1, 1], profile=prof, sizes=SIZES)


def test_readers_on_a_synthetic_record():
    prof = dict(frames=8, window_s=0.8, busy_s=0.16,
                device_ops=[("raster_msaa_kernel(x)", 8e-4),
                            ("elementwise", 0.1)],
                n_kernels=8 * 5000)
    rd = run.readers(["facade.host_ms", "facade.syncs", "flush.host_ms",
                      "frame.dispatch_host_ms", "frame.dispatch_device_ms",
                      "kernels.launches", "kernels.roofline_share",
                      "device.idle_share", "device.kernels"])
    got = {n: r.read(_rec(prof)) for n, r in rd.items()}
    assert got["facade.host_ms"] == pytest.approx(50.0)
    assert got["facade.syncs"] == 1
    assert got["flush.host_ms"] == pytest.approx(0.1)
    assert got["frame.dispatch_host_ms"] == pytest.approx(49.0)
    assert got["frame.dispatch_device_ms"] == pytest.approx(20.0)
    assert got["kernels.launches"] == pytest.approx(2.0)
    assert got["device.idle_share"] == pytest.approx(80.0)
    assert got["device.kernels"] == pytest.approx(5000.0)
    bound = sum(roofline.bound_s(b)
                for b in roofline.role_bytes(SIZES).values())
    assert got["kernels.roofline_share"] == pytest.approx(
        100.0 * bound * 8 / 8e-4)
    # nothing to read: the readers return nothing, never 0
    assert rd["kernels.roofline_share"].read(_rec(None)) is None
    assert rd["device.idle_share"].read(_rec(None)) is None
    assert rd["kernels.roofline_share"].read(_rec(dict(
        prof, device_ops=[("elementwise", 0.1)]))) is None


def test_reservoir_draws_from_the_whole_window():
    """The checked frames: three drawn from the seed among every frame
    that finished, each image the frame's own, the same draw for the
    same seed and frame count."""
    import torch

    from port_bench import check

    def draw(seed, n):
        res = check.Reservoir(seed, 3, (1,), False)
        for i in range(n):
            if res.wants(i):
                res.copy(torch.tensor([float(i)]), False)
                res.keep(i)
        return res.frames()

    picks = []
    for seed in range(300):
        got = draw(seed, 50)
        assert [int(img.item()) for _, img in got] == [i for i, _ in got]
        assert len({i for i, _ in got}) == 3
        picks += [i for i, _ in got]
    tenths = [sum(1 for p in picks if 5 * b <= p < 5 * b + 5)
              for b in range(10)]
    assert min(tenths) > 50 and max(tenths) < 130, tenths
    assert [i for i, _ in draw(7, 50)] == [i for i, _ in draw(7, 50)]
    assert [i for i, _ in draw(7, 2)] == [0, 1]
