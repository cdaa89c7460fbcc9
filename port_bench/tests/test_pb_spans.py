"""The readers of the program's spans inside the facade and the frame
graph (render_device, prepare, render_frame/<stage>) on a synthetic
record, and their silence where the program has no such span."""

import pytest

from port_bench import run

SPANS = {
    "facade.render_host_ms": "render_device",
    "facade.prepare_host_ms": "prepare",
    **{f"frame.{s}_host_ms": f"render_frame/{s}"
       for s in ("vertex", "raster", "shade", "resolve", "overlay",
                 "effects", "display")},
}


def _rec(spans_host):
    return dict(frames=10, host_render_s=[0.05] * 10, spans_host=spans_host,
                spans_device={}, launches={}, syncs=[], profile=None,
                sizes={})


def test_manifest_lists_each_reader_once():
    names = [m["name"] for m in run.manifest()["per_layer"]]
    assert all(names.count(n) == 1 for n in SPANS)


@pytest.mark.parametrize("metric", sorted(SPANS))
def test_span_reader_reads_its_span(metric):
    # seconds a frame, distinct for every span, as RenderTimings.summary()
    spans = {s: 1e-3 * (i + 1) for i, s in enumerate(SPANS.values())}
    spans.update({"write_gpu": 1e-4, "render_frame/dispatch": 0.049})
    rd = run.readers([metric])[metric]
    want = 1e3 * spans[SPANS[metric]]
    assert rd.read(_rec(spans)) == pytest.approx(want)


@pytest.mark.parametrize("metric", sorted(SPANS))
def test_span_reader_is_silent_without_its_span(metric):
    """The program before these spans: the record holds only the
    reference's spans, and the reader returns nothing, never 0."""
    rd = run.readers([metric])[metric]
    assert rd.read(_rec({"write_gpu": 1e-4,
                         "render_frame/dispatch": 0.049})) is None
    assert rd.read(_rec({})) is None


COUNTERS = {"facade.prep_reruns": "prepare/rerun",
            "frame.peel_syncs": "render_frame/peel_sync"}


@pytest.mark.parametrize("metric", sorted(COUNTERS))
def test_counter_reader_reads_its_counter_a_frame(metric):
    """run_cell hands the counters over as counts a timed frame; a frame
    that never counted reads 0, a record with no counts reads nothing."""
    rd = run.readers([metric])[metric]
    rec = dict(_rec({}), counts={COUNTERS[metric]: 0.75, "shade/chain": 2.0})
    assert rd.read(rec) == pytest.approx(0.75)
    assert rd.read(dict(rec, counts={})) == 0.0
    assert rd.read(dict(rec, counts=None)) is None


def test_session_host_ms_is_the_step_less_the_render():
    rd = run.readers(["facade.session_host_ms"])["facade.session_host_ms"]
    rec = _rec({"render_device": 0.046})
    assert rd.read(rec) == pytest.approx(4.0)
    assert rd.read(_rec({})) is None
    assert rd.read(dict(rec, host_render_s=[])) is None
