#!/usr/bin/env python3
"""Where a benchmark cell's frame spends its host time and its kernels,
stage by stage, on one CUDA card.

Builds the cell as port_bench/run.py does (open_cell: the scene from
the seed, the program, the traffic's driver and its warm-up), then:

  1. cost: render_device()'s host ms a frame with RenderTimings off and
     on, in alternating blocks of --block frames (--blocks of each),
     every frame synchronized before the next; and the host µs of one
     span opened and closed, timings on and off, over 20,000 spans;
  2. spans: --frames frames with timings on: host ms a frame of every
     span, render_device's self time (what its write_gpu, prepare and
     render_frame/dispatch spans leave), the counts a frame (shade/chain,
     the shade calls outside K14's scope, printed also at 0), the hand
     kernels' launches a frame by kernel, and host
     syncs a frame (torch's sync debug mode) over two more frames beside
     the render_frame/peel_sync count of the same frames;
  3. trace: --profiled frames under torch.profiler, as the traced
     benchmark run takes them: kernels a frame by the innermost program
     range open when the runtime call that launched each began
     (kernels_by_range; a kernel whose launch the trace cannot match by
     correlation id counts under "(unattributed)"), and the device's idle
     gaps by the range open when each began (port_bench/trace.py reduce),
     and the spans opened a frame (the program's ranges in the trace).

Prints a summary and writes the whole record to <out>/stages_<cell>.json
(--out, by default build/stage_breakdown).

    python3 scripts/stage_breakdown.py --workload colonnade-msaa.orbit
        [--seed 1] [--frames 60] [--profiled 8] [--blocks 12] [--block 20]
        [--out DIR]
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import statistics
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
UNATTRIBUTED = "(unattributed)"


def kernels_by_range(events):
    """Chrome-trace events -> ({range: kernels}, {kernel name: count} of
    the unattributed ones). A kernel goes to the innermost user range
    (record_function) open when the runtime or driver call with its
    correlation id began."""
    launches, ranges, kernels = {}, [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        corr = (e.get("args") or {}).get("correlation")
        if cat == "kernel":
            kernels.append((corr, e.get("name", "?")))
        elif cat in _LAUNCH_CATS and corr is not None:
            launches[corr] = float(e.get("ts", 0.0))
        elif cat == "user_annotation":
            t0 = float(e.get("ts", 0.0))
            ranges.append((t0, t0 + float(e.get("dur", 0.0)),
                           e.get("name", "?")))
    ranges.sort(key=lambda r: r[1] - r[0])          # innermost first
    by_range = collections.Counter()
    lost = collections.Counter()
    for corr, name in kernels:
        ts = launches.get(corr)
        if ts is None:
            by_range[UNATTRIBUTED] += 1
            lost[name] += 1
            continue
        by_range[next((r[2] for r in ranges if r[0] <= ts < r[1]),
                      "(none)")] += 1
    return dict(by_range), dict(lost)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--profiled", type=int, default=8)
    ap.add_argument("--blocks", type=int, default=12)
    ap.add_argument("--block", type=int, default=20)
    ap.add_argument("--out", default=os.path.join("build", "stage_breakdown"))
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    os.chdir(REPO)

    import torch
    from torch.profiler import record_function

    from awsm_renderer_tpu_torch.ops import kernels
    from awsm_renderer_tpu_torch.utils.profiling import RenderTimings
    from port_bench import run
    from port_bench import trace as tr

    run._caches_in_checkout()
    torch.set_num_threads(1)
    dev = torch.device("cuda")
    host = []

    def wrap(r, scene):
        def render():
            t0 = time.perf_counter()
            out = r.render_device()
            host.append(time.perf_counter() - t0)
            return out
        return render

    _w, _cfg, _mix, _scene, r, drv = run.open_cell(args.workload, args.seed,
                                                   dev, wrap=wrap)
    torch.cuda.synchronize()
    i = 0

    def frames(n, on):
        nonlocal i
        r.logging_timings = on
        del host[:]
        for _ in range(n):
            drv.step(i)
            torch.cuda.synchronize()
            i += 1
        return list(host)

    # ---- 1. the instrumentation's cost ------------------------------------
    blocks = []
    for _ in range(args.blocks):
        for on in (False, True):
            blocks.append((on, statistics.mean(frames(args.block, on)) * 1e3))
    off = [ms for on, ms in blocks if not on]
    on_ = [ms for on, ms in blocks if on]
    span_us = {}
    for on in (False, True):
        t = RenderTimings(enabled=on, device=dev)
        t0 = time.perf_counter()
        for _ in range(20000):
            with t.span("render_frame/shade"):
                pass
        span_us[on] = (time.perf_counter() - t0) / 20000 * 1e6
        t.end_frame()

    # ---- 2. spans, counts and syncs ----------------------------------------
    r.timings = RenderTimings(enabled=True, device=dev)
    l0 = dict(kernels.launch_counts)
    host_ms = statistics.mean(frames(args.frames, True)) * 1e3
    by_kernel = {k: v - l0.get(k, 0) for k, v in kernels.launch_counts.items()
                 if v - l0.get(k, 0)}
    launches = sum(by_kernel.values())
    spans = {k: v * 1e3 for k, v in r.timings.summary().items()}
    n = len(r.timings.frames)
    counts = {k: v / n for k, v in r.timings.counts.items()}
    peel0 = r.timings.counts.get("render_frame/peel_sync", 0)
    syncs = [tr.count_syncs(lambda: drv.step(i + j)) for j in range(2)]
    i += 2
    peel = (r.timings.counts.get("render_frame/peel_sync", 0) - peel0) / 2
    facade = ("write_gpu", "prepare", "render_frame/dispatch")
    self_ms = spans.get("render_device", 0.0) - sum(spans.get(k, 0.0)
                                                    for k in facade)
    stages = {k: v for k, v in spans.items() if k.startswith("render_frame/")
              and k != "render_frame/dispatch"}

    # ---- 3. the device trace ----------------------------------------------
    path = os.path.join(REPO, "build", "port_bench", "stages_trace.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)

    def traced(j):
        with record_function("bench/step"):
            drv.step(i + j)
        with record_function("bench/sync"):
            torch.cuda.synchronize()

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for j in range(args.profiled):
            with record_function("bench/frame"):
                traced(j)
        torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    reduced = tr.reduce(events, args.profiled)
    by_range, lost = kernels_by_range(events)
    per_frame = {k: v / args.profiled for k, v in sorted(
        by_range.items(), key=lambda kv: -kv[1])}
    idle = {k: v for k, v in reduced["idle_by_range"]}
    opened = sum(1 for e in events if e.get("ph") == "X"
                 and e.get("cat") == "user_annotation"
                 and not e.get("name", "").startswith("bench/"))
    opened /= args.profiled
    idle_total = sum(idle.values())

    rec = dict(
        workload=args.workload, seed=args.seed,
        card=torch.cuda.get_device_name(dev),
        cost=dict(blocks=blocks, block_frames=args.block,
                  off_ms=statistics.mean(off), on_ms=statistics.mean(on_),
                  span_us_off=span_us[False], span_us_on=span_us[True],
                  spans_a_frame=opened),
        host_ms=host_ms, spans_ms=spans, render_device_self_ms=self_ms,
        stage_sum_over_dispatch=(sum(stages.values())
                                 / spans["render_frame/dispatch"]),
        counts_a_frame=counts, syncs=syncs, peel_syncs_same_frames=peel,
        launches_a_frame=launches / n,
        launches_by_kernel={k: v / n for k, v in by_kernel.items()},
        shade_chain_a_frame=counts.get("shade/chain", 0.0),
        kernels_a_frame=reduced["n_kernels"] / args.profiled,
        kernels_by_range=per_frame,
        unattributed=dict(sorted(lost.items(), key=lambda kv: -kv[1])),
        idle_s=idle, idle_share_by_range={k: v / idle_total
                                          for k, v in idle.items()},
        busy_s=reduced["busy_s"], window_s=reduced["window_s"])
    out = os.path.join(REPO, args.out)
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, f"stages_{args.workload}.json"), "w") as f:
        json.dump(rec, f, indent=1)

    print(f"== {args.workload} on {rec['card']} (seed {args.seed})")
    print(f"cost: render_device host ms a frame, timings off "
          f"{rec['cost']['off_ms']:.3f}, on {rec['cost']['on_ms']:.3f} "
          f"(blocks of {args.block}: "
          + ", ".join(f"{'on' if o else 'off'} {ms:.2f}" for o, ms in blocks)
          + ")")
    print(f"one span: {span_us[False]:.3f} µs off, {span_us[True]:.3f} µs "
          f"on; {opened:.1f} spans a frame: "
          f"{opened * (span_us[True] - span_us[False]) / 1e3:.3f} ms a "
          f"frame on")
    print("spans, host ms a frame: " + ", ".join(
        f"{k} {v:.3f}" for k, v in sorted(spans.items(),
                                           key=lambda kv: -kv[1])))
    print(f"render_device self {self_ms:.3f} ms; stages / dispatch "
          f"{rec['stage_sum_over_dispatch']:.4f}")
    print(f"counts a frame {counts} (shade/chain "
          f"{rec['shade_chain_a_frame']:g}); syncs {syncs}, peel_sync "
          f"{peel} a frame over the same frames; hand launches "
          f"{rec['launches_a_frame']:.2f} a frame: " + ", ".join(
              f"{k} {v:.2f}" for k, v in rec["launches_by_kernel"].items()))
    print(f"kernels a frame {rec['kernels_a_frame']:.1f}: " + ", ".join(
        f"{k} {v:.1f}" for k, v in per_frame.items()))
    print(f"unattributed kernels (all frames): {rec['unattributed']}")
    print("idle s (share): " + ", ".join(
        f"{k} {v:.4f} ({v / idle_total:.1%})" for k, v in sorted(
            idle.items(), key=lambda kv: -kv[1])))
    print(f"busy {rec['busy_s']:.4f} s of a {rec['window_s']:.4f} s window")
    return 0


if __name__ == "__main__":
    sys.exit(main())
