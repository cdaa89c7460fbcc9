"""What the traced run reads besides the program's own spans and
counters: host syncs a frame (torch's sync debug mode) and a
torch.profiler device trace of a few frames, reduced to device busy
time, kernels by name, and the idle gaps labelled by the host range that
was open when the device went idle."""

from __future__ import annotations

import collections
import gzip
import json
import os
import warnings


def count_syncs(render) -> int:
    """Host waits on the device during one call of render(): torch's sync
    debug mode warns at every call that synchronizes. A wait that does
    not go through torch is not seen."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            render()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sum(1 for w in caught if "synchroniz" in str(w.message))


def profile_frames(frame, n: int, path: str) -> dict:
    """Run frame(i) for i in range(n) under torch.profiler (CPU and CUDA
    activities), each inside a "bench/frame" range, and reduce the
    trace (written to `path`, then removed)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        for i in range(n):
            with record_function("bench/frame"):
                frame(i)
        torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    try:
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt") as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return reduce(events, n)


_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def reduce(events, n_frames: int) -> dict:
    """Chrome-trace events -> the device's view of the traced frames."""
    dev, ranges, frames = [], [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        t0, d = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        if cat in _DEVICE_CATS:
            dev.append((t0, t0 + d, e.get("name", "?"), cat))
        elif cat == "user_annotation":
            if e.get("name") == "bench/frame":
                frames.append((t0, t0 + d))
            ranges.append((t0, t0 + d, e.get("name", "?")))
    if not frames:
        raise ValueError("the trace holds no bench/frame range")
    w0 = min(f[0] for f in frames)
    w1 = max(max(f[1] for f in frames), max((x[1] for x in dev), default=w0))
    dev.sort()
    busy, gaps, cur0, cur1 = 0.0, [], None, None
    for t0, t1, _, _ in dev:
        if cur1 is None or t0 > cur1:
            if cur1 is not None:
                busy += cur1 - cur0
                gaps.append((cur1, t0))
            elif t0 > w0:
                gaps.append((w0, t0))
            cur0, cur1 = t0, t1
        else:
            cur1 = max(cur1, t1)
    if cur1 is not None:
        busy += cur1 - cur0
        if w1 > cur1:
            gaps.append((cur1, w1))
    by_name = collections.defaultdict(float)
    for t0, t1, name, _ in dev:
        by_name[name] += (t1 - t0) * 1e-6
    # a gap is labelled by the innermost host range open at its start
    ranges.sort(key=lambda r: r[1] - r[0])
    gap_time = collections.defaultdict(float)
    for g0, g1 in gaps:
        label = next((r[2] for r in ranges if r[0] <= g0 < r[1]), "(none)")
        gap_time[label] += (g1 - g0) * 1e-6
    return {
        "frames": n_frames,
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": busy * 1e-6,
        "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1]),
        "n_kernels": sum(1 for x in dev if x[3] == "kernel"),
        "idle_by_range": sorted(gap_time.items(), key=lambda kv: -kv[1]),
    }
