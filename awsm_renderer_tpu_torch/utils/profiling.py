"""Tracing / profiling / rate-limited debug logging.

Port of awsm_renderer_tpu/utils/profiling.py: `tracing` spans gated by
AwsmRendererLogging { render_timings } (crates/renderer/src/debug.rs:
9-63, spans in render.rs:56-356) and debug_once / debug_n rate-limited
logging. A span records host wall seconds (`frames`, the reference's
meaning) under a torch.profiler.record_function range, so the passes
show in a torch.profiler trace. On a CUDA renderer each span also
records a pair of CUDA events on the current stream: their device
seconds are kept apart, in `device_frames`, and resolved by one
synchronize at summary() / device_summary(), so a span never waits on
the device.
"""

from __future__ import annotations

import contextlib
import logging
import time
from collections import defaultdict
from typing import Dict, List

logger = logging.getLogger("awsm_renderer_tpu_torch")


def _mean(frames: List[Dict[str, float]]) -> Dict[str, float]:
    if not frames:
        return {}
    acc: Dict[str, float] = defaultdict(float)
    for f in frames:
        for k, v in f.items():
            acc[k] += v
    return {k: v / len(frames) for k, v in acc.items()}


class RenderTimings:
    """Per-pass wall timings (reference: render_timings spans); on a
    CUDA `device`, per-pass device timings beside them."""

    def __init__(self, enabled: bool = False, device=None):
        self.enabled = enabled
        self.frames: List[Dict[str, float]] = []
        self.device_frames: List[Dict[str, float]] = []
        self._current: Dict[str, float] = {}
        self._cuda = device is not None and str(device).startswith("cuda")
        self._events: Dict[str, list] = {}   # this frame's event pairs
        self._pending: List[Dict[str, list]] = []   # ended, unresolved

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.enabled:
            yield
            return
        import torch

        ev = None
        if self._cuda:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
        t0 = time.perf_counter()
        with torch.profiler.record_function(name):
            yield
        self._current[name] = self._current.get(name, 0.0) + (
            time.perf_counter() - t0)
        if ev is not None:
            ev[1].record()
            self._events.setdefault(name, []).append(ev)

    def note(self, msg: str) -> None:
        """One-line event attached to the current frame (e.g.
        'retrace: msaa, bloom' when the frame's specialization changed)."""
        logger.info(msg)
        if self.enabled:
            self._current[msg] = self._current.get(msg, 0.0)

    def end_frame(self) -> Dict[str, float]:
        frame = self._current
        self._current = {}
        events, self._events = self._events, {}
        if self.enabled:
            self.frames.append(frame)
            if self._cuda:
                self._pending.append(events)
            logger.info("frame timings: %s",
                        {k: f"{v*1000:.2f}ms" for k, v in frame.items()})
        return frame

    def _resolve(self) -> None:
        """Turn the ended frames' event pairs into device seconds (one
        synchronize for all of them)."""
        if not self._pending:
            return
        import torch

        torch.cuda.synchronize()
        for events in self._pending:
            self.device_frames.append({
                k: sum(a.elapsed_time(b) for a, b in pairs) / 1e3
                for k, pairs in events.items()})
        self._pending = []

    def summary(self) -> Dict[str, float]:
        """Mean host seconds per span over recorded frames (the device
        times of the same frames are resolved into device_frames)."""
        self._resolve()
        return _mean(self.frames)

    def device_summary(self) -> Dict[str, float]:
        """Mean device seconds per span over recorded frames ({} off the
        card)."""
        self._resolve()
        return _mean(self.device_frames)


_debug_counts: Dict[object, int] = defaultdict(int)


def debug_once(key, message: str) -> None:
    """Log a message only the first time `key` is seen (debug.rs:33)."""
    debug_n(key, message, 1)


def debug_n(key, message: str, n: int) -> None:
    """Log a message at most n times per key (debug.rs:43)."""
    if _debug_counts[key] < n:
        _debug_counts[key] += 1
        logger.warning(message)


def debug_unique_string(key, message: str) -> None:
    """Log when the message for `key` changes (debug.rs:53)."""
    if _debug_counts.get(("str", key)) != message:
        _debug_counts[("str", key)] = message
        logger.warning(message)
