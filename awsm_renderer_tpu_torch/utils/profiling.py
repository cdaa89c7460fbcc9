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
the device. `count` adds to cumulative event counts, kept apart from
the seconds.

The renderer makes its timings active for the duration of a frame
(`active`), so the frame graph and the ops below it open spans and count
events through the module functions `span` and `count` without taking
the timings as an argument. With no enabled timings active, both cost
one check: `span` returns a shared no-op context, `count` returns.
"""

from __future__ import annotations

import contextlib
import contextvars
import logging
import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch

logger = logging.getLogger("awsm_renderer_tpu_torch")


def _mean(frames: List[Dict[str, float]]) -> Dict[str, float]:
    if not frames:
        return {}
    acc: Dict[str, float] = defaultdict(float)
    for f in frames:
        for k, v in f.items():
            acc[k] += v
    return {k: v / len(frames) for k, v in acc.items()}


class _Span:
    """One span of an enabled RenderTimings: host seconds, a
    torch.profiler range and, on CUDA, a pair of events on the current
    stream. A span whose body raises records nothing."""

    __slots__ = ("timings", "name", "range", "events", "t0")

    def __init__(self, timings: "RenderTimings", name: str):
        self.timings, self.name = timings, name

    def __enter__(self):
        self.events = None
        if self.timings._cuda:
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        self.t0 = time.perf_counter()
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.range.__exit__(exc_type, exc, tb)
        if exc_type is not None:
            return False
        cur = self.timings._current
        cur[self.name] = cur.get(self.name, 0.0) + (
            time.perf_counter() - self.t0)
        if self.events is not None:
            self.events[1].record()
            self.timings._events.setdefault(self.name, []).append(
                self.events)
        return False


_NOOP = contextlib.nullcontext()


class RenderTimings:
    """Per-pass wall timings (reference: render_timings spans); on a
    CUDA `device`, per-pass device timings beside them; event counts
    (`counts`, cumulative over the enabled frames)."""

    def __init__(self, enabled: bool = False, device=None):
        self.enabled = enabled
        self.frames: List[Dict[str, float]] = []
        self.device_frames: List[Dict[str, float]] = []
        self.counts: Dict[str, int] = {}
        self._current: Dict[str, float] = {}
        self._cuda = device is not None and str(device).startswith("cuda")
        self._events: Dict[str, list] = {}   # this frame's event pairs
        self._pending: List[Dict[str, list]] = []   # ended, unresolved

    def span(self, name: str):
        """Context that times its body under `name` (disabled: a shared
        no-op)."""
        return _Span(self, name) if self.enabled else _NOOP

    def count(self, name: str, n: int = 1) -> None:
        """n more events `name` (disabled: nothing)."""
        if self.enabled:
            self.counts[name] = self.counts.get(name, 0) + n

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
        return frame

    def _resolve(self) -> None:
        """Turn the ended frames' event pairs into device seconds (one
        synchronize for all of them)."""
        if not self._pending:
            return
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


# the enabled timings of the frame being rendered, or None
_ACTIVE: contextvars.ContextVar[Optional[RenderTimings]] = \
    contextvars.ContextVar("awsm_active_timings", default=None)


@contextlib.contextmanager
def active(timings: RenderTimings):
    """Make `timings` the target of `span` and `count` for the body (when
    it is enabled; else none is), and restore the previous target after
    it, also when the body raises."""
    token = _ACTIVE.set(timings if timings.enabled else None)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def span(name: str):
    """RenderTimings.span on the active timings; a shared no-op when
    none is active."""
    t = _ACTIVE.get()
    return _NOOP if t is None else _Span(t, name)


def count(name: str, n: int = 1) -> None:
    """RenderTimings.count on the active timings; nothing when none is
    active."""
    t = _ACTIVE.get()
    if t is not None:
        t.count(name, n)


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
