"""Window arithmetic of the end-to-end metrics, on host-clock readings."""

from __future__ import annotations

import math
from typing import Sequence


def frame_ms(t_open: float, finishes: Sequence[float]) -> float:
    """Window wall time per frame: from the window's opening to the finish
    of the last frame that finished inside it, over the frames finished.
    Every frame counts, stalls included."""
    if not finishes:
        raise ValueError("no frame finished inside the window")
    return (finishes[-1] - t_open) * 1e3 / len(finishes)


def percentile_ms(durations: Sequence[float], q: float) -> float:
    """The q-th percentile (nearest rank) of every frame's time, in ms."""
    if not durations:
        raise ValueError("no frame finished inside the window")
    xs = sorted(durations)
    k = max(1, math.ceil(q / 100.0 * len(xs)))
    return xs[k - 1] * 1e3
