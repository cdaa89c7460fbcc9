#!/usr/bin/env python3
"""Faults planted in the animation path, for the cells whose mix calls
update_all each frame (drivers/animate.py): each a wrap(renderer, scene)
-> render entry, as faults.py's, that run.run_cell puts in the program's
place before the warm-up. The benchmark's runs use none.

    python3 port_bench/faults_animate.py --workload <cell> --seeds 1,2 \
        --wraps sound,players_paused,control_bf16 --seconds 20 [--out <json>]

takes control.py's readings (one line of JSON a run, then a summary
line) with these wraps beside faults.py's. It needs a card.
"""

from __future__ import annotations

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _is_face(player) -> bool:
    """A clip of morph-weight channels alone."""
    return all(ch.path.value == "weights" for ch in player.clip.channels)


def players_paused(r, scene):
    """Every animation player paused before its first step: the skeletons
    stay in the bind pose and the faces at their initial weights."""
    for _, p in r.animations.items():
        p.playing = False
    return r.render_device


def face_paused(r, scene):
    """The face clips' players paused: the heads follow their skeletons
    but their 52 weights stay at the initial ones."""
    for _, p in r.animations.items():
        if _is_face(p):
            p.playing = False
    return r.render_device


def body_late(r, scene):
    """The body clips one frame behind: each body player skips its first
    step, so every frame shows the skeletons' pose of the frame before
    (the faces keep time)."""
    def late(player):
        advance, skipped = player.advance, []

        def step(dt):
            if not skipped:
                skipped.append(dt)
                return player.time
            return advance(dt)
        return step

    for _, p in r.animations.items():
        if not _is_face(p):
            p.advance = late(p)
    return r.render_device


WRAPS = {f.__name__: f for f in (players_paused, face_paused, body_late)}


def main(argv=None) -> int:
    """control.py's readings, its wraps joined by these."""
    sys.path.insert(0, ROOT)
    from port_bench import control, faults

    faults.WRAPS.update(WRAPS)
    return control.main(argv)


if __name__ == "__main__":
    sys.exit(main())
