"""animate: one viewer watching an animated scene from a still camera.
Closed loop: a frame is update_all(dt), every animation player advanced
by dt and the poses it drives (joints, skins, morph weights) updated,
then the render call. The warm-up renders warmup_frames such frames, so
the players have advanced warmup_frames + i + 1 steps when the window's
frame i is drawn.

The camera is the configuration's "eye" looking at its "target".
shown(i) is worked out here alone, from the clips in scene.meta: each
player's time by the player's own recurrence (reference/pose.py
player_time, float64), the scene posed there by reference/pose.py; never
from the program's state.
"""

from __future__ import annotations

from port_bench.reference import pose
from port_bench.scene import look_at, perspective


class Animate:
    def __init__(self, mix: dict, scene, seed: int, renderer=None,
                 render=None):
        cam, st = scene.camera, scene.settings
        self.scene, self.r, self.render = scene, renderer, render
        self.dt = float(mix["dt"])
        self.warmup_frames = int(mix["warmup_frames"])
        self.view = look_at(cam["eye"], cam["target"], [0, 1, 0])
        self.proj = perspective(float(cam["fov_y"]),
                                int(st["width"]) / int(st["height"]),
                                float(cam["near"]), float(cam["far"]))
        self.next = None

    def warmup(self) -> None:
        self.r.camera.update(self.view, self.proj)
        for _ in range(self.warmup_frames):
            self.r.update_all(self.dt)
            self.render()
        self.next = 0

    def step(self, i: int):
        assert i == self.next, f"frame {i} out of order (expected {self.next})"
        self.next = i + 1
        self.r.update_all(self.dt)
        return self.render()

    def times(self, i: int):
        """[(body clip time, face clip time)] of each avatar as frame i
        shows it."""
        n = self.warmup_frames + i + 1
        at = {}
        out = []
        for clip in self.scene.meta["rig"]["clips"]:
            dur = float(clip["times"][-1])
            if dur not in at:
                at[dur] = pose.player_time(n, self.dt, dur)
            out.append((at[dur], at[dur]))
        return out

    def shown(self, i: int):
        return pose.pose_scene(self.scene, self.times(i)), self.view, \
            self.proj


def make(mix: dict, scene, seed: int, renderer=None, render=None) -> Animate:
    return Animate(mix, scene, seed, renderer, render)
