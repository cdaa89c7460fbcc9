"""orbit: one viewer whose camera circles the configuration's target at
its radius and height, looking at the target, step_rad a frame from
start_rad plus a seed-drawn offset in [0, seed_offset_rad); step_rad 0
is a still camera. A mix of this driver is data (traffic/<mix>.json with
"driver": "orbit"); a new kind of traffic is a new module here, found by
the name its mix gives.

A driver module has make(mix, scene, seed, renderer=None, render=None)
returning an object with:
  warmup()   set-up: renders every shape the window can meet
  step(i)    frame i's input and its render call; returns the image
  shown(i)   (scene, view, projection) of frame i, for the reference
"""

from __future__ import annotations

import math

import numpy as np

from port_bench.scene import look_at, perspective


class Orbit:
    def __init__(self, mix: dict, scene, seed: int, renderer=None,
                 render=None):
        rng = np.random.default_rng([seed, 1])
        cam, st = scene.camera, scene.settings
        self.scene, self.r, self.render = scene, renderer, render
        self.a0 = float(mix["start_rad"]) + float(
            rng.uniform(0.0, float(mix["seed_offset_rad"])))
        self.step_rad = float(mix["step_rad"])
        self.radius = float(cam["radius"])
        self.height = float(cam["height"])
        self.target = [float(x) for x in cam.get("target", (0, 0, 0))]
        self.proj = perspective(float(cam["fov_y"]),
                                int(st["width"]) / int(st["height"]),
                                float(cam["near"]), float(cam["far"]))
        self.warmup_views = int(mix["warmup_views"])

    def camera(self, i: int):
        """(view, projection) of frame i of the window."""
        return self._at(self.a0 + self.step_rad * i)

    def warmup(self) -> None:
        """Views spread over the whole circle: every frame size the window
        can meet is allocated before it opens."""
        n = self.warmup_views
        for k in range(n):
            self.r.camera.update(*self._at(self.a0 + 2 * math.pi * k / n))
            self.render()

    def step(self, i: int):
        self.r.camera.update(*self.camera(i))
        return self.render()

    def shown(self, i: int):
        return (self.scene, *self.camera(i))

    def _at(self, a: float):
        t = self.target
        eye = [t[0] + math.cos(a) * self.radius, t[1] + self.height,
               t[2] + math.sin(a) * self.radius]
        return look_at(eye, t, [0, 1, 0]), self.proj


def make(mix: dict, scene, seed: int, renderer=None, render=None) -> Orbit:
    return Orbit(mix, scene, seed, renderer, render)
