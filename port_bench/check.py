"""How `correct` is decided: frames drawn from the seed among all the
window's frames are copied out as the program displayed them; once the
window has closed and the program is freed, the plain reference renders
what the driver says each frame showed (its scene and camera), and each
displayed image is held against it.

Three numbers a frame, the worst frame counting:
  bad_px    the share of pixels whose display colour differs from the
            reference's by more than pixel_tol in some channel (r, g, b
            or coverage alpha): what a viewer sees as wrong;
  bad_tile  that share in the worst 32 x 32 window of the image (windows
            at a stride of 16): a wrong object or block, too small a part
            of the frame to move bad_px;
  mean_abs  the mean absolute difference over r, g, b and every pixel:
            a drift too small for any one pixel to cross pixel_tol.
Each has its limit in the configuration's "check" group, set from the
program's readings over many seeds, the control's (the reference in
bfloat16) and the planted faults' (faults.py; control.py collects them).
"""

from __future__ import annotations

import numpy as np

NAMES = ("bad_px", "bad_tile", "mean_abs")
TILE, TILE_STRIDE = 32, 16


class Reservoir:
    """k frames drawn uniformly, from the seed, among all the frames that
    finish inside the window, however many that is (Vitter's algorithm
    R): whether frame i is a candidate is drawn before it runs, so only a
    candidate's image is copied (to pinned host memory on the card, with
    the frame's own synchronize), and it is kept only if the frame
    finishes inside the window."""

    def __init__(self, seed: int, k: int, shape, pin_memory: bool):
        import torch

        self.rng = np.random.default_rng([seed, 2])
        self.k = k
        self.buf = [torch.empty(shape, dtype=torch.float32,
                                pin_memory=pin_memory) for _ in range(k + 1)]
        self.free = list(range(k + 1))
        self.stage = self.free.pop()
        self.held = []                  # (frame, buffer)

    def wants(self, i: int) -> bool:
        return i < self.k or self.rng.random() < self.k / (i + 1)

    def copy(self, out, non_blocking: bool) -> None:
        self.buf[self.stage].copy_(out, non_blocking=non_blocking)

    def keep(self, i: int) -> None:
        """Frame i, copied, finished inside the window."""
        if len(self.held) < self.k:
            self.held.append((i, self.stage))
            self.stage = self.free.pop()
        else:
            j = int(self.rng.integers(self.k))
            self.held[j], self.stage = (i, self.stage), self.held[j][1]

    def frames(self):
        """[(frame index, image)] in frame order."""
        return [(i, self.buf[b]) for i, b in sorted(self.held)]


def compare(shown, ref, pixel_tol: float) -> dict:
    """Numbers of one frame: shown and ref (H, W, 4) tensors."""
    import torch.nn.functional as tf

    d = (shown.float() - ref.float().to(shown.device)).abs()
    bad = (d.amax(-1) > pixel_tol).float()
    tiles = tf.avg_pool2d(bad[None, None], TILE, TILE_STRIDE)
    return {"bad_px": float(bad.mean()), "bad_tile": float(tiles.max()),
            "mean_abs": float(d[..., :3].mean())}


def judge(per_frame, limits: dict):
    """(correct, worst numbers, the frames that failed)."""
    worst = {n: max(f[n] for f in per_frame) for n in NAMES}
    failed = sum(1 for f in per_frame
                 if any(limits.get(n) is None or f[n] > limits[n]
                        for n in NAMES))
    ok = bool(per_frame) and failed == 0
    return ok, worst, failed


def render_reference(frames, device, dtype=None, reference=None):
    """Reference images of `frames` [(scene, view, proj)], one at a time;
    a scene's tables are built once for each run of frames that show it.
    reference: the configuration's own reference class (its module's
    `Reference`), else the shared one, reference.render.Reference."""
    import torch

    if reference is None:
        from .reference.render import Reference as reference

    refs = {}
    for scene, view, proj in frames:
        if id(scene) not in refs:
            refs = {id(scene): reference(scene, device,
                                         dtype or torch.float32)}
        yield refs[id(scene)].render(view, proj)
