"""Channel-column vector helpers for full-frame shading math.

Every vector here is a plain Python list of flat (P,) tensors — [x, y, z]
or [r, g, b, a] — the layout of awsm_renderer_tpu/ops/cvec.py, kept so
the port's shading reads line for line like the reference. Entries may
also be Python floats (constants that the reference folds the same way).
"""

from __future__ import annotations

import torch

_EPS = 1e-6


def add(a, b):
    return [x + y for x, y in zip(a, b)]


def sub(a, b):
    return [x - y for x, y in zip(a, b)]


def mul(a, b):
    """Hadamard product of two channel lists."""
    return [x * y for x, y in zip(a, b)]


def scale(a, s):
    """Channel list times a (P,) tensor or scalar."""
    return [x * s for x in a]


def lerp(a, b, t):
    return [x + (y - x) * t for x, y in zip(a, b)]


def where(c, a, b):
    """Per-channel select; c is a (P,) bool tensor."""
    return [torch.where(c, x, y) for x, y in zip(a, b)]


def dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def cross3(a, b):
    return [a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0]]


def norm3(a, eps=_EPS):
    m = torch.clamp(torch.sqrt(dot3(a, a)), min=eps)
    inv = 1.0 / m
    return [x * inv for x in a]
