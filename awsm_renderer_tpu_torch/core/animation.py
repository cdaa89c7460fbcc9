"""CPU-side animation system: players, clips, samplers.

Mirrors reference behavior: crates/renderer/src/animation/
(animations.rs `Animations`/`update_animations`, player.rs:7-105
`AnimationPlayer` state machine, interpolate.rs:6-117 Linear/Step/
CubicSpline over Vec3/Quat/scalar/weights, data.rs channel targets).
Samplers are vectorized numpy over keyframe tables; per-frame output is
applied to transform keys and mesh morph weights.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Union

import numpy as np

from ..errors import AnimationError
from ..utils import math3d as m3
from ..utils.profiling import count

F = np.float32


class Interpolation(enum.Enum):
    LINEAR = "LINEAR"
    STEP = "STEP"
    CUBIC_SPLINE = "CUBICSPLINE"


class TargetPath(enum.Enum):
    TRANSLATION = "translation"
    ROTATION = "rotation"
    SCALE = "scale"
    WEIGHTS = "weights"


class LoopStyle(enum.Enum):
    """Reference: player.rs loop styles."""

    ONCE = 0
    LOOP = 1
    PING_PONG = 2


@dataclass
class AnimationSampler:
    """Keyframe sampler (reference: interpolate.rs)."""

    times: np.ndarray        # (K,) f32, ascending
    values: np.ndarray       # (K, D) — or (K, 3, D) for cubic spline (in-tangent, value, out-tangent)
    interpolation: Interpolation = Interpolation.LINEAR

    def __post_init__(self):
        self.times = np.asarray(self.times, dtype=F).reshape(-1)
        self.values = np.asarray(self.values, dtype=F)

    @property
    def duration(self) -> float:
        return float(self.times[-1]) if len(self.times) else 0.0

    def sample(self, t: float, is_rotation: bool = False) -> np.ndarray:
        times = self.times
        K = len(times)
        if K == 0:
            raise AnimationError("empty sampler (no keyframes)")
        if K == 1 or t <= times[0]:
            v = self.values[0]
            return v[1] if self.interpolation == Interpolation.CUBIC_SPLINE else v
        if t >= times[-1]:
            v = self.values[-1]
            return v[1] if self.interpolation == Interpolation.CUBIC_SPLINE else v
        i = int(np.searchsorted(times, t, side="right")) - 1
        i = min(i, K - 2)
        t0, t1 = float(times[i]), float(times[i + 1])
        dt = max(t1 - t0, 1e-9)
        u = (t - t0) / dt

        if self.interpolation == Interpolation.STEP:
            return self.values[i]
        if self.interpolation == Interpolation.CUBIC_SPLINE:
            # values[k] = (in_tangent, value, out_tangent)
            p0 = self.values[i, 1]
            m0 = self.values[i, 2] * dt
            p1 = self.values[i + 1, 1]
            m1 = self.values[i + 1, 0] * dt
            u2, u3 = u * u, u * u * u
            out = (
                (2 * u3 - 3 * u2 + 1) * p0
                + (u3 - 2 * u2 + u) * m0
                + (-2 * u3 + 3 * u2) * p1
                + (u3 - u2) * m1
            )
            if is_rotation:
                out = m3.quat_normalize(out)
            return out.astype(F)
        # LINEAR
        v0, v1 = self.values[i], self.values[i + 1]
        if is_rotation:
            return m3.quat_slerp(v0, v1, u)
        return ((1 - u) * v0 + u * v1).astype(F)


@dataclass
class AnimationChannel:
    sampler: AnimationSampler
    path: TargetPath
    transform_key: Optional[int] = None   # for translation/rotation/scale
    mesh_key: Optional[int] = None        # for weights


@dataclass
class AnimationClip:
    channels: List[AnimationChannel] = field(default_factory=list)
    name: str = ""

    @property
    def duration(self) -> float:
        return max((c.sampler.duration for c in self.channels), default=0.0)


@dataclass
class AnimationPlayer:
    """Playback state machine (reference: player.rs:7-105).

    weight: blend contribution when several playing clips target the
    same node/path (Fox-class: multiple clips on ONE skeleton). 1.0 and
    a unique target = direct application (the reference's behavior);
    otherwise values blend weighted (quaternions sign-aligned nlerp).
    Drives Animations.crossfade."""

    clip: AnimationClip
    speed: float = 1.0
    loop_style: LoopStyle = LoopStyle.LOOP
    playing: bool = True
    time: float = 0.0
    direction: float = 1.0
    weight: float = 1.0

    def advance(self, dt: float) -> float:
        if not self.playing:
            return self.time
        dur = self.clip.duration
        if dur <= 0:
            return 0.0
        self.time += dt * self.speed * self.direction
        if self.loop_style == LoopStyle.ONCE:
            if self.time >= dur:
                self.time = dur
                self.playing = False
            elif self.time < 0:
                self.time = 0.0
                self.playing = False
        elif self.loop_style == LoopStyle.LOOP:
            self.time %= dur
            if self.time < 0:
                self.time += dur
        else:  # PING_PONG
            if self.time > dur:
                self.time = dur - (self.time - dur)
                self.direction *= -1
            elif self.time < 0:
                self.time = -self.time
                self.direction *= -1
        return self.time


class Animations:
    """Reference: animation/animations.rs:39-120.

    Per-frame keyframe sampling (binary search + lerp/slerp per channel)
    runs in the native C++ runtime when available (native/awsm_host.cpp
    sample_channels — the tier the reference implements in Rust); cubic-
    spline channels and the python fallback use AnimationSampler directly.
    """

    def __init__(self):
        self._players: Dict[int, AnimationPlayer] = {}
        self._next_key = 1
        self._native_tables = None  # rebuilt when the player set changes
        self._fades: List[list] = []  # [from_key, to_key, t, duration]

    def insert(self, player: AnimationPlayer) -> int:
        key = self._next_key
        self._next_key += 1
        self._players[key] = player
        self._native_tables = None
        return key

    def get(self, key: int) -> AnimationPlayer:
        try:
            return self._players[key]
        except KeyError:
            raise AnimationError(
                f"unknown or removed animation player key {key}") from None

    def remove(self, key: int) -> None:
        if key not in self._players:
            raise AnimationError(
                f"unknown or removed animation player key {key}")
        del self._players[key]
        self._native_tables = None

    def items(self):
        return self._players.items()

    @property
    def count(self) -> int:
        return len(self._players)

    def _build_native_tables(self):
        """Flatten LINEAR/STEP channels of all players into the concatenated
        arrays the C++ sampler consumes. Cubic-spline channels stay python."""
        entries = []  # (player, channel, mode, D)
        times_parts, values_parts = [], []
        t_off, t_len, v_off, dim, mode, out_off = [], [], [], [], [], []
        to_cur = vo_cur = oo_cur = 0
        for player in self._players.values():
            for ch in player.clip.channels:
                if ch.sampler.interpolation == Interpolation.CUBIC_SPLINE:
                    continue
                vals = ch.sampler.values.reshape(len(ch.sampler.times), -1)
                D = vals.shape[1]
                is_rot = ch.path == TargetPath.ROTATION
                entries.append((player, ch, D))
                times_parts.append(ch.sampler.times)
                values_parts.append(vals.reshape(-1))
                t_off.append(to_cur)
                t_len.append(len(ch.sampler.times))
                v_off.append(vo_cur)
                dim.append(D)
                mode.append(2 if is_rot and D == 4 else
                            (1 if ch.sampler.interpolation == Interpolation.STEP else 0))
                out_off.append(oo_cur)
                to_cur += len(ch.sampler.times)
                vo_cur += vals.size
                oo_cur += D
        import numpy as _np

        self._native_tables = {
            "entries": entries,
            "times": _np.concatenate(times_parts).astype(_np.float32)
            if times_parts else _np.zeros(0, _np.float32),
            "values": _np.concatenate(values_parts).astype(_np.float32)
            if values_parts else _np.zeros(0, _np.float32),
            "t_off": _np.asarray(t_off, _np.int64),
            "t_len": _np.asarray(t_len, _np.int32),
            "v_off": _np.asarray(v_off, _np.int64),
            "dim": _np.asarray(dim, _np.int32),
            "mode": _np.asarray(mode, _np.int32),
            "out_off": _np.asarray(out_off, _np.int64),
            "out_size": oo_cur,
        }

    def crossfade(self, from_key: int, to_key: int, duration: float) -> None:
        """Blend playback from one clip to another over `duration`
        seconds (Fox-class clip switching on one skeleton). The target
        clip starts playing at weight 0 and ramps to 1 while the source
        ramps to 0; at the end the source stops and both weights reset.
        duration <= 0 switches instantly."""
        src = self.get(from_key)
        dst = self.get(to_key)
        dst.playing = True
        if duration <= 0.0:
            src.playing = False
            src.weight = 1.0
            dst.weight = 1.0
            return
        dst.weight = 0.0
        self._fades.append([from_key, to_key, 0.0, float(duration)])

    def _apply(self, ch, v, transforms, meshes) -> None:
        if ch.path == TargetPath.WEIGHTS:
            if ch.mesh_key is not None:
                meshes.update_morph_weights(ch.mesh_key, np.atleast_1d(v))
            return
        if ch.transform_key is None:
            return
        if ch.path == TargetPath.TRANSLATION:
            transforms.set_translation(ch.transform_key, v)
        elif ch.path == TargetPath.ROTATION:
            transforms.set_rotation(ch.transform_key, m3.quat_normalize(v))
        elif ch.path == TargetPath.SCALE:
            transforms.set_scale(ch.transform_key, v)

    @staticmethod
    def _blend(entries, is_rotation: bool):
        """Weighted blend of [(value, weight)] samples: normalized
        weighted mean; quaternions sign-align to the first then nlerp
        (the standard animation-blend approximation)."""
        total = sum(w for _, w in entries)
        if total <= 1e-9:
            return entries[0][0]
        first = np.asarray(entries[0][0], np.float32)
        acc = np.zeros_like(first, dtype=np.float64)
        for v, w in entries:
            v = np.asarray(v, np.float64).reshape(first.shape)
            if is_rotation and np.dot(v, np.asarray(first, np.float64)) < 0:
                v = -v
            acc += v * (w / total)
        out = acc.astype(np.float32)
        return m3.quat_normalize(out) if is_rotation else out

    def update(self, dt: float, transforms, meshes) -> None:
        """Sample all playing clips and apply to targets
        (reference: animations.rs:84 update_animations). Values from
        several playing clips that target the same node/path blend by
        player weight (crossfade support); the common one-clip-per-
        target case applies directly, exactly as before."""
        from ..utils import native

        # advance crossfades first: they ramp player weights/playing
        for fade in list(self._fades):
            fade[2] += dt
            src = self._players.get(fade[0])
            dst = self._players.get(fade[1])
            u = min(fade[2] / max(fade[3], 1e-9), 1.0)
            if dst is not None:
                dst.weight = u
            if src is not None:
                src.weight = 1.0 - u
            if u >= 1.0:
                if src is not None:
                    src.playing = False
                    src.weight = 1.0
                    # rewind: a stopped player with time != 0 stays in
                    # the active set (holding a finished ONCE pose) and
                    # would keep contributing at full weight — after a
                    # fade INTO an earlier-inserted clip the last-writer
                    # tie-break would then snap back to the faded-OUT
                    # pose (r4 review finding)
                    src.time = 0.0
                if dst is not None:
                    dst.weight = 1.0
                self._fades.remove(fade)

        active_players = [p for p in self._players.values()
                          if p.playing or p.time != 0.0]
        if not active_players:
            return
        for player in active_players:
            player.advance(dt)

        if self._native_tables is None:
            self._build_native_tables()
        nt = self._native_tables
        used_native = False
        # sampled contributions keyed by target: blended before applying.
        # Each entry carries its (player insertion index, channel index)
        # so the full-weight "last writer wins" tie-break follows player
        # insertion order — matching the reference's in-order channel
        # application (animations.rs update_animations) — regardless of
        # whether the entry arrived via the native table or the python
        # (cubic-spline) sampling path (r4 advisor finding: stash order
        # was native-first, so a cubic clip always won the tie).
        contrib: Dict[tuple, list] = {}
        _order = {}
        for pi, p in enumerate(self._players.values()):
            for ci, c in enumerate(p.clip.channels):
                _order[(id(p), id(c))] = (pi, ci)

        def _stash(player, ch, v):
            if ch.path == TargetPath.WEIGHTS:
                key = ("w", ch.mesh_key, ch.path)
            else:
                key = ("t", ch.transform_key, ch.path)
            contrib.setdefault(key, []).append(
                (ch, v, player.weight, _order[(id(player), id(ch))]))

        if nt["entries"]:
            t = np.asarray([p.time for p, _, _ in nt["entries"]], np.float32)
            out = np.zeros(nt["out_size"], np.float32)
            used_native = native.sample_channels(
                nt["times"], nt["values"], nt["t_off"], nt["t_len"],
                nt["v_off"], nt["dim"], nt["mode"], t, nt["out_off"], out)
            if used_native:
                for (player, ch, D), oo in zip(nt["entries"], nt["out_off"]):
                    if not player.playing and player.time == 0.0:
                        continue
                    _stash(player, ch, out[oo : oo + D])

        # python path: cubic-spline channels always; everything when the
        # native library is unavailable
        for player in active_players:
            for ch in player.clip.channels:
                cubic = ch.sampler.interpolation == Interpolation.CUBIC_SPLINE
                if used_native and not cubic:
                    continue
                v = ch.sampler.sample(
                    player.time, is_rotation=(ch.path == TargetPath.ROTATION))
                _stash(player, ch, v)

        count("animation/channels", sum(len(e) for e in contrib.values()))
        for key, entries in contrib.items():
            ch = entries[0][0]
            if len(entries) == 1:
                self._apply(ch, entries[0][1], transforms, meshes)
            elif all(w == 1.0 for _, _, w, _ in entries):
                # several full-weight clips on one target: sequential
                # overwrite, last writer wins BY PLAYER/CHANNEL
                # INSERTION ORDER — the reference applies channels in
                # order (animations.rs update_animations), so this is
                # exact parity outside a crossfade
                last = max(entries, key=lambda e: e[3])
                self._apply(last[0], last[1], transforms, meshes)
            else:
                v = self._blend([(v, w) for _, v, w, _ in entries],
                                is_rotation=(ch.path == TargetPath.ROTATION))
                self._apply(ch, v, transforms, meshes)
