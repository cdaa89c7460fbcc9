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
from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Union

import numpy as np

from ..errors import AllocatorError, AnimationError
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
        arrays the C++ sampler consumes. Cubic-spline channels stay python.
        Each entry also keeps its player's index and its (player, channel)
        insertion order."""
        players = list(self._players.values())
        entries = []  # (player, channel, D)
        ent_player, ent_order = [], []
        cubic = []  # (player index, channel index, channel)
        times_parts, values_parts = [], []
        t_off, t_len, v_off, dim, mode, out_off = [], [], [], [], [], []
        to_cur = vo_cur = oo_cur = 0
        for pi, player in enumerate(players):
            for ci, ch in enumerate(player.clip.channels):
                if ch.sampler.interpolation == Interpolation.CUBIC_SPLINE:
                    cubic.append((pi, ci, ch))
                    continue
                vals = ch.sampler.values.reshape(len(ch.sampler.times), -1)
                D = vals.shape[1]
                is_rot = ch.path == TargetPath.ROTATION
                entries.append((player, ch, D))
                ent_player.append(pi)
                ent_order.append((pi, ci))
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

        self._native_tables = {
            "players": players,
            "entries": entries,
            "player": np.asarray(ent_player, np.int64),
            "order": ent_order,
            "cubic": cubic,
            "times": np.concatenate(times_parts).astype(np.float32)
            if times_parts else np.zeros(0, np.float32),
            "values": np.concatenate(values_parts).astype(np.float32)
            if values_parts else np.zeros(0, np.float32),
            "t_off": np.asarray(t_off, np.int64),
            "t_len": np.asarray(t_len, np.int32),
            "v_off": np.asarray(v_off, np.int64),
            "dim": np.asarray(dim, np.int32),
            "mode": np.asarray(mode, np.int32),
            "out_off": np.asarray(out_off, np.int64),
            "out_size": oo_cur,
            "rows": None,   # the row table, see _row_table
        }

    def _row_table(self, nt, transforms, meshes):
        """Where each sampled channel's values go, for the channels that
        need no more than a write: the row table. A channel is in it when
        it is LINEAR or STEP (it is in the sampler's tables), no other
        channel of any player drives its target and path, and its target
        is live in its store; the rest keep the per-channel path. Built
        with the sampler's tables, and again when the transforms' or the
        meshes' rows change."""
        version = (transforms.rows_version, meshes.rows_version)
        rt = nt["rows"]
        if rt is not None and rt["version"] == version:
            return rt
        writers = Counter(_target(ch) for p in nt["players"]
                          for ch in p.clip.channels)
        table = np.zeros(len(nt["entries"]), bool)
        t_rows, t_cols, t_src, t_ent, rot_src = [], [], [], [], []
        w_rows, w_rows_ent = [], []
        w_er, w_ec, w_src, w_ent = [], [], [], []
        for e, ((_, ch, D), oo) in enumerate(
                zip(nt["entries"], nt["out_off"].tolist())):
            if writers[_target(ch)] != 1:
                continue
            if ch.path == TargetPath.WEIGHTS:
                if ch.mesh_key is None or D == 0:
                    continue
                try:
                    row = meshes.row_of(ch.mesh_key)
                except AllocatorError:
                    continue
                meshes._ensure_morph_width(D)
                w_rows.append(row)
                w_rows_ent.append(e)
                w_er += [row] * D
                w_ec += range(D)
                w_src += range(oo, oo + D)
                w_ent += [e] * D
            else:
                col, width = _TRS_COLUMNS[ch.path]
                if ch.transform_key is None or D != width:
                    continue
                try:
                    row = transforms.row_of(ch.transform_key)
                except AllocatorError:
                    continue
                if ch.path == TargetPath.ROTATION:
                    rot_src.append(range(oo, oo + 4))
                t_rows += [row] * D
                t_cols += range(col, col + D)
                t_src += range(oo, oo + D)
                t_ent += [e] * D
            table[e] = True

        def ix(a):
            return np.asarray(a, np.int64)

        rt = nt["rows"] = {
            "version": version, "table": table, "size": int(table.sum()),
            "rest": np.nonzero(~table)[0].tolist(),
            "t_rows": ix(t_rows), "t_cols": ix(t_cols), "t_src": ix(t_src),
            "t_ent": ix(t_ent), "rot_src": ix(rot_src).reshape(-1, 4),
            "w_rows": ix(w_rows), "w_rows_ent": ix(w_rows_ent),
            "w_er": ix(w_er), "w_ec": ix(w_ec), "w_src": ix(w_src),
            "w_ent": ix(w_ent),
        }
        return rt

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

    def _advance(self, dt: float):
        """Step the crossfades and the players by dt. Returns the
        (index, player) pairs that were active before the step, in
        insertion order."""
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

        active = [(pi, p) for pi, p in enumerate(self._players.values())
                  if p.playing or p.time != 0.0]
        for _, player in active:
            player.advance(dt)
        return active

    def _sample(self, nt):
        """The LINEAR/STEP channels sampled at their players' times by the
        native sampler, or None when the native library is unavailable
        (or there are no such channels)."""
        from ..utils import native

        if not nt["entries"]:
            return None
        times = np.fromiter((p.time for p in nt["players"]), np.float32,
                            len(nt["players"]))
        out = np.zeros(nt["out_size"], np.float32)
        if not native.sample_channels(
                nt["times"], nt["values"], nt["t_off"], nt["t_len"],
                nt["v_off"], nt["dim"], nt["mode"], times[nt["player"]],
                nt["out_off"], out):
            return None
        return out

    @staticmethod
    def _apply_table(nt, rt, out, transforms, meshes) -> int:
        """Write the row table's channels of the players that are active
        after their step (playing, or stopped away from time 0): their
        rows of the local TRS and morph-weight tables, one scatter each.
        Returns the number of channels written."""
        live = np.fromiter((p.playing or p.time != 0.0 for p in nt["players"]),
                           bool, len(nt["players"]))
        on = rt["table"] & live[nt["player"]]
        n = int(np.count_nonzero(on))
        if n == 0:
            return 0

        def elements(ent):
            # every table channel writes (the common case): no selection
            return slice(None) if n == rt["size"] else on[rt[ent]]

        vals = out
        if len(rt["rot_src"]):
            vals = out.copy()
            vals[rt["rot_src"]] = m3.quat_normalize_rows(out[rt["rot_src"]])
        m = elements("t_ent")
        transforms.write_local_elements(
            rt["t_rows"][m], rt["t_cols"][m], vals[rt["t_src"][m]])
        m = elements("w_ent")
        src = rt["w_src"][m]
        if src.size:
            meshes.write_morph_weights(rt["w_rows"][elements("w_rows_ent")],
                                       rt["w_er"][m], rt["w_ec"][m], out[src])
        return n

    def _apply_channels(self, nt, out, entries, active, transforms,
                        meshes) -> int:
        """The per-channel path: sampled values stashed by target, then
        applied one target at a time — directly, by last writer, or
        blended. `entries` are the indices of the sampler's entries to
        take from `out` (None: all of them); without `out`, every channel
        of the active players is sampled here instead. Cubic-spline
        channels are always sampled here. Returns the number of values
        stashed."""
        # sampled contributions keyed by target: blended before applying.
        # Each entry carries its (player insertion index, channel index)
        # so the full-weight "last writer wins" tie-break follows player
        # insertion order — matching the reference's in-order channel
        # application (animations.rs update_animations) — regardless of
        # whether the entry arrived via the native table or the python
        # (cubic-spline) sampling path (r4 advisor finding: stash order
        # was native-first, so a cubic clip always won the tie).
        contrib: Dict[tuple, list] = {}

        def _stash(order, player, ch, v):
            contrib.setdefault(_target(ch), []).append(
                (ch, v, player.weight, order))

        if out is not None:
            ents, offs = nt["entries"], nt["out_off"]
            for e in range(len(ents)) if entries is None else entries:
                player, ch, D = ents[e]
                if not player.playing and player.time == 0.0:
                    continue
                oo = offs[e]
                _stash(nt["order"][e], player, ch, out[oo : oo + D])

        # python path: cubic-spline channels always; everything when the
        # native library is unavailable
        if out is None:
            python = [(pi, ci, player, ch) for pi, player in active
                      for ci, ch in enumerate(player.clip.channels)]
        else:
            players = dict(active)
            python = [(pi, ci, players[pi], ch) for pi, ci, ch in nt["cubic"]
                      if pi in players]
        for pi, ci, player, ch in python:
            v = ch.sampler.sample(
                player.time, is_rotation=(ch.path == TargetPath.ROTATION))
            _stash((pi, ci), player, ch, v)

        for key, items in contrib.items():
            ch = items[0][0]
            if len(items) == 1:
                self._apply(ch, items[0][1], transforms, meshes)
            elif all(w == 1.0 for _, _, w, _ in items):
                # several full-weight clips on one target: sequential
                # overwrite, last writer wins BY PLAYER/CHANNEL
                # INSERTION ORDER — the reference applies channels in
                # order (animations.rs update_animations), so this is
                # exact parity outside a crossfade
                last = max(items, key=lambda e: e[3])
                self._apply(last[0], last[1], transforms, meshes)
            else:
                v = self._blend([(v, w) for _, v, w, _ in items],
                                is_rotation=(ch.path == TargetPath.ROTATION))
                self._apply(ch, v, transforms, meshes)
        return sum(len(e) for e in contrib.values())

    def update(self, dt: float, transforms, meshes) -> None:
        """Sample all playing clips and apply to targets
        (reference: animations.rs:84 update_animations). Values from
        several playing clips that target the same node/path blend by
        player weight (crossfade support); the common one-clip-per-
        target case applies directly, exactly as before.

        With the native sampler and no crossfade running, the channels
        of the row table (_row_table) are written in one scatter a
        store; the others take the per-channel path."""
        active = self._advance(dt)
        if not active:
            return
        if self._native_tables is None:
            self._build_native_tables()
        nt = self._native_tables
        out = self._sample(nt)
        n_table, rest = 0, None
        if out is not None and not self._fades:
            rt = self._row_table(nt, transforms, meshes)
            n_table = self._apply_table(nt, rt, out, transforms, meshes)
            rest = rt["rest"]
        n = self._apply_channels(nt, out, rest, active, transforms, meshes)
        count("animation/channels", n_table + n)
        count("animation/table_channels", n_table)


# a transform path's columns in the local TRS table: (first, count)
_TRS_COLUMNS = {TargetPath.TRANSLATION: (0, 3), TargetPath.ROTATION: (3, 4),
                TargetPath.SCALE: (7, 3)}


def _target(ch: AnimationChannel) -> tuple:
    """What a channel drives: channels with the same one collide."""
    if ch.path == TargetPath.WEIGHTS:
        return ("w", ch.mesh_key, ch.path)
    return ("t", ch.transform_key, ch.path)
