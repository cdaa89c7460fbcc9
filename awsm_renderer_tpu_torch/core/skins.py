"""Skin store: joint matrices computed from the transform graph.

Mirrors reference behavior: crates/renderer/src/meshes/skins.rs:23-307
(joint matrices in a storage buffer, 64 B each; `update_transforms(dirty)`
recomputes joint matrices for skins whose joints moved). Joint matrix =
world(joint) @ inverse_bind_matrix; skinned vertices use it INSTEAD of the
mesh node's world matrix (glTF skinning semantics).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Set

import numpy as np

from ..errors import SkinError

from ..utils.allocator import BuddyAllocator
from ..utils.profiling import count

F = np.float32


@dataclass
class _Skin:
    joint_keys: List[int]          # transform keys of the joints
    inverse_bind: np.ndarray       # (J, 4, 4)
    base: int                      # first row in the joint pool
    # the joints' rows in the transform store, and the store's
    # rows_version they were read at
    joint_rows: Optional[np.ndarray] = None
    rows_version: Optional[int] = None

    def rows(self, transforms) -> np.ndarray:
        if self.rows_version != transforms.rows_version:
            self.joint_rows = np.array(
                [transforms.row_of(k) for k in self.joint_keys], np.int64)
            self.rows_version = transforms.rows_version
        return self.joint_rows


class Skins:
    def __init__(self, initial_capacity: int = 64):
        self._alloc = BuddyAllocator(initial_capacity, min_block=16)
        self.joint_matrices = np.tile(np.eye(4, dtype=F), (self._alloc.capacity, 1, 1))
        self._skins: Dict[int, _Skin] = {}
        self._pending: Set[int] = set()   # inserted, matrices not yet computed
        self._key_table = None   # every skin's joint keys; see _joint_keys
        self._next_key = 1
        self.gpu_dirty = True
        self.capacity_changed = False

    def insert(self, joint_transform_keys: List[int], inverse_bind_matrices: np.ndarray) -> int:
        J = len(joint_transform_keys)
        ibm = np.asarray(inverse_bind_matrices, dtype=F).reshape(J, 4, 4)
        base = self._alloc.alloc(J)
        if self._alloc.take_needs_resize():
            old = self.joint_matrices
            self.joint_matrices = np.tile(np.eye(4, dtype=F), (self._alloc.capacity, 1, 1))
            self.joint_matrices[: old.shape[0]] = old
            self.capacity_changed = True
        key = self._next_key
        self._next_key += 1
        self._skins[key] = _Skin(list(joint_transform_keys), ibm, base)
        self._key_table = None
        # joint matrices can't be computed here (no transform graph in
        # scope): mark pending so the next flush_pending/update_transforms
        # initializes them from the CURRENT pose — without this, a skin
        # inserted over an already-posed skeleton renders bind-pose until
        # some joint happens to move (reference skins.rs computes joint
        # matrices on creation)
        self._pending.add(key)
        self.gpu_dirty = True
        return key

    def remove(self, key: int) -> None:
        skin = self._skins.pop(key)
        self._alloc.free(skin.base)
        self._key_table = None

    def joint_rows(self, key: int) -> np.ndarray:
        try:
            skin = self._skins[key]
        except KeyError:
            raise SkinError(f"unknown or removed skin key {key}") from None
        return skin.base + np.arange(len(skin.joint_keys), dtype=np.int32)

    @property
    def count(self) -> int:
        return len(self._skins)

    @property
    def capacity(self) -> int:
        return self._alloc.capacity

    def flush_pending(self, transforms) -> None:
        """Initialize joint matrices for skins inserted since the last
        update (called at render start — a new skin must reflect the
        skeleton's CURRENT pose, not bind pose)."""
        if self._pending:
            self.update_transforms(transforms, set())

    def _joint_keys(self):
        """Every skin's joint keys in one array, in the order of
        self._skins, and each skin's [start, stop) in it."""
        if self._key_table is None:
            sizes = np.array([len(s.joint_keys) for s in self._skins.values()],
                             np.int64)
            stops = np.cumsum(sizes)
            keys = np.fromiter(
                (k for s in self._skins.values() for k in s.joint_keys),
                np.int64, int(sizes.sum()))
            self._key_table = (keys, stops - sizes, stops)
        return self._key_table

    def update_transforms(self, transforms, changed_keys: Optional[Set[int]] = None) -> None:
        """Recompute joint matrices for skins touched by `changed_keys`
        (all skins when None); pending (newly inserted) skins always
        recompute. Reference: skins.rs update_transforms."""
        moved = None
        if changed_keys is not None:
            keys, starts, stops = self._joint_keys()
            hit = np.isin(keys, np.fromiter(changed_keys, np.int64,
                                            len(changed_keys)))
            total = np.concatenate(([0], np.cumsum(hit)))
            moved = total[stops] > total[starts]
        for i, (key, skin) in enumerate(self._skins.items()):
            if moved is not None and not moved[i] and key not in self._pending:
                continue
            J = len(skin.joint_keys)
            worlds = transforms.world[skin.rows(transforms)]
            self.joint_matrices[skin.base : skin.base + J] = worlds @ skin.inverse_bind
            self.gpu_dirty = True
            count("skins/joints", J)
        self._pending.clear()
