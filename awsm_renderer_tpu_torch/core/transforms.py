"""Scene-graph transform store.

Mirrors reference behavior: crates/renderer/src/transforms.rs
(local TRS + parent/child maps; `update_world()` propagates dirty subtrees;
world matrices and normal matrices land in two storage buffers). Here the
"storage buffers" are capacity-padded numpy mirrors uploaded to device
arrays by the scene flush; keys are SlotAllocator keys (row indices into
those arrays), the analog of `TransformKey`.

The per-frame hot loop (TRS composition + matrix propagation + normal
matrices) runs in the native C++ runtime (native/awsm_host.cpp
world_propagate/compose_trs — the tier the reference implements in Rust),
with numpy fallbacks.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

import numpy as np

from ..utils import math3d as m3
from ..utils import native
from ..utils.allocator import SlotAllocator

F = np.float32


@dataclass
class Transform:
    """Local TRS (reference: transforms.rs:458 `Transform` struct)."""

    translation: np.ndarray = field(default_factory=lambda: np.zeros(3, dtype=F))
    rotation: np.ndarray = field(default_factory=m3.quat_identity)  # quat xyzw
    scale: np.ndarray = field(default_factory=lambda: np.ones(3, dtype=F))

    @staticmethod
    def from_matrix(m: np.ndarray) -> "Transform":
        t, r, s = m3.mat4_decompose(np.asarray(m, dtype=F))
        return Transform(t, r, s)

    def to_matrix(self) -> np.ndarray:
        return m3.trs_to_mat4(self.translation, self.rotation, self.scale)

    def to_row(self) -> np.ndarray:
        return np.concatenate([
            np.asarray(self.translation, F).reshape(3),
            np.asarray(self.rotation, F).reshape(4),
            np.asarray(self.scale, F).reshape(3),
        ])


class Transforms:
    def __init__(self, initial_capacity: int = 64):
        self._alloc = SlotAllocator(initial_capacity)
        self._resize(initial_capacity)
        self._parent: Dict[int, Optional[int]] = {}
        self._children: Dict[int, List[int]] = {}
        self._dirty: np.ndarray = np.zeros(initial_capacity, dtype=np.uint8)
        self._order: np.ndarray = np.zeros(0, dtype=np.int32)  # topo row order
        self._topo_dirty = True
        self.gpu_dirty = True  # whole-array upload flag for the scene flush

    @property
    def gpu_dirty(self) -> bool:
        return self._gpu_dirty

    @gpu_dirty.setter
    def gpu_dirty(self, v: bool) -> None:
        # monotonic version for host-side derived-state caches (the
        # renderer's per-frame prep memo keys on it: world matrices feed
        # the world AABBs that drive frustum culling and tile caps)
        self._gpu_dirty = bool(v)
        if v:
            self.mutation_count = getattr(self, "mutation_count", 0) + 1

    def _resize(self, capacity: int) -> None:
        self.world = np.tile(np.eye(4, dtype=F), (capacity, 1, 1))
        self.normal = np.tile(np.eye(3, dtype=F), (capacity, 1, 1))
        self._local_trs = np.zeros((capacity, 10), dtype=F)
        self._local_trs[:, 6] = 1.0  # quat w
        self._local_trs[:, 7:10] = 1.0
        self._local_mat = np.tile(np.eye(4, dtype=F).reshape(16), (capacity, 1))
        self._parent_row = np.full(capacity, -1, dtype=np.int32)
        self._local_dirty = np.zeros(capacity, dtype=bool)

    def _grow(self) -> None:
        cap = self._alloc.capacity
        old = (self.world, self.normal, self._local_trs, self._local_mat,
               self._parent_row, self._local_dirty, self._dirty)
        self._resize(cap)
        n = old[0].shape[0]
        self.world[:n] = old[0]
        self.normal[:n] = old[1]
        self._local_trs[:n] = old[2]
        self._local_mat[:n] = old[3]
        self._parent_row[:n] = old[4]
        self._local_dirty[:n] = old[5]
        dirty = np.zeros(cap, dtype=np.uint8)
        dirty[:n] = old[6]
        self._dirty = dirty

    # -- public API (mirrors transforms.rs insert/set_local/set_parent) -----

    def insert(self, transform: Optional[Transform] = None, parent: Optional[int] = None) -> int:
        key = self._alloc.insert()
        if self._alloc.take_needs_resize():
            self._grow()
        t = transform or Transform()
        row = self._alloc.row_of(key)
        self._parent[key] = parent
        self._children[key] = []
        self._parent_row[row] = self._alloc.row_of(parent) if parent is not None else -1
        if parent is not None:
            self._children[parent].append(key)
        self._write_columns(key, 0, t.to_row())
        self._topo_dirty = True
        return key

    def remove(self, key: int) -> None:
        for child in list(self._children.get(key, [])):
            self.remove(child)
        parent = self._parent.pop(key, None)
        if parent is not None and parent in self._children:
            self._children[parent].remove(key)
        self._children.pop(key, None)
        row = self._alloc.row_of(key)
        self._dirty[row] = 0
        self._local_dirty[row] = False
        self._parent_row[row] = -1
        self._alloc.remove(key)
        self._topo_dirty = True

    def _write_columns(self, key: int, col: int, values: np.ndarray) -> None:
        """Columns col: of key's row in the local TRS table; the row's
        other columns keep what they hold."""
        row = self._alloc.row_of(key)
        self._local_trs[row, col : col + len(values)] = values
        self._local_dirty[row] = True
        self._dirty[row] = 1

    def write_local_elements(self, rows: np.ndarray, cols: np.ndarray,
                             values: np.ndarray) -> None:
        """Many local TRS entries at once: element i of `values` to
        (rows[i], cols[i]), and those rows marked for the next
        update_world. The animation table's write; a set_translation /
        set_rotation / set_scale per element, in one scatter."""
        self._local_trs[rows, cols] = values
        self._local_dirty[rows] = True
        self._dirty[rows] = 1

    def set_local(self, key: int, transform: Transform) -> None:
        self._write_columns(key, 0, transform.to_row())

    def get_local(self, key: int) -> Transform:
        """The local TRS as the table holds it (a copy: edit it, then
        set_local)."""
        row = self._local_trs[self._alloc.row_of(key)]
        return Transform(row[0:3].copy(), row[3:7].copy(), row[7:10].copy())

    def set_translation(self, key: int, t) -> None:
        self._write_columns(key, 0, np.asarray(t, F).reshape(3))

    def set_rotation(self, key: int, q) -> None:
        self._write_columns(key, 3, np.asarray(q, F).reshape(4))

    def set_scale(self, key: int, s) -> None:
        self._write_columns(key, 7, np.asarray(s, F).reshape(3))

    def set_parent(self, key: int, parent: Optional[int]) -> None:
        old = self._parent.get(key)
        if old is not None and old in self._children:
            self._children[old].remove(key)
        self._parent[key] = parent
        if parent is not None:
            self._children[parent].append(key)
        row = self._alloc.row_of(key)
        self._parent_row[row] = self._alloc.row_of(parent) if parent is not None else -1
        self._dirty[row] = 1
        self._topo_dirty = True

    def row_of(self, key: int) -> int:
        return self._alloc.row_of(key)

    @property
    def rows_version(self) -> int:
        """Changes whenever a key gains or loses its row: tables of
        rows built from keys hold while it does."""
        return self._alloc.version

    @property
    def capacity(self) -> int:
        return self._alloc.capacity

    def world_of(self, key: int) -> np.ndarray:
        return self.world[self._alloc.row_of(key)]

    def _rebuild_topo(self) -> None:
        order: List[int] = []
        stack = [k for k, p in self._parent.items() if p is None]
        # DFS, parents before children (stack order doesn't matter for that)
        while stack:
            k = stack.pop()
            order.append(self._alloc.row_of(k))
            stack.extend(self._children.get(k, []))
        self._order = np.asarray(order, dtype=np.int32)
        self._topo_dirty = False

    # -- per-frame update (mirrors transforms.rs:244 update_world) ----------

    def update_world(self) -> Set[int]:
        """Propagate dirty local transforms down their subtrees.

        Returns the set of keys whose world matrix changed this frame.
        """
        if not self._dirty.any():
            return set()
        if self._topo_dirty:
            self._rebuild_topo()

        rows = np.nonzero(self._local_dirty)[0]
        if len(rows):
            self._local_mat[rows] = native.compose_trs(
                self._local_trs[rows]).reshape(len(rows), 16)
            self._local_dirty[:] = False

        changed_mask = native.world_propagate(
            self._order, self._parent_row, self._local_mat,
            self.world.reshape(-1, 16), self.normal.reshape(-1, 9), self._dirty,
        )
        self._dirty[:] = 0
        changed_rows = set(np.nonzero(changed_mask)[0].tolist())
        changed = {k for k, r in self._alloc.items() if r in changed_rows}
        if changed:
            self.gpu_dirty = True
        return changed
