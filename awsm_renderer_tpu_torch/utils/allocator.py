"""Slot and buddy allocators managing index space of device-resident arrays.

TPU-native analogs of the reference's GPU buffer managers:

- ``SlotAllocator`` plays the role of ``DynamicUniformBuffer``
  (reference: crates/renderer/src/buffer/dynamic_uniform.rs:40-180):
  fixed-size slots, O(1) insert/update/remove, free-slot reuse, doubling
  growth, dirty-range tracking. Here a "slot" is a row index into a
  capacity-padded JAX array instead of a byte offset into a GPU buffer.

- ``BuddyAllocator`` plays the role of ``DynamicStorageBuffer``
  (reference: crates/renderer/src/buffer/dynamic_storage.rs:39-120):
  variable-size allocations via buddy allocation, power-of-2 rounding,
  O(log N) alloc/free with coalescing, min block size, doubling growth.
  Here offsets index *elements* (e.g. vertices or triangles) of a pooled
  device array rather than bytes.

Growth returns a "needs resize" signal, the analog of the reference's
``take_gpu_needs_resize()`` — the caller must reallocate the device array
(which, under jit, is a recompile trigger keyed on the new capacity).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


from ..errors import AllocatorError  # typed hierarchy (errors.py)

# one sequence for every SlotAllocator: no two live allocators share a
# version, so a table keyed on a version knows the allocator as well
_VERSIONS = itertools.count(1)


@dataclass
class _Slot:
    index: int
    alive: bool


class SlotAllocator:
    """Fixed-slot-size allocator over row indices [0, capacity).

    Keys are opaque integers (monotonic, never reused) so stale handles are
    detected, mirroring slotmap-key semantics of the reference.
    """

    def __init__(self, initial_capacity: int = 16):
        if initial_capacity < 1:
            raise AllocatorError("capacity must be >= 1")
        self._capacity = initial_capacity
        self._free: List[int] = list(range(initial_capacity - 1, -1, -1))
        self._slots: Dict[int, int] = {}  # key -> row index
        self._next_key = 1
        self._needs_resize = False
        self._dirty: List[Tuple[int, int]] = []  # (start_row, end_row) half-open
        self._high_water = 0  # rows ever used (for dense-upload decisions)
        # changes whenever a key gains or loses its row (insert, remove):
        # tables of rows built from keys are valid while it holds
        self.version = next(_VERSIONS)

    @property
    def capacity(self) -> int:
        return self._capacity

    @property
    def count(self) -> int:
        return len(self._slots)

    @property
    def high_water(self) -> int:
        return self._high_water

    def insert(self) -> int:
        """Allocate a slot; returns a key. O(1) amortized."""
        if not self._free:
            old = self._capacity
            self._capacity *= 2
            self._free.extend(range(self._capacity - 1, old - 1, -1))
            self._needs_resize = True
        row = self._free.pop()
        key = self._next_key
        self._next_key += 1
        self._slots[key] = row
        self._high_water = max(self._high_water, row + 1)
        self.version = next(_VERSIONS)
        self.mark_dirty(key)
        return key

    def row_of(self, key: int) -> int:
        try:
            return self._slots[key]
        except KeyError:
            raise AllocatorError(f"unknown or removed key {key}") from None

    def contains(self, key: int) -> bool:
        return key in self._slots

    def remove(self, key: int) -> int:
        """Free a slot. Returns the freed row. O(1)."""
        row = self.row_of(key)
        del self._slots[key]
        self._free.append(row)
        self.version = next(_VERSIONS)
        return row

    def mark_dirty(self, key: int) -> None:
        row = self.row_of(key)
        self._dirty.append((row, row + 1))

    def take_needs_resize(self) -> bool:
        v = self._needs_resize
        self._needs_resize = False
        return v

    def take_dirty_ranges(self) -> List[Tuple[int, int]]:
        """Drain and coalesce dirty row ranges (sorted, merged)."""
        if not self._dirty:
            return []
        ranges = sorted(self._dirty)
        self._dirty = []
        merged = [list(ranges[0])]
        for s, e in ranges[1:]:
            if s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def live_rows(self) -> List[int]:
        return sorted(self._slots.values())

    def items(self):
        return self._slots.items()


def _round_up_pow2(x: int) -> int:
    if x <= 1:
        return 1
    return 1 << (x - 1).bit_length()


class BuddyAllocator:
    """Buddy allocator over element offsets.

    Reference semantics (dynamic_storage.rs): min block size, sizes rounded
    to powers of two (≤50% internal fragmentation), free with coalescing of
    buddy pairs, growth by doubling total capacity.
    """

    def __init__(self, capacity: int, min_block: int = 256):
        if min_block < 1 or (min_block & (min_block - 1)):
            raise AllocatorError("min_block must be a power of two >= 1")
        capacity = max(_round_up_pow2(capacity), min_block)
        self.min_block = min_block
        self._capacity = capacity
        # free lists per block size (power of two): size -> sorted set of offsets
        self._free: Dict[int, set] = {capacity: {0}}
        self._alloc_size: Dict[int, int] = {}  # offset -> block size
        self._needs_resize = False
        self._used = 0  # sum of block sizes handed out

    @property
    def capacity(self) -> int:
        return self._capacity

    @property
    def used(self) -> int:
        return self._used

    def _block_size_for(self, size: int) -> int:
        return max(_round_up_pow2(size), self.min_block)

    def alloc(self, size: int) -> int:
        """Allocate `size` elements; returns offset. Grows if needed."""
        if size <= 0:
            raise AllocatorError("size must be > 0")
        bs = self._block_size_for(size)
        offset = self._try_alloc(bs)
        while offset is None:
            self._grow(max(self._capacity * 2, bs * 2))
            offset = self._try_alloc(bs)
        self._alloc_size[offset] = bs
        self._used += bs
        return offset

    def _try_alloc(self, bs: int) -> Optional[int]:
        # find smallest free block >= bs, splitting as needed
        size = bs
        while size <= self._capacity:
            bucket = self._free.get(size)
            if bucket:
                off = min(bucket)
                bucket.remove(off)
                # split down to bs
                while size > bs:
                    size //= 2
                    self._free.setdefault(size, set()).add(off + size)
                return off
            size *= 2
        return None

    def _grow(self, new_capacity: int) -> None:
        new_capacity = _round_up_pow2(new_capacity)
        # add the new upper half (repeatedly doubling) as free blocks
        while self._capacity < new_capacity:
            self._free.setdefault(self._capacity, set()).add(self._capacity)
            # try coalescing the whole space if it is fully free
            self._coalesce(self._capacity, self._capacity)
            self._capacity *= 2
        self._needs_resize = True

    def free(self, offset: int) -> None:
        bs = self._alloc_size.pop(offset, None)
        if bs is None:
            raise AllocatorError(f"offset {offset} is not allocated")
        self._used -= bs
        self._coalesce(offset, bs)

    def _coalesce(self, offset: int, bs: int) -> None:
        while bs < self._capacity:
            buddy = offset ^ bs
            bucket = self._free.get(bs)
            if bucket is not None and buddy in bucket:
                bucket.remove(buddy)
                offset = min(offset, buddy)
                bs *= 2
            else:
                break
        self._free.setdefault(bs, set()).add(offset)

    def size_of(self, offset: int) -> int:
        try:
            return self._alloc_size[offset]
        except KeyError:
            raise AllocatorError(f"offset {offset} is not allocated") from None

    def take_needs_resize(self) -> bool:
        v = self._needs_resize
        self._needs_resize = False
        return v

    def check_invariants(self) -> None:
        """Debug check: free blocks + allocated blocks exactly tile capacity."""
        spans = []
        for size, bucket in self._free.items():
            for off in bucket:
                spans.append((off, size))
        for off, size in self._alloc_size.items():
            spans.append((off, size))
        spans.sort()
        pos = 0
        for off, size in spans:
            if off != pos:
                raise AllocatorError(f"gap or overlap at {pos} (next block {off})")
            pos = off + size
        if pos != self._capacity:
            raise AllocatorError(f"blocks tile {pos}, capacity {self._capacity}")
