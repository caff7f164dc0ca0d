"""Slot-allocating LRU for the Dynamic Class Pool (DCP) — the port's own
copy of ``vlsfr_tpu/core/lru.py`` (pure numpy, unchanged).

Re-design of the reference's linked-node LRU (the reference's lru.py:21-255)
with the same observable semantics but an array-backed representation:

* Slots ``0..capacity-1`` are allocated sequentially on first use; eviction
  reuses the evicted entry's slot (reference lru.py:62-89). The value returned
  by ``get`` is the slot index — it addresses a row of the device-side DCP
  embedding queue.
* Recency is a doubly-linked list stored as two int arrays (``_prev``/``_next``
  over slot ids plus HEAD/TAIL sentinels) instead of per-key node objects —
  O(1) ops, no allocation on the hot path, and a layout that the optional C++
  implementation (csrc/dcp_planner.cc) mirrors exactly.
* ``try_get`` logs an undo record per mutation so a whole speculative batch
  can be rolled back LIFO (reference lru.py:157-255). Rollback exists because
  the FFC loss evaluates both batch directions against the *same* pre-update
  pool state; see core/dcp.py for how the rebuild uses it.

The public surface matches the reference component C5 (SURVEY.md §2.1):
``get / try_get / view / __contains__ / state_dict / restore / clear / keys /
rollback_one_step / rollback_steps / __iter__``.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

# op codes for the undo log
_OP_ADD = 0
_OP_PROMOTE = 1
_OP_EVICT = 2


class LRU:
    """Fixed-capacity LRU mapping identity label -> pool slot in [0, capacity)."""

    def __init__(self, capacity: int):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = capacity
        # linked list over slot ids; sentinels live past the slot range
        self._HEAD = capacity
        self._TAIL = capacity + 1
        self._prev = np.full(capacity + 2, -1, dtype=np.int64)
        self._next = np.full(capacity + 2, -1, dtype=np.int64)
        self._next[self._HEAD] = self._TAIL
        self._prev[self._TAIL] = self._HEAD
        self._slot_key = {}  # slot -> key currently stored there
        self._key2slot = {}  # key -> slot
        self._size = 0  # number of allocated slots (== reference cur_idx)
        self._oplog: list[tuple] = []

    # -- linked-list primitives -------------------------------------------
    def _unlink(self, s: int) -> None:
        p, n = self._prev[s], self._next[s]
        self._next[p] = n
        self._prev[n] = p

    def _push_front(self, s: int) -> None:
        first = self._next[self._HEAD]
        self._next[self._HEAD] = s
        self._prev[s] = self._HEAD
        self._next[s] = first
        self._prev[first] = s

    def _link_between(self, s: int, p: int, n: int) -> None:
        self._next[p] = s
        self._prev[s] = p
        self._next[s] = n
        self._prev[n] = s

    # -- queries -----------------------------------------------------------
    def __contains__(self, key) -> bool:
        return key in self._key2slot

    def __len__(self) -> int:
        return self._size

    def view(self, key) -> int:
        """Slot of ``key`` or -1; never mutates (reference lru.py:147-151)."""
        return self._key2slot.get(key, -1)

    def keys(self):
        return self._key2slot.keys()

    def __iter__(self) -> Iterator[tuple]:
        """Yield (key, slot) most-recent first (reference lru.py:94-98)."""
        s = self._next[self._HEAD]
        while s != self._TAIL:
            yield self._slot_key[s], int(s)
            s = self._next[s]

    # -- mutation ----------------------------------------------------------
    def _get_impl(self, key, log: bool) -> int:
        slot = self._key2slot.get(key, -1)
        if slot >= 0:
            # hit: promote to most-recent
            if log:
                self._oplog.append((_OP_PROMOTE, slot, int(self._prev[slot]), int(self._next[slot])))
            self._unlink(slot)
            self._push_front(slot)
            return int(slot)
        if self._size < self.capacity:
            # miss with free space: allocate the next sequential slot
            slot = self._size
            self._size += 1
            self._key2slot[key] = slot
            self._slot_key[slot] = key
            self._push_front(slot)
            if log:
                self._oplog.append((_OP_ADD, slot, key))
            return slot
        # miss, pool full: evict least-recent, reuse its slot
        slot = int(self._prev[self._TAIL])
        old_key = self._slot_key[slot]
        if log:
            self._oplog.append(
                (_OP_EVICT, slot, old_key, key, int(self._prev[slot]), int(self._next[slot]))
            )
        del self._key2slot[old_key]
        self._key2slot[key] = slot
        self._slot_key[slot] = key
        self._unlink(slot)
        self._push_front(slot)
        return slot

    def get(self, key) -> int:
        """Lookup-or-insert; promotes to most-recent. Persistent."""
        return self._get_impl(key, log=False)

    def try_get(self, key) -> int:
        """Like ``get`` but records an undo op (reference lru.py:157-204)."""
        return self._get_impl(key, log=True)

    # -- rollback ----------------------------------------------------------
    def rollback_one_step(self) -> None:
        """Undo the most recent logged op (reference lru.py:210-248)."""
        if not self._oplog:
            return
        op = self._oplog.pop()
        code = op[0]
        if code == _OP_ADD:
            _, slot, key = op
            self._unlink(slot)
            del self._key2slot[key]
            del self._slot_key[slot]
            self._size -= 1  # LIFO undo ⇒ slot == size-1, allocation order restored
        elif code == _OP_PROMOTE:
            _, slot, old_prev, old_next = op
            self._unlink(slot)
            self._link_between(slot, old_prev, old_next)
        else:  # _OP_EVICT
            _, slot, old_key, new_key, old_prev, old_next = op
            del self._key2slot[new_key]
            self._key2slot[old_key] = slot
            self._slot_key[slot] = old_key
            self._unlink(slot)
            self._link_between(slot, old_prev, old_next)

    def rollback_steps(self, steps: int) -> None:
        for _ in range(min(steps, len(self._oplog))):
            self.rollback_one_step()

    @property
    def pending_ops(self) -> int:
        return len(self._oplog)

    # -- (de)serialization -------------------------------------------------
    def state_dict(self) -> list[tuple]:
        """Recency-ordered [(key, slot), ...], most-recent first."""
        return list(self)

    def restore(self, kvs: list[tuple]) -> None:
        """Rebuild from ``state_dict`` output; requires an empty cache
        (reference lru.py:113-127)."""
        assert len(kvs) <= self.capacity
        assert self._size == 0, "restore requires an empty LRU"
        prev = self._HEAD
        for key, slot in kvs:
            slot = int(slot)
            assert key not in self._key2slot
            self._key2slot[key] = slot
            self._slot_key[slot] = key
            self._next[prev] = slot
            self._prev[slot] = prev
            prev = slot
            self._size += 1
        self._next[prev] = self._TAIL
        self._prev[self._TAIL] = prev

    def clear(self) -> None:
        self._key2slot.clear()
        self._slot_key.clear()
        self._size = 0
        self._oplog.clear()
        self._next[self._HEAD] = self._TAIL
        self._prev[self._TAIL] = self._HEAD
