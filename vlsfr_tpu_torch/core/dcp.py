"""Host-side Dynamic Class Pool manager (port of ``vlsfr_tpu/core/dcp.py``).

The host plans both directional passes of a step ahead of the device:
pass A (probe x vs gallery y) is speculative and rolled back, pass B (probe
y vs gallery x) persists — the reference's rollback-then-real double call
without any device→host sync. ``PassIndices``/``StepIndices`` are plain
dataclasses of numpy arrays; the train step moves them to the device.

Semantics are the JAX package's exactly (tests/test_torch_dcp_data.py holds
``plan_step``, ``state_dict`` and ``restore`` against it).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from vlsfr_tpu_torch.core.lru import LRU


@dataclass
class PassIndices:
    """Index arrays for one directional pass (numpy, host-resident)."""

    rows: np.ndarray  # [B] int32, which of the 2 queue rows to write
    cols: np.ndarray  # [B] int32, pool slot per gallery sample
    seen: np.ndarray  # [B] float32, 1.0 if label was already pooled
    fake_labels: np.ndarray  # [B] int32, probe label -> pool slot or -1


@dataclass
class StepIndices:
    """All host-precomputed indices for one combined FFC step."""

    a: PassIndices  # speculative direction: probe(x) vs gallery(y)
    b: PassIndices  # persistent direction: probe(y) vs gallery(x)


class DCPManager:
    """Owns the LRU and per-slot parity counters; plans one step ahead."""

    def __init__(self, queue_size: int):
        self.queue_size = queue_size
        self.lru = LRU(queue_size)
        # parity counter per slot (reference queue_position_dict)
        self.parity = np.zeros(queue_size, dtype=np.int32)

    def _run_pass(self, gallery_labels, probe_labels, speculative: bool) -> PassIndices:
        n = len(gallery_labels)
        rows = np.zeros(n, dtype=np.int32)
        cols = np.zeros(n, dtype=np.int32)
        seen = np.zeros(n, dtype=np.float32)
        touched: dict[int, int] = {}  # slot -> parity before this pass
        lookup = self.lru.try_get if speculative else self.lru.get
        for i, gl in enumerate(gallery_labels):
            hit = gl in self.lru
            slot = lookup(gl)
            cols[i] = slot
            if slot not in touched:
                touched[slot] = int(self.parity[slot])
            if hit:
                rows[i] = self.parity[slot]
                seen[i] = 1.0
                self.parity[slot] ^= 1
            else:
                rows[i] = 0
                self.parity[slot] = 1
        fake = np.fromiter(
            (self.lru.view(pl) for pl in probe_labels), dtype=np.int32, count=len(probe_labels)
        )
        if speculative:
            self.lru.rollback_steps(n)
            for slot, old in touched.items():
                self.parity[slot] = old
        return PassIndices(rows=rows, cols=cols, seen=seen, fake_labels=fake)

    def plan_step(self, x_labels, y_labels) -> StepIndices:
        """Plan both directional passes of one FFC step from the current
        state: pass A speculative (mutations undone), pass B persistent."""
        x_labels = [int(v) for v in x_labels]
        y_labels = [int(v) for v in y_labels]
        a = self._run_pass(y_labels, x_labels, speculative=True)
        b = self._run_pass(x_labels, y_labels, speculative=False)
        return StepIndices(a=a, b=b)

    def state_dict(self) -> dict:
        return {
            "lru": self.lru.state_dict(),
            "parity": self.parity.copy(),
            "queue_size": self.queue_size,
        }

    def restore(self, state: dict) -> None:
        if state["queue_size"] != self.queue_size:
            raise ValueError(
                f"queue_size mismatch on restore: {state['queue_size']} vs {self.queue_size}")
        self.lru.clear()
        self.lru.restore([(int(k), int(v)) for k, v in state["lru"]])
        self.parity = np.asarray(state["parity"], dtype=np.int32).copy()
