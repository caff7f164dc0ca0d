"""Structured training metrics: stdout + JSONL (port of
``vlsfr_tpu/utils/metrics.py`` without the TensorBoard writer)."""

from __future__ import annotations

import json
import logging
import os
import time

logger = logging.getLogger("vlsfr_torch")
if not logger.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(message)s", "%H:%M:%S"))
    logger.addHandler(_h)
    logger.setLevel(logging.INFO)


class Throughput:
    """images/sec (/card) over a rolling window: ``value()`` returns the
    rate and the rate per card of ``num_chips``."""

    def __init__(self, num_chips: int = 1):
        self.num_chips = max(num_chips, 1)
        self.reset()

    def reset(self):
        self._t0 = time.perf_counter()
        self._images = 0

    def update(self, n_images: int):
        self._images += n_images

    def value(self) -> tuple[float, float]:
        ips = self._images / max(time.perf_counter() - self._t0, 1e-9)
        return ips, ips / self.num_chips


class MetricsLogger:
    """One structured record per print window: a log line and, with a
    ``log_dir``, a JSONL row."""

    def __init__(self, log_dir: str = ""):
        self.log_dir = log_dir
        self._jsonl = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")

    def log(self, step: int, metrics: dict):
        scalars = {k: float(v) for k, v in metrics.items()}
        parts = " ".join(
            f"{k}={v:.4g}" if abs(v) < 1e5 else f"{k}={v:.3e}" for k, v in scalars.items()
        )
        logger.info("step %d | %s", step, parts)
        if self._jsonl:
            self._jsonl.write(json.dumps({"step": step, "prefix": "train", **scalars}) + "\n")
            self._jsonl.flush()

    def close(self):
        if self._jsonl:
            self._jsonl.close()
            self._jsonl = None
