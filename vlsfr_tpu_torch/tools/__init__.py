"""Measurement tools of the port: ``bench_conv`` (the hand 3×3 conv against
cuDNN) and ``probe_int8_mxu`` (int8 against bf16 on the tensor cores), with
the timing and card-naming helpers they share."""

from __future__ import annotations

import subprocess

import torch

ITERS = 10  # timed calls per measurement, after two warm-up calls


def time_ms(fn, dev: torch.device) -> float | None:
    """Mean ms per call over ITERS calls after two warm-up calls, by CUDA
    events; on the CPU the call runs once and no time is taken (None)."""
    if dev.type != "cuda":
        fn()
        return None
    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ITERS):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / ITERS


def card_line(dev: torch.device) -> str:
    """The card's name and power limit, as nvidia-smi reports them; every
    time a tool prints is this card's."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    return f"device: {torch.cuda.get_device_name(dev)} ({smi})"
