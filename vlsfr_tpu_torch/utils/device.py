"""Device resolution for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for the CPU; with no
card and no explicit CPU request they raise — they never fall back to the
CPU silently."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev
