"""Int8 storage for the DCP queue (``pool.queue_dtype = "int8"``; port of
``vlsfr_tpu/ops/qqueue.py``).

Queue rows are unit vectors that the fused head streams twice per step and
that are only ever replaced whole, so they are stored as int8 with one f32
scale per row: a 10,485,760-slot [2, Q, 512] queue is 10.7 GB int8 against
42.9 GB f32. Each write re-quantises the fresh gallery embedding, so the
rounding never accumulates across steps.

Scale convention: ``scale = 1 / ||q_int||`` so that ``q_int · scale`` is
unit-norm (f32 rounding aside); a zero row has scale 0. The input's own
norm is discarded. Bit-equal to the JAX module: the same f32 operations in
the same order (divide by the absmax, then multiply by 127; round half to
even; the squared norm is an exact integer sum below 2^24 at D <= 1024).
The division, the square root and the reciprocal are taken in f64 and
rounded once to f32, which gives the correctly rounded f32 result (f64
carries more than 2·24 + 2 bits): PyTorch's f32 ``sqrt`` on the CPU is
not correctly rounded (sqrt(1006018) comes out one ulp low), XLA's is.
"""

from __future__ import annotations

import torch

_QMAX = 127.0  # absmax -> int8, symmetric (-127..127)


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 quantisation of ``x[..., D]``: returns
    ``(q int8[..., D], scale f32[...])`` with ``q · scale[..., None]``
    unit-norm per row (0 for a zero row)."""
    x32 = x.float()
    absmax = torch.clamp(x32.abs().amax(dim=-1, keepdim=True), min=1e-30)
    q = torch.round((x32.double() / absmax.double()).float() * _QMAX)
    q = q.clamp(-_QMAX, _QMAX).to(torch.int8)
    nrm = torch.sqrt(q.float().square().sum(dim=-1).double()).float()
    inv = (1.0 / torch.clamp(nrm, min=1e-30).double()).float()
    return q, torch.where(nrm > 0, inv, torch.zeros_like(nrm))


def dequant_rows(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """f32 rows from ``quantize_rows`` output; unit-norm where scale > 0."""
    return q.float() * scale[..., None].float()


def is_int8_queue(queue: torch.Tensor) -> bool:
    return queue.dtype == torch.int8
