"""Layer primitives for the port's backbones (port of
``vlsfr_tpu/models/layers.py``).

Conventions carried over from the JAX package:

* activations run in the model's compute ``dtype`` (bf16 or f32) while
  parameters stay f32: ``Conv`` casts its input and weight per call,
  ``BatchNorm`` computes statistics and the affine in f32 and casts back;
* ``BatchNorm`` follows flax, not ``torch.nn.BatchNorm2d``: the batch
  variance is the BIASED ``E[x²] − E[x]²`` (clipped at 0), and the running
  stats keep momentum 0.9 on the OLD value
  (``ra = 0.9·ra + 0.1·batch``) — with torch's unbiased running variance
  the step trajectories drift apart (tests/test_torch_models.py);
* ``bn_stats_rows > 0`` is JAX's ``_SubsetBN``: training statistics from
  the strided row subset ``x[::max(b // rows, 1)]``, the same EMA, and its
  own op order ``((x − mean) · rsqrt(var + eps)) · scale + bias`` (in eval
  mode too); the variables are the same, so ``from_jax`` maps them as is;
* inside ``sync_batch_norm(group, rows, n)`` (the data axis, the FFC
  step's forwards) a train-mode ``BatchNorm`` takes its statistics over
  the whole batch of ``n`` rows held by ``group``'s ranks, as JAX's GSPMD
  means over the global array do: Σx and Σx² in f32, all_reduced with
  their cotangents (the backward sums them over the group), over the
  global count; ``rows`` are the global indices of this rank's rows, so
  the ``_SubsetBN`` subset is ``x[::max(n // rows, 1)]`` of the global
  batch; eval mode takes no collective;
* ``1 / sqrt(var + eps)`` is taken in f64 and rounded once to f32, so the
  card and the CPU give a BN the same scale (an int8 conv after it then
  rounds its input alike);
* PReLU is per-channel with slope 0.25 at init;
* inside ``ops.quant.int8_conv_inference()`` an eligible ``Conv`` (groups
  1, dilation 1) runs JAX's int8 conv (``ops/quant.py``) on the same
  parameters; a depthwise one keeps its float path.

Modules take NCHW tensors (the backbones transpose their NHWC input once);
parameter and buffer names follow the reference torch models, so a port
``state_dict`` reads as a reference checkpoint.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vlsfr_tpu_torch.ops import quant
from vlsfr_tpu_torch.parallel import distributed

_SYNC: tuple | None = None  # (group, global row ids, global rows) inside sync_batch_norm


@contextlib.contextmanager
def sync_batch_norm(group, rows: torch.Tensor, n: int):
    """Train-mode ``BatchNorm`` statistics over ``group``'s ranks: this
    rank's batch rows are the rows ``rows`` [b] (global indices, int64) of
    a global batch of ``n`` rows."""
    global _SYNC
    prev, _SYNC = _SYNC, (group, rows, n)
    try:
        yield
    finally:
        _SYNC = prev


def dropout_seed(seed: int, data_index: int, step: int) -> int:
    """The seed of a step's dropout draws at a data index."""
    return int(np.random.SeedSequence([seed, data_index, step]).generate_state(1)[0])


@contextlib.contextmanager
def data_axis_forward(mesh, b: int, dev: torch.device, *, segments: int = 1,
                      seed: int | None = None, step: int = 0):
    """The context of a training step's forwards. On the data axis
    (``mesh.data`` > 1) BatchNorm over the data group, this rank's ``b``
    rows being its rows of ``segments`` global batches of data · b rows
    concatenated (``sync_batch_norm``). With a dropout ``seed``, the draws
    from the generators seeded by (seed, this data index, ``step``), the
    process's own restored after."""
    d, di = (1, 0) if mesh is None else (mesh.data, mesh.data_rank)
    with contextlib.ExitStack() as stack:
        if d > 1:
            local = torch.arange(b, device=dev) + di * b
            rows = torch.cat([local + j * d * b for j in range(segments)])
            stack.enter_context(sync_batch_norm(mesh.data_group, rows, segments * d * b))
        if seed is not None:
            stack.enter_context(torch.random.fork_rng(devices=[dev] if dev.type == "cuda" else []))
            s = dropout_seed(seed, di, step)
            torch.random.default_generator.manual_seed(s)
            if dev.type == "cuda":
                torch.cuda.manual_seed(s)
        yield


def subset_rows(rows: torch.Tensor, n: int, stats_rows: int) -> tuple[torch.Tensor, int]:
    """Which of this rank's rows (global ids ``rows``) are in ``_SubsetBN``'s
    subset ``x[::max(n // stats_rows, 1)]`` of the ``n``-row global batch,
    and how many rows that subset has: (mask [b], count)."""
    stride = max(n // stats_rows, 1)
    return rows % stride == 0, -(-n // stride)


def synced_moments(x: torch.Tensor, axes: list[int], stats_rows: int):
    """(E[x], E[x²]) per channel over the global batch of ``sync_batch_norm``
    (the ``_SubsetBN`` subset with ``stats_rows`` > 0)."""
    group, rows, n = _SYNC
    if stats_rows > 0:
        keep, n = subset_rows(rows.to(x.device), n, stats_rows)
        x = x[keep]
    count = n * x.shape[2:].numel()  # elements per channel over the global batch
    sums = distributed.reduce_sum(torch.stack([x.sum(axes), x.square().sum(axes)]), group)
    return sums[0] / count, sums[1] / count


class BatchNorm(nn.Module):
    """BatchNorm over every axis but 1, flax rule, f32 statistics;
    ``bn_stats_rows > 0``: statistics from a strided row subset
    (``_SubsetBN``)."""

    def __init__(self, num_features: int, use_scale: bool = True, momentum: float = 0.9,
                 eps: float = 1e-5, dtype: torch.dtype = torch.float32,
                 bn_stats_rows: int = 0):
        super().__init__()
        self.stats_rows = bn_stats_rows
        self.momentum = momentum
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(num_features)) if use_scale else None
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        shape = [1] * x.dim()
        shape[1] = x.shape[1]
        if self.training:
            axes = [d for d in range(x.dim()) if d != 1]
            rows = self.stats_rows
            if _SYNC is None:
                sub = x if rows <= 0 else x[::max(x.shape[0] // rows, 1)]
                mean, mean2 = sub.mean(axes), sub.square().mean(axes)
            else:
                mean, mean2 = synced_moments(x, axes, rows)
            var = (mean2 - mean.square()).clamp(min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        # rsqrt's CUDA and CPU kernels round differently; f64's sqrt and
        # division are correctly rounded on both, so 1 / sqrt taken in f64 and
        # rounded once to f32 is the same on both devices (C elements)
        inv = (1.0 / torch.sqrt((var + self.eps).double())).float()
        if self.stats_rows > 0:  # _SubsetBN's op order
            y = (x - mean.reshape(shape)) * inv.reshape(shape)
            if self.weight is not None:
                y = y * self.weight.reshape(shape)
            return (y + self.bias.reshape(shape)).to(self.dtype)
        mul = inv if self.weight is None else inv * self.weight
        y = (x - mean.reshape(shape)) * mul.reshape(shape) + self.bias.reshape(shape)
        return y.to(self.dtype)


class Conv(nn.Conv2d):
    """torch Conv2d (symmetric padding, no bias by default) computing in
    ``dtype`` on f32 parameters; int8 × int8 → int32 inside
    ``int8_conv_inference()`` where eligible."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, groups: int = 1, bias: bool = False,
                 dtype: torch.dtype = torch.float32, init_std: float | None = None):
        super().__init__(in_ch, out_ch, kernel_size, stride=stride, padding=padding,
                         groups=groups, bias=bias)
        self.compute_dtype = dtype
        if init_std is not None:
            nn.init.normal_(self.weight, 0.0, init_std)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if quant.int8_active() and quant.eligible(self):
            return quant.int8_conv2d(x, self.weight, self.bias, self.stride, self.padding, dt)
        b = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x.to(dt), self.weight.to(dt), b, self.stride, self.padding,
                        self.dilation, self.groups)


class PReLU(nn.Module):
    """Per-channel parametric ReLU on axis 1."""

    def __init__(self, num_features: int, init_slope: float = 0.25,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.full((num_features,), init_slope))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = [1] * x.dim()
        shape[1] = x.shape[1]
        x = x.to(self.dtype)
        alpha = self.weight.to(self.dtype).reshape(shape)
        return torch.where(x >= 0, x, alpha * x)


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """x / max(||x||₂, eps) along the last axis, in f32."""
    x = x.float()
    return x / torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True)).clamp(min=eps)


def to_dtype(name: str | torch.dtype) -> torch.dtype:
    if isinstance(name, torch.dtype):
        return name
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]
