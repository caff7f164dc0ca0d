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
* PReLU is per-channel with slope 0.25 at init.

Modules take NCHW tensors (the backbones transpose their NHWC input once);
parameter and buffer names follow the reference torch models, so a port
``state_dict`` reads as a reference checkpoint.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class BatchNorm(nn.Module):
    """BatchNorm over every axis but 1, flax rule, f32 statistics."""

    def __init__(self, num_features: int, use_scale: bool = True, momentum: float = 0.9,
                 eps: float = 1e-5, dtype: torch.dtype = torch.float32,
                 bn_stats_rows: int = 0):
        super().__init__()
        if bn_stats_rows > 0:
            raise NotImplementedError("model.bn_stats_rows > 0 is not ported yet")
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
            mean = x.mean(axes)
            var = (x.square().mean(axes) - mean.square()).clamp(min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps)
        if self.weight is not None:
            mul = mul * self.weight
        y = (x - mean.reshape(shape)) * mul.reshape(shape) + self.bias.reshape(shape)
        return y.to(self.dtype)


class Conv(nn.Conv2d):
    """torch Conv2d (symmetric padding, no bias by default) computing in
    ``dtype`` on f32 parameters."""

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
