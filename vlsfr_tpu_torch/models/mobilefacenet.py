"""MobileFaceNet (112×112 → feat_dim L2-normalised) — port of
``vlsfr_tpu/models/mobilefacenet.py``.

Inverted-residual bottlenecks with per-channel PReLU, a 7×7 depthwise
"global" conv (``linear7``, VALID over the 7×7 map, so the input must be
112²) in place of pooling, and a linear 1×1 conv (``linear1``, no Dense) to
the embedding, all BN'd, then L2 normalisation. Depthwise convs are
``groups = in_ch``. Conv kernels keep torch's default init, which is JAX's
``torch_default_conv_init``. Input NHWC ``[B, 112, 112, 3]``. Parameter
names are the reference torch model's: a bottleneck's eight layers are
``blocks.<i>.conv.<0..7>``.
"""

from __future__ import annotations

import functools
from typing import Sequence

import torch
from torch import nn

from vlsfr_tpu_torch.models.layers import BatchNorm, Conv, PReLU, l2_normalize

# (expansion, channels, num_blocks, first_stride)
BOTTLENECK_SETTING = (
    (2, 64, 5, 2),
    (4, 128, 1, 2),
    (2, 128, 6, 1),
    (4, 128, 1, 2),
    (2, 128, 2, 1),
)
IMAGE_SIZE = 112


class ConvBlock(nn.Module):
    """conv → BN → (PReLU unless ``linear``); depthwise with ``dw``."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int, padding: int,
                 dw: bool = False, linear: bool = False, dtype: torch.dtype = torch.float32,
                 bn_stats_rows: int = 0):
        super().__init__()
        self.conv = Conv(in_ch, out_ch, kernel, stride, padding, groups=in_ch if dw else 1,
                         dtype=dtype)
        self.bn = BatchNorm(out_ch, dtype=dtype, bn_stats_rows=bn_stats_rows)
        self.prelu = None if linear else PReLU(out_ch, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(self.conv(x))
        return x if self.prelu is None else self.prelu(x)


class Bottleneck(nn.Module):
    """1×1 expand → 3×3 depthwise (stride) → 1×1 linear project; residual
    iff stride 1 and in_ch == out_ch."""

    def __init__(self, in_ch: int, out_ch: int, stride: int, expansion: int,
                 dtype: torch.dtype = torch.float32, bn_stats_rows: int = 0):
        super().__init__()
        mid = in_ch * expansion
        self.residual = stride == 1 and in_ch == out_ch
        bn = functools.partial(BatchNorm, dtype=dtype, bn_stats_rows=bn_stats_rows)
        self.conv = nn.Sequential(
            Conv(in_ch, mid, 1, 1, 0, dtype=dtype), bn(mid), PReLU(mid, dtype=dtype),
            Conv(mid, mid, 3, stride, 1, groups=mid, dtype=dtype), bn(mid),
            PReLU(mid, dtype=dtype),
            Conv(mid, out_ch, 1, 1, 0, dtype=dtype), bn(out_ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv(x)
        return x + y if self.residual else y


class MobileFaceNet(nn.Module):
    """NHWC ``[B, 112, 112, 3]`` → ``[B, feat_dim]`` L2-normalised f32."""

    def __init__(self, feat_dim: int = 128, dtype: torch.dtype = torch.float32,
                 setting: Sequence[tuple] = BOTTLENECK_SETTING, image_size: int = IMAGE_SIZE,
                 bn_stats_rows: int = 0):
        super().__init__()
        if image_size != IMAGE_SIZE:
            raise ValueError(f"MobileFaceNet takes {IMAGE_SIZE}² input (its linear7 is a 7×7 "
                             f"VALID conv over the 7×7 map), got {image_size}")
        self.dtype = dtype
        kw = dict(dtype=dtype, bn_stats_rows=bn_stats_rows)
        self.conv1 = ConvBlock(3, 64, 3, 2, 1, **kw)
        self.dw_conv1 = ConvBlock(64, 64, 3, 1, 1, dw=True, **kw)
        blocks, ch = [], 64
        for t, c, n, s in setting:
            for i in range(n):
                blocks.append(Bottleneck(ch, c, s if i == 0 else 1, t, **kw))
                ch = c
        self.blocks = nn.Sequential(*blocks)
        self.conv2 = ConvBlock(128, 512, 1, 1, 0, **kw)
        self.linear7 = ConvBlock(512, 512, 7, 1, 0, dw=True, linear=True, **kw)
        self.linear1 = ConvBlock(512, feat_dim, 1, 1, 0, linear=True, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        x = self.blocks(self.dw_conv1(self.conv1(x)))
        x = self.linear1(self.linear7(self.conv2(x)))
        return l2_normalize(x.reshape(x.shape[0], -1))
