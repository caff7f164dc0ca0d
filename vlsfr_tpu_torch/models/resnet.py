"""Standard ResNet v1.5 for 224×224 inputs — port of
``vlsfr_tpu/models/resnet.py`` (default ``r50``).

A 7×7 stride-2 stem with BN, ReLU and a 3×3 stride-2 max-pool, BasicBlock
(r18 / r34) or Bottleneck (r50 / r101, the stride on the 3×3 conv) stages,
and the face-embedding head: flatten the 7×7 map, Linear in f32, a
BatchNorm1d ``features`` WITH its scale (IResNet's is frozen), L2
normalisation; no global pooling. Conv kernels are kaiming-normal fan_out,
optionally the last BN scale of each block zero (``zero_init_residual``).
Input NHWC ``[B, S, S, 3]``; the fc's input width follows ``image_size``
(224 → 7×7; 112, the CLI's default data.image_size, → 4×4, as flax infers
it; the tests run at 64² → 2×2). The flatten is NCHW, the
reference torch model's order: ``from_jax._fc_weight`` permutes a flax
kernel (NHWC order) with the real channel count 512·expansion. Parameter
names are the reference torch model's.
"""

from __future__ import annotations

import functools
from typing import Sequence

import torch
from torch import nn

from vlsfr_tpu_torch.models.layers import BatchNorm, Conv, l2_normalize

DEPTHS = {
    "r18": ("basic", (2, 2, 2, 2)),
    "r34": ("basic", (3, 4, 6, 3)),
    "r50": ("bottleneck", (3, 4, 6, 3)),
    "r101": ("bottleneck", (3, 4, 23, 3)),
}


def _conv(in_ch: int, out_ch: int, k: int, stride: int, pad: int, dtype) -> Conv:
    """A conv with JAX's init: truncated normal, variance 2 / fan_out."""
    conv = Conv(in_ch, out_ch, k, stride, pad, dtype=dtype)
    std = (2.0 / (out_ch * k * k)) ** 0.5 / 0.87962566103423978  # flax's truncation factor
    nn.init.trunc_normal_(conv.weight, 0.0, std, -2.0 * std, 2.0 * std)
    return conv


def _downsample(in_ch: int, out_ch: int, stride: int, dtype, bn_stats_rows: int
                ) -> nn.Module | None:
    if stride == 1 and in_ch == out_ch:
        return None
    return nn.Sequential(_conv(in_ch, out_ch, 1, stride, 0, dtype),
                         BatchNorm(out_ch, dtype=dtype, bn_stats_rows=bn_stats_rows))


class BasicBlock(nn.Module):
    """conv3x3-BN-ReLU-conv3x3-BN + shortcut, ReLU."""

    expansion = 1

    def __init__(self, in_ch: int, planes: int, stride: int = 1,
                 zero_init_residual: bool = False, dtype: torch.dtype = torch.float32,
                 bn_stats_rows: int = 0):
        super().__init__()
        self.conv1 = _conv(in_ch, planes, 3, stride, 1, dtype)
        self.bn1 = BatchNorm(planes, dtype=dtype, bn_stats_rows=bn_stats_rows)
        self.conv2 = _conv(planes, planes, 3, 1, 1, dtype)
        self.bn2 = BatchNorm(planes, dtype=dtype, bn_stats_rows=bn_stats_rows)
        if zero_init_residual:
            nn.init.zeros_(self.bn2.weight)
        self.downsample = _downsample(in_ch, planes, stride, dtype, bn_stats_rows)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.bn2(self.conv2(torch.relu(self.bn1(self.conv1(x)))))
        sc = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + sc)


class Bottleneck(nn.Module):
    """1×1 reduce → 3×3 (stride) → 1×1 expand ×4, each with BN; shortcut, ReLU."""

    expansion = 4

    def __init__(self, in_ch: int, planes: int, stride: int = 1,
                 zero_init_residual: bool = False, dtype: torch.dtype = torch.float32,
                 bn_stats_rows: int = 0):
        super().__init__()
        out_ch = planes * self.expansion
        bn = functools.partial(BatchNorm, dtype=dtype, bn_stats_rows=bn_stats_rows)
        self.conv1 = _conv(in_ch, planes, 1, 1, 0, dtype)
        self.bn1 = bn(planes)
        self.conv2 = _conv(planes, planes, 3, stride, 1, dtype)
        self.bn2 = bn(planes)
        self.conv3 = _conv(planes, out_ch, 1, 1, 0, dtype)
        self.bn3 = bn(out_ch)
        if zero_init_residual:
            nn.init.zeros_(self.bn3.weight)
        self.downsample = _downsample(in_ch, out_ch, stride, dtype, bn_stats_rows)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        sc = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + sc)


class ResNet(nn.Module):
    """NHWC ``[B, S, S, 3]`` → ``[B, feat_dim]`` L2-normalised f32."""

    def __init__(self, block: str = "bottleneck", layers: Sequence[int] = (3, 4, 6, 3),
                 feat_dim: int = 512, zero_init_residual: bool = False,
                 dtype: torch.dtype = torch.float32, image_size: int = 224,
                 bn_stats_rows: int = 0):
        super().__init__()
        block_cls = BasicBlock if block == "basic" else Bottleneck
        self.dtype = dtype
        self.conv1 = _conv(3, 64, 7, 2, 3, dtype)
        self.bn1 = BatchNorm(64, dtype=dtype, bn_stats_rows=bn_stats_rows)
        # -inf padding: the same maximum as JAX's max_pool_torch (the dtype's min)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        in_ch = 64
        for stage, (planes, blocks) in enumerate(zip((64, 128, 256, 512), layers), start=1):
            stage_blocks = []
            for i in range(blocks):
                stride = (2 if stage > 1 else 1) if i == 0 else 1
                stage_blocks.append(block_cls(in_ch, planes, stride, zero_init_residual, dtype,
                                                bn_stats_rows))
                in_ch = planes * block_cls.expansion
            setattr(self, f"layer{stage}", nn.Sequential(*stage_blocks))
        self.out_channels = in_ch
        spatial = image_size
        for _ in range(5):  # the stem, the max-pool and three stride-2 stages: ceil(n / 2) each
            spatial = -(-spatial // 2)
        self.fc = nn.Linear(in_ch * spatial * spatial, feat_dim)
        nn.init.zeros_(self.fc.bias)
        self.features = BatchNorm(feat_dim, dtype=torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        x = self.maxpool(torch.relu(self.bn1(self.conv1(x))))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        x = self.fc(x.reshape(x.shape[0], -1).float())  # NCHW flatten (reference order)
        return l2_normalize(self.features(x))
