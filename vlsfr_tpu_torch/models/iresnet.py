"""IResNet (insightface/ArcFace-style ResNet) — port of
``vlsfr_tpu/models/iresnet.py``.

BN-first basic blocks (BN → 3×3 conv → BN → PReLU → 3×3 strided conv → BN
+ shortcut), a stride-1 3×3 stem, four stride-2 stages, and a head of
BN → flatten → dropout → Linear → BatchNorm1d with the scale frozen at 1
(no weight) → L2 normalisation. Conv kernels ~ N(0, 0.1). The fc runs in
f32 under any compute dtype. Input NHWC ``[B, H, W, 3]``; the fc's input
width follows ``image_size`` (112 → 7×7 spatial; tests run at 32²).
Parameter names are the reference torch model's.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from vlsfr_tpu_torch.models.layers import BatchNorm, Conv, PReLU, l2_normalize

DEPTHS = {
    "ir18": (2, 2, 2, 2),
    "ir34": (3, 4, 6, 3),
    "ir50": (3, 4, 14, 3),
    "ir100": (3, 13, 30, 3),
    "ir200": (6, 26, 60, 6),
}
_CONV_STD = 0.1


class IBasicBlock(nn.Module):
    def __init__(self, in_ch: int, planes: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.bn1 = BatchNorm(in_ch, dtype=dtype)
        self.conv1 = Conv(in_ch, planes, 3, 1, 1, dtype=dtype, init_std=_CONV_STD)
        self.bn2 = BatchNorm(planes, dtype=dtype)
        self.prelu = PReLU(planes, dtype=dtype)
        self.conv2 = Conv(planes, planes, 3, stride, 1, dtype=dtype, init_std=_CONV_STD)
        self.bn3 = BatchNorm(planes, dtype=dtype)
        self.downsample = None
        if stride != 1 or in_ch != planes:
            self.downsample = nn.Sequential(
                Conv(in_ch, planes, 1, stride, 0, dtype=dtype, init_std=_CONV_STD),
                BatchNorm(planes, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.bn3(self.conv2(self.prelu(self.bn2(self.conv1(self.bn1(x))))))
        sc = x if self.downsample is None else self.downsample(x)
        return y + sc


class IResNet(nn.Module):
    """NHWC ``[B, S, S, 3]`` → ``[B, feat_dim]`` L2-normalised f32."""

    def __init__(self, layers: Sequence[int] = DEPTHS["ir50"], feat_dim: int = 512,
                 dropout: float = 0.0, dtype: torch.dtype = torch.float32,
                 image_size: int = 112):
        super().__init__()
        if image_size % 16:
            raise ValueError(f"IResNet needs image_size divisible by 16, got {image_size}")
        self.dtype = dtype
        self.conv1 = Conv(3, 64, 3, 1, 1, dtype=dtype, init_std=_CONV_STD)
        self.bn1 = BatchNorm(64, dtype=dtype)
        self.prelu = PReLU(64, dtype=dtype)
        in_ch = 64
        for stage, (planes, blocks) in enumerate(zip((64, 128, 256, 512), layers), start=1):
            stage_blocks = []
            for i in range(blocks):
                stage_blocks.append(IBasicBlock(in_ch, planes, 2 if i == 0 else 1, dtype))
                in_ch = planes
            setattr(self, f"layer{stage}", nn.Sequential(*stage_blocks))
        self.bn2 = BatchNorm(512, dtype=dtype)
        self.dropout = nn.Dropout(dropout) if dropout > 0 else nn.Identity()
        spatial = image_size // 16
        self.fc = nn.Linear(512 * spatial * spatial, feat_dim)
        nn.init.zeros_(self.fc.bias)
        self.features = BatchNorm(feat_dim, use_scale=False, dtype=torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        x = self.prelu(self.bn1(self.conv1(x)))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        x = self.bn2(x)
        x = self.dropout(x.reshape(x.shape[0], -1))  # NCHW flatten (reference order)
        x = self.fc(x.float())
        return l2_normalize(self.features(x))
