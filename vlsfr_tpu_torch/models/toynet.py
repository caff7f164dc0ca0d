"""ToyNet: the minimal conv backbone for tests (port of
``vlsfr_tpu/models/toynet.py``); any input size ≥ 16, L2-normalised f32
``[B, feat_dim]`` embeddings from NHWC input."""

from __future__ import annotations

import torch
from torch import nn

from vlsfr_tpu_torch.models.layers import BatchNorm, Conv, PReLU, l2_normalize


class ToyNet(nn.Module):
    def __init__(self, feat_dim: int = 64, dtype: torch.dtype = torch.float32,
                 bn_stats_rows: int = 0):
        super().__init__()
        self.dtype = dtype
        self.conv1 = Conv(3, 16, 3, 2, 1, dtype=dtype)
        self.bn1 = BatchNorm(16, dtype=dtype, bn_stats_rows=bn_stats_rows)
        self.prelu1 = PReLU(16, dtype=dtype)
        self.conv2 = Conv(16, 32, 3, 2, 1, dtype=dtype)
        self.bn2 = BatchNorm(32, dtype=dtype, bn_stats_rows=bn_stats_rows)
        self.prelu2 = PReLU(32, dtype=dtype)
        self.fc = nn.Linear(32, feat_dim)
        nn.init.zeros_(self.fc.bias)
        self.features = BatchNorm(feat_dim, dtype=torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        x = self.prelu1(self.bn1(self.conv1(x)))
        x = self.prelu2(self.bn2(self.conv2(x)))
        x = x.mean(dim=(2, 3))  # global average pool
        return l2_normalize(self.features(self.fc(x.float())))
