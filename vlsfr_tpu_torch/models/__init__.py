"""Backbone registry (port of ``vlsfr_tpu/models/__init__.py``).

``create_net(net_type, ...)`` returns an ``nn.Module`` mapping NHWC images
to ``[B, feat_dim]`` L2-normalised f32 embeddings. Ported: ``toy`` and
``ir18/ir34/ir50/ir100/ir200``; ``mobile`` and ``r18..r101`` are not
ported yet and raise.
"""

from __future__ import annotations

import torch

from vlsfr_tpu_torch.models.iresnet import DEPTHS as _IR_DEPTHS
from vlsfr_tpu_torch.models.iresnet import IResNet
from vlsfr_tpu_torch.models.layers import to_dtype
from vlsfr_tpu_torch.models.toynet import ToyNet

NATIVE_IMAGE_SIZE = {"toy": 32, **{k: 112 for k in _IR_DEPTHS}}
_NOT_PORTED = ("mobile", "r18", "r34", "r50", "r101")


def create_net(net_type: str, feat_dim: int = 512, dtype: str | torch.dtype = torch.float32,
               dropout: float = 0.0, image_size: int | None = None,
               bn_stats_rows: int = 0) -> torch.nn.Module:
    """Build a backbone by name; raises on unknown or unported types."""
    if bn_stats_rows > 0:
        raise NotImplementedError("model.bn_stats_rows > 0 is not ported yet")
    dtype = to_dtype(dtype)
    if net_type == "toy":
        return ToyNet(feat_dim=feat_dim, dtype=dtype)
    if net_type in _IR_DEPTHS:
        return IResNet(layers=_IR_DEPTHS[net_type], feat_dim=feat_dim, dropout=dropout,
                       dtype=dtype, image_size=image_size or 112)
    if net_type in _NOT_PORTED:
        raise NotImplementedError(f"backbone {net_type!r} is not ported yet")
    raise ValueError(f"unsupported backbone {net_type!r}; choose from "
                     f"{['toy', *_IR_DEPTHS]}")


def native_image_size(net_type: str) -> int:
    if net_type in _NOT_PORTED:
        raise NotImplementedError(f"backbone {net_type!r} is not ported yet")
    return NATIVE_IMAGE_SIZE[net_type]
