"""Backbone registry (port of ``vlsfr_tpu/models/__init__.py``).

``create_net(net_type, ...)`` returns an ``nn.Module`` mapping NHWC images
to ``[B, feat_dim]`` L2-normalised f32 embeddings:

* ``mobile``                      — MobileFaceNet, 112×112
* ``ir18/ir34/ir50/ir100/ir200``  — IResNet (ArcFace-style), 112×112
* ``r18/r34/r50/r101``            — standard ResNet v1.5, 224×224
* ``toy``                         — the tests' minimal net, 32×32
"""

from __future__ import annotations

import torch

from vlsfr_tpu_torch.models.iresnet import DEPTHS as _IR_DEPTHS
from vlsfr_tpu_torch.models.iresnet import IResNet
from vlsfr_tpu_torch.models.layers import to_dtype
from vlsfr_tpu_torch.models.mobilefacenet import MobileFaceNet
from vlsfr_tpu_torch.models.resnet import DEPTHS as _R_DEPTHS
from vlsfr_tpu_torch.models.resnet import ResNet
from vlsfr_tpu_torch.models.toynet import ToyNet

NATIVE_IMAGE_SIZE = {
    "mobile": 112,
    "toy": 32,
    **{k: 112 for k in _IR_DEPTHS},
    **{k: 224 for k in _R_DEPTHS},
}


def create_net(net_type: str, feat_dim: int = 512, dtype: str | torch.dtype = torch.float32,
               dropout: float = 0.0, image_size: int | None = None,
               bn_stats_rows: int = 0) -> torch.nn.Module:
    """Build a backbone by name at ``image_size`` (default its native size);
    raises on an unknown type. ``bn_stats_rows > 0`` takes every BN's
    training statistics but the embedding BN's from a strided row subset
    (``layers.BatchNorm``), as JAX's ``create_net``."""
    dtype = to_dtype(dtype)
    size = image_size or NATIVE_IMAGE_SIZE.get(net_type)
    kw = dict(feat_dim=feat_dim, dtype=dtype, bn_stats_rows=bn_stats_rows)
    if net_type == "toy":
        return ToyNet(**kw)
    if net_type == "mobile":
        return MobileFaceNet(image_size=size, **kw)
    if net_type in _IR_DEPTHS:
        return IResNet(layers=_IR_DEPTHS[net_type], dropout=dropout, image_size=size, **kw)
    if net_type in _R_DEPTHS:
        block, layers = _R_DEPTHS[net_type]
        return ResNet(block=block, layers=layers, image_size=size, **kw)
    raise ValueError(f"unsupported backbone {net_type!r}; choose from "
                     f"{['mobile', 'toy', *_IR_DEPTHS, *_R_DEPTHS]}")


def native_image_size(net_type: str) -> int:
    return NATIVE_IMAGE_SIZE[net_type]
