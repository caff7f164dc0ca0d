"""Carry weights from the JAX package's flax variables into a port model.

Input: the flax ``params`` and ``batch_stats`` trees as nested dicts of
numpy arrays (``jax.device_get`` of a JAX model's variables). Output: a
``state_dict`` for the matching port module. Layout conversions:

* conv kernel HWIO [kH, kW, I/g, O] → weight OIHW [O, I/g, kH, kW];
* a depthwise kernel [kH, kW, 1, C] → [C, 1, kH, kW] (the same transpose);
* Dense kernel [in, out] → Linear weight [out, in]; the IResNet and ResNet
  fc additionally permutes its inputs from the flax NHWC flatten order
  (h·W·C + w·C + c) to the NCHW order (c·H·W + h·W + w) the port and the
  reference torch model flatten in, C being the model's last width
  (512 for IResNet, 512·expansion for ResNet);
* BN scale/bias (params) + mean/var (batch_stats) → weight/bias +
  running_mean/running_var; PReLU alpha → weight.

The key names are the reference torch model's, so the result is also a
valid input to ``vlsfr_tpu/models/torch_import.py:convert_torch_state_dict``
— the round trip is tested in tests/test_torch_models.py.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from vlsfr_tpu_torch.models.layers import BatchNorm, Conv, PReLU


# a MobileFaceNet bottleneck's ``conv.<j>`` → its flax ConvBlock and layer
_MOBILE_SEQ = {"0": ("expand", "conv"), "1": ("expand", "bn"), "2": ("expand", "prelu"),
               "3": ("depthwise", "conv"), "4": ("depthwise", "bn"),
               "5": ("depthwise", "prelu"), "6": ("project", "conv"), "7": ("project", "bn")}


def _flax_path(module_name: str) -> list[str]:
    """Port module name → flax module path: ``layer2.0.conv1`` →
    ``layer2_0/conv1``; ``downsample.0``/``.1`` → ``downsample_conv``/``_bn``;
    ``blocks.3.conv.4`` → ``blocks_3/depthwise/bn``."""
    parts = module_name.split(".") if module_name else []
    out, i = [], 0
    while i < len(parts):
        p = parts[i]
        nxt = parts[i + 1] if i + 1 < len(parts) else ""
        if (p.startswith("layer") or p == "blocks") and nxt.isdigit():
            out.append(f"{p}_{nxt}")
            i += 2
        elif p == "downsample" and nxt:
            out.append({"0": "downsample_conv", "1": "downsample_bn"}[nxt])
            i += 2
        elif p == "conv" and out and out[-1].startswith("blocks_") and nxt.isdigit():
            out.extend(_MOBILE_SEQ[nxt])
            i += 2
        else:
            out.append(p)
            i += 1
    return out


def _get(tree: dict, path: list[str]) -> np.ndarray:
    node = tree
    for p in path:
        node = node[p]
    return np.asarray(node, dtype=np.float32)


def _fc_weight(kernel: np.ndarray, c: int) -> np.ndarray:
    """flax [H·W·C, O] (NHWC flatten) → torch [O, C·H·W] (NCHW flatten),
    C the channels of the flattened map (512 for IResNet, 512·expansion for
    ResNet: r50's 7·7·2048 = 100,352 is also 512·14², so C cannot be
    inferred from the width)."""
    hwc, o = kernel.shape
    s = int(round(math.sqrt(hwc // c)))
    if s * s * c != hwc:
        raise ValueError(f"fc input width {hwc} is not {c}·s² for any spatial size s")
    return np.ascontiguousarray(kernel.T.reshape(o, s, s, c).transpose(0, 3, 1, 2).reshape(o, hwc))


def state_dict_from_flax(model: nn.Module, params: dict, batch_stats: dict) -> dict:
    """The port ``state_dict`` of ``model`` filled from flax variables."""
    flat_c = getattr(model, "out_channels", None)  # a flattening head's map channels
    sd: dict[str, torch.Tensor] = {}
    for name, mod in model.named_modules():
        path = _flax_path(name)
        pre = f"{name}." if name else ""
        if isinstance(mod, Conv):
            sd[pre + "weight"] = _get(params, path + ["conv", "kernel"]).transpose(3, 2, 0, 1)
        elif isinstance(mod, BatchNorm):
            if mod.weight is not None:
                sd[pre + "weight"] = _get(params, path + ["bn", "scale"])
            sd[pre + "bias"] = _get(params, path + ["bn", "bias"])
            sd[pre + "running_mean"] = _get(batch_stats, path + ["bn", "mean"])
            sd[pre + "running_var"] = _get(batch_stats, path + ["bn", "var"])
        elif isinstance(mod, PReLU):
            sd[pre + "weight"] = _get(params, path + ["alpha"])
        elif isinstance(mod, nn.Linear):
            k = _get(params, path + ["kernel"])
            sd[pre + "weight"] = k.T if flat_c is None else _fc_weight(k, flat_c)
            sd[pre + "bias"] = _get(params, path + ["bias"])
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}


def load_flax_variables(model: nn.Module, params: dict, batch_stats: dict) -> nn.Module:
    """Load flax variables into ``model`` in place (strict key match)."""
    model.load_state_dict(state_dict_from_flax(model, params, batch_stats), strict=True)
    return model
