"""Carry weights from the JAX package's flax variables into a port model.

Input: the flax ``params`` and ``batch_stats`` trees as nested dicts of
numpy arrays (``jax.device_get`` of a JAX model's variables). Output: a
``state_dict`` for the matching port module. Layout conversions:

* conv kernel HWIO [kH, kW, I/g, O] → weight OIHW [O, I/g, kH, kW];
* Dense kernel [in, out] → Linear weight [out, in]; the IResNet fc
  additionally permutes its inputs from the flax NHWC flatten order
  (h·W·C + w·C + c) to the NCHW order (c·H·W + h·W + w) the port and the
  reference torch model flatten in;
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


def _flax_path(module_name: str) -> list[str]:
    """Port module name → flax module path: ``layer2.0.conv1`` →
    ``layer2_0/conv1``; ``downsample.0``/``.1`` → ``downsample_conv``/``_bn``."""
    parts = module_name.split(".") if module_name else []
    out, i = [], 0
    while i < len(parts):
        p = parts[i]
        if p.startswith("layer") and i + 1 < len(parts) and parts[i + 1].isdigit():
            out.append(f"{p}_{parts[i + 1]}")
            i += 2
        elif p == "downsample" and i + 1 < len(parts):
            out.append({"0": "downsample_conv", "1": "downsample_bn"}[parts[i + 1]])
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


def _fc_weight(kernel: np.ndarray) -> np.ndarray:
    """flax [H·W·C, O] (NHWC flatten) → torch [O, C·H·W] (NCHW flatten);
    C = 512 for the IResNet head."""
    hwc, o = kernel.shape
    c = 512
    s = int(round(math.sqrt(hwc // c)))
    if s * s * c != hwc:
        raise ValueError(f"fc input width {hwc} is not 512·s² for any spatial size s")
    return np.ascontiguousarray(kernel.T.reshape(o, s, s, c).transpose(0, 3, 1, 2).reshape(o, hwc))


def state_dict_from_flax(model: nn.Module, params: dict, batch_stats: dict) -> dict:
    """The port ``state_dict`` of ``model`` filled from flax variables."""
    from vlsfr_tpu_torch.models.iresnet import IResNet

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
            sd[pre + "weight"] = _fc_weight(k) if isinstance(model, IResNet) else k.T
            sd[pre + "bias"] = _get(params, path + ["bias"])
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}


def load_flax_variables(model: nn.Module, params: dict, batch_stats: dict) -> nn.Module:
    """Load flax variables into ``model`` in place (strict key match)."""
    model.load_state_dict(state_dict_from_flax(model, params, batch_stats), strict=True)
    return model
