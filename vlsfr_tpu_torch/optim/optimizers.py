"""Optimizer factory (port of ``vlsfr_tpu/optim/optimizers.py``).

``torch.optim.SGD(momentum, nesterov, weight_decay)`` is the optax chain
``add_decayed_weights → trace(nesterov) → scale_by_learning_rate`` the JAX
package builds: the decay is coupled (added to the gradient first) and
applies to every parameter, BN and PReLU included; both start the
momentum trace from zero (torch's first step sets buf = g, optax's
g + μ·0). The learning rate is set per step by the caller
(``set_learning_rate``) from the schedule × the plateau scale. Only probe
parameters are optimised.
"""

from __future__ import annotations

import torch

from vlsfr_tpu_torch.config import OptimConfig


def make_optimizer(cfg: OptimConfig, params) -> torch.optim.Optimizer:
    if cfg.optim == "RMSprop":
        raise NotImplementedError("optim.optim='RMSprop' is not ported yet")
    if cfg.optim != "SGD":
        raise ValueError(f"optim must be SGD or RMSprop, got {cfg.optim!r}")
    return torch.optim.SGD(params, lr=cfg.lr, momentum=cfg.momentum,
                           nesterov=bool(cfg.nesterov and cfg.momentum),
                           weight_decay=cfg.weight_decay, dampening=0.0)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


def clip_by_global_norm_(params, max_norm: float, norm: torch.Tensor) -> None:
    """optax.clip_by_global_norm on the gradients, in place: g·max/‖g‖
    where ‖g‖ > max, unchanged otherwise."""
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for p in params:
        if p.grad is not None:
            p.grad.mul_(scale)
