"""Optimizer factory (port of ``vlsfr_tpu/optim/optimizers.py``).

``torch.optim.SGD(momentum, nesterov, weight_decay)`` is the optax chain
``add_decayed_weights → trace(nesterov) → scale_by_learning_rate`` the JAX
package builds: the decay is coupled (added to the gradient first) and
applies to every parameter, BN and PReLU included; both start the
momentum trace from zero (torch's first step sets buf = g, optax's
g + μ·0). The learning rate is set per step by the caller
(``set_learning_rate``) from the schedule × the plateau scale. Only probe
parameters are optimised.

The softmax head's classifier on its autograd routes does not go through
``torch.optim.SGD``, whose ``alpha`` ops on a bf16 leaf compute in f32 and
round once: ``sgd_leaf_`` replays what optax makes of a leaf in its own
dtype under ``jax.jit``, f32 or bf16 (``pool.classifier_dtype``). optax's
trace has the leaf's dtype, and the Python constants of the chain (wd, μ)
are weakly typed, so they enter the bf16 ops rounded to bf16; each op
rounds to bf16, except that XLA fuses the last sum of the Nesterov update
into the f32 product with the injected (f32) learning rate; then
``(p + u).astype(p.dtype)`` rounds once. Measured against optax under
``jax.jit`` on the CPU: bit for bit over three steps
(``tests/test_torch_margin_forms.py``).
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
    where ‖g‖ > max, unchanged otherwise; a bf16 gradient in its own dtype
    (``_clip_leaf``)."""
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for p in params:
        if p.grad is None:
            continue
        if p.grad.dtype == torch.float32:
            p.grad.mul_(scale)
        else:
            p.grad.copy_(torch.where(norm < max_norm, p.grad, _clip_leaf(p.grad, norm, max_norm)))


def in_dtype(x: float, dtype: torch.dtype) -> float:
    """A Python constant as a weakly typed JAX scalar enters an op on a
    ``dtype`` array: rounded to that dtype."""
    return float(torch.tensor(x, dtype=dtype))


@torch.no_grad()
def sgd_leaf_(p, trace, grad, lr: float, *, momentum: float, nesterov: bool,
              weight_decay: float) -> None:
    """The optax chain add_decayed_weights → trace(μ, nesterov) →
    scale_by_learning_rate on one leaf ``p`` in its own dtype, in place on
    ``p`` and its trace (module docstring): g = grad + wd·p, t' = g + μ·t
    (each op rounded to the leaf's dtype), u = g + μ·t' with the sum in
    f32 (Nesterov) or t', then p = dtype(p + (−lr)·u) in f32."""
    dt = p.dtype
    g = grad
    if weight_decay:
        g = g + in_dtype(weight_decay, dt) * p
    if momentum:
        mu = in_dtype(momentum, dt)
        trace.copy_(g + mu * trace)
        u = g.float() + (mu * trace).float() if nesterov else trace.float()
    else:
        u = g.float()
    p.copy_(p.float() + u * torch.tensor(-lr, dtype=torch.float32))


def _clip_leaf(g, norm, max_norm: float):
    """optax's clip of one gradient leaf in its own dtype: (g / norm) ·
    max_norm, norm and max_norm taken in g's dtype as JAX's casts and weak
    scalars take them."""
    return (g / norm.to(g.dtype)) * in_dtype(max_norm, g.dtype)
