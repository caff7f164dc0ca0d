"""Learning-rate schedules with fractional-epoch warmup (port of
``vlsfr_tpu/optim/schedules.py``).

``make_schedule`` returns ``lr(step) -> float`` on the host, computed in
float32 like the JAX traced version. While ``epoch < warmup_epochs``
lr = (epoch + iter_frac) / warmup_epochs · base; after warmup each policy
is a function of the integer ``last_epoch = epoch − warmup``:

* cos          — eta_min + (base − eta_min)(1 + cos(π·last/T_max))/2,
                 eta_min past max_epochs
* multistep    — base · Π gammas[:bisect_right(milestones, last)]
* exponential  — base · gamma^last
* linear       — base · (1 − (max−min)·last/(epochs·max))
* plateau      — constant base; ``PlateauController`` scales it host-side
"""

from __future__ import annotations

import bisect
from typing import Callable

import numpy as np

from vlsfr_tpu_torch.config import OptimConfig

f32 = np.float32


def make_schedule(cfg: OptimConfig, steps_per_epoch: int) -> Callable[[int], float]:
    spe = max(int(steps_per_epoch), 1)
    base = float(cfg.lr)
    warmup = int(cfg.warmup_epochs)
    epochs = int(cfg.epochs)
    name = cfg.scheduler

    if name == "multistep":
        milestones = [int(m) for m in cfg.milestones]
        factors = np.cumprod(np.concatenate([[1.0], np.asarray(cfg.gammas, np.float64)]))
        factors = factors.astype(np.float32)

        def post(last):
            return f32(base) * factors[bisect.bisect_right(milestones, last)]

    elif name == "cos":
        t_max = float(cfg.t_max if cfg.t_max > 0 else epochs)
        eta_min = float(cfg.eta_min)

        def post(last):
            if last + warmup >= epochs:
                return f32(eta_min)
            c = f32(np.cos(f32(np.pi) * f32(last) / f32(t_max)))
            return f32(eta_min) + f32(base - eta_min) * (f32(1) + c) / f32(2)

    elif name == "exponential":
        gamma = float(cfg.gamma)

        def post(last):
            return f32(base) * np.power(f32(gamma), f32(last))

    elif name == "linear":
        max_lr, min_lr = float(cfg.lr), float(cfg.lr_min)

        def post(last):
            ratio = f32(max_lr - min_lr) * f32(last) / f32(epochs) / f32(max_lr)
            return f32(base) * (f32(1) - ratio)

    elif name == "plateau":

        def post(last):
            return f32(base)

    else:
        raise ValueError(f"unknown scheduler {name!r}")

    def schedule(step: int) -> float:
        step = int(step)
        epoch, rem = divmod(step, spe)
        if epoch < warmup:
            frac = f32(rem) / f32(spe)
            return float((f32(epoch) + frac) / f32(max(warmup, 1)) * f32(base))
        return float(f32(post(max(epoch - warmup, 0))))

    return schedule


class PlateauController:
    """Host-side ReduceLROnPlateau (torch semantics: mode=min, factor,
    relative threshold 1e-4, patience, min_lr floor); the trainer feeds it
    the loss once per print window and multiplies the schedule by
    :attr:`scale`."""

    def __init__(self, factor: float = 0.1, patience: int = 10, min_lr: float = 0.0,
                 threshold: float = 1e-4, base_lr: float = 0.1):
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.threshold = threshold
        self.base_lr = base_lr
        self.best = float("inf")
        self.num_bad = 0
        self.scale = 1.0

    def observe(self, loss: float) -> float:
        if loss < self.best * (1.0 - self.threshold):
            self.best = loss
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.scale = max(self.scale * self.factor,
                                 self.min_lr / max(self.base_lr, 1e-12))
                self.num_bad = 0
        return self.scale

    def state_dict(self) -> dict:
        return {"best": self.best, "num_bad": self.num_bad, "scale": self.scale}

    def load_state_dict(self, d: dict) -> None:
        self.best, self.num_bad, self.scale = d["best"], d["num_bad"], d["scale"]
