"""Sparse classifier row updates (port of ``vlsfr_tpu/train/sparse_classifier.py``).

Routes D (sparse-d_w streaming) and E (partial-FC sampling with
``pool.sparse_update``) update only the step's selected classifier rows,
with SGD semantics (coupled weight decay, momentum, optional Nesterov) and
a bare f32 momentum buffer beside the classifier.

Visit-age momentum catch-up: a row that a dense SGD-momentum trajectory
would have kept moving during the steps it was not selected (zero gradient
there, the truncation's premise) first replays that geometric tail at its
next visit — Σ_{i=1..gap} μ^i·m (one more μ under Nesterov) — and decays
its momentum by μ^gap, then takes the normal step; ``last_visit`` [C]
int32 holds each row's last step. Rows not selected keep their value and
skip weight decay during the gap; the tail is replayed at the current lr
(both approximations are the JAX package's, documented there).

A bf16 classifier keeps its f32 momentum; the row write rounds twice, as
JAX's ``w.at[idx].add(delta.astype(w.dtype))`` does: the f32 step
−lr·(update + catch-up) rounded to bf16, then its sum with the row rounded
to bf16 (one rounding, the same values, in f32).
"""

from __future__ import annotations

import torch


def sparse_sgd_rows(w, momentum_buf, idx, grad_rows, *, lr, momentum: float, weight_decay: float,
                    nesterov: bool, last_visit, step: int):
    """The SGD step on the rows ``w[idx]`` only, IN PLACE on ``w``,
    ``momentum_buf`` and ``last_visit``; math in f32.

    ``idx`` [M] entries are unique; entries ≥ len(w) are dropped (padding
    rows of a ragged last tile, masked sampled columns), so the row writes
    are ``index_copy_`` of distinct rows: deterministic on a card too. Each
    row first catches up on gap = max(step − last − 1, 0) steps (module
    docstring; ``step`` the pre-increment counter) and its ``last_visit``
    becomes ``step``. Returns (w, momentum_buf, last_visit)."""
    keep = idx < w.shape[0]
    rows = idx[keep].long()  # one host sync: the count of kept rows
    w_sub = w[rows].float()
    m_sub = momentum_buf[rows].float()
    mu = momentum
    catchup = 0.0
    if mu > 0.0:
        gap = (step - last_visit[rows] - 1).clamp(min=0).float()[:, None]
        mu_gap = torch.pow(torch.tensor(mu, dtype=torch.float32, device=w.device), gap)
        geo = mu * (1.0 - mu_gap) / (1.0 - mu)
        catchup = (mu * geo if nesterov else geo) * m_sub
        m_sub = mu_gap * m_sub
    g = grad_rows[keep].float() + weight_decay * w_sub
    m_new = mu * m_sub + g
    update = g + mu * m_new if nesterov else m_new
    delta = (-lr * (update + catchup)).to(w.dtype).float()
    w.index_copy_(0, rows, (w_sub + delta).to(w.dtype))
    momentum_buf.index_copy_(0, rows, m_new.to(momentum_buf.dtype))
    last_visit.index_fill_(0, rows, int(step))
    return w, momentum_buf, last_visit
