"""Margin-softmax losses with hard-negative outlier suppression (port of
``vlsfr_tpu/ops/margin.py`` plus the target-column helpers of
``vlsfr_tpu/ops/margin_pallas.py``).

Rows with ``label >= 0`` (the label is a pool slot) get a margin-modified,
scaled cross-entropy; outlier rows (``label == -1``) get the mean of their
top-``hard_neg`` clipped cosines. All loss math runs in float32. This dense
head serves queues below ``pool.streaming_threshold``; the fused quad head
(ops/twin_margin.py) reuses ``phi_target`` / ``phi_prime``.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30
# top-k membership in the backward is tested BY VALUE (cos >= kth); a
# recomputed cosine may differ from the forward's by an ulp, so the test
# keeps a 1e-6 tolerance (vlsfr_tpu/ops/margin_pallas.py KTH_TIE_TOL)
KTH_TIE_TOL = 1e-6
LOSS_TYPES = ("AM", "Arc", "SV")


def default_hard_neg(queue_size: int) -> int:
    """clamp(int(queue_size * 2e-4), 3, 10) — reference ffc.py:48."""
    return min(max(int(queue_size * 0.0002), 3), 10)


def kernel_width_ok(d: int) -> bool:
    """Whether the CUDA kernels take feature width ``d`` (the quad / twin
    and the margin_ce kernels alike: a multiple of 64 up to 512, at any
    batch); the plain versions take any."""
    return d % 64 == 0 and 0 < d <= 512


def _check_loss_type(loss_type: str) -> None:
    if loss_type not in LOSS_TYPES:
        raise ValueError(f"loss_type must be AM | Arc | SV, got {loss_type!r}")


def _f32(x: float) -> float:
    """Round a Python float to float32, as the JAX code's numpy constants."""
    return float(torch.tensor(x, dtype=torch.float32))


def phi_target(gt: torch.Tensor, loss_type: str, margin: float) -> torch.Tensor:
    """Modified target logit φ(gt), pre-scale. Arc clamps |gt| < 1 − 1e-6
    (the gradient of sqrt(1 − gt²) diverges at ±1)."""
    _check_loss_type(loss_type)
    if loss_type == "AM":
        return gt - margin
    if loss_type == "Arc":
        gt_c = gt.clamp(-1.0 + 1e-6, 1.0 - 1e-6)
        sin = torch.sqrt(1.0 - gt_c * gt_c)
        return gt_c * _f32(math.cos(margin)) - sin * _f32(math.sin(margin))
    return torch.where(gt > margin, gt - margin, gt)


def phi_prime(gt: torch.Tensor, loss_type: str, margin: float) -> torch.Tensor:
    """dφ/dgt with the mask/threshold treated constant; zero slope outside
    the Arc clamp."""
    _check_loss_type(loss_type)
    if loss_type == "Arc":
        inside = gt.abs() < 1.0 - 1e-6
        gt_c = gt.clamp(-1.0 + 1e-6, 1.0 - 1e-6)
        sin = torch.sqrt(1.0 - gt_c * gt_c)
        return torch.where(inside, _f32(math.cos(margin)) + gt_c / sin * _f32(math.sin(margin)),
                           torch.zeros_like(gt))
    return torch.ones_like(gt)


def sv_boost(cos, gt_col, margin, mask_svfc):
    """SV's non-target modification: (boosted cos, hard mask), boosting the
    hard columns (cos > gt − m) to mask_svfc·cos + mask_svfc − 1."""
    hard = cos > (gt_col - margin)
    return torch.where(hard, mask_svfc * cos + mask_svfc - 1.0, cos), hard


def tile_modified(cos, is_target, gt_col, valid, loss_type, margin, mask_svfc):
    """Margin-modified logits for a block of columns (pre-scale); invalid
    columns → NEG_INF. SV boosts hard non-target columns (cos > gt − m)."""
    mod = sv_boost(cos, gt_col, margin, mask_svfc)[0] if loss_type == "SV" else cos
    mod = torch.where(is_target, phi_target(gt_col, loss_type, margin), mod)
    return torch.where(valid, mod, torch.full_like(mod, NEG_INF))


def top_k_low_ids(x: torch.Tensor, ids: torch.Tensor, k: int):
    """(values, ids) of the k largest entries of ``x`` along its last axis,
    sorted by value, ties going to the lowest id (``ids`` holds each
    entry's id, ascending along the axis, or broadcast to ``x``)."""
    ids = ids.expand_as(x)
    kth = torch.topk(x, k, dim=-1).values[..., -1:]
    above = x > kth
    tied = x == kth
    take = above | (tied & (tied.long().cumsum(-1) <= k - above.long().sum(-1, keepdim=True)))
    n = x.shape[-1]
    first = n - torch.arange(n, device=x.device)  # larger for lower positions
    pos = torch.topk(torch.where(take, first, 0), k, dim=-1).indices  # the k taken, ascending
    vals = x.gather(-1, pos)
    order = torch.sort(vals, dim=-1, descending=True, stable=True).indices
    pos = pos.gather(-1, order)
    return x.gather(-1, pos), ids.gather(-1, pos)


def margin_logits(cos_theta: torch.Tensor, labels: torch.Tensor, *, loss_type: str,
                  margin: float, mask_svfc: float = 1.2) -> torch.Tensor:
    """Apply the margin transform to the target column of each positive
    row; outlier rows pass through unmodified. Returns unscaled float32."""
    _check_loss_type(loss_type)
    cos_theta = cos_theta.float()
    q = cos_theta.shape[-1]
    valid = labels >= 0
    onehot = torch.nn.functional.one_hot(labels.clamp(min=0).long(), q).float()
    gt = torch.sum(cos_theta * onehot, dim=-1, keepdim=True)
    if loss_type == "AM":
        out = cos_theta * (1.0 - onehot) + (gt - margin) * onehot
    elif loss_type == "Arc":
        gt_c = gt.clamp(-1.0 + 1e-6, 1.0 - 1e-6)
        sin_theta = torch.sqrt(1.0 - gt_c * gt_c)
        target_val = gt_c * _f32(math.cos(margin)) - sin_theta * _f32(math.sin(margin))
        out = cos_theta * (1.0 - onehot) + target_val * onehot
    else:
        boosted = sv_boost(cos_theta, gt, margin, mask_svfc)[0]
        final_gt = torch.where(gt > margin, gt - margin, gt)
        out = boosted * (1.0 - onehot) + final_gt * onehot
    return torch.where(valid[:, None], out, cos_theta)


def add_margin(cos_theta: torch.Tensor, labels: torch.Tensor, *, loss_type: str = "Arc",
               margin: float = 0.5, scale: float = 32.0, hard_neg: int = 3,
               mask_svfc: float = 1.2) -> torch.Tensor:
    """Scalar float32 loss: mean margin-CE over positive rows + mean of the
    top-``hard_neg`` clipped cosines over outlier rows (each term 0 when
    its row set is empty)."""
    cos_theta = cos_theta.float()
    pos = (labels >= 0).float()
    n_pos = pos.sum()
    n_out = (1.0 - pos).sum()
    logits = scale * margin_logits(cos_theta, labels, loss_type=loss_type, margin=margin,
                                   mask_svfc=mask_svfc)
    safe = labels.clamp(min=0).long()
    logz = torch.logsumexp(logits, dim=-1)
    ce = logz - logits.gather(1, safe[:, None])[:, 0]
    zero = cos_theta.new_zeros(())
    cls_loss = torch.where(n_pos > 0, (ce * pos).sum() / n_pos.clamp(min=1.0), zero)
    k = min(hard_neg, cos_theta.shape[-1])
    ar = torch.arange(cos_theta.shape[-1], device=cos_theta.device)
    topk = top_k_low_ids(cos_theta, ar, k)[0]  # lax.top_k's columns, for the gradient
    per_row = topk.clamp(min=0.0).sum(-1) / k
    neg_loss = torch.where(n_out > 0, (per_row * (1.0 - pos)).sum() / n_out.clamp(min=1.0),
                           zero)
    return cls_loss + neg_loss


def cross_entropy_label_smooth(logits: torch.Tensor, labels: torch.Tensor,
                               epsilon: float = 0.1) -> torch.Tensor:
    """Label-smoothed cross entropy: mean over the batch of −Σ_c q_c log p_c
    with q = (1−ε)·onehot + ε/C."""
    logits = logits.float()
    c = logits.shape[-1]
    logp = torch.log_softmax(logits, dim=-1)
    onehot = torch.nn.functional.one_hot(labels.long(), c).float()
    q = (1.0 - epsilon) * onehot + epsilon / c
    return torch.mean(torch.sum(-q * logp, dim=-1))
