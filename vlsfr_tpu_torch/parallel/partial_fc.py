"""Margin-softmax classifier loss (port of ``vlsfr_tpu/parallel/partial_fc.py``,
single-device part).

One classifier ``[num_classes, feat_dim]`` whose rows are normalised on
every forward (ArcFace convention), and the full-softmax margin loss over
it: the dense branch materialises the ``[B, C]`` cosines, the streaming
branch never does (``ops/margin_stream.py``, the CUDA kernels on the card).
Sharding the class axis over devices (``mesh``) and partial-FC class
sampling (``sample_classes``, and the denominator mask it needs) are not
ported yet.
"""

from __future__ import annotations

import torch

from vlsfr_tpu_torch.ops.margin import margin_logits
from vlsfr_tpu_torch.ops.margin_stream import MarginSoftmax


def _refuse_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError("a class-sharded classifier (mesh) is not ported yet")


def l2_normalize_rows(w: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    n = torch.sqrt(w.float().square().sum(dim=-1, keepdim=True))
    return w / n.clamp(min=eps)


def cosine_logits(emb: torch.Tensor, weights: torch.Tensor, mesh=None) -> torch.Tensor:
    """[B, D] normalised embeddings × [C, D] class weights → [B, C] cosines
    (the weight rows are normalised here)."""
    _refuse_mesh(mesh)
    return emb.float() @ l2_normalize_rows(weights).float().T


def margin_softmax_loss(emb, weights, labels, *, loss_type="Arc", margin=0.5, scale=32.0,
                        mask_svfc=1.2, mesh=None, streaming=False):
    """Full-softmax ArcFace/AM/SV loss over ``num_classes = weights.shape[0]``.

    Labels are class ids (no outlier rows). Returns (mean CE, metrics with
    ``ce`` and ``train_acc``). With ``streaming`` the class axis is streamed
    and ``train_acc`` is ``gt >= top1`` of the target-excluded running
    top-1 (ties count as correct); the dense branch takes the argmax."""
    _refuse_mesh(mesh)
    if streaming:
        ce, _neg, top1, gt = MarginSoftmax.apply(emb.float().contiguous(), weights, labels,
                                                 loss_type, float(margin), float(scale), 1,
                                                 float(mask_svfc))
        loss = ce.mean()
        acc = (gt >= top1[:, 0]).float().mean()
        return loss, {"ce": loss.detach(), "train_acc": acc}
    logits = cosine_logits(emb, weights)
    modified = margin_logits(logits, labels, loss_type=loss_type, margin=margin,
                             mask_svfc=mask_svfc) * scale
    logz = torch.logsumexp(modified, dim=-1)
    ce = logz - modified.gather(1, labels.long()[:, None])[:, 0]
    acc = (logits.argmax(dim=-1) == labels.long()).float().mean()
    loss = ce.mean()
    return loss, {"ce": loss.detach(), "train_acc": acc.detach()}
