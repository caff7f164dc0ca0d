"""Margin-softmax classifier loss (port of ``vlsfr_tpu/parallel/partial_fc.py``).

One classifier ``[num_classes, feat_dim]`` whose rows are normalised on
every forward (ArcFace convention), and the full-softmax margin loss over
it: the dense branch materialises the ``[B, C]`` cosines, the streaming
branch never does (``ops/margin_stream.py``, the CUDA kernels on the card).
Partial-FC sampling (arXiv 2010.05222): ``sample_classes`` builds the
step's class set (unique positives plus random negatives, duplicates
masked out of the denominator through ``col_mask``). With a ``mesh`` each
rank holds a block of the classifier and both branches run class-sharded:
the streaming branch through ``parallel/sharded_margin.py``, the dense
branch (JAX's GSPMD-sharded cosines) through ``sharded_margin_softmax``
(``parallel/sharded_dense.py``), which also serves partial-FC sampling
over a class-sharded classifier (route E). A bf16 classifier needs no kernel
here: its rows promote to f32 where they are normalised, so the cosines
are f32 and the gradient returns to the rows in bf16, as JAX's promotion
does.
"""

from __future__ import annotations

import torch

from vlsfr_tpu_torch.ops.margin import NEG_INF, margin_logits
from vlsfr_tpu_torch.ops.margin_stream import MarginSoftmax
from vlsfr_tpu_torch.parallel.sharded_dense import ShardedDenseMargin, held_columns, reduce_grad
from vlsfr_tpu_torch.parallel.sharded_margin import ShardedMarginSoftmax


def sample_classes(labels: torch.Tensor, num_classes: int, num_sampled: int,
                   rand: torch.Tensor | None) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The partial-FC sampled class set (``partial_fc.sample_classes``):
    every class contributes at most one column to the CE denominator.

    ``rand`` [S − B] are the random negatives' class draws in [0, C) (the
    caller's; JAX draws them with ``jax.random.randint``), None when
    S = B. Returns:

    * ``sampled`` [S] int32 — the batch labels, then the sorted draws;
      invalid positions keep a real id (safe to gather) for the caller to
      mask or drop;
    * ``local_labels`` [B] int32 — each row's target position in
      ``sampled``: its label's first occurrence in the batch;
    * ``valid`` [S] bool — False for a repeated batch label, a draw equal
      to the previous (sorted) draw, and a draw equal to a batch label.
    """
    b = labels.shape[0]
    labels = labels.to(torch.int32)
    eq = labels[:, None] == labels[None, :]
    first = eq.int().argmax(dim=1).to(torch.int32)  # the first match
    pos_valid = first == torch.arange(b, dtype=torch.int32, device=labels.device)
    if num_sampled - b > 0:
        rand = torch.sort(rand.to(torch.int32)).values
        rand_valid = torch.cat([torch.ones(1, dtype=torch.bool, device=rand.device),
                                rand[1:] != rand[:-1]])
        rand_valid &= ~(rand[:, None] == labels[None, :]).any(dim=1)
    else:
        rand = torch.zeros((0,), dtype=torch.int32, device=labels.device)
        rand_valid = torch.zeros((0,), dtype=torch.bool, device=labels.device)
    return torch.cat([labels, rand]), first, torch.cat([pos_valid, rand_valid])


def l2_normalize_rows(w: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    n = torch.sqrt(w.float().square().sum(dim=-1, keepdim=True))
    return w / n.clamp(min=eps)


def cosine_logits(emb: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """[B, D] normalised embeddings × [C, D] class weights → [B, C] cosines
    (the weight rows are normalised here)."""
    return emb.float() @ l2_normalize_rows(weights).float().T


def sharded_margin_softmax(emb, w_rows, col_ids, labels, group, *, loss_type="Arc", margin=0.5,
                           scale=32.0, mask_svfc=1.2):
    """The dense margin-softmax loss of the whole class row from this rank's
    columns (routes C and E on the model axis): classifier rows ``w_rows``
    [c, D] at global column ids ``col_ids`` [c] (ascending), ``labels``
    [B] the rows' target column ids. The ranks' statistics merge in
    ``parallel/sharded_dense.ShardedDenseMargin``; d_emb is all_reduced
    once, ``w_rows``' gradient is this rank's own. Returns (mean CE,
    metrics), the same on every rank; ``train_acc`` is JAX's argmax test,
    its ties going to the lowest column id."""
    kw = dict(loss_type=loss_type, margin=float(margin), scale=float(scale),
              mask_svfc=float(mask_svfc))
    cos = cosine_logits(reduce_grad(emb.float(), group), w_rows)
    ce, _, _, _, top = ShardedDenseMargin.apply(cos[None], held_columns(col_ids, labels)[None],
                                                col_ids, group, kw, 1)
    loss = ce[0].mean()
    acc = (top[0, :, 0] == labels.long()).float().mean()
    return loss, {"ce": loss.detach(), "train_acc": acc.detach()}


def margin_softmax_loss(emb, weights, labels, *, loss_type="Arc", margin=0.5, scale=32.0,
                        mask_svfc=1.2, mesh=None, streaming=False, col_mask=None):
    """Full-softmax ArcFace/AM/SV loss over ``num_classes = weights.shape[0]``.

    Labels are class ids (no outlier rows). Returns (mean CE, metrics with
    ``ce`` and ``train_acc``). With ``streaming`` the class axis is streamed
    and ``train_acc`` is ``gt >= top1`` of the target-excluded running
    top-1 (ties count as correct); the dense branch takes the argmax.
    ``col_mask`` [C] (dense branch only) takes columns out of the
    denominator and out of the argmax (partial-FC duplicate masking). With
    a ``mesh`` ``weights`` is this rank's block of the classifier and the
    loss and metrics are the whole classifier's (the dense branch: route
    C, ``sharded_margin_softmax``)."""
    if streaming:
        if col_mask is not None:
            raise ValueError("col_mask is a dense (sampled) path feature")
        args = (emb.float().contiguous(), weights, labels, loss_type, float(margin), float(scale),
                1, float(mask_svfc))
        if mesh is None:
            ce, _neg, top1, gt = MarginSoftmax.apply(*args)
        else:
            ce, _neg, top1, gt = ShardedMarginSoftmax.apply(*args, mesh)
        loss = ce.mean()
        acc = (gt >= top1[:, 0]).float().mean()
        return loss, {"ce": loss.detach(), "train_acc": acc}
    if mesh is not None:
        if col_mask is not None:
            raise ValueError("col_mask takes no mesh: route E's sharded step passes each "
                             "rank's columns to sharded_margin_softmax")
        c0, c_local = mesh.class_block(weights.shape[0] * mesh.model, "pool.num_classes")
        col_ids = torch.arange(c0, c0 + c_local, device=weights.device)
        return sharded_margin_softmax(emb, weights, col_ids, labels, mesh.group,
                                      loss_type=loss_type, margin=margin, scale=scale,
                                      mask_svfc=mask_svfc)
    logits = cosine_logits(emb, weights)
    if col_mask is not None:
        logits = torch.where(col_mask[None, :], logits, NEG_INF)
    modified = margin_logits(logits, labels, loss_type=loss_type, margin=margin,
                             mask_svfc=mask_svfc) * scale
    logz = torch.logsumexp(modified, dim=-1)
    ce = logz - modified.gather(1, labels.long()[:, None])[:, 0]
    acc = (logits.argmax(dim=-1) == labels.long()).float().mean()
    loss = ce.mean()
    return loss, {"ce": loss.detach(), "train_acc": acc.detach()}


def sharded_sampled_loss(emb, w_block, c0: int, labels, rand, num_classes: int,
                         num_sampled: int, group, **loss_kw):
    """Partial-FC sampling over a class-sharded classifier (route E on the
    model axis), on one rank: the step's class set from the batch labels
    and the draws ``rand`` (the same on every rank, so every rank builds
    the same set), of which this rank keeps the valid positions whose class
    lies in its block ``w_block`` [C/m, D] from class ``c0``; their cosines
    go through ``sharded_margin_softmax`` with the positions as column ids.
    Returns (mean CE, metrics, rows, w_sub): ``rows`` the block rows of
    those classes (unique), ``w_sub`` a leaf holding them that takes their
    gradient in the backward. Positions that are invalid or another rank's
    are dropped, as route D drops them."""
    sampled, local_labels, valid = sample_classes(labels, num_classes, num_sampled, rand)
    mine = valid & (sampled >= c0) & (sampled < c0 + w_block.shape[0])
    positions = torch.nonzero(mine).flatten()  # one host sync: the count of rows held
    rows = sampled[positions].long() - c0
    w_sub = w_block.detach()[rows].requires_grad_(True)
    loss, metrics = sharded_margin_softmax(emb, w_sub, positions, local_labels, group, **loss_kw)
    return loss, dict(metrics, sampled_classes=num_sampled), rows, w_sub


def sampled_margin_softmax_loss(emb, weights, labels, rand, num_sampled: int, *, loss_type="Arc",
                                margin=0.5, scale=32.0, mask_svfc=1.2):
    """Partial-FC class sampling (``partial_fc.sampled_margin_softmax_loss``):
    the CE denominator over the batch's classes plus the random negatives
    ``rand`` [num_sampled − B] (``sample_classes``), duplicates masked, so
    the classifier product and its gradient touch ``num_sampled`` rows.
    Gradients reach the sampled rows through the gather; masked columns
    get exact zeros. Returns (mean CE, metrics with ``sampled_classes``)."""
    if num_sampled < emb.shape[0]:
        raise ValueError("num_sampled must cover the batch's positives")
    sampled, local_labels, valid = sample_classes(labels, weights.shape[0], num_sampled, rand)
    loss, metrics = margin_softmax_loss(emb, weights[sampled.long()], local_labels,
                                        loss_type=loss_type, margin=margin, scale=scale,
                                        mask_svfc=mask_svfc, col_mask=valid)
    return loss, dict(metrics, sampled_classes=num_sampled)
