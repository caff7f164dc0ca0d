"""The class-sharded streaming softmax head, route B (port of
``vlsfr_tpu/parallel/sharded_margin.py``), and the pieces routes A and D
share with it (``block_gt``, ``merged_forward``).

Each rank holds one contiguous block [C/m, D] of the classifier
(``Mesh.class_block``) and the whole batch, with block-local labels
(``_shard_common.localize_labels``: −1 outlier, −2 a target another rank
owns):

* forward: the owner of each target computes its cosine, one all_reduce
  makes ``gt`` global; each rank streams its block into a raw online-softmax
  state (``ops/margin_stream.margin_partial_fwd``: (m, s, top-k), the owned
  target column folded into (m, s) as scale·φ(gt), as JAX's partial kernel
  streams it in band); one all_gather and ``merge_partials`` give the global
  state, logz = m + log s;
* backward (``ShardedMarginSoftmax``): each rank's ``margin_partial_bwd``
  against the global gt, logz and kth, the cotangents masked with the
  GLOBAL positive rows (a −2 row's softmax gradient flows on every block);
  the owner's target tail, d_gt·φ′(gt) through its label rows, joins d_emb
  and, added by the owner block in batch order, the block's d_w; then one
  all_reduce of d_emb. The block's d_w needs no collective: it is this
  rank's own gradient.

Every rank computes the loss of the whole batch, so its autograd hands the
head the whole cotangent: no all_reduce of the cotangents (JAX's
``shard_map`` transpose needed one). The JAX module's scan fallbacks have
no copy here: the plain versions of the partial kernels take their role.
Route B's entry point is ``parallel/partial_fc.margin_softmax_loss`` with a
``mesh``, as in JAX.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from vlsfr_tpu_torch.ops.margin_stream import (
    _mask_cotangents,
    _target_rows,
    ce_and_neg,
    compute_gt,
    margin_partial_bwd,
    margin_partial_fwd,
)
from vlsfr_tpu_torch.parallel._shard_common import collective_merge, localize_labels


def block_gt(emb32, w_l, labels, mesh):
    """(block-local labels [B] int32, global gt [B]): the target cosines
    the owners compute, summed over the group."""
    c0, c_local = mesh.class_block(w_l.shape[0] * mesh.model, "pool.num_classes")
    ll, owned = localize_labels(c0, c_local, labels)
    gt = torch.where(owned, compute_gt(emb32, w_l, ll), 0.0)
    dist.all_reduce(gt, group=mesh.group)
    return ll, gt


def merged_forward(emb32, w_l, ll, labels, gt, kw: dict, group):
    """(ce, neg, logz, topk) of the whole classifier from this rank's block:
    the partial forward, one all_gather and the merge."""
    m, s, topk = margin_partial_fwd(emb32, w_l, ll, gt, **kw)
    m, s, topk = collective_merge(m, s, topk, kw["k"], group)
    logz = m + torch.log(s)
    ce, neg = ce_and_neg(logz, topk, labels, gt, loss_type=kw["loss_type"], margin=kw["margin"],
                         scale=kw["scale"])
    return ce, neg, logz, topk


class ShardedMarginSoftmax(torch.autograd.Function):
    """``ops/margin_stream.MarginSoftmax`` over the mesh: (ce, neg, topk, gt)
    of the whole batch against the whole classifier, from this rank's block
    ``w_l`` and the group's collectives; the gradient of ``w_l`` is the
    block's. ``topk`` and ``gt`` are monitoring outputs."""

    @staticmethod
    def forward(ctx, emb, w_l, labels, loss_type, margin, scale, hard_neg, mask_svfc, mesh):
        kw = dict(loss_type=loss_type, margin=margin, scale=scale, k=hard_neg,
                  mask_svfc=mask_svfc)
        labels = labels.to(torch.int32)
        emb32 = emb.float().contiguous()
        ll, gt = block_gt(emb32, w_l, labels, mesh)
        ce, neg, logz, topk = merged_forward(emb32, w_l, ll, labels, gt, kw, mesh.group)
        ctx.save_for_backward(emb32, w_l, labels, ll, gt, logz, topk)
        ctx.kw, ctx.mesh, ctx.dtype = kw, mesh, emb.dtype
        ctx.mark_non_differentiable(topk, gt)
        return ce, neg, topk, gt

    @staticmethod
    def backward(ctx, d_ce, d_neg, _d_topk, _d_gt):
        emb32, w_l, labels, ll, gt, logz, topk = ctx.saved_tensors
        kw = ctx.kw
        zeros = torch.zeros_like(logz)
        d_ce, d_neg = _mask_cotangents(labels >= 0, zeros if d_ce is None else d_ce,
                                       zeros if d_neg is None else d_neg)
        # the owner's target tail, from its label rows (0 on other rows)
        emb_term, d_wl = _target_rows(emb32, w_l, ll, gt, logz, d_ce, loss_type=kw["loss_type"],
                                      margin=kw["margin"], scale=kw["scale"])
        d_emb, d_w, _ = margin_partial_bwd(emb32, w_l, ll, gt, logz, topk[:, -1].contiguous(),
                                           d_ce, d_neg, d_wl.contiguous(),
                                           grad_w=ctx.needs_input_grad[1], **kw)
        d_emb = d_emb + emb_term
        dist.all_reduce(d_emb, group=ctx.mesh.group)
        if d_w is not None:  # the kernels store f32; JAX casts to the block's dtype
            d_w = d_w.to(w_l.dtype)
        return (d_emb.to(ctx.dtype), d_w) + (None,) * 7
