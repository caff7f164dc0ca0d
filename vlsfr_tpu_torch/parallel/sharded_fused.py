"""The class-sharded fused-SGD streaming softmax head, route A (port of
``vlsfr_tpu/parallel/sharded_fused.py``).

Each rank's classifier block and its momentum are updated in place inside
the streaming backward, exactly as on one device: the block's d_w is a
function of the whole batch's embeddings, the global logz / top-k and the
block, and every rank holds all of them. Per rank: the global gt, the
partial forward and the collective merge (``sharded_margin.block_gt`` /
``merged_forward``), then ``margin_ce_bwd_fused_sgd`` over the block with
the global positive rows as ``pos_rows`` (a −2 row keeps its softmax
gradient here; the target tail runs on the owner only), then one
all_reduce of d_emb. On the data axis the caller passes the global batch
(``train/softmax_head.py`` gathers the embeddings over ``data``, as JAX's
head does, and the gather's backward slices d_emb back to the rank's
rows), so every data replica of a block applies the same update. A bf16
block (and a bf16 or f32 momentum block) takes the kernels' bf16 forms;
the merges and d_emb stay f32.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from vlsfr_tpu_torch.ops.margin_stream import margin_ce_bwd_fused_sgd
from vlsfr_tpu_torch.parallel.sharded_margin import block_gt, merged_forward


def sharded_margin_grads_fused_sgd(emb, w_l, mom_l, labels, d_ce, d_neg, lr, *, mesh, momentum,
                                   nesterov, weight_decay, loss_type="Arc", margin=0.5,
                                   scale=32.0, hard_neg=1, mask_svfc=1.2):
    """``ops/margin_stream.streaming_margin_grads_fused_sgd`` over the mesh:
    this rank's block ``w_l`` / ``mom_l`` [C/m, D] of the classifier and
    momentum (updated IN PLACE), the whole batch's ``emb``, ``labels`` and
    output cotangents. Returns (ce, neg, topk, gt, d_emb, w_l, mom_l), the
    per-row outputs and d_emb the same on every rank."""
    emb32 = emb.float().contiguous()
    labels = labels.to(torch.int32)
    kw = dict(loss_type=loss_type, margin=float(margin), scale=float(scale), k=int(hard_neg),
              mask_svfc=float(mask_svfc))
    ll, gt = block_gt(emb32, w_l, labels, mesh)
    ce, neg, logz, topk = merged_forward(emb32, w_l, ll, labels, gt, kw, mesh.group)
    d_emb, w_l, mom_l = margin_ce_bwd_fused_sgd(
        emb32, w_l, mom_l, ll, gt, logz, topk, d_ce, d_neg, lr, momentum=momentum,
        nesterov=nesterov, weight_decay=weight_decay, pos_rows=labels >= 0, **kw)
    dist.all_reduce(d_emb, group=mesh.group)
    return ce, neg, topk, gt, d_emb, w_l, mom_l
