"""The class-sharded sparse-d_w streaming softmax head, route D (port of
``vlsfr_tpu/parallel/sharded_sparse.py``).

Per rank, over its classifier block: the global gt (``sharded_margin.
block_gt``); the forward with tile statistics (``margin_ce_fwd``, whose
merge adds the target term on the owner); the logsumexp merge of the
blocks' logz and the top-k merge (one all_gather); the relevance selector
over the block's own tiles with this rank's random draws; the sparse
backward over the selected tiles and the exact d_emb from
``margin_ce_bwd(grad_w=False)``; one all_reduce of d_emb. On the data
axis the caller passes the global batch (``train/softmax_head.py``
gathers it over ``data``) and the model index's draws, so every data
replica of a block selects the same tiles and applies the same rows: JAX
gathers the selector's inputs over ``data``, folds the model index alone
into the key and sums the d_w rows over ``data``, the same rows summed in
another order.

JAX marks a row whose target another shard owns with the label ``1 << 30``
and leans on three properties of its own: the kernels stream the target
column in band (no column matches the sentinel), the selector's scatter
drops an out-of-range tile, and out-of-range gathers clamp. The port has
none of them (its forward merge adds scale·φ(gt) for every label ≥ 0, its
target-row helpers gather ``w[label]``, its selector's scatter raises), so
it keeps the block-local labels (−2 for such a row) and passes the global
positive rows as ``pos_rows`` to the selector (top-k test), the sparse
backward and the exact d_emb (cotangent masking). One difference follows:
an outlier row (label −1) keeps its hard-negative d_neg push here, where
JAX's sentinel drops it; full-softmax training has no outlier rows. A bf16
block takes the kernels' bf16 forms; the merges, the selection and the d_w
rows stay f32.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from vlsfr_tpu_torch.ops.margin_stream import (
    ce_and_neg,
    margin_ce_bwd,
    margin_ce_bwd_sparse,
    margin_ce_fwd,
    select_relevant_tiles,
    sparse_bwd_geometry,
)
from vlsfr_tpu_torch.parallel._shard_common import collective_merge
from vlsfr_tpu_torch.parallel.sharded_margin import block_gt


def sharded_sparse_margin_grads(emb, w_l, labels, d_ce, d_neg, *, mesh, m_tiles, loss_type="Arc",
                                margin=0.5, scale=32.0, hard_neg=1, mask_svfc=1.2, tile=512,
                                u=None):
    """``ops/margin_stream.streaming_sparse_margin_grads`` over the mesh:
    this rank's block ``w_l`` [C/m, D], the whole batch; ``m_tiles`` tiles
    of the block selected (``u`` [n_tiles of the block] this rank's random
    fill draws, or None). Returns (ce, neg, topk, gt, d_emb, row_idx
    [M·tile] int32, d_w_rows [M·tile, D]): the per-row outputs and the
    exact d_emb the same on every rank; ``row_idx`` numbered over the whole
    classifier, padding rows past the block's end set to C, and d_w_rows
    this rank's, scaled by the tiles' importance weights."""
    emb32 = emb.float().contiguous()
    labels = labels.to(torch.int32)
    b, d = emb32.shape
    c_local = w_l.shape[0]
    num_classes = c_local * mesh.model
    c0, _ = mesh.class_block(num_classes, "pool.num_classes")
    tile, n_tiles = sparse_bwd_geometry(b, d, c_local, tile)
    kw = dict(loss_type=loss_type, margin=float(margin), scale=float(scale), k=int(hard_neg),
              mask_svfc=float(mask_svfc))
    ll, gt = block_gt(emb32, w_l, labels, mesh)
    _, _, logz_l, topk_l, maxz, maxcos = margin_ce_fwd(emb32, w_l, ll, gt, with_stats=True,
                                                       tile=tile, **kw)
    # the blocks' logz (each with its owned targets) merge as states of s = 1
    ref, s, topk = collective_merge(logz_l, torch.ones_like(logz_l), topk_l, kw["k"], mesh.group)
    logz = ref + torch.log(s)
    ce, neg = ce_and_neg(logz, topk, labels, gt, loss_type=loss_type, margin=kw["margin"],
                         scale=kw["scale"])
    pos = labels >= 0
    tile_idx, tile_weight = select_relevant_tiles(maxz, maxcos, logz, topk, ll,
                                                  min(m_tiles, n_tiles), tile, u=u, pos_rows=pos)
    _, d_w_rows = margin_ce_bwd_sparse(emb32, w_l, ll, gt, logz, topk, d_ce, d_neg, tile_idx,
                                       tile=tile, pos_rows=pos, **kw)
    d_w_rows.mul_(tile_weight.repeat_interleave(tile)[:, None])
    d_emb, _ = margin_ce_bwd(emb32, w_l, ll, gt, logz, topk, d_ce, d_neg, grad_w=False,
                             pos_rows=pos, **kw)
    dist.all_reduce(d_emb, group=mesh.group)
    row_local = (tile_idx[:, None] * tile
                 + torch.arange(tile, dtype=torch.int32, device=emb32.device)[None, :]).reshape(-1)
    row_idx = torch.where(row_local < c_local, c0 + row_local, num_classes).to(torch.int32)
    return ce, neg, topk, gt, d_emb, row_idx, d_w_rows
