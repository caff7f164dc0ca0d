"""The model-sharded twin FFC head (port of ``vlsfr_tpu/parallel/sharded_twin.py``).

One FFC direction over a queue split into blocks [2, Q/m, D], one per rank
of the mesh's group: the ``directional_loss``-compatible surface of the
sharded head (the train step's sharded route is the quad,
``parallel/sharded_quad.py``). Each rank localizes the step's write plan
and labels against its block (``_shard_common.localize``) and runs the
twin partial kernels (``ops/twin_margin.twin_partial_fwd`` / ``_bwd``,
CUDA kernels on the card):

* forward: the owner of each target computes its effective-view target
  cosines, one all_reduce makes them global (gt); each rank streams its
  block into the raw per-view state (m, s, top-k), the target column's
  z = scale·φ(gt) included on its owner only; one all_gather and
  ``merge_partials`` give the global state, logz = m + log s — no target
  term is added after the merge;
* backward: each rank's partial backward against the GLOBAL gt, logz, kth
  and cotangents (masked with the global positive rows) gives its d_emb
  partial and its owner-only raw d_gt; one all_reduce of d_gt, × φ'(gt) on
  the owner's effective label rows (``_shard_common.owner_tail``), then
  one all_reduce of d_emb.

Every rank computes the loss of the whole batch, so its autograd hands the
head the whole cotangent: no all_reduce of the cotangents (JAX's
``shard_map`` transpose split them, and its backward psums them back).
Differentiable w.r.t. ``emb`` only; f32 and bf16 blocks (int8 queues run
through the sharded quad). There is no data axis (``mesh.data > 1`` is
refused by ``parallel/mesh.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from vlsfr_tpu_torch.ops.margin import KTH_TIE_TOL
from vlsfr_tpu_torch.ops.twin_margin import (
    finalize_twin,
    reduce_margin_dir,
    twin_partial_bwd,
    twin_partial_fwd,
)
from vlsfr_tpu_torch.parallel._shard_common import (
    carriers,
    collective_merge,
    effective_label_rows,
    localize,
    owned_gt_parts,
    owner_tail,
    shard_write_values,
)


class TwinShardInputs(NamedTuple):
    """One shard's twin kernel inputs (one direction) and its owner-side
    pieces."""

    E: torch.Tensor  # [b, D] probes
    G: torch.Tensor  # [bp, D] writes
    V: torch.Tensor  # [bp, D] view-2 write values
    rows: torch.Tensor  # [bp] int32
    lcol: torch.Tensor  # [bp] int32, −1 = another shard's write
    blend: torch.Tensor  # [bp] int32
    labels: torch.Tensor  # [b] int32, shard-local (−1 outlier, −2 not owned)
    owned: torch.Tensor  # [b] bool
    r0e: torch.Tensor  # [b, D] effective label rows (meaningful where owned)
    rbe: torch.Tensor
    gt_parts: torch.Tensor  # [2, b] owner's target cosines, 0 elsewhere

    def kernel_args(self, q_l):
        """The twin partial kernels' leading arguments, over the block ``q_l``."""
        return (self.E, q_l[0], self.G, self.V, self.rows, self.lcol, self.blend, self.labels)


def twin_shard_inputs(emb, q_l, c0, g, rows, cols, seen, labels) -> TwinShardInputs:
    """Localize one direction against the block ``q_l`` starting at slot
    ``c0``. Collective-free."""
    c_local = q_l.shape[1]
    g32, rows_i, cols_i, seen_f = carriers(g, rows, cols, seen)
    lab = labels.to(torch.int32)
    lcol, in_range, ll, owned = localize(c0, c_local, cols_i, lab)
    r0e, rbe = effective_label_rows(q_l, g32, rows_i, cols_i, seen_f, lab, owned, ll)
    v, blend = shard_write_values(q_l, g32, rows_i, cols_i, seen_f, lcol, in_range)
    E = emb.float().contiguous()
    c = lambda t: t.contiguous()  # noqa: E731
    return TwinShardInputs(E, c(g32), c(v), c(rows_i), c(lcol), c(blend.to(torch.int32)), c(ll),
                           owned, r0e, rbe, owned_gt_parts(E, r0e, rbe, owned))


class ShardedTwinMargin(torch.autograd.Function):
    """``ops/twin_margin.TwinMargin`` over the mesh: the same five per-row
    outputs, from this rank's queue block and the group's collectives."""

    @staticmethod
    def forward(ctx, emb, q_l, g, rows, cols, seen, labels, mesh, kw, tile):
        c0, _ = mesh.class_block(q_l.shape[1] * mesh.model)
        si = twin_shard_inputs(emb, q_l, c0, g, rows, cols, seen, labels)
        gt = si.gt_parts.clone()
        dist.all_reduce(gt, group=mesh.group)
        m, s, topk = twin_partial_fwd(*si.kernel_args(q_l), gt, **kw)
        m, s, topk = collective_merge(m, s, topk, kw["k"], mesh.group)
        lab = labels.to(torch.int32)
        ce, neg, logz, topk = finalize_twin(m, s, topk, lab, gt, loss_type=kw["loss_type"],
                                            margin=kw["margin"], scale=kw["scale"])
        hit = ((gt[0] + KTH_TIE_TOL >= topk[0, :, 0]) & (lab >= 0)).float()
        ctx.save_for_backward(q_l, gt, logz, topk, lab, *si)
        ctx.mesh, ctx.kw, ctx.tile, ctx.dtype = mesh, kw, tile, emb.dtype
        ctx.mark_non_differentiable(hit)
        return ce[0], neg[0], ce[1], neg[1], hit

    @staticmethod
    def backward(ctx, dce1, dneg1, dce2, dneg2, _dhit):
        q_l, gt, logz, topk, lab, *rest = ctx.saved_tensors
        si = TwinShardInputs(*rest)
        kw, group = ctx.kw, ctx.mesh.group
        zeros = gt.new_zeros(gt.shape[1])
        c = [zeros if x is None else x.float() for x in (dce1, dneg1, dce2, dneg2)]
        # masked with the GLOBAL positive rows, so a −2 row's outlier test in
        # the partial backward adds nothing
        pos = (lab >= 0)[None, :]
        dce = torch.where(pos, torch.stack([c[0], c[2]]), 0.0).contiguous()
        dneg = torch.where(pos, 0.0, torch.stack([c[1], c[3]])).contiguous()
        kth = topk[:, :, -1].contiguous()
        d_emb, dgt = twin_partial_bwd(*si.kernel_args(q_l), gt, logz, kth, dce, dneg,
                                      tile=ctx.tile, **kw)
        dist.all_reduce(dgt, group=group)  # owner-only raw values → the global d_gt
        d_emb = owner_tail(d_emb, dgt, gt, si.owned, si.r0e, si.rbe, kw["loss_type"],
                           kw["margin"])
        dist.all_reduce(d_emb, group=group)
        return (d_emb.to(ctx.dtype),) + (None,) * 9


def make_sharded_twin_loss(mesh, *, loss_type="Arc", margin=0.5, scale=32.0, hard_neg=10,
                           mask_svfc=1.2, tile=512, with_acc=False):
    """``loss_fn(emb, q_l, g, rows, cols, seen, labels)`` -> loss[, acc]:
    ``ops/twin_margin.twin_add_margin``'s result, with this rank's queue
    block ``q_l`` [2, Q/m, D] (f32 or bf16) in place of the queue; the
    write plan and labels are the whole step's (global slot ids). ``tile``
    is JAX's kernel tile request, resolved over each block."""
    kw = dict(loss_type=loss_type, margin=float(margin), scale=float(scale), k=int(hard_neg),
              mask_svfc=float(mask_svfc))

    def loss_fn(emb, q_l, g, rows, cols, seen, labels):
        ce1, neg1, ce2, neg2, hit1 = ShardedTwinMargin.apply(emb, q_l, g.detach(), rows, cols,
                                                             seen, labels, mesh, kw, int(tile))
        loss = reduce_margin_dir(ce1, neg1, ce2, neg2, labels)
        if with_acc:
            n_pos = (labels >= 0).float().sum().clamp(min=1.0)
            return loss, (hit1.sum() / n_pos).detach()
        return loss

    return loss_fn
