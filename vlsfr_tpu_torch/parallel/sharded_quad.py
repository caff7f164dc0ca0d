"""The model-sharded quad FFC head (port of ``vlsfr_tpu/parallel/sharded_quad.py``).

Each rank holds one block [2, Q/m, D] of the queue and runs the quad head's
one pass per forward and per backward over it (``quad_partial_fwd`` /
``quad_partial_bwd``, CUDA kernels on the card), on shard-local write
plans and labels (``_shard_common.localize``):

* forward: the owner of each target computes its effective-view target
  cosines, one all_reduce makes them global (gt); each rank streams its
  block into a negative-stream state (m, s, top-k), target excluded on the
  owner; one all_gather and ``merge_partials`` give the global state, and
  ``finalize_fwd`` adds each positive row's target term scale·φ(gt) — for
  every loss type, SV included (JAX's Pallas SV partial streams the target
  in-band instead; the sum is the same);
* backward: each rank's partial backward against the GLOBAL logz, kth and
  cotangents gives its d_emb partial and its owner-only d_gt; one
  all_reduce of d_gt, × φ'(gt) on the owner's effective label rows (the
  tail), then one all_reduce of d_emb.

Every rank computes the loss of the whole batch, so its autograd hands the
head the whole cotangent: no all_reduce of the cotangents (JAX's
``shard_map`` transpose needed one). Differentiable w.r.t. the two probe
embeddings only, as ``ops/twin_margin.quad_add_margin``.

Queue forms as the single-device head's: a bf16 or int8 block, an int8
block with its [2, Q/m] scales, and int8 compute (each rank quantises the
probes per row, which no shard changes).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from vlsfr_tpu_torch.ops.margin import KTH_TIE_TOL, phi_prime
from vlsfr_tpu_torch.ops.qqueue import quantize_rows
from vlsfr_tpu_torch.ops.twin_margin import (
    finalize_fwd,
    quad_partial_bwd,
    quad_partial_fwd,
    reduce_quad_outputs,
)
from vlsfr_tpu_torch.parallel._shard_common import (
    carriers,
    collective_merge,
    effective_label_rows,
    localize,
    owned_gt_parts,
    shard_write_values,
)


class ShardInputs(NamedTuple):
    """One shard's packed kernel inputs (both directions stacked as in
    ``ops/twin_margin.pack_dirs``) and its owner-side pieces."""

    E: torch.Tensor  # [2b, D] probes
    G: torch.Tensor  # [2bp, D] writes
    V: torch.Tensor  # [2bp, D] view-2 write values
    rows: torch.Tensor  # [2bp] int32
    lcol: torch.Tensor  # [2bp] int32, −1 = another shard's write
    blend: torch.Tensor  # [2bp] int32
    labels: torch.Tensor  # [2b] int32, shard-local (−1 outlier, −2 not owned)
    owned: torch.Tensor  # [2b] bool
    r0e: torch.Tensor  # [2b, D] effective label rows (meaningful where owned)
    rbe: torch.Tensor
    gt_parts: torch.Tensor  # [2, 2b] owner's target cosines, 0 elsewhere
    qs0: torch.Tensor | None = None  # int8 block: plane 0's scales [Q/m]
    e8q: torch.Tensor | None = None  # int8 compute: the probes quantised [2b, D]
    e8s: torch.Tensor | None = None  # ... and their scales [2b]

    def kernel_args(self, q_l):
        """The partial kernels' leading arguments, over the block ``q_l``."""
        return (self.E, q_l[0], self.G, self.V, self.rows, self.lcol, self.blend, self.labels)

    def form_kw(self) -> dict:
        """The partial kernels' form arguments (``qscales``, ``e8``)."""
        return dict(qscales=self.qs0, e8=None if self.e8q is None else (self.e8q, self.e8s))


def shard_inputs(emb_x, emb_y, q_l, c0, g_a, g_b, plan_a, plan_b, labels_a, labels_b,
                 qs_l=None, int8_compute=False) -> ShardInputs:
    """Localize both directions against the block ``q_l`` starting at slot
    ``c0`` (an int8 block with its scales ``qs_l`` [2, Q/m]).
    Collective-free."""
    c_local = q_l.shape[1]
    parts = []
    for emb, g, (rows, cols, seen), labels in ((emb_x, g_a, plan_a, labels_a),
                                               (emb_y, g_b, plan_b, labels_b)):
        g32, rows_i, cols_i, seen_f = carriers(g, rows, cols, seen)
        lab = labels.to(torch.int32)
        lcol, in_range, ll, owned = localize(c0, c_local, cols_i, lab)
        r0e, rbe = effective_label_rows(q_l, g32, rows_i, cols_i, seen_f, lab, owned, ll, qs_l)
        v, blend = shard_write_values(q_l, g32, rows_i, cols_i, seen_f, lcol, in_range, qs_l)
        parts.append((emb.float(), g32, v, rows_i, lcol, blend, ll, owned, r0e, rbe))
    E, G, V, rows, lcol, blend, ll, owned, r0e, rbe = (
        torch.cat([a, b]).contiguous() for a, b in zip(*parts))
    e8 = quantize_rows(E) if int8_compute and qs_l is not None else (None, None)
    return ShardInputs(E, G, V, rows, lcol, blend, ll, owned, r0e, rbe,
                       owned_gt_parts(E, r0e, rbe, owned),
                       None if qs_l is None else qs_l[0], *e8)


def owner_tail(d_emb, dgt, gt, si: ShardInputs, loss_type, margin):
    """d_emb + the φ'(gt)·d_gt paths through the effective label rows, on
    the rows whose target this shard owns."""
    own = si.owned.float()[:, None]
    d_emb = d_emb + (dgt[0] * phi_prime(gt[0], loss_type, margin))[:, None] * si.r0e * own
    return d_emb + (dgt[1] * phi_prime(gt[1], loss_type, margin))[:, None] * si.rbe * own


class ShardedQuadMargin(torch.autograd.Function):
    """``ops/twin_margin.QuadMargin`` over the mesh: the same ten per-row
    outputs, from this rank's queue block and the group's collectives."""

    @staticmethod
    def forward(ctx, emb_x, emb_y, q_l, qs_l, g_a, g_b, rows_a, cols_a, seen_a, rows_b, cols_b,
                seen_b, labels_a, labels_b, mesh, kw, int8_compute):
        b = emb_x.shape[0]
        c0, _ = mesh.class_block(q_l.shape[1] * mesh.model)
        si = shard_inputs(emb_x, emb_y, q_l, c0, g_a, g_b, (rows_a, cols_a, seen_a),
                          (rows_b, cols_b, seen_b), labels_a, labels_b, qs_l, int8_compute)
        gt = si.gt_parts.clone()
        dist.all_reduce(gt, group=mesh.group)
        pkw = dict(b=b, bp=rows_a.shape[0], **kw)
        m, s, topk = quad_partial_fwd(*si.kernel_args(q_l), gt, **pkw, **si.form_kw())
        m, s, topk = collective_merge(m, s, topk, kw["k"], mesh.group)
        labels = torch.cat([labels_a, labels_b]).to(torch.int32)
        ce, neg, logz, topk = finalize_fwd(m, s, topk, labels, gt, loss_type=kw["loss_type"],
                                           margin=kw["margin"], scale=kw["scale"])
        hit = ((gt[0] + KTH_TIE_TOL >= topk[0, :, 0]) & (labels >= 0)).float()
        ctx.save_for_backward(q_l, gt, logz, topk, labels, *si)
        ctx.mesh, ctx.pkw, ctx.dtypes = mesh, pkw, (emb_x.dtype, emb_y.dtype)
        ctx.mark_non_differentiable(hit)
        out = []
        for lo in (0, b):
            sl = slice(lo, lo + b)
            out += [ce[0, sl], neg[0, sl], ce[1, sl], neg[1, sl]]
        return (*out, hit[:b], hit[b:])

    @staticmethod
    def backward(ctx, *cots):
        q_l, gt, logz, topk, labels, *rest = ctx.saved_tensors
        si = ShardInputs(*rest)
        pkw, group = ctx.pkw, ctx.mesh.group
        b = pkw["b"]
        zeros = gt.new_zeros(b)
        c = [zeros if x is None else x.float() for x in cots[:8]]
        # cots order: (ce1a, neg1a, ce2a, neg2a, ce1b, neg1b, ce2b, neg2b);
        # masked with the GLOBAL positive rows, so a −2 row's outlier test
        # in the partial backward adds nothing
        pos = (labels >= 0)[None, :]
        dce = torch.stack([torch.cat([c[0], c[4]]), torch.cat([c[2], c[6]])])
        dneg = torch.stack([torch.cat([c[1], c[5]]), torch.cat([c[3], c[7]])])
        dce = torch.where(pos, dce, torch.zeros_like(dce)).contiguous()
        dneg = torch.where(pos, torch.zeros_like(dneg), dneg).contiguous()
        kth = topk[:, :, -1].contiguous()
        d_emb, dgt = quad_partial_bwd(*si.kernel_args(q_l), gt, logz, kth, dce, dneg, **pkw,
                                      **si.form_kw())
        dist.all_reduce(dgt, group=group)  # owner-only values → the global d_gt
        d_emb = owner_tail(d_emb, dgt, gt, si, pkw["loss_type"], pkw["margin"])
        dist.all_reduce(d_emb, group=group)
        dt_x, dt_y = ctx.dtypes
        return (d_emb[:b].to(dt_x), d_emb[b:].to(dt_y)) + (None,) * 15


def make_sharded_quad_loss(mesh, *, loss_type="Arc", margin=0.5, scale=32.0, hard_neg=10,
                           mask_svfc=1.2, with_acc=False, int8_compute=False):
    """``loss_fn(emb_x, emb_y, q_l, g_a, g_b, plan_a, plan_b, labels_a,
    labels_b, qscales=None)`` -> (loss_a, loss_b)[, acc]:
    ``quad_add_margin``'s signature and result, with this rank's queue
    block ``q_l`` [2, Q/m, D] (and, for an int8 queue, its scales'
    block [2, Q/m]) in place of the queue. Plans and labels are the whole
    step's (global slot ids). ``int8_compute`` takes effect on int8 blocks
    only, as in JAX."""
    kw = dict(loss_type=loss_type, margin=float(margin), scale=float(scale), k=int(hard_neg),
              mask_svfc=float(mask_svfc))

    def loss_fn(emb_x, emb_y, q_l, g_a, g_b, plan_a, plan_b, labels_a, labels_b, qscales=None):
        out = ShardedQuadMargin.apply(emb_x, emb_y, q_l, qscales, g_a.detach(), g_b.detach(),
                                      *plan_a, *plan_b, labels_a, labels_b, mesh, kw,
                                      bool(int8_compute))
        return reduce_quad_outputs(out, labels_a, labels_b, with_acc)

    return loss_fn
