"""Per-shard machinery of the model-sharded heads (port of
``vlsfr_tpu/parallel/_shard_common.py``; the label and merge pieces also
serve the class-sharded softmax head).

Each rank holds one contiguous block [2, Q/m, D] of the queue (first slot
``c0``) and the whole step's write plans and labels, which it localizes
(``localize``). The collective pieces take the mesh's process group; the
rest is collective-free, so that one process can also emulate several
shards (``merge_partials`` over a stacked shard axis).

The JAX module's scan fallbacks (``scan_partials`` / ``scan_bwd``) have no
copy here: the plain versions of the partial kernels
(``ops/twin_margin.quad_partial_*_plain``) take their role.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from vlsfr_tpu_torch.ops.margin import phi_prime
from vlsfr_tpu_torch.ops.twin_margin import effective_rows, plane_rows, twin_write_values


def carriers(g, rows, cols, seen):
    return g.float(), rows.to(torch.int32), cols.to(torch.int32), seen.float()


def localize_labels(c0: int, c_local: int, labels):
    """Shard-local labels of the block [c0, c0 + c_local): −1 = global
    outlier, −2 = a positive row whose target another shard owns (the split
    keeps the kernels' positive test right for outliers). Returns (local
    labels int32, owned)."""
    ll = labels - c0
    owned = (ll >= 0) & (ll < c_local)
    return torch.where(labels < 0, -1, torch.where(owned, ll, -2)).to(torch.int32), owned


def localize(c0: int, c_local: int, cols_i, labels):
    """Shard-local coordinates of the block [c0, c0 + c_local): write
    columns (−1 = another shard's) and labels (``localize_labels``).
    Returns (lcol, in_range, local labels, owned)."""
    lcol = cols_i - c0
    in_range = (lcol >= 0) & (lcol < c_local)
    lcol = torch.where(in_range, lcol, -1).to(torch.int32)
    return (lcol, in_range, *localize_labels(c0, c_local, labels))


def effective_label_rows(q_l, g32, rows_i, cols_i, seen_f, labels, owned, ll, qs_l=None):
    """The owner's effective label rows (r0e, rbe): its block's label rows
    (dequantised with the block's scales ``qs_l`` [2, Q/m] for an int8
    queue) with this step's writes applied, matched on GLOBAL slot ids
    (rows of non-owned labels are block row 0, never used).
    Collective-free."""
    safe = torch.where(owned, ll, 0).long()
    r0 = plane_rows(q_l, qs_l, 0, safe)
    r1 = plane_rows(q_l, qs_l, 1, safe)
    gids = torch.where(owned, labels, -1).long()
    return effective_rows(r0, r1, gids, g32, rows_i.long(), cols_i.long(), seen_f)


def owned_gt_parts(emb32, r0e, rbe, owned):
    """[2, rows] target cosines where this shard owns the target, else 0:
    summed over the shards they are the global (gt1, gt2)."""
    zero = emb32.new_zeros(())
    return torch.stack([torch.where(owned, (emb32 * r0e).sum(-1), zero),
                        torch.where(owned, (emb32 * rbe).sum(-1), zero)])


def owner_tail(d_emb, dgt, gt, owned, r0e, rbe, loss_type, margin):
    """d_emb + the φ'(gt)·d_gt paths (``dgt``, ``gt`` [2, rows], global)
    through the effective label rows, on the rows whose target this shard
    owns."""
    own = owned.float()[:, None]
    d_emb = d_emb + (dgt[0] * phi_prime(gt[0], loss_type, margin))[:, None] * r0e * own
    return d_emb + (dgt[1] * phi_prime(gt[1], loss_type, margin))[:, None] * rbe * own


def shard_write_values(q_l, g32, rows_i, cols_i, seen_f, lcol, in_range, qs_l=None):
    """Local-range q1 gather (dequantised for an int8 block) + the shared
    ``twin_write_values``: out-of-shard entries gather block row 0 — never
    selected, because no local column matches their slot. The same-slot
    structure inside ``twin_write_values`` uses GLOBAL columns (exact)."""
    q1_rows = plane_rows(q_l, qs_l, 1, torch.where(in_range, lcol, 0).long())
    return twin_write_values(q1_rows, g32, rows_i, cols_i, seen_f)


def merge_logsumexp(m_all, s_all):
    """(m, s) of the whole row from the shards' (max, sum of exp(x − max))
    stacked on a leading shard axis, summed in shard order. A shard state
    of (−inf, 0) adds nothing (and no NaN)."""
    gmax = m_all.max(dim=0).values
    ref = torch.where(torch.isinf(gmax), torch.zeros_like(gmax), gmax)
    return ref, (s_all * torch.exp(m_all - ref)).sum(dim=0)


def merge_partials(m_all, s_all, topk_all, k: int):
    """Merge the shards' online-softmax states, stacked on a leading shard
    axis: m_all / s_all [S, ...], topk_all [S, ..., k] → (m, s, topk) of
    the whole queue, in the layout ``ops/twin_margin.finalize_fwd`` takes."""
    ref, s = merge_logsumexp(m_all, s_all)
    cand = topk_all.movedim(0, -2).flatten(-2)  # [..., S·k]
    return ref, s, torch.topk(cand, k, dim=-1).values


def collective_merge(m_l, s_l, topk_l, k: int, group):
    """The global (m, s, topk) from every rank's partial state: one
    all_gather of the packed [..., 2 + k] state, then ``merge_partials``."""
    part = torch.cat([m_l[..., None], s_l[..., None], topk_l], dim=-1).contiguous()
    gathered = [torch.empty_like(part) for _ in range(dist.get_world_size(group))]
    dist.all_gather(gathered, part, group=group)
    every = torch.stack(gathered)
    return merge_partials(every[..., 0], every[..., 1], every[..., 2:], k)
