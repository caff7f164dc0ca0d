"""The dense heads on the model axis: the dense FFC head and the softmax
head's routes C and E with the class axis split over the ranks (JAX lets
GSPMD shard these einsums: the dense branch of
``vlsfr_tpu/core/ffc.py:directional_loss``, ``cosine_logits`` with a mesh in
``vlsfr_tpu/parallel/partial_fc.py``, and the sampled step of
``vlsfr_tpu/train/softmax_head.py`` gathering rows of a class-sharded
classifier). JAX runs them as XLA math, with no Pallas kernel, and so does
the port: plain torch per rank plus the group's collectives.

Each rank holds the whole batch and some columns of the class axis: its
block of the queue or of the classifier (``Mesh.class_block``), or on
route E the sampled positions whose class lies in its block. The caller
forms those columns' cosines [V, R, c] (V stacked views of R rows; plain
torch, with autograd) on embeddings passed through ``reduce_grad``, and
``ShardedDenseMargin`` turns them into each row's margin CE and
hard-negative term over the whole row:

* forward: the owner of each target takes its cosine, one all_reduce makes
  gt global; each rank reduces its columns to a block state
  (``block_stats``: the margin logits' max and sum of exponentials, and
  the top-k of the raw cosines with their global column ids); one
  all_gather and ``merge_stats`` give the global state, merged in rank
  order; ``finalize`` gives ce = logz − scale·φ(gt) and the mean clipped
  top-k (JAX's ``ops/margin.py:add_margin``);
* backward (``block_grad``): the cotangent of this rank's own cosines —
  the softmax term, the owner's target term and the selected top-k columns
  it holds — with no collective; ``reduce_grad`` then all_reduces d_emb
  once, and a classifier block's gradient is the rank's own.

Every rank computes the loss of the whole batch, so its autograd hands the
head the whole cotangent: no all_reduce of the cotangents. The top-k and
the argmax break ties to the lowest global column id, as ``lax.top_k`` and
``jnp.argmax`` do, whichever rank holds the column. The per-block
functions take no group, so one process can emulate several ranks
(``emulate``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from vlsfr_tpu_torch.ops.margin import phi_prime, phi_target, sv_boost, top_k_low_ids
from vlsfr_tpu_torch.parallel._shard_common import merge_logsumexp

NO_COLUMN = torch.iinfo(torch.int64).max  # the id of a padding candidate: never a tie winner


class _ReduceGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def reduce_grad(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` itself; its gradient is all_reduced over ``group`` on the way
    back (the ranks' d_emb partials, summed once)."""
    return _ReduceGrad.apply(x, group)


def owner_gt(cos, ll):
    """This rank's share of each row's target cosine [V, R]: the cosine at
    its held target column (``ll`` ≥ 0), 0 elsewhere; the ranks' shares sum
    to gt."""
    if cos.shape[-1] == 0:
        return cos.new_zeros(ll.shape)
    own = cos.gather(-1, ll.clamp(min=0).long()[..., None])[..., 0]
    return torch.where(ll >= 0, own, 0.0)


def block_logits(cos, ll, gt, *, loss_type, margin, scale, mask_svfc):
    """scale × the margin logits of this rank's columns ``cos`` [V, R, c]
    (JAX's ``margin_logits``): SV boosts the positive rows' hard columns
    (cos > gt − m, the global gt), the owned target column (``ll`` ≥ 0)
    becomes φ(gt); outlier rows (``ll`` = −1) keep their raw cosines."""
    x = cos
    if loss_type == "SV":
        x = torch.where((ll != -1)[..., None], sv_boost(cos, gt[..., None], margin, mask_svfc)[0],
                        cos)
    target = torch.arange(cos.shape[-1], device=cos.device) == ll[..., None]
    x = torch.where(target, phi_target(gt, loss_type, margin)[..., None], x)
    return scale * x


def block_stats(cos, ll, gt, col_ids, k: int, kw: dict):
    """This rank's block state of the rows ``cos`` [V, R, c] (global column
    ids ``col_ids`` [c], ascending): (m, s) of the margin logits, the max
    and the sum of exp(x − m) [V, R] (−inf and 0 for a rank with no
    column), and the raw cosines' top-k values and global ids [V, R, k]
    (padded with −inf and ``NO_COLUMN`` past c)."""
    lead, c = cos.shape[:-1], cos.shape[-1]
    if c == 0:
        m = cos.new_full(lead, float("-inf"))
        s = cos.new_zeros(lead)
    else:
        x = block_logits(cos, ll, gt, **kw)
        m = x.amax(-1)
        s = torch.exp(x - m[..., None]).sum(-1)
    kk = min(k, c)
    vals, ids = (top_k_low_ids(cos, col_ids, kk) if kk else
                 (cos.new_empty(*lead, 0), col_ids.new_empty(*lead, 0)))
    if kk < k:
        vals = torch.cat([vals, cos.new_full((*lead, k - kk), float("-inf"))], -1)
        ids = torch.cat([ids, ids.new_full((*lead, k - kk), NO_COLUMN)], -1)
    return m, s, vals, ids


def merge_stats(m_all, s_all, vals_all, ids_all, k: int):
    """The whole row's (logz, top-k values, top-k ids) from the block states
    stacked on a leading rank axis (m / s [S, ...], values / ids
    [S, ..., k]), merged in rank order; top-k ties go to the lowest id."""
    ref, s = merge_logsumexp(m_all, s_all)
    vals = vals_all.movedim(0, -2).flatten(-2)  # [..., S·k]
    ids = ids_all.movedim(0, -2).flatten(-2)
    order = torch.argsort(ids, dim=-1, stable=True)
    vals, ids = top_k_low_ids(vals.gather(-1, order), ids.gather(-1, order), k)
    return ref + torch.log(s), vals, ids


def finalize(logz, vals, gt, ll, k: int, *, loss_type, margin, scale, mask_svfc):
    """Per-row (ce, neg) of the whole row: ce = logz − scale·φ(gt) on the
    positive rows, the mean of the clipped top-k cosines on the outlier
    rows (``ll`` = −1), 0 elsewhere."""
    pos = ll != -1
    ce = logz - scale * phi_target(gt, loss_type, margin)
    neg = vals.clamp(min=0.0).sum(-1) / k
    return torch.where(pos, ce, 0.0), torch.where(pos, 0.0, neg)


def block_grad(cos, ll, gt, col_ids, logz, vals, ids, d_ce, d_neg, k: int, kw: dict):
    """The cotangent of this rank's cosines ``cos`` [V, R, c] (no
    collective): d_ce·softmax through the margin's slope on every column,
    d_ce·scale·φ′(gt)·(p_t − 1) at the owned target column, and
    d_neg / k · d clip(v)/dv at each selected top-k column this rank holds
    (``ids`` global, ``vals`` the merged values). ``d_ce`` and ``d_neg``
    [V, R] are taken on the positive and the outlier rows only."""
    loss_type, margin, scale = kw["loss_type"], kw["margin"], kw["scale"]
    c = cos.shape[-1]
    pos = ll != -1
    d_ce = torch.where(pos, d_ce, 0.0)
    d_neg = torch.where(pos, 0.0, d_neg)
    if c == 0:
        return torch.zeros_like(cos)
    p = torch.exp(block_logits(cos, ll, gt, **kw) - logz[..., None])
    slope = torch.full_like(cos, scale)
    if loss_type == "SV":
        hard = sv_boost(cos, gt[..., None], margin, kw["mask_svfc"])[1]
        slope = torch.where(hard & pos[..., None], scale * kw["mask_svfc"], slope)
    d = d_ce[..., None] * p * slope
    target = torch.arange(c, device=cos.device) == ll[..., None]
    p_t = torch.exp(scale * phi_target(gt, loss_type, margin) - logz)
    d_t = d_ce * scale * phi_prime(gt, loss_type, margin) * (p_t - 1.0)
    d = torch.where(target, d_t[..., None], d)
    # the selected top-k columns held here; jnp.maximum's slope is 1/2 at 0
    loc = torch.searchsorted(col_ids, ids.clamp(max=NO_COLUMN - 1))
    held = (loc < c) & (col_ids[loc.clamp(max=c - 1)] == ids)
    clip = torch.where(vals > 0, 1.0, torch.where(vals == 0, 0.5, 0.0))
    push = torch.zeros((*cos.shape[:-1], c + 1), dtype=cos.dtype, device=cos.device)
    push.scatter_(-1, torch.where(held, loc, c),
                  torch.where(held, d_neg[..., None] / k * clip, 0.0))
    return d + push[..., :c]


class ShardedDenseMargin(torch.autograd.Function):
    """``ShardedDenseMargin.apply(cos, ll, col_ids, group, kw, k)`` -> (ce,
    neg, gt, top-k values, top-k ids), each [V, R] (the top-k [V, R, k]):
    the whole row's margin CE and hard-negative term from this rank's
    cosines ``cos`` [V, R, c] with global column ids ``col_ids`` [c]
    (ascending) and the rows' targets ``ll`` [V, R] (the target's column
    in ``cos`` where this rank holds it, −2 where another rank does, −1 on
    an outlier row). ``kw``: loss_type, margin, scale, mask_svfc;
    ``k``: the top-k width. Differentiable w.r.t. ``cos`` only; the
    backward is this rank's own (``block_grad``)."""

    @staticmethod
    def forward(ctx, cos, ll, col_ids, group, kw, k):
        cos = cos.float()
        gt = owner_gt(cos, ll)
        dist.all_reduce(gt, group=group)
        m, s, vals, ids = block_stats(cos, ll, gt, col_ids, k, kw)
        # one all_gather of the packed state; f64 carries the f32 values
        # and the int64 ids below 2^53 exactly, and NO_COLUMN as a float
        part = torch.cat([m[..., None].double(), s[..., None].double(), vals.double(),
                          ids.double()], -1).contiguous()
        every = [torch.empty_like(part) for _ in range(dist.get_world_size(group))]
        dist.all_gather(every, part, group=group)
        every = torch.stack(every)
        got_ids = every[..., 2 + k:]
        got_ids = torch.where(got_ids >= 2.0**62, NO_COLUMN, got_ids.clamp(max=2.0**62).long())
        logz, vals, ids = merge_stats(every[..., 0].float(), every[..., 1].float(),
                                      every[..., 2:2 + k].float(), got_ids, k)
        ce, neg = finalize(logz, vals, gt, ll, k, **kw)
        ctx.save_for_backward(cos, ll, col_ids, gt, logz, vals, ids)
        ctx.kw, ctx.k = kw, k
        ctx.mark_non_differentiable(gt, vals, ids)
        return ce, neg, gt, vals, ids

    @staticmethod
    def backward(ctx, d_ce, d_neg, *_):
        cos, ll, col_ids, gt, logz, vals, ids = ctx.saved_tensors
        d_ce = torch.zeros_like(gt) if d_ce is None else d_ce
        d_neg = torch.zeros_like(gt) if d_neg is None else d_neg
        d_cos = block_grad(cos, ll, gt, col_ids, logz, vals, ids, d_ce, d_neg, ctx.k, ctx.kw)
        return d_cos, None, None, None, None, None


def emulate(parts, k: int, kw: dict, d_ce=None, d_neg=None):
    """``ShardedDenseMargin`` over several ranks' blocks held in one
    process, ``parts`` [(cos, ll, col_ids)] in rank order, its two
    collectives done here: gt summed over the blocks, their states stacked
    and merged. Returns ((ce, neg, gt, top-k values, ids), each block's
    cosine cotangent for the output cotangents ``d_ce`` / ``d_neg``, or
    None without them)."""
    gt = sum(owner_gt(cos, ll) for cos, ll, _ in parts)
    states = [block_stats(cos, ll, gt, ids, k, kw) for cos, ll, ids in parts]
    logz, vals, ids = merge_stats(*(torch.stack(x) for x in zip(*states)), k)
    ce, neg = finalize(logz, vals, gt, parts[0][1], k, **kw)
    grads = None
    if d_ce is not None:
        grads = [block_grad(cos.detach(), ll, gt, cids, logz, vals, ids, d_ce, d_neg, k, kw)
                 for cos, ll, cids in parts]
    return (ce, neg, gt, vals, ids), grads


def held_columns(col_ids: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Each target's column among this rank's ascending ``col_ids``, −2
    where it holds none of them (−1 kept for an outlier target < 0)."""
    c = col_ids.shape[0]
    if c == 0:
        return torch.where(targets < 0, -1, -2)
    loc = torch.searchsorted(col_ids, targets.long())
    held = (loc < c) & (col_ids[loc.clamp(max=c - 1)] == targets)
    return torch.where(targets < 0, -1, torch.where(held, loc, -2))
