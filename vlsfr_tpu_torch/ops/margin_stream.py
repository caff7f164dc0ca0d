"""Port of ``vlsfr_tpu/ops/margin_pallas.py`` (single-device part): the
streaming margin-softmax cross-entropy over a huge class axis.

Normalised embeddings ``emb [B, D]`` against class weights ``w [C, D]``
with the margin transform, scaled CE on rows with a class label and the
hard-negative term on outlier rows (``label == -1``), without ever holding
the ``[B, C]`` logits (0.5 GB at B = 128, C = 2^20).

Kernel boundary. ``margin_ce_fwd`` (with ``with_stats`` also the per-tile
row maxima), ``margin_ce_bwd``, ``margin_ce_bwd_fused_sgd``,
``margin_ce_bwd_sparse``, ``margin_partial_fwd`` and ``margin_partial_bwd``
keep the JAX functions' arguments and outputs (``pallas_margin_ce_fwd`` /
``_bwd`` / ``_bwd_fused_sgd`` / ``_bwd_sparse``,
``pallas_margin_partial_fwd`` / ``_bwd``; the partial backward also takes
the owner's label-row gradient ``d_wl`` to add in its d_w pass). For CUDA
tensors they launch the hand-written kernels in ``csrc/margin_ce.cu``; for
CPU tensors they run the plain PyTorch versions beside them (``*_plain``).
There is no other route and no switch.

Sparse d_w (``streaming_sparse_margin_grads``): the forward's tile
statistics pick the M class tiles whose d_w can matter
(``select_relevant_tiles``, targets forced, random fill from draws the
caller passes in) and the sparse backward computes the d_w rows of those
tiles only, scaled by their importance weights.

Around the kernels, as in JAX, plain torch does the B-row work: the target
cosines ``gt`` (``compute_gt``) and the target-column gradient — the
analytic d_gt = (exp(scale·φ(gt) − logz) − 1)·d_ce·scale·φ′(gt), routed
into ``d_emb`` through the label rows and into the label rows' gradient
``d_wl`` (``_target_rows``). The streamed part of every path excludes the
target column from the gradient; the target term joins outside.

Relevance gate. The Pallas backward skips the exp and products of a class
tile that carries no softmax mass (every row's z − logz ≤ −20, no target,
no top-k member). Neither the plain versions nor the CUDA kernels apply
that gate: every column's terms are computed, as in the scan reference
``_stream_bwd``.

Classifier forms, read from ``w.dtype`` (and the fused update's momentum
form from ``mom.dtype``), as JAX reads them (``mxu_bf16 = w.dtype ==
bfloat16`` in each Pallas wrapper). An f32 classifier keeps f32
throughout. A bf16 classifier rounds where the Pallas kernels round
(``_mxu_pair``): each staged row is normalised in f32 and the normalised
row ŵ, not the stored one, is rounded to bf16; the embedding is rounded to
bf16; the backward rounds d_cos to bf16 before both of its products
(d_emb += bf16(d_cos) @ bf16(ŵ), d_ŵ = bf16(d_cos)ᵀ @ bf16(emb)), and the
normalisation's backward runs in f32 on the unrounded ŵ and 1/‖w‖. Every
product accumulates in f32, and a product of two bf16 values is exact in
f32, so the kernels' tensor-core products over the rounded operands are
the MXU's dot up to the order of the sums (their cosines one chain in
every pass: ``clean_cos``). The row norm of a bf16 row is summed in f64
(``bf16_row_inv``: exact for bf16 values in any order, then one rounding
to f32), so the kernels and the plain versions round the same normalised
operand bit for bit; JAX sums the squares in f32, and its 1/‖w‖ may sit
one f32 ulp away, which moves a handful of rounded operands by one bf16
ulp. d_w leaves every backward in f32 (the Pallas kernels' store);
``MarginSoftmax`` casts it to ``w.dtype`` as ``pallas_margin_ce_bwd``'s
tail does. The fused update computes in f32 from the stored W and mom and
rounds each of ``new_w`` and ``new_mom`` once to its storage dtype. The
target terms (``compute_gt``, ``_target_rows``) stay unrounded f32 on the
B label rows, as in JAX.

One block of a class-sharded classifier (``parallel/sharded_margin.py``,
``sharded_fused.py``, ``sharded_sparse.py``): ``margin_partial_fwd`` /
``margin_partial_bwd`` (``pallas_margin_partial_fwd`` / ``_bwd``) stream
the block against a global ``gt`` (and, backward, a global ``logz`` /
``kth``). Labels are block-local: −1 an outlier row, −2 a positive row
whose target another block owns, ≥ 0 an owned target column. A −2 row is
positive globally, so the callers pass the global positive rows as
``pos_rows`` wherever the cotangents are masked; the target terms stay on
the owner, whose label is the only one that is ≥ 0.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from vlsfr_tpu_torch.ops.margin import (
    KTH_TIE_TOL,
    LOSS_TYPES,
    NEG_INF,
    _f32,
    kernel_width_ok,
    phi_prime,
    phi_target,
    tile_modified,
)

KMAX = 16  # largest hard_neg the kernels keep a register top-k for
RANDOM_FILL_FRAC = 0.5  # share of the sparse tile budget the random fill boosts
KERNELS = ("margin_ce_fwd", "margin_ce_bwd", "margin_ce_bwd_fused_sgd", "margin_ce_bwd_sparse",
           "margin_partial_fwd", "margin_partial_bwd")
# one counter per kernel form: the name at f32, name[bf16] at a bf16 classifier,
# and the fused kernel's name[w,mom] where either is bf16 (``_launch_key``)
LAUNCH_COUNTS = {
    **dict.fromkeys(KERNELS, 0),
    **{f"{name}[bf16]": 0 for name in KERNELS if name != "margin_ce_bwd_fused_sgd"},
    **{f"margin_ce_bwd_fused_sgd[{pair}]": 0 for pair in ("bf16,bf16", "bf16,f32", "f32,bf16")}}


def reset_launch_counts() -> None:
    for name in LAUNCH_COUNTS:
        LAUNCH_COUNTS[name] = 0


def _launch_key(name: str, w, mom=None) -> str:
    """The counter of kernel ``name`` in the form of ``w`` (and ``mom``)."""
    tags = ["bf16" if t.dtype == torch.bfloat16 else "f32" for t in (w, mom) if t is not None]
    return name if tags == ["f32"] * len(tags) else f"{name}[{','.join(tags)}]"


def _count_launch(name: str, w, mom=None) -> None:
    LAUNCH_COUNTS[_launch_key(name, w, mom)] += 1


# ----------------------------------------------------------------------
# B-row helpers (plain torch on every device, as XLA ops in JAX)
# ----------------------------------------------------------------------


def _normalize_rows(w, eps=1e-12):
    w = w.float()
    n2 = w.square().sum(dim=-1, keepdim=True)
    return w * torch.rsqrt(n2.clamp(min=eps * eps))


W_DTYPES = (torch.float32, torch.bfloat16)  # the classifier (and momentum) forms


def _bf16r(x):
    """x rounded to bf16 (nearest even), held in f32."""
    return x.to(torch.bfloat16).float()


def bf16_row_inv(w_rows):
    """1/‖w‖ [n, 1] f32 of bf16 rows as the bf16 forms take it: the squares
    summed in f64 (exact for bf16 values, in any order), clamped at 1e-24,
    1/sqrt in f64, rounded once to f32. ``csrc/margin_ce.cu``'s
    ``inv_norm_bf16_kernel`` computes the same bits."""
    n2 = w_rows.double().square().sum(dim=-1, keepdim=True)
    return (1.0 / torch.sqrt(n2.clamp(min=1e-24))).float()


def _form_rows(w_rows):
    """(ŵ f32, ŵ as the dot operand, 1/‖w‖) of a block of rows in their
    form: f32 rows as JAX normalises them, rsqrt(max(Σ w², 1e-24)) in f32,
    and ŵ is the operand; bf16 rows normalised in f32 (``bf16_row_inv``)
    and the operand is bf16(ŵ)."""
    w32 = w_rows.float()
    if w_rows.dtype == torch.bfloat16:
        inv = bf16_row_inv(w_rows)
        wn = w32 * inv
        return wn, _bf16r(wn), inv
    inv = torch.rsqrt(w32.square().sum(dim=-1, keepdim=True).clamp(min=1e-24))
    wn = w32 * inv
    return wn, wn, inv


def _operand(x, w):
    """An f32 dot operand (the embedding, d_cos) against the classifier
    ``w``: rounded to bf16 against a bf16 classifier."""
    return _bf16r(x) if w.dtype == torch.bfloat16 else x


def compute_gt(emb, w, labels):
    """gt_i = cos(emb_i, ŵ[label_i]) via one row gather (the row of class 0
    for outlier rows, as in JAX)."""
    return (emb.float() * _normalize_rows(w[labels.clamp(min=0).long()])).sum(dim=-1)


def _positive(labels, pos_rows):
    """The positive rows: ``labels >= 0``, or ``pos_rows`` [B] bool where
    the labels are block-local (a −2 row is positive)."""
    return labels >= 0 if pos_rows is None else pos_rows


def _mask_cotangents(pos, d_ce, d_neg):
    """ce ≡ 0 on outlier rows and neg ≡ 0 on positive rows (``pos``):
    their cotangents must not leak."""
    zero = torch.zeros((), device=pos.device)
    return (torch.where(pos, d_ce.float(), zero).contiguous(),
            torch.where(pos, zero, d_neg.float()).contiguous())


def ce_and_neg(logz, topk, labels, gt, *, loss_type, margin, scale):
    """ce = logz − scale·φ(gt) on positive rows, neg = the mean clipped
    top-k on outlier rows, each 0 on the other rows."""
    pos = labels >= 0
    zero = torch.zeros_like(logz)
    return (torch.where(pos, logz - scale * phi_target(gt, loss_type, margin), zero),
            torch.where(pos, zero, topk.clamp(min=0.0).mean(dim=-1)))


def _target_dz(gt, logz, d_ce, *, loss_type, margin, scale):
    """dz at the target column, (p_t − 1)·d_ce·scale with p_t from the
    outside gt (``d_ce`` comes masked)."""
    p_t = torch.exp(scale * phi_target(gt, loss_type, margin) - logz)
    return (p_t - 1.0) * d_ce * scale


def _owned_target_dz(labels, gt, logz, d_ce, *, loss_type, margin, scale):
    """``_target_dz`` on the rows whose target column this block holds
    (label ≥ 0), 0 elsewhere: the partial backward's d_gt_raw."""
    return torch.where(labels >= 0, _target_dz(gt, logz, d_ce, loss_type=loss_type,
                                               margin=margin, scale=scale), 0.0)


def _target_rows(emb, w, labels, gt, logz, d_ce, *, loss_type, margin, scale):
    """The target column's gradient from the pre-update label rows:
    (its ``d_emb`` term [B, D], the label rows' gradient ``d_wl`` [B, D]).
    ``d_ce`` comes masked; both terms are 0 on outlier rows."""
    d_gt = _target_dz(gt, logz, d_ce, loss_type=loss_type, margin=margin,
                      scale=scale) * phi_prime(gt, loss_type, margin)
    return _label_rows_grad(emb, w, labels, d_gt)


def _label_rows_grad(emb, w, labels, d_gt):
    """(d_emb term [B, D], label rows' gradient d_wl [B, D]) of a gradient
    ``d_gt`` [B] on the target cosines (φ′ included), through the gather of
    the normalised label rows; both 0 on outlier rows."""
    pos1 = (labels >= 0).float()[:, None]
    wl = w[labels.clamp(min=0).long()].float()
    wln = _normalize_rows(wl)
    d_wln = d_gt[:, None] * emb.float() * pos1
    inv = torch.rsqrt(wl.square().sum(dim=-1, keepdim=True).clamp(min=1e-24))
    d_wl = inv * (d_wln - wln * (d_wln * wln).sum(dim=-1, keepdim=True))
    return d_gt[:, None] * wln * pos1, d_wl


def _sgd_rows(w, mom, d_w, lr, *, momentum, nesterov, weight_decay):
    """The optax wd → trace(μ, nesterov) → (−lr) chain on a block of rows,
    in place on ``w`` and ``mom`` (the fused kernel's ``_apply_update``):
    f32 math from the stored rows, each of w' and mom' rounded once to its
    storage dtype."""
    w32 = w.float()
    g = d_w
    if weight_decay:
        g = g + weight_decay * w32
    if momentum:
        new_mom = momentum * mom.float() + g
        upd = g + momentum * new_mom if nesterov else new_mom
    else:
        new_mom = upd = g
    w.copy_(w32 - lr * upd)
    mom.copy_(new_mom)


# ----------------------------------------------------------------------
# plain versions of the dense kernels (chunked over C)
# ----------------------------------------------------------------------


def _chunk_cos(e_op, w, lo, hi, cos=None):
    """(cos [B, n], ŵ, ŵ's operand, 1/‖w‖) of the rows [lo, hi) in their
    form, against the embedding operand ``e_op``; the columns [lo, hi) of
    ``cos`` [B, C] where it is given (``margin_ce_bwd_plain``)."""
    wn, wn_op, inv = _form_rows(w[lo:hi])
    return e_op @ wn_op.T if cos is None else cos[:, lo:hi], wn, wn_op, inv


def _dcos(cos, col, labels, gt, logz, kth, d_ce, d_neg, *, loss_type, margin, scale, k,
          mask_svfc, valid=None):
    """d loss / d cos over the columns ``col`` [n] (``cos`` [B, n]), 0 at
    the target column (its gradient joins through d_gt) and at columns past
    the class axis (``valid`` False). ``d_ce``/``d_neg`` come masked."""
    is_target = col[None, :] == labels[:, None].long()
    valid = torch.ones_like(is_target) if valid is None else valid[None, :].expand_as(is_target)
    mod = tile_modified(cos, is_target, gt[:, None], valid, loss_type, margin, mask_svfc)
    dz = torch.exp(scale * mod - logz[:, None]) * d_ce[:, None] * scale
    if loss_type == "SV":
        hard = cos > (gt[:, None] - margin)
        dz = torch.where(hard, dz * mask_svfc, dz)
    zero = torch.zeros_like(dz)
    d_cos = torch.where(is_target, zero, dz)
    in_topk = (cos >= kth[:, None] - KTH_TIE_TOL) & (cos > 0) & (labels < 0)[:, None]
    return torch.where(valid, d_cos + torch.where(in_topk, d_neg[:, None] / k, zero), zero)


def _rows_dw(dc_op, e_op, wn, inv):
    """d_w = inv·(d_ŵ − ŵ⟨d_ŵ, ŵ⟩), d_ŵ = dc_opᵀ @ e_op: the row
    normalisation's backward, in f32 on the unrounded ŵ and inv."""
    d_wn = dc_op.T @ e_op
    return inv * (d_wn - wn * (d_wn * wn).sum(dim=-1, keepdim=True))


def _tile_max(x, tile):
    """[B, n] → [ceil(n / tile), B]: the row maxima of each ``tile``
    columns, a ragged last tile padded with NEG_INF."""
    pad = (-x.shape[1]) % tile
    if pad:
        x = torch.nn.functional.pad(x, (0, pad), value=NEG_INF)
    return x.view(x.shape[0], -1, tile).amax(dim=-1).T


def _stream_plain(emb, w, labels, gt, *, loss_type, margin, scale, k, mask_svfc,
                  with_stats=False, tile=512, chunk=32768):
    """The online softmax over w's columns, chunk by chunk: (m [B], s [B],
    topk [B, k]), the target column of a row with label ≥ 0 streamed in
    band as scale·φ(gt) and kept out of the top-k; with ``with_stats``
    also (maxz, maxcos) [n_tiles, B]."""
    b = emb.shape[0]
    c = w.shape[0]
    dev = emb.device
    e_op = _operand(emb.float(), w)
    m = torch.full((b,), NEG_INF, device=dev)
    s = torch.zeros((b,), device=dev)
    topk = torch.full((b, k), NEG_INF, device=dev)
    if with_stats:
        chunk = max(chunk // tile, 1) * tile  # a chunk holds whole stats tiles
        maxz, maxcos = [], []
    for lo in range(0, c, chunk):
        hi = min(c, lo + chunk)
        cos, *_ = _chunk_cos(e_op, w, lo, hi)
        col = torch.arange(lo, hi, device=dev)
        is_target = col[None, :] == labels[:, None].long()
        mod = tile_modified(cos, is_target, gt[:, None], torch.ones_like(is_target), loss_type,
                            margin, mask_svfc)
        z = scale * mod
        m_new = torch.maximum(m, z.max(dim=1).values)
        s = s * torch.exp(m - m_new) + torch.exp(z - m_new[:, None]).sum(dim=1)
        m = m_new
        # top-k over NON-target columns: the hit test gt >= topk[:, 0] must
        # never compare gt against a recomputation of itself
        cand = torch.where(is_target, torch.full_like(cos, NEG_INF), cos)
        topk = torch.topk(torch.cat([topk, cand], dim=1), k, dim=1).values
        if with_stats:
            maxz.append(_tile_max(z, tile))
            maxcos.append(_tile_max(cos, tile))
    if with_stats:
        return m, s, topk, torch.cat(maxz), torch.cat(maxcos)
    return m, s, topk


def margin_ce_fwd_plain(emb, w, labels, gt, *, loss_type, margin, scale, k, mask_svfc,
                        with_stats=False, tile=512, chunk=32768):
    """Plain PyTorch version of the forward kernel; same inputs and outputs
    as ``margin_ce_fwd`` (the scan reference ``_stream_fwd``). With
    ``with_stats`` also (maxz, maxcos) [n_tiles, B]: per ``tile`` classes,
    each row's max of scale·mod (scale·φ(gt) at the target) and of the raw
    cosines (the target's own included)."""
    m, s, topk, *stats = _stream_plain(emb, w, labels, gt, loss_type=loss_type, margin=margin,
                                       scale=scale, k=k, mask_svfc=mask_svfc,
                                       with_stats=with_stats, tile=tile, chunk=chunk)
    logz = m + torch.log(s)
    ce, neg = ce_and_neg(logz, topk, labels, gt, loss_type=loss_type, margin=margin, scale=scale)
    return (ce, neg, logz, topk, *stats)


def margin_partial_fwd_plain(emb, w, labels, gt, *, loss_type, margin, scale, k, mask_svfc,
                             chunk=32768):
    """Plain PyTorch version of ``margin_partial_fwd`` (the scan fallback
    ``sharded_margin._local_partials``): the block's raw (m, s, topk), the
    owned target column (label ≥ 0) in (m, s) as scale·φ(gt)."""
    return _stream_plain(emb, w, labels, gt, loss_type=loss_type, margin=margin, scale=scale, k=k,
                         mask_svfc=mask_svfc, chunk=chunk)


def margin_partial_bwd_plain(emb, w, labels, gt, logz, kth, d_ce, d_neg, d_wl, *, loss_type,
                             margin, scale, k, mask_svfc, grad_w=True, chunk=32768, cos=None):
    """Plain PyTorch version of ``margin_partial_bwd`` (the scan twin
    ``sharded_margin.dense_local_bwd_scan``, plus ``d_wl``): (d_emb's
    streamed part [B, D] f32, the block's d_w [C, D] f32 or None, d_gt_raw
    [B]); ``d_wl`` rows added to the owned label rows of d_w. ``cos`` as in
    ``margin_ce_bwd_plain``."""
    c = w.shape[0]
    e_op = _operand(emb.float(), w)
    kw = dict(loss_type=loss_type, margin=margin, scale=scale, k=k, mask_svfc=mask_svfc)
    d_emb = torch.zeros_like(e_op)
    d_w = torch.empty((c, w.shape[1]), device=w.device) if grad_w else None
    for lo in range(0, c, chunk):
        hi = min(c, lo + chunk)
        cos_c, wn, wn_op, inv = _chunk_cos(e_op, w, lo, hi, cos)
        d_cos = _dcos(cos_c, torch.arange(lo, hi, device=w.device), labels, gt, logz, kth, d_ce,
                      d_neg, **kw)
        dc_op = _operand(d_cos, w)
        d_emb += dc_op @ wn_op
        if grad_w:
            d_w[lo:hi] = _rows_dw(dc_op, e_op, wn, inv)
    if grad_w:  # a scatter-add: two rows sharing a class both add
        own = labels >= 0
        d_w.index_add_(0, labels[own].long(), d_wl[own])
    return d_emb, d_w, _owned_target_dz(labels, gt, logz, d_ce, loss_type=loss_type,
                                        margin=margin, scale=scale)


def margin_ce_bwd_plain(emb, w, labels, gt, logz, topk, d_ce, d_neg, *, loss_type, margin, scale,
                        k, mask_svfc, grad_w=True, pos_rows=None, chunk=32768, cos=None):
    """Plain PyTorch version of ``margin_ce_bwd``: (d_emb [B, D], d_w
    [C, D] f32 or None with ``grad_w=False``), the target tail included.
    ``cos``: [B, C] f32 cosines to take in place of the recomputed ones;
    the checks on a card pass the kernels' own (``clean_cos``, which
    ``utils/parity.margin_cos_checks`` holds to the recomputed ones), so
    that both sides round the same d_cos to bf16 (that module's
    docstring)."""
    d_ce, d_neg = _mask_cotangents(_positive(labels, pos_rows), d_ce, d_neg)
    # the target tail (``pallas_margin_ce_bwd``'s XLA tail): d_gt into d_emb
    # and into the label rows of d_w
    emb_term, d_wl = _target_rows(emb, w, labels, gt, logz, d_ce, loss_type=loss_type,
                                  margin=margin, scale=scale)
    d_emb, d_w, _ = margin_partial_bwd_plain(
        emb, w, labels, gt, logz, topk[:, -1], d_ce, d_neg, d_wl, loss_type=loss_type,
        margin=margin, scale=scale, k=k, mask_svfc=mask_svfc, grad_w=grad_w, chunk=chunk, cos=cos)
    return (d_emb + emb_term).to(emb.dtype), d_w


def margin_ce_bwd_fused_sgd_plain(emb, w, mom, labels, gt, logz, topk, d_ce, d_neg, lr, *,
                                  momentum, nesterov, weight_decay, loss_type, margin, scale, k,
                                  mask_svfc, pos_rows=None, chunk=32768, cos=None):
    """Plain PyTorch version of ``margin_ce_bwd_fused_sgd``; updates ``w``
    and ``mom`` IN PLACE, chunk by chunk, each chunk's rows after its
    d_emb contribution is taken. Returns (d_emb, w, mom). ``cos`` (of the
    rows before the update) as in ``margin_ce_bwd_plain``."""
    c = w.shape[0]
    e_op = _operand(emb.float(), w)
    d_ce, d_neg = _mask_cotangents(_positive(labels, pos_rows), d_ce, d_neg)
    kth = topk[:, -1]
    emb_term, d_wl = _target_rows(emb, w, labels, gt, logz, d_ce, loss_type=loss_type,
                                  margin=margin, scale=scale)
    kw = dict(loss_type=loss_type, margin=margin, scale=scale, k=k, mask_svfc=mask_svfc)
    d_emb = torch.zeros_like(e_op)
    lab = labels.long()
    for lo in range(0, c, chunk):
        hi = min(c, lo + chunk)
        cos_c, wn, wn_op, inv = _chunk_cos(e_op, w, lo, hi, cos)
        d_cos = _dcos(cos_c, torch.arange(lo, hi, device=w.device), labels, gt, logz, kth, d_ce,
                      d_neg, **kw)
        dc_op = _operand(d_cos, w)
        d_emb += dc_op @ wn_op
        d_w = _rows_dw(dc_op, e_op, wn, inv)
        mine = (lab >= lo) & (lab < hi)  # target rows of this chunk: a sum per class
        d_w.index_add_(0, lab[mine] - lo, d_wl[mine])
        _sgd_rows(w[lo:hi], mom[lo:hi], d_w, lr, momentum=momentum, nesterov=nesterov,
                  weight_decay=weight_decay)
    return (d_emb + emb_term).to(emb.dtype), w, mom


# ----------------------------------------------------------------------
# sparse d_w: the forward's tile statistics → the selected tiles' rows
# ----------------------------------------------------------------------


def sparse_bwd_geometry(b: int, d: int, c: int, tile: int = 512) -> tuple[int, int]:
    """(tile, n_tiles) of the sparse backward, as the JAX package clamps
    them (``margin_pallas.sparse_bwd_geometry``), so callers size
    ``m_tiles`` (rate × n_tiles) as it does."""
    max_tile = max(256, int((11 * 2**20) // (16 * d + 24 * b)) // 128 * 128)
    tile = min(tile, max_tile)
    return tile, (c + tile - 1) // tile


def sparse_m_tiles(rate: float, n_tiles: int, b: int) -> int:
    """Route D's tile budget at ``pool.sparse_grad_rate`` = ``rate``
    (``softmax_head.py`` in the JAX package): targets are forced, so it
    holds at least one tile per batch row."""
    return min(n_tiles, max(int(round(rate * n_tiles)), b, 8))


def select_relevant_tiles(maxz, maxcos, logz, topk, labels, m_tiles: int, tile: int, u=None,
                          pos_rows=None):
    """The ``m_tiles`` class tiles whose d_w can matter this step, and the
    importance weight of each (``margin_pallas.select_relevant_tiles``).

    Score per tile: its softmax-mass bound max_row(maxz − logz), + 1e6 if
    it holds a top-k member of an outlier row, + 1e4 if its uniform draw
    ``u`` [n_tiles] is below RANDOM_FILL_FRAC·m/n_tiles (the random fill; no
    fill without ``u``), and 1e9 for every target tile. ``idx`` [M] int32
    are the M highest scores, equal scores in index order (``lax.top_k``'s
    order: a stable descending sort, since ``torch.topk`` promises none).
    Forced tiles (score ≥ 1e6) weigh 1; the others weigh their stratum's
    population over its selected count (above / below the −20 gate), at
    least 1, so the expected update matches the dense one. With
    block-local labels, ``pos_rows`` names the positive rows for the top-k
    test; only owned targets (label ≥ 0) are forced."""
    n_tiles = maxz.shape[0]
    pos = labels >= 0
    kth = topk[:, -1]
    rel = (maxz - logz[None, :]).amax(dim=1)
    outlier = ~_positive(labels, pos_rows)
    topk_hit = ((maxcos >= kth[None, :] - KTH_TIE_TOL) & (maxcos > 0.0) & outlier[None, :]).any(1)
    score = rel + torch.where(topk_hit, 1e6, 0.0)
    if u is not None:
        p = _f32(RANDOM_FILL_FRAC * m_tiles / max(n_tiles, 1))
        score = torch.where(u < p, score + 1e4, score)
    tgt_tiles = torch.where(pos, labels.long() // tile, 0)
    score = score.scatter_reduce(0, tgt_tiles, torch.where(pos, 1e9, -math.inf), "amax")
    idx = torch.sort(score, descending=True, stable=True).indices[:m_tiles]
    forced = score >= 1e6
    above = (rel > -20.0) & ~forced
    below = ~above & ~forced
    w_above = above.sum().float() / above[idx].sum().clamp(min=1).float()
    w_below = below.sum().float() / below[idx].sum().clamp(min=1).float()
    weight = torch.where(forced[idx], 1.0,
                         torch.where(above[idx], w_above.clamp(min=1.0), w_below.clamp(min=1.0)))
    return idx.to(torch.int32), weight


def _label_flat_pos(labels, tile_idx, tile):
    """(present [B], flat [B]): whether a row's label lies in a selected
    tile, and its row in the [M·tile] layout (the first selected tile that
    holds it, as ``_sparse_tail``'s argmax)."""
    safe = labels.clamp(min=0).long()
    match = tile_idx.long()[None, :] == (safe // tile)[:, None]
    present = match.any(dim=1) & (labels >= 0)
    return present, match.int().argmax(dim=1) * tile + safe % tile


def _sparse_parts_plain(emb, w, labels, gt, logz, topk, d_ce, d_neg, tile_idx, *, loss_type,
                        margin, scale, k, mask_svfc, tile, pos_rows=None, cos=None):
    """The plain sparse backward before its target term: (d_emb's streamed
    part [B, D] f32, d_w rows [M·tile, D] with the label rows' d_wl added,
    d_gt [B]: the target column's dz where its tile is selected, else 0).
    ``cos`` [B, C] as in ``margin_ce_bwd_plain``."""
    c = w.shape[0]
    e_op = _operand(emb.float(), w)
    d_ce, d_neg = _mask_cotangents(_positive(labels, pos_rows), d_ce, d_neg)
    col = (tile_idx.long()[:, None] * tile
           + torch.arange(tile, device=w.device)[None, :]).reshape(-1)
    valid = (col >= 0) & (col < c)  # rows past C, or of a tile index out of range, are zero
    w_sel = torch.where(valid[:, None], w[col.clamp(0, c - 1)], 0)
    wn, wn_op, inv = _form_rows(w_sel)
    cos = e_op @ wn_op.T if cos is None else cos[:, col.clamp(0, c - 1)]
    d_cos = _dcos(cos, col, labels, gt, logz, topk[:, -1], d_ce, d_neg, loss_type=loss_type,
                  margin=margin, scale=scale, k=k, mask_svfc=mask_svfc, valid=valid)
    dc_op = _operand(d_cos, w)
    d_w_rows = _rows_dw(dc_op, e_op, wn, inv)
    present, flat = _label_flat_pos(labels, tile_idx, tile)
    d_gt = torch.where(present, _target_dz(gt, logz, d_ce, loss_type=loss_type, margin=margin,
                                           scale=scale), 0.0)
    _, d_wl = _label_rows_grad(emb, w, labels, d_gt * phi_prime(gt, loss_type, margin))
    d_w_rows.index_add_(0, flat[present], d_wl[present])
    return dc_op @ wn_op, d_w_rows, d_gt


def _with_target_term(d_emb, emb, w, labels, gt, d_gt, loss_type, margin):
    """d_emb plus the target column's term, φ′(gt)·d_gt through the label
    rows (``_sparse_tail``'s d_emb_extra)."""
    term, _ = _label_rows_grad(emb, w, labels, d_gt * phi_prime(gt, loss_type, margin))
    return (d_emb + term).to(emb.dtype)


def margin_ce_bwd_sparse_plain(emb, w, labels, gt, logz, topk, d_ce, d_neg, tile_idx, *,
                               loss_type, margin, scale, k, mask_svfc, tile, pos_rows=None,
                               cos=None):
    """Plain PyTorch version of ``margin_ce_bwd_sparse`` (the gather
    reference ``_sparse_bwd_gather`` and ``_sparse_tail``): one pass over
    the gathered columns of the selected tiles. Returns (d_emb [B, D]
    truncated to those tiles, d_w rows [M·tile, D] in ``tile_idx`` order;
    the label rows' target gradient added, rows past C zero). ``cos`` [B, C]
    as in ``margin_ce_bwd_plain``."""
    d_emb, d_w_rows, d_gt = _sparse_parts_plain(
        emb, w, labels, gt, logz, topk, d_ce, d_neg, tile_idx, loss_type=loss_type, margin=margin,
        scale=scale, k=k, mask_svfc=mask_svfc, tile=tile, pos_rows=pos_rows, cos=cos)
    return _with_target_term(d_emb, emb, w, labels, gt, d_gt, loss_type, margin), d_w_rows


# ----------------------------------------------------------------------
# the CUDA kernels (csrc/margin_ce.cu)
# ----------------------------------------------------------------------

_LOSS_CODE = {"AM": 0, "Arc": 1, "SV": 2}
_F_TC = 128  # columns per forward tile
_F_LANES = 2  # forward lanes a row: lane l streams columns [64 l, 64 l + 64) of each tile
_F_NST, _F_FK = 3, 32  # the forward's stages; an f32 stage's features (64 for bf16)
_B_TC = 64  # columns per backward tile
_B_RB = 64  # rows per d_emb block (row group): a bf16 classifier, or f32 above _ROWS
_STAT_COLS = 64  # columns per forward statistics partial (half an _F_TC tile)
_ROWS = 128  # batch rows a forward block holds (a row group); the f32 backward's one pass
# the cosines as each pass forms them (``clean_cos``; csrc/margin_ce.cu): the
# d_w pass is one kernel for every bf16 backward form (dense, sparse, fused);
# an f32 classifier's backward is one pass, whichever of the last two is named,
# up to 128 batch rows (above, its d_emb pass and its pass in row groups)
COS_TILINGS = ("forward", "d_emb pass", "d_w pass")
_P = ctypes.c_void_p
_COMMON_ARGTYPES = [
    _P, _P, _P, ctypes.c_int, _P,  # emb (bf16 form: rounded), emb as bf16, w, w is bf16, 1/||w||
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int,  # C, D, B
    _P, _P, ctypes.c_int, ctypes.c_int,  # labels, gt, k, loss
    ctypes.c_float, ctypes.c_float, ctypes.c_float,  # margin, scale, svfc
    ctypes.c_float, ctypes.c_float,  # cos(margin), sin(margin)
]
_BWD_ARGTYPES = _COMMON_ARGTYPES + [
    _P, _P, _P, _P,  # logz, kth, dce, dneg [B]
    _P, ctypes.c_int, ctypes.c_longlong, _P,  # d_emb part, nchunk, cols_per_chunk, d_emb
    ctypes.c_int, ctypes.c_longlong,  # d_w blocks, cols per d_w block
]


def _lib():
    from vlsfr_tpu_torch.ops.cuda_build import load_library

    lib = load_library("margin_ce")
    if not getattr(lib, "_vlsfr_typed", False):
        lib.margin_ce_fwd_launch.argtypes = _COMMON_ARGTYPES + [
            _P, ctypes.c_int, ctypes.c_longlong,  # part, nblk, cols_per_blk
            _P, _P, _P, _P,  # ce, neg, logz, topk
            _P, ctypes.c_int, _P, _P,  # stats scratch (or None), stats tile, maxz, maxcos
            _P]  # stream
        lib.margin_ce_bwd_launch.argtypes = _BWD_ARGTYPES + [_P, _P, _P]  # d_w, d_wl, stream
        lib.margin_ce_bwd_fused_sgd_launch.argtypes = _BWD_ARGTYPES + [
            _P, _P, ctypes.c_int, _P,  # w (updated in place), mom (in place), mom is bf16, d_wl
            ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_float,  # lr, mu, nesterov, wd
            _P]  # stream
        lib.margin_ce_bwd_sparse_launch.argtypes = _BWD_ARGTYPES + [
            _P, ctypes.c_int, ctypes.c_longlong,  # tile_idx, tile, M * tile
            _P, _P, _P, _P]  # d_w rows, d_wl, d_gt, stream
        lib.margin_partial_fwd_launch.argtypes = _COMMON_ARGTYPES + [
            _P, ctypes.c_int, ctypes.c_longlong,  # part, nblk, cols_per_blk
            _P, _P, _P, _P]  # m, s, topk, stream
        lib.margin_partial_bwd_launch.argtypes = _BWD_ARGTYPES + [_P, _P, _P]  # d_w, d_wl, stream
        lib.margin_ce_clean_cos_launch.argtypes = _COMMON_ARGTYPES + [ctypes.c_int, _P, _P]
        lib.margin_fwd_smem.argtypes = [ctypes.c_int]
        for fn in (lib.margin_ce_fwd_launch, lib.margin_ce_bwd_launch,
                   lib.margin_ce_bwd_fused_sgd_launch, lib.margin_ce_bwd_sparse_launch,
                   lib.margin_partial_fwd_launch, lib.margin_partial_bwd_launch,
                   lib.margin_ce_clean_cos_launch, lib.margin_fwd_smem):
            fn.restype = ctypes.c_int
        lib.margin_ce_error_string.argtypes = [ctypes.c_int]
        lib.margin_ce_error_string.restype = ctypes.c_char_p
        lib._vlsfr_typed = True
    return lib


def _check_launch(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           f"{lib.margin_ce_error_string(err).decode()} (cudaError {err})")


def _check_inputs(emb, w, labels, gt, k, loss_type, extra=()):
    """Device, dtype, shape and contiguity of the kernels' inputs; raises on
    what the kernels do not take. ``w`` is float32 or bfloat16."""
    if loss_type not in LOSS_TYPES:
        raise ValueError(f"loss_type must be AM | Arc | SV, got {loss_type!r}")
    if w.dtype not in W_DTYPES:
        raise ValueError(f"the classifier must be float32 or bfloat16, got {w.dtype}")
    b, d = emb.shape
    if w.dim() != 2 or w.shape[1] != d:
        raise ValueError(f"w must be [C, {d}], got {tuple(w.shape)}")
    if not 1 <= k <= KMAX:
        raise ValueError(f"hard_neg k={k} outside [1, {KMAX}]")
    for name, t, dt, shape in (
            ("emb", emb, torch.float32, (b, d)), ("labels", labels, torch.int32, (b,)),
            ("gt", gt, torch.float32, (b,)), *extra):
        if t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {dt} {shape}, got {t.dtype} {tuple(t.shape)}")
    for name, t in (("w", w), ("labels", labels), ("gt", gt), *((e[0], e[1]) for e in extra)):
        if t.device != emb.device:
            raise ValueError(f"{name} is on {t.device}, emb on {emb.device}")
        if emb.is_cuda and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if emb.is_cuda and not emb.is_contiguous():
        raise ValueError("emb must be contiguous")
    if emb.is_cuda and not kernel_width_ok(d):
        raise ValueError(f"the margin_ce kernels take a feature width that is a multiple of 64 "
                         f"up to 512; got D={d}")


def _form_scratch(emb, w, ncols):
    """(the embedding the kernels read, that embedding stored as bf16 or
    None, the [ncols] 1/‖w‖ scratch or None): against a bf16 classifier
    the embedding rounded to bf16 (held in f32, and as bf16 for the tensor
    cores) and the scratch the kernels fill with 1/‖w‖ per logical
    column."""
    if w.dtype != torch.bfloat16:
        return emb, None, None
    eb = emb.to(torch.bfloat16).contiguous()
    return eb.float(), eb, torch.empty((ncols,), device=emb.device)


def _common_args(e_op, eb, w, inv, labels, gt, *, k, loss_type, margin, scale, mask_svfc):
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    return (e_op.data_ptr(), ptr(eb), w.data_ptr(), int(w.dtype == torch.bfloat16), ptr(inv),
            w.shape[0], e_op.shape[1], e_op.shape[0], labels.data_ptr(), gt.data_ptr(), k,
            _LOSS_CODE[loss_type], margin, scale, mask_svfc, _f32(math.cos(margin)),
            _f32(math.sin(margin)))


def _split_columns(c, tile, n_parts):
    """(parts, columns per part): a tile-multiple split of [0, C)."""
    tiles = -(-c // tile)
    per = -(-tiles // max(min(n_parts, tiles), 1)) * tile
    return -(-c // per), per


def _sms(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


class FwdGeometry(NamedTuple):
    """The forward kernel's launch (``fwd_geometry``)."""

    nblk: int  # column ranges, each of cols_per_blk columns (the last may hold fewer)
    cols_per_blk: int  # a multiple of the 128-column tile
    n_parts: int  # partials a row: one per lane of each range, merged in this order
    smem: int  # bytes of shared memory a block (csrc/margin_ce.cu: fwd_smem)
    n_rg: int  # row groups of 128 rows: the blocks of a column range


def fwd_geometry(w_bf16: bool, c: int, sms: int, b: int = _ROWS) -> FwdGeometry:
    """The forward kernel's grid over C classifier columns and B batch
    rows on a card of ``sms`` SMs: one block an SM, each a row group of
    128 rows (every row up to B = 128) over a range of whole 128-column
    tiles, the ranges covering [0, C) in order and the row groups of a
    range adjacent in launch order; two lanes a row, each writing its own
    (m, s, top-k) partial. Shared memory: three stages of emb's 128 rows
    and a W tile's 128 rows, 32 features a stage at a row stride of 36
    floats (f32 W) or 64 bf16 features (bf16 W), the f32 cosine tile
    [128, 132] and the tile's 1/‖w‖."""
    n_rg = -(-b // _ROWS)
    nblk, per = _split_columns(c, _F_TC, max(sms // n_rg, 1))
    stage = (_ROWS + _F_TC) * (64 * 2 if w_bf16 else 4 * (_F_FK + 4))
    return FwdGeometry(nblk, per, _F_LANES * nblk,
                       _F_NST * stage + 4 * (_ROWS * (_F_TC + 4) + _F_TC), n_rg)


def margin_ce_fwd(emb, w, labels, gt, *, loss_type, margin, scale, k, mask_svfc,
                  with_stats=False, tile=512):
    """Streaming forward: (ce [B], neg [B], logz [B], topk [B, k]), and with
    ``with_stats`` also (maxz, maxcos) [ceil(C / tile), B], the per-tile row
    maxima that feed ``select_relevant_tiles``.

    Replaces ``vlsfr_tpu/ops/margin_pallas.py:pallas_margin_ce_fwd``. Bound
    on an H100 at the slice shapes (B = 128, D = 512, C = 2^20): 2·B·D·C =
    1.37e11 FLOP of f32 dot products (~2.05 ms at 67 TFLOP/s) against
    2.15 GB of W (~0.64 ms at 3.35 TB/s): compute-bound. Design
    (csrc/margin_ce.cu: ``margin_fwd_kernel``; grid ``fwd_geometry``): one
    block an SM streams a range of 128-column tiles with every batch row,
    so each W tile is read once. The f32 product runs on the CUDA cores in
    f32 FMA, emb's rows and the W tile staged 32 features a chunk by
    cp.async, two chunks in flight, an 8 × 8 micro-tile a thread read by
    float4 loads; each cosine is one fmaf chain over the features in
    order, the f32 backward's. Each row's stream is split over two lanes,
    64 columns of each tile a lane: two base-2 (max, sumexp) chains and a
    select-network top-k in registers a lane, each lane's partial merged
    with the others in a fixed order by a second launch; a tile's row pass
    runs under the next tile's first copies. The statistics are
    per-64-column maxima (target column included), one lane's half tile,
    taken by the same pass, reduced to ``tile`` columns (a multiple of 64)
    by a third launch; without ``with_stats`` none of that runs. The bf16
    form (bf16 ``w``): the cosine tile on the tensor cores, the same row
    pass; the dots at 989 TFLOP/s (0.14 ms) against 1.07 GB of W (0.32
    ms): bytes-bound; a first launch writes 1/‖w‖ per column (module
    docstring).
    """
    _check_inputs(emb, w, labels, gt, k, loss_type)
    if not emb.is_cuda:
        return margin_ce_fwd_plain(emb, w, labels, gt, loss_type=loss_type, margin=margin,
                                   scale=scale, k=k, mask_svfc=mask_svfc, with_stats=with_stats,
                                   tile=tile)
    if with_stats and tile % _STAT_COLS:
        raise ValueError(f"the stats tile must be a multiple of {_STAT_COLS}, got {tile}")
    lib = _lib()
    b, dev = emb.shape[0], emb.device
    c = w.shape[0]
    e_op, eb, inv = _form_scratch(emb, w, c)
    geo = fwd_geometry(w.dtype == torch.bfloat16, c, _sms(dev), b)
    part = torch.empty((geo.n_parts, b, 2 + KMAX), device=dev)
    ce, neg, logz = (torch.empty((b,), device=dev) for _ in range(3))
    topk = torch.empty((b, k), device=dev)
    stats, stat_ptrs = [], [None, None, None]  # scratch, maxz, maxcos
    if with_stats:
        stats = [torch.empty((2, -(-c // _STAT_COLS), b), device=dev),
                 *(torch.empty((-(-c // tile), b), device=dev) for _ in range(2))]
        stat_ptrs = [s.data_ptr() for s in stats]
    err = lib.margin_ce_fwd_launch(
        *_common_args(e_op, eb, w, inv, labels, gt, k=k, loss_type=loss_type, margin=margin,
                      scale=scale, mask_svfc=mask_svfc),
        part.data_ptr(), geo.nblk, geo.cols_per_blk, ce.data_ptr(), neg.data_ptr(),
        logz.data_ptr(), topk.data_ptr(), stat_ptrs[0], tile, *stat_ptrs[1:],
        torch.cuda.current_stream(dev).cuda_stream)
    _check_launch(lib, err, "margin_ce_fwd")
    _count_launch("margin_ce_fwd", w)
    return (ce, neg, logz, topk, *stats[1:])


def margin_partial_fwd(emb, w, labels, gt, *, loss_type, margin, scale, k, mask_svfc):
    """One class block's raw online-softmax state against the global target
    cosines ``gt``: (m [B], s [B], topk [B, k]), logsumexp = m + log s over
    the block's columns, the owned target column (label ≥ 0) in it as
    scale·φ(gt), and the top-k of the block's non-target cosines. Labels
    are block-local (−1 outlier, −2 a target another block owns).

    Replaces ``vlsfr_tpu/ops/margin_pallas.py:pallas_margin_partial_fwd``.
    Bound on an H100 at B = 128, D = 512 over a block of C_l columns:
    2·B·D·C_l FLOP (2^20: 1.37e11, ~2.05 ms at the f32 rate) against
    4·C_l·D bytes of W (2.15 GB, ~0.64 ms): compute-bound. Design:
    ``margin_ce_fwd``'s block pass (each block a column range with every
    batch row resident, a (max, sumexp, top-k) partial a lane) and a
    merge launch that folds the partials in a fixed order, then the owned
    target term, and writes the raw state instead of finalizing it: the
    blocks' states merge across ranks (``parallel/_shard_common.py``)."""
    _check_inputs(emb, w, labels, gt, k, loss_type)
    kw = dict(loss_type=loss_type, margin=margin, scale=scale, k=k, mask_svfc=mask_svfc)
    if not emb.is_cuda:
        return margin_partial_fwd_plain(emb, w, labels, gt, **kw)
    lib = _lib()
    b, dev = emb.shape[0], emb.device
    e_op, eb, inv = _form_scratch(emb, w, w.shape[0])
    geo = fwd_geometry(w.dtype == torch.bfloat16, w.shape[0], _sms(dev), b)
    part = torch.empty((geo.n_parts, b, 2 + KMAX), device=dev)
    m, s = (torch.empty((b,), device=dev) for _ in range(2))
    topk = torch.empty((b, k), device=dev)
    err = lib.margin_partial_fwd_launch(
        *_common_args(e_op, eb, w, inv, labels, gt, **kw), part.data_ptr(), geo.nblk,
        geo.cols_per_blk, m.data_ptr(), s.data_ptr(), topk.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _check_launch(lib, err, "margin_partial_fwd")
    _count_launch("margin_partial_fwd", w)
    return m, s, topk


def bwd_geometry(w_bf16: bool, b: int, ncols: int, sms: int) -> tuple[int, int, int, int]:
    """(nchunk, cols per chunk, column-owning blocks, cols per such block)
    of the backward over ``ncols`` columns and B batch rows on a card of
    ``sms`` SMs. Every pass runs one block an SM (its shared memory): an
    f32 classifier's one pass up to B = 128, each block writing its d_emb
    partial; a bf16 classifier's d_w pass, each block staging emb once for
    all of its tiles (the sparse form's 1,024 tiles at 65,536 rows: 8 a
    block), and its d_emb pass, each block a row group of 64 rows over a
    column chunk; above 128 rows an f32 classifier's d_emb pass and its
    pass in row groups for d_w alike."""
    nblk, per_w = _split_columns(ncols, _B_TC, sms)
    if not w_bf16 and b <= _ROWS:
        return nblk, per_w, nblk, per_w
    nchunk, per = _split_columns(ncols, _B_TC, max(sms // -(-b // _B_RB), 1))
    return nchunk, per, nblk, per_w


def _bwd_geometry(emb, w, ncols):
    """``bwd_geometry``'s launch, with the d_emb partial buffer [nchunk,
    B, D] first."""
    b, d = emb.shape
    nchunk, per, nblk, per_w = bwd_geometry(w.dtype == torch.bfloat16, b, ncols,
                                            _sms(emb.device))
    return torch.empty((nchunk, b, d), device=emb.device), nchunk, per, nblk, per_w


def _bwd_extra(logz, topk, b, k):
    return (("logz", logz, torch.float32, (b,)), ("topk", topk, torch.float32, (b, k)))


def _launch_bwd(name, emb, w, labels, gt, logz, kth, d_ce, d_neg, d_wl, grad_w, kw):
    """One launch of the two-pass backward entry ``<name>_launch`` over all
    of w's columns, cotangents masked: (d_emb's streamed part [B, D], d_w
    [C, D] with ``d_wl`` added to the label rows, or None)."""
    lib = _lib()
    dev = emb.device
    e_op, eb, inv = _form_scratch(emb, w, w.shape[0])
    part, nchunk, per, nblk, per_w = _bwd_geometry(emb, w, w.shape[0])
    d_emb = torch.empty_like(emb)
    d_w = torch.empty(w.shape, device=dev) if grad_w else None
    err = getattr(lib, f"{name}_launch")(
        *_common_args(e_op, eb, w, inv, labels, gt, **kw), logz.data_ptr(), kth.data_ptr(),
        d_ce.data_ptr(), d_neg.data_ptr(), part.data_ptr(), nchunk, per, d_emb.data_ptr(), nblk,
        per_w, d_w.data_ptr() if grad_w else None, d_wl.data_ptr() if grad_w else None,
        torch.cuda.current_stream(dev).cuda_stream)
    _check_launch(lib, err, name)
    _count_launch(name, w)
    return d_emb, d_w


def margin_ce_bwd(emb, w, labels, gt, logz, topk, d_ce, d_neg, *, loss_type, margin, scale, k,
                  mask_svfc, grad_w=True, pos_rows=None):
    """Streaming backward: re-streams W and returns (d_emb [B, D], d_w
    [C, D] f32, or None with ``grad_w=False``), the target tail included.
    ``pos_rows``: the positive rows where the labels are block-local.

    Replaces ``vlsfr_tpu/ops/margin_pallas.py:pallas_margin_ce_bwd``. Bound
    on an H100 at the slice shapes with ``grad_w``: three products (cosine
    recompute, d_cos @ ŵ, d_cosᵀ @ emb) = 4.12e11 FLOP (~6.15 ms at the f32
    rate) against W read + d_w written = 4.3 GB (~1.28 ms): compute-bound.
    Design, IEEE f32 FMA on the CUDA cores, register-blocked (``ftile_dots``
    in ``csrc/margin_common.cuh``: cp.async staging, a micro-tile a thread,
    every cosine the forward's in-order chain): one pass of the three
    products, a block (one an SM) owning 64-column tiles with every batch
    row: each W tile is staged once and serves the cosines, the d_w
    epilogue and d_emb += (d_cos·inv)·W; d_ŵ = d_cosᵀ·emb streams emb
    through shared memory; each d_w row is written once by its owner, which
    adds the label rows' d_wl (computed here before the launch) in batch
    order; each block's d_emb partial lives in L2 and a merge launch sums
    them in a fixed order. No float atomics: d_emb and d_w are bit-stable
    run to run. The bf16 form: W read (1.07 GB) + f32 d_w written (2.15 GB),
    0.96 ms, against 0.42 ms of bf16 dots: bytes-bound. Its passes run on
    the tensor cores: the d_w pass first (emb resident, one 64-column W
    tile at a time scaled once into bf16(ŵ), 1/‖w‖ from the staged rows,
    d_ŵ [64, D] in mma accumulators, ⟨d_ŵ, ŵ⟩ from the finished row; one
    kernel for every bf16 form, the sparse and fused ones too), then the
    d_emb pass (64 rows a block, two W tiles in flight; with
    ``grad_w=False`` it computes 1/‖w‖ from its own tiles).
    """
    _check_inputs(emb, w, labels, gt, k, loss_type, extra=_bwd_extra(logz, topk, emb.shape[0], k))
    kw = dict(loss_type=loss_type, margin=margin, scale=scale, k=k, mask_svfc=mask_svfc)
    if not emb.is_cuda:
        return margin_ce_bwd_plain(emb, w, labels, gt, logz, topk, d_ce, d_neg, grad_w=grad_w,
                                   pos_rows=pos_rows, **kw)
    d_ce_m, d_neg_m = _mask_cotangents(_positive(labels, pos_rows), d_ce, d_neg)
    emb_term, d_wl = _target_rows(emb, w, labels, gt, logz, d_ce_m, loss_type=loss_type,
                                  margin=margin, scale=scale)
    d_emb, d_w = _launch_bwd("margin_ce_bwd", emb, w, labels, gt, logz, topk[:, -1].contiguous(),
                             d_ce_m, d_neg_m, d_wl.contiguous(), grad_w, kw)
    return (d_emb + emb_term).to(emb.dtype), d_w


def margin_partial_bwd(emb, w, labels, gt, logz, kth, d_ce, d_neg, d_wl, *, loss_type, margin,
                       scale, k, mask_svfc, grad_w=True):
    """One class block's streaming backward against the global ``gt``,
    ``logz`` and ``kth`` [B], with cotangents that arrive masked by the
    global positive rows: (d_emb's streamed part over the block [B, D] f32,
    the block's d_w [C_l, D] f32 or None with ``grad_w=False``, d_gt_raw
    [B] = the target column's dz on the rows whose target the block owns,
    else 0). The caller routes d_gt through the label rows: ``d_wl`` [B, D],
    the owner's label-row gradient (0 on rows it does not own), is added to
    the owned label rows of d_w by their owner, in batch order, and the
    d_emb term is the caller's.

    Replaces ``vlsfr_tpu/ops/margin_pallas.py:pallas_margin_partial_bwd``.
    Bound on an H100 at B = 128, D = 512 with ``grad_w``: three products,
    6·B·D·C_l FLOP (2^20: 4.12e11, ~6.15 ms at the f32 rate) against W read
    + d_w written, 8·C_l·D bytes (4.3 GB, ~1.28 ms): compute-bound. Design:
    ``margin_ce_bwd``'s kernels (column-owned d_w rows written once, d_emb
    partials summed in a fixed order) on the block; the target column's dz
    is B-row torch work beside it, as the single-device tail is. The bf16
    form is ``margin_ce_bwd``'s tensor-core passes."""
    b = emb.shape[0]
    vec = lambda name, t: (name, t, torch.float32, (b,))  # noqa: E731
    extra = [vec("logz", logz), vec("kth", kth), vec("d_ce", d_ce), vec("d_neg", d_neg),
             ("d_wl", d_wl, torch.float32, tuple(emb.shape))]
    _check_inputs(emb, w, labels, gt, k, loss_type, extra=extra)
    kw = dict(loss_type=loss_type, margin=margin, scale=scale, k=k, mask_svfc=mask_svfc)
    if not emb.is_cuda:
        return margin_partial_bwd_plain(emb, w, labels, gt, logz, kth, d_ce, d_neg, d_wl,
                                        grad_w=grad_w, **kw)
    d_emb, d_w = _launch_bwd("margin_partial_bwd", emb, w, labels, gt, logz, kth, d_ce, d_neg,
                             d_wl, grad_w, kw)
    return d_emb, d_w, _owned_target_dz(labels, gt, logz, d_ce, loss_type=loss_type,
                                        margin=margin, scale=scale)


def margin_ce_bwd_fused_sgd(emb, w, mom, labels, gt, logz, topk, d_ce, d_neg, lr, *, momentum,
                            nesterov, weight_decay, loss_type, margin, scale, k, mask_svfc,
                            pos_rows=None):
    """Streaming backward with the classifier's SGD-momentum update fused
    in: returns (d_emb [B, D], w, mom), where ``w`` and ``mom`` are updated
    IN PLACE to exactly what optax's wd → trace(μ, nesterov) → (−lr) chain
    makes of the dense d_w. The dense d_w never exists in device memory.
    ``pos_rows`` (one block of a class-sharded classifier, labels
    block-local): the global positive rows, whose softmax gradient exists
    on every block; the target tail stays on the owner (label ≥ 0).

    Replaces ``vlsfr_tpu/ops/margin_pallas.py:pallas_margin_ce_bwd_fused_sgd``.
    Bound on an H100 at the slice shapes: 4.12e11 FLOP (~6.15 ms at the f32
    rate) against W and mom read and written = 8.6 GB (~2.56 ms):
    compute-bound. The target tail (d_gt, the label rows' gradient d_wl) is
    computed here from the PRE-update rows before the launch. Each block
    owns its W and mom rows and reads them before it writes them; no other
    block touches them (f32 W: the one pass takes d_emb from its staged
    copy of the tile; bf16 W: the d_emb pass reads W before the
    column-owned pass overwrites it, in stream order). Two batch rows with one
    class both add their d_wl into that row, in batch order. ``w`` and
    ``mom`` are each f32 or bf16; the bf16 classifier's forms are bytes-bound
    (W and mom read and written: 4.29 GB at (bf16, bf16), 1.28 ms; 6.44 GB
    at (bf16, f32), 1.92 ms), and run margin_ce_bwd's two tensor-core
    passes, the d_w pass with the update as its epilogue and after the
    d_emb pass; an f32 classifier beside a bf16 momentum is the f32 form,
    6.15 ms of f32 products.
    """
    if mom.dtype not in W_DTYPES:
        raise ValueError(f"the momentum must be float32 or bfloat16, got {mom.dtype}")
    _check_inputs(emb, w, labels, gt, k, loss_type,
                  extra=(*_bwd_extra(logz, topk, emb.shape[0], k),
                         ("mom", mom, mom.dtype, tuple(w.shape))))
    if not emb.is_cuda:
        return margin_ce_bwd_fused_sgd_plain(
            emb, w, mom, labels, gt, logz, topk, d_ce, d_neg, lr, momentum=momentum,
            nesterov=nesterov, weight_decay=weight_decay, loss_type=loss_type, margin=margin,
            scale=scale, k=k, mask_svfc=mask_svfc, pos_rows=pos_rows)
    d_ce_m, d_neg_m = _mask_cotangents(_positive(labels, pos_rows), d_ce, d_neg)
    kth = topk[:, -1].contiguous()
    lib = _lib()
    dev = emb.device
    emb_term, d_wl = _target_rows(emb, w, labels, gt, logz, d_ce_m, loss_type=loss_type,
                                  margin=margin, scale=scale)
    d_wl = d_wl.contiguous()
    e_op, eb, inv = _form_scratch(emb, w, w.shape[0])
    part, nchunk, per, nblk, per_w = _bwd_geometry(emb, w, w.shape[0])
    d_emb = torch.empty_like(emb)
    err = lib.margin_ce_bwd_fused_sgd_launch(
        *_common_args(e_op, eb, w, inv, labels, gt, k=k, loss_type=loss_type, margin=margin,
                      scale=scale, mask_svfc=mask_svfc),
        logz.data_ptr(), kth.data_ptr(), d_ce_m.data_ptr(), d_neg_m.data_ptr(),
        part.data_ptr(), nchunk, per, d_emb.data_ptr(), nblk, per_w,
        w.data_ptr(), mom.data_ptr(), int(mom.dtype == torch.bfloat16), d_wl.data_ptr(),
        float(lr), float(momentum),
        int(bool(nesterov and momentum)), float(weight_decay),
        torch.cuda.current_stream(dev).cuda_stream)
    _check_launch(lib, err, "margin_ce_bwd_fused_sgd")
    _count_launch("margin_ce_bwd_fused_sgd", w, mom)
    return (d_emb + emb_term).to(emb.dtype), w, mom


def margin_ce_bwd_sparse(emb, w, labels, gt, logz, topk, d_ce, d_neg, tile_idx, *, loss_type,
                         margin, scale, k, mask_svfc, tile, pos_rows=None):
    """Backward over the M selected class tiles only: (d_emb [B, D] summed
    over those tiles, d_w rows [M·tile, D] f32 in ``tile_idx`` order), the
    label rows' target gradient added to the rows of the selected tiles that
    hold them, rows past C zero. ``tile_idx`` [M] int32 holds distinct tile
    indices; a tile index outside [0, ceil(C / tile)) gives zero rows.
    ``pos_rows``: the positive rows where the labels are block-local.

    Replaces ``vlsfr_tpu/ops/margin_pallas.py:pallas_margin_ce_bwd_sparse``.
    Bound on an H100 at the route-D shapes (B = 128, D = 512, M·tile =
    65,536): three products 2.58e10 FLOP (~0.385 ms at the f32 rate)
    against 134 MB of W tiles read and 134 MB of d_w rows written
    (~0.080 ms): compute-bound. Design: margin_ce_bwd's kernels run over
    the M·tile logical columns, each 64-column tile mapped through
    ``tile_idx`` (read by every block, the counterpart of scalar prefetch)
    onto its class rows; the column owner writes each d_w row once (adding
    the label rows' d_wl in batch order) and d_gt, the target column's dz,
    for the rows whose target it owns; d_emb partials are summed in a fixed
    order. No float atomics. The bf16 form: the tensor-core passes of
    margin_ce_bwd over the logical columns (W tiles read, 0.067 GB, and f32
    d_w rows written, 0.134 GB: 0.060 ms, bytes-bound).
    """
    m = tile_idx.shape[0]
    _check_inputs(emb, w, labels, gt, k, loss_type,
                  extra=(*_bwd_extra(logz, topk, emb.shape[0], k),
                         ("tile_idx", tile_idx, torch.int32, (m,))))
    kw = dict(loss_type=loss_type, margin=margin, scale=scale, k=k, mask_svfc=mask_svfc,
              tile=tile, pos_rows=pos_rows)
    parts = _sparse_parts_cuda if emb.is_cuda else _sparse_parts_plain
    d_emb, d_w_rows, d_gt = parts(emb, w, labels, gt, logz, topk, d_ce, d_neg, tile_idx, **kw)
    return _with_target_term(d_emb, emb, w, labels, gt, d_gt, loss_type, margin), d_w_rows


def _sparse_parts_cuda(emb, w, labels, gt, logz, topk, d_ce, d_neg, tile_idx, *, loss_type,
                       margin, scale, k, mask_svfc, tile, pos_rows=None):
    """``_sparse_parts_plain``'s outputs from the kernel."""
    if tile % _B_TC:
        raise ValueError(f"the sparse backward's tile must be a multiple of {_B_TC}, got {tile}")
    m = tile_idx.shape[0]
    d_ce_m, d_neg_m = _mask_cotangents(_positive(labels, pos_rows), d_ce, d_neg)
    kth = topk[:, -1].contiguous()
    lib = _lib()
    dev = emb.device
    _, d_wl = _target_rows(emb, w, labels, gt, logz, d_ce_m, loss_type=loss_type, margin=margin,
                           scale=scale)
    d_wl = d_wl.contiguous()
    e_op, eb, inv = _form_scratch(emb, w, m * tile)
    part, nchunk, per, nblk, per_w = _bwd_geometry(emb, w, m * tile)
    d_emb = torch.empty_like(emb)
    d_w_rows = torch.empty((m * tile, emb.shape[1]), device=dev)
    d_gt = torch.zeros_like(gt)  # rows whose target tile is not selected keep 0
    err = lib.margin_ce_bwd_sparse_launch(
        *_common_args(e_op, eb, w, inv, labels, gt, k=k, loss_type=loss_type, margin=margin,
                      scale=scale, mask_svfc=mask_svfc),
        logz.data_ptr(), kth.data_ptr(), d_ce_m.data_ptr(), d_neg_m.data_ptr(),
        part.data_ptr(), nchunk, per, d_emb.data_ptr(), nblk, per_w,
        tile_idx.data_ptr(), tile, m * tile, d_w_rows.data_ptr(), d_wl.data_ptr(),
        d_gt.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _check_launch(lib, err, "margin_ce_bwd_sparse")
    _count_launch("margin_ce_bwd_sparse", w)
    return d_emb, d_w_rows, d_gt


def clean_cos(emb, w, *, tiling: str = "forward"):
    """[B, C] cosines of the embedding against the classifier's normalised
    rows as the kernels' tiles form them (every column, no labels read):
    ``tiling`` one of COS_TILINGS — the forward, the d_emb pass, the d_w
    pass of every bf16 backward form (an f32 classifier's backward is one
    pass: the last two are its tiling). A
    parity probe of the one chain they share: the backward's top-k test
    compares its cosines with the forward's kth. No training path calls
    it. CPU tensors: the plain version, emb · ŵᵀ (bf16 classifier:
    bf16(emb) · bf16(ŵ)ᵀ summed in f32)."""
    if tiling not in COS_TILINGS:
        raise ValueError(f"tiling must be one of {COS_TILINGS}, got {tiling!r}")
    b = emb.shape[0]
    labels = torch.zeros((b,), dtype=torch.int32, device=emb.device)
    gt = torch.zeros((b,), device=emb.device)
    _check_inputs(emb, w, labels, gt, 1, "Arc")
    if not emb.is_cuda:
        return _chunk_cos(_operand(emb.float(), w), w, 0, w.shape[0])[0]
    lib = _lib()
    e_op, eb, inv = _form_scratch(emb, w, w.shape[0])
    out = torch.empty((b, w.shape[0]), device=emb.device)
    err = lib.margin_ce_clean_cos_launch(
        *_common_args(e_op, eb, w, inv, labels, gt, k=1, loss_type="Arc", margin=0.5, scale=1.0,
                      mask_svfc=1.0),
        COS_TILINGS.index(tiling), out.data_ptr(), torch.cuda.current_stream(emb.device).cuda_stream)
    _check_launch(lib, err, "margin_ce_clean_cos")
    return out


# ----------------------------------------------------------------------
# autograd and the loss entry points
# ----------------------------------------------------------------------


class MarginSoftmax(torch.autograd.Function):
    """(ce [B], neg [B], topk [B, hard_neg], gt [B]) without materialising
    [B, C] logits (``fused_margin_softmax``). ``topk`` (the target-excluded
    top cosines) and ``gt`` (the target cosines) are monitoring outputs: no
    gradient flows through them. When ``w`` needs no gradient (a constant)
    the backward computes no d_w."""

    @staticmethod
    def forward(ctx, emb, w, labels, loss_type, margin, scale, hard_neg, mask_svfc):
        kw = dict(loss_type=loss_type, margin=margin, scale=scale, k=hard_neg,
                  mask_svfc=mask_svfc)
        labels = labels.to(torch.int32)
        gt = compute_gt(emb, w, labels)
        ce, neg, logz, topk = margin_ce_fwd(emb, w, labels, gt, **kw)
        ctx.save_for_backward(emb, w, labels, gt, logz, topk)
        ctx.kw = kw
        ctx.mark_non_differentiable(topk, gt)
        return ce, neg, topk, gt

    @staticmethod
    def backward(ctx, d_ce, d_neg, _d_topk, _d_gt):
        emb, w, labels, gt, logz, topk = ctx.saved_tensors
        zeros = torch.zeros_like(logz)
        d_emb, d_w = margin_ce_bwd(emb, w, labels, gt, logz, topk,
                                   zeros if d_ce is None else d_ce,
                                   zeros if d_neg is None else d_neg,
                                   grad_w=ctx.needs_input_grad[1], **ctx.kw)
        if d_w is not None:  # the kernels store f32; JAX's wrapper casts to w.dtype
            d_w = d_w.to(w.dtype)
        return (d_emb, d_w) + (None,) * 6


def fused_margin_softmax(emb, w, labels, loss_type="Arc", margin=0.5, scale=32.0, hard_neg=10,
                         mask_svfc=1.2):
    """(ce, neg, topk) per row; see ``MarginSoftmax``."""
    ce, neg, topk, _gt = MarginSoftmax.apply(emb, w, labels, loss_type, float(margin),
                                             float(scale), int(hard_neg), float(mask_svfc))
    return ce, neg, topk


def fused_add_margin(emb, w, labels, *, loss_type="Arc", margin=0.5, scale=32.0, hard_neg=10,
                     mask_svfc=1.2):
    """Scalar loss = mean CE over positive rows + mean hard-negative term
    over outlier rows (each 0 when its row set is empty) — the reduction of
    ``ops.margin.add_margin``, streaming over the class axis."""
    ce, neg, _topk = fused_margin_softmax(emb, w, labels, loss_type, margin, scale, hard_neg,
                                          mask_svfc)
    return reduce_margin_loss(ce, neg, labels)


def reduce_margin_loss(ce, neg, labels):
    """Mean CE over positive rows + mean hard-negative term over outlier
    rows, each 0 when its row set is empty."""
    pos = (labels >= 0).float()
    n_pos, n_out = pos.sum(), (1.0 - pos).sum()
    zero = ce.new_zeros(())
    cls = torch.where(n_pos > 0, ce.sum() / n_pos.clamp(min=1.0), zero)
    neg_l = torch.where(n_out > 0, neg.sum() / n_out.clamp(min=1.0), zero)
    return cls + neg_l


def streaming_margin_grads_fused_sgd(emb, w, mom, labels, d_ce, d_neg, lr, *, momentum, nesterov,
                                     weight_decay, loss_type="Arc", margin=0.5, scale=32.0,
                                     hard_neg=1, mask_svfc=1.2):
    """Explicit forward + backward with the classifier SGD update fused into
    the backward stream, outside autograd: the caller supplies the output
    cotangents and feeds ``d_emb`` into the backbone. ``w`` and ``mom`` are
    updated IN PLACE. Returns (ce, neg, topk, gt, d_emb, w, mom)."""
    emb = emb.float().contiguous()
    labels = labels.to(torch.int32)
    kw = dict(loss_type=loss_type, margin=float(margin), scale=float(scale), k=int(hard_neg),
              mask_svfc=float(mask_svfc))
    gt = compute_gt(emb, w, labels)
    ce, neg, logz, topk = margin_ce_fwd(emb, w, labels, gt, **kw)
    d_emb, w, mom = margin_ce_bwd_fused_sgd(emb, w, mom, labels, gt, logz, topk, d_ce, d_neg, lr,
                                            momentum=momentum, nesterov=nesterov,
                                            weight_decay=weight_decay, **kw)
    return ce, neg, topk, gt, d_emb, w, mom


def streaming_sparse_margin_grads(emb, w, labels, d_ce, d_neg, *, m_tiles, loss_type="Arc",
                                  margin=0.5, scale=32.0, hard_neg=1, mask_svfc=1.2, tile=512,
                                  u=None, exact_demb=True):
    """One explicit forward + backward with a SPARSE classifier gradient,
    outside autograd (``margin_pallas.streaming_sparse_margin_grads``): the
    exact loss from the streaming forward with tile statistics, the
    ``m_tiles`` tiles ``select_relevant_tiles`` picks (``u`` [n_tiles] the
    uniform draws of its random fill, or None for none), their d_w rows
    scaled by the tiles' importance weights, and d_emb — exact from
    ``margin_ce_bwd(grad_w=False)`` with ``exact_demb``, else the sparse
    backward's truncated one.

    Returns (ce, neg, topk, gt, d_emb, row_idx [M·tile] int32, d_w_rows
    [M·tile, D]); ``row_idx`` entries are unique, those ≥ C are padding for
    the update to drop (``train/sparse_classifier.sparse_sgd_rows``)."""
    emb = emb.float().contiguous()
    labels = labels.to(torch.int32)
    b, d = emb.shape
    tile, n_tiles = sparse_bwd_geometry(b, d, w.shape[0], tile)
    kw = dict(loss_type=loss_type, margin=float(margin), scale=float(scale), k=int(hard_neg),
              mask_svfc=float(mask_svfc))
    gt = compute_gt(emb, w, labels)
    ce, neg, logz, topk, maxz, maxcos = margin_ce_fwd(emb, w, labels, gt, with_stats=True,
                                                      tile=tile, **kw)
    tile_idx, tile_weight = select_relevant_tiles(maxz, maxcos, logz, topk, labels,
                                                  min(m_tiles, n_tiles), tile, u=u)
    d_emb, d_w_rows = margin_ce_bwd_sparse(emb, w, labels, gt, logz, topk, d_ce, d_neg, tile_idx,
                                           tile=tile, **kw)
    d_w_rows.mul_(tile_weight.repeat_interleave(tile)[:, None])
    if exact_demb:
        d_emb, _ = margin_ce_bwd(emb, w, labels, gt, logz, topk, d_ce, d_neg, grad_w=False, **kw)
    row_idx = (tile_idx[:, None] * tile
               + torch.arange(tile, dtype=torch.int32, device=emb.device)[None, :]).reshape(-1)
    return ce, neg, topk, gt, d_emb, row_idx, d_w_rows
