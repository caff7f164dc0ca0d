"""Hold a classifier kernel's output to its plain version, row set by row set.

The rows of the batch's labels carry the target column's gradient, which
plain torch computes on both sides and which is larger than the streamed
gradient of every other row by orders of magnitude at C = 2^20. A limit
scaled by the largest value over all rows would let a kernel be wrong on
all the other rows, which are the rows it computes alone. So each check
splits the classifier rows into the label rows and the others and holds
each set to a limit scaled by its own largest reference value, plus the
rounding of the stored output (``rounding`` × f32 eps × its largest value:
the kernel and the plain version round the same sums in another order and
with or without FMA).

A sparse backward's d_w rows follow the selected tiles' layout, so its
label rows are the rows of that layout that hold a batch label
(``sparse_label_rows``).

The model-sharded quad head is held on one card by emulated shards
(``quad_shard_checks``): the queue cut into blocks, each block's partial
kernels against their plain versions (``quad_partial_checks``), and the
blocks merged as the collectives would merge them against the
single-device kernels on the whole queue. Limits: the partial state
m + log s and ce / neg / logz 1e-4 absolute, m scale × 1e-5 (the top-k
limit through z = scale·cos), top-k 1e-5 (f32 sums in another order);
d_emb 1e-4 × its max; d_gt 1e-5. logz is held on the in-pool rows, the
only rows the loss reads it on: on outlier rows SV's logz depends on a gt
the loss never uses, which the single-device head takes from slot 0 and
the sharded head sets to 0.

The class-sharded softmax head is held the same way
(``margin_shard_checks``): the classifier cut into blocks, each block's
partial kernels against their plain versions (``margin_partial_checks``:
the state as the quad partials', d_emb 1e-4 × its max, d_w by row set —
the block's owned label rows / the others — 1e-4 × the set's max,
d_gt_raw 1e-5 × max(1, its max)), and the blocks merged as the collectives
would merge them against ``margin_ce_fwd`` / ``margin_ce_bwd`` on the whole
classifier: ce / neg / logz 1e-4, top-k 1e-5, d_emb 1e-4 × its streamed
part's max + 2 f32 eps, and each block of d_w by row set against the
whole d_w's rows.

The quad kernels on one card (``quad_checks``): ce / neg / logz 1e-4
absolute and top-k 1e-5 (f32 sums in another order over up to 10M
columns), d_gt 1e-5; d_emb 1e-4 × its max on an f32 queue. On the bf16 and
int8 forms both sides round each d_cos to bf16 before its product with a
row (module docstring of ``ops/twin_margin.py``); the kernel's f32 d_cos
differs from the plain version's in the last bits (expf, sums in another
order), and where the two straddle a bf16 rounding boundary one term of
d_emb moves by one bf16 ulp, up to 2^-8 of itself. A straddle moves the
D features of one row, and in a row that one column dominates it can move
them by ~1e-3 of d_emb's max. So d_emb is held in two parts
(``rounded_demb``): at most STRADDLE_ROWS = 8 rows in each 256 of d_emb
(a straddle is a chance per d_cos term, so the rows it touches grow with
the rows) may be further than DEMB_TIGHT = 1e-5 × max from the plain
version, and no row further than
ROUNDED_DEMB_RTOL = 2^-7 × max (one bf16 ulp of two such terms). A kernel
that skips a rounding moves most rows by ~2^-9 of their terms and fails
the first part. On an H100 over chip_smoke.py's phase-21 and phase-23
cases (256 rows) the kernels put at most 3 rows beyond 1e-5 × max (the
int8 forms' tensor-core cosines, against the plain version's f32
product, 0-1); copies that skip the clean tiles' or the bf16 written
tiles' rounding, round an int8 tile's d_cos before its column scale or
leave the scale out put tens to hundreds there
(``tests/test_torch_kernels.py::test_form_checks_reject_planted_faults``
plants each).

The softmax head's bf16 classifier (``margin_stream``'s bf16 forms: the
kernels and the plain versions round the same operands, bf16(emb) and
bf16(ŵ), bit for bit, and sum exact products in another order;
``rounded_softmax_checks`` and the helpers below). Where the kernel's and
the plain version's f32 d_cos straddle a bf16 rounding boundary, one
rounded term moves by a bf16 spacing, up to 2^-8 of itself; how many rows
that moves beyond a tight limit depends on how many terms a row sums, so
each count has one limit below WIDE = 2^16 summed columns (d_emb) or rows
in the set (d_w) and one at or above it, each set from the most read on an
H100 at B = 128 (chip_smoke.py phase 29 and the ``gpu`` tests of
tests/test_torch_kernels.py, C = 4,096 / 5,000 and 2^20 / 1,250,000):

* the cosines: the kernels form them on the tensor cores as one chain in
  every pass (``margin_cos_checks``: the three tilings bit for bit, within
  BF16_COS_ATOL of the plain version's), and the backward's references —
  ``margin_ce_bwd_checks``, ``margin_ce_bwd_sparse_checks``,
  ``margin_partial_checks`` — run the plain versions on those cosines
  (``cos=``). cuBLAS's f32 product sums the same exact bf16 products in
  another order: 5.2e-9 apart on average, 1.8e-7 at most, at C = 2^20 (the
  tensor cores' 3.2e-9 from the exact sum, cuBLAS's 4.8e-9), and each such
  difference that straddles a bf16 rounding boundary of d_cos moves its
  term by a bf16 spacing; a d_w row sums B terms, one of them dominant, so
  against cuBLAS's cosines 785-876 rows of 2^20 read beyond the tight
  limit, 433-500 against the exact ones (f64), 0 against the kernels' own
  (H100, three cases at B = 128, D = 512). The f32 FMA kernel of PR 8
  summed in cuBLAS's order and read 0-5;
* forward: ce / neg / logz 1e-5 × max(1, max |value|) (BF16_FWD_RTOL), top-k
  1e-5 absolute; the statistics and the partial state as the f32 form's;
* d_emb: ``rounded_demb`` against its streamed part (d_emb less the target
  term plain torch adds on both sides), its count at most
  SOFTMAX_DEMB_ROWS = 16 rows below WIDE columns (read: up to 10 of 128 over
  the 4,096 columns of 8 selected tiles, 8 at C = 4,096) and STRADDLE_ROWS
  = 8 from WIDE up (read: 0-1 at 2^20 and over 65,536 sparse columns), as
  the quad forms'; a rounding skipped on every column moves every row;
* d_w (and the f32 momentum of a bf16 classifier, whose g carries the same
  d_w) by row set in two parts (``rounded_rows``): each d_w row sums B
  terms bf16(d_cos[b, t])·bf16(emb_b), not diluted over the columns. At
  most ROUNDED_ROWS = 32 rows of a set below WIDE rows (read: up to 18 of
  3,968, 9 of 4,096) and 16 from WIDE up (read: 0 of 2^20, 0 of 65,536
  sparse rows, 1-5 of 1,250,000) may be further than 1e-5 × the set's
  max|ref| (+ 2 f32 eps × its max stored value) from the plain version,
  and none further than ROUNDED_ROW_CAP = 2^-5 × its own max|ref| beyond
  that (two straddled terms and the projection's share). A d_w fault that
  reaches the rows near the set's max (a scale, a missing term) fails the
  count. A block's d_w is held to the whole classifier's d_w from the same
  merged (gt, logz, top-k), not from the whole head's own logz, whose last
  bits move d_cos across boundaries on ~0.1 % of the rows;
* w' and mom' stored in bf16 (``bf16_ulps``), in bf16 spacings at the
  larger of the result and the stored value before the update (a result
  that cancels its operands carries their f32 rounding, many ulps of
  itself and no fault): equal, except at most ULP_SHARE = 2^-13 of the
  elements one spacing apart (the f32 values before the rounding differ in
  their last bits, FMA contraction and d_w's straddles, and each such
  value rounds the other way when it lies that close to a boundary: a
  share of the elements; read up to 70 of 2^21 at C = 4,096 (2^-14.9),
  4,628 of 2^29 at 2^20, and 27,810 of 2^29 (2^-14.2) there with the
  momentum scaled by 1e-4 at lr 100), and none more than one spacing apart
  outside the
  rows whose gradient straddled (``straddled_rows``: the kernel's d_w
  beyond the tight limit of the plain one's; a straddled term that
  dominates its element moves the f32 value by up to two spacings). A w'
  rounded twice (bf16(w − bf16(lr·upd))) moves ~1 % of a 0.01-scale
  classifier's elements at lr 0.1 and fails the count;
* a momentum written from zero (a trainer's first step, bf16(g)), whose g
  may cancel (d_w ≈ −wd·w) with no stored value to set the scale: a
  cancelled element sits many of its own spacings from the plain version
  (read at 2^20 against the plain update on the plain forward's logz:
  262,629 elements apart, 46,142 beyond one spacing, up to 58,299
  spacings), so it is held by what lies beyond one bf16 spacing of each
  element, with d_w's limits (``rounded_rows``; ``bf16_fresh_state``; read
  0 rows beyond the tight limit on the step's own logz);
* w' stored in f32 beside a bf16 momentum (the f32 form): ``by_rows``
  against lr(1 + μ)·g with g = d_w + wd·w from the plain d_w, as the f32
  pair's; that momentum, bf16 of the f32 form's g + μ·mom, by row set
  beyond one bf16 spacing of each element, 1e-4 × the set's max|g|: the
  f32 form's g is held only to its set's max, so where g dominates (a
  small momentum) its small elements sit many of their own spacings from
  the plain version (read: 17 elements up to 29 spacings, 566,485 of 2^29
  elements apart at 2^20 with the momentum scaled by 1e-4 at lr 100), and
  no count of elements apart holds for it.

The f32 form's clean cosines (``f32_cos_checks``) are one fmaf chain
over the features in index order in both tilings (the forward's register
micro-tile, the backward's ftile_dots): equal bit for bit, and within F32_COS_ATOL of
the plain f32 product.

The int8-compute dot is an exact integer sum (``int8_dot_checks``): the
kernels' own clean cosines (``ops/twin_margin.clean_cos``, the tile code
the forward and the backward's recompute run) with unit scales are f32 of
the raw int32 accumulator and equal the integer product bit for bit; with
the real scales they equal the plain version's f32(acc) · (se · s) bit for
bit (the forward's and the backward's s8 tensor-core sums are the same
integer, whatever the tiling). The bf16 form's clean cosines (``bf16_cos_checks``)
and the int8-storage form's (``int8_cos_checks``: bf16(E) against the rows
widened to bf16, then the column scale) come from the tensor cores in both
tilings: equal to each other bit for bit (the backward's top-k test
compares them with the forward's kth), and within BF16_COS_ATOL of the
plain version's; so do the bf16 classifier's in the margin_ce kernels'
three tilings (``margin_cos_checks``).

Used by ``chip_smoke.py`` and the tests in ``tests/test_torch_kernels.py``.
"""

from __future__ import annotations

import torch

F32_EPS = torch.finfo(torch.float32).eps
# d_emb of the bf16 / int8 quad forms (module docstring, ``rounded_demb``)
ROUNDED_DEMB_RTOL = 2.0**-7
DEMB_TIGHT = 1e-5
STRADDLE_ROWS = 8
# the softmax head's bf16 classifier (module docstring): counts below / from WIDE
BF16_FWD_RTOL = 1e-5
WIDE = 1 << 16
SOFTMAX_DEMB_ROWS = (16, STRADDLE_ROWS)
ROUNDED_ROWS = (32, 16)
ROUNDED_ROW_CAP = 2.0**-5
ULP_SHARE = 2.0**-13


def label_rows(n_rows: int, labels: torch.Tensor) -> torch.Tensor:
    """[n_rows] bool: the rows some batch row is labelled with (outlier
    rows, label -1, name none)."""
    mask = torch.zeros(n_rows, dtype=torch.bool, device=labels.device)
    mask[labels[labels >= 0].long()] = True
    return mask


def whole(name: str, got, want, ref, rtol: float, rounding: float = 2.0) -> dict:
    """max |got − want| against rtol × max |ref| + rounding × eps ×
    max |want|, over the whole tensor. For d_emb, ``ref`` is the streamed
    part alone (d_emb less the target term both sides add in plain torch)."""
    limit = rtol * float(ref.abs().max()) + rounding * F32_EPS * float(want.abs().max())
    return {"name": name, "err": float((got - want).abs().max()), "limit": limit}


def sparse_label_rows(labels: torch.Tensor, tile_idx: torch.Tensor, tile: int) -> torch.Tensor:
    """[M·tile] bool: the rows of a sparse backward's d_w layout (the
    selected tiles in ``tile_idx`` order) that hold a batch label."""
    from vlsfr_tpu_torch.ops.margin_stream import _label_flat_pos

    present, flat = _label_flat_pos(labels, tile_idx, tile)
    mask = torch.zeros(tile_idx.shape[0] * tile, dtype=torch.bool, device=labels.device)
    mask[flat[present]] = True
    return mask


def by_rows(name: str, got, want, ref, labels, rtol: float, rounding: float = 0.0,
            is_label=None) -> list[dict]:
    """max |got − want| on the label rows and on the other rows of [C, D]
    tensors, each against rtol × max |ref| + rounding × eps × max |want|
    over the same rows. One entry per non-empty row set, with the set's
    max |ref| and max |want| beside its error and limit. ``is_label``
    [rows] bool names the label rows where they are not the class ids
    (a sparse layout: ``sparse_label_rows``)."""
    err = (got - want).abs().amax(dim=1)
    ref_max = ref.abs().amax(dim=1)
    out_max = want.abs().amax(dim=1)
    if is_label is None:
        is_label = label_rows(got.shape[0], labels.to(got.device))
    out = []
    for rows, mask in (("label rows", is_label), ("other rows", ~is_label)):
        if not bool(mask.any()):
            continue
        r, o = float(ref_max[mask].max()), float(out_max[mask].max())
        out.append({"name": f"{name} ({rows})", "err": float(err[mask].max()),
                    "limit": rtol * r + rounding * F32_EPS * o, "ref_max": r, "want_max": o})
    return out


def sgd_update(w_k, mom_k, w_p, mom_p, mom0, labels, lr: float, momentum: float,
               rtol: float = 1e-4, rounding: float = 2.0) -> list[dict]:
    """The fused SGD update (w', mom') of a kernel against the plain one,
    both from the same W and mom (``mom0``, taken before either ran). The
    reference is the gradient the plain update applied, decay included:
    g = mom' − μ·mom (mom' = g when μ = 0). mom' moves by g and w' by at
    most lr·(1 + μ)·g, so a wrong d_w or a skipped decay shows on the rows
    the kernel computes alone, where g is ~1e-6."""
    g = mom_p - momentum * mom0
    out = by_rows("mom'", mom_k, mom_p, g, labels, rtol, rounding)
    g.mul_(lr * (1.0 + momentum))
    out += by_rows("w'", w_k, w_p, g, labels, rtol, rounding)
    return out


def margin_ce_bwd_checks(emb, w, mom, labels, gt, logz, topk, d_ce, d_neg, kw: dict, lr: float,
                         sgd: dict, pos_rows=None) -> tuple[list[dict], list[dict]]:
    """The margin_ce backward kernels against their plain versions on one
    case, from the forward's ``logz`` / ``topk``: (``margin_ce_bwd``'s
    checks — d_emb without and with d_w, and d_w by row set; the fused
    kernel's — d_emb, then w' and mom' by row set). d_emb is held to its
    streamed part, 1e-4 × max|d_emb − the target term|; d_w to 1e-4 × the
    set's max|d_w|; w' and mom' as ``sgd_update``. W and mom are updated in
    place by the fused kernel; the plain version gets clones taken before.
    ``pos_rows``: the global positive rows of a block with block-local
    labels (one block of a class-sharded classifier). A bf16 classifier
    or momentum takes the bf16 forms' checks (module docstring): d_emb by
    ``rounded_demb`` on its streamed part, d_w by ``rounded_rows``, w' /
    mom' in bf16 by ``bf16_ulps``, an f32 mom' of a bf16 classifier by
    ``rounded_rows``, an f32 w' beside a bf16 momentum by ``by_rows``
    against lr(1 + μ)·(d_w + wd·w) and that momentum beyond one bf16
    spacing to 1e-4 × the set's max|d_w + wd·w|; a bf16 classifier's
    cosines first (``margin_cos_checks``), then the plain versions on
    them."""
    from vlsfr_tpu_torch.ops import margin_stream as tms

    rounded = w.dtype == torch.bfloat16
    d_ce_m, _ = tms._mask_cotangents(tms._positive(labels, pos_rows), d_ce, d_neg)
    emb_term, _ = tms._target_rows(emb, w, labels, gt, logz, d_ce_m, loss_type=kw["loss_type"],
                                   margin=kw["margin"], scale=kw["scale"])
    bwd, straddled, cos = [], None, None
    if rounded:  # the plain versions on the kernels' cosines, held first (module docstring)
        bwd, cos = margin_cos_checks(emb, w), tms.clean_cos(emb, w)

    def demb(name, got, want):
        if rounded:
            return softmax_demb(name, got, want, want - emb_term, cols=w.shape[0])
        return [whole(name, got, want, want - emb_term, 1e-4)]

    kw = dict(kw, pos_rows=pos_rows)
    for grad_w in (False, True):
        de_k, dw_k = tms.margin_ce_bwd(emb, w, labels, gt, logz, topk, d_ce, d_neg,
                                       grad_w=grad_w, **kw)
        de_p, dw_p = tms.margin_ce_bwd_plain(emb, w, labels, gt, logz, topk, d_ce, d_neg,
                                             grad_w=grad_w, cos=cos, **kw)
        bwd += demb(f"d_emb (grad_w={grad_w})", de_k, de_p)
        if grad_w:
            if rounded:
                bwd += rounded_rows("d_w", dw_k, dw_p, dw_p, labels)
                straddled = straddled_rows(dw_k, dw_p, labels)
            else:
                bwd += by_rows("d_w", dw_k, dw_p, dw_p, labels, 1e-4)
            if not rounded and mom.dtype == torch.bfloat16:  # f32 w' beside a bf16 mom
                g_ref = dw_p.add_(w, alpha=sgd["weight_decay"])
        elif dw_k is not None or dw_p is not None:
            raise RuntimeError("margin_ce_bwd returned a d_w with grad_w=False")
        del dw_k, dw_p
    w_p, mom_p, mom0 = w.clone(), mom.clone(), mom.clone()
    w0 = w.clone() if rounded else None
    de_k, w_k, mom_k = tms.margin_ce_bwd_fused_sgd(emb, w, mom, labels, gt, logz, topk, d_ce,
                                                   d_neg, lr, **sgd, **kw)
    de_p, w_p, mom_p = tms.margin_ce_bwd_fused_sgd_plain(emb, w_p, mom_p, labels, gt, logz, topk,
                                                         d_ce, d_neg, lr, cos=cos, **sgd, **kw)
    del cos
    if w_k.data_ptr() != w.data_ptr() or mom_k.data_ptr() != mom.data_ptr():
        raise RuntimeError("margin_ce_bwd_fused_sgd did not update W and mom in place")
    fused = demb("fused d_emb", de_k, de_p)
    mu = sgd["momentum"]
    if not rounded and mom.dtype == torch.float32:
        return bwd, fused + sgd_update(w_k, mom_k, w_p, mom_p, mom0, labels, lr, mu)
    if rounded:
        fused += bf16_ulps("w'", w_k, w_p, w0, straddled)
    else:
        fused += by_rows("w'", w_k, w_p, g_ref * (lr * (1.0 + mu)), labels, 1e-4, 2.0)
    if rounded and mom.dtype == torch.bfloat16:
        fused += bf16_ulps("mom'", mom_k, mom_p, mom0, straddled)
    elif mom.dtype == torch.bfloat16:  # the f32 form's g stored in bf16
        gap = beyond_spacing(mom_k, mom_p, mom0)
        fused += by_rows("mom' beyond one bf16 spacing", gap, torch.zeros_like(gap), g_ref,
                         labels, 1e-4)
    else:
        fused += rounded_rows("mom'", mom_k, mom_p, mom_p - mu * mom0, labels)
    return bwd, fused


def fwd_stats_checks(maxz_k, maxcos_k, maxz_p, maxcos_p, scale: float,
                     tol: float = 1e-5) -> list[dict]:
    """The forward's tile statistics against the plain ones: maxcos to
    ``tol`` absolute (f32 cosines summed in another order), maxz = scale ×
    a cosine (or scale·φ(gt)) to scale × ``tol``."""
    return [{"name": "maxcos", "err": float((maxcos_k - maxcos_p).abs().max()), "limit": tol},
            {"name": "maxz", "err": float((maxz_k - maxz_p).abs().max()), "limit": scale * tol}]


def margin_ce_bwd_sparse_checks(emb, w, labels, gt, logz, topk, d_ce, d_neg, tile_idx, kw: dict,
                                tile: int, pos_rows=None) -> list[dict]:
    """The sparse backward against its plain version on the same
    ``tile_idx``. The wrapper ``margin_ce_bwd_sparse`` (what route D calls)
    against ``margin_ce_bwd_sparse_plain``: the whole d_emb to 1e-4 × its
    streamed part's max (the target term, which plain torch adds on both
    sides, left out of the reference) + 2 f32 eps; the d_w rows by row set
    (the rows that hold a batch label / the others) to 1e-4 × the set's
    max|d_w|. Then the kernel's parts before the target term: the streamed
    d_emb alone, to the same limit, and d_gt, the target column's dz, to
    1e-5 × max(1, max|d_gt|) (one exp in another library). ``pos_rows`` as
    in ``margin_ce_bwd_checks``."""
    from vlsfr_tpu_torch.ops import margin_stream as tms

    args = (emb, w, labels, gt, logz, topk, d_ce, d_neg, tile_idx)
    kw = dict(kw, pos_rows=pos_rows)
    rounded = w.dtype == torch.bfloat16
    cos = tms.clean_cos(emb, w) if rounded else None  # the kernels' own (module docstring)
    sde_p, _, dgt_p = tms._sparse_parts_plain(*args, tile=tile, cos=cos, **kw)
    de_k, dw_k = tms.margin_ce_bwd_sparse(*args, tile=tile, **kw)
    de_p, dw_p = tms.margin_ce_bwd_sparse_plain(*args, tile=tile, cos=cos, **kw)
    del cos
    is_label = sparse_label_rows(labels, tile_idx, tile)
    cols = tile_idx.numel() * tile
    if rounded:  # the bf16 form (module docstring)
        out = softmax_demb("sparse d_emb", de_k, de_p, sde_p, cols=cols)
        out += rounded_rows("sparse d_w", dw_k, dw_p, dw_p, labels, is_label=is_label)
    else:
        out = [whole("sparse d_emb", de_k, de_p, sde_p, 1e-4)]
        out += by_rows("sparse d_w", dw_k, dw_p, dw_p, labels, 1e-4, is_label=is_label)
    del dw_k, dw_p
    sde_k, _, dgt_k = tms._sparse_parts_cuda(*args, tile=tile, **kw)
    out += (softmax_demb("sparse d_emb (streamed)", sde_k, sde_p, cols=cols) if rounded
            else [whole("sparse d_emb (streamed)", sde_k, sde_p, sde_p, 1e-4)])
    out.append({"name": "sparse d_gt", "err": float((dgt_k - dgt_p).abs().max()),
                "limit": 1e-5 * max(1.0, float(dgt_p.abs().max()))})
    return out


def sparse_path_checks(emb, w, labels, d_ce, d_neg, kw: dict, tile: int, m_tiles: int, u,
                       pos_rows=None, gt=None):
    """Route D's kernels against their plain versions on one case: the
    forward with statistics (ce / neg / logz 1e-4 and top-k 1e-5 absolute,
    then ``fwd_stats_checks``), tiles selected from the PLAIN statistics
    (``u`` the random fill's draws), and the sparse backward on those same
    tiles (``margin_ce_bwd_sparse_checks``), so selection noise cannot mask
    a kernel fault. One block of a class-sharded classifier passes its
    block-local labels, the global positive rows ``pos_rows`` and the
    global ``gt``. Returns (checks, tile_idx, (gt, logz, topk))."""
    from vlsfr_tpu_torch.ops import margin_stream as tms

    if gt is None:
        gt = tms.compute_gt(emb, w, labels)
    got = tms.margin_ce_fwd(emb, w, labels, gt, with_stats=True, tile=tile, **kw)
    want = tms.margin_ce_fwd_plain(emb, w, labels, gt, with_stats=True, tile=tile, **kw)
    checks = fwd_out_checks(got, want, w.dtype == torch.bfloat16)
    checks += fwd_stats_checks(got[4], got[5], want[4], want[5], kw["scale"])
    _, _, logz, topk, maxz, maxcos = want
    tile_idx, _ = tms.select_relevant_tiles(maxz, maxcos, logz, topk, labels, m_tiles, tile, u=u,
                                            pos_rows=pos_rows)
    checks += margin_ce_bwd_sparse_checks(emb, w, labels, gt, logz, topk, d_ce, d_neg, tile_idx,
                                          kw, tile, pos_rows=pos_rows)
    return checks, tile_idx, (gt, logz, topk)


def fwd_out_checks(got, want, rounded: bool, tag: str = "") -> list[dict]:
    """The forward's outputs (ce, neg, logz, top-k) against the plain
    ones: an f32 classifier's ce / neg / logz 1e-4 and top-k 1e-5 absolute
    (f32 sums in another order over C columns), a bf16 one's
    ``rounded_fwd_checks``."""
    if rounded:
        return rounded_fwd_checks(got, want, tag)
    return [_err(f"{tag}{name}", g, wn, tol) for name, g, wn, tol in
            zip(("ce", "neg", "logz", "topk"), got, want, (1e-4, 1e-4, 1e-4, 1e-5))]


def partial_state_checks(got, want, scale: float, tag: str = "") -> list[dict]:
    """A class block's partial forward state (m, s, top-k) against the
    plain one: the rows with a column (s > 0) alike, m to scale × 1e-5 and
    m + log s to 1e-4 on them, top-k 1e-5."""
    (m_k, s_k, t_k), (m_p, s_p, t_p) = got, want
    seen = s_p > 0
    return [
        {"name": f"{tag}partial rows with a column", "limit": 0.0,
         "err": float((seen != (s_k > 0)).sum())},
        _err(f"{tag}partial m", m_k[seen], m_p[seen], scale * 1e-5),
        _err(f"{tag}partial m + log s", (m_k + torch.log(s_k))[seen],
             (m_p + torch.log(s_p))[seen], 1e-4),
        _err(f"{tag}partial top-k", t_k, t_p, 1e-5)]


def margin_fwd_checks(emb, w, labels, kw: dict, tile: int = 512, tag: str = "") -> list[dict]:
    """The forward kernel against its plain versions on one case, in every
    call it serves, each under the limits it has elsewhere:
    ``margin_ce_fwd`` without statistics and with them (``fwd_out_checks``,
    then ``fwd_stats_checks`` at ``tile``), and ``margin_partial_fwd`` with
    the whole classifier as one block (``partial_state_checks``; the
    labels are the block's own)."""
    from vlsfr_tpu_torch.ops import margin_stream as tms

    gt = tms.compute_gt(emb, w, labels)
    rounded = w.dtype == torch.bfloat16
    checks = fwd_out_checks(tms.margin_ce_fwd(emb, w, labels, gt, **kw),
                            tms.margin_ce_fwd_plain(emb, w, labels, gt, **kw), rounded, tag)
    got = tms.margin_ce_fwd(emb, w, labels, gt, with_stats=True, tile=tile, **kw)
    want = tms.margin_ce_fwd_plain(emb, w, labels, gt, with_stats=True, tile=tile, **kw)
    t = f"{tag}with statistics: "
    checks += fwd_out_checks(got, want, rounded, t)
    checks += [dict(c, name=t + c["name"])
               for c in fwd_stats_checks(got[4], got[5], want[4], want[5], kw["scale"])]
    return checks + partial_state_checks(tms.margin_partial_fwd(emb, w, labels, gt, **kw),
                                         tms.margin_partial_fwd_plain(emb, w, labels, gt, **kw),
                                         kw["scale"], tag)


def _err(name: str, got, want, limit: float) -> dict:
    return {"name": name, "err": float((got - want).abs().max()) if got.numel() else 0.0,
            "limit": limit}


def quad_checks(queue, packed, kw: dict, dce, dneg, tag: str = "", tile: int = 512):
    """``quad_fwd`` / ``quad_bwd`` against their plain versions on one case
    in the packed layout (``kw`` holds the form's ``qscales`` / ``e8``;
    ``tile`` the backward's tile request). Returns (checks, the plain
    forward's outputs)."""
    from vlsfr_tpu_torch.ops import twin_margin as ttm

    E, rest = packed[0], packed[1:]
    got = ttm.quad_fwd(E, queue, *rest, **kw)
    want = ttm.quad_fwd_plain(E, queue, *rest, **kw)
    checks = [_err(f"{tag}{name}", g, w, tol) for name, g, w, tol in
              zip(("ce", "neg", "logz", "top-k"), got, want, (1e-4, 1e-4, 1e-4, 1e-5))]
    logz, kth = want[2], want[3][:, :, -1].contiguous()
    d_k, g_k = ttm.quad_bwd(E, queue, *rest, logz, kth, dce, dneg, **kw, tile=tile)
    d_p, g_p = ttm.quad_bwd_plain(E, queue, *rest, logz, kth, dce, dneg, **kw, tile=tile)
    checks += demb_checks(f"{tag}d_emb", d_k, d_p, queue.dtype)
    checks.append(_err(f"{tag}d_gt", g_k, g_p, 1e-5))
    return checks, want


def demb_checks(name: str, got, want, dtype) -> list[dict]:
    """A quad backward's d_emb against the plain one: 1e-4 × its max on an
    f32 queue, ``rounded_demb`` on the others."""
    if dtype == torch.float32:
        return [_err(name, got, want, 1e-4 * float(want.abs().max()))]
    return rounded_demb(name, got, want)


def rounded_demb(name: str, got, want, ref=None, allowed: int | None = None) -> list[dict]:
    """d_emb of a rounded form in two parts (module docstring): the count
    of rows further than DEMB_TIGHT × max |ref| from the plain version, at
    most ``allowed`` (STRADDLE_ROWS for each 256 rows, or part of 256; the
    softmax head's, ``softmax_demb``), and the largest error of any row, at
    most ROUNDED_DEMB_RTOL × max |ref|. ``ref`` is ``want`` unless given
    (the softmax head's streamed part)."""
    if allowed is None:
        allowed = STRADDLE_ROWS * -(-got.shape[0] // 256)
    top = float((want if ref is None else ref).abs().max())
    row_err = (got - want).abs().amax(dim=1)
    return [{"name": f"{name} rows beyond {DEMB_TIGHT:g} x max", "count": True,
             "err": float((row_err > DEMB_TIGHT * top).sum()), "limit": float(allowed)},
            {"name": name, "err": float(row_err.max()), "limit": ROUNDED_DEMB_RTOL * top}]


def softmax_demb(name: str, got, want, ref=None, *, cols: int) -> list[dict]:
    """``rounded_demb`` with the softmax head's bf16 allowance for a d_emb
    summed over ``cols`` columns: SOFTMAX_DEMB_ROWS below / from WIDE
    (module docstring)."""
    return rounded_demb(name, got, want, ref, SOFTMAX_DEMB_ROWS[cols >= WIDE])


def _beyond_tight(err, ref_row, out_max, mask, rounding: float):
    """The rows of ``mask`` whose error is beyond DEMB_TIGHT × the set's
    max|ref| + ``rounding`` × eps × its max|want|, and that limit."""
    tight = (DEMB_TIGHT * float(ref_row[mask].max())
             + rounding * F32_EPS * float(out_max[mask].max()))
    return mask & (err > tight), tight


def _row_sets(got, labels, is_label):
    if is_label is None:
        is_label = label_rows(got.shape[0], labels.to(got.device))
    return (("label rows", is_label), ("other rows", ~is_label))


def rounded_rows(name: str, got, want, ref, labels, rounding: float = 2.0,
                 is_label=None) -> list[dict]:
    """[rows, D] f32 values that sum bf16-rounded terms (a bf16 form's d_w,
    or an f32 momentum that takes it), by row set in two parts (module
    docstring): the count of rows further than DEMB_TIGHT × the set's
    max|ref| + ``rounding`` × eps × its max|want|, at most ROUNDED_ROWS
    (below / from WIDE rows in the set); and the largest excess of any row
    over ROUNDED_ROW_CAP × its own max|ref|, at most that tight limit."""
    err = (got - want).abs().amax(dim=1)
    ref_row = ref.abs().amax(dim=1)
    out_max = want.abs().amax(dim=1)
    out = []
    for rows, mask in _row_sets(got, labels, is_label):
        n = int(mask.sum())
        if not n:
            continue
        beyond, tight = _beyond_tight(err, ref_row, out_max, mask, rounding)
        out += [{"name": f"{name} ({rows}) rows beyond {DEMB_TIGHT:g} x max", "count": True,
                 "err": float(beyond.sum()), "limit": float(ROUNDED_ROWS[n >= WIDE])},
                {"name": f"{name} ({rows}) beyond {ROUNDED_ROW_CAP:g} x its row's max",
                 "excess": True, "limit": tight,
                 "err": float((err[mask] - ROUNDED_ROW_CAP * ref_row[mask]).max())}]
    return out


def straddled_rows(got, want, labels, rounding: float = 2.0, is_label=None):
    """[rows] bool: the rows where a bf16 form's d_w (``got``) is further
    from the plain one's than ``rounded_rows``' tight limit of its row set,
    the rows whose gradient straddled a rounding boundary."""
    err = (got - want).abs().amax(dim=1)
    ref_row = want.abs().amax(dim=1)
    out = torch.zeros_like(err, dtype=torch.bool)
    for _, mask in _row_sets(got, labels, is_label):
        if bool(mask.any()):
            out |= _beyond_tight(err, ref_row, ref_row, mask, rounding)[0]
    return out


def bf16_spacing(x):
    """The spacing of bf16 values at |x| (bf16 keeps 8 significant bits:
    2^(e − 8) for |x| in [2^(e − 1), 2^e)); the smallest normal's at 0."""
    _, e = torch.frexp(x.abs().float())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8).clamp(min=2.0**-133)


def beyond_spacing(got, want, before=None):
    """|got − want| of bf16 stores less one bf16 spacing at the larger of
    |want| and |before| (the store's own rounding), at least 0, in f32."""
    scale = want.float().abs() if before is None else torch.maximum(want.float().abs(),
                                                                    before.float().abs())
    return ((got.float() - want.float()).abs() - bf16_spacing(scale)).clamp_(min=0)


def bf16_fresh_state(name: str, got, want, labels) -> list[dict]:
    """A bf16 state written from a fresh gradient (the momentum after a
    trainer's first step from zero, bf16(g)) against the plain
    composition's: beyond one bf16 spacing of each element, by
    ``rounded_rows`` against the state (module docstring)."""
    gap = beyond_spacing(got, want)
    return rounded_rows(f"{name} beyond one bf16 spacing", gap, torch.zeros_like(gap),
                        want.float(), labels)


def bf16_ulps(name: str, got, want, before, straddled=None,
              share: float = ULP_SHARE) -> list[dict]:
    """bf16 results of an update (a fused update's w' or mom', or a state
    written from zero: ``before`` zeros), from the stored values ``before``
    it, in bf16 spacings at the larger of |want| and |before| (a result that
    cancels its operands carries their f32 rounding, which is no fault):
    the count of elements that differ, at most max(STRADDLE_ROWS, ``share``
    (ULP_SHARE) × their number), and the count more than one spacing apart outside the
    ``straddled`` rows ([rows] bool, ``straddled_rows`` of the same step's
    d_w; none if not given), 0 (module docstring). The first entry also
    holds how many elements the update changed."""
    scale = torch.maximum(want.float().abs(), before.float().abs())
    dist = (got.float() - want.float()).abs() / bf16_spacing(scale)
    far = dist > 1
    if straddled is not None:
        far &= ~straddled.to(far.device)[:, None]
    allowed = max(STRADDLE_ROWS, int(share * want.numel()))
    return [{"name": f"{name} elements apart", "count": True,
             "err": float((dist > 0).sum()), "limit": float(allowed),
             "changed": int((want != before).sum())},
            {"name": f"{name} elements more than one bf16 spacing apart"
                     + ("" if straddled is None else " (rows with no straddled gradient)"),
             "count": True, "err": float(far.sum()), "limit": 0.0,
             "max_spacings": float(dist.max())}]


def rounded_fwd_checks(got, want, tag: str = "") -> list[dict]:
    """A bf16 form's forward outputs (ce, neg, logz, top-k, ...) against
    the plain ones: ce / neg / logz BF16_FWD_RTOL × max(1, max |want|),
    top-k 1e-5 absolute."""
    out = []
    for name, g, w in zip(("ce", "neg", "logz", "top-k"), got, want):
        limit = 1e-5 if name == "top-k" else BF16_FWD_RTOL * max(1.0, float(w.abs().max()))
        out.append(_err(f"{tag}{name}", g, w, limit))
    return out


def int8_dot_checks(E8, se, w8, qs, tag: str = "") -> list[dict]:
    """The int8-compute dot of the quantised probes ``(E8, se)`` with an
    int8 plane ``w8`` (scales ``qs``), each bit-equal (limit 0): the plain
    version's f32 product against the integer product (``torch._int_mm``
    on the card); on the card also the kernels' clean cosines
    (``clean_cos``) in the forward's and the backward's tiling, with unit
    scales against the integer product, and with the real scales against
    the plain version's."""
    from vlsfr_tpu_torch.ops import twin_margin as ttm

    exact = (torch._int_mm(E8, w8.T) if E8.is_cuda else E8.long() @ w8.long().T).float()
    checks = [_err(f"{tag}int8 raw dot (plain version)", E8.float() @ w8.float().T, exact, 0.0)]
    if not E8.is_cuda:
        return checks
    E, plain = E8.float(), ttm._clean_cos(None, w8, qs, (E8, se))
    ones_r, ones_q = torch.ones_like(se), torch.ones_like(qs)
    for tiles, bwd in (("forward", False), ("backward", True)):
        raw = ttm.clean_cos(E, w8, qscales=ones_q, e8=(E8, ones_r), bwd_tiles=bwd)
        checks.append(_err(f"{tag}int8 raw dot (kernel, {tiles} tiles)", raw, exact, 0.0))
        del raw
        cos = ttm.clean_cos(E, w8, qscales=qs, e8=(E8, se), bwd_tiles=bwd)
        checks.append(_err(f"{tag}int8c clean cos (kernel, {tiles} tiles)", cos, plain, 0.0))
        del cos
    return checks


BF16_COS_ATOL = 1e-6  # exact bf16 products, |cos| <= 1, summed in f32 in another order
F32_COS_ATOL = 1e-5  # f32 sums in another order, as the forward's top-k (its cosines)


def _tiling_cos_checks(form: str, E, q0, qs, tag: str,
                       atol: float = BF16_COS_ATOL) -> list[dict]:
    from vlsfr_tpu_torch.ops import twin_margin as ttm

    fwd = ttm.clean_cos(E, q0, qscales=qs)
    bwd = ttm.clean_cos(E, q0, qscales=qs, bwd_tiles=True)
    plain = ttm._clean_cos(ttm._dot_operands(E, E, E, q0)[0], q0, qs, None)
    return [{"name": f"{tag}{form} clean cos elements differing (backward vs forward tiles)",
             "count": True, "err": float((fwd != bwd).sum()), "limit": 0.0},
            _err(f"{tag}{form} clean cos (kernel, forward tiles)", fwd, plain, atol)]


def f32_cos_checks(E, q0, tag: str = "") -> list[dict]:
    """The f32 form's clean cosines of probes ``E`` [R <= 256, D] against an
    f32 plane ``q0`` (``clean_cos``: the forward's micro-tile and the
    backward's ftile_dots, each one fmaf chain over the features in index
    order): the backward's tiling against the forward's, bit for bit (a
    count of elements that differ, limit 0: the backward's top-k test
    compares its cosine with the forward's kth), and the forward's within
    F32_COS_ATOL of the plain f32 product (sums in another order)."""
    return _tiling_cos_checks("f32", E, q0, None, tag, F32_COS_ATOL)


def bf16_cos_checks(E, q0, tag: str = "") -> list[dict]:
    """The bf16 form's clean cosines of probes ``E`` [R <= 256, D] against a
    bf16 plane ``q0`` (``clean_cos``): the backward's tiling against the
    forward's, bit for bit (a count of elements that differ, limit 0), and
    the forward's within BF16_COS_ATOL of the plain version."""
    return _tiling_cos_checks("bf16", E, q0, None, tag)


def int8_cos_checks(E, q0, qs, tag: str = "") -> list[dict]:
    """The int8-storage form's clean cosines of probes ``E`` [R <= 256, D]
    against an int8 plane ``q0`` with scales ``qs`` (``clean_cos``: the k16
    chain over bf16(E) and the rows widened to bf16, times the column
    scale, in both tilings): as ``bf16_cos_checks``, the backward's tiling
    against the forward's bit for bit and the forward's within
    BF16_COS_ATOL of the plain version (exact products in another order,
    |cos| <= 1 after the scale)."""
    return _tiling_cos_checks("int8", E, q0, qs, tag)


def margin_cos_checks(emb, w, tag: str = "") -> list[dict]:
    """The classifier's cosines as the margin_ce kernels form them
    (``margin_stream.clean_cos``): every backward tiling against the
    forward's bit for bit (a count of elements that differ, limit 0: the
    backward's top-k test compares its cosines with the forward's kth; an
    f32 classifier's backward is one pass, one tiling), and the forward's
    within BF16_COS_ATOL (bf16) or F32_COS_ATOL (f32) of the plain
    version. Above 128 batch rows an f32 classifier's backward has two
    tilings too: its d_emb pass and its pass in row groups for d_w."""
    from vlsfr_tpu_torch.ops import margin_stream as tms

    form = "bf16" if w.dtype == torch.bfloat16 else "f32"
    one_pass = form == "f32" and emb.shape[0] <= tms._ROWS
    fwd = tms.clean_cos(emb, w)
    checks = []
    for tiling in tms.COS_TILINGS[1:2] if one_pass else tms.COS_TILINGS[1:]:
        other = tms.clean_cos(emb, w, tiling=tiling)
        name = "backward pass" if one_pass else tiling
        checks.append({"name": f"{tag}{form} cos elements differing ({name} vs forward tiles)",
                       "count": True, "err": float((fwd != other).sum()), "limit": 0.0})
        del other
    plain = tms._chunk_cos(tms._operand(emb.float(), w), w, 0, w.shape[0])[0]
    return checks + [_err(f"{tag}{form} cos (kernel, forward tiles)", fwd, plain,
                          BF16_COS_ATOL if form == "bf16" else F32_COS_ATOL)]


def quad_partial_checks(si, q_l, gt, logz, kth, dce, dneg, kw: dict, tag: str = "",
                        tile: int = 512):
    """Both partial kernels against their plain versions on one shard's
    inputs ``si`` (``parallel/sharded_quad.shard_inputs``) over its block
    ``q_l``, with the global gt, logz, kth and cotangents. Returns (checks,
    the kernel's (d_emb, d_gt))."""
    from vlsfr_tpu_torch.ops import twin_margin as ttm

    args = si.kernel_args(q_l)
    pkw = dict(b=si.E.shape[0] // 2, bp=si.rows.shape[0] // 2, **kw, **si.form_kw())
    m_k, s_k, t_k = ttm.quad_partial_fwd(*args, gt, **pkw)
    m_p, s_p, t_p = ttm.quad_partial_fwd_plain(*args, gt, **pkw)
    seen = s_p > 0
    checks = [
        {"name": f"{tag}partial rows with a column", "limit": 0.0,
         "err": float((seen != (s_k > 0)).sum())},
        _err(f"{tag}partial m", m_k[seen], m_p[seen], kw["scale"] * 1e-5),
        _err(f"{tag}partial m + log s", (m_k + torch.log(s_k))[seen],
             (m_p + torch.log(s_p))[seen], 1e-4),
        _err(f"{tag}partial top-k", t_k, t_p, 1e-5)]
    d_k, g_k = ttm.quad_partial_bwd(*args, gt, logz, kth, dce, dneg, **pkw, tile=tile)
    d_p, g_p = ttm.quad_partial_bwd_plain(*args, gt, logz, kth, dce, dneg, **pkw, tile=tile)
    checks += demb_checks(f"{tag}partial d_emb", d_k, d_p, q_l.dtype)
    checks.append(_err(f"{tag}partial d_gt", g_k, g_p, 1e-5))
    return checks, (d_k, g_k)


def quad_shard_checks(emb_x, emb_y, queue, g_a, g_b, plan_a, plan_b, labels_a, labels_b, dce,
                      dneg, kw: dict, n_shards: int, qscales=None, int8_compute=False,
                      tile: int = 512):
    """The sharded quad head emulated in one process: ``queue`` cut into
    ``n_shards`` blocks, the gt parts summed (the all_reduce), each block's
    partial kernels held to their plain versions, the block states merged
    (``merge_partials``, the all_gather) and finalized, and the summed d_gt
    and d_emb with the owners' tails (the backward's all_reduces), against
    ``quad_fwd`` / ``quad_bwd`` + tail on the whole queue. ``dce`` /
    ``dneg`` are [2, 2b], masked with the positive rows. An int8 queue
    comes with its [2, Q] ``qscales`` (and may run ``int8_compute``);
    ``tile`` is the backward's tile request, resolved per block as on the
    whole queue. Returns the checks."""
    from vlsfr_tpu_torch.ops import twin_margin as ttm
    from vlsfr_tpu_torch.ops.qqueue import quantize_rows
    from vlsfr_tpu_torch.parallel._shard_common import merge_partials, owner_tail
    from vlsfr_tpu_torch.parallel.sharded_quad import shard_inputs

    b, q = emb_x.shape[0], queue.shape[1]
    lt, mg, k = kw["loss_type"], kw["margin"], kw["k"]
    qs = qscales
    packed = ttm.pack_dirs(emb_x, emb_y, ttm.dir_inputs(queue, g_a, *plan_a, qs),
                           ttm.dir_inputs(queue, g_b, *plan_b, qs), labels_a, labels_b,
                           ttm.compute_twin_gt(emb_x, queue, g_a, *plan_a, labels_a, qs),
                           ttm.compute_twin_gt(emb_y, queue, g_b, *plan_b, labels_b, qs))
    E, rest, labels = packed[0], packed[1:], packed[6]
    fkw = dict(qscales=None if qs is None else qs[0],
               e8=quantize_rows(E) if int8_compute else None)
    ce_w, neg_w, logz_w, topk_w = ttm.quad_fwd(E, queue, *rest, b=b, **kw, **fkw)
    c_local = q // n_shards
    blocks = [queue[:, j * c_local:(j + 1) * c_local] for j in range(n_shards)]
    sis = [shard_inputs(emb_x, emb_y, q_l, j * c_local, g_a, g_b, plan_a, plan_b, labels_a,
                        labels_b, None if qs is None else qs[:, j * c_local:(j + 1) * c_local],
                        int8_compute)
           for j, q_l in enumerate(blocks)]
    gt = sum(si.gt_parts for si in sis)
    pos = labels >= 0
    # the kernels' block states, merged: the global logz and kth every
    # block's backward takes
    states = [ttm.quad_partial_fwd(*si.kernel_args(q_l), gt, b=b, bp=b, **kw, **si.form_kw())
              for si, q_l in zip(sis, blocks)]
    m, s, t = merge_partials(*(torch.stack(x) for x in zip(*states)), k)
    ce, neg, logz, topk = ttm.finalize_fwd(m, s, t, labels, gt, loss_type=lt, margin=mg,
                                           scale=kw["scale"])
    kth = topk[:, :, -1].contiguous()
    checks, d_tot, dgt_sum = [], 0.0, 0.0
    for j, (si, q_l) in enumerate(zip(sis, blocks)):
        c, (d_k, g_k) = quad_partial_checks(si, q_l, gt, logz, kth, dce, dneg, kw,
                                            tag=f"block {j}/{n_shards} ", tile=tile)
        checks += c
        d_tot, dgt_sum = d_tot + d_k, dgt_sum + g_k
    for si in sis:  # each owner's tail, from the summed d_gt
        d_tot = owner_tail(d_tot, dgt_sum, gt, si.owned, si.r0e, si.rbe, lt, mg)
    d_w, dgt_w = ttm.quad_bwd(E, queue, *rest, logz_w, topk_w[:, :, -1].contiguous(), dce, dneg,
                              b=b, **kw, **fkw, tile=tile)
    sa, sb = slice(0, b), slice(b, 2 * b)
    d_whole = torch.cat([
        ttm.twin_gt_tail(emb_x, queue, g_a, *plan_a, labels_a, packed[7][0, sa], packed[7][1, sa],
                         dgt_w[0, sa], dgt_w[1, sa], d_w[sa], lt, mg, qs),
        ttm.twin_gt_tail(emb_y, queue, g_b, *plan_b, labels_b, packed[7][0, sb], packed[7][1, sb],
                         dgt_w[0, sb], dgt_w[1, sb], d_w[sb], lt, mg, qs)]).float()
    tag = f"{n_shards} blocks merged vs the whole queue: "
    checks += [
        _err(tag + "ce", ce, ce_w, 1e-4), _err(tag + "neg", neg, neg_w, 1e-4),
        _err(tag + "logz (in-pool rows)", logz[:, pos], logz_w[:, pos], 1e-4),
        _err(tag + "top-k", topk, topk_w, 1e-5),
        _err(tag + "d_gt", dgt_sum, dgt_w, 1e-5),
        _err(tag + "d_emb with the owners' tails", d_tot, d_whole,
             1e-4 * float(d_whole.abs().max()))]
    return checks


def twin_checks(queue, inputs, kw: dict, dce, dneg, tag: str = "", tile: int = 512):
    """``twin_fwd`` / ``twin_bwd`` against their plain versions on one
    direction's inputs (E, G, V, rows, cols, blend, labels, gt), with the
    quad's limits: ce / neg / logz 1e-4, top-k 1e-5, d_gt 1e-5, d_emb 1e-4
    × its max on an f32 queue and ``rounded_demb`` on a bf16 one. Returns
    (checks, the plain forward's outputs)."""
    from vlsfr_tpu_torch.ops import twin_margin as ttm

    E, rest = inputs[0], inputs[1:]
    got = ttm.twin_fwd(E, queue, *rest, **kw)
    want = ttm.twin_fwd_plain(E, queue, *rest, **kw)
    checks = [_err(f"{tag}{name}", g, w, tol) for name, g, w, tol in
              zip(("ce", "neg", "logz", "top-k"), got, want, (1e-4, 1e-4, 1e-4, 1e-5))]
    logz, kth = want[2], want[3][:, :, -1].contiguous()
    d_k, g_k = ttm.twin_bwd(E, queue, *rest, logz, kth, dce, dneg, **kw, tile=tile)
    d_p, g_p = ttm.twin_bwd_plain(E, queue, *rest, logz, kth, dce, dneg, **kw, tile=tile)
    checks += demb_checks(f"{tag}d_emb", d_k, d_p, queue.dtype)
    checks.append(_err(f"{tag}d_gt", g_k, g_p, 1e-5))
    return checks, want


def twin_shard_checks(emb, queue, g, plan, labels, dce, dneg, kw: dict, n_shards: int,
                      tile: int = 512):
    """The sharded twin head emulated in one process, as
    ``quad_shard_checks``: each block's twin partial kernels against their
    plain versions (the state as the quad partials', d_emb by
    ``demb_checks``, raw d_gt 1e-5), and the blocks merged
    (``merge_partials``, ``finalize_twin``; summed d_gt and d_emb with the
    owners' tails) against ``twin_fwd`` / ``twin_bwd`` + tail on the whole
    queue: ce / neg / logz (in-pool rows) 1e-4, top-k 1e-5, d_gt 1e-5,
    d_emb 1e-4 × its max (f32) or ``rounded_demb`` (bf16). ``dce`` /
    ``dneg`` are [2, b], masked with the positive rows. Returns the
    checks."""
    from vlsfr_tpu_torch.ops import twin_margin as ttm
    from vlsfr_tpu_torch.parallel._shard_common import merge_partials, owner_tail
    from vlsfr_tpu_torch.parallel.sharded_twin import twin_shard_inputs

    q = queue.shape[1]
    lt, mg, k = kw["loss_type"], kw["margin"], kw["k"]
    lab = labels.to(torch.int32)
    g32, rows_i, cols_i, v, blend = ttm.dir_inputs(queue, g, *plan)
    gt_w = torch.stack(ttm.compute_twin_gt(emb, queue, g, *plan, labels))
    whole_in = (emb.float().contiguous(), g32, v, rows_i, cols_i, blend.to(torch.int32), lab,
                gt_w)
    ce_w, neg_w, logz_w, topk_w = ttm.twin_fwd(whole_in[0], queue, *whole_in[1:], **kw)
    c_local = q // n_shards
    blocks = [queue[:, j * c_local:(j + 1) * c_local] for j in range(n_shards)]
    sis = [twin_shard_inputs(emb, q_l, j * c_local, g, *plan, labels)
           for j, q_l in enumerate(blocks)]
    gt = sum(si.gt_parts for si in sis)
    pos = lab >= 0
    checks = []
    states = []
    for j, (si, q_l) in enumerate(zip(sis, blocks)):
        args = si.kernel_args(q_l)
        m_k, s_k, t_k = ttm.twin_partial_fwd(*args, gt, **kw)
        m_p, s_p, t_p = ttm.twin_partial_fwd_plain(*args, gt, **kw)
        seen = s_p > 0
        tag = f"block {j}/{n_shards} "
        checks += [
            {"name": f"{tag}partial rows with a column", "limit": 0.0,
             "err": float((seen != (s_k > 0)).sum())},
            _err(f"{tag}partial m + log s", (m_k + torch.log(s_k))[seen],
                 (m_p + torch.log(s_p))[seen], 1e-4),
            _err(f"{tag}partial top-k", t_k, t_p, 1e-5)]
        states.append((m_k, s_k, t_k))
    m, s, t = merge_partials(*(torch.stack(x) for x in zip(*states)), k)
    ce, neg, logz, topk = ttm.finalize_twin(m, s, t, lab, gt, loss_type=lt, margin=mg,
                                            scale=kw["scale"])
    kth = topk[:, :, -1].contiguous()
    d_tot, dgt_sum = 0.0, 0.0
    for j, (si, q_l) in enumerate(zip(sis, blocks)):
        args = (*si.kernel_args(q_l), gt, logz, kth, dce, dneg)
        d_k, g_k = ttm.twin_partial_bwd(*args, **kw, tile=tile)
        d_p, g_p = ttm.twin_partial_bwd_plain(*args, **kw, tile=tile)
        tag = f"block {j}/{n_shards} "
        checks += demb_checks(f"{tag}partial d_emb", d_k, d_p, q_l.dtype)
        checks.append(_err(f"{tag}partial d_gt", g_k, g_p, 1e-5))
        d_tot, dgt_sum = d_tot + d_k, dgt_sum + g_k
    for si in sis:  # each owner's tail, from the summed d_gt
        d_tot = owner_tail(d_tot, dgt_sum, gt, si.owned, si.r0e, si.rbe, lt, mg)
    d_w, dgt_w = ttm.twin_bwd(whole_in[0], queue, *whole_in[1:], logz_w,
                              topk_w[:, :, -1].contiguous(), dce, dneg, **kw, tile=tile)
    d_whole = ttm.twin_gt_tail(emb, queue, g, *plan, labels, gt_w[0], gt_w[1], dgt_w[0],
                               dgt_w[1], d_w, lt, mg).float()
    tag = f"{n_shards} blocks merged vs the whole queue: "
    checks += [
        _err(tag + "ce", ce, ce_w, 1e-4), _err(tag + "neg", neg, neg_w, 1e-4),
        _err(tag + "logz (in-pool rows)", logz[:, pos], logz_w[:, pos], 1e-4),
        _err(tag + "top-k", topk, topk_w, 1e-5),
        _err(tag + "d_gt", dgt_sum, dgt_w, 1e-5),
        *demb_checks(tag + "d_emb with the owners' tails", d_tot, d_whole, queue.dtype)]
    return checks


def margin_partial_checks(emb, w_l, ll, gt, logz, kth, d_ce, d_neg, d_wl, kw: dict,
                          tag: str = ""):
    """Both partial margin_ce kernels against their plain versions on one
    block ``w_l`` with block-local labels ``ll``, the global gt / logz /
    kth, cotangents masked with the global positive rows and the owner's
    label-row gradient ``d_wl``. Returns (checks, the kernel's (m, s, topk),
    the kernel's (d_emb, d_w))."""
    from vlsfr_tpu_torch.ops import margin_stream as tms

    m_k, s_k, t_k = tms.margin_partial_fwd(emb, w_l, ll, gt, **kw)
    checks = partial_state_checks((m_k, s_k, t_k),
                                  tms.margin_partial_fwd_plain(emb, w_l, ll, gt, **kw),
                                  kw["scale"], tag)
    args = (emb, w_l, ll, gt, logz, kth, d_ce, d_neg, d_wl)
    cos = tms.clean_cos(emb, w_l) if w_l.dtype == torch.bfloat16 else None  # module docstring
    d_k, w_k, g_k = tms.margin_partial_bwd(*args, **kw)
    d_p, w_p, g_p = tms.margin_partial_bwd_plain(*args, cos=cos, **kw)
    del cos
    if w_l.dtype == torch.bfloat16:  # the bf16 form (module docstring)
        checks += softmax_demb(f"{tag}partial d_emb", d_k, d_p, cols=w_l.shape[0])
        checks += rounded_rows(f"{tag}partial d_w", w_k, w_p, w_p, ll)
    else:
        checks.append(_err(f"{tag}partial d_emb", d_k, d_p, 1e-4 * float(d_p.abs().max())))
        checks += by_rows(f"{tag}partial d_w", w_k, w_p, w_p, ll, 1e-4)
    del w_p
    checks.append(_err(f"{tag}partial d_gt_raw", g_k, g_p,
                       1e-5 * max(1.0, float(g_p.abs().max()))))
    return checks, (m_k, s_k, t_k), (d_k, w_k)


def margin_shard_checks(emb, w, labels, d_ce, d_neg, kw: dict, n_shards: int):
    """The class-sharded softmax head emulated in one process: ``w`` cut
    into ``n_shards`` blocks (C divisible by it, as the mesh requires), the
    owners' target cosines summed (the all_reduce), each block's partial
    kernels held to their plain versions (``margin_partial_checks``), the
    block states merged (``merge_partials``, the all_gather) and the blocks'
    d_emb with the owners' tails summed (the all_reduce), against
    ``margin_ce_fwd`` / ``margin_ce_bwd`` on the whole classifier; each
    block's d_w against the whole d_w's rows, by row set (a bf16
    classifier's whole d_w from the merged (gt, logz, top-k), module
    docstring). Returns (checks, the merged (gt, logz, topk) every block's
    backward takes)."""
    from vlsfr_tpu_torch.ops import margin_stream as tms
    from vlsfr_tpu_torch.parallel._shard_common import localize_labels, merge_partials

    c = w.shape[0]
    if c % n_shards:
        raise ValueError(f"{c} classes do not split into {n_shards} blocks")
    cl = c // n_shards
    lt = dict(loss_type=kw["loss_type"], margin=kw["margin"], scale=kw["scale"])
    gt_w = tms.compute_gt(emb, w, labels)
    ce_w, neg_w, logz_w, topk_w = tms.margin_ce_fwd(emb, w, labels, gt_w, **kw)
    de_w, dw_w = tms.margin_ce_bwd(emb, w, labels, gt_w, logz_w, topk_w, d_ce, d_neg, **kw)
    pos = labels >= 0
    d_ce_m, d_neg_m = tms._mask_cotangents(pos, d_ce, d_neg)
    term_w, _ = tms._target_rows(emb, w, labels, gt_w, logz_w, d_ce_m, **lt)
    blocks = [(w[j * cl:(j + 1) * cl], *localize_labels(j * cl, cl, labels))
              for j in range(n_shards)]
    gt = sum(torch.where(owned, tms.compute_gt(emb, blk, ll), 0.0) for blk, ll, owned in blocks)
    states = [tms.margin_partial_fwd(emb, blk, ll, gt, **kw) for blk, ll, _ in blocks]
    m, s, topk = merge_partials(*(torch.stack(x) for x in zip(*states)), kw["k"])
    logz = m + torch.log(s)
    ce, neg = tms.ce_and_neg(logz, topk, labels, gt, **lt)
    kth = topk[:, -1].contiguous()
    if w.dtype == torch.bfloat16:  # the whole d_w from the blocks' inputs
        del dw_w
        _, dw_w = tms.margin_ce_bwd(emb, w, labels, gt, logz, topk, d_ce, d_neg, **kw)
    checks, d_tot = [], 0.0
    for j, (blk, ll, _) in enumerate(blocks):
        term, d_wl = tms._target_rows(emb, blk, ll, gt, logz, d_ce_m, **lt)
        tag = f"block {j}/{n_shards} "
        c_j, _, (d_k, w_k) = margin_partial_checks(emb, blk, ll, gt, logz, kth, d_ce_m, d_neg_m,
                                                   d_wl.contiguous(), kw, tag=tag)
        checks += c_j
        d_tot = d_tot + d_k + term
        rows = dw_w[j * cl:(j + 1) * cl]
        if w.dtype == torch.bfloat16:
            checks += rounded_rows(f"{tag}d_w vs the whole d_w (merged inputs)", w_k, rows,
                                   rows, ll)
        else:
            checks += by_rows(f"{tag}d_w vs the whole d_w", w_k, rows, rows, ll, 1e-4)
        del w_k
    tag = f"{n_shards} blocks merged vs the whole classifier: "
    checks += [_err(tag + "ce", ce, ce_w, 1e-4), _err(tag + "neg", neg, neg_w, 1e-4),
               _err(tag + "logz", logz, logz_w, 1e-4), _err(tag + "top-k", topk, topk_w, 1e-5),
               whole(tag + "d_emb with the owners' tails", d_tot, de_w, de_w - term_w, 1e-4)]
    return checks, (gt, logz, topk)


def failures(checks: list[dict]) -> list[dict]:
    """The checks whose error is above its limit (or not finite)."""
    return [c for c in checks if not c["err"] <= c["limit"]]


def describe(c: dict) -> str:
    if c.get("count"):
        extra = "".join(f" ({c[k]:{f}} {what})" for k, f, what in (
            ("changed", ".0f", "changed by the update"), ("max_spacings", ".2f", "spacings at most"))
            if k in c)
        return f"{c['name']}: {c['err']:.0f} <= {c['limit']:.0f}{extra}"
    if c.get("excess"):
        return f"{c['name']}: largest excess {c['err']:.3e} <= {c['limit']:.3e}"
    return f"{c['name']}: max |kernel - plain| {c['err']:.3e} <= {c['limit']:.3e}"


# ----------------------------------------------------------------------
# the 3×3 conv (ops/conv3x3.py) and the matrix-unit probe
# (tools/probe_int8_mxu.py)
# ----------------------------------------------------------------------

CONV_F32_RTOL = 2e-5  # f32 y: × max|y| (f32 sums of 9·C exact products in another order)
# bf16 y: the share of elements that may round to the neighbouring bf16
# value. The kernel's and the plain version's f32 sums differ by ~1e-6 of
# |y| (9·C = 576-1,152 terms in another order), against a bf16 spacing of
# 2^-8..2^-7 of |y|: about 4e-4 of the elements straddle a rounding
# boundary; the limit allows five times that. Where the sum cancels to
# near 0 the two f32 sums differ by more than a spacing of the tiny value,
# so an element is far only beyond one spacing plus the f32 form's limit
CONV_BF16_SHARE = 2e-3
CONV_STATS_RTOL = 1e-5  # Σ against Σ|y|, Σ² against Σy², per channel
PROBE_RTOL = 1e-5  # the probe's f32 sums against Σ|a·w| per output


def conv_checks(y, y_want, stats=None, stats_want=None, tag: str = "") -> list[dict]:
    """conv3x3's output against its plain version: f32 y within
    CONV_F32_RTOL × max|y|; bf16 y within one bf16 spacing of the plain
    value plus CONV_F32_RTOL × max|y| everywhere (the f32 sums' own gap,
    which a sum that cancels keeps after rounding), and at most
    CONV_BF16_SHARE of the elements apart;
    with statistics, Σ within CONV_STATS_RTOL × Σ|y| and Σ² within
    CONV_STATS_RTOL × Σy² in every channel (f32 sums over B·H·W rows in
    another order)."""
    pre = f"{tag} " if tag else ""
    ref = y_want.float()
    if y.dtype == torch.bfloat16:
        diff = (y.float() - ref).abs()
        far = diff > bf16_spacing(ref) + CONV_F32_RTOL * float(ref.abs().max())
        checks = [{"name": f"{pre}y elements more than one bf16 spacing (+ the f32 limit) apart",
                   "count": True, "err": float(far.sum()), "limit": 0.0},
                  {"name": f"{pre}y elements apart", "count": True,
                   "err": float((diff > 0).sum()),
                   "limit": float(int(CONV_BF16_SHARE * diff.numel()))}]
    else:
        checks = [_err(f"{pre}y", y, ref, CONV_F32_RTOL * float(ref.abs().max()))]
    if stats is None:
        return checks
    rows = ref.reshape(-1, ref.shape[-1])
    for name, got, want, scale, of in (
            ("Σ", stats[0], stats_want[0], rows.abs().sum(0), "Σ|y|"),
            ("Σ²", stats[1], stats_want[1], rows.square().sum(0), "Σy²")):
        checks.append({"name": f"{pre}{name} per channel, relative to {of}",
                       "err": float(((got - want).abs() / scale).max()),
                       "limit": CONV_STATS_RTOL})
    return checks


def probe_checks(kind: str, got, want, a, w, tag: str = "") -> list[dict]:
    """The probe's output against its plain version: int8 bit for bit (a
    count of elements that differ, limit 0); the bf16 forms within
    PROBE_RTOL × Σ_i Σ_d |a·w| of each output (exact products summed in f32
    in another order)."""
    pre = f"{tag} " if tag else ""
    if kind == "int8":
        return [{"name": f"{pre}int8 o elements differing", "count": True,
                 "err": float((got != want).sum()), "limit": 0.0}]
    w_abs = torch.zeros(w.shape[1:], dtype=torch.float32, device=w.device)
    for i in range(w.shape[0]):
        w_abs += w[i].float().abs()
    scale = a.float().abs() @ w_abs.T
    return [{"name": f"{pre}{kind} o relative to Σ|a·w|",
             "err": float(((got - want).abs() / scale.clamp(min=1e-30)).max()),
             "limit": PROBE_RTOL}]
