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
(``rounded_demb``): at most STRADDLE_ROWS = 8 rows may be further than
DEMB_TIGHT = 1e-5 × max from the plain version, and no row further than
ROUNDED_DEMB_RTOL = 2^-7 × max (one bf16 ulp of two such terms). A kernel
that skips a rounding moves most rows by ~2^-9 of their terms and fails
the first part. On an H100 over chip_smoke.py's phase-21 and phase-23
cases (256 rows) the kernels put at most 3 rows beyond 1e-5 × max; copies
that skip the clean tiles' or the bf16 written tiles' rounding put tens
to hundreds there (``tests/test_torch_kernels.py::
test_form_checks_reject_planted_faults`` plants both).

The int8-compute dot is an exact integer sum (``int8_dot_checks``): the
kernels' own clean cosines (``ops/twin_margin.clean_cos``, the tile code
the forward and the backward's recompute run) with unit scales are f32 of
the raw int32 accumulator and equal the integer product bit for bit; with
the real scales they equal the plain version's f32(acc) · (se · s) bit for
bit.

Used by ``chip_smoke.py`` and the tests in ``tests/test_torch_kernels.py``.
"""

from __future__ import annotations

import torch

F32_EPS = torch.finfo(torch.float32).eps
# d_emb of the bf16 / int8 quad forms (module docstring, ``rounded_demb``)
ROUNDED_DEMB_RTOL = 2.0**-7
DEMB_TIGHT = 1e-5
STRADDLE_ROWS = 8


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
    labels (one block of a class-sharded classifier)."""
    from vlsfr_tpu_torch.ops import margin_stream as tms

    d_ce_m, _ = tms._mask_cotangents(tms._positive(labels, pos_rows), d_ce, d_neg)
    emb_term, _ = tms._target_rows(emb, w, labels, gt, logz, d_ce_m, loss_type=kw["loss_type"],
                                   margin=kw["margin"], scale=kw["scale"])
    kw = dict(kw, pos_rows=pos_rows)
    bwd = []
    for grad_w in (False, True):
        de_k, dw_k = tms.margin_ce_bwd(emb, w, labels, gt, logz, topk, d_ce, d_neg,
                                       grad_w=grad_w, **kw)
        de_p, dw_p = tms.margin_ce_bwd_plain(emb, w, labels, gt, logz, topk, d_ce, d_neg,
                                             grad_w=grad_w, **kw)
        bwd.append(whole(f"d_emb (grad_w={grad_w})", de_k, de_p, de_p - emb_term, 1e-4))
        if grad_w:
            bwd += by_rows("d_w", dw_k, dw_p, dw_p, labels, 1e-4)
        elif dw_k is not None or dw_p is not None:
            raise RuntimeError("margin_ce_bwd returned a d_w with grad_w=False")
        del dw_k, dw_p
    w_p, mom_p, mom0 = w.clone(), mom.clone(), mom.clone()
    de_k, w_k, mom_k = tms.margin_ce_bwd_fused_sgd(emb, w, mom, labels, gt, logz, topk, d_ce,
                                                   d_neg, lr, **sgd, **kw)
    de_p, w_p, mom_p = tms.margin_ce_bwd_fused_sgd_plain(emb, w_p, mom_p, labels, gt, logz, topk,
                                                         d_ce, d_neg, lr, **sgd, **kw)
    if w_k.data_ptr() != w.data_ptr() or mom_k.data_ptr() != mom.data_ptr():
        raise RuntimeError("margin_ce_bwd_fused_sgd did not update W and mom in place")
    fused = [whole("fused d_emb", de_k, de_p, de_p - emb_term, 1e-4)]
    return bwd, fused + sgd_update(w_k, mom_k, w_p, mom_p, mom0, labels, lr, sgd["momentum"])


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
    sde_p, _, dgt_p = tms._sparse_parts_plain(*args, tile=tile, **kw)
    de_k, dw_k = tms.margin_ce_bwd_sparse(*args, tile=tile, **kw)
    de_p, dw_p = tms.margin_ce_bwd_sparse_plain(*args, tile=tile, **kw)
    out = [whole("sparse d_emb", de_k, de_p, sde_p, 1e-4)]
    out += by_rows("sparse d_w", dw_k, dw_p, dw_p, labels, 1e-4,
                   is_label=sparse_label_rows(labels, tile_idx, tile))
    del dw_k, dw_p
    sde_k, _, dgt_k = tms._sparse_parts_cuda(*args, tile=tile, **kw)
    out.append(whole("sparse d_emb (streamed)", sde_k, sde_p, sde_p, 1e-4))
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
    checks = [{"name": name, "err": float((g - wn).abs().max()), "limit": tol}
              for name, g, wn, tol in zip(("ce", "neg", "logz", "topk"), got, want,
                                          (1e-4, 1e-4, 1e-4, 1e-5))]
    checks += fwd_stats_checks(got[4], got[5], want[4], want[5], kw["scale"])
    _, _, logz, topk, maxz, maxcos = want
    tile_idx, _ = tms.select_relevant_tiles(maxz, maxcos, logz, topk, labels, m_tiles, tile, u=u,
                                            pos_rows=pos_rows)
    checks += margin_ce_bwd_sparse_checks(emb, w, labels, gt, logz, topk, d_ce, d_neg, tile_idx,
                                          kw, tile, pos_rows=pos_rows)
    return checks, tile_idx, (gt, logz, topk)


def _err(name: str, got, want, limit: float) -> dict:
    return {"name": name, "err": float((got - want).abs().max()) if got.numel() else 0.0,
            "limit": limit}


def quad_checks(queue, packed, kw: dict, dce, dneg, tag: str = ""):
    """``quad_fwd`` / ``quad_bwd`` against their plain versions on one case
    in the packed layout (``kw`` holds the form's ``qscales`` / ``e8``).
    Returns (checks, the plain forward's outputs)."""
    from vlsfr_tpu_torch.ops import twin_margin as ttm

    E, rest = packed[0], packed[1:]
    got = ttm.quad_fwd(E, queue, *rest, **kw)
    want = ttm.quad_fwd_plain(E, queue, *rest, **kw)
    checks = [_err(f"{tag}{name}", g, w, tol) for name, g, w, tol in
              zip(("ce", "neg", "logz", "top-k"), got, want, (1e-4, 1e-4, 1e-4, 1e-5))]
    logz, kth = want[2], want[3][:, :, -1].contiguous()
    d_k, g_k = ttm.quad_bwd(E, queue, *rest, logz, kth, dce, dneg, **kw)
    d_p, g_p = ttm.quad_bwd_plain(E, queue, *rest, logz, kth, dce, dneg, **kw)
    checks += demb_checks(f"{tag}d_emb", d_k, d_p, queue.dtype)
    checks.append(_err(f"{tag}d_gt", g_k, g_p, 1e-5))
    return checks, want


def demb_checks(name: str, got, want, dtype) -> list[dict]:
    """A quad backward's d_emb against the plain one: 1e-4 × its max on an
    f32 queue, ``rounded_demb`` on the others."""
    if dtype == torch.float32:
        return [_err(name, got, want, 1e-4 * float(want.abs().max()))]
    return rounded_demb(name, got, want)


def rounded_demb(name: str, got, want) -> list[dict]:
    """d_emb of a rounded quad form in two parts (module docstring): the
    count of rows further than DEMB_TIGHT × max |want| from the plain
    version, at most STRADDLE_ROWS, and the largest error of any row, at
    most ROUNDED_DEMB_RTOL × max |want|."""
    top = float(want.abs().max())
    row_err = (got - want).abs().amax(dim=1)
    return [{"name": f"{name} rows beyond {DEMB_TIGHT:g} x max", "count": True,
             "err": float((row_err > DEMB_TIGHT * top).sum()), "limit": float(STRADDLE_ROWS)},
            {"name": name, "err": float(row_err.max()), "limit": ROUNDED_DEMB_RTOL * top}]


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


def quad_partial_checks(si, q_l, gt, logz, kth, dce, dneg, kw: dict, tag: str = ""):
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
    d_k, g_k = ttm.quad_partial_bwd(*args, gt, logz, kth, dce, dneg, **pkw)
    d_p, g_p = ttm.quad_partial_bwd_plain(*args, gt, logz, kth, dce, dneg, **pkw)
    checks += demb_checks(f"{tag}partial d_emb", d_k, d_p, q_l.dtype)
    checks.append(_err(f"{tag}partial d_gt", g_k, g_p, 1e-5))
    return checks, (d_k, g_k)


def quad_shard_checks(emb_x, emb_y, queue, g_a, g_b, plan_a, plan_b, labels_a, labels_b, dce,
                      dneg, kw: dict, n_shards: int, qscales=None, int8_compute=False):
    """The sharded quad head emulated in one process: ``queue`` cut into
    ``n_shards`` blocks, the gt parts summed (the all_reduce), each block's
    partial kernels held to their plain versions, the block states merged
    (``merge_partials``, the all_gather) and finalized, and the summed d_gt
    and d_emb with the owners' tails (the backward's all_reduces), against
    ``quad_fwd`` / ``quad_bwd`` + tail on the whole queue. ``dce`` /
    ``dneg`` are [2, 2b], masked with the positive rows. An int8 queue
    comes with its [2, Q] ``qscales`` (and may run ``int8_compute``).
    Returns the checks."""
    from vlsfr_tpu_torch.ops import twin_margin as ttm
    from vlsfr_tpu_torch.ops.qqueue import quantize_rows
    from vlsfr_tpu_torch.parallel._shard_common import merge_partials
    from vlsfr_tpu_torch.parallel.sharded_quad import owner_tail, shard_inputs

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
                                                tag=f"block {j}/{n_shards} ")
        checks += c
        d_tot, dgt_sum = d_tot + d_k, dgt_sum + g_k
    for si in sis:  # each owner's tail, from the summed d_gt
        d_tot = owner_tail(d_tot, dgt_sum, gt, si, lt, mg)
    d_w, dgt_w = ttm.quad_bwd(E, queue, *rest, logz_w, topk_w[:, :, -1].contiguous(), dce, dneg,
                              b=b, **kw, **fkw)
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


def margin_partial_checks(emb, w_l, ll, gt, logz, kth, d_ce, d_neg, d_wl, kw: dict,
                          tag: str = ""):
    """Both partial margin_ce kernels against their plain versions on one
    block ``w_l`` with block-local labels ``ll``, the global gt / logz /
    kth, cotangents masked with the global positive rows and the owner's
    label-row gradient ``d_wl``. Returns (checks, the kernel's (m, s, topk),
    the kernel's (d_emb, d_w))."""
    from vlsfr_tpu_torch.ops import margin_stream as tms

    m_k, s_k, t_k = tms.margin_partial_fwd(emb, w_l, ll, gt, **kw)
    m_p, s_p, t_p = tms.margin_partial_fwd_plain(emb, w_l, ll, gt, **kw)
    seen = s_p > 0
    checks = [
        {"name": f"{tag}partial rows with a column", "limit": 0.0,
         "err": float((seen != (s_k > 0)).sum())},
        _err(f"{tag}partial m", m_k[seen], m_p[seen], kw["scale"] * 1e-5),
        _err(f"{tag}partial m + log s", (m_k + torch.log(s_k))[seen],
             (m_p + torch.log(s_p))[seen], 1e-4),
        _err(f"{tag}partial top-k", t_k, t_p, 1e-5)]
    args = (emb, w_l, ll, gt, logz, kth, d_ce, d_neg, d_wl)
    d_k, w_k, g_k = tms.margin_partial_bwd(*args, **kw)
    d_p, w_p, g_p = tms.margin_partial_bwd_plain(*args, **kw)
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
    block's d_w against the whole d_w's rows, by row set. Returns (checks,
    the merged (gt, logz, topk) every block's backward takes)."""
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
    checks, d_tot = [], 0.0
    for j, (blk, ll, _) in enumerate(blocks):
        term, d_wl = tms._target_rows(emb, blk, ll, gt, logz, d_ce_m, **lt)
        tag = f"block {j}/{n_shards} "
        c_j, _, (d_k, w_k) = margin_partial_checks(emb, blk, ll, gt, logz, kth, d_ce_m, d_neg_m,
                                                   d_wl.contiguous(), kw, tag=tag)
        checks += c_j
        d_tot = d_tot + d_k + term
        rows = dw_w[j * cl:(j + 1) * cl]
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
        return f"{c['name']}: {c['err']:.0f} <= {c['limit']:.0f}"
    return f"{c['name']}: max |kernel - plain| {c['err']:.3e} <= {c['limit']:.3e}"
