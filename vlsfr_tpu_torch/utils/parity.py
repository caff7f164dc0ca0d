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

Used by ``chip_smoke.py`` and the tests in ``tests/test_torch_kernels.py``.
"""

from __future__ import annotations

import torch

F32_EPS = torch.finfo(torch.float32).eps


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


def by_rows(name: str, got, want, ref, labels, rtol: float, rounding: float = 0.0) -> list[dict]:
    """max |got − want| on the label rows and on the other rows of [C, D]
    tensors, each against rtol × max |ref| + rounding × eps × max |want|
    over the same rows. One entry per non-empty row set, with the set's
    max |ref| and max |want| beside its error and limit."""
    err = (got - want).abs().amax(dim=1)
    ref_max = ref.abs().amax(dim=1)
    out_max = want.abs().amax(dim=1)
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
                         sgd: dict) -> tuple[list[dict], list[dict]]:
    """The margin_ce backward kernels against their plain versions on one
    case, from the forward's ``logz`` / ``topk``: (``margin_ce_bwd``'s
    checks — d_emb without and with d_w, and d_w by row set; the fused
    kernel's — d_emb, then w' and mom' by row set). d_emb is held to its
    streamed part, 1e-4 × max|d_emb − the target term|; d_w to 1e-4 × the
    set's max|d_w|; w' and mom' as ``sgd_update``. W and mom are updated in
    place by the fused kernel; the plain version gets clones taken before."""
    from vlsfr_tpu_torch.ops import margin_stream as tms

    emb_term, _ = tms._target_rows(emb, w, labels, gt, logz, d_ce, loss_type=kw["loss_type"],
                                   margin=kw["margin"], scale=kw["scale"])
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


def failures(checks: list[dict]) -> list[dict]:
    """The checks whose error is above its limit (or not finite)."""
    return [c for c in checks if not c["err"] <= c["limit"]]


def describe(c: dict) -> str:
    return f"{c['name']}: max |kernel - plain| {c['err']:.3e} <= {c['limit']:.3e}"
