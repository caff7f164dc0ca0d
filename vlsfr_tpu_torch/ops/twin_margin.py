"""The fused quad FFC head: both directions × both queue views in one pass
over q0 per forward and per backward (port of the quad part of
``vlsfr_tpu/ops/twin_margin.py``).

Each FFC step scores two probes (direction A: probe(x) vs the writes of
gallery(y); direction B: probe(y) vs gallery(x)) against two views of the
post-write queue: view 1 is row 0 after this step's writes, view 2 the
parity blend (slots written with ``seen`` read row 1). Both views differ
from q0 only at this step's ≤ B written slots per direction, so q1 is
never streamed: view 2's values at written slots are the B-row ``v`` of
``twin_write_values``. Duplicate writes to one slot resolve to the highest
batch index (the reference's sequential last-write-wins).

Kernel boundary. ``quad_fwd`` / ``quad_bwd`` work on the PACKED layout:
both directions' probes stacked into ``E`` [R = 2b, D] (rows [0, b) are
direction A, [b, 2b) direction B), with ``G``, ``V``, ``rows``, ``cols``,
``blend``, ``labels`` stacked the same way and per-view row vectors as
[2, R] (index 0 = view 1, 1 = view 2). For CUDA tensors they launch the
hand-written kernels in ``csrc/quad_margin.cu``; for CPU tensors they run
the plain PyTorch versions beside them (``quad_fwd_plain`` /
``quad_bwd_plain``). There is no other route and no switch.

Around the kernels, as in JAX, plain torch computes the target cosines
(``compute_twin_gt``), the write values (``dir_inputs``) and the φ'(gt)
tail of the gradient (``twin_gt_tail``) — all B-row work.

The negative stream. Every loss type's logsumexp is split into the
NON-target columns (streamed, target excluded) and the target term
``scale·φ(gt)`` joined analytically at the end — the scan reference
(``_twin_stream_fwd``) puts φ(gt) at the target column, which is the same
sum. The top-k of hard negatives also excludes the target, so the
train-accuracy hit test ``gt + KTH_TIE_TOL >= topk[:, 0]`` never compares
gt against a recomputation of itself.
"""

from __future__ import annotations

import ctypes
import math

import torch

from vlsfr_tpu_torch.ops.margin import (
    KTH_TIE_TOL,
    LOSS_TYPES,
    NEG_INF,
    _f32,
    phi_prime,
    phi_target,
    sv_boost,
)

KMAX = 16  # largest hard_neg the kernels keep a register top-k for
LAUNCH_COUNTS = {"quad_fwd": 0, "quad_bwd": 0}


def reset_launch_counts() -> None:
    for name in LAUNCH_COUNTS:
        LAUNCH_COUNTS[name] = 0


# ----------------------------------------------------------------------
# B-row helpers (plain torch on every device, as XLA ops in JAX)
# ----------------------------------------------------------------------


def twin_write_values(q1_rows, g32, rows_i, cols_i, seen_f):
    """Per-write view-2 values: ``v[i] = g[last parity-1 writer of
    cols[i]]`` if one exists, else ``q1[cols[i]]``; ``blend_b[i]`` = 1 if
    any write to the slot has ``seen > 0``. Entries sharing a slot get the
    same (v, blend_b)."""
    b = cols_i.shape[0]
    same = cols_i[:, None] == cols_i[None, :]
    i_iota = torch.arange(b, device=cols_i.device)
    win1 = torch.where(same & (rows_i[None, :] == 1), i_iota[None, :],
                       torch.full_like(same, -1, dtype=torch.long)).max(dim=1).values
    v = torch.where(win1[:, None] >= 0, g32[win1.clamp(min=0)], q1_rows.float())
    blend_b = (same & (seen_f[None, :] > 0)).any(dim=1).to(torch.int32)
    return v, blend_b


def effective_rows(w0, w1, col_ids, g, rows, cols, seen):
    """Rows of both effective views at slots ``col_ids``: view 1 = row 0
    with parity-0 writes applied, view 2 = the parity blend (row 1 with
    parity-1 writes where any write saw the slot). Highest batch index
    wins among duplicate writes."""
    match = col_ids[:, None] == cols[None, :]  # [T, B]
    i_iota = torch.arange(cols.shape[0], device=cols.device)
    none = torch.full_like(match, -1, dtype=torch.long)

    def override(base, parity):
        last = torch.where(match & (rows[None, :] == parity), i_iota[None, :], none)
        last = last.max(dim=1).values
        return torch.where(last[:, None] >= 0, g[last.clamp(min=0)], base)

    w0_eff = override(w0, 0)
    w1_eff = override(w1, 1)
    hit = (match & (seen[None, :] > 0)).any(dim=1)
    return w0_eff, torch.where(hit[:, None], w1_eff, w0_eff)


def _label_rows(queue, g, rows, cols, seen, labels):
    safe = labels.clamp(min=0).long()
    r0 = queue[0][safe].float()  # B-row gathers; the planes are never copied
    r1 = queue[1][safe].float()
    return effective_rows(r0, r1, safe, g.float(), rows.long(), cols.long(), seen.float())


def compute_twin_gt(emb, queue, g, rows, cols, seen, labels):
    """(gt1, gt2): target cosines against both effective views."""
    r0_eff, rb_eff = _label_rows(queue, g, rows, cols, seen, labels)
    e = emb.float()
    return (e * r0_eff).sum(-1), (e * rb_eff).sum(-1)


def twin_gt_tail(emb, queue, g, rows, cols, seen, labels, gt1, gt2, dgt1, dgt2, d_emb,
                 loss_type, margin):
    """Route the φ'(gt)·d_gt paths into d_emb via the effective label rows."""
    r0_eff, rb_eff = _label_rows(queue, g, rows, cols, seen, labels)
    pos = (labels >= 0).float()[:, None]
    d_emb = d_emb + (dgt1 * phi_prime(gt1, loss_type, margin))[:, None] * r0_eff * pos
    d_emb = d_emb + (dgt2 * phi_prime(gt2, loss_type, margin))[:, None] * rb_eff * pos
    return d_emb.to(emb.dtype)


def dir_inputs(queue, g, rows, cols, seen):
    """(g32, rows_i, cols_i, v, blend) carrier pack for one direction."""
    cols_i = cols.to(torch.int32)
    rows_i = rows.to(torch.int32)
    g32 = g.float()
    v, blend = twin_write_values(queue[1][cols_i.long()], g32, rows_i, cols_i, seen.float())
    return g32, rows_i, cols_i, v, blend


def reduce_margin_dir(ce1, neg1, ce2, neg2, labels):
    """Per-direction scalar: mean CE over in-pool rows + mean hard-neg
    hinge over outlier rows, summed over the two views."""
    pos = (labels >= 0).float()
    n_pos = pos.sum().clamp(min=1.0)
    n_out = (1.0 - pos).sum().clamp(min=1.0)
    any_pos = pos.sum() > 0
    any_out = (1.0 - pos).sum() > 0
    zero = ce1.new_zeros(())

    def reduce(ce, neg):
        return (torch.where(any_pos, ce.sum() / n_pos, zero)
                + torch.where(any_out, neg.sum() / n_out, zero))

    return reduce(ce1, neg1) + reduce(ce2, neg2)


# ----------------------------------------------------------------------
# plain versions of the two kernels (packed layout, chunked over Q)
# ----------------------------------------------------------------------


def _chunk_writers(rows, cols, blend, b, lo, hi):
    """Per direction, the last parity-0 writer and last blend writer of
    each column in [lo, hi): two [2, hi - lo] int64 arrays, −1 = none."""
    n = hi - lo
    dev = cols.device
    last0 = torch.full((2, n), -1, dtype=torch.long, device=dev)
    lastb = torch.full((2, n), -1, dtype=torch.long, device=dev)
    idx = torch.arange(b, device=dev)
    for d in range(2):
        c = cols[d * b:(d + 1) * b].long() - lo
        inr = (c >= 0) & (c < n)
        for last, sel in ((last0, rows[d * b:(d + 1) * b] == 0),
                          (lastb, blend[d * b:(d + 1) * b] > 0)):
            m = inr & sel
            last[d].scatter_reduce_(0, c[m], idx[m], reduce="amax")
    return last0, lastb


def _written_cos(cos, E, G, V, last0, lastb, b):
    """(view-1 cos, view-2 cos) of one chunk: written columns are replaced
    by the probe's dots with the written rows (g, or v for blend slots)."""
    c1 = cos.clone()
    for d in range(2):
        rs = slice(d * b, (d + 1) * b)
        j0 = torch.nonzero(last0[d] >= 0).flatten()
        if j0.numel():
            c1[rs, j0] = E[rs] @ G[rs][last0[d, j0]].T
    c2 = c1.clone()
    for d in range(2):
        rs = slice(d * b, (d + 1) * b)
        jb = torch.nonzero(lastb[d] >= 0).flatten()
        if jb.numel():
            c2[rs, jb] = E[rs] @ V[rs][lastb[d, jb]].T
    return c1, c2


def quad_fwd_plain(E, q, G, V, rows, cols, blend, labels, gt, *, b, loss_type, margin,
                   scale, k, mask_svfc, chunk=32768):
    """Plain PyTorch version of the forward kernel; same inputs and outputs
    as ``quad_fwd``."""
    r_, _ = E.shape
    n_q = q.shape[1]
    dev = E.device
    m = torch.full((2, r_), -math.inf, device=dev)
    s = torch.zeros((2, r_), device=dev)
    topk = torch.full((2, r_, k), NEG_INF, device=dev)
    for lo in range(0, n_q, chunk):
        hi = min(n_q, lo + chunk)
        cos = E @ q[0, lo:hi].float().T
        last0, lastb = _chunk_writers(rows, cols, blend, b, lo, hi)
        views = _written_cos(cos, E, G, V, last0, lastb, b)
        neg_ok = torch.arange(lo, hi, device=dev)[None, :] != labels[:, None].long()
        for v, cv in enumerate(views):
            mod = sv_boost(cv, gt[v][:, None], margin, mask_svfc)[0] if loss_type == "SV" else cv
            z = torch.where(neg_ok, scale * mod, torch.full_like(mod, -math.inf))
            m_new = torch.maximum(m[v], z.max(dim=1).values)
            ref = torch.where(torch.isinf(m_new), torch.zeros_like(m_new), m_new)
            s[v] = s[v] * torch.exp(m[v] - ref) + torch.exp(z - ref[:, None]).sum(dim=1)
            m[v] = m_new
            cand = torch.where(neg_ok, cv, torch.full_like(cv, NEG_INF))
            topk[v] = torch.topk(torch.cat([topk[v], cand], dim=1), k, dim=1).values
    return _finalize_fwd(m, s, topk, labels, gt, loss_type=loss_type, margin=margin,
                         scale=scale)


def _finalize_fwd(m, s, topk, labels, gt, *, loss_type, margin, scale):
    lse_neg = torch.where(s > 0, m + torch.log(s), torch.full_like(s, -math.inf))
    zt = scale * phi_target(gt, loss_type, margin)
    pos = (labels >= 0)[None, :]
    mf = torch.maximum(lse_neg, zt)
    logz = torch.where(pos, mf + torch.log(torch.exp(lse_neg - mf) + torch.exp(zt - mf)), lse_neg)
    ce = torch.where(pos, logz - zt, torch.zeros_like(logz))
    neg = torch.where(pos, torch.zeros_like(logz), topk.clamp(min=0.0).mean(dim=-1))
    return ce, neg, logz, topk


def _dcos(c, gt_col, logz, kth, dce, dneg, pos, *, loss_type, margin, scale, k, mask_svfc):
    if loss_type == "SV":
        mod, hard = sv_boost(c, gt_col, margin, mask_svfc)
        fac = torch.where(hard, torch.full_like(c, mask_svfc), torch.ones_like(c))
    else:
        mod, fac = c, 1.0
    d = torch.exp(scale * mod - logz) * dce * scale * fac
    in_topk = (c >= kth - KTH_TIE_TOL) & (c > 0) & ~pos
    return d + torch.where(in_topk, dneg / k, torch.zeros_like(d))


def quad_bwd_plain(E, q, G, V, rows, cols, blend, labels, gt, logz, kth, dce, dneg, *, b,
                   loss_type, margin, scale, k, mask_svfc, chunk=32768):
    """Plain PyTorch version of the backward kernel; same inputs and
    outputs as ``quad_bwd``."""
    r_, d_ = E.shape
    n_q = q.shape[1]
    dev = E.device
    d_emb = torch.zeros((r_, d_), device=dev)
    pos = (labels >= 0)[:, None]
    kw = dict(loss_type=loss_type, margin=margin, scale=scale, k=k, mask_svfc=mask_svfc)
    for lo in range(0, n_q, chunk):
        hi = min(n_q, lo + chunk)
        w = q[0, lo:hi].float()
        last0, lastb = _chunk_writers(rows, cols, blend, b, lo, hi)
        c1, c2 = _written_cos(E @ w.T, E, G, V, last0, lastb, b)
        neg_ok = torch.arange(lo, hi, device=dev)[None, :] != labels[:, None].long()
        dc = [torch.where(neg_ok,
                          _dcos(cv, gt[v][:, None], logz[v][:, None], kth[v][:, None],
                                dce[v][:, None], dneg[v][:, None], pos, **kw),
                          torch.zeros_like(cv))
              for v, cv in enumerate((c1, c2))]
        for d in range(2):
            rs = slice(d * b, (d + 1) * b)
            j0 = torch.nonzero(last0[d] >= 0).flatten()
            jb = torch.nonzero(lastb[d] >= 0).flatten()
            if not (j0.numel() or jb.numel()):
                d_emb[rs] += (dc[0][rs] + dc[1][rs]) @ w
                continue
            w0e = w.clone()
            w0e[j0] = G[rs][last0[d, j0]]
            wbe = w0e.clone()
            wbe[jb] = V[rs][lastb[d, jb]]
            d_emb[rs] += dc[0][rs] @ w0e + dc[1][rs] @ wbe
    zt = scale * phi_target(gt, loss_type, margin)
    dgt = torch.where((labels >= 0)[None, :], (torch.exp(zt - logz) - 1.0) * dce * scale,
                      torch.zeros_like(zt))
    return d_emb, dgt


# ----------------------------------------------------------------------
# the CUDA kernels (csrc/quad_margin.cu)
# ----------------------------------------------------------------------

_LOSS_CODE = {"AM": 0, "Arc": 1, "SV": 2}
_F_TC = 64  # columns per tile of both kernels
_B_RB = 32  # rows per backward block (row group)
_P = ctypes.c_void_p
_FWD_ARGTYPES = [
    _P, ctypes.c_longlong, ctypes.c_int,  # q0, Q, D
    _P, _P, _P,  # E, G, V
    _P, _P, _P, _P,  # rows, cols, blend, labels
    _P,  # gt [2, R]
    ctypes.c_int, ctypes.c_int, ctypes.c_int,  # b, R, k
    ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_float,  # loss, margin, scale, svfc
    ctypes.c_float, ctypes.c_float,  # cos(margin), sin(margin)
]


def _lib():
    from vlsfr_tpu_torch.ops.cuda_build import load_library

    lib = load_library("quad_margin")
    if not getattr(lib, "_vlsfr_typed", False):
        lib.quad_fwd_launch.argtypes = _FWD_ARGTYPES + [
            _P, ctypes.c_int, ctypes.c_longlong,  # part, nblk, cols_per_blk
            _P, _P, _P, _P, _P]  # ce, neg, logz, topk, stream
        lib.quad_fwd_launch.restype = ctypes.c_int
        lib.quad_bwd_launch.argtypes = _FWD_ARGTYPES + [
            _P, _P, _P, _P,  # logz, kth, dce, dneg [2, R]
            _P, ctypes.c_int, ctypes.c_longlong,  # part, nchunk, cols_per_chunk
            _P, _P, _P]  # d_emb, dgt, stream
        lib.quad_bwd_launch.restype = ctypes.c_int
        lib.quad_error_string.argtypes = [ctypes.c_int]
        lib.quad_error_string.restype = ctypes.c_char_p
        lib._vlsfr_typed = True
    return lib


def _check(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           f"{lib.quad_error_string(err).decode()} (cudaError {err})")


def _check_packed(E, q, G, V, rows, cols, blend, labels, gt, b, k, loss_type, extra=()):
    if loss_type not in LOSS_TYPES:
        raise ValueError(f"loss_type must be AM | Arc | SV, got {loss_type!r}")
    r_, d_ = E.shape
    if r_ != 2 * b:
        raise ValueError(f"E has {r_} rows, expected 2*b = {2 * b}")
    if q.dim() != 3 or q.shape[0] != 2 or q.shape[2] != d_:
        raise ValueError(f"queue must be [2, Q, {d_}], got {tuple(q.shape)}")
    if not 1 <= k <= KMAX:
        raise ValueError(f"hard_neg k={k} outside [1, {KMAX}]")
    for name, t, dt, shape in (
            ("E", E, torch.float32, (r_, d_)), ("queue", q, torch.float32, tuple(q.shape)),
            ("G", G, torch.float32, (r_, d_)), ("V", V, torch.float32, (r_, d_)),
            ("rows", rows, torch.int32, (r_,)), ("cols", cols, torch.int32, (r_,)),
            ("blend", blend, torch.int32, (r_,)), ("labels", labels, torch.int32, (r_,)),
            ("gt", gt, torch.float32, (2, r_)), *extra):
        if t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {dt} {shape}, got {t.dtype} {tuple(t.shape)}")
        if t.device != E.device:
            raise ValueError(f"{name} is on {t.device}, E on {E.device}")
        if E.is_cuda and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _cuda_shape_limits(E, b):
    d_ = E.shape[1]
    if b > 128 or d_ % 64 or d_ > 512:
        raise ValueError(f"the quad kernels take b <= 128 rows per direction and a "
                         f"feature width that is a multiple of 64 up to 512; got b={b}, "
                         f"D={d_}")


def _common_args(E, q, G, V, rows, cols, blend, labels, gt, b, k, loss_type, margin,
                 scale, mask_svfc):
    return (q.data_ptr(), q.shape[1], E.shape[1], E.data_ptr(), G.data_ptr(), V.data_ptr(),
            rows.data_ptr(), cols.data_ptr(), blend.data_ptr(), labels.data_ptr(),
            gt.data_ptr(), b, E.shape[0], k, _LOSS_CODE[loss_type], margin, scale, mask_svfc,
            _f32(math.cos(margin)), _f32(math.sin(margin)))


def _split_columns(n_q, n_parts):
    """(parts, columns per part): a tile-multiple split of [0, Q)."""
    tiles = -(-n_q // _F_TC)
    per = -(-tiles // max(min(n_parts, tiles), 1)) * _F_TC
    return -(-n_q // per), per


def quad_fwd(E, q, G, V, rows, cols, blend, labels, gt, *, b, loss_type, margin, scale, k,
             mask_svfc):
    """Streaming forward of both directions × both views over q0.

    Returns (ce, neg, logz) [2, R] and topk [2, R, k] (view-major).

    Replaces ``vlsfr_tpu/ops/twin_margin.py:pallas_quad_fwd``. Bound on an
    H100 at the slice shapes (R = 256, D = 512, Q = 2^20): 2·R·D·Q =
    2.75e11 FLOP of f32 dot products over 2.15 GB of q0 — compute-bound at
    the 67 TFLOP/s f32 rate (~4.1 ms) rather than at 3.35 TB/s (~0.64 ms).
    Design (csrc/quad_margin.cu): one block per contiguous column range
    reads each q0 tile once for all 2b probe rows, keeps per-row running
    (max, sumexp) and a register top-k, and writes a per-block partial;
    a second launch merges the partials in a fixed order (deterministic).
    """
    _check_packed(E, q, G, V, rows, cols, blend, labels, gt, b, k, loss_type)
    if not E.is_cuda:
        return quad_fwd_plain(E, q, G, V, rows, cols, blend, labels, gt, b=b,
                              loss_type=loss_type, margin=margin, scale=scale, k=k,
                              mask_svfc=mask_svfc)
    _cuda_shape_limits(E, b)
    lib = _lib()
    r_ = E.shape[0]
    sms = torch.cuda.get_device_properties(E.device).multi_processor_count
    nblk, per = _split_columns(q.shape[1], 2 * sms)
    part = torch.empty((nblk, 2, r_, 2 + KMAX), device=E.device)
    ce, neg, logz = (torch.empty((2, r_), device=E.device) for _ in range(3))
    topk = torch.empty((2, r_, k), device=E.device)
    stream = torch.cuda.current_stream(E.device).cuda_stream
    err = lib.quad_fwd_launch(
        *_common_args(E, q, G, V, rows, cols, blend, labels, gt, b, k, loss_type, margin,
                      scale, mask_svfc),
        part.data_ptr(), nblk, per, ce.data_ptr(), neg.data_ptr(), logz.data_ptr(),
        topk.data_ptr(), stream)
    _check(lib, err, "quad_fwd")
    LAUNCH_COUNTS["quad_fwd"] += 1
    return ce, neg, logz, topk


def quad_bwd(E, q, G, V, rows, cols, blend, labels, gt, logz, kth, dce, dneg, *, b,
             loss_type, margin, scale, k, mask_svfc):
    """Streaming backward: re-streams q0 and returns (d_emb [R, D] — the
    q0/g/v paths, before the φ'(gt) tail — and d_gt [2, R]). ``dce`` /
    ``dneg`` come pre-masked (0 on outlier / positive rows).

    Replaces ``vlsfr_tpu/ops/twin_margin.py:pallas_quad_bwd``. Bound on an
    H100 at the slice shapes: 2 × 2.75e11 FLOP (cosine recompute + the
    d_cos @ q0 product) ≈ 8.2 ms at the 67 TFLOP/s f32 rate; q0's 2.15 GB
    read once is 0.64 ms. Design: each block owns 32 probe rows × one
    column range, so its d_emb partial [32, D] lives in registers; the row
    groups of one column range are adjacent in launch order and share the
    q0 tile through L2. A second launch sums the partials in a fixed
    order — no float atomics, bit-stable run to run.
    """
    r_ = E.shape[0]
    vec = (2, r_)
    _check_packed(E, q, G, V, rows, cols, blend, labels, gt, b, k, loss_type,
                  extra=(("logz", logz, torch.float32, vec), ("kth", kth, torch.float32, vec),
                         ("dce", dce, torch.float32, vec), ("dneg", dneg, torch.float32, vec)))
    if not E.is_cuda:
        return quad_bwd_plain(E, q, G, V, rows, cols, blend, labels, gt, logz, kth, dce, dneg,
                              b=b, loss_type=loss_type, margin=margin, scale=scale, k=k,
                              mask_svfc=mask_svfc)
    _cuda_shape_limits(E, b)
    lib = _lib()
    sms = torch.cuda.get_device_properties(E.device).multi_processor_count
    n_rg = -(-r_ // _B_RB)
    nchunk, per = _split_columns(q.shape[1], max(4 * sms // n_rg, 1))
    part = torch.empty((nchunk, r_, E.shape[1]), device=E.device)
    d_emb = torch.empty_like(E)
    dgt = torch.empty(vec, device=E.device)
    stream = torch.cuda.current_stream(E.device).cuda_stream
    err = lib.quad_bwd_launch(
        *_common_args(E, q, G, V, rows, cols, blend, labels, gt, b, k, loss_type, margin,
                      scale, mask_svfc),
        logz.data_ptr(), kth.data_ptr(), dce.data_ptr(), dneg.data_ptr(),
        part.data_ptr(), nchunk, per, d_emb.data_ptr(), dgt.data_ptr(), stream)
    _check(lib, err, "quad_bwd")
    LAUNCH_COUNTS["quad_bwd"] += 1
    return d_emb, dgt


# ----------------------------------------------------------------------
# autograd and the loss entry point
# ----------------------------------------------------------------------


def pack_dirs(emb_x, emb_y, dir_a, dir_b, labels_a, labels_b, gts_a, gts_b):
    """Stack both directions into the kernels' packed layout."""
    ga, ra, ca, va, bla = dir_a
    gb, rb, cb, vb, blb = dir_b
    cat = lambda x, y: torch.cat([x, y]).contiguous()  # noqa: E731
    return (cat(emb_x.float(), emb_y.float()), cat(ga, gb), cat(va, vb),
            cat(ra, rb), cat(ca, cb), cat(bla, blb),
            cat(labels_a.to(torch.int32), labels_b.to(torch.int32)),
            torch.stack([cat(gts_a[0], gts_b[0]), cat(gts_a[1], gts_b[1])]))


class QuadMargin(torch.autograd.Function):
    """Both FFC directions' per-row (ce1, neg1, ce2, neg2) plus the
    streaming top-1 hits, differentiable w.r.t. the two probe embeddings
    only (mirrors ``fused_quad_margin``; no queue or gallery gradient)."""

    @staticmethod
    def forward(ctx, emb_x, emb_y, queue, g_a, g_b, rows_a, cols_a, seen_a, rows_b, cols_b,
                seen_b, labels_a, labels_b, loss_type, margin, scale, hard_neg, mask_svfc):
        b = emb_x.shape[0]
        kw = dict(b=b, loss_type=loss_type, margin=margin, scale=scale, k=hard_neg,
                  mask_svfc=mask_svfc)
        gts_a = compute_twin_gt(emb_x, queue, g_a, rows_a, cols_a, seen_a, labels_a)
        gts_b = compute_twin_gt(emb_y, queue, g_b, rows_b, cols_b, seen_b, labels_b)
        packed = pack_dirs(emb_x, emb_y, dir_inputs(queue, g_a, rows_a, cols_a, seen_a),
                           dir_inputs(queue, g_b, rows_b, cols_b, seen_b),
                           labels_a, labels_b, gts_a, gts_b)
        ce, neg, logz, topk = quad_fwd(packed[0], queue, *packed[1:], **kw)
        labels = packed[6]
        hit = ((packed[7][0] + KTH_TIE_TOL >= topk[0, :, 0]) & (labels >= 0)).float()
        ctx.save_for_backward(emb_x, emb_y, queue, g_a, g_b, rows_a, cols_a, seen_a,
                              rows_b, cols_b, seen_b, labels_a, labels_b, logz, topk,
                              *packed)
        ctx.kw = kw
        ctx.mark_non_differentiable(hit)
        out = []
        for lo in (0, b):
            sl = slice(lo, lo + b)
            out += [ce[0, sl], neg[0, sl], ce[1, sl], neg[1, sl]]
        return (*out, hit[:b], hit[b:])

    @staticmethod
    def backward(ctx, *cots):
        (emb_x, emb_y, queue, g_a, g_b, rows_a, cols_a, seen_a, rows_b, cols_b, seen_b,
         labels_a, labels_b, logz, topk, E, G, V, rows, cols, blend, labels, gt) = ctx.saved_tensors
        kw = ctx.kw
        b = kw["b"]
        zeros = E.new_zeros(b)
        c = [zeros if x is None else x.float() for x in cots[:8]]
        # cots order: (ce1a, neg1a, ce2a, neg2a, ce1b, neg1b, ce2b, neg2b)
        dce = torch.stack([torch.cat([c[0], c[4]]), torch.cat([c[2], c[6]])])
        dneg = torch.stack([torch.cat([c[1], c[5]]), torch.cat([c[3], c[7]])])
        pos = (labels >= 0)[None, :]
        dce = torch.where(pos, dce, torch.zeros_like(dce)).contiguous()
        dneg = torch.where(pos, torch.zeros_like(dneg), dneg).contiguous()
        kth = topk[:, :, -1].contiguous()
        d_emb, dgt = quad_bwd(E, queue, G, V, rows, cols, blend, labels, gt, logz, kth, dce,
                              dneg, **kw)
        lt, mg = kw["loss_type"], kw["margin"]
        sa, sb = slice(0, b), slice(b, 2 * b)
        d_x = twin_gt_tail(emb_x, queue, g_a, rows_a, cols_a, seen_a, labels_a,
                           gt[0, sa], gt[1, sa], dgt[0, sa], dgt[1, sa], d_emb[sa], lt, mg)
        d_y = twin_gt_tail(emb_y, queue, g_b, rows_b, cols_b, seen_b, labels_b,
                           gt[0, sb], gt[1, sb], dgt[0, sb], dgt[1, sb], d_emb[sb], lt, mg)
        return (d_x, d_y) + (None,) * 16


def quad_add_margin(emb_x, emb_y, queue, g_a, g_b, plan_a, plan_b, labels_a, labels_b, *,
                    loss_type="Arc", margin=0.5, scale=32.0, hard_neg=10, mask_svfc=1.2,
                    with_acc=False, qscales=None, int8_compute=False):
    """(loss_a, loss_b): both FFC directional losses with ONE streaming
    pass over q0 per forward and backward. ``with_acc`` also returns the
    combined streaming top-1 accuracy over both directions' in-pool rows."""
    if qscales is not None or int8_compute or queue.dtype != torch.float32:
        raise NotImplementedError(
            "int8 and bf16 queues (qscales, int8_compute) are not ported yet; "
            "the quad head takes a float32 queue")
    rows_a, cols_a, seen_a = plan_a
    rows_b, cols_b, seen_b = plan_b
    out = QuadMargin.apply(emb_x, emb_y, queue, g_a.detach(), g_b.detach(), rows_a, cols_a,
                           seen_a, rows_b, cols_b, seen_b, labels_a, labels_b, loss_type,
                           float(margin), float(scale), int(hard_neg), float(mask_svfc))
    ce1a, neg1a, ce2a, neg2a, ce1b, neg1b, ce2b, neg2b, hit_a, hit_b = out
    losses = (reduce_margin_dir(ce1a, neg1a, ce2a, neg2a, labels_a),
              reduce_margin_dir(ce1b, neg1b, ce2b, neg2b, labels_b))
    if with_acc:
        n_pos = ((labels_a >= 0).float().sum() + (labels_b >= 0).float().sum()).clamp(min=1.0)
        return losses, ((hit_a.sum() + hit_b.sum()) / n_pos).detach()
    return losses
