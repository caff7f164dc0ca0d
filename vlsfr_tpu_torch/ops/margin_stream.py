"""Port of ``vlsfr_tpu/ops/margin_pallas.py`` (single-device part): the
streaming margin-softmax cross-entropy over a huge class axis.

Normalised embeddings ``emb [B, D]`` against class weights ``w [C, D]``
with the margin transform, scaled CE on rows with a class label and the
hard-negative term on outlier rows (``label == -1``), without ever holding
the ``[B, C]`` logits (0.5 GB at B = 128, C = 2^20).

Kernel boundary. ``margin_ce_fwd``, ``margin_ce_bwd`` and
``margin_ce_bwd_fused_sgd`` keep the JAX functions' arguments and outputs
(``pallas_margin_ce_fwd`` / ``_bwd`` / ``_bwd_fused_sgd``). For CUDA
tensors they launch the hand-written kernels in ``csrc/margin_ce.cu``; for
CPU tensors they run the plain PyTorch versions beside them
(``*_plain``, chunked over C). There is no other route and no switch.

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
    tile_modified,
)

KMAX = 16  # largest hard_neg the kernels keep a register top-k for
LAUNCH_COUNTS = {"margin_ce_fwd": 0, "margin_ce_bwd": 0, "margin_ce_bwd_fused_sgd": 0}


def reset_launch_counts() -> None:
    for name in LAUNCH_COUNTS:
        LAUNCH_COUNTS[name] = 0


# ----------------------------------------------------------------------
# B-row helpers (plain torch on every device, as XLA ops in JAX)
# ----------------------------------------------------------------------


def _normalize_rows(w, eps=1e-12):
    w = w.float()
    n2 = w.square().sum(dim=-1, keepdim=True)
    return w * torch.rsqrt(n2.clamp(min=eps * eps))


def compute_gt(emb, w, labels):
    """gt_i = cos(emb_i, ŵ[label_i]) via one row gather (the row of class 0
    for outlier rows, as in JAX)."""
    return (emb.float() * _normalize_rows(w[labels.clamp(min=0).long()])).sum(dim=-1)


def _mask_cotangents(labels, d_ce, d_neg):
    """ce ≡ 0 on outlier rows and neg ≡ 0 on positive rows: their
    cotangents must not leak."""
    pos = labels >= 0
    zero = torch.zeros((), device=labels.device)
    return (torch.where(pos, d_ce.float(), zero).contiguous(),
            torch.where(pos, zero, d_neg.float()).contiguous())


def _target_rows(emb, w, labels, gt, logz, d_ce, *, loss_type, margin, scale):
    """The target column's gradient from the pre-update label rows:
    (its ``d_emb`` term [B, D], the label rows' gradient ``d_wl`` [B, D]).
    ``d_ce`` comes masked; both terms are 0 on outlier rows."""
    pos1 = (labels >= 0).float()[:, None]
    p_t = torch.exp(scale * phi_target(gt, loss_type, margin) - logz)
    d_gt = (p_t - 1.0) * d_ce * scale * phi_prime(gt, loss_type, margin)
    wl = w[labels.clamp(min=0).long()].float()
    wln = _normalize_rows(wl)
    d_wln = d_gt[:, None] * emb.float() * pos1
    inv = torch.rsqrt(wl.square().sum(dim=-1, keepdim=True).clamp(min=1e-24))
    d_wl = inv * (d_wln - wln * (d_wln * wln).sum(dim=-1, keepdim=True))
    return d_gt[:, None] * wln * pos1, d_wl


def _sgd_rows(w, mom, d_w, lr, *, momentum, nesterov, weight_decay):
    """The optax wd → trace(μ, nesterov) → (−lr) chain on a block of rows,
    in place on ``w`` and ``mom`` (``apply_sgd_dense`` in JAX)."""
    g = d_w
    if weight_decay:
        g = g + weight_decay * w
    if momentum:
        new_mom = momentum * mom + g
        upd = g + momentum * new_mom if nesterov else new_mom
    else:
        new_mom = upd = g
    w.copy_(w - lr * upd)
    mom.copy_(new_mom)


# ----------------------------------------------------------------------
# plain versions of the three kernels (chunked over C)
# ----------------------------------------------------------------------


def _chunk_cos(emb32, w, lo, hi):
    wn = _normalize_rows(w[lo:hi])
    return emb32 @ wn.T, wn


def _chunk_dcos(cos, lo, labels, gt, logz, kth, d_ce, d_neg, *, loss_type, margin, scale, k,
                mask_svfc):
    """d loss / d cos over one chunk of columns, 0 at the target column
    (its gradient joins through d_gt). ``d_ce``/``d_neg`` come masked."""
    col = torch.arange(lo, lo + cos.shape[1], device=cos.device)
    is_target = col[None, :] == labels[:, None].long()
    valid = torch.ones_like(is_target)
    mod = tile_modified(cos, is_target, gt[:, None], valid, loss_type, margin, mask_svfc)
    dz = torch.exp(scale * mod - logz[:, None]) * d_ce[:, None] * scale
    if loss_type == "SV":
        hard = cos > (gt[:, None] - margin)
        dz = torch.where(hard, dz * mask_svfc, dz)
    d_cos = torch.where(is_target, torch.zeros_like(dz), dz)
    in_topk = (cos >= kth[:, None] - KTH_TIE_TOL) & (cos > 0) & (labels < 0)[:, None]
    return d_cos + torch.where(in_topk, d_neg[:, None] / k, torch.zeros_like(dz))


def _chunk_dw(d_cos, emb32, wn, lo, hi, w):
    """d_w = inv·(d_ŵ − ŵ⟨d_ŵ, ŵ⟩): the row normalisation's backward."""
    d_wn = d_cos.T @ emb32
    inv = torch.rsqrt(w[lo:hi].float().square().sum(dim=-1, keepdim=True).clamp(min=1e-24))
    return inv * (d_wn - wn * (d_wn * wn).sum(dim=-1, keepdim=True))


def margin_ce_fwd_plain(emb, w, labels, gt, *, loss_type, margin, scale, k, mask_svfc,
                        chunk=32768):
    """Plain PyTorch version of the forward kernel; same inputs and outputs
    as ``margin_ce_fwd`` (the scan reference ``_stream_fwd``)."""
    b = emb.shape[0]
    c = w.shape[0]
    dev = emb.device
    emb32 = emb.float()
    m = torch.full((b,), NEG_INF, device=dev)
    s = torch.zeros((b,), device=dev)
    topk = torch.full((b, k), NEG_INF, device=dev)
    for lo in range(0, c, chunk):
        hi = min(c, lo + chunk)
        cos, _ = _chunk_cos(emb32, w, lo, hi)
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
    logz = m + torch.log(s)
    pos = labels >= 0
    ce = torch.where(pos, logz - scale * phi_target(gt, loss_type, margin), torch.zeros_like(logz))
    neg = torch.where(pos, torch.zeros_like(logz), topk.clamp(min=0.0).mean(dim=-1))
    return ce, neg, logz, topk


def margin_ce_bwd_plain(emb, w, labels, gt, logz, topk, d_ce, d_neg, *, loss_type, margin, scale,
                        k, mask_svfc, grad_w=True, chunk=32768):
    """Plain PyTorch version of ``margin_ce_bwd``: (d_emb [B, D], d_w
    [C, D] f32 or None with ``grad_w=False``), the target tail included."""
    c = w.shape[0]
    emb32 = emb.float()
    d_ce, d_neg = _mask_cotangents(labels, d_ce, d_neg)
    kth = topk[:, -1]
    kw = dict(loss_type=loss_type, margin=margin, scale=scale, k=k, mask_svfc=mask_svfc)
    d_emb = torch.zeros_like(emb32)
    d_w = torch.empty((c, w.shape[1]), device=w.device) if grad_w else None
    for lo in range(0, c, chunk):
        hi = min(c, lo + chunk)
        cos, wn = _chunk_cos(emb32, w, lo, hi)
        d_cos = _chunk_dcos(cos, lo, labels, gt, logz, kth, d_ce, d_neg, **kw)
        d_emb += d_cos @ wn
        if grad_w:
            d_w[lo:hi] = _chunk_dw(d_cos, emb32, wn, lo, hi, w)
    # the target tail (``pallas_margin_ce_bwd``'s XLA tail): d_gt into d_emb
    # and, as a scatter-add, into the label rows of d_w — two rows sharing a
    # class both add
    emb_term, d_wl = _target_rows(emb, w, labels, gt, logz, d_ce, loss_type=loss_type,
                                  margin=margin, scale=scale)
    if grad_w:
        d_w.index_add_(0, labels.clamp(min=0).long(), d_wl)
    return (d_emb + emb_term).to(emb.dtype), d_w


def margin_ce_bwd_fused_sgd_plain(emb, w, mom, labels, gt, logz, topk, d_ce, d_neg, lr, *,
                                  momentum, nesterov, weight_decay, loss_type, margin, scale, k,
                                  mask_svfc, chunk=32768):
    """Plain PyTorch version of ``margin_ce_bwd_fused_sgd``; updates ``w``
    and ``mom`` IN PLACE, chunk by chunk, each chunk's rows after its
    d_emb contribution is taken. Returns (d_emb, w, mom)."""
    c = w.shape[0]
    emb32 = emb.float()
    d_ce, d_neg = _mask_cotangents(labels, d_ce, d_neg)
    kth = topk[:, -1]
    emb_term, d_wl = _target_rows(emb, w, labels, gt, logz, d_ce, loss_type=loss_type,
                                  margin=margin, scale=scale)
    kw = dict(loss_type=loss_type, margin=margin, scale=scale, k=k, mask_svfc=mask_svfc)
    d_emb = torch.zeros_like(emb32)
    lab = labels.long()
    for lo in range(0, c, chunk):
        hi = min(c, lo + chunk)
        cos, wn = _chunk_cos(emb32, w, lo, hi)
        d_cos = _chunk_dcos(cos, lo, labels, gt, logz, kth, d_ce, d_neg, **kw)
        d_emb += d_cos @ wn
        d_w = _chunk_dw(d_cos, emb32, wn, lo, hi, w)
        mine = (lab >= lo) & (lab < hi)  # target rows of this chunk: a sum per class
        d_w.index_add_(0, lab[mine] - lo, d_wl[mine])
        _sgd_rows(w[lo:hi], mom[lo:hi], d_w, lr, momentum=momentum, nesterov=nesterov,
                  weight_decay=weight_decay)
    return (d_emb + emb_term).to(emb.dtype), w, mom


# ----------------------------------------------------------------------
# the CUDA kernels (csrc/margin_ce.cu)
# ----------------------------------------------------------------------

_LOSS_CODE = {"AM": 0, "Arc": 1, "SV": 2}
_F_TC = 128  # columns per forward tile
_B_TC = 64  # columns per backward tile
_B_RB = 32  # rows per d_emb block (row group)
_MAX_ROWS = 128  # batch rows the kernels hold per block
_P = ctypes.c_void_p
_COMMON_ARGTYPES = [
    _P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,  # emb, w, C, D, B
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
            _P, _P, _P, _P, _P]  # ce, neg, logz, topk, stream
        lib.margin_ce_bwd_launch.argtypes = _BWD_ARGTYPES + [_P, _P, _P]  # d_w, d_wl, stream
        lib.margin_ce_bwd_fused_sgd_launch.argtypes = _BWD_ARGTYPES + [
            _P, _P, _P,  # w (updated in place), mom (in place), d_wl
            ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_float,  # lr, mu, nesterov, wd
            _P]  # stream
        for fn in (lib.margin_ce_fwd_launch, lib.margin_ce_bwd_launch,
                   lib.margin_ce_bwd_fused_sgd_launch):
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
    what the kernels do not take."""
    if loss_type not in LOSS_TYPES:
        raise ValueError(f"loss_type must be AM | Arc | SV, got {loss_type!r}")
    if w.dtype != torch.float32:
        raise NotImplementedError("a bfloat16 classifier is not ported yet; w must be float32")
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
    if emb.is_cuda and (b > _MAX_ROWS or d % 64 or d > 512):
        raise ValueError(f"the margin_ce kernels take B <= {_MAX_ROWS} rows and a feature "
                         f"width that is a multiple of 64 up to 512; got B={b}, D={d}")


def _common_args(emb, w, labels, gt, k, loss_type, margin, scale, mask_svfc):
    return (emb.data_ptr(), w.data_ptr(), w.shape[0], emb.shape[1], emb.shape[0],
            labels.data_ptr(), gt.data_ptr(), k, _LOSS_CODE[loss_type], margin, scale, mask_svfc,
            _f32(math.cos(margin)), _f32(math.sin(margin)))


def _split_columns(c, tile, n_parts):
    """(parts, columns per part): a tile-multiple split of [0, C)."""
    tiles = -(-c // tile)
    per = -(-tiles // max(min(n_parts, tiles), 1)) * tile
    return -(-c // per), per


def _sms(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def margin_ce_fwd(emb, w, labels, gt, *, loss_type, margin, scale, k, mask_svfc):
    """Streaming forward: (ce [B], neg [B], logz [B], topk [B, k]).

    Replaces ``vlsfr_tpu/ops/margin_pallas.py:pallas_margin_ce_fwd``. Bound
    on an H100 at the slice shapes (B = 128, D = 512, C = 2^20): 2·B·D·C =
    1.37e11 FLOP of f32 dot products (~2.05 ms at 67 TFLOP/s) against
    2.15 GB of W (~0.64 ms at 3.35 TB/s): compute-bound. Design
    (csrc/margin_ce.cu): each block streams a contiguous column range with
    every batch row resident, so each W tile is read once; per-row running
    (max, sumexp) and a register top-k go to a per-block partial that a
    second launch merges in a fixed order.
    """
    _check_inputs(emb, w, labels, gt, k, loss_type)
    if not emb.is_cuda:
        return margin_ce_fwd_plain(emb, w, labels, gt, loss_type=loss_type, margin=margin,
                                   scale=scale, k=k, mask_svfc=mask_svfc)
    lib = _lib()
    b, dev = emb.shape[0], emb.device
    nblk, per = _split_columns(w.shape[0], _F_TC, 2 * _sms(dev))
    part = torch.empty((2 * nblk, b, 2 + KMAX), device=dev)
    ce, neg, logz = (torch.empty((b,), device=dev) for _ in range(3))
    topk = torch.empty((b, k), device=dev)
    err = lib.margin_ce_fwd_launch(
        *_common_args(emb, w, labels, gt, k, loss_type, margin, scale, mask_svfc),
        part.data_ptr(), nblk, per, ce.data_ptr(), neg.data_ptr(), logz.data_ptr(),
        topk.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _check_launch(lib, err, "margin_ce_fwd")
    LAUNCH_COUNTS["margin_ce_fwd"] += 1
    return ce, neg, logz, topk


def _bwd_geometry(emb, w):
    """(d_emb partial buffer, nchunk, cols per chunk, d_w blocks, cols per
    d_w block) of the two backward passes."""
    b, d = emb.shape
    sms = _sms(emb.device)
    n_rg = -(-b // _B_RB)
    nchunk, per = _split_columns(w.shape[0], _B_TC, max(4 * sms // n_rg, 1))
    nblk, per_w = _split_columns(w.shape[0], _B_TC, 2 * sms)
    return torch.empty((nchunk, b, d), device=emb.device), nchunk, per, nblk, per_w


def _bwd_extra(logz, topk, b, k):
    return (("logz", logz, torch.float32, (b,)), ("topk", topk, torch.float32, (b, k)))


def margin_ce_bwd(emb, w, labels, gt, logz, topk, d_ce, d_neg, *, loss_type, margin, scale, k,
                  mask_svfc, grad_w=True):
    """Streaming backward: re-streams W and returns (d_emb [B, D], d_w
    [C, D] f32, or None with ``grad_w=False``), the target tail included.

    Replaces ``vlsfr_tpu/ops/margin_pallas.py:pallas_margin_ce_bwd``. Bound
    on an H100 at the slice shapes with ``grad_w``: three products (cosine
    recompute, d_cos @ ŵ, d_cosᵀ @ emb) = 4.12e11 FLOP (~6.15 ms at the f32
    rate) against W read + d_w written = 4.3 GB (~1.28 ms): compute-bound.
    Design: a row-grouped pass (32 rows × a column range per block, d_emb
    partial in registers, partials summed in a fixed order by a merge
    launch) and, with ``grad_w``, a column-owned pass (every batch row ×
    64 columns per tile) that recomputes d_cos and writes each d_w row once,
    its owner adding the label rows' d_wl (computed here before the launch)
    in batch order. No float atomics: d_emb and d_w are bit-stable run to
    run.
    """
    _check_inputs(emb, w, labels, gt, k, loss_type, extra=_bwd_extra(logz, topk, emb.shape[0], k))
    if not emb.is_cuda:
        return margin_ce_bwd_plain(emb, w, labels, gt, logz, topk, d_ce, d_neg, grad_w=grad_w,
                                   loss_type=loss_type, margin=margin, scale=scale, k=k,
                                   mask_svfc=mask_svfc)
    d_ce_m, d_neg_m = _mask_cotangents(labels, d_ce, d_neg)
    kth = topk[:, -1].contiguous()
    lib = _lib()
    dev = emb.device
    emb_term, d_wl = _target_rows(emb, w, labels, gt, logz, d_ce_m, loss_type=loss_type,
                                  margin=margin, scale=scale)
    d_wl = d_wl.contiguous()
    part, nchunk, per, nblk, per_w = _bwd_geometry(emb, w)
    d_emb = torch.empty_like(emb)
    d_w = torch.empty_like(w) if grad_w else None
    err = lib.margin_ce_bwd_launch(
        *_common_args(emb, w, labels, gt, k, loss_type, margin, scale, mask_svfc),
        logz.data_ptr(), kth.data_ptr(), d_ce_m.data_ptr(), d_neg_m.data_ptr(),
        part.data_ptr(), nchunk, per, d_emb.data_ptr(), nblk, per_w,
        d_w.data_ptr() if grad_w else None, d_wl.data_ptr() if grad_w else None,
        torch.cuda.current_stream(dev).cuda_stream)
    _check_launch(lib, err, "margin_ce_bwd")
    LAUNCH_COUNTS["margin_ce_bwd"] += 1
    return (d_emb + emb_term).to(emb.dtype), d_w


def margin_ce_bwd_fused_sgd(emb, w, mom, labels, gt, logz, topk, d_ce, d_neg, lr, *, momentum,
                            nesterov, weight_decay, loss_type, margin, scale, k, mask_svfc):
    """Streaming backward with the classifier's SGD-momentum update fused
    in: returns (d_emb [B, D], w, mom), where ``w`` and ``mom`` are updated
    IN PLACE to exactly what optax's wd → trace(μ, nesterov) → (−lr) chain
    makes of the dense d_w. The dense d_w never exists in device memory.

    Replaces ``vlsfr_tpu/ops/margin_pallas.py:pallas_margin_ce_bwd_fused_sgd``.
    Bound on an H100 at the slice shapes: 4.12e11 FLOP (~6.15 ms at the f32
    rate) against W and mom read and written = 8.6 GB (~2.56 ms):
    compute-bound. The target tail (d_gt, the label rows' gradient d_wl) is
    computed here from the PRE-update rows before the launch; the kernel's
    d_emb pass reads W before its column-owned pass overwrites it (stream
    order), and in that pass each block reads its own W and mom rows before
    it writes them; no other block touches them. Two batch rows with one
    class both add their d_wl into that row, in batch order.
    """
    if mom.dtype != torch.float32:
        raise NotImplementedError("bfloat16 classifier momentum is not ported yet")
    _check_inputs(emb, w, labels, gt, k, loss_type,
                  extra=(*_bwd_extra(logz, topk, emb.shape[0], k),
                         ("mom", mom, torch.float32, tuple(w.shape))))
    if not emb.is_cuda:
        return margin_ce_bwd_fused_sgd_plain(
            emb, w, mom, labels, gt, logz, topk, d_ce, d_neg, lr, momentum=momentum,
            nesterov=nesterov, weight_decay=weight_decay, loss_type=loss_type, margin=margin,
            scale=scale, k=k, mask_svfc=mask_svfc)
    d_ce_m, d_neg_m = _mask_cotangents(labels, d_ce, d_neg)
    kth = topk[:, -1].contiguous()
    lib = _lib()
    dev = emb.device
    emb_term, d_wl = _target_rows(emb, w, labels, gt, logz, d_ce_m, loss_type=loss_type,
                                  margin=margin, scale=scale)
    d_wl = d_wl.contiguous()
    part, nchunk, per, nblk, per_w = _bwd_geometry(emb, w)
    d_emb = torch.empty_like(emb)
    err = lib.margin_ce_bwd_fused_sgd_launch(
        *_common_args(emb, w, labels, gt, k, loss_type, margin, scale, mask_svfc),
        logz.data_ptr(), kth.data_ptr(), d_ce_m.data_ptr(), d_neg_m.data_ptr(),
        part.data_ptr(), nchunk, per, d_emb.data_ptr(), nblk, per_w,
        w.data_ptr(), mom.data_ptr(), d_wl.data_ptr(), float(lr), float(momentum),
        int(bool(nesterov and momentum)), float(weight_decay),
        torch.cuda.current_stream(dev).cuda_stream)
    _check_launch(lib, err, "margin_ce_bwd_fused_sgd")
    LAUNCH_COUNTS["margin_ce_bwd_fused_sgd"] += 1
    return (d_emb + emb_term).to(emb.dtype), w, mom


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
