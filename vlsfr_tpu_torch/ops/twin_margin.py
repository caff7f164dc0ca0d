"""The fused FFC heads (port of ``vlsfr_tpu/ops/twin_margin.py``): the quad
head, both directions × both queue views in one pass over q0 per forward
and per backward, and the twin head, one direction × both views (the
reference's ``directional_loss`` surface, ``twin_add_margin``).

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
direction A, [b, 2b) direction B), with ``labels`` stacked the same way,
the writes ``G``, ``V``, ``rows``, ``cols``, ``blend`` stacked per direction
too ([2 bp, ...], bp = b writes per direction on one device) and per-view
row vectors as [2, R] (index 0 = view 1, 1 = view 2). For CUDA tensors they
launch the hand-written kernels in ``csrc/quad_margin.cu``; for CPU tensors
they run the plain PyTorch versions beside them (``quad_fwd_plain`` /
``quad_bwd_plain``). There is no other route and no switch.

The twin kernels ``twin_fwd`` / ``twin_bwd`` take the same layout with
one direction: E [b, D], the direction's writes [bp, D] and [bp], labels
[b], per-view rows [2, b]. Their partial forms ``twin_partial_fwd`` /
``twin_partial_bwd`` serve ``parallel/sharded_twin.py``. The twin kernels
take f32 and bf16 queues; int8 queues run through the quad head only, as
in JAX.

The per-shard forms ``quad_partial_fwd`` / ``quad_partial_bwd`` (the
model-sharded head, ``parallel/sharded_quad.py``) take plane 0 of one
shard's queue block, shard-local write columns (-1: another shard's) and
labels (-1: outlier; -2: a positive row whose target is on another shard),
and bp writes per direction apart from the b probes. The forward returns
the shard's negative-stream state (m, s, top-k) for the collective merge;
the backward takes the GLOBAL logz, kth and cotangents and returns the
shard's d_emb partial and its owner-only d_gt.

Around the kernels, as in JAX, plain torch computes the target cosines
(``compute_twin_gt``), the write values (``dir_inputs``) and the φ'(gt)
tail of the gradient (``twin_gt_tail``) — all B-row work, exact f32 on the
(dequantised) rows.

Queue forms. The kernels take the queue plane as f32, bf16 or int8; an
int8 plane comes with its per-row scales ``qscales`` [Q] (ops/qqueue.py),
and the int8-compute form also with the probes quantised per row,
``e8 = (E8 int8 [R, D], se f32 [R])``. Each rounds where the JAX kernel
rounds (``vlsfr_tpu/ops/twin_margin.py:_cos_tile``, ``_demb_clean``,
``_int8_written_cos`` / ``_demb``, ``effective_tile_views``):

* every dot operand that is not int8 is rounded to bf16 — the probes, the
  write rows G and V — and products accumulate in f32;
* int8 storage: cos = (bf16(E)·int8) · s_col; int8 compute: cos =
  f32(E8·int8, an exact int32 sum) · (se_row · s_col);
* written columns: bf16(E)·bf16(g or v);
* the backward rounds d_cos to bf16 before its product with the rows (int8
  queues: bf16(d_cos · s_col)·int8). Within a tile that holds none of the
  direction's writes, the quad's Arc and AM take d_cos of both views in
  one combined form (JAX's ``_quad_dir_bwd_shared`` clean tile), the
  quad's SV and the twin the sum of the two views, rounded once; a tile
  that holds a write routes each view's d_cos to the row that view scores
  against, rounding as JAX's written tile does (bf16 queue: each view's
  d_cos alone; int8: the sum routed to the int8 row, g or v). The f32 form
  keeps f32 throughout.

The rounding tile. JAX makes the clean / written choice per tile of its
kernel, ``_fit_tile(c, _twin_tile(b, d, tile, itemsize))`` of the
requested ``tile`` (``pool.queue_tile``, or the step's own choice at 0):
2048 columns for capacity_10m_int8c, 1024 for a bf16 queue of 4,194,304
slots. The backward wrappers take the same ``tile`` and resolve it the
same way (``round_tile``: over b rows per direction, over max(b, bp) and
the block's columns for the partial forms); the kernels keep their
64-column compute tile and call a 64-column tile written when the
direction writes a column of its enclosing rounding tile. A resolved tile
must be a multiple of 64 (JAX's TPU path only makes multiples of 128).

The negative stream. The quad splits every loss type's logsumexp into the
NON-target columns (streamed, target excluded) and the target term
``scale·φ(gt)`` joined analytically at the end. The twin streams the
target column as z = scale·φ(gt) (JAX's twin kernels), so nothing is
added after the stream or the shards' merge, and its d_gt is that
column's dz. Both top-k lists exclude the target, so the train-accuracy
hit test ``gt + KTH_TIE_TOL >= topk[:, 0]`` never compares gt against a
recomputation of itself.
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
    sv_boost,
)
from vlsfr_tpu_torch.ops.qqueue import quantize_rows

KMAX = 16  # largest hard_neg the kernels keep a register top-k for
TILE = 64  # columns per kernel tile; a rounding tile is a multiple of it
FORMS = ("f32", "bf16", "int8", "int8c")
TC_FORMS = ("bf16", "int8", "int8c")  # the forms whose backward runs on the tensor cores
KERNELS = ("quad_fwd", "quad_bwd", "quad_partial_fwd", "quad_partial_bwd")
TWIN_FORMS = ("f32", "bf16")
TWIN_KERNELS = ("twin_fwd", "twin_bwd", "twin_partial_fwd", "twin_partial_bwd")


def kernel_name(kernel: str, form: str) -> str:
    """The launch counter of one form of a kernel: ``quad_fwd`` (f32),
    ``quad_fwd[bf16]``, ``quad_fwd[int8]``, ``quad_fwd[int8c]``."""
    return kernel if form == "f32" else f"{kernel}[{form}]"


LAUNCH_COUNTS = {kernel_name(k, f): 0 for k in KERNELS for f in FORMS}
LAUNCH_COUNTS.update({kernel_name(k, f): 0 for k in TWIN_KERNELS for f in TWIN_FORMS})


def reset_launch_counts() -> None:
    for name in LAUNCH_COUNTS:
        LAUNCH_COUNTS[name] = 0


def queue_form(plane: torch.Tensor, e8=None) -> str:
    """The kernel form a queue plane's dtype (and the int8-compute probes)
    selects."""
    if plane.dtype == torch.int8:
        return "int8" if e8 is None else "int8c"
    return {torch.float32: "f32", torch.bfloat16: "bf16"}.get(plane.dtype, "?")


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 (to nearest, ties to even), kept in f32."""
    return x.to(torch.bfloat16).float()


def fit_tile(c: int, tile: int) -> int:
    """The largest 128-multiple <= ``tile`` that divides ``c``, else
    ``tile`` (JAX's ``vlsfr_tpu/ops/margin_pallas.py:_fit_tile``)."""
    for t in range(tile // 128 * 128, 0, -128):
        if c % t == 0:
            return t
    return tile


def twin_tile(b: int, d: int, tile: int, qbytes: int = 4) -> int:
    """``tile`` clamped as JAX's ``_twin_tile`` clamps it to its kernels'
    VMEM budget (one double-buffered queue tile of ``qbytes`` per element,
    the [b, D] operands and ~8 [b, tile] buffers; int8 at b <= 128 admits
    2048)."""
    fixed = 24 * b * d
    per_col = 2 * qbytes * d + 40 * b
    max_tile = max(256, int((11 * 2**20 - fixed) // per_col) // 128 * 128)
    if qbytes == 1 and b <= 128:
        max_tile = max(max_tile, 2048)
    return min(tile, max_tile)


def round_tile(c: int, b: int, d: int, tile: int, qbytes: int) -> int:
    """The rounding tile of a backward over ``c`` columns of a plane with
    ``qbytes`` per element, b rows (max(b, bp) for the partial forms):
    the tile JAX's kernel runs for the requested ``tile``. Refuses a tile
    that is not a multiple of the kernels' 64 columns."""
    t = fit_tile(c, twin_tile(b, d, tile, qbytes))
    if t <= 0 or t % TILE:
        raise ValueError(f"tile={tile} resolves to a rounding tile of {t} columns over {c}; "
                         f"it must be a positive multiple of {TILE}")
    return t


def _rounding_tile(q0, b: int, bp: int, tile: int) -> int:
    """The rounding tile of a backward over the plane ``q0`` [n, D];
    ``TILE`` on an f32 plane, which rounds nothing."""
    if q0.dtype == torch.float32:
        return TILE
    return round_tile(q0.shape[0], max(b, bp), q0.shape[1], tile, q0.element_size())


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


def plane_rows(queue, qscales, plane: int, idx):
    """f32 rows ``idx`` of one queue plane — a B-row gather; the planes are
    never copied — dequantised with their scales for an int8 queue
    (``qscales`` [2, Q]; None for float queues)."""
    r = queue[plane][idx].float()
    if qscales is not None:
        r = r * qscales[plane][idx].float()[:, None]
    return r


def _label_rows(queue, g, rows, cols, seen, labels, qscales=None):
    safe = labels.clamp(min=0).long()
    r0 = plane_rows(queue, qscales, 0, safe)
    r1 = plane_rows(queue, qscales, 1, safe)
    return effective_rows(r0, r1, safe, g.float(), rows.long(), cols.long(), seen.float())


def compute_twin_gt(emb, queue, g, rows, cols, seen, labels, qscales=None):
    """(gt1, gt2): target cosines against both effective views."""
    r0_eff, rb_eff = _label_rows(queue, g, rows, cols, seen, labels, qscales)
    e = emb.float()
    return (e * r0_eff).sum(-1), (e * rb_eff).sum(-1)


def twin_gt_tail(emb, queue, g, rows, cols, seen, labels, gt1, gt2, dgt1, dgt2, d_emb,
                 loss_type, margin, qscales=None):
    """Route the φ'(gt)·d_gt paths into d_emb via the effective label rows."""
    r0_eff, rb_eff = _label_rows(queue, g, rows, cols, seen, labels, qscales)
    pos = (labels >= 0).float()[:, None]
    d_emb = d_emb + (dgt1 * phi_prime(gt1, loss_type, margin))[:, None] * r0_eff * pos
    d_emb = d_emb + (dgt2 * phi_prime(gt2, loss_type, margin))[:, None] * rb_eff * pos
    return d_emb.to(emb.dtype)


def dir_inputs(queue, g, rows, cols, seen, qscales=None):
    """(g32, rows_i, cols_i, v, blend) carrier pack for one direction."""
    cols_i = cols.to(torch.int32)
    rows_i = rows.to(torch.int32)
    g32 = g.float()
    v, blend = twin_write_values(plane_rows(queue, qscales, 1, cols_i.long()), g32, rows_i,
                                 cols_i, seen.float())
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
# plain versions of the kernels (packed layout, chunked over Q)
# ----------------------------------------------------------------------


def _chunk_writers(rows, cols, blend, bp, lo, hi):
    """Per direction (``bp`` writes each), the last parity-0 writer and
    last blend writer of each column in [lo, hi): two [nd, hi - lo] int64
    arrays, −1 = none. A column of −1 (another shard's write) never
    matches."""
    n = hi - lo
    nd = cols.shape[0] // bp
    dev = cols.device
    last0 = torch.full((nd, n), -1, dtype=torch.long, device=dev)
    lastb = torch.full((nd, n), -1, dtype=torch.long, device=dev)
    idx = torch.arange(bp, device=dev)
    for d in range(nd):
        ws = slice(d * bp, (d + 1) * bp)
        c = cols[ws].long() - lo
        inr = (cols[ws] >= 0) & (c >= 0) & (c < n)
        for last, sel in ((last0, rows[ws] == 0), (lastb, blend[ws] > 0)):
            m = inr & sel
            last[d].scatter_reduce_(0, c[m], idx[m], reduce="amax")
    return last0, lastb


def _tile_hits(cols, bp, lo, hi, rtile):
    """[nd, hi - lo] bool: whether the rounding tile [⌊c/T⌋·T, +T) holding
    each column c of [lo, hi) holds a write of the direction, whatever its
    parity and blend (JAX's per-tile ``tile_hit``; T = ``rtile``). A column
    of −1 never counts."""
    nd = cols.shape[0] // bp
    span = torch.arange(lo, hi, device=cols.device) // rtile
    hit = torch.empty((nd, hi - lo), dtype=torch.bool, device=cols.device)
    for d in range(nd):
        c = cols[d * bp:(d + 1) * bp].long()
        hit[d] = torch.isin(span, c[c >= 0] // rtile)
    return hit


def _written_cos(cos, E, G, V, last0, lastb, b, bp):
    """(view-1 cos, view-2 cos) of one chunk: written columns are replaced
    by the probe's dots with the written rows (g, or v for blend slots).
    Probe rows come b per direction, writes bp."""
    nd = E.shape[0] // b
    c1 = cos.clone()
    for d in range(nd):
        rs, ws = slice(d * b, (d + 1) * b), slice(d * bp, (d + 1) * bp)
        j0 = torch.nonzero(last0[d] >= 0).flatten()
        if j0.numel():
            c1[rs, j0] = E[rs] @ G[ws][last0[d, j0]].T
    c2 = c1.clone()
    for d in range(nd):
        rs, ws = slice(d * b, (d + 1) * b), slice(d * bp, (d + 1) * bp)
        jb = torch.nonzero(lastb[d] >= 0).flatten()
        if jb.numel():
            c2[rs, jb] = E[rs] @ V[ws][lastb[d, jb]].T
    return c1, c2


def _dot_operands(E, G, V, q0):
    """The probe and write rows as the dots read them: as given on an f32
    queue, rounded to bf16 on every other form."""
    if q0.dtype == torch.float32:
        return E, G, V
    return _bf16(E), _bf16(G), _bf16(V)


def _clean_cos(E, w, s, e8):
    """[R, n] cosines of the (operand-rounded) probes against the stored
    rows ``w`` [n, D]: int8 rows are scaled per column after the dot
    (``s``); int8 compute dots the quantised probes (an exact integer sum
    in f32: |products| <= 127², sums < 2^24 at D <= 1024)."""
    wf = w.float()
    if e8 is not None:
        return (e8[0].float() @ wf.T) * (e8[1][:, None] * s[None, :])
    cos = E @ wf.T
    return cos if s is None else cos * s[None, :]


def _check_form(q0, qscales, e8):
    form = queue_form(q0, e8)
    if form == "?":
        raise ValueError(f"the queue plane must be float32, bfloat16 or int8, got {q0.dtype}")
    if (form in ("int8", "int8c")) != (qscales is not None):
        raise ValueError("an int8 queue plane takes its scales (qscales), a float one none")
    return form


def _stream_plain(E, q0, G, V, rows, cols, blend, labels, gt, *, b, bp, loss_type, margin,
                  scale, k, mask_svfc, qscales=None, e8=None, chunk=32768, twin=False):
    """The running (max, sumexp) of z and the top-k cosines of each (view,
    row) over the columns of ``q0`` [n, D]; (−inf, 0) where a row has no
    column. The quad excludes the target column from the stream, the twin
    (``twin``) streams it as z = scale·φ(gt); neither puts it in the
    top-k."""
    _check_form(q0, qscales, e8)
    r_, _ = E.shape
    n_q = q0.shape[0]
    dev = E.device
    Eo, Go, Vo = _dot_operands(E, G, V, q0)
    # the target column's z: scale·φ(gt) in the twin, none in the quad
    zt = scale * phi_target(gt, loss_type, margin) if twin else torch.full_like(gt, -math.inf)
    m = torch.full((2, r_), -math.inf, device=dev)
    s = torch.zeros((2, r_), device=dev)
    topk = torch.full((2, r_, k), NEG_INF, device=dev)
    for lo in range(0, n_q, chunk):
        hi = min(n_q, lo + chunk)
        sc = None if qscales is None else qscales[lo:hi]
        cos = _clean_cos(Eo, q0[lo:hi], sc, e8)
        last0, lastb = _chunk_writers(rows, cols, blend, bp, lo, hi)
        views = _written_cos(cos, Eo, Go, Vo, last0, lastb, b, bp)
        is_target = torch.arange(lo, hi, device=dev)[None, :] == labels[:, None].long()
        for v, cv in enumerate(views):
            mod = sv_boost(cv, gt[v][:, None], margin, mask_svfc)[0] if loss_type == "SV" else cv
            z = torch.where(is_target, zt[v][:, None].expand_as(mod), scale * mod)
            m_new = torch.maximum(m[v], z.max(dim=1).values)
            ref = torch.where(torch.isinf(m_new), torch.zeros_like(m_new), m_new)
            s[v] = s[v] * torch.exp(m[v] - ref) + torch.exp(z - ref[:, None]).sum(dim=1)
            m[v] = m_new
            cand = torch.where(is_target, torch.full_like(cv, NEG_INF), cv)
            topk[v] = torch.topk(torch.cat([topk[v], cand], dim=1), k, dim=1).values
    return m, s, topk


def quad_fwd_plain(E, q, G, V, rows, cols, blend, labels, gt, *, b, loss_type, margin,
                   scale, k, mask_svfc, qscales=None, e8=None, chunk=32768):
    """Plain PyTorch version of the forward kernel; same inputs and outputs
    as ``quad_fwd``."""
    m, s, topk = quad_partial_fwd_plain(E, q[0], G, V, rows, cols, blend, labels, gt, b=b, bp=b,
                                        loss_type=loss_type, margin=margin, scale=scale, k=k,
                                        mask_svfc=mask_svfc, qscales=qscales, e8=e8,
                                        chunk=chunk)
    return finalize_fwd(m, s, topk, labels, gt, loss_type=loss_type, margin=margin, scale=scale)


def quad_partial_fwd_plain(E, q0, G, V, rows, cols, blend, labels, gt, *, b, bp, loss_type,
                           margin, scale, k, mask_svfc, qscales=None, e8=None, chunk=32768):
    """Plain PyTorch version of the partial forward kernel: the running
    (max, sumexp) of the target-excluded z and the top-k cosines of each
    (view, row) over the columns of ``q0`` [Q, D]; ``quad_partial_fwd``'s
    inputs and outputs. (−inf, 0) where a row has no column."""
    return _stream_plain(E, q0, G, V, rows, cols, blend, labels, gt, b=b, bp=bp,
                         loss_type=loss_type, margin=margin, scale=scale, k=k,
                         mask_svfc=mask_svfc, qscales=qscales, e8=e8, chunk=chunk)


def finalize_fwd(m, s, topk, labels, gt, *, loss_type, margin, scale):
    """(ce, neg, logz, topk) from the negative stream's (m, s, top-k): the
    target term scale·φ(gt) joins the logsumexp on positive rows."""
    lse_neg = torch.where(s > 0, m + torch.log(s), torch.full_like(s, -math.inf))
    zt = scale * phi_target(gt, loss_type, margin)
    pos = (labels >= 0)[None, :]
    mf = torch.maximum(lse_neg, zt)
    logz = torch.where(pos, mf + torch.log(torch.exp(lse_neg - mf) + torch.exp(zt - mf)), lse_neg)
    ce = torch.where(pos, logz - zt, torch.zeros_like(logz))
    neg = torch.where(pos, torch.zeros_like(logz), topk.clamp(min=0.0).mean(dim=-1))
    return ce, neg, logz, topk


def finalize_twin(m, s, topk, labels, gt, *, loss_type, margin, scale):
    """(ce, neg, logz, topk) from the twin stream's (m, s, top-k), whose
    sum holds the target term already: logz = m + log s."""
    logz = torch.where(s > 0, m + torch.log(s), torch.full_like(s, -math.inf))
    zt = scale * phi_target(gt, loss_type, margin)
    pos = (labels >= 0)[None, :]
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


def _combined_dcos(cos, logz, kth, dce, dneg, *, scale, k):
    """Arc / AM: d_cos of both views of a column that neither view
    overrides, in one form (JAX's ``_quad_dir_bwd_shared`` clean tile):
    exp(z − ref)·c12 plus each view's hard-negative term, z = scale·cos,
    ref = min(logz1, logz2)."""
    ref = torch.minimum(logz[0], logz[1])[:, None]
    c12 = (dce[0][:, None] * torch.exp(ref - logz[0][:, None])
           + dce[1][:, None] * torch.exp(ref - logz[1][:, None])) * scale
    z = scale * cos
    dc = torch.exp(z - ref) * c12
    inv_k = _f32(1.0 / k)
    for v in range(2):
        zthr = torch.clamp(scale * (kth[v] - KTH_TIE_TOL), min=1e-20)[:, None]
        dc = dc + torch.where(z >= zthr, (dneg[v] * inv_k)[:, None], torch.zeros_like(dc))
    return dc


def quad_bwd_plain(E, q, G, V, rows, cols, blend, labels, gt, logz, kth, dce, dneg, *, b,
                   loss_type, margin, scale, k, mask_svfc, qscales=None, e8=None, tile=512,
                   chunk=32768):
    """Plain PyTorch version of the backward kernel; same inputs and
    outputs as ``quad_bwd``."""
    return quad_partial_bwd_plain(E, q[0], G, V, rows, cols, blend, labels, gt, logz, kth, dce,
                                  dneg, b=b, bp=b, loss_type=loss_type, margin=margin,
                                  scale=scale, k=k, mask_svfc=mask_svfc, qscales=qscales, e8=e8,
                                  tile=tile, chunk=chunk)


def _demb_coefs(d1, d2, o0, ob, hit, clean, s):
    """One direction's d_cos coefficients of a chunk on a bf16 or int8
    plane (module docstring): (to the stored rows, to the parity-0 writes
    g, to the blend writes v), each rounded to bf16 as the JAX kernel
    rounds it. ``o0`` / ``ob``: the column is overridden in view 1 / view
    2; ``hit``: its rounding tile holds a write of the direction;
    ``clean``: the d_cos of a clean tile; ``s``: int8 column scales or
    None."""
    zero = torch.zeros_like(d1)
    if s is None:  # bf16: each view's d_cos rounded alone
        r1, r2 = _bf16(d1), _bf16(d2)
        a = torch.where(ob, r1, r1 + r2)  # view 2 reads view 1's row
        cq = torch.where(hit, torch.where(o0, zero, a), _bf16(clean))
        return cq, torch.where(o0, a, zero), torch.where(ob, r2, zero)
    a = torch.where(ob, d1, d1 + d2)
    cq = _bf16(torch.where(hit, torch.where(o0, zero, a), clean) * s[None, :])
    return cq, _bf16(torch.where(o0, a, zero)), _bf16(torch.where(ob, d2, zero))


def quad_partial_bwd_plain(E, q0, G, V, rows, cols, blend, labels, gt, logz, kth, dce, dneg, *,
                           b, bp, loss_type, margin, scale, k, mask_svfc, qscales=None, e8=None,
                           tile=512, chunk=32768):
    """Plain PyTorch version of the partial backward kernel: d_emb over the
    columns of ``q0`` and d_gt where the (shard-local) label is ≥ 0;
    ``quad_partial_bwd``'s inputs and outputs."""
    return _bwd_plain(E, q0, G, V, rows, cols, blend, labels, gt, logz, kth, dce, dneg, b=b,
                      bp=bp, loss_type=loss_type, margin=margin, scale=scale, k=k,
                      mask_svfc=mask_svfc, qscales=qscales, e8=e8,
                      rtile=_rounding_tile(q0, b, bp, tile), chunk=chunk)


def _bwd_plain(E, q0, G, V, rows, cols, blend, labels, gt, logz, kth, dce, dneg, *, b, bp,
               loss_type, margin, scale, k, mask_svfc, qscales=None, e8=None, rtile=TILE,
               chunk=32768, twin=False):
    """d_emb over the columns of ``q0`` (the q0 / g / v paths) and d_gt,
    the target column's dz, where the (shard-local) label is ≥ 0, with the
    clean / written choice per rounding tile ``rtile``. The twin's clean
    tile sums the two views' d_cos for every loss type."""
    form = _check_form(q0, qscales, e8)
    r_, d_ = E.shape
    nd = r_ // b
    n_q = q0.shape[0]
    dev = E.device
    Eo, Go, Vo = _dot_operands(E, G, V, q0)
    d_emb = torch.zeros((r_, d_), device=dev)
    pos = (labels >= 0)[:, None]
    kw = dict(loss_type=loss_type, margin=margin, scale=scale, k=k, mask_svfc=mask_svfc)
    for lo in range(0, n_q, chunk):
        hi = min(n_q, lo + chunk)
        w = q0[lo:hi].float()
        sc = None if qscales is None else qscales[lo:hi]
        cos = _clean_cos(Eo, w, sc, e8)
        last0, lastb = _chunk_writers(rows, cols, blend, bp, lo, hi)
        c1, c2 = _written_cos(cos, Eo, Go, Vo, last0, lastb, b, bp)
        neg_ok = torch.arange(lo, hi, device=dev)[None, :] != labels[:, None].long()
        dc = [torch.where(neg_ok,
                          _dcos(cv, gt[v][:, None], logz[v][:, None], kth[v][:, None],
                                dce[v][:, None], dneg[v][:, None], pos, **kw),
                          torch.zeros_like(cv))
              for v, cv in enumerate((c1, c2))]
        if form != "f32":
            if twin or loss_type == "SV":
                clean = dc[0] + dc[1]
            else:
                clean = torch.where(neg_ok, _combined_dcos(cos, logz, kth, dce, dneg,
                                                           scale=scale, k=k),
                                    torch.zeros_like(cos))
            hits = _tile_hits(cols, bp, lo, hi, rtile)
        for d in range(nd):
            rs, ws = slice(d * b, (d + 1) * b), slice(d * bp, (d + 1) * bp)
            j0 = torch.nonzero(last0[d] >= 0).flatten()
            jb = torch.nonzero(lastb[d] >= 0).flatten()
            if form != "f32":
                cq, cg, cv = _demb_coefs(dc[0][rs], dc[1][rs], (last0[d] >= 0)[None, :],
                                         (lastb[d] >= 0)[None, :], hits[d][None, :],
                                         clean[rs], sc)
                d_emb[rs] += (cq @ w + cg[:, j0] @ Go[ws][last0[d, j0]]
                              + cv[:, jb] @ Vo[ws][lastb[d, jb]])
                continue
            if not (j0.numel() or jb.numel()):
                d_emb[rs] += (dc[0][rs] + dc[1][rs]) @ w
                continue
            w0e = w.clone()
            w0e[j0] = G[ws][last0[d, j0]]
            wbe = w0e.clone()
            wbe[jb] = V[ws][lastb[d, jb]]
            d_emb[rs] += dc[0][rs] @ w0e + dc[1][rs] @ wbe
    zt = scale * phi_target(gt, loss_type, margin)
    dgt = torch.where((labels >= 0)[None, :], (torch.exp(zt - logz) - 1.0) * dce * scale,
                      torch.zeros_like(zt))
    return d_emb, dgt


def twin_fwd_plain(E, q, G, V, rows, cols, blend, labels, gt, *, loss_type, margin, scale, k,
                   mask_svfc, chunk=32768):
    """Plain PyTorch version of the twin forward kernel; same inputs and
    outputs as ``twin_fwd``."""
    m, s, topk = twin_partial_fwd_plain(E, q[0], G, V, rows, cols, blend, labels, gt,
                                        loss_type=loss_type, margin=margin, scale=scale, k=k,
                                        mask_svfc=mask_svfc, chunk=chunk)
    return finalize_twin(m, s, topk, labels, gt, loss_type=loss_type, margin=margin, scale=scale)


def twin_partial_fwd_plain(E, q0, G, V, rows, cols, blend, labels, gt, *, loss_type, margin,
                           scale, k, mask_svfc, chunk=32768):
    """Plain PyTorch version of the twin partial forward kernel: each
    (view, row)'s raw (max, sumexp) over the block ``q0`` [n, D], target
    included where the row's (shard-local) label is here, and its
    target-excluded top-k; ``twin_partial_fwd``'s inputs and outputs."""
    return _stream_plain(E, q0, G, V, rows, cols, blend, labels, gt, b=E.shape[0],
                         bp=rows.shape[0], loss_type=loss_type, margin=margin, scale=scale, k=k,
                         mask_svfc=mask_svfc, chunk=chunk, twin=True)


def twin_bwd_plain(E, q, G, V, rows, cols, blend, labels, gt, logz, kth, dce, dneg, *,
                   loss_type, margin, scale, k, mask_svfc, tile=512, chunk=32768):
    """Plain PyTorch version of the twin backward kernel; same inputs and
    outputs as ``twin_bwd``."""
    return twin_partial_bwd_plain(E, q[0], G, V, rows, cols, blend, labels, gt, logz, kth, dce,
                                  dneg, loss_type=loss_type, margin=margin, scale=scale, k=k,
                                  mask_svfc=mask_svfc, tile=tile, chunk=chunk)


def twin_partial_bwd_plain(E, q0, G, V, rows, cols, blend, labels, gt, logz, kth, dce, dneg, *,
                           loss_type, margin, scale, k, mask_svfc, tile=512, chunk=32768):
    """Plain PyTorch version of the twin partial backward kernel;
    ``twin_partial_bwd``'s inputs and outputs."""
    b, bp = E.shape[0], rows.shape[0]
    return _bwd_plain(E, q0, G, V, rows, cols, blend, labels, gt, logz, kth, dce, dneg, b=b,
                      bp=bp, loss_type=loss_type, margin=margin, scale=scale, k=k,
                      mask_svfc=mask_svfc, rtile=_rounding_tile(q0, b, bp, tile), chunk=chunk,
                      twin=True)


# ----------------------------------------------------------------------
# the CUDA kernels (csrc/quad_margin.cu)
# ----------------------------------------------------------------------

_LOSS_CODE = {"AM": 0, "Arc": 1, "SV": 2}
_FORM_CODE = {form: i for i, form in enumerate(FORMS)}
_P = ctypes.c_void_p
_FWD_ARGTYPES = [
    _P, ctypes.c_longlong, ctypes.c_int,  # q0, Q, D
    _P, _P, _P,  # E, G, V
    _P, _P, _P, _P,  # rows, cols, blend, labels
    _P,  # gt [2, R]
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # b, bp, R, k
    ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_float,  # loss, margin, scale, svfc
    ctypes.c_float, ctypes.c_float,  # cos(margin), sin(margin)
    _P, _P, _P,  # int8 column scales [Q], E8 [R, D], se [R]
    _P, ctypes.c_int,  # E as bf16 [R, D] (bf16 form); the form
    ctypes.c_int, ctypes.c_int,  # the rounding tile; the twin head
]


def _lib():
    from vlsfr_tpu_torch.ops.cuda_build import load_library

    lib = load_library("quad_margin")
    if not getattr(lib, "_vlsfr_typed", False):
        blocks = [_P, _P, ctypes.c_int, ctypes.c_longlong]  # part, wcos, nchunk, cols_per_chunk
        lib.quad_fwd_launch.argtypes = _FWD_ARGTYPES + blocks + [_P] * 5  # ce neg logz topk stream
        lib.quad_partial_fwd_launch.argtypes = _FWD_ARGTYPES + blocks + [_P] * 4  # m s topk stream
        lib.quad_fwd_launch.restype = lib.quad_partial_fwd_launch.restype = ctypes.c_int
        lib.quad_fwd_smem.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.quad_fwd_smem.restype = ctypes.c_int
        lib.quad_bwd_launch.argtypes = _FWD_ARGTYPES + [
            _P, _P, _P, _P,  # logz, kth, dce, dneg [2, R]
            _P, _P, _P,  # part, wcoef, wcos
            ctypes.c_int, ctypes.c_longlong,  # nchunk, cols_per_chunk
            _P, _P, _P]  # d_emb, dgt, stream
        lib.quad_bwd_launch.restype = ctypes.c_int
        lib.quad_clean_cos_launch.argtypes = _FWD_ARGTYPES + [ctypes.c_int, _P, _P]
        lib.quad_clean_cos_launch.restype = ctypes.c_int
        lib.quad_error_string.argtypes = [ctypes.c_int]
        lib.quad_error_string.restype = ctypes.c_char_p
        lib._vlsfr_typed = True
    return lib


def _check(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           f"{lib.quad_error_string(err).decode()} (cudaError {err})")


def _check_queue(q, d_):
    if q.dim() != 3 or q.shape[0] != 2 or q.shape[2] != d_:
        raise ValueError(f"queue must be [2, Q, {d_}], got {tuple(q.shape)}")


def _check_packed(E, q0, G, V, rows, cols, blend, labels, gt, b, bp, k, loss_type,
                  qscales=None, e8=None, extra=(), nd=2) -> str:
    """Types, shapes, device and (for the card) contiguity of the packed
    inputs: ``q0`` is the streamed queue plane [Q, D], b probes and bp
    writes per direction, ``nd`` directions (2: the quad, 1: the twin); an
    int8 plane's ``qscales`` [Q] and the int8-compute probes ``e8``.
    Returns the form."""
    if loss_type not in LOSS_TYPES:
        raise ValueError(f"loss_type must be AM | Arc | SV, got {loss_type!r}")
    r_, d_ = E.shape
    if r_ != nd * b:
        raise ValueError(f"E has {r_} rows, expected {nd}*b = {nd * b}")
    if q0.dim() != 2 or q0.shape[1] != d_:
        raise ValueError(f"the queue plane must be [Q, {d_}], got {tuple(q0.shape)}")
    if not 1 <= k <= KMAX:
        raise ValueError(f"hard_neg k={k} outside [1, {KMAX}]")
    form = _check_form(q0, qscales, e8)
    rw = nd * bp
    opt = []
    if qscales is not None:
        opt.append(("qscales", qscales, torch.float32, (q0.shape[0],)))
    if e8 is not None:
        opt += [("E8", e8[0], torch.int8, (r_, d_)), ("se", e8[1], torch.float32, (r_,))]
    for name, t, dt, shape in (
            ("E", E, torch.float32, (r_, d_)), ("queue", q0, q0.dtype, tuple(q0.shape)),
            ("G", G, torch.float32, (rw, d_)), ("V", V, torch.float32, (rw, d_)),
            ("rows", rows, torch.int32, (rw,)), ("cols", cols, torch.int32, (rw,)),
            ("blend", blend, torch.int32, (rw,)), ("labels", labels, torch.int32, (r_,)),
            ("gt", gt, torch.float32, (2, r_)), *opt, *extra):
        if t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {dt} {shape}, got {t.dtype} {tuple(t.shape)}")
        if t.device != E.device:
            raise ValueError(f"{name} is on {t.device}, E on {E.device}")
        if E.is_cuda and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return form


def _bwd_vectors(E, logz, kth, dce, dneg):
    vec = (2, E.shape[0])
    return (("logz", logz, torch.float32, vec), ("kth", kth, torch.float32, vec),
            ("dce", dce, torch.float32, vec), ("dneg", dneg, torch.float32, vec))


def _cuda_shape_limits(E):
    d_ = E.shape[1]
    if not kernel_width_ok(d_):
        raise ValueError(f"the quad and twin kernels take a feature width that is a multiple "
                         f"of 64 up to 512; got D={d_}")


def _common_args(E, q0, G, V, rows, cols, blend, labels, gt, b, bp, k, loss_type, margin,
                 scale, mask_svfc, qscales, e8, rtile=TILE, twin=False):
    """The launch entries' leading arguments. E, G and V go to the kernel
    as its dots read them (``_dot_operands``), and on a bf16 or int8-storage
    queue E also as bf16 (the same values: the tensor cores' operand);
    returns the tensors that must outlive the launch, and the arguments."""
    Eo, Go, Vo = _dot_operands(E, G, V, q0)
    form = queue_form(q0, e8)
    Eb = Eo.to(torch.bfloat16) if form in ("bf16", "int8") else None
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    e8q, e8s = (None, None) if e8 is None else e8
    args = (q0.data_ptr(), q0.shape[0], E.shape[1], Eo.data_ptr(), Go.data_ptr(), Vo.data_ptr(),
            rows.data_ptr(), cols.data_ptr(), blend.data_ptr(), labels.data_ptr(),
            gt.data_ptr(), b, bp, E.shape[0], k, _LOSS_CODE[loss_type], margin, scale,
            mask_svfc, _f32(math.cos(margin)), _f32(math.sin(margin)), ptr(qscales), ptr(e8q),
            ptr(e8s), ptr(Eb), _FORM_CODE[form], rtile, int(twin))
    return (Eo, Go, Vo, Eb), args


def _split_columns(n_q, n_parts):
    """(parts, columns per part): a tile-multiple split of [0, Q)."""
    tiles = -(-n_q // TILE)
    per = -(-tiles // max(min(n_parts, tiles), 1)) * TILE
    return -(-n_q // per), per


class FwdGeometry(NamedTuple):
    """The forward kernel's launch (``fwd_geometry``)."""

    rows_per_block: int  # probe rows a block holds: a row group
    n_rg: int  # row groups
    nchunk: int  # column ranges, each of cols_per_chunk columns (the last may hold fewer)
    cols_per_chunk: int
    wcos: tuple  # [R, 2, bp]: the written columns' cosines, formed once a launch
    smem: int  # bytes of shared memory a block (csrc/quad_margin.cu: f_smem, whatever D)


FWD_F32_CHUNK, FWD_DMAX = 32, 512  # the f32 form's features a chunk; the largest D


def fwd_geometry(form: str, r_: int, q: int, sms: int, bp: int) -> FwdGeometry:
    """The forward kernel's grid over R probe rows and Q columns on a card
    of ``sms`` SMs, bp writes per direction: one block an SM, each a row
    group over a 64-multiple column range, the row groups of a range
    adjacent (they share its queue tiles through L2); the written columns'
    cosines [R, 2, bp] formed before the block pass. Any R: the f32
    form's block holds 128 rows up to R = 128, else 256 (every probe row
    up to R = 256, then row groups of 256), and stages 32
    features of E's rows and of the queue tile a chunk (a row stride of 36
    floats); the tensor-core forms' block holds 128 rows, E's resident in
    shared memory for D <= 512 (bf16, or int8c's int8), and stages 128
    bytes of each queue row a chunk. Six chunks staged (three for f32 and
    int8, whose queue words wait in registers), the [rows, 64 + 4] f32
    cosine tile and two tiles' write plans."""
    rows = 128 if form != "f32" or r_ <= 128 else 256
    n_rg = -(-r_ // rows)
    nchunk, per = _split_columns(q, max(sms // n_rg, 1))
    if form == "f32":
        resident, stage = 0, (rows + TILE) * 4 * (FWD_F32_CHUNK + 4)
    else:
        resident, stage = rows * FWD_DMAX * (1 if form == "int8c" else 2), TILE * 128
    stages = 6 if form in ("bf16", "int8c") else 3
    smem = resident + stages * stage + 4 * rows * (TILE + 4) + 4 * 2 * (4 * TILE + 4)
    return FwdGeometry(rows, n_rg, nchunk, per, (r_, 2, bp), smem)


def _fwd_launch(entry, n_vec, E, q0, G, V, rows, cols, blend, labels, gt, *, b, bp, loss_type,
                margin, scale, k, mask_svfc, qscales=None, e8=None, twin=False):
    """Launch ``entry`` (the forward or its partial form, of the quad or,
    with ``twin``, the twin head): the written cosines, the block pass over
    q0, then the merge. Returns n_vec [2, R] outputs and topk [2, R, k]."""
    _cuda_shape_limits(E)
    lib = _lib()
    r_ = E.shape[0]
    sms = torch.cuda.get_device_properties(E.device).multi_processor_count
    geo = fwd_geometry(queue_form(q0, e8), r_, q0.shape[0], sms, bp)
    nchunk, per = geo.nchunk, geo.cols_per_chunk
    part = torch.empty((nchunk, 2, r_, 2 + KMAX), device=E.device)
    wcos = torch.empty(geo.wcos, device=E.device)
    vecs = [torch.empty((2, r_), device=E.device) for _ in range(n_vec)]
    topk = torch.empty((2, r_, k), device=E.device)
    stream = torch.cuda.current_stream(E.device).cuda_stream
    _keep, args = _common_args(E, q0, G, V, rows, cols, blend, labels, gt, b, bp, k, loss_type,
                               margin, scale, mask_svfc, qscales, e8, twin=twin)
    err = getattr(lib, entry)(*args, part.data_ptr(), wcos.data_ptr(), nchunk, per,
                              *(v.data_ptr() for v in vecs), topk.data_ptr(), stream)
    _check(lib, err, entry)
    return (*vecs, topk)


class BwdGeometry(NamedTuple):
    """The backward kernel's launch (``bwd_geometry``)."""

    rows_per_block: int  # probe rows a block holds: a row group
    blocks_per_sm: int
    n_rg: int  # row groups
    nchunk: int  # column chunks, each of cols_per_chunk columns (the last may hold fewer)
    cols_per_chunk: int
    wcoef: tuple  # [R, 2, bp]: the d_cos of written columns towards this step's writes
    wcos: tuple | None  # the f32 form's [R, 2, bp] written cosines, formed once a launch


def bwd_geometry(form: str, r_: int, q: int, sms: int, bp: int) -> BwdGeometry:
    """The backward kernel's grid over R probe rows and Q columns on a card
    of ``sms`` SMs, bp writes per direction. Every form's block holds 64
    rows and fills an SM's shared memory (the f32 kernel: the q0 tile
    staged once for both products, 186 KiB at D = 512; the tensor-core
    forms: two tiles in flight), one block an SM, so the grid is one wave.
    Each sends the d_cos of written columns to ``wcoef``; the f32 kernel
    also takes those columns' cosines from ``wcos``, formed before it."""
    n_rg = -(-r_ // 64)
    nchunk, per = _split_columns(q, max(sms // n_rg, 1))
    return BwdGeometry(64, 1, n_rg, nchunk, per, (r_, 2, bp),
                       (r_, 2, bp) if form not in TC_FORMS else None)


def _bwd_launch(E, q0, G, V, rows, cols, blend, labels, gt, logz, kth, dce, dneg, *, b, bp,
                loss_type, margin, scale, k, mask_svfc, rtile, qscales=None, e8=None,
                twin=False):
    _cuda_shape_limits(E)
    lib = _lib()
    r_ = E.shape[0]
    sms = torch.cuda.get_device_properties(E.device).multi_processor_count
    geo = bwd_geometry(queue_form(q0, e8), r_, q0.shape[0], sms, bp)
    nchunk, per = geo.nchunk, geo.cols_per_chunk
    part = torch.empty((nchunk, r_, E.shape[1]), device=E.device)
    wcoef = torch.zeros(geo.wcoef, device=E.device)
    wcos = None if geo.wcos is None else torch.empty(geo.wcos, device=E.device)
    d_emb = torch.empty_like(E)
    dgt = torch.empty((2, r_), device=E.device)
    stream = torch.cuda.current_stream(E.device).cuda_stream
    _keep, args = _common_args(E, q0, G, V, rows, cols, blend, labels, gt, b, bp, k, loss_type,
                               margin, scale, mask_svfc, qscales, e8, rtile, twin)
    err = lib.quad_bwd_launch(*args, logz.data_ptr(), kth.data_ptr(), dce.data_ptr(),
                              dneg.data_ptr(), part.data_ptr(), wcoef.data_ptr(),
                              None if wcos is None else wcos.data_ptr(), nchunk, per,
                              d_emb.data_ptr(), dgt.data_ptr(), stream)
    _check(lib, err, "quad_bwd")
    return d_emb, dgt


def quad_fwd(E, q, G, V, rows, cols, blend, labels, gt, *, b, loss_type, margin, scale, k,
             mask_svfc, qscales=None, e8=None):
    """Streaming forward of both directions × both views over q0.

    Returns (ce, neg, logz) [2, R] and topk [2, R, k] (view-major). ``q``
    is f32, bf16 or int8; an int8 queue takes plane 0's scales ``qscales``
    [Q], and the int8-compute form also ``e8`` (module docstring).

    Replaces ``vlsfr_tpu/ops/twin_margin.py:pallas_quad_fwd``. Bound on an
    H100 at the slice shapes (R = 256, D = 512, Q = 2^20, f32): 2·R·D·Q =
    2.75e11 FLOP of f32 dot products over 2.15 GB of q0 — compute-bound at
    the 67 TFLOP/s f32 rate (~4.1 ms) rather than at 3.35 TB/s (~0.64 ms).
    The other forms' bounds take the tensor cores' dense rates (989
    TFLOP/s bf16, 1,979 TOPS int8) the TPU kernel's matrix unit stands for:
    int8 compute at Q = 10,485,760 is HBM-bound (5.37 GB, ~1.6 ms).
    Design (csrc/quad_margin.cu; ``fwd_geometry``): the written columns'
    cosines first, once a launch; then one block an SM per contiguous
    column range reads each q0 tile once for all 2b probe rows, staged by
    cp.async, and streams the previous tile's cosines into per-row running
    (max, sumexp) chains and a register top-k under the next tile's
    product; each block writes a partial, and a second launch merges the
    partials in a fixed order (deterministic). The forms differ in the dot,
    each the backward's recompute's chain: f32 FMA (f32); the tensor cores'
    k16 chain over bf16 operands (bf16, and int8 storage with its tile
    widened to bf16 and scaled after the dot); ``mma.sync`` s8 into int32
    (int8 compute).
    """
    _check_queue(q, E.shape[1])
    form = _check_packed(E, q[0], G, V, rows, cols, blend, labels, gt, b, b, k, loss_type,
                         qscales, e8)
    kw = dict(b=b, loss_type=loss_type, margin=margin, scale=scale, k=k, mask_svfc=mask_svfc,
              qscales=qscales, e8=e8)
    if not E.is_cuda:
        return quad_fwd_plain(E, q, G, V, rows, cols, blend, labels, gt, **kw)
    out = _fwd_launch("quad_fwd_launch", 3, E, q[0], G, V, rows, cols, blend, labels, gt, bp=b,
                      **kw)
    LAUNCH_COUNTS[kernel_name("quad_fwd", form)] += 1
    return out


def quad_bwd(E, q, G, V, rows, cols, blend, labels, gt, logz, kth, dce, dneg, *, b,
             loss_type, margin, scale, k, mask_svfc, qscales=None, e8=None, tile=512):
    """Streaming backward: re-streams q0 and returns (d_emb [R, D] — the
    q0/g/v paths, before the φ'(gt) tail — and d_gt [2, R]). ``dce`` /
    ``dneg`` come pre-masked (0 on outlier / positive rows). Forms as
    ``quad_fwd``'s; the rounded forms round d_cos per rounding tile of the
    requested ``tile`` (``round_tile`` over Q columns and b rows).

    Replaces ``vlsfr_tpu/ops/twin_margin.py:pallas_quad_bwd``. Bound on an
    H100 at the slice shapes (f32): 2 × 2.75e11 FLOP (cosine recompute +
    the d_cos @ q0 product) ≈ 8.2 ms at the 67 TFLOP/s f32 rate; q0's
    2.15 GB read once is 0.64 ms; the int8 forms at Q = 10,485,760 are
    operations-bound on the tensor cores (int8 storage 5.6 ms, int8
    compute 4.2). Design: each block owns 64 probe rows × one column range
    (``bwd_geometry``), one block an SM, its d_emb partial [64, D] in
    registers. The f32 kernel runs IEEE f32 FMA on the CUDA cores: each q0
    tile staged once, by cp.async, for both register-blocked products (the
    recompute, then d_cos, the views' terms summed, times the tile); the
    bf16 and int8 forms run both products on the tensor cores
    (``mma.sync``: the recompute in bf16, or s8 for int8 compute; d_cos
    rounded to bf16 times the tile as bf16). The written columns stay out
    of the products: their d_cos towards this step's writes goes to
    ``wcoef`` for the merge (the f32 kernel takes their cosines from
    ``wcos``, formed once a launch). The row groups of one column range are
    adjacent in launch order and share the q0 tile through L2. A second
    launch sums the partials in a fixed order — no float atomics,
    bit-stable run to run. The recompute runs the forward's operation
    chain, so the top-k tie test sees the same bits.
    """
    _check_queue(q, E.shape[1])
    form = _check_packed(E, q[0], G, V, rows, cols, blend, labels, gt, b, b, k, loss_type,
                         qscales, e8, extra=_bwd_vectors(E, logz, kth, dce, dneg))
    kw = dict(b=b, loss_type=loss_type, margin=margin, scale=scale, k=k, mask_svfc=mask_svfc,
              qscales=qscales, e8=e8)
    rtile = _rounding_tile(q[0], b, b, tile)
    if not E.is_cuda:
        return _bwd_plain(E, q[0], G, V, rows, cols, blend, labels, gt, logz, kth, dce, dneg,
                          bp=b, rtile=rtile, **kw)
    out = _bwd_launch(E, q[0], G, V, rows, cols, blend, labels, gt, logz, kth, dce, dneg, bp=b,
                      rtile=rtile, **kw)
    LAUNCH_COUNTS[kernel_name("quad_bwd", form)] += 1
    return out


def quad_partial_fwd(E, q0, G, V, rows, cols, blend, labels, gt, *, b, bp, loss_type, margin,
                     scale, k, mask_svfc, qscales=None, e8=None):
    """One shard's forward over its block's plane 0 ``q0`` [Q/m, D] (with
    its scales ``qscales`` [Q/m] when int8), with shard-local cols / labels
    (module docstring), b probes and bp writes per direction and the
    GLOBAL gt. Returns (m, s) [2, R] and topk [2, R, k]: each (view, row)'s
    negative-stream state, target excluded on its owner, for
    ``parallel/_shard_common.merge_partials``.

    Replaces ``vlsfr_tpu/ops/twin_margin.py:pallas_quad_partial_fwd``.
    Bound as ``quad_fwd``'s over the block: 2·R·D·Q/m FLOP (f32: 4.1 ms at
    Q/m = 2^20, 1.0 ms at 2^18). Design: ``quad_fwd``'s block pass, then a
    merge of the block partials in block order without the finalize.
    """
    form = _check_packed(E, q0, G, V, rows, cols, blend, labels, gt, b, bp, k, loss_type,
                         qscales, e8)
    kw = dict(b=b, bp=bp, loss_type=loss_type, margin=margin, scale=scale, k=k,
              mask_svfc=mask_svfc, qscales=qscales, e8=e8)
    if not E.is_cuda:
        return quad_partial_fwd_plain(E, q0, G, V, rows, cols, blend, labels, gt, **kw)
    out = _fwd_launch("quad_partial_fwd_launch", 2, E, q0, G, V, rows, cols, blend, labels, gt,
                      **kw)
    LAUNCH_COUNTS[kernel_name("quad_partial_fwd", form)] += 1
    return out


def quad_partial_bwd(E, q0, G, V, rows, cols, blend, labels, gt, logz, kth, dce, dneg, *, b,
                     bp, loss_type, margin, scale, k, mask_svfc, qscales=None, e8=None,
                     tile=512):
    """One shard's backward over its block's plane 0 ``q0``, fed the GLOBAL
    logz, kth and cotangents (``dce`` zero on outlier rows, ``dneg`` on
    every globally positive row). Returns the shard's d_emb partial [R, D]
    (before the φ'(gt) tail) and d_gt [2, R], nonzero only where the
    shard-local label is ≥ 0 — the owner; summed over the shards it is the
    global d_gt.

    Replaces ``vlsfr_tpu/ops/twin_margin.py:pallas_quad_partial_bwd``.
    Bound: 4·R·D·Q/m FLOP (f32: 8.2 ms at Q/m = 2^20, 2.1 ms at 2^18).
    Design: ``quad_bwd``'s kernels over the block; the rounding tile is
    resolved over the block's columns and max(b, bp) rows, as JAX's.
    """
    form = _check_packed(E, q0, G, V, rows, cols, blend, labels, gt, b, bp, k, loss_type,
                         qscales, e8, extra=_bwd_vectors(E, logz, kth, dce, dneg))
    kw = dict(b=b, bp=bp, loss_type=loss_type, margin=margin, scale=scale, k=k,
              mask_svfc=mask_svfc, qscales=qscales, e8=e8)
    rtile = _rounding_tile(q0, b, bp, tile)
    if not E.is_cuda:
        return _bwd_plain(E, q0, G, V, rows, cols, blend, labels, gt, logz, kth, dce, dneg,
                          rtile=rtile, **kw)
    out = _bwd_launch(E, q0, G, V, rows, cols, blend, labels, gt, logz, kth, dce, dneg,
                      rtile=rtile, **kw)
    LAUNCH_COUNTS[kernel_name("quad_partial_bwd", form)] += 1
    return out


def _check_twin(E, q0, G, V, rows, cols, blend, labels, gt, k, loss_type, extra=()) -> str:
    """``_check_packed`` for one direction (b = E's rows, bp = the writes);
    the twin kernels take f32 and bf16 planes."""
    if queue_form(q0) not in TWIN_FORMS:
        raise ValueError(f"the twin kernels take float32 or bfloat16 queue planes, got "
                         f"{q0.dtype} (int8 queues run through the quad head)")
    return _check_packed(E, q0, G, V, rows, cols, blend, labels, gt, E.shape[0],
                         rows.shape[0], k, loss_type, extra=extra, nd=1)


def twin_fwd(E, q, G, V, rows, cols, blend, labels, gt, *, loss_type, margin, scale, k,
             mask_svfc):
    """Streaming forward of one FFC direction × both views over q0: E [b,
    D] probes, the direction's writes G, V [bp, D], rows / cols / blend
    [bp], labels [b], gt [2, b]. Returns (ce, neg, logz) [2, b] and topk
    [2, b, k], view-major; the target column streams z = scale·φ(gt), the
    top-k excludes it. ``q`` is f32 or bf16 (bf16: the dots' operands
    rounded as the quad's).

    Replaces ``vlsfr_tpu/ops/twin_margin.py:pallas_twin_fwd``. Bound on an
    H100 at b = 128, D = 512, Q = 2^20: f32 2·b·D·Q = 1.37e11 FLOP at 67
    TFLOP/s, 2.05 ms; bf16 the 1.07e9 B of q0 at 3.35 TB/s, 0.32 ms (its
    dot at the 989 TFLOP/s tensor-core rate takes 0.14). Design: the quad
    forward's kernel (csrc/quad_margin.cu) with a 128-row block, one
    direction, and the target column in the stream.
    """
    _check_queue(q, E.shape[1])
    form = _check_twin(E, q[0], G, V, rows, cols, blend, labels, gt, k, loss_type)
    kw = dict(loss_type=loss_type, margin=margin, scale=scale, k=k, mask_svfc=mask_svfc)
    if not E.is_cuda:
        return twin_fwd_plain(E, q, G, V, rows, cols, blend, labels, gt, **kw)
    out = _fwd_launch("quad_fwd_launch", 3, E, q[0], G, V, rows, cols, blend, labels, gt,
                      b=E.shape[0], bp=rows.shape[0], twin=True, **kw)
    LAUNCH_COUNTS[kernel_name("twin_fwd", form)] += 1
    return out


def twin_bwd(E, q, G, V, rows, cols, blend, labels, gt, logz, kth, dce, dneg, *, loss_type,
             margin, scale, k, mask_svfc, tile=512):
    """Streaming backward of one direction: (d_emb [b, D] — the q0/g/v
    paths, before the φ'(gt) tail — and d_gt [2, b], the target column's
    dz). ``dce`` / ``dneg`` [2, b] come pre-masked (0 on outlier /
    positive rows). A bf16 queue rounds d_cos per rounding tile of
    ``tile`` (``round_tile``: JAX's default 512 resolves to 512 at
    Q = 2^20).

    Replaces ``vlsfr_tpu/ops/twin_margin.py:pallas_twin_bwd``. Bound at
    b = 128, D = 512, Q = 2^20: f32 4·b·D·Q = 2.75e11 FLOP, 4.10 ms; bf16
    q0's 1.07e9 B, 0.32 ms (its two dots at the tensor-core rate 0.28).
    Design: the quad backward's kernels with one direction (64-row groups,
    two at b = 128, d_emb partials in registers, a fixed-order merge).
    """
    _check_queue(q, E.shape[1])
    form = _check_twin(E, q[0], G, V, rows, cols, blend, labels, gt, k, loss_type,
                       extra=_bwd_vectors(E, logz, kth, dce, dneg))
    return _twin_bwd_route(form, "twin_bwd", E, q[0], G, V, rows, cols, blend, labels, gt, logz,
                           kth, dce, dneg, loss_type=loss_type, margin=margin, scale=scale, k=k,
                           mask_svfc=mask_svfc, tile=tile)


def twin_partial_fwd(E, q0, G, V, rows, cols, blend, labels, gt, *, loss_type, margin, scale, k,
                     mask_svfc):
    """One shard's twin forward over its block's plane 0 ``q0`` [Q/m, D],
    with shard-local write columns (−1: another shard's) and labels (−1
    outlier, −2 owned elsewhere), bp writes apart from the b probes and the
    GLOBAL gt. Returns each (view, row)'s raw (m, s) [2, b] — the target
    term included on its owner only — and target-excluded topk [2, b, k],
    for ``parallel/_shard_common.merge_partials``.

    Replaces ``vlsfr_tpu/ops/twin_margin.py:pallas_twin_partial_fwd``.
    Bound: ``twin_fwd``'s over the block (a quarter at 2^18 of 2^20).
    Design: ``twin_fwd``'s block pass, then a merge in block order without
    the finalize.
    """
    form = _check_twin(E, q0, G, V, rows, cols, blend, labels, gt, k, loss_type)
    kw = dict(loss_type=loss_type, margin=margin, scale=scale, k=k, mask_svfc=mask_svfc)
    if not E.is_cuda:
        return twin_partial_fwd_plain(E, q0, G, V, rows, cols, blend, labels, gt, **kw)
    out = _fwd_launch("quad_partial_fwd_launch", 2, E, q0, G, V, rows, cols, blend, labels, gt,
                      b=E.shape[0], bp=rows.shape[0], twin=True, **kw)
    LAUNCH_COUNTS[kernel_name("twin_partial_fwd", form)] += 1
    return out


def twin_partial_bwd(E, q0, G, V, rows, cols, blend, labels, gt, logz, kth, dce, dneg, *,
                     loss_type, margin, scale, k, mask_svfc, tile=512):
    """One shard's twin backward over its block, fed the GLOBAL gt, logz,
    kth and cotangents (masked with the GLOBAL positive rows). Returns the
    shard's d_emb partial [b, D] (before the φ'(gt) tail) and its raw d_gt
    [2, b], nonzero on the owner only; the rounding tile is resolved over
    the block's columns and max(b, bp) rows.

    Replaces ``vlsfr_tpu/ops/twin_margin.py:pallas_twin_partial_bwd``.
    Bound: ``twin_bwd``'s over the block. Design: ``twin_bwd``'s kernels
    over the block.
    """
    form = _check_twin(E, q0, G, V, rows, cols, blend, labels, gt, k, loss_type,
                       extra=_bwd_vectors(E, logz, kth, dce, dneg))
    return _twin_bwd_route(form, "twin_partial_bwd", E, q0, G, V, rows, cols, blend, labels, gt,
                           logz, kth, dce, dneg, loss_type=loss_type, margin=margin, scale=scale,
                           k=k, mask_svfc=mask_svfc, tile=tile)


def _twin_bwd_route(form, name, E, q0, G, V, rows, cols, blend, labels, gt, logz, kth, dce,
                    dneg, *, tile, **kw):
    """The twin backward over the plane ``q0``: the plain version for CPU
    tensors, the kernel (counted under ``name``) for CUDA tensors."""
    b, bp = E.shape[0], rows.shape[0]
    rtile = _rounding_tile(q0, b, bp, tile)
    args = (E, q0, G, V, rows, cols, blend, labels, gt, logz, kth, dce, dneg)
    if not E.is_cuda:
        return _bwd_plain(*args, b=b, bp=bp, rtile=rtile, twin=True, **kw)
    out = _bwd_launch(*args, b=b, bp=bp, rtile=rtile, twin=True, **kw)
    LAUNCH_COUNTS[kernel_name(name, form)] += 1
    return out


def clean_cos(E, q0, *, qscales=None, e8=None, bwd_tiles: bool = False):
    """[R, Q] cosines of the probes ``E`` [R, D] against the plane ``q0``
    [Q, D] as the kernels' clean tiles form them (no writes, no targets),
    with the forward's tiling or, with ``bwd_tiles``, the backward's
    recompute. A parity probe that exposes the dot both kernels share; no
    training path calls it. CPU tensors: the plain version (``_clean_cos``
    on the form's dot operands)."""
    _check_form(q0, qscales, e8)
    r_ = E.shape[0]
    if not E.is_cuda:
        return _clean_cos(_dot_operands(E, E, E, q0)[0], q0, qscales, e8)
    lib = _lib()
    idx = torch.zeros(2, dtype=torch.int32, device=E.device)  # no writes, no labels read
    gt = torch.zeros((2, r_), device=E.device)
    _keep, args = _common_args(E, q0, E, E, idx, idx, idx, idx, gt, max(r_ // 2, 1), 1, 1, "Arc",
                               0.5, 1.0, 1.0, qscales, e8)
    out = torch.empty((r_, q0.shape[0]), device=E.device)
    err = lib.quad_clean_cos_launch(*args, int(bwd_tiles), out.data_ptr(),
                                    torch.cuda.current_stream(E.device).cuda_stream)
    _check(lib, err, "quad_clean_cos")
    return out


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
    only (mirrors ``fused_quad_margin``; no queue or gallery gradient).
    ``qscales`` [2, Q] are an int8 queue's scales (None for float queues);
    ``int8_compute`` quantises the probes for the streamed dots; ``tile``
    sets the backward's rounding tile (``quad_bwd``)."""

    @staticmethod
    def forward(ctx, emb_x, emb_y, queue, qscales, g_a, g_b, rows_a, cols_a, seen_a, rows_b,
                cols_b, seen_b, labels_a, labels_b, loss_type, margin, scale, hard_neg,
                mask_svfc, int8_compute, tile=512):
        b = emb_x.shape[0]
        gts_a = compute_twin_gt(emb_x, queue, g_a, rows_a, cols_a, seen_a, labels_a, qscales)
        gts_b = compute_twin_gt(emb_y, queue, g_b, rows_b, cols_b, seen_b, labels_b, qscales)
        packed = pack_dirs(emb_x, emb_y, dir_inputs(queue, g_a, rows_a, cols_a, seen_a, qscales),
                           dir_inputs(queue, g_b, rows_b, cols_b, seen_b, qscales),
                           labels_a, labels_b, gts_a, gts_b)
        e8 = quantize_rows(packed[0]) if int8_compute else (None, None)  # JAX's _e8_operands
        kw = dict(b=b, loss_type=loss_type, margin=margin, scale=scale, k=hard_neg,
                  mask_svfc=mask_svfc)
        ce, neg, logz, topk = quad_fwd(packed[0], queue, *packed[1:], **kw,
                                       **_form_kw(qscales, e8))
        labels = packed[6]
        hit = ((packed[7][0] + KTH_TIE_TOL >= topk[0, :, 0]) & (labels >= 0)).float()
        ctx.save_for_backward(emb_x, emb_y, queue, qscales, *e8, g_a, g_b, rows_a, cols_a,
                              seen_a, rows_b, cols_b, seen_b, labels_a, labels_b, logz, topk,
                              *packed)
        ctx.kw, ctx.tile = kw, tile
        ctx.mark_non_differentiable(hit)
        out = []
        for lo in (0, b):
            sl = slice(lo, lo + b)
            out += [ce[0, sl], neg[0, sl], ce[1, sl], neg[1, sl]]
        return (*out, hit[:b], hit[b:])

    @staticmethod
    def backward(ctx, *cots):
        (emb_x, emb_y, queue, qscales, e8q, e8s, g_a, g_b, rows_a, cols_a, seen_a, rows_b,
         cols_b, seen_b, labels_a, labels_b, logz, topk, E, G, V, rows, cols, blend, labels,
         gt) = ctx.saved_tensors
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
                              dneg, **kw, **_form_kw(qscales, (e8q, e8s)), tile=ctx.tile)
        lt, mg = kw["loss_type"], kw["margin"]
        sa, sb = slice(0, b), slice(b, 2 * b)
        d_x = twin_gt_tail(emb_x, queue, g_a, rows_a, cols_a, seen_a, labels_a, gt[0, sa],
                           gt[1, sa], dgt[0, sa], dgt[1, sa], d_emb[sa], lt, mg, qscales)
        d_y = twin_gt_tail(emb_y, queue, g_b, rows_b, cols_b, seen_b, labels_b, gt[0, sb],
                           gt[1, sb], dgt[0, sb], dgt[1, sb], d_emb[sb], lt, mg, qscales)
        return (d_x, d_y) + (None,) * 19


def _form_kw(qscales, e8) -> dict:
    """The kernels' form arguments: plane 0's scales of a [2, Q] scale
    array, and the int8-compute probes (a pair of None when off)."""
    return dict(qscales=None if qscales is None else qscales[0],
                e8=None if e8[0] is None else e8)


def quad_add_margin(emb_x, emb_y, queue, g_a, g_b, plan_a, plan_b, labels_a, labels_b, *,
                    loss_type="Arc", margin=0.5, scale=32.0, hard_neg=10, mask_svfc=1.2,
                    tile=512, with_acc=False, qscales=None, int8_compute=False):
    """(loss_a, loss_b): both FFC directional losses with ONE streaming
    pass over q0 per forward and backward. ``with_acc`` also returns the
    combined streaming top-1 accuracy over both directions' in-pool rows.
    ``qscales`` [2, Q] carries an int8 queue's per-row scales;
    ``int8_compute`` quantises the probes per row and streams the clean
    dots int8 × int8 → int32 (gt, the overrides and d_emb stay as in int8
    storage). ``tile`` is JAX's kernel tile request: the rounded forms'
    backward rounds d_cos per tile as JAX resolves it (``round_tile``)."""
    if int8_compute and qscales is None:
        raise ValueError("int8_compute requires an int8-stored queue "
                         "(pool.queue_dtype='int8')")
    rows_a, cols_a, seen_a = plan_a
    rows_b, cols_b, seen_b = plan_b
    out = QuadMargin.apply(emb_x, emb_y, queue, qscales, g_a.detach(), g_b.detach(), rows_a,
                           cols_a, seen_a, rows_b, cols_b, seen_b, labels_a, labels_b, loss_type,
                           float(margin), float(scale), int(hard_neg), float(mask_svfc),
                           bool(int8_compute), int(tile))
    return reduce_quad_outputs(out, labels_a, labels_b, with_acc)


def reduce_quad_outputs(out, labels_a, labels_b, with_acc):
    """(loss_a, loss_b)[, acc] from the ten per-row outputs of the quad
    head: (ce1, neg1, ce2, neg2) per direction and the two hit vectors."""
    ce1a, neg1a, ce2a, neg2a, ce1b, neg1b, ce2b, neg2b, hit_a, hit_b = out
    losses = (reduce_margin_dir(ce1a, neg1a, ce2a, neg2a, labels_a),
              reduce_margin_dir(ce1b, neg1b, ce2b, neg2b, labels_b))
    if with_acc:
        n_pos = ((labels_a >= 0).float().sum() + (labels_b >= 0).float().sum()).clamp(min=1.0)
        return losses, ((hit_a.sum() + hit_b.sum()) / n_pos).detach()
    return losses


class TwinMargin(torch.autograd.Function):
    """One FFC direction's per-row (ce1, neg1, ce2, neg2) over the two
    queue views and the streaming top-1 hit (view 1), differentiable
    w.r.t. ``emb`` only (mirrors JAX's ``fused_twin_margin``; the queue
    and the gallery rows are constants). f32 and bf16 queues."""

    @staticmethod
    def forward(ctx, emb, queue, g, rows, cols, seen, labels, loss_type, margin, scale, hard_neg,
                mask_svfc, tile):
        gt1, gt2 = compute_twin_gt(emb, queue, g, rows, cols, seen, labels)
        g32, rows_i, cols_i, v, blend = (x.contiguous()
                                         for x in dir_inputs(queue, g, rows, cols, seen))
        E = emb.float().contiguous()
        lab = labels.to(torch.int32).contiguous()
        gt = torch.stack([gt1, gt2])
        kw = dict(loss_type=loss_type, margin=margin, scale=scale, k=hard_neg,
                  mask_svfc=mask_svfc)
        ce, neg, logz, topk = twin_fwd(E, queue, g32, v, rows_i, cols_i, blend, lab, gt, **kw)
        hit = ((gt1 + KTH_TIE_TOL >= topk[0, :, 0]) & (labels >= 0)).float()
        ctx.save_for_backward(emb, queue, g, rows, cols, seen, labels, E, g32, v, rows_i, cols_i,
                              blend, lab, gt, logz, topk)
        ctx.kw, ctx.tile = kw, tile
        ctx.mark_non_differentiable(hit)
        return ce[0], neg[0], ce[1], neg[1], hit

    @staticmethod
    def backward(ctx, dce1, dneg1, dce2, dneg2, _dhit):
        (emb, queue, g, rows, cols, seen, labels, E, g32, v, rows_i, cols_i, blend, lab, gt,
         logz, topk) = ctx.saved_tensors
        kw = ctx.kw
        zeros = E.new_zeros(E.shape[0])
        c = [zeros if x is None else x.float() for x in (dce1, dneg1, dce2, dneg2)]
        pos = (lab >= 0)[None, :]
        dce = torch.where(pos, torch.stack([c[0], c[2]]), 0.0).contiguous()
        dneg = torch.where(pos, 0.0, torch.stack([c[1], c[3]])).contiguous()
        kth = topk[:, :, -1].contiguous()
        d_emb, dgt = twin_bwd(E, queue, g32, v, rows_i, cols_i, blend, lab, gt, logz, kth, dce,
                              dneg, tile=ctx.tile, **kw)
        d = twin_gt_tail(emb, queue, g, rows, cols, seen, labels, gt[0], gt[1], dgt[0], dgt[1],
                         d_emb, kw["loss_type"], kw["margin"])
        return (d,) + (None,) * 12


def twin_add_margin(emb, queue, g, rows, cols, seen, labels, *, loss_type="Arc", margin=0.5,
                    scale=32.0, hard_neg=10, mask_svfc=1.2, tile=512, with_acc=False):
    """One FFC directional loss, add_margin(view 1) + add_margin(view 2),
    both views streamed in one pass with this step's writes applied in
    registers (JAX's ``twin_add_margin``). ``queue`` is the [2, Q, D]
    queue, f32 or bf16; ``tile`` is JAX's kernel tile request (the bf16
    backward's rounding tile, ``round_tile``). ``with_acc`` also returns
    the streaming top-1 accuracy over in-pool rows (view 1). The device
    of the tensors chooses the route: the CUDA kernels for CUDA tensors,
    their plain versions for CPU tensors."""
    if queue.dtype == torch.int8:
        raise ValueError(
            "int8 queues run through the quad route only (quad_add_margin "
            "/ parallel.sharded_quad) — core/ffc.py routes every fused "
            "config there; the legacy twin composition has no scales "
            "plumbing.")
    ce1, neg1, ce2, neg2, hit1 = TwinMargin.apply(
        emb, queue, g.detach(), rows, cols, seen, labels, loss_type, float(margin), float(scale),
        int(hard_neg), float(mask_svfc), int(tile))
    loss = reduce_margin_dir(ce1, neg1, ce2, neg2, labels)
    if with_acc:
        n_pos = (labels >= 0).float().sum().clamp(min=1.0)
        return loss, (hit1.sum() / n_pos).detach()
    return loss
