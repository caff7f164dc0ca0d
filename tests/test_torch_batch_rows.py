"""The margin_ce kernels' plain versions against the JAX package's Pallas
kernels (interpret mode, as tests/test_torch_margin_stream.py and
tests/test_torch_margin_forms.py run them) above the kernels' former 128
batch rows, and the launch geometries of both kernel families at the
shipped configs' batch.

B = 200 rows (not a multiple of 64 or 128: the CUDA forward's and d_w
passes' last 128-row group and the d_emb passes' last 64-row group are
ragged), C = 2048 classes, D = 64, for an f32 and a bf16 classifier: the
forward with its tile statistics, the backward, the fused SGD update, the
sparse backward over selected tiles, and one block of a class-sharded
classifier. Limits: f32 as tests/test_torch_margin_stream.py's (per-row
values and gradients 2e-5 absolute, the fused update 2e-5 / 2e-6 absolute
+ 1e-5 relative); bf16 as tests/test_torch_margin_forms.py's
(``vlsfr_tpu_torch/utils/parity.py``'s bf16 checks, by row set).

The geometry tests hold the grids at R = 1024 probe rows (b = 512 per
direction) and B = 512 batch rows: every column range and row group
covered once, one wave of one block an SM.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlsfr_tpu.ops import margin_pallas as jmp
from vlsfr_tpu_torch.ops import margin_stream as tms
from vlsfr_tpu_torch.ops import twin_margin as ttm
from vlsfr_tpu_torch.parallel._shard_common import localize_labels
from vlsfr_tpu_torch.utils import parity

B, C, D, TILE = 200, 2048, 64, 128
SGD = dict(momentum=0.9, nesterov=True, weight_decay=1e-4)
LR = 0.1
ATOL = 2e-5
DT = {"f32": torch.float32, "bf16": torch.bfloat16}
FORMS = tuple(DT)
# w' / mom' elements one bf16 spacing from JAX's (tests/test_torch_margin_forms.py)
JAX_ULP_SHARE = 2.0**-10


def to_jax(t: torch.Tensor):
    if not t.is_floating_point():
        return jnp.asarray(t.numpy())
    x = jnp.asarray(t.float().numpy())
    return x.astype(jnp.bfloat16) if t.dtype == torch.bfloat16 else x


def to_torch(x):
    t = torch.from_numpy(np.array(jnp.asarray(x).astype(jnp.float32)))
    return t.bfloat16() if jnp.asarray(x).dtype == jnp.bfloat16 else t


def make_case(seed, form, c=C, b=B):
    """Unit embeddings, a 0.01·N(0, 1) classifier and momentum in the
    form's dtype, labels with rows 0 and 1 one class and outlier rows, the
    cotangents 1/b; Arc, k = 3."""
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((b, D)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
    w, mom = (torch.from_numpy((0.01 * rng.standard_normal((c, D))).astype(np.float32))
              .to(DT[form]) for _ in range(2))
    labels = rng.integers(0, c, b).astype(np.int32)
    labels[1] = labels[0]
    labels[rng.random(b) < 0.3] = -1
    labels[2] = -1
    pos = labels >= 0
    d_ce = torch.from_numpy(np.where(pos, 1.0 / b, 0.0).astype(np.float32))
    d_neg = torch.from_numpy(np.where(pos, 0.0, 1.0 / b).astype(np.float32))
    kw = dict(loss_type="Arc", margin=0.5, scale=32.0, k=3, mask_svfc=1.2)
    return torch.from_numpy(emb), w, mom, torch.from_numpy(labels), d_ce, d_neg, kw


def pallas_kw(kw, tile=TILE):
    return dict(kw, normalize_w=True, tile=tile, interpret=True)


def jax_forward(emb, w, labels, kw, with_stats=False):
    ej, wj, lj = to_jax(emb), to_jax(w), to_jax(labels).astype(jnp.int32)
    gt = jmp.compute_gt(ej, wj, lj, True)
    out = jmp.pallas_margin_ce_fwd(ej, wj, lj, gt, with_stats=with_stats, **pallas_kw(kw))
    return to_torch(gt), [to_torch(x) for x in out]


def streamed_ref(emb, w, labels, gt, logz, d_ce, d_neg, kw, want):
    """d_emb's reference less the target term both sides add in f32
    (``parity.softmax_demb``'s streamed part)."""
    d_ce_m, _ = tms._mask_cotangents(tms._positive(labels, None), d_ce, d_neg)
    term, _ = tms._target_rows(emb, w, labels, gt, logz, d_ce_m, loss_type=kw["loss_type"],
                               margin=kw["margin"], scale=kw["scale"])
    return want - term


def assert_holds(checks):
    bad = parity.failures(checks)
    assert not bad, "; ".join(map(parity.describe, bad))


def close(got, want, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("form", FORMS)
def test_forward_matches_pallas_interpret_at_200_rows(form):
    """margin_ce_fwd with the tile statistics against
    pallas_margin_ce_fwd(with_stats=True)."""
    emb, w, _, labels, _, _, kw = make_case(1, form)
    gt, want = jax_forward(emb, w, labels, kw, with_stats=True)
    got = tms.margin_ce_fwd(emb, w, labels, gt, with_stats=True, tile=TILE, **kw)
    stats = parity.fwd_stats_checks(got[4], got[5], want[4], want[5], kw["scale"])
    if form == "bf16":
        assert_holds(parity.rounded_fwd_checks(got, want) + stats)
    else:
        for g, wn in zip(got[:4], want[:4]):
            close(g, wn)
        assert_holds(stats)


@pytest.mark.parametrize("form", FORMS)
def test_backward_matches_pallas_interpret_at_200_rows(form):
    """margin_ce_bwd against pallas_margin_ce_bwd: d_emb and d_w (bf16: d_w
    in bf16 as JAX's wrapper casts it, by row set)."""
    emb, w, _, labels, d_ce, d_neg, kw = make_case(2, form)
    gt, (_, _, logz, topk) = jax_forward(emb, w, labels, kw)
    ge, gw = jmp.pallas_margin_ce_bwd(*(to_jax(x) for x in (emb, w, labels, gt, logz, topk, d_ce,
                                                             d_neg)), **pallas_kw(kw))
    d_emb, d_w = tms.margin_ce_bwd(emb, w, labels, gt, logz, topk, d_ce, d_neg, **kw)
    want, gw = to_torch(ge), to_torch(gw).float()
    if form == "bf16":
        ref = streamed_ref(emb, w, labels, gt, logz, d_ce, d_neg, kw, want)
        assert_holds(parity.softmax_demb("d_emb", d_emb, want, ref, cols=C)
                     + parity.rounded_rows("d_w", d_w.to(torch.bfloat16).float(), gw, gw, labels))
    else:
        close(d_emb, want)
        close(d_w, gw)


@pytest.mark.parametrize("form", FORMS)
def test_fused_matches_pallas_interpret_at_200_rows(form):
    """margin_ce_bwd_fused_sgd (W and mom of the form, updated in place)
    against pallas_margin_ce_bwd_fused_sgd."""
    emb, w, mom, labels, d_ce, d_neg, kw = make_case(3, form)
    gt, (_, _, logz, topk) = jax_forward(emb, w, labels, kw)
    ge, nw, nm = jmp.pallas_margin_ce_bwd_fused_sgd(
        *(to_jax(x) for x in (emb, w, mom, labels, gt, logz, topk, d_ce, d_neg)), LR, **SGD,
        **pallas_kw(kw))
    w0, mom0 = w.clone(), mom.clone()
    d_emb, w2, mom2 = tms.margin_ce_bwd_fused_sgd(emb, w, mom, labels, gt, logz, topk, d_ce, d_neg,
                                                  LR, **SGD, **kw)
    assert w2 is w and mom2 is mom
    want, nw, nm = to_torch(ge), to_torch(nw), to_torch(nm)
    if form == "f32":
        close(d_emb, want, 2e-5, 1e-5)
        close(mom, nm, 2e-5, 1e-5)
        close(w, nw, 2e-6, 1e-5)
        return
    ref = streamed_ref(emb, w0, labels, gt, logz, d_ce, d_neg, kw, want)
    checks = parity.softmax_demb("fused d_emb", d_emb, want, ref, cols=C)
    _, jd_w = jmp.pallas_margin_ce_bwd(*(to_jax(x) for x in (emb, w0, labels, gt, logz, topk,
                                                              d_ce, d_neg)), **pallas_kw(kw))
    _, d_w = tms.margin_ce_bwd_plain(emb, w0, labels, gt, logz, topk, d_ce, d_neg, **kw)
    straddled = (d_w.bfloat16() != to_torch(jd_w)).any(dim=1)
    checks += parity.bf16_ulps("w'", w, nw, w0, straddled, share=JAX_ULP_SHARE)
    checks += parity.bf16_ulps("mom'", mom, nm, mom0, straddled, share=JAX_ULP_SHARE)
    assert_holds(checks)


@pytest.mark.parametrize("form", FORMS)
def test_sparse_matches_pallas_interpret_at_200_rows(form):
    """margin_ce_bwd_sparse against pallas_margin_ce_bwd_sparse on the same
    selected tiles (every target tile but a few, and one with none): d_emb
    truncated to them, the d_w rows (bf16: by row set)."""
    emb, w, _, labels, d_ce, d_neg, kw = make_case(4, form)
    gt, (_, _, logz, topk) = jax_forward(emb, w, labels, kw)
    targets = sorted({int(x) // TILE for x in labels if x >= 0})
    tile_idx = torch.tensor(targets[:-3], dtype=torch.int32)
    ge, gw = jmp.pallas_margin_ce_bwd_sparse(
        *(to_jax(x) for x in (emb, w, labels, gt, logz, topk, d_ce, d_neg)),
        jnp.asarray(tile_idx.numpy()), **pallas_kw(kw))
    args = (emb, w, labels, gt, logz, topk, d_ce, d_neg, tile_idx)
    d_emb, d_w = tms.margin_ce_bwd_sparse(*args, tile=TILE, **kw)
    want, gw = to_torch(ge), to_torch(gw).float()
    if form == "f32":
        close(d_emb, want)
        close(d_w, gw)
        return
    sde, _, _ = tms._sparse_parts_plain(*args, tile=TILE, **kw)
    assert_holds(parity.softmax_demb("sparse d_emb", d_emb, want, sde,
                                     cols=tile_idx.numel() * TILE)
                 + parity.rounded_rows("sparse d_w", d_w, gw, gw, labels,
                                       is_label=parity.sparse_label_rows(labels, tile_idx, TILE)))


@pytest.mark.parametrize("form", FORMS)
def test_partial_matches_pallas_interpret_at_200_rows(form):
    """margin_partial_fwd / _bwd on block 1 of 4 (512 classes) against
    pallas_margin_partial_fwd / _bwd (JAX marks a row another block owns
    −1): the state m + log s, m and top-k; d_emb, the block's d_w, d_gt_raw."""
    emb, w, _, labels, d_ce, d_neg, kw = make_case(5, form)
    c0, cl = C // 4, C // 4
    ll, owned = localize_labels(c0, cl, labels)
    gt = torch.where(labels >= 0, tms.compute_gt(emb, w, labels), 0.3)
    w_l = w[c0:c0 + cl]
    jll = to_jax(torch.where(owned, ll, -1)).astype(jnp.int32)
    pk = pallas_kw(kw)
    m, s, topk = tms.margin_partial_fwd(emb, w_l, ll, gt, **kw)
    jm, js, jt = (to_torch(x) for x in jmp.pallas_margin_partial_fwd(
        to_jax(emb), to_jax(w_l), jll, to_jax(gt), **pk))
    checks = [parity._err("m + log s", m + torch.log(s), jm + torch.log(js), 1e-5),
              parity._err("m", m, jm, kw["scale"] * 1e-5), parity._err("top-k", topk, jt, 1e-5)]
    logz = m + torch.log(s) + 1.0
    kth = topk[:, -1].contiguous()
    no_wl = torch.zeros_like(emb)  # JAX's partial backward leaves the label rows' term out
    d_emb, d_w, d_gt = tms.margin_partial_bwd(emb, w_l, ll, gt, logz, kth, d_ce, d_neg, no_wl,
                                              **kw)
    je, jw, jg = (to_torch(x) for x in jmp.pallas_margin_partial_bwd(
        to_jax(emb), to_jax(w_l), jll, *(to_jax(x) for x in (gt, logz, kth, d_ce, d_neg)), **pk))
    checks.append(parity._err("partial d_gt_raw", d_gt, jg, 1e-5 * max(1.0, float(jg.abs().max()))))
    if form == "bf16":
        checks += parity.softmax_demb("partial d_emb", d_emb, je, cols=cl)
        checks += parity.rounded_rows("partial d_w", d_w, jw, jw, ll)
    else:
        checks += [parity._err("partial d_emb", d_emb, je, ATOL),
                   parity._err("partial d_w", d_w, jw, ATOL)]
    assert_holds(checks)


# ----------------------------------------------------------------------
# the launch geometries at the shipped batch
# ----------------------------------------------------------------------


def _covers_once(per: int, n: int, total: int, tile: int):
    """Ranges of ``per`` columns (a multiple of ``tile``), ``n`` of them,
    cover [0, total) once, each nonempty."""
    assert per % tile == 0
    spans = [(i * per, min(total, (i + 1) * per)) for i in range(n)]
    assert spans[0][0] == 0 and spans[-1][1] == total
    assert all(lo < hi for lo, hi in spans)
    assert all(a[1] == b_[0] for a, b_ in zip(spans, spans[1:]))


@pytest.mark.parametrize("form", ttm.FORMS)
@pytest.mark.parametrize("r_,q,bp", [(1024, 10485760, 512), (1024, 2621440, 512),
                                     (1024, 1 << 20, 512), (512, 1 << 20, 512),
                                     (400, 1 << 18, 200)])
def test_quad_geometry_covers_the_work_once_at_1024_rows(form, r_, q, bp):
    """The quad / twin forward's and backward's grids (``fwd_geometry``,
    ``bwd_geometry``) at R = 1024 probe rows (the 10M config's b = 512 per
    direction; its 4-card block of 2,621,440 slots), the twin's 512, and R
    = 400 (b = 200): the row groups hold every row once (the forward's
    128-row groups, or 256 for f32; the backward's 64), the column ranges
    cover the queue once, and the grid is one wave of one block an SM on a
    132-SM card; the written columns' scratch [R, 2, bp]."""
    fwd = ttm.fwd_geometry(form, r_, q, 132, bp)
    rows = 128 if form != "f32" else 256
    assert fwd.rows_per_block == rows and fwd.n_rg == -(-r_ // rows)
    assert (fwd.n_rg - 1) * rows < r_ <= fwd.n_rg * rows
    _covers_once(fwd.cols_per_chunk, fwd.nchunk, q, ttm.TILE)
    assert fwd.nchunk * fwd.n_rg <= 132 and fwd.wcos == (r_, 2, bp)
    assert fwd.smem <= 232448
    bwd = ttm.bwd_geometry(form, r_, q, 132, bp)
    assert bwd.n_rg == -(-r_ // 64) and (bwd.n_rg - 1) * 64 < r_
    _covers_once(bwd.cols_per_chunk, bwd.nchunk, q, ttm.TILE)
    assert bwd.nchunk * bwd.n_rg <= 132 and bwd.wcoef == (r_, 2, bp)


@pytest.mark.parametrize("w_bf16", [False, True])
@pytest.mark.parametrize("b,c", [(512, 5_000_000), (512, 1_250_000), (512, 1 << 20),
                                 (200, 4000), (128, 1 << 20)])
def test_margin_geometry_covers_the_work_once_at_512_rows(w_bf16, b, c):
    """The margin_ce forward's grid (``fwd_geometry``) and the backward's
    (``bwd_geometry``) at B = 512 over the 5M config's classes (and its
    4-card block of 1,250,000), B = 200 and B = 128: the forward's 128-row
    groups hold every row once (one at B <= 128), its ranges cover C once
    in 128-column tiles, one wave on 132 SMs, two partials a range; the
    backward's column-owning blocks and its d_emb chunks each cover C once
    in 64-column tiles, the d_emb chunks x 64-row groups one wave (an f32
    classifier's one pass up to B = 128: its chunks are the owners)."""
    fwd = tms.fwd_geometry(w_bf16, c, 132, b)
    assert fwd.n_rg == -(-b // 128) and fwd.n_parts == 2 * fwd.nblk
    _covers_once(fwd.cols_per_blk, fwd.nblk, c, 128)
    assert fwd.nblk * fwd.n_rg <= 132
    nchunk, per, nblk, per_w = tms.bwd_geometry(w_bf16, b, c, 132)
    _covers_once(per_w, nblk, c, 64)
    _covers_once(per, nchunk, c, 64)
    assert nblk <= 132
    if not w_bf16 and b <= 128:
        assert (nchunk, per) == (nblk, per_w)
    else:
        assert nchunk * -(-b // 64) <= 132
