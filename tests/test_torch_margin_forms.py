"""The bf16 forms of the streaming softmax head's six kernels (the
classifier at ``pool.classifier_dtype = bfloat16``;
``vlsfr_tpu_torch/ops/margin_stream.py``) against the JAX package's Pallas
kernels in interpret mode, with the limits of
``vlsfr_tpu_torch/utils/parity.py`` (its module docstring gives each
reason): ce / neg / logz 1e-5 × max(1, |value|), top-k 1e-5, the tile
statistics as the f32 form's; d_emb in two parts (``softmax_demb``, on the
streamed part); d_w by row set in two parts (``rounded_rows``), or cast to
bf16 where JAX's wrapper casts it; the fused update's bf16 w' /
mom' by ``bf16_ulps`` (a counted few elements apart), an f32
mom' by ``rounded_rows``, an f32 w' beside a bf16 momentum by ``by_rows``.
On the CPU every wrapper runs its plain version, which rounds where the
Pallas kernels round: bf16(emb) · bf16(ŵ) with f32 sums, d_cos rounded to
bf16 before both backward products. What is left is the order of f32 sums,
and JAX's 1/‖w‖ summed in f32 one ulp from the port's (``bf16_row_inv``),
which moves a few rounded operands by one bf16 ulp.

Sizes: b = 8 rows (a repeated class, outlier rows where k = 3), d = 128,
C = 1024 (the partial kernels: one block of 40 of 160 classes), JAX's tile
32 (16 on the block; the fused kernel also at 128). Then the planted
faults of the bf16 form, each against the real plain version: a form that
skips the operand rounding, one that rounds the stored row and scales
afterwards, and a fused update that rounds w' twice must fail the checks;
and the pieces around the kernels:
optax's chain on a bf16 leaf (``optim/optimizers.sgd_leaf_``) against
optax under ``jax.jit`` bit for bit, route D's row write
(``sparse_sgd_rows``) against JAX's bit for bit, and the chunked classifier
initialisation.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlsfr_tpu.ops import margin_pallas as jmp
from vlsfr_tpu_torch.ops import margin_stream as tms
from vlsfr_tpu_torch.utils import parity

B, C, D, TILE = 8, 1024, 128, 32
SGD = dict(momentum=0.9, nesterov=True, weight_decay=1e-4)
LR = 0.1
CASES = [("Arc", 1, 0.0), ("AM", 3, 0.3), ("SV", 3, 0.3)]
PAIRS = [("bf16", "bf16"), ("bf16", "f32"), ("f32", "bf16")]
DT = {"bf16": torch.bfloat16, "f32": torch.float32}
F32_EPS = torch.finfo(torch.float32).eps
# w' / mom' elements one bf16 spacing apart from JAX's: JAX sums 1/||w|| in f32, one
# ulp from the port's, which moves rounded operands and so more f32 values across
# bf16 boundaries than the kernel and its plain version do (read: up to 105 of 131,072)
JAX_ULP_SHARE = 2.0**-10


def to_jax(t: torch.Tensor):
    """A torch tensor as a JAX array of the same dtype (bf16 exactly)."""
    if not t.is_floating_point():
        return jnp.asarray(t.numpy())
    x = jnp.asarray(t.float().numpy())
    return x.astype(jnp.bfloat16) if t.dtype == torch.bfloat16 else x


def to_torch(x):
    """A JAX array as a torch tensor (bf16 arrays exactly, as bf16)."""
    t = torch.from_numpy(np.array(jnp.asarray(x).astype(jnp.float32)))
    return t.bfloat16() if jnp.asarray(x).dtype == jnp.bfloat16 else t


def make_case(seed, c=C, loss_type="Arc", k=1, frac_outlier=0.0, w_dtype=torch.bfloat16,
              mom_dtype=torch.bfloat16, b=B):
    """Unit embeddings (``b`` rows), a 0.01·N(0, 1) classifier and momentum
    in their dtypes (as JAX draws and casts them), labels with rows 0 and 1
    one class, outlier rows at ``frac_outlier``, d_ce = 1/b on labelled rows
    and d_neg = 1/b on the others."""
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((b, D)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
    w = torch.from_numpy((0.01 * rng.standard_normal((c, D))).astype(np.float32)).to(w_dtype)
    mom = torch.from_numpy((0.01 * rng.standard_normal((c, D))).astype(np.float32)).to(mom_dtype)
    labels = rng.integers(0, c, b).astype(np.int32)
    labels[1] = labels[0]
    if frac_outlier:
        labels[rng.random(b) < frac_outlier] = -1
        labels[2] = -1
    pos = labels >= 0
    d_ce = torch.from_numpy(np.where(pos, 1.0 / b, 0.0).astype(np.float32))
    d_neg = torch.from_numpy(np.where(pos, 0.0, 1.0 / b).astype(np.float32))
    kw = dict(loss_type=loss_type, margin=0.5, scale=32.0, k=k, mask_svfc=1.2)
    return torch.from_numpy(emb), w, mom, torch.from_numpy(labels), d_ce, d_neg, kw


def pallas_kw(kw, tile=TILE):
    return dict(kw, normalize_w=True, tile=tile, interpret=True)


def assert_holds(checks):
    bad = parity.failures(checks)
    assert not bad, "; ".join(map(parity.describe, bad))


def jax_forward(emb, w, labels, kw, with_stats=False):
    """JAX's gt and its Pallas forward (interpret mode) as torch tensors."""
    ej, wj, lj = to_jax(emb), to_jax(w), to_jax(labels).astype(jnp.int32)
    gt = jmp.compute_gt(ej, wj, lj, True)
    out = jmp.pallas_margin_ce_fwd(ej, wj, lj, gt, with_stats=with_stats, **pallas_kw(kw))
    return to_torch(gt), [to_torch(x) for x in out]


@pytest.mark.parametrize("loss_type,k,frac_outlier", CASES)
def test_forward_forms_match_pallas_interpret(loss_type, k, frac_outlier):
    """margin_ce_fwd's bf16 form, with the tile statistics, against
    pallas_margin_ce_fwd(with_stats=True)."""
    emb, w, _, labels, _, _, kw = make_case(1, loss_type=loss_type, k=k, frac_outlier=frac_outlier)
    gt_j, want = jax_forward(emb, w, labels, kw, with_stats=True)
    gt = tms.compute_gt(emb, w, labels)
    assert float((gt - gt_j).abs().max()) <= 1e-6
    got = tms.margin_ce_fwd(emb, w, labels, gt_j, with_stats=True, tile=TILE, **kw)
    assert_holds(parity.rounded_fwd_checks(got, want)
                 + parity.fwd_stats_checks(got[4], got[5], want[4], want[5], kw["scale"]))


def _streamed(emb, w, labels, gt, logz, d_ce, d_neg, kw, pos_rows=None):
    """The target term both sides add in f32 to d_emb (it is left out of
    the limits' reference, as in parity.margin_ce_bwd_checks)."""
    d_ce_m, _ = tms._mask_cotangents(tms._positive(labels, pos_rows), d_ce, d_neg)
    term, _ = tms._target_rows(emb, w, labels, gt, logz, d_ce_m, loss_type=kw["loss_type"],
                               margin=kw["margin"], scale=kw["scale"])
    return term


@pytest.mark.parametrize("loss_type,k,frac_outlier", CASES)
def test_backward_forms_match_pallas_interpret(loss_type, k, frac_outlier):
    """margin_ce_bwd's bf16 form against pallas_margin_ce_bwd: d_emb, and
    d_w in bf16 as JAX's wrapper and ``MarginSoftmax`` cast it."""
    emb, w, _, labels, d_ce, d_neg, kw = make_case(2, loss_type=loss_type, k=k,
                                                   frac_outlier=frac_outlier)
    gt, (_, _, logz, topk) = jax_forward(emb, w, labels, kw)
    ge, gw = jmp.pallas_margin_ce_bwd(*(to_jax(x) for x in (emb, w, labels, gt, logz, topk, d_ce,
                                                             d_neg)), **pallas_kw(kw))
    assert gw.dtype == jnp.bfloat16
    d_emb, d_w = tms.margin_ce_bwd(emb, w, labels, gt, logz, topk, d_ce, d_neg, **kw)
    want = to_torch(ge)
    term = _streamed(emb, w, labels, gt, logz, d_ce, d_neg, kw)
    gw = to_torch(gw).float()
    assert_holds(parity.softmax_demb("d_emb", d_emb, want, want - term, cols=C)
                 + parity.rounded_rows("d_w", d_w.to(torch.bfloat16).float(), gw, gw, labels))


@pytest.mark.parametrize("loss_type,k,frac_outlier", [("Arc", 1, 0.0), ("SV", 3, 0.3)])
def test_backward_ragged_form_matches_pallas_interpret(loss_type, k, frac_outlier):
    """margin_ce_bwd's bf16 form with and without d_w at B = 12 (not a
    multiple of 16) and C = 1000 (not a multiple of 64, nor of JAX's tile)
    against pallas_margin_ce_bwd: d_emb, and d_w in bf16."""
    c = 1000
    emb, w, _, labels, d_ce, d_neg, kw = make_case(7, c=c, loss_type=loss_type, k=k,
                                                   frac_outlier=frac_outlier, b=12)
    gt, (_, _, logz, topk) = jax_forward(emb, w, labels, kw)
    ge, gw = jmp.pallas_margin_ce_bwd(*(to_jax(x) for x in (emb, w, labels, gt, logz, topk, d_ce,
                                                             d_neg)), **pallas_kw(kw))
    want, gw = to_torch(ge), to_torch(gw).float()
    term = _streamed(emb, w, labels, gt, logz, d_ce, d_neg, kw)
    d_emb, d_w = tms.margin_ce_bwd(emb, w, labels, gt, logz, topk, d_ce, d_neg, **kw)
    d_emb0, no_w = tms.margin_ce_bwd(emb, w, labels, gt, logz, topk, d_ce, d_neg, grad_w=False,
                                     **kw)
    assert no_w is None and torch.equal(d_emb0, d_emb)
    assert_holds(parity.softmax_demb("d_emb", d_emb, want, want - term, cols=c)
                 + parity.rounded_rows("d_w", d_w.to(torch.bfloat16).float(), gw, gw, labels))


@pytest.mark.parametrize("w_form,mom_form,tile", [(*pair, TILE) for pair in PAIRS]
                         + [("bf16", "bf16", 4 * TILE)])
def test_fused_forms_match_pallas_interpret(w_form, mom_form, tile):
    """margin_ce_bwd_fused_sgd in the three (w, mom) dtype pairs JAX's tests
    cover, against pallas_margin_ce_bwd_fused_sgd; W and mom in place. JAX
    resolves the fused kernel's tile from the dtypes (``w_bufs``); the tile
    reaches no result but the order of its sums (the relevance gate aside,
    which neither port side applies), so the plain version, which has no
    tile, holds to JAX's kernel at 32 and at 128 columns alike."""
    emb, w, mom, labels, d_ce, d_neg, kw = make_case(3, k=3, frac_outlier=0.3,
                                                     w_dtype=DT[w_form], mom_dtype=DT[mom_form])
    gt, (_, _, logz, topk) = jax_forward(emb, w, labels, kw)
    ge, nw, nm = jmp.pallas_margin_ce_bwd_fused_sgd(
        *(to_jax(x) for x in (emb, w, mom, labels, gt, logz, topk, d_ce, d_neg)), LR, **SGD,
        **pallas_kw(kw, tile))
    assert (nw.dtype, nm.dtype) == (to_jax(w).dtype, to_jax(mom).dtype)
    term = _streamed(emb, w, labels, gt, logz, d_ce, d_neg, kw)
    w0, mom0 = w.clone(), mom.clone()
    d_emb, w2, mom2 = tms.margin_ce_bwd_fused_sgd(emb, w, mom, labels, gt, logz, topk, d_ce, d_neg,
                                                  LR, **SGD, **kw)
    assert w2 is w and mom2 is mom  # in place
    want, nw, nm = to_torch(ge), to_torch(nw), to_torch(nm)
    checks = parity.softmax_demb("fused d_emb", d_emb, want, want - term, cols=C)
    straddled = None  # a bf16 form's rows whose d_w moved by a bf16 spacing from JAX's
    if w_form == "bf16":
        _, jd_w = jmp.pallas_margin_ce_bwd(*(to_jax(x) for x in (emb, w0, labels, gt, logz, topk,
                                                                  d_ce, d_neg)), **pallas_kw(kw))
        _, d_w = tms.margin_ce_bwd_plain(emb, w0, labels, gt, logz, topk, d_ce, d_neg, **kw)
        straddled = (d_w.bfloat16() != to_torch(jd_w)).any(dim=1)
        checks += parity.bf16_ulps("w'", w, nw, w0, straddled, share=JAX_ULP_SHARE)
    else:  # the f32 form beside a bf16 momentum: lr(1 + μ)·g, g from the plain d_w
        _, d_w = tms.margin_ce_bwd_plain(emb, w0, labels, gt, logz, topk, d_ce, d_neg, **kw)
        g = (d_w + SGD["weight_decay"] * w0).mul_(LR * (1.0 + SGD["momentum"]))
        checks += parity.by_rows("w'", w, nw, g, labels, 1e-4, 2.0)
    if mom_form == "bf16":
        checks += parity.bf16_ulps("mom'", mom, nm, mom0, straddled, share=JAX_ULP_SHARE)
    else:
        checks += parity.rounded_rows("mom'", mom, nm, nm - SGD["momentum"] * mom0, labels)
    assert_holds(checks)
    assert int((w != w0).sum()) > w.numel() // 2  # the update moved the classifier


def test_sparse_form_matches_pallas_interpret():
    """margin_ce_bwd_sparse's bf16 form against pallas_margin_ce_bwd_sparse
    on the same selected tiles (every target tile and a ragged last tile
    of C = 1000): d_emb truncated to them, the d_w rows by row set."""
    emb, w, _, labels, d_ce, d_neg, kw = make_case(4, c=1000, k=3, frac_outlier=0.3)
    gt, (_, _, logz, topk) = jax_forward(emb, w, labels, kw)
    tiles = sorted({int(x) // TILE for x in labels if x >= 0} | {1000 // TILE, 5})
    tile_idx = torch.tensor(tiles, dtype=torch.int32)
    ge, gw = jmp.pallas_margin_ce_bwd_sparse(
        *(to_jax(x) for x in (emb, w, labels, gt, logz, topk, d_ce, d_neg)),
        jnp.asarray(tile_idx.numpy()), **pallas_kw(kw))
    args = (emb, w, labels, gt, logz, topk, d_ce, d_neg, tile_idx)
    sde, _, _ = tms._sparse_parts_plain(*args, tile=TILE, **kw)
    d_emb, d_w = tms.margin_ce_bwd_sparse(*args, tile=TILE, **kw)
    want = to_torch(ge)
    assert_holds(parity.softmax_demb("sparse d_emb", d_emb, want, sde,
                                       cols=tile_idx.numel() * TILE)
                 + parity.rounded_rows("sparse d_w", d_w, to_torch(gw), to_torch(gw), labels,
                                       is_label=parity.sparse_label_rows(labels, tile_idx, TILE)))


def block_case(seed, c_all=160, c0=40, c_local=40):
    """Rank 1 of 4 over a bf16 classifier of 160 classes: owned rows (rows 0
    and 1 one class, row 3 in the ragged last tile of 16), outlier rows and
    rows of other blocks; gt the global target cosines."""
    from vlsfr_tpu_torch.parallel._shard_common import localize_labels

    emb, w, _, _, _, _, kw = make_case(seed, c=c_all, k=3)
    labels = torch.tensor([c0 + 7, c0 + 7, 3, c0 + 37, 130, -1, -1, 90], dtype=torch.int32)
    gt = torch.where(labels >= 0, tms.compute_gt(emb, w, labels), 0.3)
    ll, owned = localize_labels(c0, c_local, labels)
    return emb, w[c0:c0 + c_local], labels, ll, owned, gt, kw


def test_partial_forms_match_pallas_interpret():
    """margin_partial_fwd / _bwd's bf16 forms on one block against
    pallas_margin_partial_fwd / _bwd (JAX marks a row another block owns
    −1): the state m + log s, m and top-k; d_emb, the block's f32 d_w by
    row set, d_gt_raw 1e-5."""
    emb, w_l, labels, ll, owned, gt, kw = block_case(5)
    jll = to_jax(torch.where(owned, ll, -1)).astype(jnp.int32)
    pk = pallas_kw(kw, tile=16)
    m, s, topk = tms.margin_partial_fwd(emb, w_l, ll, gt, **kw)
    jm, js, jt = (to_torch(x) for x in jmp.pallas_margin_partial_fwd(
        to_jax(emb), to_jax(w_l), jll, to_jax(gt), **pk))
    checks = [parity._err("m + log s", m + torch.log(s), jm + torch.log(js), 1e-5),
              parity._err("m", m, jm, kw["scale"] * 1e-5), parity._err("top-k", topk, jt, 1e-5)]
    pos = labels >= 0
    logz = m + torch.log(s) + 1.0
    kth = topk[:, -1].contiguous()
    d_ce, d_neg = torch.where(pos, 1.0 / B, 0.0), torch.where(pos, 0.0, 0.3)
    no_wl = torch.zeros_like(emb)  # JAX's partial backward leaves the label rows' term out
    d_emb, d_w, d_gt = tms.margin_partial_bwd(emb, w_l, ll, gt, logz, kth, d_ce, d_neg, no_wl,
                                              **kw)
    je, jw, jg = (to_torch(x) for x in jmp.pallas_margin_partial_bwd(
        to_jax(emb), to_jax(w_l), jll, *(to_jax(x) for x in (gt, logz, kth, d_ce, d_neg)), **pk))
    checks += parity.softmax_demb("partial d_emb", d_emb, je, cols=w_l.shape[0])
    checks += parity.rounded_rows("partial d_w", d_w, jw, jw, ll)
    checks.append(parity._err("partial d_gt_raw", d_gt, jg, 1e-5 * max(1.0, float(jg.abs().max()))))
    assert_holds(checks)


# ----------------------------------------------------------------------
# planted faults: each must fail the bf16 checks against the real form
# ----------------------------------------------------------------------


_FORM_ROWS = tms._form_rows


def _unrounded_rows(w_rows):
    wn, _, inv = _FORM_ROWS(w_rows)
    return wn, wn, inv


def _stored_row_scaled(w_rows):
    wn, _, inv = _FORM_ROWS(w_rows)
    return wn, tms._bf16r(w_rows.float()) * inv, inv


def _sgd_rows_rounded_twice(w, mom, d_w, lr, *, momentum, nesterov, weight_decay):
    w32 = w.float()
    g = d_w + weight_decay * w32
    new_mom = momentum * mom.float() + g
    upd = g + momentum * new_mom if nesterov else new_mom
    w.copy_(w32 + tms._bf16r(-lr * upd))
    mom.copy_(new_mom)


FAULTS = {  # fault: (what it patches in margin_stream, its replacement)
    "skips_operand_rounding": (("_form_rows", _unrounded_rows),
                               ("_operand", lambda x, w: x)),
    "rounds_stored_row_then_scales": (("_form_rows", _stored_row_scaled),),
    "rounds_new_w_twice": (("_sgd_rows", _sgd_rows_rounded_twice),),
}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_bf16_checks_reject_planted_faults(fault, monkeypatch):
    """A plain version with the fault, held to the real plain version by the
    bf16 checks, fails them: the forward's top-k for the two operand faults
    (each moves every cosine by ~2^-9 of its terms), the count of w'
    elements one ulp apart for the twice-rounded update (~1 % of a
    0.01-scale classifier's elements at lr 0.1, against 2^-13)."""
    emb, w, mom, labels, d_ce, d_neg, kw = make_case(6, c=2048)
    gt = tms.compute_gt(emb, w, labels)
    want = tms.margin_ce_fwd_plain(emb, w, labels, gt, **kw)
    logz, topk = want[2], want[3]
    w_p, mom_p = w.clone(), mom.clone()
    tms.margin_ce_bwd_fused_sgd_plain(emb, w_p, mom_p, labels, gt, logz, topk, d_ce, d_neg, LR,
                                      **SGD, **kw)
    for name, fn in FAULTS[fault]:
        monkeypatch.setattr(tms, name, fn)
    got = tms.margin_ce_fwd_plain(emb, w, labels, gt, **kw)
    w_k, mom_k = w.clone(), mom.clone()
    tms.margin_ce_bwd_fused_sgd_plain(emb, w_k, mom_k, labels, gt, logz, topk, d_ce, d_neg, LR,
                                      **SGD, **kw)
    failed = {c["name"] for c in parity.failures(parity.rounded_fwd_checks(got, want)
                                                 + parity.bf16_ulps("w'", w_k, w_p, w))}
    if fault == "rounds_new_w_twice":
        assert failed == {"w' elements apart"}
    else:
        assert "top-k" in failed


# ----------------------------------------------------------------------
# around the kernels: the classifier's updates and initialisation
# ----------------------------------------------------------------------


def _leaf_update_against_optax(dtype):
    """Three steps of ``sgd_leaf_`` on a leaf of ``dtype`` against optax's
    chain on that leaf beside another one, under ``jax.jit``: w and the
    trace at bf16 bit for bit; at f32 within 2 f32 eps of their largest
    value, since XLA contracts each multiply-add of the chain into an FMA on
    the CPU (measured 0.40 and 0.92 eps)."""
    from vlsfr_tpu.config import OptimConfig
    from vlsfr_tpu.optim import make_optimizer
    from vlsfr_tpu_torch.optim.optimizers import sgd_leaf_

    cfg = OptimConfig()
    opt = make_optimizer(cfg)
    rng = np.random.default_rng(0)
    w0 = (0.01 * rng.standard_normal((64, 32))).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    params = {"backbone": jnp.ones(4), "classifier": jnp.asarray(w0).astype(jdt)}
    state = opt.init(params)

    @jax.jit
    def step(p, st, g, lr):
        st.hyperparams["learning_rate"] = lr
        u, st = opt.update(g, st, p)
        return jax.tree.map(lambda a, b: (a + b).astype(a.dtype), p, u), st

    w, trace = to_torch(params["classifier"]), torch.zeros((64, 32), dtype=dtype)
    for s in range(3):
        g = jnp.asarray((1e-3 * rng.standard_normal((64, 32))).astype(np.float32))
        grads = {"backbone": jnp.ones(4), "classifier": g.astype(jdt)}
        lr = 0.05 * (s + 1)
        params, state = step(params, state, grads, jnp.float32(lr))
        sgd_leaf_(w, trace, to_torch(grads["classifier"]), lr, momentum=cfg.momentum,
                  nesterov=cfg.nesterov, weight_decay=cfg.weight_decay)
    assert w.dtype == dtype
    for got, want in ((w, to_torch(params["classifier"])),
                      (trace, to_torch(state.inner_state[1].trace["classifier"]))):
        if dtype == torch.bfloat16:
            assert torch.equal(got, want)
        else:
            assert float((got - want).abs().max()) <= 2 * F32_EPS * float(want.abs().max())


def test_bf16_leaf_update_matches_optax_under_jit():
    """``sgd_leaf_`` (the classifier's update on routes B, C and dense E) at
    a bf16 classifier against optax under jit, bit for bit."""
    _leaf_update_against_optax(torch.bfloat16)


def test_f32_leaf_update_matches_optax_under_jit():
    """The same at an f32 classifier, which takes ``sgd_leaf_`` too (2 f32
    eps of the largest value)."""
    _leaf_update_against_optax(torch.float32)


def test_sparse_row_write_matches_jax():
    """Route D's row update on a bf16 classifier with f32 momentum: the f32
    step rounded to bf16, then added to the row and rounded (JAX's
    ``w.at[idx].add(delta.astype(w.dtype))``): the rows bit for bit with
    JAX's ``sparse_sgd_rows``, padding rows dropped; the momentum 1e-6
    relative."""
    from vlsfr_tpu.train.sparse_classifier import sparse_sgd_rows as j_rows
    from vlsfr_tpu_torch.train.sparse_classifier import sparse_sgd_rows

    rng = np.random.default_rng(1)
    c = 64
    w = torch.from_numpy((0.01 * rng.standard_normal((c, D))).astype(np.float32)).bfloat16()
    mom = torch.from_numpy((0.01 * rng.standard_normal((c, D))).astype(np.float32))
    last = torch.from_numpy(rng.integers(0, 3, c).astype(np.int32))
    idx = torch.tensor([3, 7, 8, 40, c, c], dtype=torch.int32)
    grad = torch.from_numpy((1e-3 * rng.standard_normal((6, D))).astype(np.float32))
    kw = dict(lr=0.1, momentum=0.9, weight_decay=1e-4, nesterov=True)
    jw, jm, jl = jax.jit(functools.partial(j_rows, **kw))(
        to_jax(w), to_jax(mom), to_jax(idx), to_jax(grad), last_visit=to_jax(last), step=5)
    sparse_sgd_rows(w, mom, idx, grad, last_visit=last, step=5, **kw)
    assert w.dtype == torch.bfloat16 and torch.equal(w, to_torch(jw))
    assert torch.equal(last, torch.from_numpy(np.array(jl)))
    # the f32 momentum: the catch-up's μ^gap is an f32 pow in another library
    torch.testing.assert_close(mom, to_torch(jm), rtol=1e-6, atol=0.0)


def test_chunked_classifier_init():
    """``init_classifier``: f32 0.01·N(0, 1) cast to the dtype, drawn in
    chunks of rows; a block is the whole classifier's slice bit for bit."""
    from vlsfr_tpu_torch.train import softmax_head

    c = 3 * 1000 + 7
    gen = lambda: torch.Generator().manual_seed(4)  # noqa: E731
    whole = softmax_head.init_classifier(c, 16, torch.bfloat16, device="cpu", generator=gen())
    assert whole.dtype == torch.bfloat16
    g = gen()
    ref = torch.cat([torch.randn((min(1000, c - lo), 16), generator=g).mul_(0.01)
                     for lo in range(0, c, 1000)]).bfloat16()
    old, softmax_head.INIT_ROWS = softmax_head.INIT_ROWS, 1000
    try:
        chunked = softmax_head.init_classifier(c, 16, torch.bfloat16, device="cpu",
                                               generator=gen())
        block = softmax_head.init_classifier(c, 16, torch.bfloat16, device="cpu",
                                             generator=gen(), block=(1500, 1000))
    finally:
        softmax_head.INIT_ROWS = old
    assert torch.equal(chunked, ref) and torch.equal(block, ref[1500:2500])
    assert torch.equal(whole, softmax_head.init_classifier(c, 16, torch.bfloat16, device="cpu",
                                                           generator=gen()))
