"""The port's streaming margin-softmax (vlsfr_tpu_torch/ops/margin_stream.py)
against the JAX package's (vlsfr_tpu/ops/margin_pallas.py).

On the CPU the port's ``margin_ce_fwd`` / ``margin_ce_bwd`` /
``margin_ce_bwd_fused_sgd`` run their plain PyTorch versions; they are held
against the scan references ``_stream_fwd`` / ``_stream_bwd`` (+
``apply_sgd_dense`` for the fused update) across Arc/AM/SV, k = 1 and k = 3
with outlier rows, a repeated label and the three SGD settings, and once
each against the Pallas kernels in interpret mode. The CUDA kernels are
held against the plain versions by tests/test_torch_kernels.py (``gpu``
marker) and by chip_smoke.py at full width.

Tolerances are the JAX suite's own: values and top-k 2e-5 absolute
(tests/test_margin_pallas.py; the port's forward joins the same terms in
another order), d_emb / d_w 2e-5, and for the fused update d_emb and mom
2e-5 + 1e-5 relative, w 2e-6 + 1e-5 relative (tests/test_fused_update.py).
C is never a multiple of the plain versions' chunk nor of JAX's tile.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlsfr_tpu.ops import margin_pallas as jmp
from vlsfr_tpu_torch.ops import margin_stream as tms

VAL_ATOL = 2e-5
GRAD_ATOL = 2e-5


def make_case(rng, b=8, c=150, d=32, frac_outlier=0.0, repeat_label=False):
    emb = rng.standard_normal((b, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
    w = rng.standard_normal((c, d)).astype(np.float32)
    mom = (0.1 * rng.standard_normal((c, d))).astype(np.float32)
    labels = rng.integers(0, c, size=b).astype(np.int32)
    if repeat_label:
        labels[1] = labels[0]
    labels[rng.random(b) < frac_outlier] = -1
    if frac_outlier:
        labels[2] = -1  # both row kinds always present
    return emb, w, mom, labels


def t(x):
    return torch.from_numpy(np.array(x))


def kw_for(loss_type, k):
    return dict(loss_type=loss_type, margin=0.4, scale=24.0, k=k, mask_svfc=1.2)


def jax_fwd(emb, w, labels, kw, tile=64):
    ej, wj, lj = jnp.asarray(emb), jnp.asarray(w), jnp.asarray(labels)
    gt = jmp.compute_gt(ej, wj, lj, True)
    return gt, jmp._stream_fwd(ej, wj, lj, gt, tile=tile, normalize_w=True, **kw)


FWD_CASES = [(lt, 1, 0.0) for lt in ("Arc", "AM", "SV")] + \
            [(lt, 3, 0.4) for lt in ("Arc", "AM", "SV")]


@pytest.mark.parametrize("loss_type,k,frac_outlier", FWD_CASES)
def test_fwd_matches_stream(loss_type, k, frac_outlier, rng):
    emb, w, _, labels = make_case(rng, frac_outlier=frac_outlier)
    kw = kw_for(loss_type, k)
    gt_j, want = jax_fwd(emb, w, labels, kw)
    gt = tms.compute_gt(t(emb), t(w), t(labels))
    np.testing.assert_allclose(gt.numpy(), np.asarray(gt_j), atol=1e-6)
    got = tms.margin_ce_fwd(t(emb), t(w), t(labels), gt, **kw)
    for name, g, wnt in zip(("ce", "neg", "logz", "topk"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), atol=VAL_ATOL, err_msg=name)
    # chunking does not change the result
    again = tms.margin_ce_fwd_plain(t(emb), t(w), t(labels), gt, chunk=7, **kw)
    for g, a in zip(got, again):
        np.testing.assert_allclose(g.numpy(), a.numpy(), atol=VAL_ATOL)


def test_fwd_matches_pallas_interpret(rng):
    emb, w, _, labels = make_case(rng, b=8, c=150, d=128, frac_outlier=0.4)
    kw = kw_for("SV", 3)
    ej, wj, lj = jnp.asarray(emb), jnp.asarray(w), jnp.asarray(labels)
    gt = jmp.compute_gt(ej, wj, lj, True)
    want = jmp.pallas_margin_ce_fwd(ej, wj, lj, gt, interpret=True, tile=128, normalize_w=True,
                                    **kw)
    got = tms.margin_ce_fwd(t(emb), t(w), t(labels), t(gt), **kw)
    for name, g, wnt in zip(("ce", "neg", "logz", "topk"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), atol=VAL_ATOL, err_msg=name)


def _bwd_inputs(rng, emb, labels, loss_type, k, w):
    kw = kw_for(loss_type, k)
    gt, (_, _, logz, topk) = jax_fwd(emb, w, labels, kw)
    b = emb.shape[0]
    d_ce = rng.standard_normal(b).astype(np.float32) / b
    d_neg = rng.standard_normal(b).astype(np.float32) / b
    return kw, gt, logz, topk, d_ce, d_neg


@pytest.mark.parametrize("loss_type,k,frac_outlier", FWD_CASES)
@pytest.mark.parametrize("grad_w", [True, False])
def test_bwd_matches_stream(loss_type, k, frac_outlier, grad_w, rng):
    emb, w, _, labels = make_case(rng, frac_outlier=frac_outlier, repeat_label=True)
    kw, gt, logz, topk, d_ce, d_neg = _bwd_inputs(rng, emb, labels, loss_type, k, w)
    ge, gw = jmp._stream_bwd(jnp.asarray(emb), jnp.asarray(w), jnp.asarray(labels), gt, logz,
                             topk, jnp.asarray(d_ce), jnp.asarray(d_neg), tile=64,
                             normalize_w=True, grad_w=grad_w, **kw)
    d_emb, d_w = tms.margin_ce_bwd(t(emb), t(w), t(labels), t(gt), t(logz), t(topk), t(d_ce),
                                   t(d_neg), grad_w=grad_w, **kw)
    np.testing.assert_allclose(d_emb.numpy(), np.asarray(ge), atol=GRAD_ATOL)
    if grad_w:
        np.testing.assert_allclose(d_w.numpy(), np.asarray(gw), atol=GRAD_ATOL)
    else:
        assert d_w is None


def test_bwd_matches_pallas_interpret(rng):
    emb, w, _, labels = make_case(rng, b=8, c=150, d=128, frac_outlier=0.4, repeat_label=True)
    kw, gt, logz, topk, d_ce, d_neg = _bwd_inputs(rng, emb, labels, "Arc", 3, w)
    ge, gw = jmp.pallas_margin_ce_bwd(jnp.asarray(emb), jnp.asarray(w), jnp.asarray(labels), gt,
                                      logz, topk, jnp.asarray(d_ce), jnp.asarray(d_neg),
                                      interpret=True, tile=128, normalize_w=True, **kw)
    d_emb, d_w = tms.margin_ce_bwd(t(emb), t(w), t(labels), t(gt), t(logz), t(topk), t(d_ce),
                                   t(d_neg), **kw)
    np.testing.assert_allclose(d_emb.numpy(), np.asarray(ge), atol=GRAD_ATOL)
    np.testing.assert_allclose(d_w.numpy(), np.asarray(gw), atol=GRAD_ATOL)


SGD_CASES = [(0.9, True, 1e-4), (0.9, False, 0.0), (0.0, False, 1e-4)]


def _fused_case(rng, loss_type, frac_outlier, repeat_label, k=3):
    emb, w, mom, labels = make_case(rng, frac_outlier=frac_outlier, repeat_label=repeat_label)
    b = emb.shape[0]
    pos = labels >= 0
    d_ce = np.where(pos, 1.0 / b, 0.0).astype(np.float32)
    d_neg = np.where(pos, 0.0, 1.0 / b).astype(np.float32)
    kw = kw_for(loss_type, k)
    gt, (_, _, logz, topk) = jax_fwd(emb, w, labels, kw)
    return emb, w, mom, labels, d_ce, d_neg, kw, gt, logz, topk


def _assert_fused(got, d_emb_o, new_w_o, new_mom_o):
    d_emb, new_w, new_mom = got
    np.testing.assert_allclose(d_emb.numpy(), np.asarray(d_emb_o), atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(new_mom.numpy(), np.asarray(new_mom_o), atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(new_w.numpy(), np.asarray(new_w_o), atol=2e-6, rtol=1e-5)


@pytest.mark.parametrize("momentum,nesterov,wd", SGD_CASES)
@pytest.mark.parametrize("loss_type", ["Arc", "SV"])
def test_fused_matches_stream_plus_sgd(momentum, nesterov, wd, loss_type, rng):
    emb, w, mom, labels, d_ce, d_neg, kw, gt, logz, topk = _fused_case(rng, loss_type, 0.0, False)
    lr = 0.05
    ge, gw = jmp._stream_bwd(jnp.asarray(emb), jnp.asarray(w), jnp.asarray(labels), gt, logz,
                             topk, jnp.asarray(d_ce), jnp.asarray(d_neg), tile=64,
                             normalize_w=True, **kw)
    new_w_o, new_mom_o = jmp.apply_sgd_dense(jnp.asarray(w), jnp.asarray(mom), gw, lr,
                                             momentum=momentum, nesterov=nesterov,
                                             weight_decay=wd)
    w_t, mom_t = t(w), t(mom)
    got = tms.margin_ce_bwd_fused_sgd(t(emb), w_t, mom_t, t(labels), t(gt), t(logz), t(topk),
                                      t(d_ce), t(d_neg), lr, momentum=momentum,
                                      nesterov=nesterov, weight_decay=wd, **kw)
    assert got[1] is w_t and got[2] is mom_t  # in place
    _assert_fused(got, ge, new_w_o, new_mom_o)


@pytest.mark.parametrize("frac_outlier,repeat_label", [(0.4, False), (0.0, True)])
def test_fused_matches_pallas_interpret(frac_outlier, repeat_label, rng):
    """Outlier rows (hard-negative cotangents, no target tail) and a batch
    whose rows 0 and 1 share a class: both rows' target gradients add into
    that class's row."""
    emb, w, mom, labels, d_ce, d_neg, kw, gt, logz, topk = _fused_case(
        rng, "Arc", frac_outlier, repeat_label)
    if repeat_label:
        assert labels[0] == labels[1] >= 0
    sgd = dict(momentum=0.9, nesterov=True, weight_decay=1e-4)
    ge, nw, nm = jmp.pallas_margin_ce_bwd_fused_sgd(
        jnp.asarray(emb), jnp.asarray(w), jnp.asarray(mom), jnp.asarray(labels), gt, logz, topk,
        jnp.asarray(d_ce), jnp.asarray(d_neg), 0.1, interpret=True, tile=128, normalize_w=True,
        **sgd, **kw)
    got = tms.margin_ce_bwd_fused_sgd(t(emb), t(w), t(mom), t(labels), t(gt), t(logz), t(topk),
                                      t(d_ce), t(d_neg), 0.1, **sgd, **kw)
    _assert_fused(got, ge, nw, nm)
    # the plain version is chunk-invariant, and a repeated class's row moves
    # by both rows' gradients (dropping one of them shows)
    again = tms.margin_ce_bwd_fused_sgd_plain(t(emb), t(w), t(mom), t(labels), t(gt), t(logz),
                                              t(topk), t(d_ce), t(d_neg), 0.1, chunk=9, **sgd,
                                              **kw)
    _assert_fused(again, ge, nw, nm)


def test_streaming_op_matches_jax(rng):
    """``streaming_margin_grads_fused_sgd``: the public op's plumbing
    (cotangent masking, gt, return order) against the JAX op's CPU route."""
    emb, w, mom, labels = make_case(rng, repeat_label=True)
    b = emb.shape[0]
    d_ce = np.full(b, 1.0 / b, np.float32)
    d_neg = np.zeros(b, np.float32)
    okw = dict(loss_type="Arc", margin=0.4, scale=24.0, hard_neg=1, mask_svfc=1.2)
    sgd = dict(momentum=0.9, nesterov=True, weight_decay=1e-4)
    want = jmp.streaming_margin_grads_fused_sgd(
        jnp.asarray(emb), jnp.asarray(w), jnp.asarray(mom), jnp.asarray(labels),
        jnp.asarray(d_ce), jnp.asarray(d_neg), 0.05, use_pallas=False, tile=64, **sgd, **okw)
    got = tms.streaming_margin_grads_fused_sgd(t(emb), t(w), t(mom), t(labels), t(d_ce),
                                               t(d_neg), 0.05, **sgd, **okw)
    names = ("ce", "neg", "topk", "gt", "d_emb", "new_w", "new_mom")
    tols = (VAL_ATOL, VAL_ATOL, VAL_ATOL, 1e-6, 2e-5, 2e-6, 2e-5)
    for name, g, wnt, tol in zip(names, got, want, tols):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), atol=tol, rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("loss_type", ["Arc", "AM", "SV"])
def test_autograd_matches_jax_grad(loss_type, rng):
    """``fused_add_margin`` through ``MarginSoftmax``: the scalar loss and
    its gradients w.r.t. emb and w against ``jax.grad`` of the JAX op on
    its scan route, with outlier rows (k = 3) and a repeated label."""
    emb, w, _, labels = make_case(rng, c=97, frac_outlier=0.4, repeat_label=True)
    mk = dict(loss_type=loss_type, margin=0.5, scale=24.0, hard_neg=3, mask_svfc=1.2)

    def jloss(e, ww):
        return jmp.fused_add_margin(e, ww, jnp.asarray(labels), tile=32, use_pallas=False, **mk)

    want, (ge, gw) = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(emb), jnp.asarray(w))
    e_t = t(emb).requires_grad_(True)
    w_t = t(w).requires_grad_(True)
    loss = tms.fused_add_margin(e_t, w_t, t(labels), **mk)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(e_t.grad.numpy(), np.asarray(ge), atol=GRAD_ATOL)
    np.testing.assert_allclose(w_t.grad.numpy(), np.asarray(gw), atol=GRAD_ATOL)
    # topk is a monitoring output: it carries no gradient
    ce, neg, topk = tms.fused_margin_softmax(e_t, w_t, t(labels), loss_type, 0.5, 24.0, 3)
    assert not topk.requires_grad and ce.requires_grad
    # a constant w: the backward computes no d_w and the same d_emb
    e2 = t(emb).requires_grad_(True)
    tms.fused_add_margin(e2, t(w), t(labels), **mk).backward()
    np.testing.assert_array_equal(e2.grad.numpy(), e_t.grad.numpy())


def test_cpu_tensors_never_launch_and_bf16_refused(rng):
    emb, w, mom, labels = make_case(rng, c=40)
    tms.reset_launch_counts()
    b = emb.shape[0]
    ones = torch.full((b,), 1.0 / b)
    tms.streaming_margin_grads_fused_sgd(t(emb), t(w), t(mom), t(labels), ones,
                                         torch.zeros(b), 0.1, momentum=0.9, nesterov=True,
                                         weight_decay=1e-4)
    tms.fused_add_margin(t(emb).requires_grad_(True), t(w), t(labels), hard_neg=1).backward()
    assert tms.LAUNCH_COUNTS == {"margin_ce_fwd": 0, "margin_ce_bwd": 0,
                                 "margin_ce_bwd_fused_sgd": 0}
    kw = kw_for("Arc", 1)
    gt = tms.compute_gt(t(emb), t(w), t(labels))
    with pytest.raises(NotImplementedError):
        tms.margin_ce_fwd(t(emb), t(w).bfloat16(), t(labels), gt, **kw)
    with pytest.raises(ValueError):
        tms.margin_ce_fwd(t(emb), t(w), t(labels), gt, **kw_for("Arc", 17))
