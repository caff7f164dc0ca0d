"""The port's twin FFC head (``vlsfr_tpu_torch/ops/twin_margin.py``:
``twin_fwd`` / ``twin_bwd``, ``TwinMargin``, ``twin_add_margin``, and
``core/ffc.py:directional_loss(use_fused=True)``) against the JAX
package's, on the same numpy inputs.

On the CPU the port's twin wrappers run their plain versions. These are
held against JAX's Pallas twin kernels in interpret mode
(``pallas_twin_fwd`` / ``pallas_twin_bwd``, patched in as
``tests/test_twin_margin.py`` does) across Arc / AM / SV, f32 and bf16
queues, a duplicate write slot and two kernel tiles, one of them wider
than the kernels' 64 columns (the bf16 backward rounds d_cos per tile).
The twin keeps the target column in its stream, so the sums are JAX's
sums in another order only: per-row values and top-k 1e-5 relative + 1e-5
absolute, d_emb 1e-5 × its max, the scalar loss 1e-5 relative.

The port's pair of twin losses is also held against its own quad head (the
counterpart of ``tests/test_twin_margin.py::test_quad_matches_two_twins``:
losses 1e-5 relative as there, d_emb D = 64 f32 spacings of its max).

Sizes: b = 8 probes, Q = 512 slots, D = 64.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlsfr_tpu.core import ffc as jffc
from vlsfr_tpu.ops import twin_margin as jtm
from vlsfr_tpu_torch.core import ffc as tffc
from vlsfr_tpu_torch.core.ffc import state_from_jax
from vlsfr_tpu_torch.ops import twin_margin as ttm

B, Q, D, K = 8, 512, 64, 4
KW = dict(loss_type="Arc", margin=0.5, scale=32.0, mask_svfc=1.2)


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def make_case(rng, b=B, q=Q, d=D, near=True):
    """Probes, gallery rows, a [2, q, d] queue and a write plan with a
    duplicate (row, slot); labels on written slots (with ``near``, those
    probes near their written rows), outliers and one target no write
    touches."""
    p, g = _unit(rng.standard_normal((b, d))), _unit(rng.standard_normal((b, d)))
    queue = np.stack([_unit(rng.standard_normal((q, d))) for _ in range(2)])
    rows = rng.integers(0, 2, b).astype(np.int32)
    cols = rng.integers(0, q, b).astype(np.int32)
    rows[1], cols[1] = rows[0], cols[0]
    seen = (rng.random(b) < 0.5).astype(np.float32)
    labels = cols.copy()
    labels[rng.random(b) < 0.3] = -1
    labels[2] = -1
    labels[3] = rng.integers(0, q)
    # probes near their own writes: the target term then carries weight in
    # logz (for random probes it is ~e^-15 of the sum)
    own = (labels == cols) & near
    p[own] = _unit(g[own] + 0.5 * rng.standard_normal((int(own.sum()), d)) / np.sqrt(d))
    return p, g, queue, rows, cols, seen, labels


def jax_queue(queue, form):
    jq = jnp.asarray(queue)
    return jq.astype(jnp.bfloat16) if form == "bf16" else jq


def port_inputs(tq, p, g, rows, cols, seen, labels):
    """The twin kernels' inputs for one direction (E, G, V, rows, cols,
    blend, labels, gt)."""
    t = [torch.from_numpy(x) for x in (p, g, rows, cols, seen, labels)]
    g32, rows_i, cols_i, v, blend = ttm.dir_inputs(tq, *t[1:5])
    gt = torch.stack(ttm.compute_twin_gt(t[0], tq, *t[1:6]))
    return (t[0], g32, v, rows_i, cols_i, blend.to(torch.int32), t[5].to(torch.int32), gt)


@pytest.mark.parametrize("tile", [64, 256])
@pytest.mark.parametrize("form", ["f32", "bf16"])
@pytest.mark.parametrize("loss_type", ["Arc", "AM", "SV"])
def test_twin_plain_matches_pallas_interpret(loss_type, form, tile, rng):
    """twin_fwd / twin_bwd (their plain versions) against pallas_twin_fwd
    / pallas_twin_bwd: (ce, neg) per view, logz, the target-excluded
    top-k, d_emb with the φ'(gt) tail and d_gt."""
    twin_against_pallas(rng, loss_type, form, tile)


@pytest.mark.parametrize("form", ["f32", "bf16"])
def test_twin_plain_matches_pallas_interpret_at_200_rows(form, rng):
    """As above (Arc) at b = 200 probes (above the kernels' former 128
    rows: the tensor-core forward's two 128-row groups, the backward's four
    64-row groups, the last ragged), Q = 2048 slots, tile 256."""
    twin_against_pallas(rng, "Arc", form, 256, b=200, q=2048)


def twin_against_pallas(rng, loss_type, form, tile, b=B, q=Q):
    p, g, queue, rows, cols, seen, labels = make_case(rng, b=b, q=q)
    jq = jax_queue(queue, form)
    j = [jnp.asarray(x) for x in (p, g, rows, cols, seen, labels)]
    gt1, gt2 = jtm.compute_twin_gt(j[0], jq, *j[1:6])
    kw = dict(KW, loss_type=loss_type, k=K)
    out_j, res_j = jtm.pallas_twin_fwd(j[0], jq, *j[1:6], gt1, gt2, tile=tile, interpret=True,
                                       **kw)
    tq, _ = state_from_jax(np.asarray(jq))
    inp = port_inputs(tq, p, g, rows, cols, seen, labels)
    np.testing.assert_allclose(inp[7].numpy(), np.stack([gt1, gt2]), rtol=1e-6, atol=1e-6)
    ce, neg, logz, topk = ttm.twin_fwd(inp[0], tq, *inp[1:], **kw)
    for got, want in ((ce[0], out_j[0]), (neg[0], out_j[1]), (ce[1], out_j[2]),
                      (neg[1], out_j[3]), (logz[0], res_j[0]), (logz[1], res_j[1]),
                      (topk[0], res_j[2]), (topk[1], res_j[3])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)

    cot = (rng.standard_normal((4, b)) / b).astype(np.float32)
    pos = labels >= 0
    dce = np.where(pos, cot[[0, 2]], 0.0).astype(np.float32)
    dneg = np.where(pos, 0.0, cot[[1, 3]]).astype(np.float32)
    kth = topk[:, :, -1].contiguous()
    d_emb, dgt = ttm.twin_bwd(inp[0], tq, *inp[1:], logz, kth, torch.from_numpy(dce),
                              torch.from_numpy(dneg), tile=tile, **kw)
    d_emb = ttm.twin_gt_tail(torch.from_numpy(p), tq, *(torch.from_numpy(x) for x in
                                                          (g, rows, cols, seen, labels)),
                             inp[7][0], inp[7][1], dgt[0], dgt[1], d_emb, loss_type, 0.5)
    c = [jnp.asarray(x) for x in cot]
    want = np.asarray(jtm.pallas_twin_bwd(j[0], jq, *j[1:6], gt1, gt2, *res_j, (c[0], c[1]),
                                          (c[2], c[3]), tile=tile, interpret=True, **kw))
    np.testing.assert_allclose(d_emb.numpy(), want, atol=1e-5 * np.abs(want).max())
    # d_gt: JAX's in-kernel sum of the target column's dz
    zt = 32.0 * np.asarray(jax.vmap(lambda x: jtm._phi_target(x, loss_type, 0.5, 1.2))(
        jnp.stack([gt1, gt2])))
    dgt_j = np.where(pos, (np.exp(zt - np.stack(res_j[:2])) - 1.0) * dce * 32.0, 0.0)
    np.testing.assert_allclose(dgt.numpy(), dgt_j, rtol=1e-5, atol=1e-5)
    assert not any(ttm.LAUNCH_COUNTS.values())  # CPU tensors: plain versions only


def interpret_twin(monkeypatch):
    """JAX's twin op on its Pallas kernels in interpret mode."""
    monkeypatch.setattr(jtm, "pallas_twin_fwd",
                        functools.partial(jtm.pallas_twin_fwd, interpret=True))
    monkeypatch.setattr(jtm, "pallas_twin_bwd",
                        functools.partial(jtm.pallas_twin_bwd, interpret=True))


@pytest.mark.parametrize("loss_type,form", [("Arc", "f32"), ("AM", "f32"), ("SV", "f32"),
                                            ("Arc", "bf16"), ("SV", "bf16")])
def test_twin_add_margin_matches_jax(loss_type, form, rng, monkeypatch):
    """twin_add_margin's loss, accuracy and d_emb against JAX's
    twin_add_margin (Pallas, interpret mode) and jax.grad, at the default
    tile request of 512."""
    interpret_twin(monkeypatch)
    p, g, queue, rows, cols, seen, labels = make_case(rng)
    jq = jax_queue(queue, form)
    kw = dict(KW, loss_type=loss_type, hard_neg=K)
    j = [jnp.asarray(x) for x in (g, rows, cols, seen, labels)]

    def jax_loss(e):
        return jtm.twin_add_margin(e, jq, *j, use_pallas=True, with_acc=True, **kw)

    (loss_j, acc_j), grad_j = jax.value_and_grad(jax_loss, has_aux=True)(jnp.asarray(p))
    tq, _ = state_from_jax(np.asarray(jq))
    emb = torch.from_numpy(p).requires_grad_(True)
    loss, acc = ttm.twin_add_margin(emb, tq, *(torch.from_numpy(x) for x in
                                              (g, rows, cols, seen, labels)),
                                    with_acc=True, **kw)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(loss_j), rel=1e-5)
    assert float(acc) == pytest.approx(float(acc_j), abs=1e-7)
    grad_j = np.asarray(grad_j)
    np.testing.assert_allclose(emb.grad.numpy(), grad_j, atol=1e-5 * np.abs(grad_j).max())


@pytest.mark.parametrize("defer", [True, False])
def test_directional_loss_fused_matches_jax(defer, rng):
    """directional_loss(use_fused=True) with with_acc: the loss, the
    accuracy and d_emb against JAX's (its twin op on the CPU's scan
    path), and the second result: the write plan with ``defer_scatter``,
    else the written queue."""
    p, g, queue, rows, cols, seen, labels = make_case(rng)
    kw = dict(KW, hard_neg=K)
    j = [jnp.asarray(x) for x in (queue, rows, cols, seen, labels)]

    def jax_loss(e):
        loss, new_q, acc = jffc.directional_loss(e, jnp.asarray(g), j[0], *j[1:], use_fused=True,
                                                 defer_scatter=defer, with_acc=True, **kw)
        return loss, (new_q, acc)

    (loss_j, (new_j, acc_j)), grad_j = jax.value_and_grad(jax_loss, has_aux=True)(
        jnp.asarray(p))
    t = [torch.from_numpy(x) for x in (g, queue, rows, cols, seen, labels)]
    emb = torch.from_numpy(p).requires_grad_(True)
    loss, new_t, acc = tffc.directional_loss(emb, *t, use_fused=True, defer_scatter=defer,
                                             with_acc=True, **kw)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(loss_j), rel=1e-5)
    assert float(acc) == pytest.approx(float(acc_j), abs=1e-7)
    np.testing.assert_allclose(emb.grad.numpy(), np.asarray(grad_j),
                               atol=1e-5 * np.abs(np.asarray(grad_j)).max())
    if defer:
        assert len(new_t) == len(new_j) == 3
        for got, want in zip(new_t, new_j):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        np.testing.assert_array_equal(new_t.numpy(), np.asarray(new_j))
        assert not torch.equal(new_t, t[1])  # a written copy; the queue is untouched
        np.testing.assert_array_equal(t[1].numpy(), queue)


def test_directional_loss_dense_path_unchanged(rng):
    """use_fused off: the dense head, as before (JAX's dense path)."""
    p, g, queue, rows, cols, seen, labels = make_case(rng, q=96)
    kw = dict(KW, hard_neg=K)
    loss_j, new_j, acc_j = jffc.directional_loss(
        jnp.asarray(p), jnp.asarray(g), jnp.asarray(queue), jnp.asarray(rows), jnp.asarray(cols),
        jnp.asarray(seen), jnp.asarray(labels), with_acc=True, **kw)
    loss, new_t, acc = tffc.directional_loss(*(torch.from_numpy(x) for x in
                                               (p, g, queue, rows, cols, seen, labels)),
                                             with_acc=True, **kw)
    assert float(loss.detach()) == pytest.approx(float(loss_j), rel=1e-5)
    assert float(acc) == pytest.approx(float(acc_j), abs=1e-7)
    np.testing.assert_array_equal(new_t.numpy(), np.asarray(new_j))


def test_int8_queue_refused_with_jax_message(rng):
    """An int8 queue runs through the quad head only: both packages raise
    the same ValueError."""
    from vlsfr_tpu.ops.qqueue import quantize_rows

    p, g, queue, rows, cols, seen, labels = make_case(rng)
    q8, _ = quantize_rows(jnp.asarray(queue))
    with pytest.raises(ValueError) as jerr:
        jtm.twin_add_margin(jnp.asarray(p), q8, *(jnp.asarray(x) for x in
                                                  (g, rows, cols, seen, labels)))
    with pytest.raises(ValueError) as terr:
        ttm.twin_add_margin(torch.from_numpy(p), torch.from_numpy(np.array(q8)),
                            *(torch.from_numpy(x) for x in (g, rows, cols, seen, labels)))
    assert str(terr.value) == str(jerr.value)
    t8 = torch.from_numpy(np.array(q8))
    inp = port_inputs(torch.from_numpy(queue), p, g, rows, cols, seen, labels)
    with pytest.raises(ValueError, match="twin kernels take float32 or bfloat16"):
        ttm.twin_fwd(inp[0], t8, *inp[1:], k=K, **KW)


@pytest.mark.parametrize("near", [False, True])
@pytest.mark.parametrize("loss_type", ["Arc", "AM", "SV"])
def test_twin_pair_matches_quad(loss_type, near, rng):
    """The port's two twin losses (one per direction) against its quad
    head on the same inputs: losses and both probes' d_emb. On random
    probes JAX's test_quad_matches_two_twins case, with d_emb held to D
    f32 spacings of its max (2^-23 × max|d_emb| for each of the D = 64
    features summed in every dot; the two heads round the same products in
    another order, 5 spacings apart here, which an absolute 3e-6 held or
    not by the host's BLAS path). With the probes near their targets the
    target dominates logz and d_gt = (p_t − 1)·d_ce·scale cancels: the 1e-7
    by which the twin (target in the stream) and the quad (target added
    after it) round p_t becomes ~1e-4 of d_gt, so d_emb is held to 1e-5 ×
    its max there. Both limits stay below a fault of 1e-4 × max|d_emb|
    planted in the quad's d_emb (every value scaled by 1 + 1e-4)."""
    da, db = make_case(rng, near=near), make_case(rng, near=near)
    queue = torch.from_numpy(da[2])
    kw = dict(KW, loss_type=loss_type, hard_neg=3)
    t = lambda case: [torch.from_numpy(x) for x in case]  # noqa: E731
    ta, tb = t(da), t(db)
    res = []
    for run in ("quad", "twin"):
        px, py = ta[0].clone().requires_grad_(True), tb[0].clone().requires_grad_(True)
        if run == "quad":
            la, lb = ttm.quad_add_margin(px, py, queue, ta[1], tb[1], ta[3:6], tb[3:6], ta[6],
                                         tb[6], **kw)
        else:
            la = ttm.twin_add_margin(px, queue, ta[1], *ta[3:7], **kw)
            lb = ttm.twin_add_margin(py, queue, tb[1], *tb[3:7], **kw)
        (la + lb).backward()
        res.append((float(la.detach()), float(lb.detach()), px.grad, py.grad))
    (qa, qb, qx, qy), (wa, wb, wx, wy) = res
    assert wa == pytest.approx(qa, rel=1e-5) and wb == pytest.approx(qb, rel=1e-5)
    for got, want in ((wx, qx), (wy, qy)):
        atol = (1e-5 if near else D * 2.0**-23) * float(want.abs().max())
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=atol)
        with pytest.raises(AssertionError):
            np.testing.assert_allclose(got.numpy(), (want * (1 + 1e-4)).numpy(), rtol=0,
                                       atol=atol)


@pytest.mark.parametrize("c,b,d,tile,qbytes", [
    (10 * 2**20, 128, 512, 2048, 1), (4 * 2**20, 128, 512, 2048, 2), (2**20, 128, 512, 512, 4),
    (2**20, 128, 512, 512, 2), (2**18, 128, 512, 2048, 1), (512, 16, 128, 64, 2),
    (4096, 8, 64, 512, 2), (1000, 16, 64, 512, 2), (128, 8, 128, 512, 1)])
def test_round_tile_matches_jax(c, b, d, tile, qbytes):
    """round_tile resolves a tile request as JAX's _fit_tile(_twin_tile)
    does: 2048 for capacity_10m_int8c, 1024 for the bf16 pool of
    4,194,304."""
    want = jtm._fit_tile(c, jtm._twin_tile(b, d, tile, qbytes=qbytes))
    assert ttm.round_tile(c, b, d, tile, qbytes) == want
    if (c, qbytes) == (10 * 2**20, 1):
        assert want == 2048
    if (c, qbytes) == (4 * 2**20, 2):
        assert want == 1024


def test_round_tile_refuses_a_tile_off_the_64_grid():
    """A resolved tile that is not a multiple of 64 columns is refused
    (JAX's TPU path makes multiples of 128 only); the f32 form rounds
    nothing and takes any request."""
    with pytest.raises(ValueError, match="multiple of 64"):
        ttm.round_tile(1000, 8, 64, 100, 2)
    q = torch.zeros((2, 1000, 64))
    assert ttm._rounding_tile(q[0], 8, 8, 100) == ttm.TILE
    with pytest.raises(ValueError, match="multiple of 64"):
        ttm._rounding_tile(q[0].bfloat16(), 8, 8, 100)
