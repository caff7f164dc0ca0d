"""The port's fused quad head (vlsfr_tpu_torch/ops/twin_margin.py) against
the JAX package's (vlsfr_tpu/ops/twin_margin.py).

On the CPU the port's ``quad_fwd`` / ``quad_bwd`` run their plain PyTorch
versions; they are held against the JAX scan reference
(``_quad_fwd_impl(use_pallas=False)`` / ``_quad_vjp_bwd``) across Arc/AM/SV,
a duplicate write slot and the hard-negative depths k ∈ {2, 4} (the
shipped merge probe is m = 2), and once against the Pallas kernels
``pallas_quad_fwd/bwd`` in interpret mode. The CUDA kernels themselves are
held against the plain versions by tests/test_torch_kernels.py (``gpu``
marker; skips without a card) and by chip_smoke.py at the slice's full
width.

Tolerances are the JAX suite's own (tests/test_twin_margin.py): atol 2e-5
on per-row values and top-k, 3e-5 on d_emb — the plain version splits the
logsumexp into a target-excluded stream plus the analytic target term,
which reorders f32 sums of O(scale) terms.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlsfr_tpu.ops import twin_margin as jtm
from vlsfr_tpu_torch.ops import twin_margin as ttm

VAL_ATOL = 2e-5
DEMB_ATOL = 3e-5


def make_dir(rng, b, q, d, frac_outlier=0.3, dup_slot=False):
    unit = lambda x: (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)  # noqa: E731
    p = unit(rng.standard_normal((b, d)))
    g = unit(rng.standard_normal((b, d)))
    rows = rng.integers(0, 2, b).astype(np.int32)
    cols = rng.integers(0, q, b).astype(np.int32)
    if dup_slot:  # two samples write the same (row, col) — last write wins
        rows[1], cols[1] = rows[0], cols[0]
    seen = (rng.random(b) < 0.5).astype(np.float32)
    labels = cols.copy()
    labels[rng.random(b) < frac_outlier] = -1
    labels[2] = -1  # both row kinds always present
    return p, g, rows, cols, seen, labels


def make_quad(rng, b=8, q=96, d=16, dup_slot=False):
    queue = rng.standard_normal((2, q, d)).astype(np.float32)
    queue /= np.linalg.norm(queue, axis=-1, keepdims=True)
    da = make_dir(rng, b, q, d, dup_slot=dup_slot)
    db = make_dir(rng, b, q, d, dup_slot=dup_slot)
    return queue, da, db


def jax_args(queue, da, db):
    j = [jnp.asarray(x) for x in (queue, *da, *db)]
    q, (px, ga, ra, ca, sa, la), (py, gb, rb, cb, sb, lb) = j[0], j[1:7], j[7:]
    return (px, py, q, None, ga, gb, ra, ca, sa, rb, cb, sb, la, lb)


def torch_quad(queue, da, db, kw):
    """QuadMargin outputs (8 per-row values + 2 hits) with leaf probes."""
    t = [torch.from_numpy(x) for x in (queue, *da, *db)]
    q, (px, ga, ra, ca, sa, la), (py, gb, rb, cb, sb, lb) = t[0], t[1:7], t[7:]
    px.requires_grad_(True)
    py.requires_grad_(True)
    out = ttm.QuadMargin.apply(px, py, q, None, ga, gb, ra, ca, sa, rb, cb, sb, la, lb,
                               kw["loss_type"], kw["margin"], kw["scale"], kw["hard_neg"],
                               kw["mask_svfc"], False)
    return out, px, py


def packed_fwd(queue, da, db, kw):
    """The port's ``quad_fwd`` on the packed layout (plain version on CPU)."""
    q = torch.from_numpy(queue)
    pa = [torch.from_numpy(x) for x in da]
    pb = [torch.from_numpy(x) for x in db]
    packed = ttm.pack_dirs(pa[0], pb[0], ttm.dir_inputs(q, *pa[1:5]),
                           ttm.dir_inputs(q, *pb[1:5]), pa[5], pb[5],
                           ttm.compute_twin_gt(pa[0], q, *pa[1:]),
                           ttm.compute_twin_gt(pb[0], q, *pb[1:]))
    return ttm.quad_fwd(packed[0], q, *packed[1:], b=len(da[0]), loss_type=kw["loss_type"],
                        margin=kw["margin"], scale=kw["scale"], k=kw["hard_neg"],
                        mask_svfc=kw["mask_svfc"])


def random_cots(rng, b=8):
    """Per-row cotangents at the scale the loss reduction gives them
    (1 / rows), so d_emb stays O(scale / b) as in training."""
    return [(rng.standard_normal(b) / b).astype(np.float32) for _ in range(8)]


CASES = [(lt, dup, k) for lt in ("Arc", "AM", "SV") for dup in (False, True) for k in (2, 4)]


@pytest.mark.parametrize("loss_type,dup_slot,k", CASES)
def test_quad_matches_jax_scan(loss_type, dup_slot, k, rng):
    """Forward values/top-k and the full d_emb (kernel + φ'(gt) tail) vs
    the JAX scan reference with random cotangents."""
    queue, da, db = make_quad(rng, dup_slot=dup_slot)
    kw = dict(loss_type=loss_type, margin=0.5, scale=32.0, hard_neg=k, mask_svfc=1.2)
    jargs = jax_args(queue, da, db)
    out_j, res_j = jtm._quad_vjp_fwd(*jargs, loss_type, 0.5, 32.0, k, 1.2, 16, False, False)
    out_t, px, py = torch_quad(queue, da, db, kw)
    for got, want in zip(out_t, out_j):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=VAL_ATOL)
    # logz and the target-excluded top-k, per (direction, view)
    _, _, logz, topk = packed_fwd(queue, da, db, kw)
    j_logz, j_topk = res_j[15], res_j[16]
    for i, (d, v) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
        rs = slice(8 * d, 8 * d + 8)
        np.testing.assert_allclose(logz[v, rs].numpy(), np.asarray(j_logz[i]), atol=VAL_ATOL)
        np.testing.assert_allclose(topk[v, rs].numpy(), np.asarray(j_topk[i]), atol=VAL_ATOL)

    cots = random_cots(rng)
    torch.autograd.backward(list(out_t[:8]), [torch.from_numpy(c) for c in cots])
    jcots = tuple(jnp.asarray(c) for c in cots) + (jnp.zeros(8), jnp.zeros(8))
    gx, gy = jtm._quad_vjp_bwd(loss_type, 0.5, 32.0, k, 1.2, 16, False, False, res_j, jcots)[:2]
    np.testing.assert_allclose(px.grad.numpy(), np.asarray(gx), atol=DEMB_ATOL)
    np.testing.assert_allclose(py.grad.numpy(), np.asarray(gy), atol=DEMB_ATOL)


@pytest.mark.parametrize("loss_type", ["Arc", "AM", "SV"])
def test_quad_add_margin_losses_and_grads_match_jax(loss_type, rng):
    """quad_add_margin (losses + streamed accuracy) and autograd vs jax.grad."""
    queue, da, db = make_quad(rng, dup_slot=True)
    kw = dict(loss_type=loss_type, margin=0.5, scale=24.0, hard_neg=3, mask_svfc=1.2)

    def jax_total(px, py):
        (la, lb), acc = jtm.quad_add_margin(
            px, py, jnp.asarray(queue), jnp.asarray(da[1]), jnp.asarray(db[1]),
            tuple(jnp.asarray(x) for x in da[2:5]), tuple(jnp.asarray(x) for x in db[2:5]),
            jnp.asarray(da[5]), jnp.asarray(db[5]), tile=16, use_pallas=False, with_acc=True,
            **kw)
        return la + 2.0 * lb, (la, lb, acc)

    (_, (la, lb, acc)), (gx, gy) = jax.value_and_grad(jax_total, argnums=(0, 1), has_aux=True)(
        jnp.asarray(da[0]), jnp.asarray(db[0]))

    px = torch.from_numpy(da[0]).requires_grad_(True)
    py = torch.from_numpy(db[0]).requires_grad_(True)
    t = lambda i, d: torch.from_numpy(d[i])  # noqa: E731
    (ta, tb), tacc = ttm.quad_add_margin(
        px, py, torch.from_numpy(queue), t(1, da), t(1, db), (t(2, da), t(3, da), t(4, da)),
        (t(2, db), t(3, db), t(4, db)), t(5, da), t(5, db), with_acc=True, **kw)
    (ta + 2.0 * tb).backward()
    np.testing.assert_allclose(float(ta.detach()), float(la), rtol=1e-5)
    np.testing.assert_allclose(float(tb.detach()), float(lb), rtol=1e-5)
    assert float(tacc) == pytest.approx(float(acc), abs=1e-7)
    np.testing.assert_allclose(px.grad.numpy(), np.asarray(gx), atol=DEMB_ATOL)
    np.testing.assert_allclose(py.grad.numpy(), np.asarray(gy), atol=DEMB_ATOL)


def test_quad_matches_pallas_interpret(rng):
    """The port's plain fwd/bwd vs the Pallas quad kernels themselves,
    run in interpret mode (fixed-reference zfix body at scale 32)."""
    queue, da, db = make_quad(rng, b=8, q=70, d=128, dup_slot=True)
    k = 4
    kw = dict(loss_type="Arc", margin=0.5, scale=32.0, hard_neg=k, mask_svfc=1.2)
    j = jax_args(queue, da, db)
    px, py, q, _, ga, gb, ra, ca, sa, rb, cb, sb, la, lb = j
    gts_a = jtm.compute_twin_gt(px, q, ga, ra, ca, sa, la)
    gts_b = jtm.compute_twin_gt(py, q, gb, rb, cb, sb, lb)
    pk = dict(loss_type="Arc", margin=0.5, scale=32.0, k=k, mask_svfc=1.2, tile=32,
              interpret=True)
    out_p, res_p = jtm.pallas_quad_fwd(px, py, q, ga, gb, (ra, ca, sa), (rb, cb, sb), la, lb,
                                       gts_a, gts_b, **pk)
    out_t, tx, ty = torch_quad(queue, da, db, kw)
    for got, want in zip(out_t[:8], out_p):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=VAL_ATOL)

    cots = random_cots(rng)
    torch.autograd.backward(list(out_t[:8]), [torch.from_numpy(c) for c in cots])
    c = [jnp.asarray(x) for x in cots]
    gx, gy = jtm.pallas_quad_bwd(px, py, q, ga, gb, (ra, ca, sa), (rb, cb, sb), la, lb,
                                 gts_a, gts_b, res_p[:4], res_p[4:], tuple(c[:4]),
                                 tuple(c[4:]), **pk)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), atol=DEMB_ATOL)
    np.testing.assert_allclose(ty.grad.numpy(), np.asarray(gy), atol=DEMB_ATOL)


def test_helpers_match_jax(rng):
    """twin_write_values, compute_twin_gt and reduce_margin_dir."""
    queue, da, _ = make_quad(rng, dup_slot=True)
    p, g, rows, cols, seen, labels = da
    jv, jb = jtm.twin_write_values(jnp.asarray(queue[1][cols]), jnp.asarray(g),
                                   jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(seen))
    tv, tb = ttm.twin_write_values(torch.from_numpy(queue[1][cols]), torch.from_numpy(g),
                                   torch.from_numpy(rows), torch.from_numpy(cols),
                                   torch.from_numpy(seen))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    jg = jtm.compute_twin_gt(*(jnp.asarray(x) for x in (p, queue, g, rows, cols, seen, labels)))
    tg = ttm.compute_twin_gt(*(torch.from_numpy(x) for x in (p, queue, g, rows, cols, seen,
                                                             labels)))
    for got, want in zip(tg, jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    vals = [rng.standard_normal(8).astype(np.float32) for _ in range(4)]
    want = jtm.reduce_margin_dir(*(jnp.asarray(v) for v in vals), jnp.asarray(labels))
    got = ttm.reduce_margin_dir(*(torch.from_numpy(v) for v in vals), torch.from_numpy(labels))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_wrappers_reject_bad_inputs(rng):
    queue, da, db = make_quad(rng)
    E = torch.zeros(16, 16)
    args = (torch.from_numpy(queue), torch.zeros(16, 16), torch.zeros(16, 16),
            torch.zeros(16, dtype=torch.int32), torch.zeros(16, dtype=torch.int32),
            torch.zeros(16, dtype=torch.int32), torch.zeros(16, dtype=torch.int32),
            torch.zeros(2, 16))
    kw = dict(b=8, loss_type="Arc", margin=0.5, scale=32.0, mask_svfc=1.2)
    ttm.quad_fwd(E, *args, k=3, **kw)  # well-formed: runs the plain version
    with pytest.raises(ValueError):
        ttm.quad_fwd(E, *args, k=ttm.KMAX + 1, **kw)
    with pytest.raises(ValueError):
        ttm.quad_fwd(E.double(), *args, k=3, **kw)
    with pytest.raises(ValueError):
        ttm.quad_fwd(E, *args, k=3, **dict(kw, loss_type="Cos"))
    with pytest.raises(ValueError):  # an int8 plane without its scales
        ttm.quad_fwd(E, args[0].to(torch.int8), *args[1:], k=3, **kw)
    with pytest.raises(ValueError, match="int8_compute requires an int8-stored queue"):
        ttm.quad_add_margin(E[:8], E[8:], torch.from_numpy(queue).bfloat16(), E[:8], E[8:],
                            args[3:6], args[3:6], args[6][:8], args[6][:8], int8_compute=True)


@pytest.mark.parametrize("form", ttm.FORMS)
def test_bwd_geometry_covers_the_queue_once(form):
    """The backward kernel's grid (``bwd_geometry``), at probe rows, queue
    sizes and SM counts from a few rows and a ragged 63 columns up to the
    10M-slot int8 queue: its column chunks cover [0, Q) exactly once in
    whole 64-column tiles, its row groups cover the R rows, and every form
    (64 rows, one block an SM) makes one wave and sends written columns'
    d_cos to a [R, 2, bp] wcoef; the f32 kernel also takes their cosines
    from a [R, 2, bp] wcos, the tensor-core forms none."""
    tc = form in ttm.TC_FORMS
    for r_, q, sms, bp in ((2, 1, 132, 1), (74, 63, 132, 37), (74, 3001, 16, 37),
                           (128, 64, 114, 64), (256, 4096, 132, 128), (256, 1 << 20, 132, 128),
                           (256, 10485760, 132, 128), (256, 2621440, 114, 256)):
        geo = ttm.bwd_geometry(form, r_, q, sms, bp)
        assert (geo.rows_per_block, geo.blocks_per_sm) == (64, 1)
        per = geo.cols_per_chunk
        assert per % ttm.TILE == 0
        spans = [(c * per, min(q, (c + 1) * per)) for c in range(geo.nchunk)]
        assert spans[0][0] == 0 and spans[-1][1] == q
        assert all(lo < hi for lo, hi in spans)
        assert all(a[1] == b_[0] for a, b_ in zip(spans, spans[1:]))
        assert (geo.n_rg - 1) * geo.rows_per_block < r_ <= geo.n_rg * geo.rows_per_block
        assert geo.nchunk * geo.n_rg <= geo.blocks_per_sm * sms
        assert geo.wcoef == (r_, 2, bp)
        assert geo.wcos == (None if tc else (r_, 2, bp))
