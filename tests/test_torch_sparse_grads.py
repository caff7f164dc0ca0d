"""The port's sparse-classifier routes against the JAX package's
(tests/test_sparse_grads.py on the JAX side): the forward's tile
statistics, tile selection, the sparse backward, the explicit sparse op,
the sparse row optimizer and partial-FC sampling.

The same numpy inputs go through both packages; the JAX Pallas kernels run
in interpret mode, as that file runs them. Random draws are JAX's own
(``jax.random.uniform`` / ``randint`` on the keys the JAX code uses),
converted to numpy and handed to the port, which takes its draws as
tensors.

Tolerances: values, statistics and gradients 2e-5 absolute (the JAX
suite's; the port sums the same terms in another order, and scale·cos
turns a 1e-7 cosine difference into 2.4e-6 of maxz at scale 24), 3e-5 for
the gradients of the whole sparse op (JAX's own 3e-5 in
test_sparse_exact_when_all_tiles); tile indices, importance weights, the
sampled set and row indices exactly; the sparse row update 1e-6 absolute
and 1e-6 relative (f32 pow and products in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlsfr_tpu.ops import margin_pallas as jmp
from vlsfr_tpu.parallel import partial_fc as jpfc
from vlsfr_tpu.train.sparse_classifier import sparse_sgd_rows as j_sparse_sgd_rows
from vlsfr_tpu_torch.ops import margin_stream as tms
from vlsfr_tpu_torch.parallel import partial_fc as tpfc
from vlsfr_tpu_torch.train.sparse_classifier import sparse_sgd_rows

ATOL = 2e-5


def make_case(rng, b=8, c=96, d=16, frac_outlier=0.3, repeat_label=False):
    emb = rng.standard_normal((b, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
    w = rng.standard_normal((c, d)).astype(np.float32)
    labels = rng.integers(0, c, size=b).astype(np.int32)
    if repeat_label:
        labels[1] = labels[0]
    labels[rng.random(b) < frac_outlier] = -1
    if frac_outlier:
        labels[2] = -1  # both row kinds always present
    return emb, w, labels


def t(x):
    return torch.from_numpy(np.array(x))


def kw_for(loss_type, k):
    return dict(loss_type=loss_type, margin=0.5, scale=24.0, k=k, mask_svfc=1.2)


def jax_stats(emb, w, labels, kw, tile):
    ej, wj, lj = jnp.asarray(emb), jnp.asarray(w), jnp.asarray(labels)
    gt = jmp.compute_gt(ej, wj, lj, True)
    return gt, jmp._stream_fwd(ej, wj, lj, gt, with_stats=True, normalize_w=True, tile=tile, **kw)


# ----------------------------------------------------------------------
# forward statistics
# ----------------------------------------------------------------------

STAT_CASES = [("Arc", 1, 0.0, 128), ("AM", 3, 0.4, 128), ("SV", 3, 0.4, 128),
              ("Arc", 3, 0.4, 150), ("AM", 1, 0.0, 150), ("SV", 1, 0.0, 150)]


@pytest.mark.parametrize("loss_type,k,frac_outlier,c", STAT_CASES)
def test_fwd_stats_match_stream(loss_type, k, frac_outlier, c, rng):
    """C a multiple of the stats tile (128) and not (150: a ragged last
    tile whose padding must never enter a maximum)."""
    emb, w, labels = make_case(rng, c=c, d=32, frac_outlier=frac_outlier, repeat_label=True)
    kw = kw_for(loss_type, k)
    gt, want = jax_stats(emb, w, labels, kw, tile=32)
    got = tms.margin_ce_fwd(t(emb), t(w), t(labels), t(gt), with_stats=True, tile=32, **kw)
    assert got[4].shape == (-(-c // 32), 8)
    for name, g, wnt in zip(("ce", "neg", "logz", "topk", "maxz", "maxcos"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), atol=ATOL, err_msg=name)
    # the plain version's chunking does not change the statistics
    again = tms.margin_ce_fwd_plain(t(emb), t(w), t(labels), t(gt), with_stats=True, tile=32,
                                    chunk=40, **kw)
    for g, a in zip(got, again):
        np.testing.assert_allclose(g.numpy(), a.numpy(), atol=ATOL)


def test_fwd_stats_match_pallas_interpret(rng):
    emb, w, labels = make_case(rng, b=8, c=200, d=128, frac_outlier=0.4)
    kw = kw_for("SV", 3)
    ej, wj, lj = jnp.asarray(emb), jnp.asarray(w), jnp.asarray(labels)
    gt = jmp.compute_gt(ej, wj, lj, True)
    want = jmp.pallas_margin_ce_fwd(ej, wj, lj, gt, with_stats=True, interpret=True, tile=128,
                                    normalize_w=True, **kw)
    got = tms.margin_ce_fwd(t(emb), t(w), t(labels), t(gt), with_stats=True, tile=128, **kw)
    for name, g, wnt in zip(("ce", "neg", "logz", "topk", "maxz", "maxcos"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), atol=ATOL, err_msg=name)


# ----------------------------------------------------------------------
# tile selection
# ----------------------------------------------------------------------


def _planted_stats(rng, n_tiles=40, b=8, tile=16):
    """Statistics with an all-equal score band (tiles 10-29, every row's
    maxz 10) across the selection cutoff, two outlier rows and labels in
    five tiles."""
    maxz = rng.uniform(-30.0, 5.0, (n_tiles, b)).astype(np.float32)
    maxz[10:30] = 10.0  # above every other unforced tile: the band holds the cutoff
    maxcos = rng.uniform(-0.2, 0.4, (n_tiles, b)).astype(np.float32)
    logz = rng.uniform(5.0, 9.0, b).astype(np.float32)
    topk = np.sort(rng.uniform(0.1, 0.3, (b, 2)).astype(np.float32), axis=1)[:, ::-1].copy()
    labels = (np.array([3, 3, 12, 25, 33, 38, -1, -1]) * tile + 1).astype(np.int32)
    labels[labels < 0] = -1
    maxcos[7, 6] = topk[6, -1]  # a top-k holder of an outlier row
    return maxz, maxcos, logz, topk, labels


@pytest.mark.parametrize("fill", [False, True])
def test_select_relevant_tiles_matches_jax(fill, rng):
    """Equal indices (in JAX's order: lower index first among equal
    scores) and equal weights, with and without the random fill (JAX's
    draws), on real statistics and on a planted equal-score band."""
    tile = 16
    emb, w, labels = make_case(rng, b=8, c=160, d=16, frac_outlier=0.4)
    _, (_, _, logz, topk, maxz, maxcos) = jax_stats(emb, w, labels, kw_for("Arc", 3), tile)
    cases = [(maxz, maxcos, logz, topk, labels), _planted_stats(rng, tile=tile)]
    for i, (mz, mc, lz, tk, lab) in enumerate(cases):
        n_tiles = np.asarray(mz).shape[0]
        for m in (6, n_tiles // 2):
            key = jax.random.PRNGKey(11 + i) if fill else None
            j_idx, j_wt = jmp.select_relevant_tiles(jnp.asarray(mz), jnp.asarray(mc),
                                                    jnp.asarray(lz), jnp.asarray(tk),
                                                    jnp.asarray(lab), m, tile, key=key)
            u = t(jax.random.uniform(key, (n_tiles,))) if fill else None
            idx, wt = tms.select_relevant_tiles(t(mz), t(mc), t(lz), t(tk), t(lab), m, tile, u=u)
            assert idx.dtype == torch.int32
            np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx), err_msg=f"{i} m={m}")
            np.testing.assert_array_equal(wt.numpy(), np.asarray(j_wt), err_msg=f"{i} m={m}")
            if i == 1 and m == n_tiles // 2 and not fill:  # the cutoff splits the band
                band = set(range(10, 30)) - {12, 25}
                assert 0 < len(band & set(idx.tolist())) < len(band)


# ----------------------------------------------------------------------
# the sparse backward
# ----------------------------------------------------------------------


def _bwd_case(rng, loss_type, c=150, d=128):
    emb, w, labels = make_case(rng, b=8, c=c, d=d, frac_outlier=0.3, repeat_label=True)
    labels[0] = labels[1] = 140  # a repeated label in the ragged last tile (tile 4)
    labels[3] = 10  # a label in tile 0
    kw = kw_for(loss_type, 3)
    gt, (_, _, logz, topk, _, _) = jax_stats(emb, w, labels, kw, tile=32)
    d_ce = rng.standard_normal(8).astype(np.float32)
    d_neg = rng.standard_normal(8).astype(np.float32)
    # not sorted; tiles 1 and 3 left out, so some rows' targets are absent
    tile_idx = np.array([4, 0, 2], np.int32)
    return emb, w, labels, kw, gt, logz, topk, d_ce, d_neg, tile_idx


@pytest.mark.parametrize("loss_type", ["Arc", "AM", "SV"])
def test_sparse_bwd_matches_pallas_interpret_and_gather(loss_type, rng):
    emb, w, labels, kw, gt, logz, topk, d_ce, d_neg, tile_idx = _bwd_case(rng, loss_type)
    jargs = (jnp.asarray(emb), jnp.asarray(w), jnp.asarray(labels), gt, logz, topk,
             jnp.asarray(d_ce), jnp.asarray(d_neg), jnp.asarray(tile_idx))
    jkw = dict(normalize_w=True, tile=32, **kw)
    want_p = jmp.pallas_margin_ce_bwd_sparse(*jargs, interpret=True, **jkw)
    want_g = jmp._sparse_bwd_gather(*jargs, **jkw)
    d_emb, d_w_rows = tms.margin_ce_bwd_sparse(t(emb), t(w), t(labels), t(gt), t(logz), t(topk),
                                               t(d_ce), t(d_neg), t(tile_idx), tile=32, **kw)
    assert d_w_rows.shape == (3 * 32, 128)
    for want in (want_p, want_g):
        np.testing.assert_allclose(d_emb.numpy(), np.asarray(want[0]), atol=ATOL)
        np.testing.assert_allclose(d_w_rows.numpy(), np.asarray(want[1]), atol=ATOL)
    # rows past C (150 = 4·32 + 22) are zero; the repeated label's row moved
    np.testing.assert_array_equal(d_w_rows[22:32].numpy(), 0.0)
    assert float(d_w_rows[140 - 128].abs().max()) > 0


@pytest.mark.parametrize("exact_demb", [True, False])
def test_streaming_sparse_grads_matches_jax(exact_demb, rng):
    """The explicit op end to end with the random fill (JAX's draws):
    the loss outputs, d_emb (exact or truncated), the row indices and the
    importance-weighted d_w rows."""
    emb, w, labels = make_case(rng, b=8, c=200, d=16, frac_outlier=0.3, repeat_label=True)
    b, tile = 8, 16
    d_ce = (rng.standard_normal(b) / b).astype(np.float32)
    d_neg = (rng.standard_normal(b) / b).astype(np.float32)
    key = jax.random.PRNGKey(23)
    okw = dict(loss_type="Arc", margin=0.5, scale=24.0, hard_neg=3, mask_svfc=1.2, tile=tile)
    want = jmp.streaming_sparse_margin_grads(
        jnp.asarray(emb), jnp.asarray(w), jnp.asarray(labels), jnp.asarray(d_ce),
        jnp.asarray(d_neg), m_tiles=7, use_pallas=False, key=key, exact_demb=exact_demb, **okw)
    n_tiles = -(-200 // tile)
    u = t(jax.random.uniform(key, (n_tiles,)))
    got = tms.streaming_sparse_margin_grads(t(emb), t(w), t(labels), t(d_ce), t(d_neg), m_tiles=7,
                                            u=u, exact_demb=exact_demb, **okw)
    names = ("ce", "neg", "topk", "gt", "d_emb", "row_idx", "d_w_rows")
    for name, g, wnt in zip(names, got, want):
        if name == "row_idx":
            np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(wnt), atol=3e-5, err_msg=name)


@pytest.mark.parametrize("loss_type", ["Arc", "AM", "SV"])
def test_sparse_exact_when_all_tiles(loss_type, rng):
    """M = n_tiles: the port's sparse op IS the dense gradient of the JAX
    op (``jax.grad`` of ``fused_margin_softmax``), as
    tests/test_sparse_grads.py holds the JAX op."""
    emb, w, labels = make_case(rng, c=96, d=16)
    b, tile = 8, 16
    d_ce = rng.standard_normal(b).astype(np.float32)
    d_neg = rng.standard_normal(b).astype(np.float32)
    lj = jnp.asarray(labels)

    def f(e, ww):
        ce, neg, _ = jmp.fused_margin_softmax(e, ww, lj, loss_type, 0.5, 24.0, 3, 1.2, True, tile,
                                              False)
        return jnp.sum(ce * jnp.asarray(d_ce)) + jnp.sum(neg * jnp.asarray(d_neg))

    gd_e, gd_w = jax.grad(f, argnums=(0, 1))(jnp.asarray(emb), jnp.asarray(w))
    out = tms.streaming_sparse_margin_grads(t(emb), t(w), t(labels), t(d_ce), t(d_neg),
                                            m_tiles=96 // tile, loss_type=loss_type, margin=0.5,
                                            scale=24.0, hard_neg=3, tile=tile, exact_demb=False)
    row_idx, d_w_rows = out[5], out[6]
    dw = torch.zeros(96, 16).index_add_(0, row_idx.long(), d_w_rows)
    np.testing.assert_allclose(out[4].numpy(), np.asarray(gd_e), atol=3e-5)
    np.testing.assert_allclose(dw.numpy(), np.asarray(gd_w), atol=3e-5)


def test_cpu_tensors_never_launch_and_bad_tile_idx_refused(rng):
    emb, w, labels = make_case(rng, c=64, d=16)
    tms.reset_launch_counts()
    b = 8
    tms.streaming_sparse_margin_grads(t(emb), t(w), t(labels), torch.full((b,), 1.0 / b),
                                      torch.zeros(b), m_tiles=2, tile=16, u=torch.rand(4))
    assert all(v == 0 for v in tms.LAUNCH_COUNTS.values())
    kw = kw_for("Arc", 1)
    gt = tms.compute_gt(t(emb), t(w), t(labels))
    _, _, logz, topk = tms.margin_ce_fwd(t(emb), t(w), t(labels), gt, **kw)
    with pytest.raises(ValueError):  # tile indices must be int32
        tms.margin_ce_bwd_sparse(t(emb), t(w), t(labels), gt, logz, topk, torch.zeros(b),
                                 torch.zeros(b), torch.tensor([0, 1]), tile=16, **kw)
    # a tile index outside [0, 4) contributes zero rows and nothing to d_emb
    cot = (torch.full((b,), 1.0 / b), torch.zeros(b))
    args = (t(emb), t(w), t(labels), gt, logz, topk, *cot)
    d_emb, rows = tms.margin_ce_bwd_sparse(*args, torch.tensor([2, 4, -1], dtype=torch.int32),
                                           tile=16, **kw)
    d_emb2, rows2 = tms.margin_ce_bwd_sparse(*args, torch.tensor([2], dtype=torch.int32),
                                             tile=16, **kw)
    assert float(rows[16:].abs().max()) == 0.0
    torch.testing.assert_close(rows[:16], rows2)
    torch.testing.assert_close(d_emb, d_emb2)


# ----------------------------------------------------------------------
# the sparse row optimizer
# ----------------------------------------------------------------------


def test_sparse_sgd_rows_drops_oob():
    w = torch.ones(4, 3)
    mom = torch.zeros(4, 3)
    last = torch.zeros(4, dtype=torch.int32)
    kw = dict(lr=0.1, momentum=0.9, weight_decay=0.0, nesterov=False, step=1)
    out = sparse_sgd_rows(w, mom, torch.tensor([1, 4], dtype=torch.int32), torch.ones(2, 3),
                          last_visit=last, **kw)
    jw, jm, jl = j_sparse_sgd_rows(jnp.ones((4, 3)), jnp.zeros((4, 3)), jnp.asarray([1, 4]),
                                   jnp.ones((2, 3)), last_visit=jnp.zeros((4,), jnp.int32), **kw)
    assert out[0] is w and out[1] is mom and out[2] is last  # in place
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(mom.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(last.numpy(), np.asarray(jl))
    np.testing.assert_allclose(w[1].numpy(), 0.9)
    np.testing.assert_allclose(w[[0, 2, 3]].numpy(), 1.0)  # untouched; the sentinel dropped
    np.testing.assert_array_equal(last.numpy(), [0, 1, 0, 0])


@pytest.mark.parametrize("nesterov", [False, True])
def test_sparse_sgd_rows_catchup_matches_jax(nesterov):
    """Six rows visited on different gap sequences (weight decay on, one
    dropped sentinel per step): w, momentum and last-visit equal JAX's
    after every step; with weight decay off, row 0 (visited at 0, 1, 5, 6,
    13, 29, then a zero-gradient visit at 30) follows the dense SGD
    trajectory exactly, as tests/test_sparse_grads.py holds JAX's."""
    rng = np.random.default_rng(0)
    c, d, mu, lr = 6, 4, 0.9, 0.1
    row0 = (0, 1, 5, 6, 13, 29, 30)
    visits = {s: [0] for s in row0}
    for row, every in ((1, 2), (2, 3), (3, 7), (4, 11), (5, 1)):
        for s in range(0, 31, every):
            visits.setdefault(s, []).append(row)
    for wd in (1e-4, 0.0):
        w0 = rng.standard_normal((c, d)).astype(np.float32)
        w, mom, last = t(w0), torch.zeros(c, d), torch.zeros(c, dtype=torch.int32)
        jw, jm, jl = jnp.asarray(w0), jnp.zeros((c, d)), jnp.zeros((c,), jnp.int32)
        grads = {}
        for s in sorted(visits):
            rows = np.array(visits[s] + [c], np.int32)  # + a dropped sentinel
            g = rng.standard_normal((len(rows), d)).astype(np.float32)
            if s == 30:
                g[:] = 0.0
            if s in row0:
                grads[s] = g[0]
            kw = dict(lr=lr, momentum=mu, weight_decay=wd, nesterov=nesterov, step=s)
            sparse_sgd_rows(w, mom, t(rows), t(g), last_visit=last, **kw)
            jw, jm, jl = j_sparse_sgd_rows(jw, jm, jnp.asarray(rows), jnp.asarray(g),
                                           last_visit=jl, **kw)
            np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=1e-6, rtol=1e-6)
            np.testing.assert_allclose(mom.numpy(), np.asarray(jm), atol=1e-6, rtol=1e-6)
            np.testing.assert_array_equal(last.numpy(), np.asarray(jl))
        if wd == 0.0:  # row 0 against the dense trajectory over steps 0..30
            w_d, m_d = w0[0].copy(), np.zeros(d, np.float32)
            for s in range(31):
                gs = grads[s] if s in grads else np.zeros(d, np.float32)
                m_d = mu * m_d + gs
                w_d = w_d - lr * (gs + mu * m_d if nesterov else m_d)
            np.testing.assert_allclose(w[0].numpy(), w_d, rtol=1e-5, atol=1e-6)


# ----------------------------------------------------------------------
# partial-FC sampling
# ----------------------------------------------------------------------


@pytest.mark.parametrize("labels,c,s", [([5, 9, 5, 7], 50, 16),
                                        ([3, 3, 11, 7, 7, 7, 0, 2], 12, 48)])
def test_sample_classes_matches_jax(labels, c, s):
    """Duplicate batch labels, and (at C = 12, 40 draws) repeated draws and
    draws that collide with batch labels: equal sets, targets and masks."""
    labels = np.array(labels, np.int32)
    key = jax.random.PRNGKey(0)
    want = jpfc.sample_classes(jnp.asarray(labels), c, s, key)
    rand = t(jax.random.randint(key, (s - len(labels),), 0, c))
    got = tpfc.sample_classes(t(labels), c, s, rand)
    for name, g, wnt in zip(("sampled", "local_labels", "valid"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wnt), err_msg=name)
    v = got[2].numpy()
    assert not v.all() and len(set(got[0].numpy()[v].tolist())) == int(v.sum())


def test_sampled_loss_matches_jax():
    """``sampled_margin_softmax_loss``: loss, train_acc and the classifier
    gradient (through the gather; masked columns exact zero) against
    ``jax.value_and_grad`` of the JAX loss on the same draws."""
    rng = np.random.default_rng(4)
    c, b, d, s = 40, 6, 8, 24
    emb = rng.standard_normal((b, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
    w = rng.standard_normal((c, d)).astype(np.float32)
    labels = np.array([2, 2, 2, 9, 17, 30], np.int32)
    key = jax.random.PRNGKey(1)

    def jloss(ww):
        loss, m = jpfc.sampled_margin_softmax_loss(jnp.asarray(emb), ww, jnp.asarray(labels), key,
                                                   s, scale=24.0)
        return loss, m

    (want, jm), gw = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(w))
    rand = t(jax.random.randint(key, (s - b,), 0, c))
    w_t = t(w).requires_grad_(True)
    loss, m = tpfc.sampled_margin_softmax_loss(t(emb), w_t, t(labels), rand, s, scale=24.0)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    assert float(m["train_acc"]) == pytest.approx(float(jm["train_acc"]), abs=1e-6)
    assert m["sampled_classes"] == int(jm["sampled_classes"]) == s
    np.testing.assert_allclose(w_t.grad.numpy(), np.asarray(gw), atol=ATOL)
