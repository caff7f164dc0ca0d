"""The quad head's bf16, int8 and int8-compute forms
(``vlsfr_tpu_torch/ops/twin_margin.py``) against the JAX package's Pallas
kernels, run in interpret mode as ``tests/test_qqueue.py`` runs them.

On the CPU the port's wrappers run their plain versions; these round where
the JAX kernels round (the module docstring of the port's twin_margin.py):
bf16 dot operands with f32 sums, int8 rows scaled after the dot, the
int8-compute dot of the quantised probes as an exact integer sum, and the
backward's d_cos rounded to bf16 per tile of JAX's kernel, the tile both
sides resolve from the same request (``round_tile``). Both sides round at
the same points, so what is left is the order of f32 sums and, rarely, a
d_cos whose last f32 bits differ landing on the other side of a bf16
rounding boundary. Limits: per-row values (ce, neg, logz) 1e-5 relative +
1e-5 absolute; top-k 1e-6; d_emb 1e-5 × its max; d_gt 1e-5; the
int8-compute raw dot bit for bit. The scale is 32, a power of two, so
JAX's z = f32(acc) · ((se · 32) · s) is the port's 32 · (f32(acc) · (se ·
s)) exactly.

Sizes are tests/test_qqueue.py's (b = 16 probes per direction, q = 512
slots, d = 128), with the tile at 64 columns, and again at tiles that
resolve to 256 and 512 columns (the shipped configs resolve 1024 and
2048); a backward that rounds per 64 columns there fails
``parity.rounded_demb`` against JAX.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlsfr_tpu.ops import twin_margin as jtm
from vlsfr_tpu.ops.qqueue import quantize_rows as j_quantize
from vlsfr_tpu_torch.core.ffc import state_from_jax
from vlsfr_tpu_torch.ops import twin_margin as ttm
from vlsfr_tpu_torch.ops.qqueue import quantize_rows
from vlsfr_tpu_torch.utils import parity

FORMS = ("bf16", "int8", "int8c")
B, Q, D, K, TILE = 16, 512, 128, 4, 64
SCALE = 32.0


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def make_dir(rng, b=B, q=Q, d=D):
    """One direction: probes, gallery rows and a write plan with a
    duplicate slot; in-pool labels on written slots, outliers, and a
    target that no write touches."""
    p, g = _unit(rng.standard_normal((b, d))), _unit(rng.standard_normal((b, d)))
    rows = rng.integers(0, 2, b).astype(np.int32)
    cols = rng.integers(0, q, b).astype(np.int32)
    rows[1], cols[1] = rows[0], cols[0]
    seen = (rng.random(b) < 0.5).astype(np.float32)
    labels = cols.copy()
    labels[rng.random(b) < 0.3] = -1
    labels[2] = -1
    labels[3] = rng.integers(0, q)
    return p, g, rows, cols, seen, labels


def make_queue(rng, form, q=Q, d=D):
    """The JAX queue of the form and its scales (None for bf16)."""
    queue = jnp.asarray(np.stack([_unit(rng.standard_normal((q, d))) for _ in range(2)]))
    if form == "bf16":
        return queue.astype(jnp.bfloat16), None
    return j_quantize(queue)


def interpret(fn):
    return functools.partial(fn, interpret=True)


def pallas_kw(loss_type, form, qs, tile=TILE):
    return dict(loss_type=loss_type, margin=0.5, scale=SCALE, k=K, mask_svfc=1.2, tile=tile,
                interpret=True, qscales=qs, int8_compute=form == "int8c")


def port_quad(tq, tqs, da, db, loss_type, form, tile=TILE):
    """QuadMargin outputs (8 per-row values and 2 hits) with leaf probes."""
    t = [torch.from_numpy(x) for x in (*da, *db)]
    px, py = t[0].clone().requires_grad_(True), t[6].clone().requires_grad_(True)
    out = ttm.QuadMargin.apply(px, py, tq, tqs, t[1], t[7], t[2], t[3], t[4], t[8], t[9], t[10],
                               t[5], t[11], loss_type, 0.5, SCALE, K, 1.2, form == "int8c", tile)
    return out, px, py


@pytest.mark.parametrize("loss_type", ["Arc", "AM", "SV"])
@pytest.mark.parametrize("form", FORMS)
def test_quad_forms_match_pallas_interpret(form, loss_type, rng):
    """The forward's per-row values, logz and top-k, and the backward's
    d_emb (with the φ'(gt) tail), against pallas_quad_fwd / _bwd."""
    forms_against_pallas(form, loss_type, rng, TILE)


@pytest.mark.parametrize("tile", [256, 512])
@pytest.mark.parametrize("form", FORMS)
def test_quad_forms_match_pallas_interpret_at_rounding_tile(form, tile, rng):
    """As above (Arc) with JAX's kernel tile at 256 and 512 columns (512:
    what ``pool.queue_tile = 0`` picks at 512 slots): the port resolves the
    same tile from the same request and rounds d_cos per that tile."""
    jtile = jtm._fit_tile(Q, jtm._twin_tile(B, D, tile, 1 if form != "bf16" else 2))
    assert jtile == tile == ttm.round_tile(Q, B, D, tile, 1 if form != "bf16" else 2)
    forms_against_pallas(form, "Arc", rng, tile)


@pytest.mark.parametrize("form", FORMS)
def test_quad_forms_match_pallas_interpret_at_200_rows(form, rng):
    """As above (Arc) at b = 200 probes per direction (R = 400: above the
    kernels' former 128 rows; the tensor-core forward's four 128-row
    groups, the backward's seven 64-row groups, the last ragged), q = 2048
    slots, d = 64, the tile at 256 columns (what both sides resolve from
    the request at these rows)."""
    assert ttm.round_tile(2048, 200, 64, 256, 1 if form != "bf16" else 2) == 256
    forms_against_pallas(form, "Arc", rng, 256, b=200, q=2048, d=64)


def forms_against_pallas(form, loss_type, rng, tile, b=B, q=Q, d=D):
    jq, qs = make_queue(rng, form, q=q, d=d)
    da, db = make_dir(rng, b, q, d), make_dir(rng, b, q, d)
    j = [jnp.asarray(x) for x in (*da, *db)]
    px, ga, ra, ca, sa, la = j[:6]
    py, gb, rb, cb, sb, lb = j[6:]
    gts_a = jtm.compute_twin_gt(px, jq, ga, ra, ca, sa, la, qscales=qs)
    gts_b = jtm.compute_twin_gt(py, jq, gb, rb, cb, sb, lb, qscales=qs)
    pk = pallas_kw(loss_type, form, qs, tile)
    out_p, res_p = jtm.pallas_quad_fwd(px, py, jq, ga, gb, (ra, ca, sa), (rb, cb, sb), la, lb,
                                       gts_a, gts_b, **pk)
    tq, tqs = state_from_jax(np.asarray(jq), None if qs is None else np.asarray(qs))
    out_t, tx, ty = port_quad(tq, tqs, da, db, loss_type, form, tile)
    for got, want in zip(out_t[:8], out_p):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)

    # logz and the target-excluded top-k of the packed forward
    t = [torch.from_numpy(x) for x in (*da, *db)]
    packed = ttm.pack_dirs(t[0], t[6], ttm.dir_inputs(tq, *t[1:5], tqs),
                           ttm.dir_inputs(tq, *t[7:11], tqs), t[5], t[11],
                           ttm.compute_twin_gt(t[0], tq, *t[1:6], tqs),
                           ttm.compute_twin_gt(t[6], tq, *t[7:12], tqs))
    e8 = quantize_rows(packed[0]) if form == "int8c" else None
    _, _, logz, topk = ttm.quad_fwd(packed[0], tq, *packed[1:], b=b, loss_type=loss_type,
                                    margin=0.5, scale=SCALE, k=K, mask_svfc=1.2,
                                    qscales=None if tqs is None else tqs[0], e8=e8)
    for i, (di, v) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
        rs = slice(b * di, b * di + b)
        np.testing.assert_allclose(logz[v, rs].numpy(), np.asarray(res_p[i]), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(topk[v, rs].numpy(), np.asarray(res_p[4 + i]), atol=1e-6)

    cots = [(rng.standard_normal(b) / b).astype(np.float32) for _ in range(8)]
    torch.autograd.backward(list(out_t[:8]), [torch.from_numpy(c) for c in cots])
    c = [jnp.asarray(x) for x in cots]
    gx, gy = jtm.pallas_quad_bwd(px, py, jq, ga, gb, (ra, ca, sa), (rb, cb, sb), la, lb, gts_a,
                                 gts_b, res_p[:4], res_p[4:], tuple(c[:4]), tuple(c[4:]), **pk)
    for got, want in ((tx.grad, gx), (ty.grad, gy)):
        want = np.asarray(want)
        if b == B:
            np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * np.abs(want).max())
        else:  # more d_cos terms, more that straddle a bf16 boundary: the kernels' limits
            checks = parity.rounded_demb("d_emb", got, torch.from_numpy(want))
            assert not parity.failures(checks), [parity.describe(ch) for ch in checks]


def test_int8c_raw_dot_matches_jax_exactly(rng):
    """The int8-compute probes (quantize_rows per row) and their raw dot
    with an int8 plane: the port's f32 product of the int8 values equals
    JAX's int32 dot_general bit for bit."""
    jq, qs = make_queue(rng, "int8")
    emb = _unit(rng.standard_normal((2 * B, D)))
    e8_j, se_j = j_quantize(jnp.asarray(emb))
    e8_t, se_t = quantize_rows(torch.from_numpy(emb))
    np.testing.assert_array_equal(e8_t.numpy(), np.asarray(e8_j))
    np.testing.assert_array_equal(se_t.numpy(), np.asarray(se_j))
    raw_j = jax.lax.dot_general(e8_j, jq[0], (((1,), (1,)), ((), ())),
                                preferred_element_type=jnp.int32)
    w8 = torch.from_numpy(np.array(jq[0]))
    raw_t = e8_t.float() @ w8.float().T
    np.testing.assert_array_equal(raw_t.numpy(), np.asarray(raw_j).astype(np.float32))
    qs0 = torch.from_numpy(np.array(qs[0]))
    (check,) = parity.int8_dot_checks(e8_t, se_t, w8, qs0)
    assert check["err"] == 0.0 == check["limit"]
    # the clean cosine: one f32 rounding of the exact integer, as JAX's
    # _cos_int8_dot forms it
    want = jtm._cos_int8_dot(e8_j, se_j[:, None], jq[0], qs[0][None, :])
    got = ttm.clean_cos(e8_t.float(), w8, qscales=qs0, e8=(e8_t, se_t))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("form", FORMS)
def test_quad_add_margin_forms_match_jax(form, rng, monkeypatch):
    """quad_add_margin (losses, accuracy) and its autograd against JAX's
    quad_add_margin and jax.grad on the Pallas path (interpret mode)."""
    monkeypatch.setattr(jtm, "pallas_quad_fwd", interpret(jtm.pallas_quad_fwd))
    monkeypatch.setattr(jtm, "pallas_quad_bwd", interpret(jtm.pallas_quad_bwd))
    jq, qs = make_queue(rng, form)
    da, db = make_dir(rng), make_dir(rng)
    kw = dict(loss_type="Arc", margin=0.5, scale=SCALE, hard_neg=K, mask_svfc=1.2)
    int8c = form == "int8c"

    def jax_total(px, py):
        (la, lb), acc = jtm.quad_add_margin(
            px, py, jq, jnp.asarray(da[1]), jnp.asarray(db[1]),
            tuple(jnp.asarray(x) for x in da[2:5]), tuple(jnp.asarray(x) for x in db[2:5]),
            jnp.asarray(da[5]), jnp.asarray(db[5]), tile=TILE, use_pallas=True,
            with_acc=True, qscales=qs, int8_compute=int8c, **kw)
        return la + 2.0 * lb, (la, lb, acc)

    (_, (la, lb, acc)), (gx, gy) = jax.value_and_grad(jax_total, argnums=(0, 1), has_aux=True)(
        jnp.asarray(da[0]), jnp.asarray(db[0]))

    tq, tqs = state_from_jax(np.asarray(jq), None if qs is None else np.asarray(qs))
    px = torch.from_numpy(da[0]).requires_grad_(True)
    py = torch.from_numpy(db[0]).requires_grad_(True)
    t = lambda i, d: torch.from_numpy(d[i])  # noqa: E731
    (ta, tb), tacc = ttm.quad_add_margin(
        px, py, tq, t(1, da), t(1, db), (t(2, da), t(3, da), t(4, da)),
        (t(2, db), t(3, db), t(4, db)), t(5, da), t(5, db), with_acc=True, qscales=tqs,
        int8_compute=int8c, tile=TILE, **kw)
    (ta + 2.0 * tb).backward()
    np.testing.assert_allclose(float(ta.detach()), float(la), rtol=1e-5)
    np.testing.assert_allclose(float(tb.detach()), float(lb), rtol=1e-5)
    assert float(tacc) == pytest.approx(float(acc), abs=1e-7)
    for got, want in ((px.grad, gx), (py.grad, gy)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * np.abs(want).max())
    assert not any(ttm.LAUNCH_COUNTS.values())  # CPU tensors: plain versions only


# ----------------------------------------------------------------------
# the partial (per-shard) forms
# ----------------------------------------------------------------------

C0, C_LOCAL = 128, 128  # the shard is rank 1 of 4 over 512 slots


def partial_dir(rng, q_local, qs_local, b, bp):
    """One direction against the shard [C0, C0 + C_LOCAL): b probes, bp
    writes (three in the block, one duplicate), labels owned, written,
    outlier and owned elsewhere, localised by JAX's rule."""
    rows = rng.integers(0, 2, bp).astype(np.int32)
    cols = rng.integers(0, 4 * C_LOCAL, bp).astype(np.int32)
    cols[:3] = C0 + rng.integers(0, C_LOCAL, 3)
    rows[1], cols[1] = rows[0], cols[0]
    seen = (rng.random(bp) < 0.5).astype(np.float32)
    labels = np.array([C0 + 5, cols[2], -1, C0 + C_LOCAL + 7] + [-1] * (b - 4), np.int32)
    lcol = cols - C0
    in_range = (lcol >= 0) & (lcol < C_LOCAL)
    lcol = np.where(in_range, lcol, -1).astype(np.int32)
    ll = labels - C0
    owned = (ll >= 0) & (ll < C_LOCAL)
    ll = np.where(labels < 0, -1, np.where(owned, ll, -2)).astype(np.int32)
    g = _unit(rng.standard_normal((bp, D)))
    idx = np.where(in_range, lcol, 0)
    q1 = np.asarray(q_local[1][idx]).astype(np.float32)
    if qs_local is not None:
        q1 = q1 * np.asarray(qs_local[1][idx])[:, None]
    v, blend = (np.asarray(x) for x in jtm.twin_write_values(q1, g, rows, cols, seen))
    gts = rng.uniform(-0.3, 0.8, (2, b)).astype(np.float32)
    return dict(emb=_unit(rng.standard_normal((b, D))), g=g, rows=rows, lcol=lcol,
                v=v.astype(np.float32), blend=blend.astype(np.int32), ll=ll, gts=gts,
                labels=labels)


@pytest.mark.parametrize("form,loss_type", [("bf16", "Arc"), ("int8", "Arc"), ("int8c", "Arc"),
                                            ("int8c", "AM")])
def test_partial_forms_match_pallas_interpret(form, loss_type, rng):
    """quad_partial_fwd / _bwd of one shard's block against
    pallas_quad_partial_fwd / _bwd (more writes than probes: bp = 8,
    b = 4). JAX's fixed-reference body keeps m = scale, so the state is
    held as m + log s."""
    partial_forms_against_pallas(form, loss_type, rng, TILE)


@pytest.mark.parametrize("form", FORMS)
def test_partial_forms_match_pallas_interpret_at_rounding_tile(form, rng):
    """As above (Arc) at JAX's default tile request of 512, which both
    sides resolve over the block of 128 slots and max(b, bp) rows to 128
    columns."""
    assert ttm.round_tile(C_LOCAL, 8, D, 512, 2 if form == "bf16" else 1) == C_LOCAL
    partial_forms_against_pallas(form, "Arc", rng, 512)


def partial_forms_against_pallas(form, loss_type, rng, tile):
    b, bp = 4, 8
    jq, qs = make_queue(rng, form, q=C_LOCAL)
    da, db = (partial_dir(rng, jq, qs, b, bp) for _ in range(2))
    cat = lambda key: torch.from_numpy(np.concatenate([da[key], db[key]]))  # noqa: E731
    E, G, V, rows, lcol, blend, ll = (cat(k_) for k_ in ("emb", "g", "v", "rows", "lcol",
                                                         "blend", "ll"))
    gt = torch.from_numpy(np.concatenate([da["gts"], db["gts"]], axis=1))
    tq, tqs = state_from_jax(np.asarray(jq), None if qs is None else np.asarray(qs))
    fkw = dict(qscales=None if tqs is None else tqs[0],
               e8=quantize_rows(E) if form == "int8c" else None)
    kw = dict(b=b, bp=bp, loss_type=loss_type, margin=0.5, scale=SCALE, k=K, mask_svfc=1.2)
    m, s, topk = ttm.quad_partial_fwd(E, tq[0], G, V, rows, lcol, blend, ll, gt, **kw, **fkw)

    jdir = lambda dd: (jnp.asarray(dd["g"]), jnp.asarray(dd["rows"]),  # noqa: E731
                       jnp.asarray(dd["lcol"]), jnp.asarray(dd["v"]), jnp.asarray(dd["blend"]),
                       jnp.asarray(dd["ll"]), jnp.asarray(dd["gts"][0]),
                       jnp.asarray(dd["gts"][1]))
    pk = pallas_kw(loss_type, form, qs, tile)
    pk["mxu_bf16"] = form == "bf16"
    parts = jtm.pallas_quad_partial_fwd(jnp.asarray(da["emb"]), jnp.asarray(db["emb"]), jq,
                                        jdir(da), jdir(db), **pk)
    for di, dir_parts in enumerate(parts):
        rs = slice(di * b, (di + 1) * b)
        for v, (jm, js, jt) in enumerate(dir_parts):
            np.testing.assert_allclose((m[v, rs] + torch.log(s[v, rs])).numpy(),
                                       np.asarray(jm) + np.log(np.asarray(js)), rtol=1e-5,
                                       atol=1e-5)
            np.testing.assert_allclose(topk[v, rs].numpy(), np.asarray(jt), atol=1e-6)

    pos = np.concatenate([da["labels"], db["labels"]]) >= 0
    logz = (m + torch.log(s)).numpy() + 1.0
    kth = topk[:, :, -1].numpy()
    cot = (rng.standard_normal((4, 2 * b)) / b).astype(np.float32)
    dce, dneg = np.where(pos, cot[:2], 0.0), np.where(pos, 0.0, cot[2:])
    f32 = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.float32))  # noqa: E731
    d_emb, dgt = ttm.quad_partial_bwd(E, tq[0], G, V, rows, lcol, blend, ll, gt, f32(logz),
                                      f32(kth), f32(dce), f32(dneg), **kw, **fkw, tile=tile)
    glob = lambda rs: tuple(jnp.asarray(x) for x in (  # noqa: E731
        logz[0, rs], logz[1, rs], kth[0, rs], kth[1, rs], dce[0, rs], dneg[0, rs], dce[1, rs],
        dneg[1, rs]))
    sa, sb = slice(0, b), slice(b, 2 * b)
    out = jtm.pallas_quad_partial_bwd(jnp.asarray(da["emb"]), jnp.asarray(db["emb"]), jq,
                                      jdir(da), jdir(db), glob(sa), glob(sb), **pk)
    dx, dg1a, dg2a, dy, dg1b, dg2b = (np.asarray(x) for x in out)
    for got, want in ((d_emb[sa], dx), (d_emb[sb], dy)):
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(dgt.numpy(), np.stack([np.concatenate([dg1a, dg1b]),
                                                      np.concatenate([dg2a, dg2b])]), atol=1e-5)


def test_64_column_rounding_fails_at_a_wider_tile(rng):
    """The repair's witness: on a bf16 queue of 2048 slots with JAX's tile
    at 512, many 64-column tiles hold none of a direction's writes while
    their 512-column tile does. A backward that chooses its rounding per
    64 columns (the port before the repair) fails ``rounded_demb`` against
    pallas_quad_bwd there; the port at the same tile request passes."""
    q = 2048
    jq, qs = make_queue(rng, "bf16", q=q)
    da, db = make_dir(rng, q=q), make_dir(rng, q=q)
    j = [jnp.asarray(x) for x in (*da, *db)]
    px, ga, ra, ca, sa, la = j[:6]
    py, gb, rb, cb, sb, lb = j[6:]
    gts_a = jtm.compute_twin_gt(px, jq, ga, ra, ca, sa, la)
    gts_b = jtm.compute_twin_gt(py, jq, gb, rb, cb, sb, lb)
    pk = pallas_kw("Arc", "bf16", None, 512)
    _, res_p = jtm.pallas_quad_fwd(px, py, jq, ga, gb, (ra, ca, sa), (rb, cb, sb), la, lb,
                                   gts_a, gts_b, **pk)
    cots = [(rng.standard_normal(B) / B).astype(np.float32) for _ in range(8)]
    c = [jnp.asarray(x) for x in cots]
    want = np.concatenate([np.asarray(x) for x in jtm.pallas_quad_bwd(
        px, py, jq, ga, gb, (ra, ca, sa), (rb, cb, sb), la, lb, gts_a, gts_b, res_p[:4],
        res_p[4:], tuple(c[:4]), tuple(c[4:]), **pk)])
    tq, _ = state_from_jax(np.asarray(jq))
    bad = {}
    for tile in (TILE, 512):
        out_t, tx, ty = port_quad(tq, None, da, db, "Arc", "bf16", tile)
        torch.autograd.backward(list(out_t[:8]), [torch.from_numpy(x) for x in cots])
        got = torch.cat([tx.grad, ty.grad])
        bad[tile] = parity.failures(parity.rounded_demb("d_emb", got, torch.from_numpy(want)))
    assert bad[TILE], "the 64-column rule should not pass at JAX's 512-column tile"
    assert not bad[512], bad[512]
