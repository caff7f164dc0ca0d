"""The port's model-sharded twin head (``vlsfr_tpu_torch/parallel/sharded_twin.py``)
against the JAX package's (``vlsfr_tpu/parallel/sharded_twin.py``).

* The plain versions of the twin partial kernels against JAX's Pallas
  partial kernels in interpret mode, on one shard's localized inputs built
  in numpy (the rule of ``vlsfr_tpu/parallel/_shard_common.py:localize``),
  with more writes than probes (bp = 8, b = 4), Arc / AM / SV, f32 and
  bf16: the raw state (m, s) and top-k 1e-5, d_emb 1e-5 × its max, the
  owner's raw d_gt 1e-5. The owner's target column is in the state, the
  other shards' rows (label −2) have none.
* The composition over 4 gloo ranks (spawned once for the module, a
  FileStore under the test's temp dir) against JAX's single-device
  ``twin_add_margin`` and its ``make_sharded_twin_loss`` on a 1×4 CPU mesh
  (scan partials), Arc / AM / SV on ``tests/test_sharded_twin.py``'s case
  with the in-pool probes moved near their targets:
  loss rel 1e-4, d_emb atol 3e-5 (that file's tolerances); and on the
  case's bf16 queue against JAX's sharded head on its Pallas partial
  kernels (interpret mode, tile 64: each block of 32 slots is one rounding
  tile on both sides), same limits.
* World 1 (a real group in this process) against the port's
  single-device ``twin_add_margin``: loss, accuracy and d_emb within 1e-6;
  and through ``directional_loss(use_fused=True, sharded_loss_fn=...)``.

The spawned ranks import this module by name, so it imports nothing of JAX
at module level: every JAX import sits inside a test or fixture.
"""

import os

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from vlsfr_tpu_torch.core.ffc import directional_loss
from vlsfr_tpu_torch.ops import twin_margin as ttm
from vlsfr_tpu_torch.parallel import distributed
from vlsfr_tpu_torch.parallel._shard_common import localize
from vlsfr_tpu_torch.parallel.mesh import make_mesh
from vlsfr_tpu_torch.parallel.sharded_twin import make_sharded_twin_loss

LOSS_TYPES = ("Arc", "AM", "SV")
LOSS_KW = dict(margin=0.5, scale=24.0, hard_neg=5)  # tests/test_sharded_twin.py's
T = torch.from_numpy


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


# ----------------------------------------------------------------------
# one shard's partial kernels against the Pallas partial kernels
# ----------------------------------------------------------------------

Q_ALL, C0, C_LOCAL = 256, 64, 64  # this shard is rank 1 of 4


def partial_case(rng, b, bp, d, form):
    """One direction against the block [C0, C0 + C_LOCAL): b probes and bp
    writes (three in this block, one duplicate slot, the rest anywhere);
    labels: an owned slot, an owned slot this step writes, an outlier and
    a slot of another shard. Localized by JAX's rule; gt global."""
    import jax.numpy as jnp

    from vlsfr_tpu.ops.twin_margin import twin_write_values

    q_local = np.stack([_unit(rng.standard_normal((C_LOCAL, d))) for _ in range(2)])
    if form == "bf16":
        q_local = np.asarray(jnp.asarray(q_local).astype(jnp.bfloat16).astype(jnp.float32))
    rows = rng.integers(0, 2, bp).astype(np.int32)
    cols = rng.integers(0, Q_ALL, bp).astype(np.int32)
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
    g = _unit(rng.standard_normal((bp, d)))
    v, blend = (np.asarray(x) for x in twin_write_values(
        q_local[1][np.where(in_range, lcol, 0)], g, rows, cols, seen))
    gts = rng.uniform(-0.3, 0.8, (2, b)).astype(np.float32)
    gts[:, owned] = 0.95  # the owner's target z = scale·φ(gt) dominates its state
    return dict(emb=_unit(rng.standard_normal((b, d))), q_local=q_local, g=g, rows=rows,
                cols=cols, lcol=lcol, v=v.astype(np.float32), blend=blend.astype(np.int32),
                labels=labels, ll=ll, gts=gts)


@pytest.mark.parametrize("form", ["f32", "bf16"])
@pytest.mark.parametrize("loss_type", LOSS_TYPES)
def test_twin_partials_match_pallas_interpret(loss_type, form, rng):
    import jax.numpy as jnp

    from vlsfr_tpu.ops import twin_margin as jtm

    b, bp, d, k = 4, 8, 16, 4
    c = partial_case(rng, b, bp, d, form)
    lcol, _, ll, _ = localize(C0, C_LOCAL, T(c["cols"]), T(c["labels"]))  # the port's rule
    np.testing.assert_array_equal(lcol.numpy(), c["lcol"])
    np.testing.assert_array_equal(ll.numpy(), c["ll"])
    jq = jnp.asarray(c["q_local"])
    if form == "bf16":
        jq = jq.astype(jnp.bfloat16)
    tq = T(np.array(c["q_local"])).to(torch.bfloat16 if form == "bf16" else torch.float32)
    kw = dict(loss_type=loss_type, margin=0.5, scale=32.0, k=k, mask_svfc=1.2)
    args = (T(c["emb"]), tq[0], T(c["g"]), T(c["v"]), T(c["rows"]), T(c["lcol"]),
            T(c["blend"]), T(c["ll"]), T(c["gts"]))
    m, s, topk = ttm.twin_partial_fwd(*args, **kw)
    jargs = (jnp.asarray(c["emb"]), jq, jnp.asarray(c["v"]), jnp.asarray(c["blend"]),
             jnp.asarray(c["g"]), jnp.asarray(c["rows"]), jnp.asarray(c["lcol"]),
             jnp.asarray(c["ll"]), jnp.asarray(c["gts"][0]), jnp.asarray(c["gts"][1]))
    pk = dict(kw, tile=64, interpret=True, mxu_bf16=form == "bf16")
    parts = jtm.pallas_twin_partial_fwd(*jargs, **pk)
    for v, (jm, js, jt) in enumerate(parts):
        np.testing.assert_allclose(m[v].numpy(), np.asarray(jm), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(s[v].numpy(), np.asarray(js), rtol=1e-5)
        np.testing.assert_allclose(topk[v].numpy(), np.asarray(jt), atol=1e-5)

    # the backward against GLOBAL row vectors (a logz above the block's own)
    pos = c["labels"] >= 0
    logz = (m + torch.log(s)).numpy() + 1.0
    kth = topk[:, :, -1].numpy()
    cot = (rng.standard_normal((4, b)) / b).astype(np.float32)
    dce = np.where(pos, cot[:2], 0.0).astype(np.float32)
    dneg = np.where(pos, 0.0, cot[2:]).astype(np.float32)
    f32 = lambda x: T(np.ascontiguousarray(x, np.float32))  # noqa: E731
    d_emb, dgt = ttm.twin_partial_bwd(*args, f32(logz), f32(kth), f32(dce), f32(dneg), tile=64,
                                      **kw)
    jd, jg1, jg2 = jtm.pallas_twin_partial_bwd(
        *jargs, *(jnp.asarray(x) for x in (logz[0], logz[1], kth[0], kth[1])),
        (jnp.asarray(dce[0]), jnp.asarray(dneg[0])), (jnp.asarray(dce[1]), jnp.asarray(dneg[1])),
        **pk)
    jd = np.asarray(jd)
    np.testing.assert_allclose(d_emb.numpy(), jd, atol=1e-5 * np.abs(jd).max())
    np.testing.assert_allclose(dgt.numpy(), np.stack([jg1, jg2]), atol=1e-5)
    assert (dgt.numpy()[:, c["ll"] < 0] == 0).all()  # the owner's d_gt only


# ----------------------------------------------------------------------
# the composition over 4 gloo ranks
# ----------------------------------------------------------------------


def near_target_case(seed):
    """tests/test_sharded_twin.py's case with every in-pool probe moved near
    its target's row 0 (0.9 cosine on average), so that the target term
    carries weight in logz and in its owner shard's state."""
    from test_sharded_twin import make_case

    rng = np.random.default_rng(seed)
    emb, q0, q1, g, rows, cols, seen, labels = make_case(rng)
    own = labels >= 0
    d = emb.shape[1]
    emb[own] = _unit(q0[labels[own]] + 0.5 * rng.standard_normal((int(own.sum()), d))
                     / np.sqrt(d))
    return emb, q0, q1, g, rows, cols, seen, labels


def _spawn(fn, world, *args):
    mp.spawn(fn, args=(world, *args), nprocs=world, join=True)


def _composition_rank(rank, world, store, case_path, out_dir):
    torch.set_num_threads(1)
    distributed.initialize("cpu", rank=rank, world_size=world, store_path=store)
    try:
        mesh = make_mesh(1, world)
        case = dict(np.load(case_path))
        c0, c_local = mesh.class_block(case["queue"].shape[1])
        out = {}
        runs = [(lt, lt, torch.float32) for lt in LOSS_TYPES] + [("bf16-Arc", "Arc",
                                                                  torch.bfloat16)]
        for key, lt, dtype in runs:
            q_l = T(np.ascontiguousarray(case["queue"][:, c0:c0 + c_local])).to(dtype)
            emb = T(case["emb"]).requires_grad_(True)
            fn = make_sharded_twin_loss(mesh, loss_type=lt, with_acc=True, tile=64, **LOSS_KW)
            loss, acc = fn(emb, q_l, *(T(case[k]) for k in ("g", "rows", "cols", "seen",
                                                            "labels")))
            loss.backward()
            out.update({f"{key}/loss": loss.detach().numpy(), f"{key}/acc": acc.numpy(),
                        f"{key}/grad": emb.grad.numpy()})
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        distributed.destroy()


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    """``near_target_case``, and every rank's loss, accuracy
    and d_emb from 4 spawned gloo ranks (one spawn for the three loss types
    on the f32 queue and Arc on its bf16 form)."""
    tmp = tmp_path_factory.mktemp("twin_world4")
    case = near_target_case(0)
    emb, q0, q1, g, rows, cols, seen, labels = case
    path = str(tmp / "case.npz")
    np.savez(path, emb=emb, queue=np.stack([q0, q1]), g=g, rows=rows, cols=cols, seen=seen,
             labels=labels)
    _spawn(_composition_rank, 4, str(tmp / "store"), path, str(tmp))
    return case, [dict(np.load(tmp / f"rank{r}.npz")) for r in range(4)]


def _jax_refs(case, loss_type, queue_dtype, **sharded_kw):
    """(loss, d_emb) of JAX's single-device twin_add_margin (f32 queue
    only) and of its sharded head on a 1×4 mesh."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from test_sharded_twin import place
    from vlsfr_tpu.ops.twin_margin import twin_add_margin
    from vlsfr_tpu.parallel.mesh import make_mesh as j_make_mesh
    from vlsfr_tpu.parallel.sharded_twin import make_sharded_twin_loss as j_sharded

    emb, q0, q1, g, rows, cols, seen, labels = case
    kw = dict(loss_type=loss_type, **LOSS_KW)
    mesh = j_make_mesh(1, 4, devices=jax.devices()[:4])
    placed = list(place(mesh, *case))
    queue = jnp.stack([jnp.asarray(q0), jnp.asarray(q1)]).astype(queue_dtype)
    placed[1] = jax.device_put(queue, NamedSharding(mesh, P(None, "model", None)))
    fn = j_sharded(mesh, **kw, **sharded_kw)
    refs = [jax.jit(jax.value_and_grad(lambda e: fn(e, *placed[1:])))(placed[0])]
    if queue_dtype == jnp.float32:
        rest = [jnp.asarray(x) for x in (g, rows, cols, seen, labels)]
        refs.append(jax.value_and_grad(lambda e: twin_add_margin(
            e, queue, *rest, tile=16, use_pallas=False, **kw))(jnp.asarray(emb)))
    return [(float(loss), np.asarray(grad)) for loss, grad in refs]


@pytest.mark.parametrize("loss_type", LOSS_TYPES)
def test_world4_composition_matches_jax(loss_type, world4):
    """4 gloo ranks against JAX's sharded twin (scan partials) and its
    single-device twin_add_margin; every rank holds the same result."""
    import jax.numpy as jnp

    case, ranks = world4
    for r in ranks:
        for loss, grad in _jax_refs(case, loss_type, jnp.float32, tile=16):
            assert float(r[f"{loss_type}/loss"]) == pytest.approx(loss, rel=1e-4)
            np.testing.assert_allclose(r[f"{loss_type}/grad"], grad, atol=3e-5)
        for key in ("loss", "acc", "grad"):
            np.testing.assert_array_equal(r[f"{loss_type}/{key}"], ranks[0][f"{loss_type}/{key}"])


def test_world4_bf16_composition_matches_jax(world4):
    """The bf16 queue over 4 gloo ranks against JAX's sharded twin on its
    Pallas partial kernels (interpret mode, mxu_bf16), tile 64."""
    import jax.numpy as jnp

    case, ranks = world4
    ((loss, grad),) = _jax_refs(case, "Arc", jnp.bfloat16, tile=64, use_pallas=True,
                                interpret=True)
    for r in ranks:
        assert float(r["bf16-Arc/loss"]) == pytest.approx(loss, rel=1e-4)
        np.testing.assert_allclose(r["bf16-Arc/grad"], grad, atol=3e-5)
        for key in ("loss", "acc", "grad"):
            np.testing.assert_array_equal(r[f"bf16-Arc/{key}"], ranks[0][f"bf16-Arc/{key}"])


# ----------------------------------------------------------------------
# world 1: the real group in this process
# ----------------------------------------------------------------------


@pytest.mark.parametrize("loss_type", LOSS_TYPES)
def test_world1_matches_twin_add_margin(loss_type, tmp_path):
    """The sharded twin over a real group of one equals the single-device
    twin head (the same plain versions, one block, one merge), called
    directly and through directional_loss's ``sharded_loss_fn``."""
    emb, q0, q1, g, rows, cols, seen, labels = near_target_case(1)
    queue = T(np.stack([q0, q1]))
    plan = [T(x) for x in (g, rows, cols, seen, labels)]
    kw = dict(loss_type=loss_type, **LOSS_KW)
    res = []
    assert distributed.initialize("cpu", rank=0, world_size=1, store_path=str(tmp_path / "s"))
    try:
        sharded = make_sharded_twin_loss(make_mesh(1, 1), with_acc=True, **kw)
        for loss_fn in (sharded, lambda *a: ttm.twin_add_margin(*a, with_acc=True, **kw)):
            e = T(emb).requires_grad_(True)
            loss, acc = loss_fn(e, queue, *plan)
            loss.backward()
            res.append((loss.detach(), acc, e.grad))
        e = T(emb).requires_grad_(True)
        loss, plan_b, acc = directional_loss(e, plan[0], queue, *plan[1:], use_fused=True,
                                             sharded_loss_fn=sharded, defer_scatter=True,
                                             with_acc=True, **kw)
        loss.backward()
        res.append((loss.detach(), acc, e.grad))
        assert plan_b[0] is not None and torch.equal(plan_b[2], plan[2])
        with pytest.raises(TypeError, match="with_acc=True"):
            directional_loss(e, plan[0], queue, *plan[1:], use_fused=True, with_acc=True,
                             defer_scatter=True,
                             sharded_loss_fn=make_sharded_twin_loss(make_mesh(1, 1), **kw), **kw)
        # the plan's slots are global and the queue is the rank's block:
        # only the caller can apply the write, so a sharded loss needs the plan
        with pytest.raises(ValueError, match="sharded_loss_fn needs defer_scatter=True"):
            directional_loss(e, plan[0], queue, *plan[1:], use_fused=True, with_acc=True,
                             sharded_loss_fn=sharded, **kw)
    finally:
        distributed.destroy()
    for got in res[0::2]:
        for g_, w_ in zip(got, res[1]):
            np.testing.assert_allclose(g_.numpy(), w_.numpy(), rtol=1e-6, atol=1e-6)
