"""The port's model-sharded FFC head (``vlsfr_tpu_torch/parallel/``) against
the JAX package's (``vlsfr_tpu/parallel/sharded_quad.py``).

* The plain versions of the partial kernels against the Pallas partial
  kernels in interpret mode, on one shard's localized inputs built in
  numpy (the rule of ``vlsfr_tpu/parallel/_shard_common.py:localize``),
  with more writes than probes per direction (bp = 8, b = 4), for Arc and
  AM (JAX's Pallas SV partial streams the target in-band, the port never
  does: SV is held after the merge, below). At scale 32 JAX's body keeps
  a fixed reference m = scale, so the state is held as m + log s; at
  scale 64 it keeps the running max, and m and s are held apart.
  Tolerances: the state and top-k 1e-5; d_emb 3e-5, d_gt 1e-5 (JAX's own).
* The composition over 4 gloo ranks (spawned, a FileStore under the test's
  temp dir) against JAX's single-shard ``quad_add_margin`` and its sharded
  head on a 1×4 CPU mesh, for Arc, AM and SV, on the case that
  ``tests/test_sharded_quad.py:make_case`` makes: losses rel 1e-4, d_emb atol 3e-5 (JAX's
  own tolerances there).
* World 1 (the real group, in this process) against the port's
  single-device head: losses and d_emb within 1e-6.
* The slice as a whole: 3 steps of the toy net at ``mesh.model = 2`` over 2
  gloo ranks against JAX's ``make_train_step`` on a 1×2 mesh (losses
  1e-5 relative, parameters 1e-5 relative + 2e-5 absolute, the ranks'
  queue blocks together against JAX's queue 1e-5 as in
  ``test_torch_ffc_step.py``), the probe parameters bit-equal on both ranks.

The spawned ranks import this module by name, so it imports nothing of JAX
at module level: every JAX import sits inside a test or fixture.
"""

import os

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from vlsfr_tpu_torch.config import Config
from vlsfr_tpu_torch.ops import twin_margin as ttm
from vlsfr_tpu_torch.parallel import distributed
from vlsfr_tpu_torch.parallel._shard_common import localize, merge_partials
from vlsfr_tpu_torch.parallel.mesh import make_mesh
from vlsfr_tpu_torch.parallel.sharded_quad import make_sharded_quad_loss

LOSS_TYPES = ("Arc", "AM", "SV")
INT8C_LOSS_TYPES = ("Arc", "SV")
LOSS_KW = dict(margin=0.5, scale=24.0, hard_neg=5)  # tests/test_sharded_quad.py's
T = torch.from_numpy


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


# ----------------------------------------------------------------------
# one shard's partial kernels against the Pallas partial kernels
# ----------------------------------------------------------------------

Q_ALL, C0, C_LOCAL = 192, 48, 48  # this shard is rank 1 of 4


def np_localize(cols, labels):
    """The rule of vlsfr_tpu/parallel/_shard_common.py:39-51, in numpy."""
    lcol = cols - C0
    in_range = (lcol >= 0) & (lcol < C_LOCAL)
    lcol = np.where(in_range, lcol, -1).astype(np.int32)
    ll = labels - C0
    owned = (ll >= 0) & (ll < C_LOCAL)
    ll = np.where(labels < 0, -1, np.where(owned, ll, -2)).astype(np.int32)
    return lcol, in_range, ll


def partial_dir(rng, q_local, b, bp, d):
    """One direction: b probes and bp writes (global slot ids), localized.
    Writes: three in this block (one duplicate slot), the rest anywhere;
    labels: an owned slot, an owned slot this step writes, an outlier and
    a slot of another shard."""
    from vlsfr_tpu.ops.twin_margin import twin_write_values

    rows = rng.integers(0, 2, bp).astype(np.int32)
    cols = rng.integers(0, Q_ALL, bp).astype(np.int32)
    cols[:3] = C0 + rng.integers(0, C_LOCAL, 3)
    rows[1], cols[1] = rows[0], cols[0]
    seen = (rng.random(bp) < 0.5).astype(np.float32)
    labels = np.array([C0 + 5, cols[2], -1, C0 + C_LOCAL + 7] + [-1] * (b - 4), np.int32)
    lcol, in_range, ll = np_localize(cols, labels)
    g = _unit(rng.standard_normal((bp, d)))
    q1_rows = q_local[1][np.where(in_range, lcol, 0)]
    v, blend = (np.asarray(x) for x in twin_write_values(q1_rows, g, rows, cols, seen))
    gts = rng.uniform(-0.3, 0.8, (2, b)).astype(np.float32)
    return dict(emb=_unit(rng.standard_normal((b, d))), g=g, rows=rows, cols=cols, lcol=lcol,
                v=v.astype(np.float32), blend=blend.astype(np.int32), labels=labels, ll=ll,
                gts=gts)


@pytest.mark.parametrize("loss_type,scale", [("Arc", 32.0), ("AM", 32.0), ("Arc", 64.0),
                                             ("AM", 64.0)])
def test_partials_match_pallas_interpret(loss_type, scale, rng):
    import jax.numpy as jnp

    from vlsfr_tpu.ops import twin_margin as jtm

    b, bp, d, k = 4, 8, 16, 4
    q_local = np.stack([_unit(rng.standard_normal((C_LOCAL, d))) for _ in range(2)])
    da, db = partial_dir(rng, q_local, b, bp, d), partial_dir(rng, q_local, b, bp, d)
    for dd in (da, db):  # the port's localize is the same rule
        lcol, _, ll, _ = localize(C0, C_LOCAL, T(dd["cols"]), T(dd["labels"]))
        np.testing.assert_array_equal(lcol.numpy(), dd["lcol"])
        np.testing.assert_array_equal(ll.numpy(), dd["ll"])
    cat = lambda key: T(np.concatenate([da[key], db[key]]))  # noqa: E731
    E, G, V, rows, lcol, blend, ll = (cat(k_) for k_ in ("emb", "g", "v", "rows", "lcol", "blend",
                                                         "ll"))
    gt = T(np.concatenate([da["gts"], db["gts"]], axis=1))
    kw = dict(b=b, bp=bp, loss_type=loss_type, margin=0.5, scale=scale, k=k, mask_svfc=1.2)
    m, s, topk = ttm.quad_partial_fwd(E, T(q_local[0]), G, V, rows, lcol, blend, ll, gt, **kw)

    pk = dict(loss_type=loss_type, margin=0.5, scale=scale, k=k, mask_svfc=1.2, tile=16,
              interpret=True)
    jdir = lambda dd: (jnp.asarray(dd["g"]), jnp.asarray(dd["rows"]),  # noqa: E731
                       jnp.asarray(dd["lcol"]), jnp.asarray(dd["v"]), jnp.asarray(dd["blend"]),
                       jnp.asarray(dd["ll"]), jnp.asarray(dd["gts"][0]),
                       jnp.asarray(dd["gts"][1]))
    parts = jtm.pallas_quad_partial_fwd(jnp.asarray(da["emb"]), jnp.asarray(db["emb"]),
                                        jnp.asarray(q_local), jdir(da), jdir(db), **pk)
    for di, dir_parts in enumerate(parts):
        rs = slice(di * b, (di + 1) * b)
        for v, (jm, js, jt) in enumerate(dir_parts):
            jm, js, jt = np.asarray(jm), np.asarray(js), np.asarray(jt)
            if scale <= 40.0:  # JAX's fixed-reference body: m = scale
                np.testing.assert_allclose((m[v, rs] + torch.log(s[v, rs])).numpy(),
                                           jm + np.log(js), atol=1e-5)
            else:
                np.testing.assert_allclose(m[v, rs].numpy(), jm, atol=1e-5)
                np.testing.assert_allclose(s[v, rs].numpy(), js, rtol=1e-5)
            np.testing.assert_allclose(topk[v, rs].numpy(), jt, atol=1e-5)

    # the backward against GLOBAL row vectors, cotangents masked with the
    # global positive rows
    pos = np.concatenate([da["labels"], db["labels"]]) >= 0
    logz = (m + torch.log(s)).numpy() + 1.0
    kth = topk[:, :, -1].numpy()
    cot = (rng.standard_normal((4, 2 * b)) / b).astype(np.float32)
    dce, dneg = np.where(pos, cot[:2], 0.0), np.where(pos, 0.0, cot[2:])
    f32 = lambda x: T(np.ascontiguousarray(x, np.float32))  # noqa: E731
    d_emb, dgt = ttm.quad_partial_bwd(E, T(q_local[0]), G, V, rows, lcol, blend, ll, gt,
                                      f32(logz), f32(kth), f32(dce), f32(dneg), **kw)
    glob = lambda rs: tuple(jnp.asarray(x) for x in (  # noqa: E731
        logz[0, rs], logz[1, rs], kth[0, rs], kth[1, rs], dce[0, rs], dneg[0, rs], dce[1, rs],
        dneg[1, rs]))
    sa, sb = slice(0, b), slice(b, 2 * b)
    out = jtm.pallas_quad_partial_bwd(jnp.asarray(da["emb"]), jnp.asarray(db["emb"]),
                                      jnp.asarray(q_local), jdir(da), jdir(db), glob(sa),
                                      glob(sb), **pk)
    dx, dg1a, dg2a, dy, dg1b, dg2b = (np.asarray(x) for x in out)
    np.testing.assert_allclose(d_emb[sa].numpy(), dx, atol=3e-5)
    np.testing.assert_allclose(d_emb[sb].numpy(), dy, atol=3e-5)
    np.testing.assert_allclose(dgt.numpy(), np.stack([np.concatenate([dg1a, dg1b]),
                                                      np.concatenate([dg2a, dg2b])]), atol=1e-5)
    assert not dgt[:, ~torch.from_numpy(np.concatenate([da["ll"], db["ll"]]) >= 0)].any()


def test_merge_partials_empty_shard_adds_nothing(rng):
    """A shard whose rows saw no column, (−inf, 0), leaves the merge of the
    others unchanged and adds no NaN."""
    m = T(rng.standard_normal((3, 2, 5)).astype(np.float32))
    s = T(rng.random((3, 2, 5)).astype(np.float32) + 0.5)
    topk = torch.sort(T(rng.standard_normal((3, 2, 5, 4)).astype(np.float32)), dim=-1,
                      descending=True).values
    ref = merge_partials(m, s, topk, 4)
    empty = (torch.full((1, 2, 5), -float("inf")), torch.zeros(1, 2, 5),
             torch.full((1, 2, 5, 4), ttm.NEG_INF))
    got = merge_partials(torch.cat([m, empty[0]]), torch.cat([s, empty[1]]),
                         torch.cat([topk, empty[2]]), 4)
    for x, y in zip(got, ref):
        assert torch.equal(x, y)
    none = merge_partials(*empty, 4)
    assert not any(torch.isnan(x).any() for x in none)
    lse = ttm.finalize_fwd(*none, torch.tensor([-1] * 5, dtype=torch.int32),
                           torch.zeros(2, 5), loss_type="Arc", margin=0.5, scale=32.0)[2]
    assert torch.isinf(lse).all() and not torch.isnan(lse).any()
    want_lse = torch.logsumexp(torch.log(s) + m, dim=0)
    np.testing.assert_allclose((ref[0] + torch.log(ref[1])).numpy(), want_lse.numpy(),
                               rtol=1e-6)


# ----------------------------------------------------------------------
# the composition over gloo ranks
# ----------------------------------------------------------------------


def _spawn(fn, world, *args):
    mp.spawn(fn, args=(world, *args), nprocs=world, join=True)


def _composition_rank(rank, world, store, case_path, out_dir):
    torch.set_num_threads(1)
    distributed.initialize("cpu", rank=rank, world_size=world, store_path=store)
    try:
        mesh = make_mesh(1, world)
        case = dict(np.load(case_path))
        c0, c_local = mesh.class_block(case["queue"].shape[1])
        q_l = T(np.ascontiguousarray(case["queue"][:, c0:c0 + c_local]))
        q8_l = T(np.ascontiguousarray(case["queue8"][:, c0:c0 + c_local]))
        s8_l = T(np.ascontiguousarray(case["scales8"][:, c0:c0 + c_local]))
        out = {}
        runs = [(lt, lt, q_l, None, False) for lt in LOSS_TYPES]
        runs += [(f"int8c-{lt}", lt, q8_l, s8_l, True) for lt in INT8C_LOSS_TYPES]
        for key, lt, queue, qscales, int8c in runs:
            px = T(case["emb_x"]).requires_grad_(True)
            py = T(case["emb_y"]).requires_grad_(True)
            fn = make_sharded_quad_loss(mesh, loss_type=lt, with_acc=True, int8_compute=int8c,
                                        **LOSS_KW)
            (la, lb), acc = fn(px, py, queue, T(case["g_a"]), T(case["g_b"]),
                               tuple(T(case[f"{k}A"]) for k in ("rows", "cols", "seen")),
                               tuple(T(case[f"{k}B"]) for k in ("rows", "cols", "seen")),
                               T(case["labA"]), T(case["labB"]), qscales=qscales)
            (la + lb).backward()
            out.update({f"{key}/la": la.detach().numpy(), f"{key}/lb": lb.detach().numpy(),
                        f"{key}/acc": acc.numpy(), f"{key}/gx": px.grad.numpy(),
                        f"{key}/gy": py.grad.numpy()})
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        distributed.destroy()


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    """The test_sharded_quad.py case, and every rank's losses and d_emb
    from 4 spawned gloo ranks (one spawn for the three loss types on the f32
    queue and for Arc and SV on its int8 form with int8 compute)."""
    import jax.numpy as jnp

    from test_sharded_quad import make_case
    from vlsfr_tpu.ops.qqueue import quantize_rows

    tmp = tmp_path_factory.mktemp("world4")
    case = make_case(np.random.default_rng(0))
    (emb_x, emb_y, queue, g_a, g_b, (rA, cA, sA), (rB, cB, sB), labA, labB) = case
    queue8, scales8 = (np.asarray(x) for x in quantize_rows(jnp.asarray(queue)))
    path = str(tmp / "case.npz")
    np.savez(path, emb_x=emb_x, emb_y=emb_y, queue=queue, g_a=g_a, g_b=g_b, rowsA=rA, colsA=cA,
             seenA=sA, rowsB=rB, colsB=cB, seenB=sB, labA=labA, labB=labB, queue8=queue8,
             scales8=scales8)
    _spawn(_composition_rank, 4, str(tmp / "store"), path, str(tmp))
    return case, [dict(np.load(tmp / f"rank{r}.npz")) for r in range(4)]


@pytest.mark.parametrize("loss_type", LOSS_TYPES)
def test_world4_composition_matches_jax(loss_type, world4):
    import jax
    import jax.numpy as jnp

    from test_sharded_quad import place
    from vlsfr_tpu.ops.twin_margin import quad_add_margin
    from vlsfr_tpu.parallel.mesh import make_mesh as j_make_mesh
    from vlsfr_tpu.parallel.sharded_quad import make_sharded_quad_loss as j_sharded

    case, ranks = world4
    (emb_x, emb_y, queue, g_a, g_b, plan_a, plan_b, labA, labB) = case
    kw = dict(loss_type=loss_type, margin=0.5, scale=24.0, hard_neg=5, tile=16)
    jq, jga, jgb = jnp.asarray(queue), jnp.asarray(g_a), jnp.asarray(g_b)
    jpa, jpb = tuple(map(jnp.asarray, plan_a)), tuple(map(jnp.asarray, plan_b))

    def single(ex, ey):
        return quad_add_margin(ex, ey, jq, jga, jgb, jpa, jpb, jnp.asarray(labA),
                               jnp.asarray(labB), use_pallas=False, **kw)

    mesh = j_make_mesh(1, 4, devices=jax.devices()[:4])
    fn = j_sharded(mesh, use_pallas=False, **kw)
    placed = place(mesh, case)

    def sharded(ex, ey):
        return fn(ex, ey, *placed[2:])

    refs = []
    for f, args in ((single, (jnp.asarray(emb_x), jnp.asarray(emb_y))),
                    (sharded, placed[:2])):
        la, lb = jax.jit(f)(*args)
        gx, gy = jax.jit(jax.grad(lambda ex, ey: sum(f(ex, ey)), argnums=(0, 1)))(*args)
        refs.append((float(la), float(lb), np.asarray(gx), np.asarray(gy)))
    for r in ranks:
        for la, lb, gx, gy in refs:
            assert float(r[f"{loss_type}/la"]) == pytest.approx(la, rel=1e-4)
            assert float(r[f"{loss_type}/lb"]) == pytest.approx(lb, rel=1e-4)
            np.testing.assert_allclose(r[f"{loss_type}/gx"], gx, atol=3e-5)
            np.testing.assert_allclose(r[f"{loss_type}/gy"], gy, atol=3e-5)
        for key in ("la", "lb", "acc", "gx", "gy"):  # every rank holds the same result
            np.testing.assert_array_equal(r[f"{loss_type}/{key}"],
                                          ranks[0][f"{loss_type}/{key}"])


@pytest.mark.parametrize("loss_type", INT8C_LOSS_TYPES)
def test_world4_int8c_composition_matches_jax(loss_type, world4):
    """The int8 queue with int8 compute over 4 gloo ranks against JAX's
    sharded head on its Pallas partial kernels (interpret mode, the 64-
    column tile the port's kernels use; each block holds 32 slots, one
    tile on both sides, so the backward rounds d_cos at the same points):
    losses rel 1e-4 and d_emb atol 3e-5, as the f32 case above."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from test_sharded_quad import place
    from vlsfr_tpu.ops.qqueue import quantize_rows
    from vlsfr_tpu.parallel.mesh import make_mesh as j_make_mesh
    from vlsfr_tpu.parallel.sharded_quad import make_sharded_quad_loss as j_sharded

    case, ranks = world4
    q_int, q_s = quantize_rows(jnp.asarray(case[2]))
    mesh = j_make_mesh(1, 4, devices=jax.devices()[:4])
    fn = j_sharded(mesh, loss_type=loss_type, margin=0.5, scale=24.0, hard_neg=5, tile=64,
                   use_pallas=True, interpret=True, int8_compute=True)
    placed = place(mesh, case)
    q_l = jax.device_put(q_int, NamedSharding(mesh, P(None, "model", None)))
    s_l = jax.device_put(q_s, NamedSharding(mesh, P(None, "model")))

    def sharded(ex, ey):
        return fn(ex, ey, q_l, *placed[3:], qscales=s_l)

    la, lb = jax.jit(sharded)(*placed[:2])
    gx, gy = jax.jit(jax.grad(lambda ex, ey: sum(sharded(ex, ey)), argnums=(0, 1)))(*placed[:2])
    key = f"int8c-{loss_type}"
    for r in ranks:
        assert float(r[f"{key}/la"]) == pytest.approx(float(la), rel=1e-4)
        assert float(r[f"{key}/lb"]) == pytest.approx(float(lb), rel=1e-4)
        np.testing.assert_allclose(r[f"{key}/gx"], np.asarray(gx), atol=3e-5)
        np.testing.assert_allclose(r[f"{key}/gy"], np.asarray(gy), atol=3e-5)
        for k in ("la", "lb", "acc", "gx", "gy"):  # every rank holds the same result
            np.testing.assert_array_equal(r[f"{key}/{k}"], ranks[0][f"{key}/{k}"])


@pytest.mark.parametrize("loss_type", LOSS_TYPES)
def test_world1_matches_single_device(loss_type, tmp_path):
    """The sharded head over a real group of one equals the single-device
    head (the same kernels' plain versions, one block, one merge)."""
    from test_sharded_quad import make_case

    case = make_case(np.random.default_rng(1))
    (emb_x, emb_y, queue, g_a, g_b, plan_a, plan_b, labA, labB) = [
        tuple(map(T, c)) if isinstance(c, tuple) else T(c) for c in case]
    res = []
    assert distributed.initialize("cpu", rank=0, world_size=1, store_path=str(tmp_path / "s"))
    try:
        fn = make_sharded_quad_loss(make_mesh(1, 1), loss_type=loss_type, with_acc=True,
                                    **LOSS_KW)
        for loss in (fn, lambda *a: ttm.quad_add_margin(*a, loss_type=loss_type, with_acc=True,
                                                        **LOSS_KW)):
            px, py = emb_x.clone().requires_grad_(True), emb_y.clone().requires_grad_(True)
            (la, lb), acc = loss(px, py, queue, g_a, g_b, plan_a, plan_b, labA, labB)
            (la + 2.0 * lb).backward()
            res.append((la.detach(), lb.detach(), acc, px.grad, py.grad))
    finally:
        distributed.destroy()
    for got, want in zip(*res):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)


# ----------------------------------------------------------------------
# the slice as a whole: the FFC step at mesh.model = 2
# ----------------------------------------------------------------------

B, Q, D, SIZE, STEPS = 8, 64, 16, 16, 3
OVERRIDES = ["model.net_type=toy", f"model.feat_dim={D}", f"pool.queue_size={Q}",
             "model.dtype=float32", "pool.momentum=0.9", "optim.lr=0.05", "loss.scale=32",
             "pool.hard_neg=4", "pool.use_fused=on", "pool.fuse_forward=true", "mesh.model=2",
             "mesh.data=1"]
METRICS = ("loss", "loss_dir_a", "loss_dir_b", "grad_norm", "lr", "train_acc", "pool_hit_rate",
           "outlier_frac")


def _trajectory_rank(rank, world, store, tmp):
    import copy

    from vlsfr_tpu_torch.core.dcp import DCPManager
    from vlsfr_tpu_torch.core.ffc import FFCState, make_train_step
    from vlsfr_tpu_torch.models import create_net
    from vlsfr_tpu_torch.optim import make_optimizer, make_schedule

    torch.set_num_threads(1)
    distributed.initialize("cpu", rank=rank, world_size=world, store_path=store)
    try:
        cfg = Config().apply_overrides(OVERRIDES)
        mesh = make_mesh(1, world)
        init = dict(np.load(os.path.join(tmp, "init.npz")))
        data = dict(np.load(os.path.join(tmp, "data.npz")))
        probe = create_net("toy", feat_dim=D)
        probe.load_state_dict({k[6:]: T(v) for k, v in init.items() if k.startswith("probe/")})
        c0, c_local = mesh.class_block(Q)
        state = FFCState(step=0, probe=probe,
                         gallery=copy.deepcopy(probe).requires_grad_(False),
                         queue=T(np.ascontiguousarray(init["queue"][:, c0:c0 + c_local])),
                         optimizer=make_optimizer(cfg.optim, probe.parameters()))
        step = make_train_step(cfg, make_schedule(cfg.optim, 10), mesh=mesh)
        dcp, out = DCPManager(Q), {}
        for s in range(STEPS):
            m = step(state, data[f"x{s}"], data[f"y{s}"],
                     dcp.plan_step(data[f"xl{s}"], data[f"yl{s}"]), 1.0)
            out.update({f"{s}/m/{k}": np.asarray(float(m[k])) for k in METRICS})
            out.update({f"{s}/p/{k}": v.numpy().copy() for k, v in probe.state_dict().items()})
            out[f"{s}/queue"] = state.queue.numpy().copy()
        np.savez(os.path.join(tmp, f"rank{rank}.npz"), **out)
    finally:
        distributed.destroy()


def test_model2_trajectory_matches_jax_sharded_step(tmp_path):
    import jax
    import jax.numpy as jnp

    from vlsfr_tpu.config import Config as JConfig
    from vlsfr_tpu.core.dcp import DCPManager as JDCP
    from vlsfr_tpu.core.ffc import create_ffc_state as j_create_state
    from vlsfr_tpu.core.ffc import make_train_step as j_make_step
    from vlsfr_tpu.models import create_net as j_create_net
    from vlsfr_tpu.optim import make_optimizer as j_make_optimizer
    from vlsfr_tpu.optim import make_schedule as j_make_schedule
    from vlsfr_tpu.parallel.mesh import batch_sharding, make_mesh as j_make_mesh
    from vlsfr_tpu.parallel.mesh import queue_sharding, replicated
    from vlsfr_tpu_torch.models import create_net
    from vlsfr_tpu_torch.models.from_jax import load_flax_variables, state_dict_from_flax

    jcfg = JConfig().apply_overrides(OVERRIDES)
    jmodel = j_create_net("toy", feat_dim=D)
    jopt = j_make_optimizer(jcfg.optim)
    jstate = j_create_state(jax.random.PRNGKey(0), jmodel, jcfg, jopt, SIZE)
    probe = load_flax_variables(create_net("toy", feat_dim=D), jax.device_get(jstate.probe_params),
                                jax.device_get(jstate.probe_stats))
    np.savez(tmp_path / "init.npz", queue=np.asarray(jstate.queue),
             **{f"probe/{k}": v.numpy() for k, v in probe.state_dict().items()})
    rng = np.random.default_rng(0)
    data = {}
    for s in range(STEPS):
        ids = rng.integers(0, 40, B // 2)
        data[f"xl{s}"] = np.concatenate([ids, rng.integers(0, 40, B // 2)])
        data[f"yl{s}"] = np.concatenate([ids, rng.integers(0, 40, B // 2)])
        data[f"x{s}"] = rng.standard_normal((B, SIZE, SIZE, 3)).astype(np.float32)
        data[f"y{s}"] = rng.standard_normal((B, SIZE, SIZE, 3)).astype(np.float32)
    np.savez(tmp_path / "data.npz", **data)
    _spawn(_trajectory_rank, 2, str(tmp_path / "store"), str(tmp_path))
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(2)]

    mesh = j_make_mesh(1, 2, devices=jax.devices()[:2])
    jstate = jax.tree.map(lambda x: jax.device_put(x, replicated(mesh)), jstate)
    jstate = jstate.replace(queue=jax.device_put(jstate.queue, queue_sharding(mesh)))
    jstep = jax.jit(j_make_step(jmodel, jcfg, jopt, j_make_schedule(jcfg.optim, 10), mesh=mesh))
    jdcp, bs = JDCP(Q), batch_sharding(mesh)
    for s in range(STEPS):
        jstate, jm = jstep(jstate, jax.device_put(jnp.asarray(data[f"x{s}"]), bs),
                           jax.device_put(jnp.asarray(data[f"y{s}"]), bs),
                           jdcp.plan_step(data[f"xl{s}"], data[f"yl{s}"]), 1.0)
        r0 = ranks[0]
        for k in METRICS[:5]:
            np.testing.assert_allclose(float(r0[f"{s}/m/{k}"]), float(jm[k]), rtol=1e-5,
                                       err_msg=f"{k}@{s}")
        for k in METRICS[5:]:
            assert float(r0[f"{s}/m/{k}"]) == pytest.approx(float(jm[k]), abs=1e-6), f"{k}@{s}"
        np.testing.assert_allclose(np.concatenate([r[f"{s}/queue"] for r in ranks], axis=1),
                                   np.asarray(jstate.queue), atol=1e-5, err_msg=f"queue@{s}")
        want = state_dict_from_flax(probe, jax.device_get(jstate.probe_params),
                                    jax.device_get(jstate.probe_stats))
        for k, v in want.items():
            np.testing.assert_allclose(r0[f"{s}/p/{k}"], v.numpy(), rtol=1e-5, atol=2e-5,
                                       err_msg=f"{k}@{s}")
            np.testing.assert_array_equal(ranks[1][f"{s}/p/{k}"], r0[f"{s}/p/{k}"])
        for k in METRICS:
            assert ranks[1][f"{s}/m/{k}"] == r0[f"{s}/m/{k}"]


def test_force_sharded_trainer_matches_single_device_cpu(tmp_path):
    """``pool.force_sharded`` in one process: the Trainer makes a group of
    one, runs the sharded head through it and destroys it on close; its
    steps equal the single-device Trainer's."""
    import torch.distributed as dist

    from vlsfr_tpu_torch.train.trainer import Trainer

    base = ["model.net_type=toy", "model.feat_dim=16", "pool.queue_size=200",
            "data.batch_size=8", "data.image_size=16", "data.synthetic_ids=30",
            "data.synthetic_images_per_id=3", "data.num_workers=2", "model.dtype=float32",
            "train.print_freq=1", "pool.use_fused=on", "pool.fuse_forward=true",
            "optim.lr=0.01"]
    runs = []
    for extra in ([], ["pool.force_sharded=true"]):
        cfg = Config().apply_overrides(base + extra)
        cfg.data.synthetic = True
        cfg.train.saved_dir = str(tmp_path)
        ttm.reset_launch_counts()
        trainer = Trainer(cfg, device="cpu")
        try:
            assert (trainer.mesh is not None) == bool(extra) == dist.is_initialized()
            out = trainer.train(max_steps=3)
            runs.append((out, trainer.state.queue.clone()))
        finally:
            trainer.close()
        assert not dist.is_initialized()
        assert not any(ttm.LAUNCH_COUNTS.values())
    (single, q1), (sharded, q2) = runs
    assert sharded["final_step"] == 3 and np.isfinite(sharded["loss"])
    assert sharded["loss"] == pytest.approx(single["loss"], rel=1e-6)
    assert torch.equal(q1, q2)


def test_cli_force_sharded_runs_in_one_process(tmp_path, capsys):
    import torch.distributed as dist

    from vlsfr_tpu_torch.train.cli import main

    main(["--device", "cpu", "--net_type", "toy", "--synthetic", "--batch_size", "8",
          "--feat_dim", "16", "--queue_size", "64", "--print_freq", "2", "--saved_dir",
          str(tmp_path), "--set", "data.image_size=16", "--set", "model.dtype=float32",
          "--set", "pool.use_fused=on", "--set", "pool.force_sharded=true", "--set",
          "data.synthetic_ids=12", "--set", "data.synthetic_images_per_id=2", "--set",
          "data.num_workers=1", "--set", "optim.epochs=1"])
    assert "training done:" in capsys.readouterr().out
    assert not dist.is_initialized()


def test_state_block_is_the_ranks_slice_of_the_queue():
    """``create_ffc_state`` on a mesh keeps the rank's block of the queue the
    single-device state draws from the same seed, bit for bit."""
    from vlsfr_tpu_torch.core.ffc import create_ffc_state
    from vlsfr_tpu_torch.models import create_net
    from vlsfr_tpu_torch.parallel.mesh import Mesh

    cfg = Config().apply_overrides(["pool.queue_size=64", "model.feat_dim=8"])
    whole = create_ffc_state(create_net("toy", feat_dim=8), cfg, device="cpu", seed=3).queue
    for rank in range(4):
        block = create_ffc_state(create_net("toy", feat_dim=8), cfg, device="cpu", seed=3,
                                 mesh=Mesh(model=4, rank=rank, group=None)).queue
        assert block.shape == (2, 16, 8)
        assert torch.equal(block, whole[:, rank * 16:(rank + 1) * 16])


def test_write_rows_into_a_block_matches_the_whole_queue():
    """Direction B's write on each block (last writer over the global plan)
    equals the write on the whole queue, sliced."""
    from vlsfr_tpu_torch.core.ffc import write_rows_

    rng = np.random.default_rng(3)
    queue = T(rng.standard_normal((2, 12, 3)).astype(np.float32))
    g = T(rng.standard_normal((6, 3)).astype(np.float32))
    rows = torch.tensor([0, 0, 1, 0, 1, 0], dtype=torch.int32)
    cols = torch.tensor([5, 5, 6, 0, 6, 11], dtype=torch.int32)  # duplicates across a boundary
    whole = write_rows_(queue.clone(), g, rows, cols)
    for c0 in (0, 4, 8):
        block = write_rows_(queue[:, c0:c0 + 4].clone(), g, rows, cols, c0)
        assert torch.equal(block, whole[:, c0:c0 + 4])
