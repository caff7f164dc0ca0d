"""The port's class-sharded softmax head (``vlsfr_tpu_torch/parallel/
sharded_margin.py``, ``sharded_fused.py``, ``sharded_sparse.py``) against
the JAX package's (``vlsfr_tpu/parallel/sharded_*.py``).

* The plain versions of the partial kernels against the Pallas partial
  kernels in interpret mode, on one block (rank 1 of 4, 40 columns: a
  ragged last tile of 16) with owned rows (one class twice), outlier rows
  (−1) and rows whose target another block owns (−2 in the port, −1 in
  JAX, which has no −2), for AM, Arc and SV at k = 1 and 3: the state
  m + log s and top-k 1e-5, m 1e-4 (JAX's running max); d_emb and d_w 3e-5,
  d_gt_raw 1e-5 (JAX's own tolerances for its partial kernels); and
  ``margin_ce_bwd_fused_sgd(pos_rows=)`` against
  ``pallas_margin_ce_bwd_fused_sgd(pos_rows=, interpret=True)`` on that
  block: d_emb, w′ and mom′ 3e-5 absolute + 1e-5 relative
  (``tests/test_fused_update.py``'s Pallas-leg tolerance).
* The three compositions over 4 spawned gloo ranks (a FileStore under the
  test's temp dir) against JAX's sharded heads on a 1×4 CPU mesh with
  ``use_pallas=False``: route B (``ShardedMarginSoftmax``, JAX's
  ``make_sharded_streaming_loss``; the loss 1e-4 relative, d_emb and each
  rank's d_w block 3e-5, JAX's ``test_sharded_margin.py`` tolerances), route
  A (``sharded_margin_grads_fused_sgd``, ``make_sharded_fused_sgd_head``;
  ``test_fused_update.py``'s tolerances) and route D
  (``sharded_sparse_margin_grads``, ``make_sharded_sparse_streaming_grads``
  with JAX's per-shard random fill fed to each rank; every output 3e-5,
  the row indices exactly, ``test_sharded_sparse.py``'s tolerance). Every
  rank's replicated outputs are bit-equal. Planted faults — the cotangents
  masked by the block-local label (JAX's sentinel lesson) on all three
  routes, and the cotangents all_reduced (JAX's ``shard_map`` psum) on
  route B — must fail the d_emb check that the real code passes.
* A world of one (a real group, in this process) against the single-device
  routes: equal.
* The slice as a whole: 3 steps of the toy net at ``mesh.model = 2`` over 2
  gloo ranks against JAX's ``make_softmax_train_step`` on a 1×2 mesh, for
  routes A, B (and B with gradient clipping) at 96 classes and D at 32768
  (16384 per rank: 8 of 32 tiles), with JAX's per-rank draws; the
  tolerances of ``tests/test_torch_softmax_head.py`` (losses 1e-5
  relative, classifier 2e-5 × max|w − w₀| on A and B and 4e-5 on D,
  momentum 1e-4 × max|mom|, last-visit exactly, backbone 1e-5 relative +
  2e-5 absolute), both ranks bit-equal; and A and D again at a bf16
  classifier (A with bf16 momentum) against JAX's sharded heads on their
  Pallas kernels in interpret mode: the first step's classifier to the
  element, then within bf16 noise (the test's docstring). Then the Trainer at
  ``mesh.model = 2`` on each rank picks route A by default, B with
  ``fused_update=off``, C with ``use_fused=off``, D with ``sparse_update``
  and E with ``sample_rate`` (routes C and E are held to JAX in
  ``tests/test_torch_dense_mesh.py``).

The spawned ranks import this module by name, so it imports nothing of JAX
at module level: every JAX import sits inside a test or fixture.
"""

import contextlib
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from vlsfr_tpu_torch.config import Config
from vlsfr_tpu_torch.ops import margin_stream as tms
from vlsfr_tpu_torch.parallel import distributed, sharded_fused, sharded_margin, sharded_sparse
from vlsfr_tpu_torch.parallel._shard_common import localize_labels
from vlsfr_tpu_torch.parallel.mesh import make_mesh
from vlsfr_tpu_torch.parallel.sharded_fused import sharded_margin_grads_fused_sgd
from vlsfr_tpu_torch.parallel.sharded_margin import ShardedMarginSoftmax
from vlsfr_tpu_torch.parallel.sharded_sparse import sharded_sparse_margin_grads

T = torch.from_numpy
SGD = dict(momentum=0.9, nesterov=True, weight_decay=1e-4)


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _spawn(fn, world, *args):
    mp.spawn(fn, args=(world, *args), nprocs=world, join=True)


# ----------------------------------------------------------------------
# one block's partial kernels against the Pallas partial kernels
# ----------------------------------------------------------------------

C_ALL, C0, C_LOCAL = 160, 40, 40  # this block is rank 1 of 4


def block_case(rng, b=8, d=16):
    """Rank 1's block and a batch: owned rows (rows 0 and 1 one class, row
    3 in the block's ragged last tile), outliers and rows of other blocks;
    gt the global target cosines (a fixed value on outlier rows)."""
    w = rng.standard_normal((C_ALL, d)).astype(np.float32)
    labels = rng.integers(0, C_ALL, b).astype(np.int32)
    labels[:5] = [C0 + 7, C0 + 7, 3, C0 + 37, 130]
    labels[5] = labels[6] = -1
    emb = _unit(rng.standard_normal((b, d)))
    wn = _unit(w)
    gt = np.where(labels >= 0, (emb * wn[np.maximum(labels, 0)]).sum(-1), 0.3).astype(np.float32)
    ll, owned = localize_labels(C0, C_LOCAL, T(labels))
    return emb, w[C0:C0 + C_LOCAL], labels, ll, owned.numpy(), gt


@pytest.mark.parametrize("loss_type,k", [("Arc", 1), ("Arc", 3), ("AM", 1), ("AM", 3), ("SV", 1),
                                         ("SV", 3)])
def test_partials_match_pallas_interpret(loss_type, k, rng):
    import jax.numpy as jnp

    from vlsfr_tpu.ops.margin_pallas import pallas_margin_partial_bwd, pallas_margin_partial_fwd

    emb, w_l, labels, ll, owned, gt = block_case(rng)
    assert {-2, -1} <= set(ll.tolist()) and (ll >= 0).sum() == 3
    jll = jnp.asarray(np.where(owned, ll.numpy(), -1))  # JAX's localization: -1 off the block
    kw = dict(loss_type=loss_type, margin=0.5, scale=32.0, k=k, mask_svfc=1.2)
    pk = dict(kw, normalize_w=True, tile=16, interpret=True)
    m, s, topk = tms.margin_partial_fwd_plain(T(emb), T(w_l), ll, T(gt), **kw)
    jm, js, jt = (np.asarray(x) for x in pallas_margin_partial_fwd(
        jnp.asarray(emb), jnp.asarray(w_l), jll, jnp.asarray(gt), **pk))
    np.testing.assert_allclose((m + torch.log(s)).numpy(), jm + np.log(js), atol=1e-5)
    np.testing.assert_allclose(m.numpy(), jm, atol=1e-4)
    np.testing.assert_allclose(topk.numpy(), jt, atol=1e-5)

    # the backward against GLOBAL row vectors, cotangents masked with the
    # global positive rows
    pos = labels >= 0
    logz = (m + torch.log(s)).numpy() + 1.0
    kth = topk[:, -1].numpy()
    cot = (rng.standard_normal((2, len(labels))) / len(labels)).astype(np.float32)
    d_ce, d_neg = np.where(pos, cot[0], 0.0), np.where(pos, 0.0, cot[1])
    f32 = lambda x: T(np.ascontiguousarray(x, np.float32))  # noqa: E731
    no_wl = torch.zeros(emb.shape)  # JAX's partial backward leaves the label rows' term out
    d_emb, d_w, d_gt = tms.margin_partial_bwd_plain(T(emb), T(w_l), ll, T(gt), f32(logz), f32(kth),
                                                    f32(d_ce), f32(d_neg), no_wl, **kw)
    je, jw, jg = (np.asarray(x) for x in pallas_margin_partial_bwd(
        jnp.asarray(emb), jnp.asarray(w_l), jll, jnp.asarray(gt), *(jnp.asarray(f32(x).numpy())
                                                                   for x in (logz, kth, d_ce,
                                                                             d_neg)), **pk))
    np.testing.assert_allclose(d_emb.numpy(), je, atol=3e-5)
    np.testing.assert_allclose(d_w.numpy(), jw, atol=3e-5)
    np.testing.assert_allclose(d_gt.numpy(), jg, atol=1e-5)
    assert not d_gt[~torch.from_numpy(owned)].any()


@pytest.mark.parametrize("loss_type", ["Arc", "AM", "SV"])
def test_fused_pos_rows_matches_pallas_interpret(loss_type, rng):
    import jax.numpy as jnp

    from vlsfr_tpu.ops.margin_pallas import pallas_margin_ce_bwd_fused_sgd

    emb, w_l, labels, ll, owned, gt = block_case(rng, d=32)
    mom = (0.1 * rng.standard_normal(w_l.shape)).astype(np.float32)
    kw = dict(loss_type=loss_type, margin=0.4, scale=24.0, k=3, mask_svfc=1.2)
    m, s, topk = tms.margin_partial_fwd_plain(T(emb), T(w_l), ll, T(gt), **kw)
    logz = m + torch.log(s) + 0.5
    pos = labels >= 0
    d_ce = np.full(len(labels), 1.0 / len(labels), np.float32)
    d_neg = np.full(len(labels), 0.3, np.float32)
    d_emb, w2, mom2 = tms.margin_ce_bwd_fused_sgd(
        T(emb), T(w_l).clone(), T(mom).clone(), ll, T(gt), logz, topk, T(d_ce), T(d_neg), 0.05,
        pos_rows=T(pos), **SGD, **kw)
    j = lambda x: jnp.asarray(np.asarray(x))  # noqa: E731
    je, jw, jm = (np.asarray(x) for x in pallas_margin_ce_bwd_fused_sgd(
        j(emb), j(w_l), j(mom), j(np.where(owned, ll.numpy(), -1)), j(gt), j(logz), j(topk),
        j(d_ce), j(d_neg), 0.05, pos_rows=j(pos), normalize_w=True, tile=16, interpret=True,
        **SGD, **kw))
    for name, got, want in (("d_emb", d_emb, je), ("w'", w2, jw), ("mom'", mom2, jm)):
        np.testing.assert_allclose(got.numpy(), want, atol=3e-5, rtol=1e-5, err_msg=name)


# ----------------------------------------------------------------------
# the compositions over 4 gloo ranks
# ----------------------------------------------------------------------

B4 = 8
ROUTE_CASES = {  # route: (classes, feature width); targets in every block, one class twice
    "B": (128, 16), "A": (64, 32), "D": (1024, 16)}
D_KEY_SEED, D_TILE, D_RATE = 5, 16, 0.2
B_KW = dict(margin=0.5, scale=24.0, hard_neg=5, mask_svfc=1.2)
A_KW = dict(margin=0.4, scale=24.0, hard_neg=3, mask_svfc=1.2)
D_KW = dict(margin=0.5, scale=24.0, hard_neg=1, mask_svfc=1.2)


def composition_cases(rng):
    """Per route: unit embeddings, a classifier (and momentum on A), labels
    with one class twice and a target in each of 4 blocks (outlier rows on
    A and B; JAX's route D drops an outlier's d_neg push, so D has none)."""
    cases = {}
    for route, (c, d) in ROUTE_CASES.items():
        cl = c // 4
        labels = rng.integers(0, c, B4).astype(np.int32)
        labels[:5] = [3, 3, cl + 2, 2 * cl + 5, 3 * cl + cl - 1]
        if route != "D":
            labels[5] = -1
            labels[rng.random(B4) < 0.25] = -1
        cases[route] = dict(emb=_unit(rng.standard_normal((B4, d))),
                            w=rng.standard_normal((c, d)).astype(np.float32),
                            mom=(0.1 * rng.standard_normal((c, d))).astype(np.float32),
                            labels=labels)
    return cases


def _fault_patches(fault):
    """(module, attribute, replacement) triples that plant ``fault``:
    ``local_mask`` masks the cotangents by the block-local label (every −2
    row loses its softmax gradient, as a sentinel −1 would), ``psum_cot``
    all_reduces route B's cotangents as JAX's ``shard_map`` transpose
    needed."""
    if fault is None:
        return []
    orig_pb = sharded_margin.margin_partial_bwd
    if fault == "psum_cot":
        def psum_bwd(emb, w, ll, gt, logz, kth, d_ce, d_neg, d_wl, **kw):
            d_ce, d_neg = d_ce.clone(), d_neg.clone()
            dist.all_reduce(d_ce)
            dist.all_reduce(d_neg)
            return orig_pb(emb, w, ll, gt, logz, kth, d_ce, d_neg, d_wl, **kw)
        return [(sharded_margin, "margin_partial_bwd", psum_bwd)]

    def local_bwd(emb, w, ll, gt, logz, kth, d_ce, d_neg, d_wl, **kw):
        return orig_pb(emb, w, ll, gt, logz, kth, torch.where(ll >= 0, d_ce, 0.0), d_neg, d_wl,
                       **kw)

    def drop_pos_rows(fn):
        return lambda *a, pos_rows, **kw: fn(*a, **kw)

    return [(sharded_margin, "margin_partial_bwd", local_bwd),
            (sharded_fused, "margin_ce_bwd_fused_sgd",
             drop_pos_rows(sharded_fused.margin_ce_bwd_fused_sgd)),
            (sharded_sparse, "margin_ce_bwd", drop_pos_rows(sharded_sparse.margin_ce_bwd)),
            (sharded_sparse, "margin_ce_bwd_sparse",
             drop_pos_rows(sharded_sparse.margin_ce_bwd_sparse))]


@contextlib.contextmanager
def planted(fault):
    patches = _fault_patches(fault)
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    for mod, name, fn in patches:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


FAULTS = {"B": (None, "local_mask", "psum_cot"), "A": (None, "local_mask"),
          "D": (None, "local_mask")}
LOSSES = {"B": ("Arc", "AM", "SV"), "A": ("Arc", "AM"), "D": ("Arc", "AM")}


def _run_route(route, lt, case, mesh, rank, u):
    """One route's outputs on this rank, as numpy."""
    c = case["w"].shape[0]
    c0, cl = mesh.class_block(c, "pool.num_classes")
    labels = T(case["labels"])
    pos = labels >= 0
    if route == "B":
        e = T(case["emb"]).clone().requires_grad_(True)
        w_l = T(case["w"][c0:c0 + cl]).clone().requires_grad_(True)
        ce, neg, _, _ = ShardedMarginSoftmax.apply(e, w_l, labels, lt, B_KW["margin"],
                                                   B_KW["scale"], B_KW["hard_neg"],
                                                   B_KW["mask_svfc"], mesh)
        loss = tms.reduce_margin_loss(ce, neg, labels)
        loss.backward()
        return dict(loss=loss.detach().numpy(), d_emb=e.grad.numpy(), d_w=w_l.grad.numpy())
    d_ce = torch.where(pos, 1.0 / B4, 0.0)
    d_neg = torch.zeros(B4)
    if route == "A":
        out = sharded_margin_grads_fused_sgd(
            T(case["emb"]), T(case["w"][c0:c0 + cl]).clone(), T(case["mom"][c0:c0 + cl]).clone(),
            labels, d_ce, d_neg, 0.05, mesh=mesh, loss_type=lt, **SGD, **A_KW)
        names = ("ce", "neg", "topk", "gt", "d_emb", "w", "mom")
    else:
        out = sharded_sparse_margin_grads(
            T(case["emb"]), T(case["w"][c0:c0 + cl]), labels, d_ce, d_neg, mesh=mesh,
            m_tiles=tms.sparse_m_tiles(D_RATE, cl // D_TILE, B4), loss_type=lt, tile=D_TILE,
            u=T(u), **D_KW)
        names = ("ce", "neg", "topk", "gt", "d_emb", "row_idx", "d_w_rows")
    return {n: x.numpy() for n, x in zip(names, out)}


def _world4_rank(rank, world, store, case_path, out_dir):
    torch.set_num_threads(1)
    distributed.initialize("cpu", rank=rank, world_size=world, store_path=store)
    try:
        mesh = make_mesh(1, world)
        data = dict(np.load(case_path))
        out = {}
        for route, faults in FAULTS.items():
            case = {k: data[f"{route}/{k}"] for k in ("emb", "w", "mom", "labels")}
            for fault in faults:
                for lt in LOSSES[route] if fault is None else LOSSES[route][:1]:
                    with planted(fault):
                        res = _run_route(route, lt, case, mesh, rank, data.get(f"D/u{rank}"))
                    out.update({f"{route}/{lt}/{fault}/{k}": v for k, v in res.items()})
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        distributed.destroy()


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    """The cases, JAX's per-shard draws of route D, and every rank's
    outputs of the three routes (real and planted) from one spawn of 4
    gloo ranks."""
    import jax

    tmp = tmp_path_factory.mktemp("world4")
    cases = composition_cases(np.random.default_rng(0))
    flat = {f"{r}/{k}": v for r, case in cases.items() for k, v in case.items()}
    n_local = ROUTE_CASES["D"][0] // 4 // D_TILE
    key = jax.random.PRNGKey(D_KEY_SEED)
    for r in range(4):  # the per-shard fill of sharded_sparse.py:156
        flat[f"D/u{r}"] = np.asarray(jax.random.uniform(jax.random.fold_in(key, r), (n_local,)))
    path = str(tmp / "case.npz")
    np.savez(path, **flat)
    _spawn(_world4_rank, 4, str(tmp / "store"), path, str(tmp))
    return cases, [dict(np.load(tmp / f"rank{r}.npz")) for r in range(4)]


@pytest.fixture(scope="module")
def jax_heads(world4):
    """JAX's sharded heads on a 1×4 CPU mesh, on the same cases: {(route,
    loss type): outputs}."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from vlsfr_tpu.parallel.mesh import make_mesh as j_make_mesh
    from vlsfr_tpu.parallel.sharded_fused import make_sharded_fused_sgd_head
    from vlsfr_tpu.parallel.sharded_margin import make_sharded_streaming_loss
    from vlsfr_tpu.parallel.sharded_sparse import make_sharded_sparse_streaming_grads

    cases, _ = world4
    mesh = j_make_mesh(1, 4, devices=jax.devices()[:4])
    def put(x, *spec):
        return jax.device_put(jnp.asarray(x), NamedSharding(mesh, P(*spec)))

    out = {}
    for lt in LOSSES["B"]:
        c = cases["B"]
        fn = make_sharded_streaming_loss(mesh, loss_type=lt, tile=16, use_pallas=False, **B_KW)
        e, w = put(c["emb"], "data", None), put(c["w"], "model", None)
        lab = put(c["labels"], "data")
        (loss, _), (ge, gw) = jax.jit(jax.value_and_grad(lambda a, b_: fn(a, b_, lab),
                                                         argnums=(0, 1), has_aux=True))(e, w)
        out[("B", lt)] = dict(loss=np.asarray(loss), d_emb=np.asarray(ge), d_w=np.asarray(gw))
    for lt in LOSSES["A"]:
        c = cases["A"]
        head = make_sharded_fused_sgd_head(mesh, loss_type=lt, normalize_w=True, tile=16,
                                           use_pallas=False, **SGD, **A_KW)
        res = head(jnp.asarray(c["emb"]), jnp.asarray(c["w"]), jnp.asarray(c["mom"]),
                   jnp.asarray(c["labels"]), 0.05)
        out[("A", lt)] = {n: np.asarray(x) for n, x in zip(
            ("ce", "neg", "topk", "gt", "d_emb", "w", "mom"), res)}
    for lt in LOSSES["D"]:
        c = cases["D"]
        cls, d = c["w"].shape
        fn = make_sharded_sparse_streaming_grads(
            mesh, batch=B4, feat_dim=d, num_classes=cls, sparse_grad_rate=D_RATE, loss_type=lt,
            tile=D_TILE, use_pallas=False, **{k: v for k, v in D_KW.items() if k != "hard_neg"})
        d_ce = np.full(B4, 1.0 / B4, np.float32)
        res = jax.jit(fn)(put(c["emb"], "data", None), put(c["w"], "model", None),
                          put(c["labels"], "data"), put(d_ce, "data"),
                          put(np.zeros(B4, np.float32), "data"), jax.random.PRNGKey(D_KEY_SEED))
        out[("D", lt)] = {n: np.asarray(x) for n, x in zip(
            ("ce", "neg", "topk", "gt", "d_emb", "row_idx", "d_w_rows"), res)}
    return out


# per route: the outputs held to JAX, each (name, replicated, atol, rtol)
CHECKS = {
    "B": (("loss", True, 0.0, 1e-4), ("d_emb", True, 3e-5, 0.0), ("d_w", False, 3e-5, 0.0)),
    "A": (("ce", True, 1e-5, 0.0), ("topk", True, 1e-6, 0.0), ("d_emb", True, 2e-5, 1e-5),
          ("w", False, 2e-6, 1e-5), ("mom", False, 2e-5, 1e-5)),
    "D": (("ce", True, 3e-5, 0.0), ("neg", True, 3e-5, 0.0), ("topk", True, 3e-5, 0.0),
          ("gt", True, 3e-5, 0.0), ("d_emb", True, 3e-5, 0.0), ("row_idx", False, 0.0, 0.0),
          ("d_w_rows", False, 3e-5, 0.0)),
}


def _block(x, rank, world=4):
    n = x.shape[0] // world
    return x[rank * n:(rank + 1) * n]


def _held_to_jax(route, lt, rank_out, want, rank, fault=None):
    """The failures of one rank's outputs against JAX's (empty: it holds)."""
    bad = []
    for name, replicated, atol, rtol in CHECKS[route]:
        got = rank_out[f"{route}/{lt}/{fault}/{name}"]
        ref = want[name] if replicated else _block(want[name], rank)
        if not np.allclose(got, ref, atol=atol, rtol=rtol):
            bad.append(f"{name}: max |diff| {np.abs(got - ref).max():.3e}")
    return bad


@pytest.mark.parametrize("route,loss_type", [(r, lt) for r in ("B", "A", "D") for lt in LOSSES[r]])
def test_world4_composition_matches_jax(route, loss_type, world4, jax_heads):
    cases, ranks = world4
    want = jax_heads[(route, loss_type)]
    if route == "A":  # gt on outlier rows is junk on both sides (JAX's test_fused_update.py)
        pos = cases["A"]["labels"] >= 0
        for r, out in enumerate(ranks):
            np.testing.assert_allclose(out[f"A/{loss_type}/None/gt"][pos], want["gt"][pos],
                                       atol=1e-6)
    for r, out in enumerate(ranks):
        assert _held_to_jax(route, loss_type, out, want, r) == [], f"rank {r}"
        for name, replicated, _, _ in CHECKS[route]:  # the ranks agree bit for bit
            if replicated:
                key = f"{route}/{loss_type}/None/{name}"
                np.testing.assert_array_equal(out[key], ranks[0][key])


@pytest.mark.parametrize("route,fault", [("B", "local_mask"), ("B", "psum_cot"),
                                         ("A", "local_mask"), ("D", "local_mask")])
def test_world4_planted_faults_fail(route, fault, world4, jax_heads):
    """Hazard 1 (cotangents masked by the block-local label) and hazard 3
    (cotangents all_reduced): the check of d_emb against JAX fails on
    every rank, where the real code passes it."""
    _, ranks = world4
    lt = LOSSES[route][0]
    for r, out in enumerate(ranks):
        bad = _held_to_jax(route, lt, out, jax_heads[(route, lt)], r, fault=fault)
        assert any(b.startswith("d_emb") for b in bad), (r, bad)


# ----------------------------------------------------------------------
# a world of one against the single-device routes
# ----------------------------------------------------------------------


@pytest.mark.parametrize("route", ["A", "B", "D"])
def test_world1_matches_single_device(route, tmp_path):
    """Over a real group of one the sharded routes are the single-device
    routes: one block, merges of one state. Equal to the bit on the CPU."""
    from vlsfr_tpu_torch.parallel.partial_fc import margin_softmax_loss

    case = composition_cases(np.random.default_rng(1))[route]
    emb, w, labels = T(case["emb"]), T(case["w"]), T(case["labels"])
    b, c = emb.shape[0], w.shape[0]
    d_ce, d_neg = torch.where(labels >= 0, 1.0 / b, 0.0), torch.zeros(b)
    kw = dict(loss_type="Arc", margin=0.5, scale=32.0, mask_svfc=1.2)
    assert distributed.initialize("cpu", rank=0, world_size=1, store_path=str(tmp_path / "s"))
    try:
        mesh = make_mesh(1, 1)
        res = []
        for m in (None, mesh):
            if route == "B":
                e, ww = emb.clone().requires_grad_(True), w.clone().requires_grad_(True)
                loss, metrics = margin_softmax_loss(e, ww, labels, streaming=True, mesh=m, **kw)
                loss.backward()
                res.append((loss.detach(), metrics["train_acc"], e.grad, ww.grad))
            elif route == "A":
                fn = (tms.streaming_margin_grads_fused_sgd if m is None else
                      lambda *a, **k: sharded_margin_grads_fused_sgd(*a, mesh=mesh, **k))
                res.append(fn(emb, w.clone(), T(case["mom"]).clone(), labels, d_ce, d_neg, 0.05,
                              hard_neg=3, **SGD, **kw))
            else:
                fn = (tms.streaming_sparse_margin_grads if m is None else
                      lambda *a, **k: sharded_sparse_margin_grads(*a, mesh=mesh, **k))
                res.append(fn(emb, w, labels, d_ce, d_neg, m_tiles=8, tile=16,
                              u=T(np.random.default_rng(2).random(c // 16, np.float32)), **kw))
    finally:
        distributed.destroy()
    if route != "B":  # gt on outlier rows: the gather of row 0 alone, 0 on the mesh (unused)
        pos = labels >= 0
        res = [(*r[:3], r[3][pos], *r[4:]) for r in res]
    for got, want in zip(*res):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


# ----------------------------------------------------------------------
# the slice as a whole: the softmax step at mesh.model = 2
# ----------------------------------------------------------------------

B, D, SIZE, STEPS = 8, 32, 32, 3
TRAJ_BASE = ["model.net_type=toy", f"model.feat_dim={D}", "model.dtype=float32",
             f"data.batch_size={B}", "pool.head=full_softmax", "optim.lr=0.05",
             "pool.use_fused=on", "mesh.model=2", "mesh.data=1"]
TRAJ_ROUTES = {  # route: (classes, overrides)
    "A": (96, ["pool.fused_update=auto"]),
    "B": (96, ["pool.fused_update=off"]),
    "B-clip": (96, ["pool.fused_update=off", "optim.grad_clip=0.5"]),
    "D": (32768, ["pool.sparse_update=true", "pool.sparse_grad_rate=0.25"]),
    "A-bf16": (96, ["pool.fused_update=auto", "pool.classifier_dtype=bfloat16",
                    "pool.classifier_mom_dtype=bfloat16"]),
    "D-bf16": (32768, ["pool.sparse_update=true", "pool.sparse_grad_rate=0.25",
                       "pool.classifier_dtype=bfloat16"]),
}
BF16_NOISE = 2.0**-4  # as tests/test_torch_softmax_head.py's bf16 trajectories
TRAINER_ROUTES = {"A": [], "B": ["pool.fused_update=off"], "C": ["pool.use_fused=off"],
                  "D": ["pool.sparse_update=true"],
                  "E": ["pool.sample_rate=0.5", "pool.sparse_update=true"],
                  "E-dense": ["pool.sample_rate=0.5"]}


def _traj_cfg(route):
    c, extra = TRAJ_ROUTES[route]
    return TRAJ_BASE + extra + [f"pool.num_classes={c}"]


def _trajectory_rank(rank, world, store, tmp):
    from vlsfr_tpu_torch.models import create_net
    from vlsfr_tpu_torch.optim import make_schedule
    from vlsfr_tpu_torch.train import softmax_head
    from vlsfr_tpu_torch.train.softmax_head import create_softmax_state, make_softmax_train_step
    from vlsfr_tpu_torch.train.trainer import Trainer

    torch.set_num_threads(1)
    distributed.initialize("cpu", rank=rank, world_size=world, store_path=store)
    try:
        mesh = make_mesh(1, world)
        data = dict(np.load(os.path.join(tmp, "data.npz")))
        own_draws = softmax_head.tile_fill_draws
        softmax_head.tile_fill_draws = (  # JAX's draws for (step, rank)
            lambda step, n, device, rank=None: T(data[f"u{step}/{rank}"]).to(device))
        out = {}
        for route in TRAJ_ROUTES:
            init = dict(np.load(os.path.join(tmp, f"init_{route}.npz")))
            cfg = Config().apply_overrides(_traj_cfg(route))
            backbone = create_net("toy", feat_dim=D)
            backbone.load_state_dict({k[9:]: T(v) for k, v in init.items()
                                      if k.startswith("backbone/")})
            state = create_softmax_state(
                backbone, cfg, cfg.pool.num_classes, device="cpu", mesh=mesh,
                classifier=T(init["classifier"]).to(softmax_head.DTYPES[cfg.pool.classifier_dtype]))
            step = make_softmax_train_step(cfg, make_schedule(cfg.optim, 100), mesh=mesh)
            for s in range(STEPS):
                m = step(state, data["images"], data[f"labels_{cfg.pool.num_classes}"], 1.0)
                out.update({f"{route}/{s}/{k}": np.asarray(float(v)) for k, v in m.items()})
                if s == 0:  # the first step's block, for the bf16 routes' exact check
                    out[f"{route}/classifier1"] = state.classifier.detach().float().numpy().copy()
            out[f"{route}/classifier"] = state.classifier.detach().float().numpy().copy()
            for name in ("classifier_mom", "classifier_last"):
                if getattr(state, name) is not None:
                    x = getattr(state, name)
                    out[f"{route}/{name}"] = (x.float() if x.is_floating_point() else x).numpy().copy()
            out.update({f"{route}/p/{k}": v.numpy().copy()
                        for k, v in state.backbone.state_dict().items()})
        softmax_head.tile_fill_draws = own_draws
        for route, extra in TRAINER_ROUTES.items():  # the Trainer's routing at mesh.model = 2
            cfg = Config().apply_overrides(
                ["model.net_type=toy", "model.feat_dim=16", "data.batch_size=8",
                 "data.image_size=16", "data.synthetic_ids=30", "data.synthetic_images_per_id=3",
                 "data.num_workers=1", "model.dtype=float32", "train.print_freq=1",
                 "pool.head=full_softmax", "pool.use_fused=on", "optim.lr=0.01", "mesh.model=2",
                 "mesh.data=1", *extra])
            cfg.data.synthetic = True
            cfg.train.saved_dir = os.path.join(tmp, f"trainer{rank}")
            trainer = Trainer(cfg, device="cpu")
            try:
                res = trainer.train(max_steps=2)
                st = trainer.state
                out[f"trainer/{route}/loss"] = np.asarray(res["loss"])
                out[f"trainer/{route}/rows"] = np.asarray(st.classifier.shape[0])
                sampled = "sampled_classes" in res
                out[f"trainer/{route}/route"] = np.asarray(
                    ("E" if st.classifier_last is not None else "E-dense") if sampled else
                    "D" if st.classifier_last is not None else
                    ("B" if cfg.pool.use_fused == "on" else "C") if st.classifier.requires_grad
                    else "A")
            finally:
                trainer.close()
        np.savez(os.path.join(tmp, f"rank{rank}.npz"), **out)
    finally:
        distributed.destroy()


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """JAX's initial states (backbone, classifier) per route, the batch and
    JAX's per-rank route-D draws, and both ranks' trajectories and Trainer
    runs from one spawn of 2 gloo ranks."""
    import jax

    from vlsfr_tpu.config import Config as JConfig
    from vlsfr_tpu.models import create_net as j_create_net
    from vlsfr_tpu.optim import make_optimizer as j_make_optimizer
    from vlsfr_tpu.train.softmax_head import create_softmax_state as j_create_state
    from vlsfr_tpu_torch.models import create_net
    from vlsfr_tpu_torch.models.from_jax import load_flax_variables
    from vlsfr_tpu_torch.ops.margin_stream import sparse_bwd_geometry

    import jax.numpy as jnp

    tmp = tmp_path_factory.mktemp("world2")
    rng = np.random.default_rng(0)
    data = {"images": rng.standard_normal((B, SIZE, SIZE, 3)).astype(np.float32)}
    for c in sorted({c for c, _ in TRAJ_ROUTES.values()}):  # one batch per class count
        labels = rng.integers(0, c, B).astype(np.int32)
        labels[1] = labels[0]  # a repeated class
        labels[-2:] = c // 2 - 1, c // 2  # the two blocks' edges
        data[f"labels_{c}"] = labels
    jstates = {}
    for route, (c, _) in TRAJ_ROUTES.items():
        jcfg = JConfig().apply_overrides(_traj_cfg(route))
        jmodel = j_create_net("toy", feat_dim=D)
        jstate = j_create_state(jax.random.PRNGKey(0), jmodel, jcfg,
                                j_make_optimizer(jcfg.optim), SIZE, c)
        jstates[route] = (jcfg, jmodel, jstate)
        backbone = load_flax_variables(create_net("toy", feat_dim=D),
                                       jax.device_get(jstate.params["backbone"]),
                                       jax.device_get(jstate.batch_stats))
        np.savez(tmp / f"init_{route}.npz",
                 classifier=np.asarray(jstate.params["classifier"].astype(jnp.float32)),
                 **{f"backbone/{k}": v.numpy() for k, v in backbone.state_dict().items()})
    _, n_tiles = sparse_bwd_geometry(B, D, TRAJ_ROUTES["D"][0] // 2)
    for s in range(STEPS):  # sharded_sparse.py:156 folds the model index into the step's key
        key = jax.random.fold_in(jax.random.PRNGKey(23), s)
        for r in range(2):
            data[f"u{s}/{r}"] = np.asarray(jax.random.uniform(jax.random.fold_in(key, r),
                                                              (n_tiles,)))
    np.savez(tmp / "data.npz", **data)
    _spawn(_trajectory_rank, 2, str(tmp / "store"), str(tmp))
    return data, jstates, [dict(np.load(tmp / f"rank{r}.npz")) for r in range(2)]


@pytest.mark.parametrize("route", list(TRAJ_ROUTES))
def test_model2_trajectory_matches_jax_sharded_step(route, world2, monkeypatch):
    """At a bf16 classifier (A-bf16 with bf16 momentum, D-bf16) JAX's
    sharded heads run their Pallas kernels in interpret mode (its CPU
    fallbacks do not round as the kernels do); the first step's classifier
    blocks are held to JAX's by ``parity.bf16_ulps`` and the next steps
    within bf16 noise, as tests/test_torch_softmax_head.py's bf16
    trajectories (losses 1e-3 relative after the first step, classifier
    BF16_NOISE × max|w − w₀|, momentum BF16_NOISE × max|mom|, backbone 1e-5
    relative + 1e-2 absolute)."""
    import jax
    import jax.numpy as jnp

    from vlsfr_tpu.optim import make_optimizer as j_make_optimizer
    from vlsfr_tpu.optim import make_schedule as j_make_schedule
    from vlsfr_tpu.parallel.mesh import (
        class_vector_sharding,
        classifier_sharding,
        make_mesh as j_make_mesh,
        replicated,
    )
    from vlsfr_tpu.train.softmax_head import make_softmax_train_step as j_make_step
    from vlsfr_tpu_torch.models import create_net
    from vlsfr_tpu_torch.models.from_jax import state_dict_from_flax

    from vlsfr_tpu_torch.utils import parity

    bf16 = route.endswith("-bf16")
    if bf16:
        from vlsfr_tpu.parallel import sharded_fused as jsf
        from vlsfr_tpu.parallel import sharded_sparse as jss

        for mod, name in ((jsf, "make_sharded_fused_sgd_head"),
                          (jss, "make_sharded_sparse_streaming_grads")):
            fn = getattr(mod, name)
            monkeypatch.setattr(mod, name,
                                lambda *a, _fn=fn, **k: _fn(*a, use_pallas=True, interpret=True, **k))
    f32 = lambda x: np.array(jnp.asarray(x).astype(jnp.float32))  # noqa: E731
    data, jstates, ranks = world2
    jcfg, jmodel, jstate = jstates[route]
    mesh = j_make_mesh(1, 2, devices=jax.devices()[:2])
    jstate = jax.tree.map(lambda x: jax.device_put(x, replicated(mesh)), jstate)
    opt = dict(jstate.opt_state) if isinstance(jstate.opt_state, dict) else None
    if opt is not None:  # the classifier's own state rides beside it, sharded by class
        opt["classifier_mom"] = jax.device_put(opt["classifier_mom"], classifier_sharding(mesh))
        if "classifier_last" in opt:
            opt["classifier_last"] = jax.device_put(opt["classifier_last"],
                                                    class_vector_sharding(mesh))
        jstate = jstate.replace(opt_state=opt)
    jstate = jstate.replace(params=dict(jstate.params, classifier=jax.device_put(
        jstate.params["classifier"], classifier_sharding(mesh))))
    w0 = f32(jstate.params["classifier"]).copy()
    jstep = jax.jit(j_make_step(jmodel, jcfg, j_make_optimizer(jcfg.optim),
                                j_make_schedule(jcfg.optim, 100), mesh=mesh))
    images = jnp.asarray(data["images"])
    labels = jnp.asarray(data[f"labels_{TRAJ_ROUTES[route][0]}"])
    r0, r1 = ranks
    for s in range(STEPS):
        jstate, jm = jstep(jstate, images, labels, 1.0)
        for k in ("loss", "ce", "lr"):
            np.testing.assert_allclose(float(r0[f"{route}/{s}/{k}"]), float(jm[k]),
                                       rtol=1e-3 if bf16 and s else 1e-5, err_msg=f"{k}@{s}")
        if bf16 and s == 0:
            got = torch.from_numpy(np.concatenate([r[f"{route}/classifier1"] for r in ranks]))
            checks = parity.bf16_ulps("w'", got.bfloat16(),
                                      torch.from_numpy(f32(jstate.params["classifier"])).bfloat16(),
                                      torch.from_numpy(w0).bfloat16())
            assert not parity.failures(checks), [parity.describe(c) for c in checks]
        if "train_acc" in jm:
            assert float(r0[f"{route}/{s}/train_acc"]) == pytest.approx(float(jm["train_acc"]),
                                                                       abs=1e-6)
        if route.startswith("D"):
            assert int(r0[f"{route}/{s}/grad_rows"]) == int(jm["grad_rows"]) == 2 * 8 * 512
    if route == "B-clip":  # the clip binds: the trajectory leaves route B's
        assert r0["B-clip/2/loss"] != r0["B/2/loss"]
    jw = f32(jstate.params["classifier"])
    w_tol = (BF16_NOISE if bf16 else 4e-5 if route == "D" else 2e-5) * np.abs(jw - w0).max()
    np.testing.assert_allclose(np.concatenate([r[f"{route}/classifier"] for r in ranks]), jw,
                               atol=w_tol)
    if route[0] in "AD":
        jmom = f32(jstate.opt_state["classifier_mom"])
        np.testing.assert_allclose(np.concatenate([r[f"{route}/classifier_mom"] for r in ranks]),
                                   jmom, atol=(BF16_NOISE if bf16 else 1e-4) * np.abs(jmom).max())
    if route.startswith("D"):
        np.testing.assert_array_equal(
            np.concatenate([r[f"{route}/classifier_last"] for r in ranks]),
            np.asarray(jstate.opt_state["classifier_last"]))
        moved = (np.abs(jw - w0).max(axis=1) > 0).sum()
        assert 0 < moved < jw.shape[0]  # only the selected rows moved
    want = state_dict_from_flax(create_net("toy", feat_dim=D),
                                jax.device_get(jstate.params["backbone"]),
                                jax.device_get(jstate.batch_stats))
    for k, v in want.items():
        np.testing.assert_allclose(r0[f"{route}/p/{k}"], v.numpy(), rtol=1e-5,
                                   atol=1e-2 if bf16 else 2e-5, err_msg=k)
        np.testing.assert_array_equal(r1[f"{route}/p/{k}"], r0[f"{route}/p/{k}"])
    for key in r0:
        if key.startswith(f"{route}/") and key[len(route) + 1].isdigit():
            assert r1[key] == r0[key], key


@pytest.mark.parametrize("route", list(TRAINER_ROUTES))
def test_trainer_routes_at_model2(route, world2):
    """The Trainer at ``mesh.model = 2`` (a group of 2 gloo ranks): route A
    by default, B with ``pool.fused_update=off``, C with
    ``pool.use_fused=off``, D with ``pool.sparse_update``, E with
    ``pool.sample_rate`` (sparse rows, or the dense optimizer); each rank
    holds half the classifier and both log the same finite loss."""
    ranks = world2[2]
    for r in ranks:
        assert str(r[f"trainer/{route}/route"]) == route
        assert int(r[f"trainer/{route}/rows"]) == 15  # 30 synthetic classes over 2 ranks
        assert np.isfinite(r[f"trainer/{route}/loss"])
    assert ranks[0][f"trainer/{route}/loss"] == ranks[1][f"trainer/{route}/loss"]


@pytest.mark.parametrize("bad", [["optim.optim=RMSprop"]])
def test_trainer_refuses_unported_at_model2(bad, tmp_path):
    """RMSprop raises "not ported yet" before any process group exists
    (routes C and E run on a mesh: tests/test_torch_dense_mesh.py; the data
    axis: tests/test_torch_softmax_data_axis.py)."""
    from vlsfr_tpu_torch.train.trainer import Trainer

    cfg = Config().apply_overrides(["model.net_type=toy", "pool.head=full_softmax",
                                    "pool.num_classes=96", "mesh.model=2", *bad])
    cfg.train.saved_dir = str(tmp_path)
    with pytest.raises(NotImplementedError, match="not ported yet"):
        Trainer(cfg, device="cpu")
    assert not dist.is_initialized()
