"""The dense heads on the model axis (``vlsfr_tpu_torch/parallel/
sharded_dense.py``): the dense FFC head (``core/ffc.make_sharded_dense_loss``)
and the softmax head's routes C (``partial_fc.margin_softmax_loss`` with a
mesh) and E (``partial_fc.sharded_sampled_loss``) with the class axis split
over the ranks, against the JAX package's GSPMD-sharded steps on a CPU mesh.

* The per-block pieces in one process: 4 emulated blocks
  (``block_stats`` / ``merge_stats`` / ``finalize`` / ``block_grad``)
  against JAX's ``add_margin`` and its gradient on the whole row, for Arc,
  AM and SV (loss 1e-5 relative, the cosines' gradient 1e-5 absolute +
  1e-5 relative: XLA's and torch's f32 exp of logits up to scale·1.2 ≈ 29
  differ by an ulp, which p carries as ~1e-6 relative), on a row whose
  third-largest cosine ties across two blocks, and the single-device
  ``ops/margin.add_margin``'s gradient there alike; the merged
  top-k ids against ``lax.top_k``'s and the merged top-1 against
  ``jnp.argmax`` on rows full of ties, exactly.
* The three compositions over 4 spawned gloo ranks against JAX's step on a
  1×4 CPU mesh with the queue placed by ``queue_sharding`` and the
  classifier by ``classifier_sharding``: the dense FFC head (JAX's dense
  ``directional_loss``, both directions) for Arc, AM and SV; route C
  (``margin_softmax_loss`` with the mesh, then the optax chain) for Arc,
  AM and SV; route E with the sparse row update (Arc, SV) and with the
  dense optimizer (AM). Limits of
  ``test_torch_sharded_softmax.py::test_world4_composition_matches_jax``:
  the loss 1e-4 relative (route B's), d_emb 3e-5 (B's), the classifier
  2e-6 + 1e-5 relative and its momentum 2e-5 + 1e-5 relative (route A's);
  exactly: train_acc, the queue block after the write and the last-visit
  block. Each case has an outlier row or a target row whose top-k or argmax
  ties across two blocks, so the tie order shows. The ranks are bit-equal
  on every replicated output. Two planted faults, each on all three
  compositions, must fail those checks on every rank: the merge breaking
  ties to the highest id, and every block dropping its first column.
* A world of one (a real group, in this process) against the
  single-device heads: within 1e-5 relative + 1e-6 absolute.
* The slice as a whole over 2 spawned gloo ranks: 3 steps of the toy net at
  ``mesh.model = 2`` against JAX's ``make_train_step`` /
  ``make_softmax_train_step`` on a 1×2 mesh, for the dense FFC head at an
  f32 and a bf16 queue, route C at an f32 and a bf16 classifier, and route
  E with the sparse and the dense update (JAX's draws fed to both);
  ``test_torch_sharded_quad.py``'s and ``test_torch_sharded_softmax.py``'s
  limits, the ranks bit-equal. Then the Trainer at ``mesh.model = 2`` on the
  dense FFC head; ghost classes (``pool.num_classes = 97`` pads to 98, as
  JAX's Trainer pads it, the blocks are the slices of the whole draw, and
  given JAX's init at 98 the slices of it, bit for bit); route E's draws
  the same on every rank.

The spawned ranks import this module by name, so it imports nothing of JAX
at module level: every JAX import sits inside a test or fixture.
"""

import contextlib
import inspect
import os

import numpy as np
import pytest
import torch

from torch_worlds import once, spawn

from vlsfr_tpu_torch.config import Config
from vlsfr_tpu_torch.core.ffc import make_sharded_dense_loss, write_rows_
from vlsfr_tpu_torch.ops.margin import add_margin as port_add_margin
from vlsfr_tpu_torch.ops.margin import top_k_low_ids
from vlsfr_tpu_torch.optim.optimizers import sgd_leaf_
from vlsfr_tpu_torch.parallel import distributed, sharded_dense
from vlsfr_tpu_torch.parallel._shard_common import merge_logsumexp
from vlsfr_tpu_torch.parallel.mesh import make_mesh
from vlsfr_tpu_torch.parallel.partial_fc import margin_softmax_loss, sharded_sampled_loss
from vlsfr_tpu_torch.train.sparse_classifier import sparse_sgd_rows

T = torch.from_numpy
SGD = dict(momentum=0.9, nesterov=True, weight_decay=1e-4)
LR = 0.05
KW = dict(margin=0.5, scale=24.0, mask_svfc=1.2)


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _rows_with_first(rng, n, d, first):
    """n unit rows whose first component is ``first`` [n]."""
    rest = _unit(rng.standard_normal((n, d - 1)))
    return np.concatenate([first[:, None], rest * np.sqrt(1 - first**2)[:, None]],
                          axis=1).astype(np.float32)


# ----------------------------------------------------------------------
# the per-block pieces, emulated in one process
# ----------------------------------------------------------------------


def _emulate(cos, labels, k, kw, n_blocks):
    """The whole row's (ce, neg) and the cosines' gradient of mean(ce) +
    mean(neg) from ``n_blocks`` emulated blocks."""
    c = cos.shape[-1] // n_blocks
    parts = []
    for j in range(n_blocks):
        col_ids = torch.arange(j * c, (j + 1) * c)
        parts.append((cos[..., j * c:(j + 1) * c], sharded_dense.held_columns(col_ids, labels),
                      col_ids))
    pos = labels >= 0
    d_ce = pos.float() / pos.float().sum().clamp(min=1.0)
    d_neg = (~pos).float() / (~pos).float().sum().clamp(min=1.0)
    (ce, neg, *_), grads = sharded_dense.emulate(parts, k, kw, d_ce, d_neg)
    return ce, neg, torch.cat(grads, -1)


@pytest.mark.parametrize("loss_type", ["Arc", "AM", "SV"])
def test_emulated_blocks_match_jax_add_margin(loss_type, rng):
    import jax
    import jax.numpy as jnp

    from vlsfr_tpu.ops.margin import add_margin

    r, c, k = 12, 40, 3
    cos = np.tanh(rng.standard_normal((r, c))).astype(np.float32)
    labels = rng.integers(0, c, r).astype(np.int32)
    labels[[1, 4, 7]] = -1
    # an outlier row whose third-largest cosine ties across blocks 1 and 2:
    # lax.top_k takes column 13
    cos[4] = np.minimum(cos[4], 0.5)
    cos[4, [5, 30]] = 0.9, 0.8
    cos[4, 13] = cos[4, 27] = 0.7
    kw = dict(KW, loss_type=loss_type)
    ce, neg, grad = _emulate(T(cos), T(labels), k, kw, 4)
    pos = labels >= 0
    loss = ce.sum() / pos.sum() + neg.sum() / (~pos).sum()
    jloss, jgrad = jax.value_and_grad(
        lambda x: add_margin(x, jnp.asarray(labels), hard_neg=k, loss_type=loss_type,
                             **KW))(jnp.asarray(cos))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), atol=1e-5, rtol=1e-5)
    assert jgrad[4, 13] > 0 and jgrad[4, 27] == 0
    # the single-device dense head (ops/margin.add_margin) breaks the tie alike
    x = T(cos).requires_grad_(True)
    port_add_margin(x, T(labels), hard_neg=k, loss_type=loss_type, **KW).backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgrad), atol=1e-5, rtol=1e-5)


def test_merge_breaks_ties_to_the_lowest_id(rng):
    """On rows of few distinct values (ties everywhere, also across
    blocks), the merged top-k ids are ``lax.top_k``'s and the merged top-1
    ``jnp.argmax``'s, exactly."""
    import jax
    import jax.numpy as jnp

    x = (rng.integers(0, 4, (16, 48)) / 4).astype(np.float32)
    for k in (1, 3, 7):
        states = []
        for j in range(4):
            ids = torch.arange(12 * j, 12 * j + 12)
            vals, top = top_k_low_ids(T(x[:, 12 * j:12 * j + 12]), ids, k)
            states.append((torch.zeros(16), torch.ones(16), vals, top))
        _, vals, ids = sharded_dense.merge_stats(*(torch.stack(s) for s in zip(*states)), k)
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
        if k == 1:
            np.testing.assert_array_equal(ids[:, 0].numpy(), np.asarray(jnp.argmax(x, axis=1)))


def test_empty_block_adds_nothing():
    """A rank that holds no column (route E when no sampled class falls in
    its block) adds (−inf, 0) and padding ids that never win."""
    cos = torch.tensor([[[0.5, -0.25]]])
    ll = torch.tensor([[-2]])
    kw = dict(KW, loss_type="Arc")
    full = sharded_dense.block_stats(cos, ll, torch.zeros(1, 1), torch.tensor([3, 9]), 2, kw)
    empty = sharded_dense.block_stats(cos[..., :0], ll, torch.zeros(1, 1),
                                      torch.zeros(0, dtype=torch.long), 2, kw)
    assert empty[0].item() == float("-inf") and empty[1].item() == 0.0
    assert (empty[3] == sharded_dense.NO_COLUMN).all()
    one = sharded_dense.merge_stats(*(torch.stack([x]) for x in full), 2)
    two = sharded_dense.merge_stats(*(torch.stack([a, b]) for a, b in zip(empty, full)), 2)
    for a, b in zip(one, two):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    grad = sharded_dense.block_grad(cos[..., :0], ll, torch.zeros(1, 1),
                                    torch.zeros(0, dtype=torch.long), *one, torch.ones(1, 1),
                                    torch.zeros(1, 1), 2, kw)
    assert grad.shape == (1, 1, 0)


# ----------------------------------------------------------------------
# the three compositions over 4 gloo ranks
# ----------------------------------------------------------------------

WORLD = 4
FFC = dict(b=6, q=32, d=8, k=3)
SOFT = dict(b=8, c=64, d=16, s=24, step=4)
E_KEY = 11


def ffc_case(rng):
    """The dense FFC head's case: a [2, 32, 8] queue whose slots 9 and 25
    hold first component 7/8 and slots 0 and 16 (the first columns of
    blocks 0 and 2) 3/4, the rest below 0.4; direction a's row 0 and
    direction b's row 0 are outliers along e0, so their top-3 ties at 3/4
    across blocks 0 and 2. Writes avoid those slots (one duplicate slot);
    labels reach every block, one slot twice."""
    q, d, b = FFC["q"], FFC["d"], FFC["b"]
    first = rng.uniform(-0.4, 0.4, (2, q))
    first[:, [9, 25]] = 0.875
    first[:, [0, 16]] = 0.75
    queue = np.stack([_rows_with_first(rng, q, d, f) for f in first])
    case = {"queue": queue}
    free = np.setdiff1d(np.arange(q), [0, 9, 16, 25])
    e0 = np.eye(d, dtype=np.float32)[0]
    for side in ("a", "b"):
        p = _unit(rng.standard_normal((b, d)))
        p[0] = e0
        labels = rng.choice(free, b).astype(np.int32)
        labels[0] = -1
        labels[[1, 2, 3]] = [2, 12, 30]
        labels[4] = labels[1]
        cols = rng.choice(free, b).astype(np.int32)
        cols[5] = cols[4]
        case.update({f"p_{side}": p, f"labels_{side}": labels, f"cols_{side}": cols,
                     f"g_{side}": _rows_with_first(rng, b, d, rng.uniform(-0.3, 0.3, b)),
                     f"rows_{side}": rng.integers(0, 2, b).astype(np.int32),
                     f"seen_{side}": (rng.random(b) < 0.6).astype(np.float32)})
    return case


def _tie_rows(d, axis):
    """Two unit rows whose component ``axis`` is 1/2 (exact under
    normalisation), with no other component on axes 0 and 1."""
    u, v = np.zeros((2, d), np.float32)
    u[[axis, 2 + 4 * axis, 3 + 4 * axis, 4 + 4 * axis]] = [0.5, 0.5, -0.5, 0.5]
    v[[axis, 2 + 4 * axis, 3 + 4 * axis, 5 + 4 * axis]] = [0.5, -0.5, 0.5, 0.5]
    return u, v


def softmax_case(rng):
    """Routes C and E: a [64, 16] classifier with small components on axes
    0 and 1, but classes 0 and 37 (C's tie along e0: row 0 along e0 targets
    37, which ties with class 0, the first column of block 0, and argmax
    picks 0) and 50 and 3 (E's tie along e1: row 0 targets 50 at position
    0, tied with row 1's class 3 at position 1 in block 0; argmax picks
    position 0). Momentum and last-visit steps for the sparse update,
    JAX's draws for route E."""
    import jax

    b, c, d, s = SOFT["b"], SOFT["c"], SOFT["d"], SOFT["s"]
    w = rng.standard_normal((c, d)).astype(np.float32)
    w[:, :2] *= 0.05
    w[0], w[37] = _tie_rows(d, 0)
    w[50], w[3] = _tie_rows(d, 1)
    emb = _unit(rng.standard_normal((b, d)))
    emb_c, emb_e = emb.copy(), emb.copy()
    emb_c[0], emb_e[0] = np.eye(d, dtype=np.float32)[:2]
    labels_c = np.array([37, 5, 20, 40, 60, 5, 33, 17], np.int32)
    labels_e = np.array([50, 3, 20, 40, 60, 20, 33, 17], np.int32)
    rand = np.asarray(jax.random.randint(jax.random.PRNGKey(E_KEY), (s - b,), 0, c))
    return {"w": w, "emb_C": emb_c, "emb_E": emb_e, "labels_C": labels_c, "labels_E": labels_e,
            "rand": rand.astype(np.int32),
            "mom": (0.1 * rng.standard_normal((c, d))).astype(np.float32),
            "last": rng.integers(0, SOFT["step"], c).astype(np.int32)}


def _merge_high_ties(m_all, s_all, vals_all, ids_all, k):
    ref, s = merge_logsumexp(m_all, s_all)
    vals = vals_all.movedim(0, -2).flatten(-2)
    ids = ids_all.movedim(0, -2).flatten(-2)
    order = torch.argsort(ids, dim=-1, descending=True, stable=True)
    vals, ids = top_k_low_ids(vals.gather(-1, order), ids.gather(-1, order), k)
    return ref + torch.log(s), vals, ids


@contextlib.contextmanager
def planted(fault):
    """``ties``: the merge breaks ties to the highest id; ``drop``: every
    block leaves out its first column."""
    orig = {"merge_stats": sharded_dense.merge_stats, "block_stats": sharded_dense.block_stats}
    if fault == "ties":
        sharded_dense.merge_stats = _merge_high_ties
    elif fault == "drop":
        def dropped(cos, ll, gt, col_ids, k, kw):
            return orig["block_stats"](cos[..., 1:], torch.where(ll >= 0, ll - 1, ll), gt,
                                       col_ids[1:], k, kw)
        sharded_dense.block_stats = dropped
    try:
        yield
    finally:
        for name, fn in orig.items():
            setattr(sharded_dense, name, fn)


COMPOSITIONS = {  # name: (route, loss type)
    "ffc-Arc": ("ffc", "Arc"), "ffc-AM": ("ffc", "AM"), "ffc-SV": ("ffc", "SV"),
    "C-Arc": ("C", "Arc"), "C-AM": ("C", "AM"), "C-SV": ("C", "SV"),
    "E-sparse-Arc": ("E-sparse", "Arc"), "E-sparse-SV": ("E-sparse", "SV"),
    "E-dense-AM": ("E-dense", "AM")}
FAULTED = {"ffc": "ffc-Arc", "C": "C-Arc", "E": "E-sparse-Arc"}
FAULTS = ("ties", "drop")


def _run_ffc(case, lt, mesh):
    c0, cl = mesh.class_block(FFC["q"])
    fn = make_sharded_dense_loss(mesh, with_acc=True, loss_type=lt, hard_neg=FFC["k"], **KW)
    px = T(case["p_a"]).clone().requires_grad_(True)
    py = T(case["p_b"]).clone().requires_grad_(True)
    q_l = T(np.ascontiguousarray(case["queue"][:, c0:c0 + cl]))
    plan = {s: tuple(T(case[f"{n}_{s}"]) for n in ("rows", "cols", "seen")) for s in "ab"}
    (la, lb), acc = fn(px, py, q_l, T(case["g_a"]), T(case["g_b"]), plan["a"], plan["b"],
                       T(case["labels_a"]), T(case["labels_b"]))
    (la + lb).backward()
    written = write_rows_(q_l.clone(), T(case["g_b"]), *plan["b"][:2], c0)
    return dict(loss=(la + lb).detach(), loss_a=la.detach(), acc=acc, d_p_a=px.grad,
                d_p_b=py.grad, queue=written)


def _run_softmax(case, route, lt, mesh):
    c0, cl = mesh.class_block(SOFT["c"], "pool.num_classes")
    e = T(case[f"emb_{route[0]}"]).clone().requires_grad_(True)
    w_l = T(case["w"][c0:c0 + cl]).clone()
    kw = dict(KW, loss_type=lt)
    out = {}
    if route == "C":
        w_l.requires_grad_(True)
        loss, m = margin_softmax_loss(e, w_l, T(case["labels_C"]), mesh=mesh, **kw)
        loss.backward()
        grad = w_l.grad
    else:
        loss, m, rows, w_sub = sharded_sampled_loss(
            e, w_l, c0, T(case["labels_E"]), T(case["rand"]), SOFT["c"], SOFT["s"], mesh.group,
            **kw)
        loss.backward()
        grad = torch.zeros_like(w_l).index_copy_(0, rows, w_sub.grad)
    if route == "E-sparse":
        mom = T(case["mom"][c0:c0 + cl]).clone()
        last = T(case["last"][c0:c0 + cl]).clone()
        sparse_sgd_rows(w_l, mom, rows, w_sub.grad, lr=LR, last_visit=last, step=SOFT["step"],
                        **SGD)
        out["last"] = last
    else:
        mom = torch.zeros_like(w_l)
        sgd_leaf_(w_l, mom, grad, LR, **SGD)
    return dict(out, loss=loss.detach(), acc=m["train_acc"], d_emb=e.grad, w=w_l.detach(),
                mom=mom)


def _world4_rank(rank, world, store, case_path, out_dir):
    torch.set_num_threads(1)
    distributed.initialize("cpu", rank=rank, world_size=world, store_path=store)
    try:
        mesh = make_mesh(1, world)
        data = dict(np.load(case_path))
        out = {}
        runs = [(name, None) for name in COMPOSITIONS]
        runs += [(FAULTED[r], f) for r in FAULTED for f in FAULTS]
        for name, fault in runs:
            route, lt = COMPOSITIONS[name]
            with planted(fault):
                if route == "ffc":
                    res = _run_ffc({k[4:]: v for k, v in data.items() if k.startswith("ffc/")},
                                   lt, mesh)
                else:
                    res = _run_softmax({k[5:]: v for k, v in data.items()
                                        if k.startswith("soft/")}, route, lt, mesh)
            out.update({f"{name}/{fault}/{k}": v.numpy() for k, v in res.items()})
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        distributed.destroy()


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    """The cases, every rank's outputs of the three compositions (real and
    planted) from one spawn of 4 gloo ranks, and JAX's sharded steps on a
    1×4 CPU mesh on the same cases ({name: outputs})."""
    rng = np.random.default_rng(0)
    cases = {"ffc": ffc_case(rng), "soft": softmax_case(rng)}

    def build(tmp):
        import jax

        from vlsfr_tpu.parallel.mesh import make_mesh as j_make_mesh

        path = str(tmp / "case.npz")
        np.savez(path, **{f"{g}/{k}": v for g, case in cases.items() for k, v in case.items()})
        spawn(_world4_rank, WORLD, str(tmp / "store"), path, str(tmp))
        mesh = j_make_mesh(1, WORLD, devices=jax.devices()[:WORLD])
        for name, (route, lt) in COMPOSITIONS.items():
            np.savez(tmp / f"jax_{name}.npz", **(
                _jax_ffc(cases["ffc"], lt, mesh) if route == "ffc"
                else _jax_softmax(cases["soft"], route, lt, mesh)))

    tmp = once(tmp_path_factory, "dense_world4", build)
    return (cases, [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)],
            {name: dict(np.load(tmp / f"jax_{name}.npz")) for name in COMPOSITIONS})


def _jax_ffc(case, lt, mesh):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from vlsfr_tpu.core.ffc import directional_loss
    from vlsfr_tpu.parallel.mesh import queue_sharding

    j = {k: jnp.asarray(v) for k, v in case.items()}
    kw = dict(KW, loss_type=lt, hard_neg=FFC["k"])

    def f(px, py, queue):
        la, _, acc_a = directional_loss(px, j["g_a"], queue, j["rows_a"], j["cols_a"],
                                        j["seen_a"], j["labels_a"], with_acc=True, **kw)
        lb, nq, acc_b = directional_loss(py, j["g_b"], queue, j["rows_b"], j["cols_b"],
                                         j["seen_b"], j["labels_b"], with_acc=True, **kw)
        return la + lb, (la, (acc_a + acc_b) / 2, nq)

    rep = NamedSharding(mesh, P())
    queue = jax.device_put(j["queue"], queue_sharding(mesh))
    (loss, (la, acc, nq)), (gx, gy) = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(
        jax.device_put(j["p_a"], rep), jax.device_put(j["p_b"], rep), queue)
    return {k: np.asarray(v) for k, v in dict(loss=loss, loss_a=la, acc=acc, d_p_a=gx, d_p_b=gy,
                                               queue=nq).items()}


def _jax_softmax(case, route, lt, mesh):
    import jax
    import jax.numpy as jnp
    import optax

    from vlsfr_tpu.config import Config as JConfig
    from vlsfr_tpu.optim import make_optimizer as j_make_optimizer
    from vlsfr_tpu.parallel.mesh import classifier_sharding, replicated
    from vlsfr_tpu.parallel.partial_fc import margin_softmax_loss as j_loss
    from vlsfr_tpu.parallel.partial_fc import sample_classes as j_sample
    from vlsfr_tpu.train.sparse_classifier import sparse_sgd_rows as j_sparse

    c, s, step = SOFT["c"], SOFT["s"], SOFT["step"]
    kw = dict(KW, loss_type=lt)
    opt = j_make_optimizer(JConfig().apply_overrides(
        [f"optim.lr={LR}", "optim.momentum=0.9", "optim.nesterov=true",
         "optim.weight_decay=1e-4"]).optim)
    w = jax.device_put(jnp.asarray(case["w"]), classifier_sharding(mesh))
    emb = jax.device_put(jnp.asarray(case[f"emb_{route[0]}"]), replicated(mesh))

    def optax_step(w, grad):
        state = opt.init(w)
        upd, state = opt.update(grad, state, w)
        return (w + upd).astype(w.dtype), optax.tree_utils.tree_get(state, "trace")

    if route == "C":
        labels = jnp.asarray(case["labels_C"])

        def step_fn(emb, w):
            (loss, m), (ge, gw) = jax.value_and_grad(
                lambda e, w_: j_loss(e, w_, labels, mesh=mesh, **kw), argnums=(0, 1),
                has_aux=True)(emb, w)
            w2, mom = optax_step(w, gw)
            return dict(loss=loss, acc=m["train_acc"], d_emb=ge, w=w2, mom=mom)

        out = jax.jit(step_fn)(emb, w)
    else:
        labels = jnp.asarray(case["labels_E"])
        key = jax.random.PRNGKey(E_KEY)

        def step_fn(emb, w, mom, last):
            sampled, local, valid = j_sample(labels, c, s, key)
            (loss, m), (ge, gsub) = jax.value_and_grad(
                lambda e, ws: j_loss(e, ws, local, col_mask=valid, **kw), argnums=(0, 1),
                has_aux=True)(emb, w[sampled])
            out = dict(loss=loss, acc=m["train_acc"], d_emb=ge)
            if route == "E-sparse":
                w2, mom2, last2 = j_sparse(w, mom, jnp.where(valid, sampled, c), gsub, lr=LR,
                                           last_visit=last, step=step, **SGD)
                return dict(out, w=w2, mom=mom2, last=last2)
            w2, mom2 = optax_step(w, jnp.zeros_like(w).at[sampled].add(gsub))
            return dict(out, w=w2, mom=mom2)

        out = jax.jit(step_fn)(emb, w, jax.device_put(jnp.asarray(case["mom"]),
                                                      classifier_sharding(mesh)),
                               jnp.asarray(case["last"]))
    return {k: np.asarray(v) for k, v in out.items()}


# per route: the outputs held to JAX, each (name, sharded axis or None, atol, rtol)
CHECKS = {
    "ffc": (("loss", None, 0.0, 1e-4), ("loss_a", None, 0.0, 1e-4), ("acc", None, 0.0, 0.0),
            ("d_p_a", None, 3e-5, 0.0), ("d_p_b", None, 3e-5, 0.0), ("queue", 1, 0.0, 0.0)),
    "C": (("loss", None, 0.0, 1e-4), ("acc", None, 0.0, 0.0), ("d_emb", None, 3e-5, 0.0),
          ("w", 0, 2e-6, 1e-5), ("mom", 0, 2e-5, 1e-5)),
}
CHECKS["E-dense"] = CHECKS["C"]
CHECKS["E-sparse"] = CHECKS["C"] + (("last", 0, 0.0, 0.0),)


def _held_to_jax(name, rank_out, want, rank, fault=None):
    """The failures of one rank's outputs against JAX's (empty: it holds)."""
    route = COMPOSITIONS[name][0]
    bad = []
    for key, axis, atol, rtol in CHECKS[route]:
        got = rank_out[f"{name}/{fault}/{key}"]
        ref = want[key]
        if axis is not None:
            n = ref.shape[axis] // WORLD
            ref = np.take(ref, np.arange(rank * n, (rank + 1) * n), axis=axis)
        if not np.allclose(got, ref, atol=atol, rtol=rtol):
            bad.append(f"{key}: max |diff| {np.abs(got - ref).max():.3e}")
    return bad


@pytest.mark.parametrize("name", list(COMPOSITIONS))
def test_world4_composition_matches_jax(name, world4):
    _, ranks, jax_steps = world4
    route = COMPOSITIONS[name][0]
    for r, out in enumerate(ranks):
        assert _held_to_jax(name, out, jax_steps[name], r) == [], f"rank {r}"
        for key, axis, _, _ in CHECKS[route]:  # the ranks agree bit for bit
            if axis is None:
                np.testing.assert_array_equal(out[f"{name}/None/{key}"],
                                              ranks[0][f"{name}/None/{key}"])


@pytest.mark.parametrize("route,fault", [(r, f) for r in FAULTED for f in FAULTS])
def test_world4_planted_faults_fail(route, fault, world4):
    """Ties broken to the highest id, or a column left out of every block:
    the checks against JAX that the real merge passes fail on every
    rank."""
    _, ranks, jax_steps = world4
    name = FAULTED[route]
    for r, out in enumerate(ranks):
        assert _held_to_jax(name, out, jax_steps[name], r, fault=fault), f"rank {r}"


# ----------------------------------------------------------------------
# a world of one against the single-device heads
# ----------------------------------------------------------------------


@pytest.mark.parametrize("route", ["ffc", "C", "E"])
def test_world1_matches_single_device(route, tmp_path):
    """Over a real group of one the merges are of one block: the loss, the
    accuracy, d_emb and the classifier rows' gradient equal the
    single-device head's within 1e-5 relative + 1e-6 absolute (the sums run
    in another order)."""
    from vlsfr_tpu_torch.core.ffc import directional_loss
    from vlsfr_tpu_torch.parallel.partial_fc import sample_classes

    rng = np.random.default_rng(3)
    res = []
    assert distributed.initialize("cpu", rank=0, world_size=1, store_path=str(tmp_path / "s"))
    try:
        mesh = make_mesh(1, 1)
        if route == "ffc":
            case = ffc_case(rng)
            plan = {s: tuple(T(case[f"{n}_{s}"]) for n in ("rows", "cols", "seen"))
                    for s in "ab"}
            kw = dict(KW, loss_type="Arc", hard_neg=FFC["k"])
            for m in (None, mesh):
                px = T(case["p_a"]).clone().requires_grad_(True)
                py = T(case["p_b"]).clone().requires_grad_(True)
                q, la, lb = T(case["queue"]), T(case["labels_a"]), T(case["labels_b"])
                if m is None:
                    loss_a, _, acc_a = directional_loss(px, T(case["g_a"]), q, *plan["a"], la,
                                                        with_acc=True, **kw)
                    loss_b, _, acc_b = directional_loss(py, T(case["g_b"]), q, *plan["b"], lb,
                                                        with_acc=True, **kw)
                    acc = (acc_a + acc_b) / 2
                else:
                    (loss_a, loss_b), acc = make_sharded_dense_loss(m, with_acc=True, **kw)(
                        px, py, q, T(case["g_a"]), T(case["g_b"]), plan["a"], plan["b"], la, lb)
                (loss_a + loss_b).backward()
                res.append((loss_a.detach(), loss_b.detach(), acc, px.grad, py.grad))
        else:
            case = softmax_case(rng)
            labels, w = T(case[f"labels_{route}"]), T(case["w"])
            for m in (None, mesh):
                e = T(case[f"emb_{route}"]).clone().requires_grad_(True)
                if route == "C":
                    ww = w.clone().requires_grad_(True)
                    loss, metrics = margin_softmax_loss(e, ww, labels, mesh=m, loss_type="SV",
                                                        **KW)
                    loss.backward()
                    grad = ww.grad
                elif m is None:
                    sampled, local, valid = sample_classes(labels, SOFT["c"], SOFT["s"],
                                                           T(case["rand"]))
                    ww = w.clone().requires_grad_(True)
                    loss, metrics = margin_softmax_loss(e, ww[sampled.long()], local,
                                                        col_mask=valid, loss_type="Arc", **KW)
                    loss.backward()
                    grad = ww.grad
                else:
                    loss, metrics, rows, w_sub = sharded_sampled_loss(
                        e, w, 0, labels, T(case["rand"]), SOFT["c"], SOFT["s"], m.group,
                        loss_type="Arc", **KW)
                    loss.backward()
                    grad = torch.zeros_like(w).index_copy_(0, rows, w_sub.grad)
                res.append((loss.detach(), metrics["train_acc"], e.grad, grad))
    finally:
        distributed.destroy()
    for got, want in zip(*res):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


# ----------------------------------------------------------------------
# the slice as a whole: 3 steps at mesh.model = 2
# ----------------------------------------------------------------------

B, D, SIZE, STEPS, Q = 8, 16, 16, 3, 64
FFC_BASE = ["model.net_type=toy", f"model.feat_dim={D}", f"pool.queue_size={Q}",
            "model.dtype=float32", "pool.momentum=0.9", "optim.lr=0.05", "loss.scale=32",
            "pool.hard_neg=4", "pool.use_fused=off", "mesh.model=2", "mesh.data=1"]
SOFT_BASE = ["model.net_type=toy", f"model.feat_dim={D}", "model.dtype=float32",
             f"data.batch_size={B}", "pool.head=full_softmax", "optim.lr=0.05",
             "pool.use_fused=off", "mesh.model=2", "mesh.data=1"]
TRAJ = {  # name: (head, classes, overrides)
    "ffc": ("ffc", Q, []),
    "ffc-bf16": ("ffc", Q, ["pool.queue_dtype=bfloat16"]),
    "C": ("softmax", 96, []),
    "C-bf16": ("softmax", 96, ["pool.classifier_dtype=bfloat16"]),
    "E-sparse": ("softmax", 96, ["pool.sample_rate=0.25", "pool.sparse_update=true"]),
    "E-dense": ("softmax", 96, ["pool.sample_rate=0.25", "optim.grad_clip=0.5"]),
}
FFC_METRICS = ("loss", "loss_dir_a", "loss_dir_b", "grad_norm", "lr", "train_acc",
               "pool_hit_rate", "outlier_frac")
GHOST_IDS = 97
BF16_NOISE = 2.0**-4  # as tests/test_torch_sharded_softmax.py's bf16 trajectories


def _traj_cfg(name):
    head, c, extra = TRAJ[name]
    if head == "ffc":
        return FFC_BASE + extra
    return SOFT_BASE + extra + [f"pool.num_classes={c}"]


def _num_sampled(name):
    return max(B, int(TRAJ[name][1] * 0.25))


def _ffc_trajectory(name, mesh, tmp, out):
    import copy

    from vlsfr_tpu_torch.core.dcp import DCPManager
    from vlsfr_tpu_torch.core.ffc import QUEUE_DTYPES, FFCState, make_train_step
    from vlsfr_tpu_torch.models import create_net
    from vlsfr_tpu_torch.optim import make_optimizer, make_schedule

    cfg = Config().apply_overrides(_traj_cfg(name))
    init = dict(np.load(os.path.join(tmp, f"init_{name}.npz")))
    data = dict(np.load(os.path.join(tmp, "ffc_data.npz")))
    probe = create_net("toy", feat_dim=D)
    probe.load_state_dict({k[6:]: T(v) for k, v in init.items() if k.startswith("probe/")})
    c0, cl = mesh.class_block(Q)
    queue = T(np.ascontiguousarray(init["queue"][:, c0:c0 + cl]))  # bf16 values held in f32
    state = FFCState(step=0, probe=probe, gallery=copy.deepcopy(probe).requires_grad_(False),
                     queue=queue.to(QUEUE_DTYPES[cfg.pool.queue_dtype]),
                     optimizer=make_optimizer(cfg.optim, probe.parameters()))
    step = make_train_step(cfg, make_schedule(cfg.optim, 10), mesh=mesh)
    dcp = DCPManager(Q)
    for s in range(STEPS):
        m = step(state, data[f"x{s}"], data[f"y{s}"],
                 dcp.plan_step(data[f"xl{s}"], data[f"yl{s}"]), 1.0)
        out.update({f"{name}/{s}/m/{k}": np.asarray(float(m[k])) for k in FFC_METRICS})
        out[f"{name}/{s}/queue"] = state.queue.float().numpy().copy()
    out.update({f"{name}/p/{k}": v.numpy().copy() for k, v in probe.state_dict().items()})


def _softmax_trajectory(name, mesh, tmp, out):
    from vlsfr_tpu_torch.models import create_net
    from vlsfr_tpu_torch.optim import make_schedule
    from vlsfr_tpu_torch.train import softmax_head

    cfg = Config().apply_overrides(_traj_cfg(name))
    init = dict(np.load(os.path.join(tmp, f"init_{name}.npz")))
    data = dict(np.load(os.path.join(tmp, "soft_data.npz")))
    backbone = create_net("toy", feat_dim=D)
    backbone.load_state_dict({k[9:]: T(v) for k, v in init.items() if k.startswith("backbone/")})
    state = softmax_head.create_softmax_state(
        backbone, cfg, cfg.pool.num_classes, device="cpu", mesh=mesh,
        classifier=T(init["classifier"]).to(softmax_head.DTYPES[cfg.pool.classifier_dtype]))
    step = softmax_head.make_softmax_train_step(cfg, make_schedule(cfg.optim, 100), mesh=mesh)
    for s in range(STEPS):
        m = step(state, data["images"], data["labels"], 1.0)
        out.update({f"{name}/{s}/{k}": np.asarray(float(v)) for k, v in m.items()})
        if s == 0:  # the first step's block, for the bf16 classifier's exact check
            out[f"{name}/classifier1"] = state.classifier.detach().float().numpy().copy()
    out[f"{name}/classifier"] = state.classifier.detach().float().numpy().copy()
    for key in ("classifier_mom", "classifier_last"):
        x = getattr(state, key)
        if x is not None:
            out[f"{name}/{key}"] = (x.float() if x.is_floating_point() else x).numpy().copy()
    out.update({f"{name}/p/{k}": v.numpy().copy() for k, v in state.backbone.state_dict().items()})


def _trainer(tmp, rank, tag, overrides):
    from vlsfr_tpu_torch.train.trainer import Trainer

    cfg = Config().apply_overrides(
        ["model.net_type=toy", "model.feat_dim=16", "data.batch_size=8", "data.image_size=16",
         "data.synthetic_ids=30", "data.synthetic_images_per_id=3", "data.num_workers=1",
         "model.dtype=float32", "train.print_freq=1", "optim.lr=0.01", "mesh.model=2",
         "mesh.data=1", *overrides])
    cfg.data.synthetic = True
    cfg.train.saved_dir = os.path.join(tmp, f"{tag}{rank}")
    return Trainer(cfg, device="cpu")


def _world2_rank(rank, world, store, tmp):
    from vlsfr_tpu_torch.train import softmax_head

    torch.set_num_threads(1)
    distributed.initialize("cpu", rank=rank, world_size=world, store_path=store)
    try:
        mesh = make_mesh(1, world)
        out = {}
        # route E's own draws, before JAX's are fed in below: no rank argument
        out["draws"] = np.stack([softmax_head.sample_draws(s, 10, GHOST_IDS + 1, "cpu").numpy()
                                 for s in range(STEPS)])
        out["draws_params"] = np.asarray(list(inspect.signature(
            softmax_head.sample_draws).parameters))
        data = dict(np.load(os.path.join(tmp, "soft_data.npz")))
        own = softmax_head.sample_draws
        softmax_head.sample_draws = lambda step, n, num_classes, device: T(data[f"r{step}"])
        try:
            for name, (head, _, _) in TRAJ.items():
                (_ffc_trajectory if head == "ffc" else _softmax_trajectory)(name, mesh, tmp, out)
        finally:
            softmax_head.sample_draws = own
        trainer = _trainer(tmp, rank, "ffc", ["pool.queue_size=64"])
        try:
            out["trainer/ffc/loss"] = np.asarray(trainer.train(max_steps=2)["loss"])
            out["trainer/ffc/queue_shape"] = np.asarray(trainer.state.queue.shape)
        finally:
            trainer.close()
        trainer = _trainer(tmp, rank, "ghost", ["pool.head=full_softmax",
                                                f"pool.num_classes={GHOST_IDS}"])
        try:
            out["ghost/num_classes"] = np.asarray(trainer.cfg.pool.num_classes)
            out["ghost/block"] = trainer.state.classifier.detach().numpy().copy()
            out["ghost/loss"] = np.asarray(trainer.train(max_steps=1)["loss"])
            jax_init = T(dict(np.load(os.path.join(tmp, "ghost.npz")))["classifier"])
            state = softmax_head.create_softmax_state(
                trainer.state.backbone, trainer.cfg, trainer.cfg.pool.num_classes, device="cpu",
                classifier=jax_init, mesh=mesh)
            out["ghost/jax_block"] = state.classifier.detach().numpy().copy()
        finally:
            trainer.close()
        np.savez(os.path.join(tmp, f"rank{rank}.npz"), **out)
    finally:
        distributed.destroy()


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """JAX's initial states per trajectory, the batches and JAX's route-E
    draws, JAX's classifier at the ghost-padded class count, and both
    ranks' trajectories and Trainer runs from one spawn of 2 gloo ranks."""
    import jax
    import jax.numpy as jnp

    from vlsfr_tpu.config import Config as JConfig
    from vlsfr_tpu.core.ffc import create_ffc_state as j_ffc_state
    from vlsfr_tpu.models import create_net as j_create_net
    from vlsfr_tpu.optim import make_optimizer as j_make_optimizer
    from vlsfr_tpu.train.softmax_head import create_softmax_state as j_soft_state
    from vlsfr_tpu_torch.models import create_net
    from vlsfr_tpu_torch.models.from_jax import load_flax_variables

    rng = np.random.default_rng(0)
    ffc_data = {}
    for s in range(STEPS):
        ids = rng.integers(0, 40, B // 2)
        ffc_data[f"xl{s}"] = np.concatenate([ids, rng.integers(0, 40, B // 2)])
        ffc_data[f"yl{s}"] = np.concatenate([ids, rng.integers(0, 40, B // 2)])
        ffc_data[f"x{s}"] = rng.standard_normal((B, SIZE, SIZE, 3)).astype(np.float32)
        ffc_data[f"y{s}"] = rng.standard_normal((B, SIZE, SIZE, 3)).astype(np.float32)
    labels = rng.integers(0, 96, B).astype(np.int32)
    labels[1] = labels[0]  # a repeated class
    labels[-2:] = 47, 48  # the two blocks' edges
    soft_data = {"images": rng.standard_normal((B, SIZE, SIZE, 3)).astype(np.float32),
                 "labels": labels}
    n = _num_sampled("E-sparse") - B
    for s in range(STEPS):  # JAX's route-E key: PRNGKey(17) folded with the step
        key = jax.random.fold_in(jax.random.PRNGKey(17), s)
        soft_data[f"r{s}"] = np.asarray(jax.random.randint(key, (n,), 0, 96)).astype(np.int32)
    jstates, inits = {}, {}
    for name, (head, c, _) in TRAJ.items():
        jcfg = JConfig().apply_overrides(_traj_cfg(name))
        jmodel = j_create_net("toy", feat_dim=D)
        jopt = j_make_optimizer(jcfg.optim)
        if head == "ffc":
            jstate = j_ffc_state(jax.random.PRNGKey(0), jmodel, jcfg, jopt, SIZE)
            probe = load_flax_variables(create_net("toy", feat_dim=D),
                                        jax.device_get(jstate.probe_params),
                                        jax.device_get(jstate.probe_stats))
            inits[name] = dict(queue=np.asarray(jstate.queue.astype(jnp.float32)),
                               **{f"probe/{k}": v.numpy() for k, v in probe.state_dict().items()})
        else:
            jstate = j_soft_state(jax.random.PRNGKey(0), jmodel, jcfg, jopt, SIZE, c)
            backbone = load_flax_variables(create_net("toy", feat_dim=D),
                                           jax.device_get(jstate.params["backbone"]),
                                           jax.device_get(jstate.batch_stats))
            inits[name] = dict(
                classifier=np.asarray(jstate.params["classifier"].astype(jnp.float32)),
                **{f"backbone/{k}": v.numpy() for k, v in backbone.state_dict().items()})
        jstates[name] = (jcfg, jmodel, jopt, jstate)
    gcfg = JConfig().apply_overrides(SOFT_BASE[:-3] + [f"pool.num_classes={GHOST_IDS + 1}"])
    gstate = j_soft_state(jax.random.PRNGKey(0), j_create_net("toy", feat_dim=D), gcfg,
                          j_make_optimizer(gcfg.optim), SIZE, GHOST_IDS + 1)
    ghost = np.asarray(gstate.params["classifier"])

    def build(tmp):
        np.savez(tmp / "ffc_data.npz", **ffc_data)
        np.savez(tmp / "soft_data.npz", **soft_data)
        for name, init in inits.items():
            np.savez(tmp / f"init_{name}.npz", **init)
        np.savez(tmp / "ghost.npz", classifier=ghost)
        spawn(_world2_rank, 2, str(tmp / "store"), str(tmp))

    tmp = once(tmp_path_factory, "dense_world2", build)
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(2)]
    return dict(ffc=ffc_data, soft=soft_data, ghost=ghost), jstates, ranks


def _check_ffc_trajectory(name, data, jstates, ranks):
    import jax
    import jax.numpy as jnp

    from vlsfr_tpu.core.dcp import DCPManager as JDCP
    from vlsfr_tpu.core.ffc import make_train_step as j_make_step
    from vlsfr_tpu.optim import make_schedule as j_make_schedule
    from vlsfr_tpu.parallel.mesh import batch_sharding, make_mesh as j_make_mesh
    from vlsfr_tpu.parallel.mesh import queue_sharding, replicated
    from vlsfr_tpu_torch.models import create_net
    from vlsfr_tpu_torch.models.from_jax import state_dict_from_flax

    bf16 = name.endswith("bf16")
    jcfg, jmodel, jopt, jstate = jstates[name]
    mesh = j_make_mesh(1, 2, devices=jax.devices()[:2])
    jstate = jax.tree.map(lambda x: jax.device_put(x, replicated(mesh)), jstate)
    jstate = jstate.replace(queue=jax.device_put(jstate.queue, queue_sharding(mesh)))
    jstep = jax.jit(j_make_step(jmodel, jcfg, jopt, j_make_schedule(jcfg.optim, 10), mesh=mesh))
    jdcp, bs = JDCP(Q), batch_sharding(mesh)
    r0, r1 = ranks
    for s in range(STEPS):
        jstate, jm = jstep(jstate, jax.device_put(jnp.asarray(data[f"x{s}"]), bs),
                           jax.device_put(jnp.asarray(data[f"y{s}"]), bs),
                           jdcp.plan_step(data[f"xl{s}"], data[f"yl{s}"]), 1.0)
        for k in FFC_METRICS[:5]:
            np.testing.assert_allclose(float(r0[f"{name}/{s}/m/{k}"]), float(jm[k]),
                                       rtol=1e-3 if bf16 and s else 1e-5, err_msg=f"{k}@{s}")
        for k in FFC_METRICS[5:]:
            assert float(r0[f"{name}/{s}/m/{k}"]) == pytest.approx(float(jm[k]), abs=1e-6), \
                f"{k}@{s}"
        # written rows are gallery embeddings; a bf16 queue holds them rounded
        np.testing.assert_allclose(
            np.concatenate([r[f"{name}/{s}/queue"] for r in ranks], axis=1),
            np.asarray(jstate.queue.astype(jnp.float32)), atol=2.0**-8 if bf16 else 1e-5,
            err_msg=f"queue@{s}")
        for k in FFC_METRICS:
            assert r1[f"{name}/{s}/m/{k}"] == r0[f"{name}/{s}/m/{k}"]
    want = state_dict_from_flax(create_net("toy", feat_dim=D),
                                jax.device_get(jstate.probe_params),
                                jax.device_get(jstate.probe_stats))
    for k, v in want.items():
        np.testing.assert_allclose(r0[f"{name}/p/{k}"], v.numpy(), rtol=1e-5,
                                   atol=1e-2 if bf16 else 2e-5, err_msg=k)
        np.testing.assert_array_equal(r1[f"{name}/p/{k}"], r0[f"{name}/p/{k}"])


def _check_softmax_trajectory(name, data, jstates, ranks):
    import jax
    import jax.numpy as jnp

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

    bf16 = name.endswith("bf16")
    f32 = lambda x: np.array(jnp.asarray(x).astype(jnp.float32))  # noqa: E731
    jcfg, jmodel, jopt, jstate = jstates[name]
    mesh = j_make_mesh(1, 2, devices=jax.devices()[:2])
    jstate = jax.tree.map(lambda x: jax.device_put(x, replicated(mesh)), jstate)
    if isinstance(jstate.opt_state, dict) and "classifier_last" in jstate.opt_state:
        opt = dict(jstate.opt_state)  # the sparse rows' own state rides with its rows
        opt["classifier_mom"] = jax.device_put(opt["classifier_mom"], classifier_sharding(mesh))
        opt["classifier_last"] = jax.device_put(opt["classifier_last"],
                                                class_vector_sharding(mesh))
        jstate = jstate.replace(opt_state=opt)
    jstate = jstate.replace(params=dict(jstate.params, classifier=jax.device_put(
        jstate.params["classifier"], classifier_sharding(mesh))))
    w0 = f32(jstate.params["classifier"]).copy()
    jstep = jax.jit(j_make_step(jmodel, jcfg, jopt, j_make_schedule(jcfg.optim, 100), mesh=mesh))
    r0, r1 = ranks
    for s in range(STEPS):
        jstate, jm = jstep(jstate, jnp.asarray(data["images"]), jnp.asarray(data["labels"]), 1.0)
        for k in ("loss", "ce", "lr"):
            np.testing.assert_allclose(float(r0[f"{name}/{s}/{k}"]), float(jm[k]),
                                       rtol=1e-3 if bf16 and s else 1e-5, err_msg=f"{k}@{s}")
        assert float(r0[f"{name}/{s}/train_acc"]) == pytest.approx(float(jm["train_acc"]),
                                                                   abs=1e-6)
        if name.startswith("E"):
            assert int(r0[f"{name}/{s}/sampled_classes"]) == _num_sampled(name)
        if bf16 and s == 0:  # the rounding points: the first step to the element
            got = torch.from_numpy(np.concatenate([r[f"{name}/classifier1"] for r in ranks]))
            apart, far = parity.bf16_ulps(
                "w'", got.bfloat16(), torch.from_numpy(f32(jstate.params["classifier"])).bfloat16(),
                torch.from_numpy(w0).bfloat16())
            assert not parity.failures([apart]), parity.describe(apart)
            assert far["max_spacings"] <= 2.0, parity.describe(far)
    jw = f32(jstate.params["classifier"])
    w_tol = (BF16_NOISE if bf16 else 4e-5 if name.startswith("E") else 2e-5) * np.abs(jw - w0).max()
    np.testing.assert_allclose(np.concatenate([r[f"{name}/classifier"] for r in ranks]), jw,
                               atol=w_tol)
    if name == "E-sparse":
        jmom = f32(jstate.opt_state["classifier_mom"])
        np.testing.assert_allclose(np.concatenate([r[f"{name}/classifier_mom"] for r in ranks]),
                                   jmom, atol=1e-4 * np.abs(jmom).max())
        np.testing.assert_array_equal(
            np.concatenate([r[f"{name}/classifier_last"] for r in ranks]),
            np.asarray(jstate.opt_state["classifier_last"]))
        moved = (np.abs(jw - w0).max(axis=1) > 0).sum()
        assert 0 < moved < jw.shape[0]  # only the sampled rows moved
    want = state_dict_from_flax(create_net("toy", feat_dim=D),
                                jax.device_get(jstate.params["backbone"]),
                                jax.device_get(jstate.batch_stats))
    for k, v in want.items():
        np.testing.assert_allclose(r0[f"{name}/p/{k}"], v.numpy(), rtol=1e-5,
                                   atol=1e-2 if bf16 else 2e-5, err_msg=k)
        np.testing.assert_array_equal(r1[f"{name}/p/{k}"], r0[f"{name}/p/{k}"])
    for key in r0:
        if key.startswith(f"{name}/") and key[len(name) + 1].isdigit():
            assert r1[key] == r0[key], key


@pytest.mark.parametrize("name", list(TRAJ))
def test_model2_trajectory_matches_jax_sharded_step(name, world2):
    """The dense FFC head (f32 and bf16 queue; ``test_torch_sharded_quad.py``'s
    limits, a bf16 queue's rows within one bf16 spacing) and routes C (f32
    and bf16 classifier) and E (sparse rows; dense optimizer with gradient
    clipping) at ``mesh.model = 2`` against JAX's sharded step
    (``test_torch_sharded_softmax.py``'s limits; at a bf16 classifier or
    queue the first step to the element, then bf16 noise: losses 1e-3
    relative, classifier BF16_NOISE × max|w − w₀|, parameters 1e-2
    absolute). The bf16 classifier's first step: the elements apart counted
    as ``parity.bf16_ulps`` counts them, each at most two spacings apart,
    not one: the merged logz sums in another order than XLA's, which flips
    the bf16 rounding of a gradient that straddles a rounding point, and at
    this toy's lr a gradient spacing moves w' by up to one more spacing
    (measured: 1 element of 1,536, 2 spacings). Both ranks bit-equal on the
    replicated state."""
    data, jstates, ranks = world2
    if TRAJ[name][0] == "ffc":
        _check_ffc_trajectory(name, data["ffc"], jstates, ranks)
    else:
        _check_softmax_trajectory(name, data["soft"], jstates, ranks)


def test_trainer_dense_ffc_at_model2(world2):
    """The Trainer at ``mesh.model = 2`` with the dense FFC head: each rank
    holds half the queue, both log the same finite loss."""
    ranks = world2[2]
    for r in ranks:
        assert r["trainer/ffc/queue_shape"].tolist() == [2, 32, 16]
        assert np.isfinite(r["trainer/ffc/loss"])
    assert ranks[0]["trainer/ffc/loss"] == ranks[1]["trainer/ffc/loss"]


def test_ghost_classes_pad_as_jax(world2, tmp_path):
    """``pool.num_classes = 97`` at ``mesh.model = 2``: the port's Trainer
    trains 98 classes, as JAX's Trainer pads them; its blocks are the
    slices of the whole classifier the same seed draws at 98 (the ghost row
    97 a real draw), and a classifier given whole (JAX's init at 98) is
    cut into its slices, bit for bit."""
    from vlsfr_tpu.config import Config as JConfig
    from vlsfr_tpu.train.trainer import Trainer as JTrainer
    from vlsfr_tpu_torch.train.softmax_head import init_classifier

    data, _, ranks = world2
    jcfg = JConfig().apply_overrides(
        ["model.net_type=toy", "model.feat_dim=16", "data.batch_size=8", "data.image_size=16",
         "data.synthetic_ids=30", "data.synthetic_images_per_id=3", "data.num_workers=1",
         "pool.head=full_softmax", f"pool.num_classes={GHOST_IDS}", "mesh.model=2",
         "model.dtype=float32"])
    jcfg.data.synthetic = True
    jcfg.train.saved_dir = str(tmp_path / "jax")
    jtrainer = JTrainer(jcfg)
    try:
        padded = jtrainer.cfg.pool.num_classes
    finally:
        jtrainer.close()
    assert padded == GHOST_IDS + 1
    whole = init_classifier(padded, 16, torch.float32, device="cpu",
                            generator=torch.Generator().manual_seed(0)).numpy()
    for r, out in enumerate(ranks):
        assert int(out["ghost/num_classes"]) == padded
        np.testing.assert_array_equal(out["ghost/block"], whole[49 * r:49 * (r + 1)])
        np.testing.assert_array_equal(out["ghost/jax_block"], data["ghost"][49 * r:49 * (r + 1)])
        assert np.isfinite(out["ghost/loss"])
    assert np.abs(ranks[1]["ghost/block"][-1]).max() > 0  # the ghost row is drawn, not zero


def test_route_e_draws_are_the_same_on_every_rank(world2):
    """``sample_draws`` takes no rank: both ranks draw the same class set
    at every step (JAX draws it once for the whole sharded classifier)."""
    ranks = world2[2]
    assert "rank" not in ranks[0]["draws_params"].tolist()
    np.testing.assert_array_equal(ranks[0]["draws"], ranks[1]["draws"])
    assert len({tuple(d) for d in ranks[0]["draws"]}) == STEPS  # each step its own
