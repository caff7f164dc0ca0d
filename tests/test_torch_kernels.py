"""The port's CUDA kernels (the quad and twin heads' and the streaming
softmax's) against their plain PyTorch versions.

This file imports neither JAX nor the JAX package, so the ``gpu`` tests run
on a machine with a card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -m gpu

Without a card the ``gpu`` tests skip; the CPU tests here check properties
of the plain versions the kernels are held to (chunking invariance, the
last-writer rule, no kernel launch on CPU tensors).

Kernel tolerances (f32 FMA in another summation order than cuBLAS, over up
to Q or C columns; scale·cos turns a 1e-7 cosine difference into a 3e-6
relative one in p): ce / neg / logz 1e-4 absolute, top-k 1e-5, d_gt 1e-5;
the forward's tile statistics maxcos 1e-5 and maxz scale × 1e-5; the
sparse backward on the kernel's and the plain version's common tile_idx,
its d_w rows per row set as below, d_emb on its streamed part, d_gt 1e-5;
quad d_emb 1e-4 × its max (f32 queue; the bf16 and int8 forms' in two
parts, ``parity.rounded_demb``: at most 8 rows beyond 1e-5 × max, none
beyond 2^-7 × max); the int8-compute dot bit for bit; the twin kernels as
the quad's (``parity.twin_checks``). The softmax kernels' gradients are held where
the kernel computes them alone (``vlsfr_tpu_torch/utils/parity.py``): d_emb
to 1e-4 × the max of its streamed part (less the target term both sides add
in plain torch); d_w, w' and mom' per row set — the batch's label rows and
the others — d_w to 1e-4 × the set's max|d_w|, mom' to 1e-4 × max|g| and
w' to 1e-4 × lr(1 + μ)·max|g|, where g = mom' − μ·mom is the gradient the
plain update applied; d_emb, w' and mom' also get 2 f32 eps × their max
for the rounding of the stored value.
"""

import ctypes
import shutil

import numpy as np
import pytest
import torch

from vlsfr_tpu_torch.ops import margin_stream as tms
from vlsfr_tpu_torch.ops import twin_margin as ttm
from vlsfr_tpu_torch.ops.qqueue import quantize_rows
from vlsfr_tpu_torch.utils import parity


def make_packed(seed, b, q, d, k, device="cpu", loss_type="Arc", form="f32", plan=None):
    """A quad case in the packed layout; ``form`` stores the queue as f32,
    bf16 or int8 (int8c: int8 with the probes quantised), and ``kw`` then
    carries the form's ``qscales`` and ``e8``. ``plan(direction, rows,
    cols)``, if given, edits each direction's write plan in place before
    the labels (the written slots) are drawn from it."""
    rng = np.random.default_rng(seed)
    unit = lambda x: (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)  # noqa: E731
    queue = torch.from_numpy(unit(rng.standard_normal((2, q, d)))).to(device)
    qscales = None
    if form == "bf16":
        queue = queue.bfloat16()
    elif form in ("int8", "int8c"):
        queue, qscales = quantize_rows(queue)
    dirs = []
    for _ in range(2):
        p = unit(rng.standard_normal((b, d)))
        g = unit(rng.standard_normal((b, d)))
        rows = rng.integers(0, 2, b).astype(np.int32)
        cols = rng.integers(0, q, b).astype(np.int32)
        rows[1], cols[1] = rows[0], cols[0]  # a duplicate slot
        if plan is not None:
            plan(len(dirs), rows, cols)
        seen = (rng.random(b) < 0.5).astype(np.float32)
        labels = cols.copy()
        labels[rng.random(b) < 0.3] = -1
        labels[2] = -1
        dirs.append([torch.from_numpy(x).to(device) for x in (p, g, rows, cols, seen, labels)])
    (pa, pb) = dirs
    packed = ttm.pack_dirs(pa[0], pb[0], ttm.dir_inputs(queue, *pa[1:5], qscales),
                           ttm.dir_inputs(queue, *pb[1:5], qscales), pa[5], pb[5],
                           ttm.compute_twin_gt(pa[0], queue, *pa[1:], qscales),
                           ttm.compute_twin_gt(pb[0], queue, *pb[1:], qscales))
    kw = dict(b=b, loss_type=loss_type, margin=0.5, scale=32.0, k=k, mask_svfc=1.2)
    if form != "f32":
        kw.update(qscales=None if qscales is None else qscales[0],
                  e8=quantize_rows(packed[0]) if form == "int8c" else None)
    r = 2 * b
    cot = torch.from_numpy((rng.standard_normal((4, r)) / b).astype(np.float32)).to(device)
    pos = (packed[6] >= 0)[None, :]
    dce = torch.where(pos, cot[:2], 0.0).contiguous()
    dneg = torch.where(pos, 0.0, cot[2:]).contiguous()
    return queue, packed, kw, dce, dneg


def assert_reordered_close(got, want, n_terms):
    """``got`` is ``want`` summed over ``n_terms`` columns in another order
    (the plain versions' chunks): within two f32 spacings of max|want|
    (2^-23 × it) for each column summed. An absolute limit would depend on
    the host's BLAS path for values of a few units; this one scales with
    them and stays below a fault of 1e-4 of max|want| while n_terms < 420."""
    tol = 2.0 * n_terms * 2.0**-23 * float(want.abs().max())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=tol)


def assert_chunk_invariant(pairs, n_terms):
    """Each (got, want) pair within ``assert_reordered_close``, and a fault
    of 1e-4 relative planted in each ``want`` (every value scaled by 1 +
    1e-4) outside it."""
    for got, want in pairs:
        assert_reordered_close(got, want, n_terms)
        with pytest.raises(AssertionError):
            assert_reordered_close(want * (1 + 1e-4), want, n_terms)


def test_plain_versions_are_chunk_invariant():
    q = 90
    queue, packed, kw, dce, dneg = make_packed(1, b=8, q=q, d=16, k=4, loss_type="SV")
    E, rest = packed[0], packed[1:]
    a = ttm.quad_fwd_plain(E, queue, *rest, chunk=7, **kw)
    b = ttm.quad_fwd_plain(E, queue, *rest, chunk=1000, **kw)
    assert_chunk_invariant(zip(a, b), q)
    kth = b[3][:, :, -1].contiguous()
    g1 = ttm.quad_bwd_plain(E, queue, *rest, b[2], kth, dce, dneg, chunk=7, **kw)
    g2 = ttm.quad_bwd_plain(E, queue, *rest, b[2], kth, dce, dneg, chunk=1000, **kw)
    assert_chunk_invariant(zip(g1, g2), q)


def test_written_column_uses_last_writer():
    """View 1 at a slot written twice with parity 0 scores the probe against
    the HIGHER batch index's gallery row."""
    b, q, d = 4, 10, 8
    E = torch.eye(2 * b, d)
    G = torch.zeros(2 * b, d)
    G[0, 0], G[1, 0] = 0.25, 0.75  # direction A: entries 0 and 1 both write slot 5
    cols = torch.tensor([5, 5, 1, 2, 3, 3, 3, 3], dtype=torch.int32)
    last0, lastb = ttm._chunk_writers(torch.zeros(2 * b, dtype=torch.int32), cols,
                                      torch.zeros(2 * b, dtype=torch.int32), b, 0, q)
    assert int(last0[0, 5]) == 1 and int(last0[1, 3]) == 3 and int(lastb.max()) == -1
    c1, _ = ttm._written_cos(torch.zeros(2 * b, q), E, G, torch.zeros(2 * b, d), last0,
                             lastb, b, b)
    assert float(c1[0, 5]) == 0.75


def test_cpu_tensors_never_launch():
    ttm.reset_launch_counts()
    queue, packed, kw, dce, dneg = make_packed(2, b=8, q=50, d=16, k=3)
    _, _, logz, topk = ttm.quad_fwd(packed[0], queue, *packed[1:], **kw)
    ttm.quad_bwd(packed[0], queue, *packed[1:], logz, topk[:, :, -1].contiguous(), dce, dneg,
                 **kw)
    assert not any(ttm.LAUNCH_COUNTS.values())


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


KERNEL_CASES = [("Arc", 64, 5000, 128, 10), ("AM", 64, 5000, 128, 10),
                ("SV", 64, 5000, 128, 10), ("Arc", 8, 700, 64, 1),
                ("Arc", 128, 40000, 512, 16),
                # R = 80 rows (not a multiple of the backward's 64-row group), Q not
                # a multiple of its 64-column tile, D = 192 and 64
                ("Arc", 40, 5001, 192, 10), ("SV", 40, 5001, 64, 5),
                # above 128 rows per direction: R = 400 (the f32 forward's two
                # 256-row groups, the second ragged) and R = 1024 (four; the
                # backward's sixteen 64-row groups)
                ("Arc", 200, 5001, 512, 10), ("SV", 512, 20000, 256, 10),
                ("AM", 512, 4096, 64, 3)]


@pytest.mark.gpu
@pytest.mark.parametrize("loss_type,b,q,d,k", KERNEL_CASES)
def test_cuda_kernels_match_plain(loss_type, b, q, d, k):
    dev = _cuda()
    queue, packed, kw, dce, dneg = make_packed(0, b, q, d, k, device=dev, loss_type=loss_type)
    E, rest = packed[0], packed[1:]
    got = ttm.quad_fwd(E, queue, *rest, **kw)
    want = ttm.quad_fwd_plain(E, queue, *rest, **kw)
    for name, g, w, tol in zip(("ce", "neg", "logz", "topk"), got, want,
                               (1e-4, 1e-4, 1e-4, 1e-5)):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), atol=tol, err_msg=name)
    logz, kth = want[2], want[3][:, :, -1].contiguous()
    d_k, g_k = ttm.quad_bwd(E, queue, *rest, logz, kth, dce, dneg, **kw)
    d_p, g_p = ttm.quad_bwd_plain(E, queue, *rest, logz, kth, dce, dneg, **kw)
    torch.cuda.synchronize()
    np.testing.assert_allclose(d_k.cpu().numpy(), d_p.cpu().numpy(),
                               atol=1e-4 * float(d_p.abs().max()))
    np.testing.assert_allclose(g_k.cpu().numpy(), g_p.cpu().numpy(), atol=1e-5)


@pytest.mark.gpu
def test_quad_add_margin_on_card_launches_each_kernel_once():
    dev = _cuda()
    queue, packed, kw, _, _ = make_packed(3, b=32, q=3000, d=128, k=10, device=dev)
    b = 32
    px = packed[0][:b].clone().requires_grad_(True)
    py = packed[0][b:].clone().requires_grad_(True)
    rng = np.random.default_rng(3)
    plan = lambda: tuple(torch.from_numpy(x).to(dev) for x in (  # noqa: E731
        rng.integers(0, 2, b).astype(np.int32), rng.integers(0, 3000, b).astype(np.int32),
        (rng.random(b) < 0.5).astype(np.float32)))
    pa, pb = plan(), plan()
    ga, gb = packed[1][:b], packed[1][b:]
    la, lb = pa[1].clone(), pb[1].clone()
    la[:5] = -1
    ttm.reset_launch_counts()
    mk = dict(loss_type="Arc", margin=0.5, scale=32.0, hard_neg=10)
    (lo_a, lo_b), acc = ttm.quad_add_margin(px, py, queue, ga, gb, pa, pb, la, lb,
                                            with_acc=True, **mk)
    (lo_a + lo_b).backward()
    assert ttm.LAUNCH_COUNTS == dict(dict.fromkeys(ttm.LAUNCH_COUNTS, 0), quad_fwd=1,
                                     quad_bwd=1)
    cpu = lambda t: t.detach().cpu()  # noqa: E731
    px_c = cpu(px).requires_grad_(True)
    py_c = cpu(py).requires_grad_(True)
    (ca, cb), cacc = ttm.quad_add_margin(px_c, py_c, cpu(queue), cpu(ga), cpu(gb),
                                         tuple(map(cpu, pa)), tuple(map(cpu, pb)), cpu(la),
                                         cpu(lb), with_acc=True, **mk)
    (ca + cb).backward()
    np.testing.assert_allclose(float(lo_a), float(ca), rtol=1e-5)
    np.testing.assert_allclose(float(lo_b), float(cb), rtol=1e-5)
    np.testing.assert_allclose(float(acc), float(cacc), atol=1e-7)
    scale = float(px_c.grad.abs().max())
    np.testing.assert_allclose(px.grad.cpu().numpy(), px_c.grad.numpy(), atol=1e-4 * scale)


# ----------------------------------------------------------------------
# the quad head's partial kernels (the model-sharded head)
# ----------------------------------------------------------------------


def make_shard_case(seed, b, q, d, device="cpu", bp=None, n_shards=4):
    """Probes and a write plan over a queue of q slots cut into n_shards
    blocks, bp writes (default b) per direction: a duplicate slot, labels
    in every block, outlier rows, a label this step writes, and a row whose
    target and write sit in different blocks. Cotangents [2, 2b] masked
    with the positive rows."""
    rng = np.random.default_rng(seed)
    bp = b if bp is None else bp
    c_local = q // n_shards
    unit = lambda x: (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)  # noqa: E731
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)  # noqa: E731
    queue = t(unit(rng.standard_normal((2, q, d))))
    embs, gs, plans, labs = [], [], [], []
    for _ in range(2):
        rows = rng.integers(0, 2, bp).astype(np.int32)
        cols = rng.integers(0, q, bp).astype(np.int32)
        rows[1], cols[1] = rows[0], cols[0]
        seen = (rng.random(bp) < 0.5).astype(np.float32)
        labels = rng.integers(0, q, b).astype(np.int32)
        labels[:n_shards] = np.arange(n_shards) * c_local + rng.integers(0, c_local, n_shards)
        labels[n_shards] = cols[2]  # a written slot
        cols[3] = (labels[0] + c_local) % q  # row 0's target and this write: other blocks
        labels[rng.random(b) < 0.25] = -1
        labels[n_shards + 1] = -1
        embs.append(t(unit(rng.standard_normal((b, d)))))
        gs.append(t(unit(rng.standard_normal((bp, d)))))
        plans.append((t(rows), t(cols), t(seen)))
        labs.append(t(labels))
    pos = torch.cat(labs)[None, :] >= 0
    cot = t((rng.standard_normal((4, 2 * b)) / b).astype(np.float32))
    dce = torch.where(pos, cot[:2], 0.0).contiguous()
    dneg = torch.where(pos, 0.0, cot[2:]).contiguous()
    return (embs[0], embs[1], queue, gs[0], gs[1], plans[0], plans[1], labs[0], labs[1], dce,
            dneg)


def shard_kw(loss_type, k=5):
    return dict(loss_type=loss_type, margin=0.5, scale=32.0, k=k, mask_svfc=1.2)


@pytest.mark.parametrize("loss_type", ["Arc", "AM", "SV"])
def test_emulated_shards_match_the_whole_queue_cpu(loss_type):
    """On the CPU (plain versions): the queue cut into 4 blocks, merged as
    the collectives merge them, equals the single-device head on the whole
    queue — the check chip_smoke.py makes on the card at full width."""
    case = make_shard_case(4, b=8, q=160, d=16)
    checks = parity.quad_shard_checks(*case, shard_kw(loss_type), n_shards=4)
    assert not parity.failures(checks), [parity.describe(c) for c in parity.failures(checks)]
    assert ttm.LAUNCH_COUNTS["quad_partial_fwd"] == ttm.LAUNCH_COUNTS["quad_partial_bwd"] == 0


SHARD_CASES = [("Arc", 64, 4096, 128, 1), ("Arc", 64, 4096, 128, 4), ("AM", 32, 2000, 64, 4),
               ("SV", 32, 2048, 64, 4), ("Arc", 128, 40000, 512, 4),
               ("AM", 40, 4004, 192, 4)]  # blocks of 1001 columns, R = 80, D = 192


@pytest.mark.gpu
@pytest.mark.parametrize("loss_type,b,q,d,n_shards", SHARD_CASES)
def test_partial_kernels_and_merge_match_plain_and_whole(loss_type, b, q, d, n_shards):
    dev = _cuda()
    ttm.reset_launch_counts()
    checks = parity.quad_shard_checks(*make_shard_case(5, b, q, d, device=dev, n_shards=n_shards),
                                      shard_kw(loss_type, k=10), n_shards=n_shards)
    torch.cuda.synchronize()
    for c in checks:
        print(parity.describe(c))
    assert not parity.failures(checks), [parity.describe(c) for c in parity.failures(checks)]
    assert ttm.LAUNCH_COUNTS["quad_partial_fwd"] == 2 * n_shards  # merge input + checks
    assert ttm.LAUNCH_COUNTS["quad_partial_bwd"] == n_shards


@pytest.mark.gpu
@pytest.mark.parametrize("loss_type", ["Arc", "SV"])
def test_partial_kernels_with_more_writes_than_probes(loss_type):
    """bp = 16 writes against b = 8 probes per direction, every sentinel
    (writes of other blocks, outliers, targets owned elsewhere), on block 1
    of 4: kernel against plain."""
    from vlsfr_tpu_torch.parallel.sharded_quad import shard_inputs

    dev = _cuda()
    (ex, ey, queue, ga, gb, pa, pb, la, lb, dce, dneg) = make_shard_case(
        6, b=8, q=2048, d=128, device=dev, bp=16)
    c_local = 512
    q_l = queue[:, c_local:2 * c_local]
    si = shard_inputs(ex, ey, q_l, c_local, ga, gb, pa, pb, la, lb)
    assert {-2, -1} <= set(si.labels.tolist()) and (si.lcol == -1).any() and (si.lcol >= 0).any()
    kw = shard_kw(loss_type, k=10)
    gt = torch.rand((2, 16), device=dev) - 0.2
    logz = torch.full((2, 16), kw["scale"], device=dev)
    kth = torch.full((2, 16), 0.1, device=dev)
    checks, _ = parity.quad_partial_checks(si, q_l, gt, logz, kth, dce, dneg, kw)
    torch.cuda.synchronize()
    for c in checks:
        print(parity.describe(c))
    assert not parity.failures(checks), [parity.describe(c) for c in parity.failures(checks)]


# ----------------------------------------------------------------------
# the streaming softmax kernels (csrc/margin_ce.cu)
# ----------------------------------------------------------------------


def make_softmax_case(seed, b, c, d, k, frac_outlier, device="cpu"):
    """Unit embeddings, a random classifier and momentum, labels with a
    repeated class (rows 0 and 1) and, optionally, outlier rows."""
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((b, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
    w = (0.01 * rng.standard_normal((c, d))).astype(np.float32)
    mom = (0.01 * rng.standard_normal((c, d))).astype(np.float32)
    labels = rng.integers(0, c, b).astype(np.int32)
    labels[1] = labels[0]
    if frac_outlier:
        labels[rng.random(b) < frac_outlier] = -1
        labels[2] = -1
    pos = labels >= 0
    d_ce = np.where(pos, 1.0 / b, 0.0).astype(np.float32)
    d_neg = np.where(pos, 0.0, 1.0 / b).astype(np.float32)
    return [torch.from_numpy(x).to(device) for x in (emb, w, mom, labels, d_ce, d_neg)]


def test_softmax_plain_versions_are_chunk_invariant():
    c = 90
    emb, w, mom, labels, d_ce, d_neg = make_softmax_case(4, 8, c, 16, 3, 0.4)
    kw = dict(loss_type="SV", margin=0.5, scale=32.0, k=3, mask_svfc=1.2)
    gt = tms.compute_gt(emb, w, labels)
    a = tms.margin_ce_fwd_plain(emb, w, labels, gt, chunk=7, **kw)
    b = tms.margin_ce_fwd_plain(emb, w, labels, gt, chunk=1000, **kw)
    assert_chunk_invariant(zip(a, b), c)
    logz, topk = b[2], b[3]
    g1 = tms.margin_ce_bwd_plain(emb, w, labels, gt, logz, topk, d_ce, d_neg, chunk=7, **kw)
    g2 = tms.margin_ce_bwd_plain(emb, w, labels, gt, logz, topk, d_ce, d_neg, chunk=1000, **kw)
    assert_chunk_invariant(zip(g1, g2), c)


def test_row_set_checks_catch_a_fault_on_the_other_rows():
    """The per-row-set checks (``utils/parity.py``) pass an exact d_w and
    update and fail one that takes 1.1 × the streamed d_w on the rows that
    are not label rows — the rows a kernel computes alone — and name those
    rows. The plain versions stand in for the kernel on both sides."""
    emb, w, mom, labels, d_ce, d_neg = make_softmax_case(6, 8, 300, 32, 1, 0.0)
    kw = dict(loss_type="Arc", margin=0.5, scale=32.0, k=1, mask_svfc=1.2)
    gt = tms.compute_gt(emb, w, labels)
    _, _, logz, topk = tms.margin_ce_fwd_plain(emb, w, labels, gt, **kw)
    dw_p = tms.margin_ce_bwd_plain(emb, w, labels, gt, logz, topk, d_ce, d_neg, **kw)[1]
    bad_dw = torch.where(parity.label_rows(w.shape[0], labels)[:, None], dw_p, 1.1 * dw_p)
    assert not parity.failures(parity.by_rows("d_w", dw_p.clone(), dw_p, dw_p, labels, 1e-4))
    bad = parity.failures(parity.by_rows("d_w", bad_dw, dw_p, dw_p, labels, 1e-4))
    assert [c["name"] for c in bad] == ["d_w (other rows)"]
    runs = {}
    for name, d_w in (("plain", dw_p), ("exact", dw_p.clone()), ("fault", bad_dw)):
        ww, mm = w.clone(), mom.clone()
        tms._sgd_rows(ww, mm, d_w, LR, **SGD)
        runs[name] = (ww, mm)
    for name, failed in (("exact", []), ("fault", ["mom' (other rows)", "w' (other rows)"])):
        checks = parity.sgd_update(*runs[name], *runs["plain"], mom, labels, LR, SGD["momentum"])
        assert [c["name"] for c in parity.failures(checks)] == failed
    # the whole backward sequence on CPU tensors, where the wrappers run the
    # plain versions: every check passes, W and mom move in place
    w_in, mom_in = w.clone(), mom.clone()
    bwd, fused = parity.margin_ce_bwd_checks(emb, w_in, mom_in, labels, gt, logz, topk, d_ce,
                                             d_neg, kw, LR, SGD)
    assert [c["name"] for c in bwd + fused] == [
        "d_emb (grad_w=False)", "d_emb (grad_w=True)", "d_w (label rows)", "d_w (other rows)",
        "fused d_emb", "mom' (label rows)", "mom' (other rows)", "w' (label rows)",
        "w' (other rows)"]
    assert not parity.failures(bwd + fused)
    torch.testing.assert_close(w_in, runs["plain"][0], rtol=0, atol=0)


SOFTMAX_CASES = [("Arc", 128, 5000, 512, 1, 0.0), ("AM", 64, 3001, 128, 3, 0.3),
                 ("SV", 8, 700, 64, 3, 0.3), ("Arc", 128, 40000, 512, 16, 0.2),
                 ("Arc", 100, 3002, 192, 3, 0.3), ("SV", 37, 777, 320, 16, 0.5),
                 # above 128 rows: the forward's row groups (the last ragged),
                 # the f32 d_emb pass and the d_w pass in row groups
                 ("Arc", 200, 5001, 512, 3, 0.3), ("SV", 512, 20000, 512, 1, 0.0),
                 ("AM", 300, 3001, 64, 3, 0.2)]


SGD = dict(momentum=0.9, nesterov=True, weight_decay=1e-4)
LR = 0.1
NO_MARGIN_LAUNCH = dict.fromkeys(tms.LAUNCH_COUNTS, 0)


@pytest.mark.gpu
@pytest.mark.parametrize("loss_type,b,c,d,k,frac_outlier", SOFTMAX_CASES)
def test_softmax_kernels_match_plain(loss_type, b, c, d, k, frac_outlier):
    dev = _cuda()
    emb, w, mom, labels, d_ce, d_neg = make_softmax_case(0, b, c, d, k, frac_outlier, dev)
    kw = dict(loss_type=loss_type, margin=0.5, scale=32.0, k=k, mask_svfc=1.2)
    gt = tms.compute_gt(emb, w, labels)
    tms.reset_launch_counts()
    got = tms.margin_ce_fwd(emb, w, labels, gt, **kw)
    want = tms.margin_ce_fwd_plain(emb, w, labels, gt, **kw)
    for name, g, wn, tol in zip(("ce", "neg", "logz", "topk"), got, want,
                                (1e-4, 1e-4, 1e-4, 1e-5)):
        np.testing.assert_allclose(g.cpu().numpy(), wn.cpu().numpy(), atol=tol, err_msg=name)
    logz, topk = want[2], want[3]
    bwd, fused = parity.margin_ce_bwd_checks(emb, w, mom, labels, gt, logz, topk, d_ce, d_neg,
                                             kw, LR, SGD)
    checks = bwd + fused
    assert not parity.failures(checks), [parity.describe(c) for c in parity.failures(checks)]
    assert tms.LAUNCH_COUNTS == dict(NO_MARGIN_LAUNCH, margin_ce_fwd=1, margin_ce_bwd=2,
                                     margin_ce_bwd_fused_sgd=1)


BF16_PAIRS = {"bf16,bf16": (torch.bfloat16, torch.bfloat16),
              "bf16,f32": (torch.bfloat16, torch.float32),
              "f32,bf16": (torch.float32, torch.bfloat16)}


@pytest.mark.gpu
@pytest.mark.parametrize("pair", list(BF16_PAIRS))
@pytest.mark.parametrize("loss_type,k,frac_outlier", [("Arc", 1, 0.0), ("SV", 3, 0.3)])
def test_bf16_softmax_kernels_match_plain(pair, loss_type, k, frac_outlier):
    """The bf16 classifier's forms (B = 128, D = 512, C = 5000) against their
    plain versions with the bf16 checks of utils/parity.py: the forward, the
    backward, the fused kernel in the (w, mom) pair, and route D's forward
    statistics and sparse backward; each launch counted under its form."""
    _bf16_softmax_case(pair, loss_type, k, frac_outlier, 128, 5000)


@pytest.mark.gpu
@pytest.mark.parametrize("pair", list(BF16_PAIRS))
@pytest.mark.parametrize("b,c", [(200, 5001), (512, 20000)])
def test_bf16_softmax_kernels_above_128_rows(pair, b, c):
    """``test_bf16_softmax_kernels_match_plain`` above 128 batch rows (the
    forward's and the d_w pass's row groups, the last one ragged at B =
    200; the d_emb pass's 64-row groups), Arc with outliers, k = 3."""
    _bf16_softmax_case(pair, "Arc", 3, 0.3, b, c)


def _bf16_softmax_case(pair, loss_type, k, frac_outlier, b, c):
    dev = _cuda()
    w_dt, m_dt = BF16_PAIRS[pair]
    emb, w, mom, labels, d_ce, d_neg = make_softmax_case(1, b, c, 512, k, frac_outlier, dev)
    w, mom = w.to(w_dt), mom.to(m_dt)
    kw = dict(loss_type=loss_type, margin=0.5, scale=32.0, k=k, mask_svfc=1.2)
    gt = tms.compute_gt(emb, w, labels)
    tms.reset_launch_counts()
    got = tms.margin_ce_fwd(emb, w, labels, gt, **kw)
    want = tms.margin_ce_fwd_plain(emb, w, labels, gt, **kw)
    checks = parity.rounded_fwd_checks(got, want) if w_dt == torch.bfloat16 else []
    bwd, fused = parity.margin_ce_bwd_checks(emb, w, mom, labels, gt, want[2], want[3], d_ce,
                                             d_neg, kw, LR, SGD)
    checks += bwd + fused
    if w_dt == torch.bfloat16:
        n_tiles = -(-c // 512)
        u = torch.rand((n_tiles,), generator=torch.Generator(device=dev).manual_seed(0),
                       device=dev)
        checks += parity.sparse_path_checks(emb, w, labels, d_ce, d_neg, kw, 512,
                                            min(8 * (n_tiles // 10), n_tiles), u)[0]
    assert not parity.failures(checks), [parity.describe(c) for c in parity.failures(checks)]
    assert tms.LAUNCH_COUNTS[f"margin_ce_bwd_fused_sgd[{pair}]"] == 1
    if w_dt == torch.bfloat16:
        assert tms.LAUNCH_COUNTS["margin_ce_fwd[bf16]"] == 2
        assert tms.LAUNCH_COUNTS["margin_ce_bwd_sparse[bf16]"] == 2
        assert not any(tms.LAUNCH_COUNTS[name] for name in tms.KERNELS)  # no f32 form


def _build_faulty(tmp_path, faults, source="margin_ce"):
    """{"real": the built library of ``csrc/<source>.cu``, name: a copy
    built with that fault's source edit, an (old, new) pair or a tuple of
    them} — the copies compiled in parallel into tmp_path."""
    from vlsfr_tpu_torch.ops import cuda_build

    src = (cuda_build.CSRC / f"{source}.cu").read_text()
    procs = {}
    for name, spec in faults.items():
        edited = src
        for old, new in (spec if isinstance(spec[0], tuple) else (spec,)):
            assert src.count(old) == 1, name
            edited = edited.replace(old, new)
        out = tmp_path / name
        out.mkdir()
        shutil.copy(cuda_build.CSRC / "margin_common.cuh", out)
        (out / f"{source}.cu").write_text(edited)
        procs[name] = cuda_build.start_nvcc(out / f"{source}.cu", out / f"lib{source}.so")
    libs = {"real": cuda_build.load_library(source)}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        assert proc.returncode == 0, log
        libs[name] = ctypes.CDLL(str(tmp_path / name / f"lib{source}.so"))
    return libs


# source edits that break the f32 pass (margin_bwd_f32_kernel): each must
# fail the checks above
PLANTED_FAULTS = {
    "no_weight_decay": ("if (sgd.wd != 0.f) g[e] += sgd.wd * wv[e];", ""),
    "d_w_x1.1": ("acc3[i][4 * h + e] = acc3[i][4 * h + e] - wv[e] * iv * (iv * sd);",
                 "acc3[i][4 * h + e] = 1.1f * (acc3[i][4 * h + e] - wv[e] * iv * (iv * sd));"),
    # the d_emb partial of a tile read as 0: every tile but the last dropped
    "d_emb_partial_not_read": ("const float4 v = first || r >= a.B || f >= D",
                               "const float4 v = true || r >= a.B || f >= D"),
}


@pytest.mark.gpu
def test_softmax_checks_reject_planted_faults(tmp_path, monkeypatch):
    """At chip_smoke.py's full width (B = 128, D = 512, C = 2^20, Arc, k = 1,
    a 0.01·N(0, 1) classifier and momentum, a repeated label), the checks
    pass the real kernels and fail a margin_ce.cu built without weight decay
    and one whose d_w is 1.1× too large, on the rows the kernel computes
    alone, and one that drops the block's d_emb partial of every tile but
    its last (every d_emb check). Prints each reading, and for d_w and mom' the error and
    limit of an all-rows check (1e-4 × max|d_w|, 1e-4 × max|mom'| over
    every row) for comparison."""
    from vlsfr_tpu_torch.ops import cuda_build

    dev = _cuda()
    libs = _build_faulty(tmp_path, PLANTED_FAULTS)

    b, c, d = 128, 1 << 20, 512
    gen = torch.Generator(device=dev).manual_seed(2)
    emb = torch.randn((b, d), generator=gen, device=dev)
    emb /= torch.linalg.vector_norm(emb, dim=-1, keepdim=True)
    w0 = torch.randn((c, d), generator=gen, device=dev).mul_(0.01)
    mom0 = torch.randn((c, d), generator=gen, device=dev).mul_(0.01)
    labels = torch.randint(0, c, (b,), generator=gen, device=dev, dtype=torch.int32)
    labels[1] = labels[0]
    d_ce, d_neg = torch.full((b,), 1.0 / b, device=dev), torch.zeros((b,), device=dev)
    kw = dict(loss_type="Arc", margin=0.5, scale=32.0, k=1, mask_svfc=1.2)
    gt = tms.compute_gt(emb, w0, labels)
    _, _, logz, topk = tms.margin_ce_fwd_plain(emb, w0, labels, gt, **kw)

    failed = {}
    for name, lib in libs.items():
        monkeypatch.setitem(cuda_build._LOADED, "margin_ce", lib)
        w, mom = w0.clone(), mom0.clone()
        bwd, fused = parity.margin_ce_bwd_checks(emb, w, mom, labels, gt, logz, topk, d_ce,
                                                 d_neg, kw, LR, SGD)
        checks = bwd + fused
        for ch in checks:
            print(f"{name}: {parity.describe(ch)}")
        for what, key in (("d_w", "ref_max"), ("mom'", "want_max")):
            sets = [ch for ch in checks if ch["name"].startswith(what + " (")]
            err = max(ch["err"] for ch in sets)
            limit = 1e-4 * max(ch[key] for ch in sets)
            print(f"{name}: {what} (all rows): max |kernel - plain| {err:.3e}, all-rows limit "
                  f"{limit:.3e}: {'passes' if err <= limit else 'fails'}")
        failed[name] = {ch["name"] for ch in parity.failures(checks)}
        del w, mom
    print({name: sorted(f) for name, f in failed.items()})
    assert failed["real"] == set()
    assert {"w' (other rows)", "mom' (other rows)"} <= failed["no_weight_decay"]
    assert {"d_w (other rows)", "w' (other rows)", "mom' (other rows)"} <= failed["d_w_x1.1"]
    assert {"d_emb (grad_w=False)", "d_emb (grad_w=True)", "fused d_emb"} <= failed[
        "d_emb_partial_not_read"]


# source edits of the bf16 form's tensor-core staging and d_w epilogue
# (csrc/margin_ce.cu): each must fail the bf16 backward's checks
BF16_BWD_FAULTS = {
    # the W operand cut toward zero instead of rounded to nearest
    "truncates_operand": ("h = __floats2bfloat162_rn(f.x * s, f.y * s);",
                          "h = __halves2bfloat162(__float2bfloat16_rz(f.x * s), "
                          "__float2bfloat16_rz(f.y * s));"),
    # the stored row as the operand, its 1/||w|| applied to the products
    "rounds_stored_row_then_scales": (
        ("h = __floats2bfloat162_rn(f.x * s, f.y * s);", "h = __floats2bfloat162_rn(f.x, f.y);"),
        ("? dcos_of(acc1[0][ni][2 * h + j], p0 + c + j,",
         "? dcos_of(acc1[0][ni][2 * h + j] * inv[c + j], p0 + c + j,"),
        ("*reinterpret_cast<__nv_bfloat162*>(Dq + swz(lr, c, E_TC / 8)) =\n"
         "            __floats2bfloat162_rn(d[0], d[1]);",
         "*reinterpret_cast<__nv_bfloat162*>(Dq + swz(lr, c, E_TC / 8)) =\n"
         "            __floats2bfloat162_rn(d[0] * inv[c], d[1] * inv[c + 1]);"),
        ("? dcos_of(acc[mi][ni][2 * h + j], p0 + c + j,",
         "? dcos_of(acc[mi][ni][2 * h + j] * inv[c + j], p0 + c + j,")),
    # <d_w_hat, w_hat> against the rounded w_hat
    "rounded_w_hat_in_projection": (
        "s = fmaf(dwh[mi][j][2 * h], wf.x * iv, s);\n"
        "          s = fmaf(dwh[mi][j][2 * h + 1], wf.y * iv, s);",
        "s = fmaf(dwh[mi][j][2 * h], __bfloat162float(__float2bfloat16_rn(wf.x * iv)), s);\n"
        "          s = fmaf(dwh[mi][j][2 * h + 1], "
        "__bfloat162float(__float2bfloat16_rn(wf.y * iv)), s);"),
}


@pytest.mark.gpu
def test_bf16_backward_checks_reject_planted_faults(tmp_path, monkeypatch):
    """At B = 128, D = 512, C = 2^17 (Arc, k = 1) the bf16 backward's checks
    (``parity.margin_ce_bwd_checks``) pass the real tensor-core passes and
    fail copies of margin_ce.cu that truncate the W operand and that take
    the stored row as the operand and scale the products (in the cosines
    against the plain version's: the checks' references run on the
    library's own cosines), and one that takes <d_w_hat, w_hat> against the
    rounded w_hat (in d_w alone)."""
    from vlsfr_tpu_torch.ops import cuda_build

    dev = _cuda()
    libs = _build_faulty(tmp_path, BF16_BWD_FAULTS)
    emb, w, mom, labels, d_ce, d_neg = make_softmax_case(6, 128, 1 << 17, 512, 1, 0.0, dev)
    w, mom = w.bfloat16(), mom.bfloat16()
    kw = dict(loss_type="Arc", margin=0.5, scale=32.0, k=1, mask_svfc=1.2)
    gt = tms.compute_gt(emb, w, labels)
    _, _, logz, topk = tms.margin_ce_fwd_plain(emb, w, labels, gt, **kw)
    failed = {}
    for name, lib in libs.items():
        monkeypatch.setitem(cuda_build._LOADED, "margin_ce", lib)
        bwd, _ = parity.margin_ce_bwd_checks(emb, w, mom.clone(), labels, gt, logz, topk, d_ce,
                                             d_neg, kw, LR, SGD)
        for ch in bwd:
            print(f"{name}: {parity.describe(ch)}")
        failed[name] = {ch["name"] for ch in parity.failures(bwd)}
    print({name: sorted(f) for name, f in failed.items()})
    cos = "bf16 cos (kernel, forward tiles)"
    dw = "d_w (other rows) rows beyond 1e-05 x max"
    assert failed["real"] == set()
    for name in ("truncates_operand", "rounds_stored_row_then_scales"):
        assert cos in failed[name], name
    assert dw in failed["rounded_w_hat_in_projection"]
    assert not any(n.startswith(("d_emb", "bf16 cos")) for n in failed["rounded_w_hat_in_projection"])


# the fused cases of the bf16 d_w pass's fault test: at LR and a 0.01-scale
# momentum the gradient and wd·w of an unlabelled row fall below one bf16
# spacing of w and mom; with the momentum scaled down and a large lr they
# move w' and mom' on every row (chip_smoke.py's MOVING_MOM, MOVING_LR)
MOVING_MOM, MOVING_LR = 1e-4, 100.0
# source edits of the bf16 d_w pass's sparse and fused modes
# (csrc/margin_ce.cu: margin_bwd_dw_bf16_kernel): each must fail the checks
BF16_DW_FAULTS = {
    # the d_w pass's tile map one selected tile off (the d_emb pass's is right)
    "tile_map_off_by_one": ("    p0 = phys_col(a, t0);\n    nl =",
                            "    p0 = phys_col(a, t0) + a.sel_tile;\n    nl ="),
    # the sparse form without the label rows' d_wl
    "sparse_drops_dwl": ("if (any_tgt) add_dwl(mi, h, 0);",
                         "if (any_tgt && MODE != DW_SPARSE) add_dwl(mi, h, 0);"),
    # the fused form leaves mom as it was
    "fused_mom_not_stored": ("            store2(mom + off, mn);\n", ""),
    # the fused form without the weight decay
    "fused_no_weight_decay": (
        "if (sgd.wd != 0.f) gv = make_float2(gv.x + sgd.wd * wf.x, gv.y + sgd.wd * wf.y);", ""),
}


@pytest.mark.gpu
def test_bf16_dw_checks_reject_planted_faults(tmp_path, monkeypatch):
    """At chip_smoke.py's full width (B = 128, D = 512, C = 2^20, Arc, k =
    1, a repeated label; a bf16 classifier and momentum, the momentum ×
    MOVING_MOM at lr MOVING_LR) the checks of the bf16 d_w pass's sparse
    form (route D's statistics and sparse backward: tile 512, M = 128) and
    fused form (``parity.margin_ce_bwd_checks``) pass the real kernel and
    fail copies of margin_ce.cu whose d_w pass maps its tiles one selected
    tile off or drops the label rows' d_wl on the sparse form, and leaves
    mom unwritten or drops the weight decay on the fused form."""
    from vlsfr_tpu_torch.ops import cuda_build

    dev = _cuda()
    libs = _build_faulty(tmp_path, BF16_DW_FAULTS)
    emb, w, mom, labels, d_ce, d_neg = make_softmax_case(2, 128, 1 << 20, 512, 1, 0.0, dev)
    w, mom = w.bfloat16(), (mom * MOVING_MOM).bfloat16()
    kw = dict(loss_type="Arc", margin=0.5, scale=32.0, k=1, mask_svfc=1.2)
    gt = tms.compute_gt(emb, w, labels)
    _, _, logz, topk = tms.margin_ce_fwd_plain(emb, w, labels, gt, **kw)
    failed = {}
    for name, lib in libs.items():
        monkeypatch.setitem(cuda_build._LOADED, "margin_ce", lib)
        checks = _stats_and_sparse_checks(emb, w, labels, d_ce, d_neg, kw, 512)
        bwd, fused = parity.margin_ce_bwd_checks(emb, w.clone(), mom.clone(), labels, gt, logz,
                                                 topk, d_ce, d_neg, kw, MOVING_LR, SGD)
        checks += bwd + fused
        for ch in checks:
            print(f"{name}: {parity.describe(ch)}")
        failed[name] = {ch["name"] for ch in parity.failures(checks)}
    print({name: sorted(f) for name, f in failed.items()})
    assert failed["real"] == set()
    for name, prefixes in (("tile_map_off_by_one", ("sparse d_w (other rows)",)),
                           ("sparse_drops_dwl", ("sparse d_w (label rows)",)),
                           ("fused_mom_not_stored", ("mom'",)),
                           ("fused_no_weight_decay", ("w'", "mom'"))):
        assert any(n.startswith(prefixes) for n in failed[name]), name
    # each fault is in one mode: the dense d_w of margin_ce_bwd stays right
    assert not any(n.startswith("d_w") for f in failed.values() for n in f)


@pytest.mark.parametrize("faults", ["PLANTED_FAULTS", "SPARSE_FAULTS", "BF16_BWD_FAULTS",
                                    "BF16_DW_FAULTS", "chip_smoke.BF16_FAULTS",
                                    "MARGIN_FWD_FAULTS", "ROW_GROUP_FAULTS"])
def test_planted_margin_faults_edit_the_kernel_source(faults):
    """Each planted fault of margin_ce.cu (the f32 pass's, the sparse
    form's, the bf16 backward's, the bf16 d_w pass's modes', chip_smoke.py's
    bf16 ones, the forward's and the d_w passes' row groups') is a source
    edit whose old text matches the
    source exactly once, so that the copy a ``gpu`` test or chip_smoke.py
    builds differs from the kernel where its name says."""
    import importlib.util
    from pathlib import Path

    from vlsfr_tpu_torch.ops import cuda_build

    if faults.startswith("chip_smoke."):
        spec = importlib.util.spec_from_file_location(
            "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        table = getattr(module, faults.split(".")[1])
    else:
        table = globals()[faults]
    src = (cuda_build.CSRC / "margin_ce.cu").read_text()
    for name, spec in table.items():
        for old, new in (spec if isinstance(spec[0], tuple) else (spec,)):
            assert src.count(old) == 1 and old != new, name


# source edits of the d_w passes' row groups (above 128 batch rows: the f32
# pass and the bf16 d_w pass, GROUPS) that the checks must reject at B = 512
ROW_GROUP_FAULTS = {
    # the f32 pass leaves out its last row group (d_w_hat, <d_w_hat, w_hat>
    # and the label rows' d_wl of its rows)
    "f32_last_group_dropped": ("  const int n_grp = GROUPS ? (a.B + FB_ROWS - 1) / FB_ROWS : 1;",
                               "  const int n_grp = GROUPS ? (a.B - 1) / FB_ROWS : 1;"),
    # ... each row group's d_cos merged into d_w_hat against another group's
    # emb rows (the groups' rows in reverse order)
    "f32_groups_out_of_order": ("a.emb,\n                                  rb + FB_EK * bk,",
                                "a.emb,\n                                  (n_grp - 1 - g) * FB_ROWS"
                                " + FB_EK * bk,"),
    # the bf16 d_w pass leaves out its last row group
    "bf16_last_group_dropped": ("  const int n_grp = GROUPS ? (a.B + WB_ROWS - 1) / WB_ROWS : 1;",
                                "  const int n_grp = GROUPS ? (a.B - 1) / WB_ROWS : 1;"),
    # ... each group's row inputs merged with another group's emb rows
    "bf16_groups_out_of_order": ("stage_rows_bf16(Es, a.eb, rb, nr, WB_ROWS, D);",
                                 "stage_rows_bf16(Es, a.eb, (n_grp - 1 - gi) * WB_ROWS, nr, "
                                 "WB_ROWS, D);"),
}


@pytest.mark.gpu
def test_row_group_checks_reject_planted_faults(tmp_path, monkeypatch):
    """At B = 512 (four row groups of the d_w passes), D = 256, C = 20,000,
    Arc, k = 1, a repeated label: ``parity.margin_ce_bwd_checks`` pass the
    real kernels and fail copies of margin_ce.cu whose d_w pass (the f32
    one for an f32 classifier, the bf16 one for a bf16 classifier and
    momentum) drops its last row group or merges each group's d_cos with
    another group's emb rows: d_w on the rows the kernel computes alone,
    and the fused update's w' and mom'. Prints each reading."""
    from vlsfr_tpu_torch.ops import cuda_build

    dev = _cuda()
    libs = _build_faulty(tmp_path, ROW_GROUP_FAULTS)
    emb, w0, mom0, labels, d_ce, d_neg = make_softmax_case(4, 512, 20000, 256, 1, 0.0, dev)
    kw = dict(loss_type="Arc", margin=0.5, scale=32.0, k=1, mask_svfc=1.2)
    failed = {}
    for dt in (torch.float32, torch.bfloat16):
        w_in, mom_in = w0.to(dt), mom0.to(dt)
        gt = tms.compute_gt(emb, w_in, labels)
        _, _, logz, topk = tms.margin_ce_fwd_plain(emb, w_in, labels, gt, **kw)
        for name, lib in libs.items():
            monkeypatch.setitem(cuda_build._LOADED, "margin_ce", lib)
            w, mom = w_in.clone(), mom_in.clone()
            bwd, fused = parity.margin_ce_bwd_checks(emb, w, mom, labels, gt, logz, topk, d_ce,
                                                     d_neg, kw, LR, SGD)
            torch.cuda.synchronize()
            for ch in bwd + fused:
                print(f"{name} {dt}: {parity.describe(ch)}")
            failed[name, dt] = {ch["name"] for ch in parity.failures(bwd + fused)}
    for dt, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        assert failed["real", dt] == set(), dt
        for fault in ("last_group_dropped", "groups_out_of_order"):
            assert any(n.startswith("d_w") for n in failed[f"{tag}_{fault}", dt]), (tag, fault)
            assert any(n.startswith("w'") for n in failed[f"{tag}_{fault}", dt]), (tag, fault)
        other = "bf16" if tag == "f32" else "f32"  # the other form's pass is not run
        for fault in ("last_group_dropped", "groups_out_of_order"):
            assert failed[f"{other}_{fault}", dt] == set(), (tag, fault)


# ----------------------------------------------------------------------
# the margin_ce forward (csrc/margin_ce.cu: margin_fwd_kernel)
# ----------------------------------------------------------------------

# source edits of the forward (margin_fwd_kernel, both W forms) that its
# checks (``parity.margin_fwd_checks``) must reject
MARGIN_FWD_FAULTS = {
    # the target column in the stream and the top-k
    "fwd_target_streamed": ("      for (int j = 0; j < 4; ++j) ok[h][j] = q + j < n && q + j != tgt;",
                            "      for (int j = 0; j < 4; ++j) ok[h][j] = q + j < n;"),
    # lane 1's top-k list dropped from its partial, so from the merge
    "fwd_lane_topk_dropped": ("  tk_store<0>(p + 2, ln.tk[0]);",
                              "  if (rp.lane != 0) tk_fill<0>(ln.tk[0], NEG_INF_F);\n"
                              "  tk_store<0>(p + 2, ln.tk[0]);"),
    # each lane's statistics half tile written one slot on
    "fwd_stats_slot_off": ("    const long long g = t0 / STAT_COLS + rp.lane;",
                           "    const long long g = t0 / STAT_COLS + rp.lane + 1;"),
    # the bf16 form's row pass streams the cosine, not scale times it
    "fwd_bf16_unscaled": ("  rp.zs = a.scale * LOG2E;", "  rp.zs = (BF16 ? 1.f : a.scale) * LOG2E;"),
}


def near_target_case(seed, b, c, d, k, frac_outlier, device="cpu"):
    """``make_softmax_case`` with eight labelled rows moved next to their
    target class row (cosine ~0.95), as a trained embedding sits: their
    target's z dominates the row's logsumexp."""
    emb, w, mom, labels, d_ce, d_neg = make_softmax_case(seed, b, c, d, k, frac_outlier, device)
    rows = torch.nonzero(labels >= 0).flatten()[2:10]
    gen = torch.Generator(device=device).manual_seed(seed)
    target = w[labels[rows].long()]
    target = target / torch.linalg.vector_norm(target, dim=-1, keepdim=True)
    near = target + 0.3 * torch.randn(target.shape, generator=gen, device=device) / d ** 0.5
    emb[rows] = near / torch.linalg.vector_norm(near, dim=-1, keepdim=True)
    return emb, w, mom, labels, d_ce, d_neg


@pytest.mark.parametrize("c", [4000, 1 << 20, 1_250_000])
@pytest.mark.parametrize("w_bf16", [False, True])
def test_margin_fwd_geometry_covers_the_classes_once(w_bf16, c):
    """The forward kernel's grid (``margin_stream.fwd_geometry``) on a
    132-SM card: one block an SM at most; its column ranges cover [0, C)
    exactly once in whole 128-column tiles (the statistics' 64-column half
    tiles never straddle two blocks); two partials a block; the block's
    shared memory within the 232,448 bytes a block may take and above the
    half that would let two blocks share an SM."""
    geo = tms.fwd_geometry(w_bf16, c, 132)
    per = geo.cols_per_blk
    assert per % 128 == 0 and 1 <= geo.nblk <= 132
    spans = [(i * per, min(c, (i + 1) * per)) for i in range(geo.nblk)]
    assert spans[0][0] == 0 and spans[-1][1] == c
    assert all(lo < hi for lo, hi in spans)
    assert all(a[1] == b_[0] for a, b_ in zip(spans, spans[1:]))
    assert geo.n_parts == 2 * geo.nblk
    assert 232448 // 2 < geo.smem <= 232448


@pytest.mark.parametrize("w_dtype", [torch.float32, torch.bfloat16])
def test_margin_fwd_checks_pass_the_plain_versions(w_dtype):
    """``parity.margin_fwd_checks`` on CPU tensors, where the wrappers run
    the plain versions: every check of the forward (without and with
    statistics, and the partial form) is there and passes, and none
    launches a kernel."""
    emb, w, _, labels, _, _ = near_target_case(8, 16, 700, 64, 3, 0.3)
    kw = dict(loss_type="Arc", margin=0.5, scale=32.0, k=3, mask_svfc=1.2)
    tms.reset_launch_counts()
    checks = parity.margin_fwd_checks(emb, w.to(w_dtype), labels, kw, tile=128)
    names = [c["name"] for c in checks]
    assert {"maxz", "maxcos", "partial m + log s", "partial top-k"} <= {
        n.split(": ")[-1] for n in names}
    assert len(names) == 14
    assert not parity.failures(checks)
    assert not any(tms.LAUNCH_COUNTS.values())


@pytest.mark.gpu
def test_margin_fwd_geometry_is_the_kernels():
    """``fwd_geometry``'s shared memory is what the forward kernel takes
    (``margin_fwd_smem``) for both W forms."""
    _cuda()
    lib = tms._lib()
    for w_bf16 in (False, True):
        assert lib.margin_fwd_smem(int(w_bf16)) == tms.fwd_geometry(w_bf16, 5000, 132).smem


@pytest.mark.gpu
def test_margin_fwd_checks_reject_planted_faults(tmp_path, monkeypatch):
    """``parity.margin_fwd_checks`` (the forward without and with
    statistics, and the partial form) pass the real kernel and fail copies
    of margin_ce.cu that stream the target column, drop one lane's top-k
    list, write each statistics half tile one slot on, and stream the bf16
    form's cosines unscaled, at B = 128, D = 512, C = 100,000 (a ragged last
    tile), Arc, k = 3 with outlier rows and eight rows next to their target,
    f32 and bf16 W. Prints each reading."""
    from vlsfr_tpu_torch.ops import cuda_build

    dev = _cuda()
    libs = _build_faulty(tmp_path, MARGIN_FWD_FAULTS)
    emb, w, _, labels, _, _ = near_target_case(9, 128, 100_000, 512, 3, 0.2, dev)
    kw = dict(loss_type="Arc", margin=0.5, scale=32.0, k=3, mask_svfc=1.2)
    failed = {}
    for form, ww in (("f32", w), ("bf16", w.bfloat16())):
        for name, lib in libs.items():
            monkeypatch.setitem(cuda_build._LOADED, "margin_ce", lib)
            checks = parity.margin_fwd_checks(emb, ww, labels, kw)
            torch.cuda.synchronize()
            for c in checks:
                print(f"{name} {form}: {parity.describe(c)}")
            failed[name, form] = {c["name"] for c in parity.failures(checks)}
    print({key: sorted(f) for key, f in failed.items()})
    topk = {"f32": "topk", "bf16": "top-k"}
    for form in ("f32", "bf16"):
        assert failed["real", form] == set()
        assert {"ce", "logz", "partial m + log s"} <= failed["fwd_target_streamed", form]
        assert {topk[form], "partial top-k"} <= failed["fwd_lane_topk_dropped", form]
        assert {"with statistics: maxz", "with statistics: maxcos"} <= failed[
            "fwd_stats_slot_off", form]
    assert {"ce", "logz"} <= failed["fwd_bf16_unscaled", "bf16"]
    assert failed["fwd_bf16_unscaled", "f32"] == set()


@pytest.mark.gpu
@pytest.mark.parametrize("b,c,d", [(100, 5000, 512), (37, 3002, 192), (128, 4136, 64),
                                   (200, 5000, 512), (512, 4136, 64)])
def test_bf16_backward_ragged_matches_plain(b, c, d):
    """The bf16 classifier's backward at B not a multiple of 16 and C not
    of 64 (D from 64 to 512; rows 0 and 1 share a label), against the plain
    versions with the bf16 checks. ``parity.margin_ce_bwd_checks``:
    margin_ce_bwd with and without d_w and the fused kernel with a bf16 and
    with an f32 momentum, after the cosines of every tiling bit for bit.
    The sparse backward: route D's pieces with every tile selected
    (``parity.sparse_path_checks``: tile 512, the last tile ragged), and
    over 128-column tiles in reverse order with one tile index past C
    (``parity.margin_ce_bwd_sparse_checks``: its rows 0). The class-sharded
    head over two ragged blocks (``parity.margin_shard_checks``: each
    block's partial kernels, then the blocks merged against the whole
    classifier, d_emb with the owners' tails included)."""
    dev = _cuda()
    emb, w, mom, labels, d_ce, d_neg = make_softmax_case(3, b, c, d, 3, 0.3, dev)
    w = w.bfloat16()
    kw = dict(loss_type="Arc", margin=0.5, scale=32.0, k=3, mask_svfc=1.2)
    gt = tms.compute_gt(emb, w, labels)
    want = tms.margin_ce_fwd_plain(emb, w, labels, gt, **kw)
    checks = parity.rounded_fwd_checks(tms.margin_ce_fwd(emb, w, labels, gt, **kw), want)
    for m_dt in (torch.bfloat16, torch.float32):
        bwd, fused = parity.margin_ce_bwd_checks(emb, w.clone(), mom.to(m_dt), labels, gt, want[2],
                                                 want[3], d_ce, d_neg, kw, LR, SGD)
        checks += [dict(ch, name=f"mom {m_dt}: {ch['name']}") for ch in bwd + fused]
    tile, n_tiles = tms.sparse_bwd_geometry(b, d, c)
    checks += parity.sparse_path_checks(emb, w, labels, d_ce, d_neg, kw, tile, n_tiles, None)[0]
    n128 = -(-c // 128)
    tile_idx = torch.arange(n128, -1, -1, dtype=torch.int32, device=dev)  # n128: past C
    sparse = parity.margin_ce_bwd_sparse_checks(emb, w, labels, gt, want[2], want[3], d_ce, d_neg,
                                                tile_idx, kw, 128)
    checks += [dict(ch, name=f"tile 128: {ch['name']}") for ch in sparse]
    _, d_w_rows = tms.margin_ce_bwd_sparse(emb, w, labels, gt, want[2], want[3], d_ce, d_neg,
                                           tile_idx, tile=128, **kw)
    checks.append({"name": "sparse d_w rows of the tile past C", "limit": 0.0,
                   "err": float(d_w_rows[:128].abs().max())})
    checks += parity.margin_shard_checks(emb, w, labels, d_ce, d_neg, kw, 2)[0]
    torch.cuda.synchronize()
    for ch in checks:
        print(parity.describe(ch))
    assert not parity.failures(checks), [parity.describe(c) for c in parity.failures(checks)]


@pytest.mark.gpu
@pytest.mark.parametrize("b,c,d", [(128, 5000, 512), (40, 777, 128), (100, 4096, 64),
                                   (512, 5000, 512), (200, 777, 128)])
def test_bf16_margin_cosines_match_between_tilings(b, c, d):
    """The bf16 classifier's cosines as the forward, the d_emb pass and
    the d_w pass (every bf16 backward form's) form them (``clean_cos``, all
    on the tensor cores): equal bit for bit, and within 1e-6 of the plain
    version (``parity.margin_cos_checks``)."""
    dev = _cuda()
    emb, w, *_ = make_softmax_case(4, b, c, d, 1, 0.0, dev)
    checks = parity.margin_cos_checks(emb, w.bfloat16())
    torch.cuda.synchronize()
    for ch in checks:
        print(parity.describe(ch))
    assert not parity.failures(checks), [parity.describe(c) for c in parity.failures(checks)]


@pytest.mark.gpu
@pytest.mark.parametrize("b,c,d", [(128, 5000, 512), (40, 777, 128), (100, 4096, 64),
                                   (100, 3002, 192), (512, 5000, 512), (200, 3002, 192)])
def test_f32_margin_cosines_match_between_tilings(b, c, d):
    """The f32 classifier's cosines as the forward (fdots_chunk, staged by
    cp.async) and the backward's one pass (ftile_dots; every f32 backward
    form runs it; above 128 rows its d_emb pass and its pass in row
    groups) form them (``clean_cos``): equal bit for bit, and within 1e-5
    of the plain version (``parity.margin_cos_checks``)."""
    dev = _cuda()
    emb, w, *_ = make_softmax_case(4, b, c, d, 1, 0.0, dev)
    checks = parity.margin_cos_checks(emb, w)
    torch.cuda.synchronize()
    for ch in checks:
        print(parity.describe(ch))
    assert len(checks) == (2 if b <= 128 else 3)
    assert not parity.failures(checks), [parity.describe(c) for c in parity.failures(checks)]


@pytest.mark.gpu
def test_margin_softmax_autograd_on_card_matches_cpu():
    dev = _cuda()
    emb, w, _, labels, _, _ = make_softmax_case(5, 32, 3000, 128, 3, 0.3, dev)
    mk = dict(loss_type="Arc", margin=0.5, scale=32.0, hard_neg=3)
    outs = []
    for device in (dev, torch.device("cpu")):
        e = emb.to(device).clone().requires_grad_(True)
        ww = w.to(device).clone().requires_grad_(True)
        tms.reset_launch_counts()
        loss = tms.fused_add_margin(e, ww, labels.to(device), **mk)
        loss.backward()
        outs.append((float(loss.detach()), e.grad.cpu(), ww.grad.cpu(), dict(tms.LAUNCH_COUNTS)))
    (lk, ek, wk, ck), (lp, ep, wp, cp) = outs
    assert ck == dict(NO_MARGIN_LAUNCH, margin_ce_fwd=1, margin_ce_bwd=1)
    assert not any(cp.values())
    np.testing.assert_allclose(lk, lp, rtol=1e-5)
    np.testing.assert_allclose(ek.numpy(), ep.numpy(), atol=1e-4 * float(ep.abs().max()))
    np.testing.assert_allclose(wk.numpy(), wp.numpy(), atol=1e-4 * float(wp.abs().max()))


def test_sparse_row_set_checks_catch_a_fault_on_the_other_rows():
    """The sparse layout's label rows (``parity.sparse_label_rows``): the
    row-set checks pass the plain d_w rows against themselves and fail
    rows that take 1.1 × the streamed d_w off the label rows, naming
    those rows. The plain version stands in for the kernel."""
    emb, w, _, labels, d_ce, d_neg = make_softmax_case(7, 8, 600, 32, 1, 0.0)
    labels[3] = 590  # a label in the ragged last tile (600 = 9·64 + 24)
    kw = dict(loss_type="Arc", margin=0.5, scale=32.0, k=1, mask_svfc=1.2)
    gt = tms.compute_gt(emb, w, labels)
    _, _, logz, topk, maxz, maxcos = tms.margin_ce_fwd_plain(emb, w, labels, gt, with_stats=True,
                                                             tile=64, **kw)
    tile_idx, _ = tms.select_relevant_tiles(maxz, maxcos, logz, topk, labels, 8, 64)
    _, dw, _ = tms._sparse_parts_plain(emb, w, labels, gt, logz, topk, d_ce, d_neg, tile_idx,
                                       tile=64, **kw)
    is_label = parity.sparse_label_rows(labels, tile_idx, 64)
    assert int(is_label.sum()) == len(set(labels.tolist()))  # every target tile is selected
    bad = torch.where(is_label[:, None], dw, 1.1 * dw)
    assert not parity.failures(parity.by_rows("d_w", dw.clone(), dw, dw, labels, 1e-4,
                                              is_label=is_label))
    failed = parity.failures(parity.by_rows("d_w", bad, dw, dw, labels, 1e-4, is_label=is_label))
    assert [c["name"] for c in failed] == ["d_w (other rows)"]


SPARSE_CASES = [("Arc", 128, 1 << 20, 512, 1, 0.0, 512), ("AM", 64, 3001, 128, 3, 0.3, 128),
                ("SV", 8, 700, 64, 3, 0.3, 64), ("Arc", 128, 40000, 512, 16, 0.2, 512),
                ("Arc", 100, 4000, 192, 3, 0.3, 192),
                ("Arc", 200, 40000, 512, 3, 0.3, 512), ("SV", 512, 20000, 256, 1, 0.0, 256)]


def _stats_and_sparse_checks(emb, w, labels, d_ce, d_neg, kw, tile, seed=0):
    """``parity.sparse_path_checks`` with M = max(n_tiles / 16, B) tiles
    and a seeded random fill."""
    n_tiles = -(-w.shape[0] // tile)
    gen = torch.Generator(device=emb.device).manual_seed(seed)
    u = torch.rand((n_tiles,), generator=gen, device=emb.device)
    m = min(n_tiles, max(n_tiles // 16, emb.shape[0]))
    return parity.sparse_path_checks(emb, w, labels, d_ce, d_neg, kw, tile, m, u)[0]


@pytest.mark.gpu
@pytest.mark.parametrize("loss_type,b,c,d,k,frac_outlier,tile", SPARSE_CASES)
def test_stats_and_sparse_kernels_match_plain(loss_type, b, c, d, k, frac_outlier, tile):
    dev = _cuda()
    emb, w, _, labels, d_ce, d_neg = make_softmax_case(0, b, c, d, k, frac_outlier, dev)
    kw = dict(loss_type=loss_type, margin=0.5, scale=32.0, k=k, mask_svfc=1.2)
    tms.reset_launch_counts()
    checks = _stats_and_sparse_checks(emb, w, labels, d_ce, d_neg, kw, tile)
    torch.cuda.synchronize()
    for ch in checks:
        print(parity.describe(ch))
    assert not parity.failures(checks), [parity.describe(c) for c in parity.failures(checks)]
    # the sparse kernel runs twice: through the wrapper, and for its parts
    assert tms.LAUNCH_COUNTS == dict(NO_MARGIN_LAUNCH, margin_ce_fwd=1, margin_ce_bwd_sparse=2)


# source edits that break the sparse backward: each must fail the checks above
SPARSE_FAULTS = {
    "no_dwl_add": ("acc3[i][4 * h + e] += dwl[(long long)(rb + b) * D + f + e];",
                   "acc3[i][4 * h + e] += 0.f;"),
    "tile_off_by_one": (
        "return a.sel == nullptr ? l : (long long)a.sel[l / a.sel_tile] * a.sel_tile + l % "
        "a.sel_tile;",
        "return a.sel == nullptr ? l : (long long)(a.sel[l / a.sel_tile] + 1) * a.sel_tile + l % "
        "a.sel_tile;"),
}


@pytest.mark.gpu
def test_sparse_checks_reject_planted_faults(tmp_path, monkeypatch):
    """At chip_smoke.py's full width (B = 128, D = 512, C = 2^20, tile 512,
    M = 128, Arc, k = 1, a repeated label) the checks pass the real kernel
    and fail a margin_ce.cu whose d_w pass drops the label rows' d_wl and
    one whose tile indirection is off by one tile."""
    from vlsfr_tpu_torch.ops import cuda_build

    dev = _cuda()
    libs = _build_faulty(tmp_path, SPARSE_FAULTS)
    emb, w, _, labels, d_ce, d_neg = make_softmax_case(2, 128, 1 << 20, 512, 1, 0.0, dev)
    kw = dict(loss_type="Arc", margin=0.5, scale=32.0, k=1, mask_svfc=1.2)
    failed = {}
    for name, lib in libs.items():
        monkeypatch.setitem(cuda_build._LOADED, "margin_ce", lib)
        checks = _stats_and_sparse_checks(emb, w, labels, d_ce, d_neg, kw, 512)
        for ch in checks:
            print(f"{name}: {parity.describe(ch)}")
        failed[name] = {ch["name"] for ch in parity.failures(checks)}
    print({name: sorted(f) for name, f in failed.items()})
    assert failed["real"] == set()
    assert "sparse d_w (label rows)" in failed["no_dwl_add"]
    assert {"sparse d_w (other rows)", "sparse d_emb",
            "sparse d_emb (streamed)"} <= failed["tile_off_by_one"]


# ----------------------------------------------------------------------
# the softmax head's partial kernels (the class-sharded head)
# ----------------------------------------------------------------------


def make_class_shard_case(seed, b, c, d, k, frac_outlier, n_shards, device="cpu"):
    """``make_softmax_case`` with the targets spread so that every one of
    ``n_shards`` blocks owns some (rows 0 and 1 one class in block 0) and
    every block sees rows owned elsewhere (−2 there)."""
    emb, w, mom, labels, d_ce, d_neg = make_softmax_case(seed, b, c, d, k, frac_outlier, device)
    cl = c // n_shards
    spread = torch.arange(n_shards, dtype=torch.int32, device=labels.device) * cl + cl // 3
    labels[2:2 + n_shards] = spread
    pos = labels >= 0
    d_ce, d_neg = torch.where(pos, 1.0 / b, 0.0), torch.where(pos, 0.0, 1.0 / b)
    return emb, w, mom, labels, d_ce, d_neg


@pytest.mark.parametrize("loss_type,k,frac_outlier", [("Arc", 1, 0.0), ("AM", 3, 0.3),
                                                      ("SV", 3, 0.3)])
def test_emulated_class_shards_match_the_whole_classifier_cpu(loss_type, k, frac_outlier):
    """On the CPU (plain versions): the classifier cut into 4 blocks, merged
    as the collectives merge them, equals the single-device head on the
    whole classifier — the check chip_smoke.py makes on the card at full
    width."""
    emb, w, _, labels, d_ce, d_neg = make_class_shard_case(8, 16, 4000, 32, k, frac_outlier, 4)
    kw = dict(loss_type=loss_type, margin=0.5, scale=32.0, k=k, mask_svfc=1.2)
    tms.reset_launch_counts()
    checks, _ = parity.margin_shard_checks(emb, w, labels, d_ce, d_neg, kw, n_shards=4)
    assert not parity.failures(checks), [parity.describe(c) for c in parity.failures(checks)]
    assert not any(tms.LAUNCH_COUNTS.values())


CLASS_SHARD_CASES = [("Arc", 128, 40000, 512, 1, 0.0, 4), ("Arc", 128, 40000, 512, 16, 0.2, 1),
                     ("AM", 64, 3000, 128, 3, 0.3, 4), ("SV", 8, 700, 64, 3, 0.3, 4),
                     ("Arc", 128, 1_000_000, 512, 1, 0.0, 4), ("Arc", 100, 5002, 192, 3, 0.3, 2),
                     ("Arc", 512, 40000, 512, 3, 0.2, 4), ("SV", 200, 5002, 192, 3, 0.3, 2)]


@pytest.mark.gpu
@pytest.mark.parametrize("loss_type,b,c,d,k,frac_outlier,n_shards", CLASS_SHARD_CASES)
def test_partial_margin_kernels_and_merge_match_plain_and_whole(loss_type, b, c, d, k,
                                                                frac_outlier, n_shards):
    """``margin_partial_fwd`` / ``_bwd`` against their plain versions on
    each block (ragged last tiles: 10,000, 750, 175 and 250,000 columns),
    and the blocks merged against margin_ce_fwd / margin_ce_bwd on the whole
    classifier."""
    dev = _cuda()
    emb, w, _, labels, d_ce, d_neg = make_class_shard_case(9, b, c, d, k, frac_outlier, n_shards,
                                                           dev)
    kw = dict(loss_type=loss_type, margin=0.5, scale=32.0, k=k, mask_svfc=1.2)
    tms.reset_launch_counts()
    checks, _ = parity.margin_shard_checks(emb, w, labels, d_ce, d_neg, kw, n_shards=n_shards)
    torch.cuda.synchronize()
    for c_ in checks:
        print(parity.describe(c_))
    assert not parity.failures(checks), [parity.describe(c) for c in parity.failures(checks)]
    assert tms.LAUNCH_COUNTS == dict(NO_MARGIN_LAUNCH, margin_ce_fwd=1, margin_ce_bwd=1,
                                     margin_partial_fwd=2 * n_shards,  # merge input + checks
                                     margin_partial_bwd=n_shards)


@pytest.mark.gpu
@pytest.mark.parametrize("loss_type", ["Arc", "SV"])
def test_pos_rows_kernels_with_minus2_rows_on_every_block(loss_type):
    """Each of 4 blocks with its block-local labels (−2 rows on every
    block), the merged global gt / logz / top-k and the global positive
    rows as ``pos_rows``: margin_ce_bwd (both grad_w) and the fused-SGD
    kernel against their plain versions (route A's and route D's exact
    d_emb), and route D's forward with statistics, selection and sparse
    backward."""
    from vlsfr_tpu_torch.parallel._shard_common import localize_labels

    dev = _cuda()
    b, c, d, n = 128, 40000, 512, 4
    emb, w, mom, labels, d_ce, d_neg = make_class_shard_case(10, b, c, d, 1, 0.0, n, dev)
    kw = dict(loss_type=loss_type, margin=0.5, scale=32.0, k=1, mask_svfc=1.2)
    _, (gt, logz, topk) = parity.margin_shard_checks(emb, w, labels, d_ce, d_neg, kw, n_shards=n)
    pos = labels >= 0
    cl = c // n
    for j in range(n):
        ll, _ = localize_labels(j * cl, cl, labels)
        assert (ll == -2).any() and (ll >= 0).any()
        blk = w[j * cl:(j + 1) * cl].clone()
        bwd, fused = parity.margin_ce_bwd_checks(emb, blk, mom[j * cl:(j + 1) * cl].clone(), ll,
                                                 gt, logz, topk, d_ce, d_neg, kw, LR, SGD,
                                                 pos_rows=pos)
        tile, n_tiles = tms.sparse_bwd_geometry(b, d, cl)
        u = torch.rand((n_tiles,), generator=torch.Generator(device=dev).manual_seed(j),
                       device=dev)
        sparse, _, _ = parity.sparse_path_checks(emb, w[j * cl:(j + 1) * cl], ll, d_ce, d_neg,
                                                 kw, tile, tms.sparse_m_tiles(0.25, n_tiles, b),
                                                 u, pos_rows=pos, gt=gt)
        torch.cuda.synchronize()
        checks = bwd + fused + sparse
        for c_ in checks:
            print(f"block {j}: {parity.describe(c_)}")
        assert not parity.failures(checks), [parity.describe(c) for c in parity.failures(checks)]


# ----------------------------------------------------------------------
# the quad kernels' bf16, int8 and int8-compute forms
# ----------------------------------------------------------------------

FORMS = ("bf16", "int8", "int8c")


@pytest.mark.parametrize("form", FORMS)
def test_form_plain_versions_are_chunk_invariant(form):
    """The rounded forms' plain versions over chunks of 64 and of 1024
    columns (the backward's rounding follows the rounding tile, whatever
    the chunk)."""
    queue, packed, kw, dce, dneg = make_packed(1, b=8, q=300, d=64, k=4, form=form)
    E, rest = packed[0], packed[1:]
    a = ttm.quad_fwd_plain(E, queue, *rest, chunk=64, **kw)
    b = ttm.quad_fwd_plain(E, queue, *rest, chunk=1024, **kw)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.numpy(), y.numpy(), atol=2e-5)
    kth = b[3][:, :, -1].contiguous()
    g1 = ttm.quad_bwd_plain(E, queue, *rest, b[2], kth, dce, dneg, chunk=64, **kw)
    g2 = ttm.quad_bwd_plain(E, queue, *rest, b[2], kth, dce, dneg, chunk=1024, **kw)
    for x, y in zip(g1, g2):
        np.testing.assert_allclose(x.numpy(), y.numpy(), atol=3e-5)


FORM_CASES = [(f, lt, b, q, d, k) for f in FORMS
              for lt, b, q, d, k in (("Arc", 64, 5000, 128, 10), ("SV", 64, 5000, 128, 10),
                                     ("AM", 128, 40000, 512, 16),
                                     ("Arc", 200, 5000, 512, 10), ("SV", 512, 20000, 256, 10))]


@pytest.mark.gpu
@pytest.mark.parametrize("form,loss_type,b,q,d,k", FORM_CASES)
def test_cuda_form_kernels_match_plain(form, loss_type, b, q, d, k):
    """Each form's quad_fwd / quad_bwd kernel against its plain version
    (limits in ``utils/parity.py``), and each launching its own counter."""
    dev = _cuda()
    queue, packed, kw, dce, dneg = make_packed(0, b, q, d, k, device=dev, loss_type=loss_type,
                                               form=form)
    ttm.reset_launch_counts()
    checks, _ = parity.quad_checks(queue, packed, kw, dce, dneg)
    if form == "int8c":
        checks += parity.int8_dot_checks(*kw["e8"], queue[0], kw["qscales"])
    torch.cuda.synchronize()
    for c in checks:
        print(form, parity.describe(c))
    assert not parity.failures(checks), [parity.describe(c) for c in parity.failures(checks)]
    assert ttm.LAUNCH_COUNTS[ttm.kernel_name("quad_fwd", form)] == 1
    assert ttm.LAUNCH_COUNTS[ttm.kernel_name("quad_bwd", form)] == 1
    assert sum(ttm.LAUNCH_COUNTS.values()) == 2


@pytest.mark.gpu
@pytest.mark.parametrize("form", FORMS)
def test_form_partial_kernels_and_merge_match_plain_and_whole(form):
    dev = _cuda()
    (ex, ey, queue, ga, gb, pa, pb, la, lb, dce, dneg) = make_shard_case(
        5, 64, 4096, 128, device=dev, n_shards=4)
    qs = None
    if form == "bf16":
        queue = queue.bfloat16()
    else:
        queue, qs = quantize_rows(queue)
    ttm.reset_launch_counts()
    checks = parity.quad_shard_checks(ex, ey, queue, ga, gb, pa, pb, la, lb, dce, dneg,
                                      shard_kw("Arc", k=10), n_shards=4, qscales=qs,
                                      int8_compute=form == "int8c")
    torch.cuda.synchronize()
    for c in checks:
        print(form, parity.describe(c))
    assert not parity.failures(checks), [parity.describe(c) for c in parity.failures(checks)]
    assert ttm.LAUNCH_COUNTS[ttm.kernel_name("quad_partial_fwd", form)] == 8
    assert ttm.LAUNCH_COUNTS[ttm.kernel_name("quad_partial_bwd", form)] == 4


@pytest.mark.parametrize("loss_type,b,q,d,k", [("Arc", 64, 5000, 128, 10),
                                               ("SV", 64, 5000, 128, 10),
                                               ("AM", 32, 3000, 64, 4)])
def test_rounded_demb_check_rejects_a_missing_rounding(loss_type, b, q, d, k):
    """``parity.rounded_demb`` on the plain versions: the bf16 form's d_emb
    against the same dots on an f32 queue holding the bf16 values (the
    probes and writes rounded as the bf16 form rounds them), where d_cos is
    never rounded. The count of rows beyond DEMB_TIGHT × max fails; the
    all-rows limit of 2^-7 × max alone would pass it."""
    queue, packed, kw, dce, dneg = make_packed(0, b, q, d, k, loss_type=loss_type, form="bf16")
    E, rest = packed[0], packed[1:]
    _, _, logz, topk = ttm.quad_fwd_plain(E, queue, *rest, **kw)
    kth = topk[:, :, -1].contiguous()
    d_round, _ = ttm.quad_bwd_plain(E, queue, *rest, logz, kth, dce, dneg, **kw)
    bf = lambda t: t.bfloat16().float()  # noqa: E731
    d_unround, _ = ttm.quad_bwd_plain(bf(E), queue.float(), bf(rest[0]), bf(rest[1]), *rest[2:],
                                      logz, kth, dce, dneg, **kw)
    count, every_row = parity.rounded_demb("d_emb", d_unround, d_round)
    assert count["err"] > 4 * count["limit"], parity.describe(count)
    assert every_row["err"] <= every_row["limit"], parity.describe(every_row)
    assert not parity.failures(parity.rounded_demb("d_emb", d_round.clone(), d_round))


# source edits of quad_margin.cu that the rounded forms' checks must reject
QUAD_FORM_FAULTS = {
    # clean tiles: d_cos not rounded to bf16 (the bf16 kernel's second
    # operand tile then carries what bf16 does not hold) or, on an int8
    # queue, rounded before the column scale (and again as the operand)
    "no_clean_dcos_rounding": ("dq = SCALED ? bf16r(d * sc) : bf16r(d);",
                               "dq = SCALED ? bf16r(d) * sc : d;"),
    # int8 queues, clean tiles: d_cos without q0's column scale
    "clean_dcos_unscaled": ("dq = SCALED ? bf16r(d * sc) : bf16r(d);", "dq = bf16r(d);"),
    # bf16 queue, written tiles: each view's d_cos not rounded
    "bf16_written_unrounded": ("d1 = bf16r(d1);\n      d2 = bf16r(d2);", "(void)0;"),
    # int8 staging: each row reads its first words again, in the int8c
    # forward's cp.async staging of the q0 tiles (each 128-feature chunk's
    # last 64 read as its first 64), the backward's (q0 tiles and E8) and
    # the int8 forward's register loads
    "int8_word_offset": (("const int f = 128 * kc + 16 * p;  // the piece's 16 features\n"
                          "        const bool ok = f < a.D && col < c_end;",
                          "const int f = 128 * kc + 16 * (p & 3);\n"
                          "        const bool ok = f < a.D && col < c_end;"),
                         ("ok ? X + (r0 + r) * D + 16 * c : X", "ok ? X + (r0 + r) * D : X"),
                         ("q0 + col * a.D + 64 * kc + 16 * (threadIdx.x & 3)",
                          "q0 + col * a.D + 16 * (threadIdx.x & 3)")),
}


@pytest.mark.gpu
def test_form_checks_reject_planted_faults(tmp_path, monkeypatch):
    """The rounded forms' checks (``parity.quad_checks`` with
    ``rounded_demb``, ``int8_dot_checks`` for int8c and ``int8_cos_checks``
    for int8) pass the real kernels and fail a quad_margin.cu that skips
    the clean tiles' bf16 rounding of d_cos (bf16) or rounds it before the
    column scale (int8 forms), one that leaves the column scale out of the
    clean tiles' d_cos (int8 forms), one that skips the bf16 written tiles'
    rounding (bf16), and one whose int8 staging reads the wrong words
    (int8c's dot, int8's cosines), at Arc, b = 64, Q = 5000, D = 128 and
    AM, b = 128, Q = 40000, D = 512, with the rounding tile at 64 columns
    (so that tiles are clean). Prints each reading. Not planted: Arc /
    AM's combined clean-tile d_cos replaced by the sum of the two views' —
    the same function up to f32 rounding, which no limit tells from another
    summation order; the CPU tests hold the plain version's form to the
    Pallas kernel's."""
    from vlsfr_tpu_torch.ops import cuda_build

    dev = _cuda()
    libs = _build_faulty(tmp_path, QUAD_FORM_FAULTS, source="quad_margin")
    failed = {}
    for form in FORMS:
        for lt, b, q, d, k in (("Arc", 64, 5000, 128, 10), ("AM", 128, 40000, 512, 16)):
            case = make_packed(3, b, q, d, k, device=dev, loss_type=lt, form=form)
            queue, kw = case[0], case[2]
            for name, lib in libs.items():
                monkeypatch.setitem(cuda_build._LOADED, "quad_margin", lib)
                checks, _ = parity.quad_checks(*case, tile=64)
                if form == "int8c":
                    checks += parity.int8_dot_checks(*kw["e8"], queue[0], kw["qscales"])
                if form == "int8":
                    checks += parity.int8_cos_checks(case[1][0], queue[0], kw["qscales"])
                torch.cuda.synchronize()
                for c in checks:
                    print(f"{name} {form} {lt}: {parity.describe(c)}")
                failed[name, form, lt] = {c["name"] for c in parity.failures(checks)}
    rows = f"d_emb rows beyond {parity.DEMB_TIGHT:g} x max"
    for form in FORMS:
        for lt in ("Arc", "AM"):
            assert failed["real", form, lt] == set()
            assert rows in failed["no_clean_dcos_rounding", form, lt]
    for lt in ("Arc", "AM"):
        assert failed["clean_dcos_unscaled", "bf16", lt] == set()  # no scale to leave out
        for form in ("int8", "int8c"):
            assert rows in failed["clean_dcos_unscaled", form, lt]
        assert rows in failed["bf16_written_unrounded", "bf16", lt]
        assert {"int8 raw dot (kernel, forward tiles)",
                "int8 raw dot (kernel, backward tiles)"} <= failed["int8_word_offset", "int8c", lt]
        assert {"int8 clean cos (kernel, forward tiles)",
                "int8 clean cos elements differing (backward vs forward tiles)"} <= failed[
                    "int8_word_offset", "int8", lt]


def _tie_columns(queue, E, r, k, avoid, qscales=None):
    """Copy the stored row that scores highest against probe row r (in both
    planes; an int8 plane 0's scales ``qscales`` with it) into k - 1 other
    slots outside ``avoid`` (written slots and targets): r's top-k then
    holds k equal cosines, each tied with its kth, where no write scores
    higher."""
    cos = ttm._bf16(E[r]) @ queue[0].float().T
    if qscales is not None:
        cos = cos * qscales
    free = torch.ones(queue.shape[1], dtype=torch.bool, device=queue.device)
    free[avoid[avoid >= 0].long()] = False
    j = int(torch.where(free, cos, -2.0).argmax())
    free[j] = False
    slots = torch.nonzero(free).flatten()[:k - 1]
    queue[:, slots] = queue[:, j:j + 1]
    if qscales is not None:
        qscales[slots] = qscales[j].clone()


@pytest.mark.gpu
@pytest.mark.parametrize("d", [128, 512])
def test_bf16_backward_edge_cases(d):
    """The bf16 form's tensor-core quad_fwd / quad_bwd against their plain
    versions (``parity.quad_checks``: the forward's limits and
    ``rounded_demb`` unchanged) with a duplicate slot, written tiles under
    a 512-column rounding tile (each view's d_cos rounded alone, both on
    q0's row as two bf16 terms) and an outlier row whose top-k holds k
    equal cosines, each tied with its kth; then the twin kernels on one
    direction of such a case, on the whole queue and as 4 blocks (targets
    inside and outside each block: labels -2 there)."""
    dev = _cuda()
    b, q, k = 64, 5000, 10
    queue, packed, kw, dce, dneg = make_packed(4, b, q, d, k, device=dev, form="bf16")
    _tie_columns(queue, packed[0], 2, k, torch.cat([packed[4], packed[6]]))  # row 2: outlier
    ttm.reset_launch_counts()
    checks, want = parity.quad_checks(queue, packed, kw, dce, dneg, tile=512)
    assert int((want[3][0, 2] == want[3][0, 2, -1]).sum()) >= k - 1  # the tie
    queue, inputs, tkw, tdce, tdneg, (t, _) = make_twin(5, b, q, d, k, device=dev, form="bf16")
    _tie_columns(queue, inputs[0], 2, k, torch.cat([inputs[4], inputs[6]]))
    twin, _ = parity.twin_checks(queue, inputs, tkw, tdce, tdneg, tile=512)
    checks += twin + parity.twin_shard_checks(t[0], queue, t[1], t[2:5], t[5], tdce, tdneg, tkw, 4)
    torch.cuda.synchronize()
    for c in checks:
        print(d, parity.describe(c))
    assert not parity.failures(checks), [parity.describe(c) for c in parity.failures(checks)]
    assert ttm.LAUNCH_COUNTS[ttm.kernel_name("quad_bwd", "bf16")] == 1
    assert ttm.LAUNCH_COUNTS[ttm.kernel_name("twin_bwd", "bf16")] >= 1
    assert ttm.LAUNCH_COUNTS[ttm.kernel_name("twin_partial_bwd", "bf16")] == 4


@pytest.mark.gpu
@pytest.mark.parametrize("r_,q,d", [(256, 5000, 512), (40, 777, 128), (128, 4096, 64),
                                    (1024, 5000, 512), (400, 777, 128)])
def test_bf16_clean_cosines_match_between_tilings(r_, q, d):
    """The bf16 form's clean cosines as the forward's tiles form them and as
    the backward's recompute does (``clean_cos``, both on the tensor
    cores): equal bit for bit, so that the backward's top-k test meets the
    forward's kth exactly; and within 1e-6 of the plain version
    (``parity.bf16_cos_checks``)."""
    dev = _cuda()
    rng = np.random.default_rng(9)
    unit = lambda x: (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)  # noqa: E731
    E = torch.from_numpy(unit(rng.standard_normal((r_, d)))).to(dev)
    q0 = torch.from_numpy(unit(rng.standard_normal((q, d)))).to(dev).bfloat16()
    checks = parity.bf16_cos_checks(E, q0)
    torch.cuda.synchronize()
    for c in checks:
        print(parity.describe(c))
    assert not parity.failures(checks), [parity.describe(c) for c in parity.failures(checks)]


@pytest.mark.gpu
@pytest.mark.parametrize("d", [128, 512])
@pytest.mark.parametrize("form", ["int8", "int8c"])
def test_int8_backward_edge_cases(form, d):
    """The int8 forms' tensor-core quad_bwd (and the forward) against their
    plain versions (``parity.quad_checks``: the limits unchanged) with a
    duplicate slot, written tiles under a 2048-column rounding tile (the
    views' d_cos summed, routed to the int8 row, g or v, and rounded) and
    an outlier row whose top-k holds k equal cosines, each tied with its
    kth; then the partial kernels on a queue cut into 4 blocks
    (``parity.quad_shard_checks``: targets and writes in other blocks,
    labels -2 there) against the whole queue's."""
    dev = _cuda()
    b, q, k = 64, 5000, 10
    queue, packed, kw, dce, dneg = make_packed(4, b, q, d, k, device=dev, form=form)
    _tie_columns(queue, packed[0], 2, k, torch.cat([packed[4], packed[6]]),
                 kw["qscales"])  # row 2: outlier
    ttm.reset_launch_counts()
    checks, want = parity.quad_checks(queue, packed, kw, dce, dneg, tile=2048)
    assert int((want[3][0, 2] == want[3][0, 2, -1]).sum()) >= k - 1  # the tie
    (ex, ey, sq, ga, gb, pa, pb, la, lb, sdce, sdneg) = make_shard_case(5, b, 4096, d,
                                                                         device=dev, n_shards=4)
    sq, qs = quantize_rows(sq)
    checks += parity.quad_shard_checks(ex, ey, sq, ga, gb, pa, pb, la, lb, sdce, sdneg,
                                       shard_kw("Arc", k=k), n_shards=4, qscales=qs,
                                       int8_compute=form == "int8c", tile=2048)
    torch.cuda.synchronize()
    for c in checks:
        print(form, d, parity.describe(c))
    assert not parity.failures(checks), [parity.describe(c) for c in parity.failures(checks)]
    assert ttm.LAUNCH_COUNTS[ttm.kernel_name("quad_bwd", form)] == 2
    assert ttm.LAUNCH_COUNTS[ttm.kernel_name("quad_partial_bwd", form)] == 4


@pytest.mark.gpu
@pytest.mark.parametrize("form", ["int8", "int8c"])
def test_int8_backward_ragged_matches_plain(form):
    """The int8 forms' quad kernels at R = 74 rows (not a multiple of the
    backward's 64-row group), Q = 3001 columns (not of its 64-column tile)
    and D = 64 (the int8 rows padded to whole swizzle groups), against the
    plain versions; then the partial kernels over two blocks of 1501
    columns against the whole queue's."""
    dev = _cuda()
    b, d, k = 37, 64, 5
    queue, packed, kw, dce, dneg = make_packed(6, b, 3001, d, k, device=dev, form=form)
    checks, _ = parity.quad_checks(queue, packed, kw, dce, dneg, tile=512)
    (ex, ey, sq, ga, gb, pa, pb, la, lb, sdce, sdneg) = make_shard_case(7, b, 3002, d,
                                                                         device=dev, n_shards=2)
    sq, qs = quantize_rows(sq)
    checks += parity.quad_shard_checks(ex, ey, sq, ga, gb, pa, pb, la, lb, sdce, sdneg,
                                       shard_kw("SV", k=k), n_shards=2, qscales=qs,
                                       int8_compute=form == "int8c")
    torch.cuda.synchronize()
    for c in checks:
        print(form, parity.describe(c))
    assert not parity.failures(checks), [parity.describe(c) for c in parity.failures(checks)]


@pytest.mark.gpu
@pytest.mark.parametrize("r_,q,d", [(256, 5000, 512), (40, 777, 128), (128, 4096, 64),
                                    (1024, 5000, 512), (400, 777, 128)])
def test_int8_clean_cosines_match_between_tilings(r_, q, d):
    """The int8-storage form's clean cosines as the forward's tiles form
    them and as the backward's recompute does (``clean_cos``, both the k16
    chain on the tensor cores over the rows widened to bf16): equal bit
    for bit, and within 1e-6 of the plain version (``parity.int8_cos_checks``);
    and the int8-compute form's integer dot in both tilings, the forward's
    ``__dp4a`` and the backward's s8 tensor-core sum, bit for bit
    (``parity.int8_dot_checks``)."""
    dev = _cuda()
    rng = np.random.default_rng(9)
    unit = lambda x: (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)  # noqa: E731
    E = torch.from_numpy(unit(rng.standard_normal((r_, d)))).to(dev)
    q0, qs = quantize_rows(torch.from_numpy(unit(rng.standard_normal((q, d)))).to(dev))
    checks = parity.int8_cos_checks(E, q0, qs)
    n = q // 8 * 8  # torch._int_mm, the integer reference, takes a multiple of 8 columns
    checks += parity.int8_dot_checks(*quantize_rows(E), q0[:n], qs[:n])
    torch.cuda.synchronize()
    for c in checks:
        print(parity.describe(c))
    assert not parity.failures(checks), [parity.describe(c) for c in parity.failures(checks)]


# ----------------------------------------------------------------------
# the f32 quad and twin backward (csrc/quad_margin.cu: quad_bwd_f32_kernel)
# ----------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("r_,q,d", [(256, 5000, 512), (40, 777, 128), (128, 4096, 64),
                                    (1024, 5000, 512), (400, 777, 128)])
def test_f32_clean_cosines_match_between_tilings(r_, q, d):
    """The f32 form's clean cosines as the forward's tiles form them
    (fdots_chunk) and as the backward's recompute does (ftile_dots, staged as
    quad_bwd_f32_kernel stages them; ``clean_cos``): equal bit for bit, so
    that the backward's top-k test meets the forward's kth exactly; and
    within 1e-5 of the plain f32 product (``parity.f32_cos_checks``)."""
    dev = _cuda()
    rng = np.random.default_rng(9)
    unit = lambda x: (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)  # noqa: E731
    E = torch.from_numpy(unit(rng.standard_normal((r_, d)))).to(dev)
    q0 = torch.from_numpy(unit(rng.standard_normal((q, d)))).to(dev)
    checks = parity.f32_cos_checks(E, q0)
    torch.cuda.synchronize()
    for c in checks:
        print(parity.describe(c))
    assert not parity.failures(checks), [parity.describe(c) for c in parity.failures(checks)]


def gathered_writes(t0, boundary):
    """A ``make_packed`` plan where a step's writes gather, as the DCP
    planner's consecutive slots do: direction A writes every slot inside the
    tile [t0, t0 + 64), direction B consecutive slots across column
    ``boundary``; in each, entries 0 and 1 write one slot with parity 0 (a
    duplicate whose last writer wins in view 1)."""
    def plan(direction, rows, cols):
        n = cols.shape[0]
        if direction == 0:
            cols[:] = t0 + np.arange(n) % 64
        else:
            cols[:] = boundary - n // 2 + np.arange(n)
        cols[1], rows[0], rows[1] = cols[0], 0, 0
    return plan


@pytest.mark.gpu
@pytest.mark.parametrize("d", [192, 512])
def test_f32_backward_edge_cases(d):
    """The f32 quad and twin kernels against their plain versions
    (``parity.quad_checks`` / ``twin_checks``, the limits unchanged) where
    the step's writes gather (``gathered_writes``): direction A's every write
    in one 64-column tile with a duplicate slot, direction B's straddling
    the boundary of two of the backward's column chunks on this card
    (``bwd_geometry``), the labels on written slots (in-pool rows whose
    target column lies in a written tile), at b = 40 probe rows a direction
    (R = 80, not a multiple of the 64-row group) and Q = 5001; then the twin
    on each direction's rows alone."""
    dev = _cuda()
    b, q, k = 40, 5001, 10
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    per = ttm.bwd_geometry("f32", 2 * b, q, sms, b).cols_per_chunk
    assert per % ttm.bwd_geometry("f32", b, q, sms, b).cols_per_chunk == 0  # the twin's too
    plan = gathered_writes(128, 3 * per)
    queue, packed, kw, dce, dneg = make_packed(8, b, q, d, k, device=dev, plan=plan)
    ttm.reset_launch_counts()
    checks, _ = parity.quad_checks(queue, packed, kw, dce, dneg)
    tkw = {key: kw[key] for key in ("loss_type", "margin", "scale", "k", "mask_svfc")}
    for dr, rs in (("A", slice(0, b)), ("B", slice(b, 2 * b))):
        inputs = tuple(x[rs].contiguous() for x in packed[:7]) + (packed[7][:, rs].contiguous(),)
        twin, _ = parity.twin_checks(queue, inputs, tkw, dce[:, rs].contiguous(),
                                     dneg[:, rs].contiguous(), tag=f"twin {dr}: ")
        checks += twin
    torch.cuda.synchronize()
    for c in checks:
        print(d, parity.describe(c))
    assert not parity.failures(checks), [parity.describe(c) for c in parity.failures(checks)]
    assert ttm.LAUNCH_COUNTS["quad_bwd"] == 1 and ttm.LAUNCH_COUNTS["twin_bwd"] == 2


# source edits of the f32 backward (quad_bwd_f32_kernel) that its checks must
# reject
QUAD_F32_FAULTS = {
    # a written column's view-1 d_cos sent to q0's stored row instead of g
    "written_view1_on_q0_row": ("  if (i0 >= 0) {                              // view 1 reads g\n"
                                "    wcoef[wrow + i0] = d1;\n"
                                "    return 0.f;\n"
                                "  }\n", ""),
    # one 4-feature step of each thread's d_emb product skipped (its first)
    "demb_step_skipped": ("for (int f = 0; f < 16; ++f) demb[i][f] = fmaf(",
                          "for (int f = 4; f < 16; ++f) demb[i][f] = fmaf("),
    # a written column's view-1 cosine from its first parity-0 writer, not the last
    "written_cos_first_writer": (
        "  if (i0 >= 0) c1 = wcos[wrow + i0];",
        "  if (i0 >= 0) {\n"
        "    int f = 0;\n"
        "    while (a.rows[rc.dir * a.BP + f] != 0 ||\n"
        "           a.cols[rc.dir * a.BP + f] != a.cols[rc.dir * a.BP + i0]) ++f;\n"
        "    c1 = wcos[wrow + f];\n"
        "  }"),
}


@pytest.mark.gpu
def test_f32_checks_reject_planted_faults(tmp_path, monkeypatch):
    """``parity.quad_checks`` and ``twin_checks`` pass the real f32 backward
    and fail copies of quad_margin.cu that send a written column's view-1
    d_cos to q0's row instead of g, skip one 4-feature step of the d_emb
    product, and take a written column's cosine from its first writer, not
    the last (in d_emb), at Arc, b = 64, Q = 5000, D = 128 and AM, b = 128,
    Q = 40000, D = 512, each with writes gathered in one tile and across a
    chunk boundary, and a duplicate slot written twice at parity 0
    (``gathered_writes``). Prints each reading."""
    from vlsfr_tpu_torch.ops import cuda_build

    dev = _cuda()
    libs = _build_faulty(tmp_path, QUAD_F32_FAULTS, source="quad_margin")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    failed = {}
    for lt, b, q, d, k in (("Arc", 64, 5000, 128, 10), ("AM", 128, 40000, 512, 16)):
        per = ttm.bwd_geometry("f32", 2 * b, q, sms, b).cols_per_chunk
        case = make_packed(3, b, q, d, k, device=dev, loss_type=lt,
                           plan=gathered_writes(256, 5 * per))
        queue, packed, kw, dce, dneg = case
        tkw = {key: kw[key] for key in ("loss_type", "margin", "scale", "k", "mask_svfc")}
        rs = slice(0, b)
        tin = tuple(x[rs].contiguous() for x in packed[:7]) + (packed[7][:, rs].contiguous(),)
        for name, lib in libs.items():
            monkeypatch.setitem(cuda_build._LOADED, "quad_margin", lib)
            checks, _ = parity.quad_checks(*case)
            checks += parity.twin_checks(queue, tin, tkw, dce[:, rs].contiguous(),
                                         dneg[:, rs].contiguous(), tag="twin: ")[0]
            torch.cuda.synchronize()
            for c in checks:
                print(f"{name} {lt}: {parity.describe(c)}")
            failed[name, lt] = {c["name"] for c in parity.failures(checks)}
    for lt in ("Arc", "AM"):
        assert failed["real", lt] == set()
        for name in QUAD_F32_FAULTS:
            assert {"d_emb", "twin: d_emb"} <= failed[name, lt], (name, lt)


# source edits of the forward (quad_fwd_kernel, every form) that its checks
# must reject
QUAD_FWD_FAULTS = {
    # a written column's view-1 cosine from its first parity-0 writer, not the last
    "fwd_written_first_writer": (
        "      if (i0 >= 0) c1[j] = w1[i0];",
        "      if (i0 >= 0) {\n"
        "        int f = 0;\n"
        "        while (a.rows[dir * a.BP + f] != 0 ||\n"
        "               a.cols[dir * a.BP + f] != a.cols[dir * a.BP + i0]) ++f;\n"
        "        c1[j] = w1[f];\n"
        "      }"),
    # each view's second (m, s) chain, the second quad of each pair's,
    # dropped from the row's merge
    "fwd_chain_dropped": ("    lse_fold(ln.m[v][1], ln.s[v][1], M[v], S[v]);\n", ""),
    # the int8c product skips the last k32 step of each row's first chunk
    "fwd_int8c_k32_step_skipped": ("wc, min(4, (a.D - 128 * kc) / 32));",
                                   "wc, min(4, (a.D - 128 * kc) / 32) - (kc == 0));"),
}


@pytest.mark.gpu
def test_forward_checks_reject_planted_faults(tmp_path, monkeypatch):
    """``parity.quad_checks`` (every form), ``twin_checks`` (f32, direction
    A's rows) and ``int8_dot_checks`` (int8c) pass the real forward and
    fail copies of quad_margin.cu that take a written column's view-1
    cosine from its first parity-0 writer instead of the last, drop one of
    a row's two (m, s) chains from its merge, and skip one k32 step of the
    int8c product, at Arc, b = 64, Q = 5000, D = 128 and AM, b = 128, Q =
    40000, D = 512, with writes gathered in one tile and across the
    boundary of two of the forward's column ranges (``gathered_writes``;
    a duplicate slot written twice at parity 0) and eight of direction A's
    probes near the duplicate slot's last write, so that its cosine weighs
    in their statistics. Prints each reading."""
    from vlsfr_tpu_torch.ops import cuda_build

    dev = _cuda()
    libs = _build_faulty(tmp_path, QUAD_FWD_FAULTS, source="quad_margin")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    failed = {}
    for form in ("f32", *FORMS):
        for lt, b, q, d, k in (("Arc", 64, 5000, 128, 10), ("AM", 128, 40000, 512, 16)):
            per = ttm.fwd_geometry(form, 2 * b, q, sms, b).cols_per_chunk
            case = make_packed(3, b, q, d, k, device=dev, loss_type=lt, form=form,
                               plan=gathered_writes(256, per))
            queue, packed, kw, dce, dneg = case
            E, G = packed[0], packed[1]
            near = G[1] + 0.3 * torch.randn((8, d), generator=torch.Generator(device=dev)
                                            .manual_seed(5), device=dev) / d ** 0.5
            E[3:11] = near / torch.linalg.vector_norm(near, dim=-1, keepdim=True)
            tkw = {key: kw[key] for key in ("loss_type", "margin", "scale", "k", "mask_svfc")}
            rs = slice(0, b)
            tin = tuple(x[rs].contiguous() for x in packed[:7]) + (packed[7][:, rs].contiguous(),)
            for name, lib in libs.items():
                monkeypatch.setitem(cuda_build._LOADED, "quad_margin", lib)
                checks, _ = parity.quad_checks(*case)
                if form == "f32":
                    checks += parity.twin_checks(queue, tin, tkw, dce[:, rs].contiguous(),
                                                 dneg[:, rs].contiguous(), tag="twin: ")[0]
                if form == "int8c":
                    checks += parity.int8_dot_checks(*kw["e8"], queue[0], kw["qscales"])
                torch.cuda.synchronize()
                for c in checks:
                    print(f"{name} {form} {lt}: {parity.describe(c)}")
                failed[name, form, lt] = {c["name"] for c in parity.failures(checks)}
    for form in ("f32", *FORMS):
        for lt in ("Arc", "AM"):
            assert failed["real", form, lt] == set()
            want = {"ce", "logz", "twin: ce", "twin: logz"} if form == "f32" else {"ce", "logz"}
            assert want <= failed["fwd_written_first_writer", form, lt], (form, lt)
            assert want <= failed["fwd_chain_dropped", form, lt], (form, lt)
            if form == "int8c":
                assert {"int8 raw dot (kernel, forward tiles)", "ce", "logz"} <= failed[
                    "fwd_int8c_k32_step_skipped", form, lt]
            else:
                assert failed["fwd_int8c_k32_step_skipped", form, lt] == set()


@pytest.mark.gpu
def test_fwd_geometry_is_the_kernels():
    """``fwd_geometry``'s shared memory is what the forward kernel takes
    (``quad_fwd_smem``) for every form at R = 64 and 200 probe rows."""
    _cuda()
    lib = ttm._lib()
    for form in ttm.FORMS:
        for r_ in (64, 200):
            geo = ttm.fwd_geometry(form, r_, 5000, 132, 64)
            assert lib.quad_fwd_smem(ttm.FORMS.index(form), r_) == geo.smem, (form, r_)


# a source edit of the f32 forward's row groups (above 256 probe rows) that
# its checks must reject at b = 512: every row group stages the probe rows
# of the first
QUAD_ROW_GROUP_FAULTS = {
    "f32_fwd_first_group_rows": ("a.E, r_base,\n                                      min(ROWS,",
                                 "a.E, 0,\n                                      min(ROWS,"),
}


@pytest.mark.gpu
def test_quad_row_group_checks_reject_planted_faults(tmp_path, monkeypatch):
    """At b = 512 (R = 1024: the f32 forward's four 256-row groups), Q =
    5000, D = 128, Arc: ``parity.quad_checks`` pass the real f32 forward
    and fail a copy of quad_margin.cu whose row groups all stage the first
    group's probe rows (ce, logz)."""
    from vlsfr_tpu_torch.ops import cuda_build

    dev = _cuda()
    libs = _build_faulty(tmp_path, QUAD_ROW_GROUP_FAULTS, source="quad_margin")
    case = make_packed(3, 512, 5000, 128, 10, device=dev)
    failed = {}
    for name, lib in libs.items():
        monkeypatch.setitem(cuda_build._LOADED, "quad_margin", lib)
        checks, _ = parity.quad_checks(*case)
        torch.cuda.synchronize()
        for c in checks:
            print(f"{name}: {parity.describe(c)}")
        failed[name] = {c["name"] for c in parity.failures(checks)}
    assert failed["real"] == set()
    assert {"ce", "logz"} <= failed["f32_fwd_first_group_rows"]


@pytest.mark.parametrize("faults", ["QUAD_FORM_FAULTS", "TWIN_FAULTS", "QUAD_F32_FAULTS",
                                    "QUAD_FWD_FAULTS", "QUAD_ROW_GROUP_FAULTS"])
def test_planted_quad_faults_edit_the_kernel_source(faults):
    """Each planted fault of quad_margin.cu (the rounded forms', the twin's,
    the f32 backward's, the forward's and its row groups') is a source edit
    whose old text matches the
    source exactly once, so that the copy the ``gpu`` test builds differs
    from the kernel where its name says."""
    from vlsfr_tpu_torch.ops import cuda_build

    src = (cuda_build.CSRC / "quad_margin.cu").read_text()
    for name, spec in globals()[faults].items():
        for old, new in (spec if isinstance(spec[0], tuple) else (spec,)):
            assert src.count(old) == 1 and old != new, name


# ----------------------------------------------------------------------
# the twin kernels
# ----------------------------------------------------------------------


def make_twin(seed, b, q, d, k, device="cpu", loss_type="Arc", form="f32"):
    """One direction's twin case (E, G, V, rows, cols, blend, labels, gt),
    a duplicate slot, outliers and in-pool labels on written slots, their
    probes near the written rows; the queue f32 or bf16; masked cotangents
    [2, b]."""
    rng = np.random.default_rng(seed)
    unit = lambda x: (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)  # noqa: E731
    queue = torch.from_numpy(unit(rng.standard_normal((2, q, d)))).to(device)
    if form == "bf16":
        queue = queue.bfloat16()
    rows = rng.integers(0, 2, b).astype(np.int32)
    cols = rng.integers(0, q, b).astype(np.int32)
    rows[1], cols[1] = rows[0], cols[0]
    seen = (rng.random(b) < 0.5).astype(np.float32)
    labels = cols.copy()
    labels[rng.random(b) < 0.3] = -1
    labels[2] = -1
    p, g = unit(rng.standard_normal((b, d))), unit(rng.standard_normal((b, d)))
    # in-pool probes near their own writes: the target term then carries
    # weight in logz (random probes leave it ~e^-15 of the sum)
    own = labels >= 0
    p[own] = unit(g[own] + 0.5 * rng.standard_normal((int(own.sum()), d)) / np.sqrt(d))
    t = [torch.from_numpy(x).to(device) for x in (p, g, rows, cols, seen, labels)]
    g32, rows_i, cols_i, v, blend = ttm.dir_inputs(queue, *t[1:5])
    gt = torch.stack(ttm.compute_twin_gt(t[0], queue, *t[1:6]))
    inputs = tuple(x.contiguous() for x in (t[0], g32, v, rows_i, cols_i, blend.to(torch.int32),
                                            t[5].to(torch.int32), gt))
    kw = dict(loss_type=loss_type, margin=0.5, scale=32.0, k=k, mask_svfc=1.2)
    cot = torch.from_numpy((rng.standard_normal((4, b)) / b).astype(np.float32)).to(device)
    pos = (inputs[6] >= 0)[None, :]
    dce = torch.where(pos, cot[:2], 0.0).contiguous()
    dneg = torch.where(pos, 0.0, cot[2:]).contiguous()
    return queue, inputs, kw, dce, dneg, (t, labels)


TWIN_CASES = [(f, lt, b, q, d, k, tile) for f in ("f32", "bf16")
              for lt, b, q, d, k, tile in (("Arc", 64, 5000, 128, 10, 512),
                                           ("SV", 64, 5000, 128, 10, 64),
                                           ("AM", 128, 40000, 512, 16, 2048),
                                           ("Arc", 100, 5001, 128, 10, 512),
                                           ("Arc", 200, 5001, 512, 10, 512),
                                           ("SV", 512, 20000, 256, 10, 2048))]


@pytest.mark.gpu
@pytest.mark.parametrize("form,loss_type,b,q,d,k,tile", TWIN_CASES)
def test_cuda_twin_kernels_match_plain(form, loss_type, b, q, d, k, tile):
    """twin_fwd / twin_bwd against their plain versions (``parity.twin_checks``),
    each launching its own counter once."""
    dev = _cuda()
    queue, inputs, kw, dce, dneg, _ = make_twin(0, b, q, d, k, device=dev, loss_type=loss_type,
                                                form=form)
    ttm.reset_launch_counts()
    checks, _ = parity.twin_checks(queue, inputs, kw, dce, dneg, tile=tile)
    torch.cuda.synchronize()
    for c in checks:
        print(form, loss_type, parity.describe(c))
    assert not parity.failures(checks), [parity.describe(c) for c in parity.failures(checks)]
    assert ttm.LAUNCH_COUNTS[ttm.kernel_name("twin_fwd", form)] == 1
    assert ttm.LAUNCH_COUNTS[ttm.kernel_name("twin_bwd", form)] == 1
    assert sum(ttm.LAUNCH_COUNTS.values()) == 2


@pytest.mark.gpu
@pytest.mark.parametrize("form,loss_type", [("f32", "Arc"), ("f32", "SV"), ("bf16", "Arc")])
def test_twin_partial_kernels_and_merge_match_plain_and_whole(form, loss_type):
    """The twin partial kernels over 4 emulated blocks against their plain
    versions, and the merged blocks against twin_fwd / twin_bwd on the
    whole queue (``parity.twin_shard_checks``)."""
    dev = _cuda()
    queue, inputs, kw, dce, dneg, (t, _) = make_twin(5, 64, 4096, 128, 10, device=dev,
                                                     loss_type=loss_type, form=form)
    ttm.reset_launch_counts()
    checks = parity.twin_shard_checks(t[0], queue, t[1], t[2:5], t[5], dce, dneg, kw, 4)
    torch.cuda.synchronize()
    for c in checks:
        print(form, loss_type, parity.describe(c))
    assert not parity.failures(checks), [parity.describe(c) for c in parity.failures(checks)]
    assert ttm.LAUNCH_COUNTS[ttm.kernel_name("twin_partial_fwd", form)] == 4
    assert ttm.LAUNCH_COUNTS[ttm.kernel_name("twin_partial_bwd", form)] == 4


@pytest.mark.gpu
@pytest.mark.parametrize("form", ["f32", "bf16"])
def test_twin_add_margin_on_card_matches_cpu(form):
    """twin_add_margin and its autograd on the card against the same call
    on CPU copies (the plain versions): loss 1e-5 relative, d_emb 1e-4 ×
    its max (f32) or ``rounded_demb`` (bf16); each twin kernel once."""
    dev = _cuda()
    queue, _, kw, _, _, (t, _) = make_twin(7, 128, 20000, 256, 10, device=dev, form=form)
    lkw = dict(loss_type="Arc", margin=0.5, scale=32.0, hard_neg=10, mask_svfc=1.2)
    res = []
    ttm.reset_launch_counts()
    for to in (lambda x: x, lambda x: x.cpu()):
        emb = to(t[0]).clone().requires_grad_(True)
        loss, acc = ttm.twin_add_margin(emb, to(queue), *(to(x) for x in t[1:]), with_acc=True,
                                        **lkw)
        loss.backward()
        res.append((float(loss.detach()), float(acc), emb.grad.cpu()))
    assert ttm.LAUNCH_COUNTS[ttm.kernel_name("twin_fwd", form)] == 1
    assert ttm.LAUNCH_COUNTS[ttm.kernel_name("twin_bwd", form)] == 1
    (lk, ak, gk), (lp, ap, gp) = res
    assert lk == pytest.approx(lp, rel=1e-5) and ak == pytest.approx(ap, abs=1e-6)
    checks = parity.demb_checks("d_emb", gk, gp, queue.dtype)
    assert not parity.failures(checks), [parity.describe(c) for c in checks]


# source edits of quad_margin.cu that the twin checks must reject
TWIN_FAULTS = {
    # the twin forward leaves the target column out of its stream
    "twin_target_not_streamed": ("stream_z(zt0, m0, s0);\n    stream_z(zt1, m1, s1);",
                                 "(void)0;"),
    # the backward chooses its rounding per 64-column tile, not per rounding tile
    "rounding_per_64_columns": ("const bool hit = written[2 + rc.dir] != 0;",
                                "const bool hit = w64;"),
}


@pytest.mark.gpu
def test_twin_checks_reject_planted_faults(tmp_path, monkeypatch):
    """``parity.twin_checks`` and ``twin_shard_checks`` pass the real
    kernels and fail a quad_margin.cu whose twin forward leaves the target
    out of the stream (ce / logz, the partial state) and one whose backward
    rounds per 64 columns on a bf16 queue at a 512-column rounding tile
    (``rounded_demb``; b = 128, Q = 65,536, D = 512, Arc). Prints each
    reading."""
    from vlsfr_tpu_torch.ops import cuda_build

    dev = _cuda()
    libs = _build_faulty(tmp_path, TWIN_FAULTS, source="quad_margin")
    failed = {}
    for form in ("f32", "bf16"):
        queue, inputs, kw, dce, dneg, (t, _) = make_twin(3, 128, 1 << 16, 512, 10, device=dev,
                                                         form=form)
        for name, lib in libs.items():
            monkeypatch.setitem(cuda_build._LOADED, "quad_margin", lib)
            checks, _ = parity.twin_checks(queue, inputs, kw, dce, dneg, tile=512)
            checks += parity.twin_shard_checks(t[0], queue, t[1], t[2:5], t[5], dce, dneg, kw, 4)
            torch.cuda.synchronize()
            for c in checks:
                print(f"{name} {form}: {parity.describe(c)}")
            failed[name, form] = {c["name"] for c in parity.failures(checks)}
    rows = f"d_emb rows beyond {parity.DEMB_TIGHT:g} x max"
    for form in ("f32", "bf16"):
        assert failed["real", form] == set()
        assert {"ce", "logz", "block 0/4 partial m + log s"} <= failed[
            "twin_target_not_streamed", form]
    assert rows in failed["rounding_per_64_columns", "bf16"]
    assert failed["rounding_per_64_columns", "f32"] == set()  # f32 rounds nothing


# ----------------------------------------------------------------------
# the 3x3 conv (ops/conv3x3.py) and the matrix-unit probe
# (tools/probe_int8_mxu.py): the kernels against their plain versions
# (limits in utils/parity.py: conv_checks, probe_checks)
# ----------------------------------------------------------------------

# (x shape, Cout, strip): C of 1 to 512 (1-7: the bf16 stem kernel, x at
# its own C, padded to 4 in f32; 200, 256 and 512: the bf16 weight slice
# streamed, 200 at every W and not a multiple of 16), H and W off the tiles
# (the stem's and the streamed kernel's 128 pixels, the f32 kernel's 256:
# B·H·W a multiple of none, tiles spanning images, W = 14, 22, 28, 7, 13),
# Cout a multiple of 64, not one, not a multiple of the streamed kernel's
# 128 (72, 136, 200) and not a multiple of 8; C = 12 leaves the f32
# kernel's second 8-channel chunk half empty; the stem at W = 112 (ir50's
# width), Cout 64, 20, 72 (two channel slices) and 27
CONV_CASES = [((2, 8, 8, 8), 8, 4), ((2, 12, 20, 24), 40, 6), ((3, 28, 28, 64), 72, 14),
              ((2, 30, 26, 64), 64, 10), ((2, 18, 22, 128), 128, 6), ((1, 14, 30, 128), 96, 14),
              ((1, 8, 9, 16), 27, 8), ((2, 16, 12, 3), 64, 8), ((2, 14, 14, 256), 64, 14),
              ((1, 28, 28, 256), 64, 28), ((1, 14, 14, 512), 72, 14), ((3, 14, 14, 200), 200, 14),
              ((2, 10, 22, 256), 136, 10), ((2, 16, 20, 200), 72, 8), ((1, 10, 7, 12), 20, 10),
              ((2, 16, 112, 3), 64, 8), ((3, 10, 13, 5), 20, 10), ((1, 12, 9, 7), 72, 6),
              ((2, 8, 12, 1), 27, 4)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["taps9", "im2col"])
@pytest.mark.parametrize("shape,cout,strip", CONV_CASES)
def test_conv3x3_kernel_matches_plain(dtype, mode, shape, cout, strip):
    from vlsfr_tpu_torch.ops import conv3x3 as tconv

    dev = _cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, dtype)
    w = torch.from_numpy((rng.standard_normal((3, 3, shape[-1], cout)) * 0.1)
                         .astype(np.float32)).to(dev)
    geo = tconv.conv_geometry(dtype == torch.bfloat16, *shape[:3],
                              tconv.kernel_channels(dtype, shape[-1]), cout, strip)
    assert (geo.kind == "stem") == (dtype == torch.bfloat16 and shape[-1] < 8)
    tconv.reset_launch_counts()
    y, stats = tconv.conv3x3(x, w, mode=mode, strip=strip, with_stats=True)
    y0 = tconv.conv3x3(x, w, mode=mode, strip=strip)
    assert tconv.LAUNCH_COUNTS[tconv.kernel_name(dtype, True)] == 1
    assert tconv.LAUNCH_COUNTS[tconv.kernel_name(dtype, False)] == 1
    y_p, stats_p = tconv.conv3x3_plain(x, w, with_stats=True)
    checks = parity.conv_checks(y, y_p, stats, stats_p) + parity.conv_checks(y0, y_p)
    torch.cuda.synchronize()
    for c in checks:
        print(parity.describe(c))
    assert parity.failures(checks) == []


# source edits of conv3x3.cu that the conv checks must reject
CONV_FAULTS = {
    # the resident bf16 kernel reads the bottom halo row one row off
    "halo_row_off": ("const int hh = gr0 + hr - 1,",
                     "const int hh = gr0 + hr - 1 + (hr == tr + 1),"),
    # the statistics merge drops the last block's partial
    "merge_drops_last_block": ("hi = min(n_blocks, lo + r);",
                               "hi = min(n_blocks - 1, lo + r);"),
    # the streamed bf16 kernel's consumers drop the last channel chunk
    "stream_drops_last_chunk": ("if (st > 0 && c0 + 16 * cb >= C) continue;",
                                "if ((st > 0 && c0 + 16 * cb >= C) || i == n_ch - 1) continue;"),
    # the f32 kernel reads tap 5 (dy = 1, dx = 2) one pixel to the right
    "f32_tap_dx_off": ("const int toff = (tap / 3) * WP + tap % 3;",
                       "const int toff = (tap / 3) * WP + tap % 3 + (tap == 5);"),
    # the stem kernel's K table reads tap 5 one pixel to the right
    "stem_tap_dx_off": ("const int dy = tap / 3 - 1, dx = tap % 3 - 1;",
                        "const int dy = tap / 3 - 1, dx = tap % 3 - 1 + (tap == 5);"),
}
# each fault's case (dtype, x shape, Cout, strip) and a check it must fail:
# the resident kernel's at C = 64, the streamed kernel's at C = 256, the
# stem's at C = 3, W = 112
CONV_FAULT_CASES = {
    "halo_row_off": (torch.bfloat16, (2, 28, 28, 64), 64, 14, "y elements more than one"),
    "merge_drops_last_block": (torch.bfloat16, (2, 28, 28, 64), 64, 14, "Σ² per channel"),
    "stream_drops_last_chunk": (torch.bfloat16, (2, 14, 14, 256), 256, 14,
                                "y elements more than one"),
    "f32_tap_dx_off": (torch.float32, (2, 28, 28, 64), 64, 14, "y"),
    "stem_tap_dx_off": (torch.bfloat16, (2, 16, 112, 3), 64, 8, "y elements more than one"),
}


@pytest.mark.gpu
def test_conv_checks_reject_planted_faults(tmp_path, monkeypatch):
    """``parity.conv_checks`` pass the real conv3x3 kernels with statistics
    at each fault's case, and fail a conv3x3.cu that reads the resident
    kernel's bottom halo row one row off (y, at C = 64), one whose
    statistics merge drops the last block (Σ²), one whose streamed kernel
    drops its last channel chunk (y, at C = 256) and ones whose f32 kernel
    or stem kernel reads one tap one pixel off (y)."""
    from vlsfr_tpu_torch.ops import conv3x3 as tconv
    from vlsfr_tpu_torch.ops import cuda_build

    dev = _cuda()
    libs = _build_faulty(tmp_path, CONV_FAULTS, source="conv3x3")
    cases = {}
    for name, (dtype, shape, cout, strip, _) in CONV_FAULT_CASES.items():
        if (dtype, shape) not in cases:
            rng = np.random.default_rng(6)
            x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, dtype)
            w = torch.from_numpy((rng.standard_normal((3, 3, shape[-1], cout)) * 0.045)
                                 .astype(np.float32)).to(dev)
            cases[dtype, shape] = (x, w, strip, *tconv.conv3x3_plain(x, w, with_stats=True))
    failed = {}
    for name, lib in libs.items():
        monkeypatch.setitem(cuda_build._LOADED, "conv3x3", lib)
        for (dtype, shape), (x, w, strip, y_p, st_p) in cases.items():
            if name != "real" and CONV_FAULT_CASES[name][:2] != (dtype, shape):
                continue
            y, st = tconv.conv3x3(x, w, strip=strip, with_stats=True)
            torch.cuda.synchronize()
            checks = parity.conv_checks(y, y_p, st, st_p)
            for c in checks:
                print(name, shape, parity.describe(c))
            failed.setdefault(name, []).extend(c["name"] for c in parity.failures(checks))
    assert failed["real"] == []
    for name, (*_, must) in CONV_FAULT_CASES.items():
        assert any(n.startswith(must) for n in failed[name]), name


@pytest.mark.parametrize("faults", ["CONV_FAULTS", "chip_smoke.CONV_FAULTS"])
def test_planted_conv_faults_edit_the_kernel_source(faults):
    """Each planted fault of conv3x3.cu (this file's and chip_smoke.py's) is
    a source edit whose old text matches the source exactly once, so that
    the copy a ``gpu`` test or chip_smoke.py builds differs from the kernel
    where its name says; this file's faults each have a case."""
    from vlsfr_tpu_torch.ops import cuda_build

    table = _chip_smoke().CONV_FAULTS if faults.startswith("chip_smoke.") else CONV_FAULTS
    src = (cuda_build.CSRC / "conv3x3.cu").read_text()
    for name, (old, new) in table.items():
        assert src.count(old) == 1 and old != new, name
    assert set(CONV_FAULT_CASES) == set(CONV_FAULTS)


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# the stem kernel's geometry at ir50's stem [128, 112, 112, C] for every C
# it takes, to Cout 64, 20 and 72 (strip 28)
STEM_GEOMETRY_CASES = [(torch.bfloat16, (128, 112, 112, c), cout, 28)
                       for c in (1, 3, 5, 7) for cout in (64, 20, 72)]


def _conv_geometry_cases():
    """(dtype, x shape, Cout, strip) of every conv a test, the bench or
    chip_smoke.py runs: the bench's shapes (bf16, and f32 at the first),
    ir50's widths, CONV_CASES in both types and STEM_GEOMETRY_CASES."""
    from vlsfr_tpu_torch.tools import bench_conv

    smoke = _chip_smoke()
    cases = [(torch.bfloat16, s, s[-1], 28) for s in bench_conv.SHAPES]
    cases.append((torch.float32, smoke.CONV_F32_SHAPE, smoke.CONV_F32_SHAPE[-1], 28))
    cases += [(torch.bfloat16, s, cout, strip) for s, cout, strip in smoke.CONV_IR50]
    cases += [(dt, s, cout, strip) for s, cout, strip in CONV_CASES
              for dt in (torch.float32, torch.bfloat16)]
    return cases + STEM_GEOMETRY_CASES


N_GEOMETRY_CASES = 3 + 1 + 3 + 2 * len(CONV_CASES) + len(STEM_GEOMETRY_CASES)


@pytest.mark.parametrize("case", range(N_GEOMETRY_CASES))
def test_conv_geometry_covers_the_output_once(case):
    """``conv3x3.conv_geometry`` (twin of conv3x3.cu's): its grid covers
    every (image, pixel, output channel) exactly once — the resident
    kernel's (image, strip) blocks × 64 channels, the streamed (128 pixels ×
    128 channels) and f32 (256 × 64) kernels' tiles in order over all
    B·H·W, only the last tile ragged, the stem's persistent blocks'
    contiguous ranges of 128-pixel tiles × 64 channels — every tile's halo
    within the virtual rows (the stem: the bytes) the stages hold, the
    partials one per grid row (what the wrapper allocates, the kernels
    write by blockIdx.x and the merge reads), the shared memory within a
    block's 232,448 bytes (the stem's within half an SM's, two blocks an
    SM), w's row stride a whole number of 16-byte pieces outside the
    resident and stem kernels; bf16 C < 8 takes the stem at its own C (the
    wrapper's channel padding no longer applies to it), C = 200, 256 and
    512 stream in bf16, the bench's shapes stay resident."""
    from vlsfr_tpu_torch.ops import conv3x3 as tconv

    cases = _conv_geometry_cases()
    assert len(cases) == N_GEOMETRY_CASES
    dtype, (b, h, w, c), cout, strip = cases[case]
    c = tconv.kernel_channels(dtype, c)
    geo = tconv.conv_geometry(dtype == torch.bfloat16, b, h, w, c, cout, strip)
    gx, gy = geo.grid
    tile_co = {"resident": tconv._BN, "streamed": tconv._S_BN, "f32": tconv._F_BN,
               "stem": tconv._ST_BN}[geo.kind]
    assert geo.n_parts == gx and 0 < geo.smem <= 232448
    assert (gy - 1) * tile_co < cout <= gy * tile_co
    assert (geo.kind == "stem") == (dtype == torch.bfloat16 and c < 8)
    if geo.kind == "stem":
        npx, px = b * h * w, tconv._ST_BM
        n_tiles = -(-npx // px)
        assert geo.wld == cout and 2 * geo.smem <= 228 * 1024
        assert gx == min(n_tiles, tconv._ST_BLOCKS // gy) and gx * gy <= tconv._ST_BLOCKS
        covered = np.zeros(npx, np.int64)
        for bx in range(gx):  # block bx: tiles [n_tiles bx / gx, n_tiles (bx + 1) / gx)
            lo, hi = n_tiles * bx // gx, n_tiles * (bx + 1) // gx
            assert hi > lo
            for t in range(lo, hi):
                p0 = t * px
                covered[p0:min(p0 + px, npx)] += 1
                # the staged elements: from the piece at pixel p0 - W - 1 to pixel p0 + 128 + W
                e0 = max(0, p0 - w - 1) * c // 8 * 8
                e1 = min(npx, p0 + px + w + 1) * c
                assert 16 * -(-(e1 - e0) // 8) <= geo.plan[0]
        assert (covered == 1).all()
        if (b, h, w) == (128, 112, 112):
            assert geo.grid == (264 // gy, gy)  # every SM two blocks
        return
    if geo.kind == "resident":
        assert dtype == torch.bfloat16 and c <= 144 and geo.wld == cout
        assert gx == b * (h // strip) and geo.plan[0] > 0  # (image, strip) pairs, rows a group
        return
    assert geo.kind == ("streamed" if dtype == torch.bfloat16 else "f32")
    assert geo.wld % 8 == 0 and cout <= geo.wld < cout + 8
    npx, px = b * h * w, (tconv._S_BM if geo.kind == "streamed" else tconv._F_BM)
    assert (gx - 1) * px < npx <= gx * px
    covered = np.zeros(npx, np.int64)
    for t in range(gx):
        p0, p1 = t * px, min((t + 1) * px, npx) - 1
        covered[p0:p1 + 1] += 1
        first = (p0 // (h * w)) * (h + 2) + (p0 % (h * w)) // w
        last = (p1 // (h * w)) * (h + 2) + (p1 % (h * w)) // w + 2
        assert last - first + 1 <= geo.plan[-1]  # the halo's virtual rows
    assert (covered == 1).all()
    if c in (200, 256, 512):
        assert geo.kind == "streamed" or dtype == torch.float32


@pytest.mark.gpu
def test_conv_geometry_matches_the_kernel():
    """conv3x3.cu's own geometry (``conv3x3_geometry``) equals
    ``conv_geometry``'s at every case of
    ``test_conv_geometry_covers_the_output_once``: kernel, grid, shared
    memory, partials, w's row stride and plan."""
    import ctypes

    from vlsfr_tpu_torch.ops import conv3x3 as tconv

    _cuda()
    lib = tconv._lib()
    for dtype, (b, h, w, c), cout, strip in _conv_geometry_cases():
        c = tconv.kernel_channels(dtype, c)
        geo = tconv.conv_geometry(dtype == torch.bfloat16, b, h, w, c, cout, strip)
        out = (ctypes.c_int * 9)()
        assert lib.conv3x3_geometry(int(dtype == torch.bfloat16), b, h, w, c, cout, strip, out) == 0
        want = [tconv.KINDS.index(geo.kind), *geo.grid, geo.smem, geo.n_parts, geo.wld, *geo.plan]
        assert list(out)[:len(want)] == want, (dtype, (b, h, w, c), cout)


# (B, D, T, NT): the probe's own shapes but NT = 37 (296 or 592 chunks over
# 33 splits: NT not a multiple of the splits, nor the chunks), B = 1 and 40,
# T of one 64-column piece, of 5 (a 256-column tile and a masked one) and 2
# tiles; D = 128-512
PROBE_CASES = [(16, 128, 128, 4), (128, 512, 256, 37), (40, 256, 64, 1), (128, 512, 1024, 37),
               (1, 128, 320, 5), (40, 384, 512, 3)]


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["int8", "bf16", "i8st_bf16dot"])
@pytest.mark.parametrize("b,d,t,nt", PROBE_CASES)
def test_probe_kernel_matches_plain(kind, b, d, t, nt):
    from vlsfr_tpu_torch.tools import probe_int8_mxu as tprobe

    dev = _cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    a, w = tprobe.make_inputs(b, d, t, nt, seed=3, dev=dev)[kind]
    tprobe.reset_launch_counts()
    got = tprobe.probe_dot(kind, a, w)
    assert tprobe.LAUNCH_COUNTS[f"probe_{kind}"] == 1
    want = tprobe.probe_dot_plain(kind, a, w)
    if kind == "int8":
        assert torch.equal(want, tprobe.exact_int8(a, w))
    checks = parity.probe_checks(kind, got, want, a, w)
    torch.cuda.synchronize()
    for c in checks:
        print(parity.describe(c))
    assert parity.failures(checks) == []


# source edits of dot_probe.cu that the probe checks must reject (an (old,
# new) pair or a tuple of them), each with the form it is run in
PROBE_FAULTS = {
    # the last split sums one tile fewer (its producer and consumers alike)
    "skips_last_tile": ("const int n = (int)(n_q * (s + 1) / splits - q_lo);",
                        "const int n = (int)(n_q * (s + 1) / splits - q_lo - (s == splits - 1 ? "
                        "kpc : 0));"),
    # i8st widens w's int8 with its sign bit flipped (offset binary)
    "i8st_sign_flipped": ("for (int q = 0; q < 4; ++q) widen4(v[q], lo[q], hi[q]);",
                          "for (int q = 0; q < 4; ++q) widen4(v[q] ^ 0x80808080u, lo[q], hi[q]);"),
}
PROBE_FAULT_KINDS = {"skips_last_tile": "int8", "i8st_sign_flipped": "i8st_bf16dot"}


@pytest.mark.gpu
def test_probe_checks_reject_planted_faults(tmp_path, monkeypatch):
    """``parity.probe_checks`` pass the real probe kernel in every form at
    B, D, T, NT = 128, 512, 1024, 37, and fail a dot_probe.cu whose last
    split skips its last tile (int8) and one whose i8st form widens w with
    the sign bit flipped."""
    from vlsfr_tpu_torch.ops import cuda_build
    from vlsfr_tpu_torch.tools import probe_int8_mxu as tprobe

    dev = _cuda()
    libs = _build_faulty(tmp_path, PROBE_FAULTS, source="dot_probe")
    inputs = tprobe.make_inputs(128, 512, 1024, 37, seed=5, dev=dev)
    for name, lib in libs.items():
        monkeypatch.setitem(cuda_build._LOADED, "dot_probe", lib)
        for kind in (tprobe.KINDS if name == "real" else (PROBE_FAULT_KINDS[name],)):
            a, w = inputs[kind]
            checks = parity.probe_checks(kind, tprobe.probe_dot(kind, a, w),
                                         tprobe.probe_dot_plain(kind, a, w), a, w)
            torch.cuda.synchronize()
            for c in checks:
                print(name, kind, parity.describe(c))
            assert (parity.failures(checks) == []) == (name == "real"), (name, kind)


@pytest.mark.parametrize("faults", ["PROBE_FAULTS", "chip_smoke.PROBE_FAULTS"])
def test_planted_probe_faults_edit_the_kernel_source(faults):
    """Each planted fault of dot_probe.cu (this file's and chip_smoke.py's)
    is a source edit whose old text matches the source exactly once; each
    has the form it runs in."""
    from vlsfr_tpu_torch.ops import cuda_build

    smoke = _chip_smoke()
    table, kinds = ((smoke.PROBE_FAULTS, smoke.PROBE_FAULT_KINDS) if faults.startswith("chip_")
                    else (PROBE_FAULTS, PROBE_FAULT_KINDS))
    src = (cuda_build.CSRC / "dot_probe.cu").read_text()
    for name, spec in table.items():
        for old, new in (spec if isinstance(spec[0], tuple) else (spec,)):
            assert src.count(old) == 1 and old != new, name
    assert set(kinds) == set(table) and {"int8", "i8st_bf16dot"} <= set(kinds.values())


# (kind, B, D, T, NT): the probe's shapes in each form, PROBE_CASES' and a
# T wider than the SMs' column tiles
PROBE_GEOMETRY_CASES = ([(k, 128, 512, 1024, 512) for k in ("int8", "bf16", "i8st_bf16dot")]
                        + [(k, *c) for c in PROBE_CASES for k in ("int8", "i8st_bf16dot")]
                        + [("bf16", 128, 128, 64 * 700, 2)])


@pytest.mark.parametrize("kind,b,d,t,nt", PROBE_GEOMETRY_CASES)
def test_probe_geometry_covers_the_work_once(kind, b, d, t, nt):
    """``probe_int8_mxu.probe_geometry`` (twin of dot_probe.cu's): the
    column tiles cover T once (the last masked), the splits cover the K
    axis — NT tiles × D in 128-byte chunks — once, in order, one chunk apart
    at most, so every tile once; a and the ring's stages (32 KB each, 16
    KB in i8st; at least two) within a block's shared memory; and at the probe's shapes
    the grid fills the 132 SMs of an H100 with no SM idle."""
    from vlsfr_tpu_torch.tools import probe_int8_mxu as tprobe

    geo = tprobe.probe_geometry(kind, b, d, t, nt)
    n_col, splits = geo.grid
    assert (n_col - 1) * 256 < t <= n_col * 256
    assert geo.kc * (2 if kind == "bf16" else 1) == 128  # a chunk: 128 bytes of a w row
    n_q = nt * (d // geo.kc)
    covered = np.zeros(n_q, np.int64)
    sizes = []
    for sp in range(splits):
        lo, hi = tprobe.split_range(n_q, splits, sp)
        covered[lo:hi] += 1
        sizes.append(hi - lo)
    assert (covered == 1).all() and max(sizes) - min(sizes) <= 1 and min(sizes) >= 1
    tiles = np.zeros(nt, np.int64)
    np.add.at(tiles, np.arange(n_q) // (d // geo.kc), 1)
    assert (tiles == d // geo.kc).all()  # every tile's chunks, once each
    a_bytes = 128 * d * (1 if kind == "int8" else 2)
    stage = (128 if kind == "i8st_bf16dot" else 256) * 128  # w rows a stage x 128 bytes
    assert geo.nst >= 2 and geo.smem == a_bytes + geo.nst * stage + 1024 + 128
    assert geo.smem <= 232448 < geo.smem + stage or geo.nst == 8
    if (b, d, t, nt) == (128, 512, 1024, 512):
        assert n_col * splits == 132  # no SM idle
    assert n_col * splits <= max(132, n_col)


@pytest.mark.gpu
def test_probe_geometry_matches_the_kernel():
    """dot_probe.cu's own geometry (``dot_probe_geometry``) equals
    ``probe_geometry``'s at every case of
    ``test_probe_geometry_covers_the_work_once``, on the card's SM count and
    on 132."""
    import ctypes

    from vlsfr_tpu_torch.tools import probe_int8_mxu as tprobe

    dev = _cuda()
    lib = tprobe._lib()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for kind, b, d, t, nt in PROBE_GEOMETRY_CASES:
        for n_sm in sorted({sms, 132}):
            geo = tprobe.probe_geometry(kind, b, d, t, nt, n_sm)
            out = (ctypes.c_int * 5)()
            assert lib.dot_probe_geometry(tprobe._FORM_CODE[kind], b, d, t, nt, n_sm, out) == 0
            assert list(out) == [*geo.grid, geo.kc, geo.nst, geo.smem], (kind, b, d, t, nt)


def test_conv_and_probe_checks_reject_wrong_outputs():
    """On the CPU: conv_checks fail a bf16 y off by two spacings somewhere,
    too many single-spacing straddles, an f32 y off by 1e-4 × max and a Σ²
    missing one row; probe_checks fail an int8 o off by one and a bf16 o
    missing one tile."""
    from vlsfr_tpu_torch.ops import conv3x3 as tconv
    from vlsfr_tpu_torch.tools import probe_int8_mxu as tprobe

    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((2, 8, 8, 16)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((3, 3, 16, 16)) * 0.1).astype(np.float32))
    y, (s1, s2) = tconv.conv3x3_plain(x, w, with_stats=True)
    assert parity.failures(parity.conv_checks(y, y, (s1, s2), (s1, s2))) == []
    yb = y.bfloat16()
    bad = yb.clone()
    bad[0, 0, 0, 0] = yb[0, 0, 0, 0].float() + 2 * parity.bf16_spacing(yb[0, 0, 0, 0])
    assert parity.failures(parity.conv_checks(bad, yb))
    step = yb.float() + parity.bf16_spacing(yb.float())  # every element one spacing up
    assert [c["name"] for c in parity.failures(parity.conv_checks(step.bfloat16(), yb))] == [
        "y elements apart"]
    y_off = y.clone()
    y_off[1, 7, 7, 3] += 1e-4 * float(y.abs().max())
    assert parity.failures(parity.conv_checks(y_off, y))
    rows = y.reshape(-1, 16)
    assert parity.failures(parity.conv_checks(y, y, (s1, s2 - rows[-1].square()), (s1, s2)))
    a, wq = tprobe.make_inputs(16, 64, 64, 3, seed=4, dev=torch.device("cpu"))["int8"]
    o = tprobe.probe_dot_plain("int8", a, wq)
    assert parity.failures(parity.probe_checks("int8", o + (o == o.max()).int(), o, a, wq))
    a, wb = tprobe.make_inputs(16, 64, 64, 3, seed=4, dev=torch.device("cpu"))["bf16"]
    o = tprobe.probe_dot_plain("bf16", a, wb)
    assert parity.failures(parity.probe_checks("bf16", tprobe.probe_dot_plain(
        "bf16", a, wb[:-1]), o, a, wb))
    assert parity.failures(parity.probe_checks("bf16", o, o, a, wb)) == []


def test_margin_bwd_variants_edit_the_kernel_source():
    """The margin_ce backward's timing tool (``tools/margin_bwd_variants.py``)
    builds copies of ``csrc/margin_ce.cu`` and ``margin_common.cuh`` with one
    phase of the f32 pass or of the bf16 d_w pass left out, or another
    staging depth: each of its edits matches its file exactly once, so that
    every copy it times differs from the kernel where its name says."""
    from vlsfr_tpu_torch.ops import cuda_build
    from vlsfr_tpu_torch.tools.margin_bwd_variants import FORMS, edited_sources

    assert set(FORMS) == {"f32", "bf16"}
    for variants in FORMS.values():
        for name, (_, edits) in variants.items():
            for fname, old, new in edits:
                assert (cuda_build.CSRC / fname).read_text().count(old) == 1 and old != new, name
            assert edited_sources(edits) != edited_sources([]), name


def test_conv_variants_edit_the_kernel_source():
    """The conv's timing tool (``tools/conv_variants.py``) builds copies of
    ``csrc/conv3x3.cu`` with one phase of the streamed bf16 kernel or of the
    f32 kernel left out: each of its edits matches the source exactly once,
    so that every copy it times differs from the kernel where its name
    says, and no edit touches the resident kernel (its case is the
    control)."""
    from vlsfr_tpu_torch.ops import cuda_build
    from vlsfr_tpu_torch.tools.conv_variants import VARIANTS, edited_source

    src = (cuda_build.CSRC / "conv3x3.cu").read_text()
    start = src.index("conv3x3_bf16_kernel(const")
    resident = src[start:src.index("\n}\n", start)]
    for name, edits in VARIANTS.items():
        for old, new in edits:
            assert src.count(old) == 1 and old != new and old not in resident, name
        assert edited_source(edits) != src, name


def test_probe_variants_edit_the_kernel_source():
    """The probe's timing tool (``tools/probe_variants.py``) builds copies
    of ``csrc/dot_probe.cu`` with one phase left out (the products, the
    copies of w, i8st's widening, the partial stores, the merge) or another
    ring or L2 setting: each of its edits matches the source exactly once,
    so that every copy it times differs from the kernel where its name
    says."""
    from vlsfr_tpu_torch.ops import cuda_build
    from vlsfr_tpu_torch.tools.probe_variants import VARIANTS, edited_source

    src = (cuda_build.CSRC / "dot_probe.cu").read_text()
    assert {"no products", "no copies", "no partial stores"} <= set(VARIANTS)
    for name, edits in VARIANTS.items():
        for old, new in edits:
            assert src.count(old) == 1 and old != new, name
        assert edited_source(edits) != src, name


def test_quad_bwd_variants_edit_the_kernel_source():
    """The backward's timing tool (``tools/quad_bwd_variants.py``) builds
    copies of ``csrc/quad_margin.cu`` with one phase left out or another
    warp count (the tensor-core kernel's) or another place for the written
    cosines (the f32 kernel's): each of its edits matches the source
    exactly once, so that every copy it times differs from the kernel where
    its name says; the copy each form holds to the plain version is one of
    its own."""
    from vlsfr_tpu_torch.ops import cuda_build
    from vlsfr_tpu_torch.tools.quad_bwd_variants import CHECKED, F32_VARIANTS, VARIANTS

    assert CHECKED["f32"] in F32_VARIANTS and all(CHECKED[f] in VARIANTS for f in FORMS)
    src = (cuda_build.CSRC / "quad_margin.cu").read_text()
    for name, edits in {**VARIANTS, **F32_VARIANTS}.items():
        for old, new in edits:
            assert src.count(old) == 1 and old != new, name


def test_quad_fwd_variants_edit_the_kernel_source():
    """The forward's timing tool (``tools/quad_fwd_variants.py``) builds
    copies of ``csrc/quad_margin.cu`` with one phase of the forward left out
    or its row pass moved between the products: each edit matches the
    source exactly once, so that every copy it times differs from the
    kernel where its name says; the copy held to the real kernel's outputs
    is one of them."""
    from vlsfr_tpu_torch.ops import cuda_build
    from vlsfr_tpu_torch.tools.quad_fwd_variants import CHECKED, VARIANTS

    assert CHECKED in VARIANTS
    src = (cuda_build.CSRC / "quad_margin.cu").read_text()
    for name, edits in VARIANTS.items():
        for old, new in edits:
            assert src.count(old) == 1 and old != new, name


def test_margin_fwd_variants_edit_the_kernel_source():
    """The margin_ce forward's timing tool (``tools/margin_fwd_variants.py``)
    builds copies of ``csrc/margin_ce.cu`` with one phase of the forward
    left out (the product, its staging copies, the row pass, its top-k
    insertions, the statistics): each of its edits matches the source
    exactly once, so that
    every copy it times differs from the kernel where its name says."""
    from vlsfr_tpu_torch.ops import cuda_build
    from vlsfr_tpu_torch.tools.margin_fwd_variants import VARIANTS, edited_source

    assert set(VARIANTS) == {"no product", "no staging copies", "no row pass",
                             "no top-k insertions", "no statistics"}
    src = (cuda_build.CSRC / "margin_ce.cu").read_text()
    for name, edits in VARIANTS.items():
        for old, new in edits:
            assert src.count(old) == 1 and old != new, name
        assert edited_source(edits) != src, name
