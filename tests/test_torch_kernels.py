"""The port's CUDA kernels (the quad head's and the streaming softmax's)
against their plain PyTorch versions.

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
beyond 2^-7 × max); the int8-compute dot bit for bit. The softmax kernels' gradients are held where
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


def make_packed(seed, b, q, d, k, device="cpu", loss_type="Arc", form="f32"):
    """A quad case in the packed layout; ``form`` stores the queue as f32,
    bf16 or int8 (int8c: int8 with the probes quantised), and ``kw`` then
    carries the form's ``qscales`` and ``e8``."""
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


def test_plain_versions_are_chunk_invariant():
    queue, packed, kw, dce, dneg = make_packed(1, b=8, q=90, d=16, k=4, loss_type="SV")
    E, rest = packed[0], packed[1:]
    a = ttm.quad_fwd_plain(E, queue, *rest, chunk=7, **kw)
    b = ttm.quad_fwd_plain(E, queue, *rest, chunk=1000, **kw)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.numpy(), y.numpy(), atol=2e-5)
    kth = b[3][:, :, -1].contiguous()
    g1 = ttm.quad_bwd_plain(E, queue, *rest, b[2], kth, dce, dneg, chunk=7, **kw)
    g2 = ttm.quad_bwd_plain(E, queue, *rest, b[2], kth, dce, dneg, chunk=1000, **kw)
    for x, y in zip(g1, g2):
        np.testing.assert_allclose(x.numpy(), y.numpy(), atol=3e-5)


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
                ("Arc", 128, 40000, 512, 16)]


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
               ("SV", 32, 2048, 64, 4), ("Arc", 128, 40000, 512, 4)]


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
    emb, w, mom, labels, d_ce, d_neg = make_softmax_case(4, 8, 90, 16, 3, 0.4)
    kw = dict(loss_type="SV", margin=0.5, scale=32.0, k=3, mask_svfc=1.2)
    gt = tms.compute_gt(emb, w, labels)
    a = tms.margin_ce_fwd_plain(emb, w, labels, gt, chunk=7, **kw)
    b = tms.margin_ce_fwd_plain(emb, w, labels, gt, chunk=1000, **kw)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.numpy(), y.numpy(), atol=2e-5)
    logz, topk = b[2], b[3]
    g1 = tms.margin_ce_bwd_plain(emb, w, labels, gt, logz, topk, d_ce, d_neg, chunk=7, **kw)
    g2 = tms.margin_ce_bwd_plain(emb, w, labels, gt, logz, topk, d_ce, d_neg, chunk=1000, **kw)
    for x, y in zip(g1, g2):
        np.testing.assert_allclose(x.numpy(), y.numpy(), atol=3e-5)


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
                 ("SV", 8, 700, 64, 3, 0.3), ("Arc", 128, 40000, 512, 16, 0.2)]


SGD = dict(momentum=0.9, nesterov=True, weight_decay=1e-4)
LR = 0.1


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
    assert tms.LAUNCH_COUNTS == {"margin_ce_fwd": 1, "margin_ce_bwd": 2,
                                 "margin_ce_bwd_fused_sgd": 1, "margin_ce_bwd_sparse": 0,
                                 "margin_partial_fwd": 0, "margin_partial_bwd": 0}


def _build_faulty(tmp_path, faults, source="margin_ce"):
    """{"real": the built library of ``csrc/<source>.cu``, name: a copy
    built with that fault's source edit} — the copies compiled in parallel
    into tmp_path."""
    from vlsfr_tpu_torch.ops import cuda_build

    src = (cuda_build.CSRC / f"{source}.cu").read_text()
    procs = {}
    for name, (old, new) in faults.items():
        assert src.count(old) == 1, name
        out = tmp_path / name
        out.mkdir()
        shutil.copy(cuda_build.CSRC / "margin_common.cuh", out)
        (out / f"{source}.cu").write_text(src.replace(old, new))
        procs[name] = cuda_build.start_nvcc(out / f"{source}.cu", out / f"lib{source}.so")
    libs = {"real": cuda_build.load_library(source)}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        assert proc.returncode == 0, log
        libs[name] = ctypes.CDLL(str(tmp_path / name / f"lib{source}.so"))
    return libs


# source edits that break the d_w pass: each must fail the checks above
PLANTED_FAULTS = {
    "no_weight_decay": ("if (sgd.wd != 0.f) g = g + sgd.wd * wv;", ""),
    "d_w_x1.1": ("float g = iv * (acc3[i][j] - wv * iv * sd);",
                 "float g = 1.1f * iv * (acc3[i][j] - wv * iv * sd);"),
}


@pytest.mark.gpu
def test_softmax_checks_reject_planted_faults(tmp_path, monkeypatch):
    """At chip_smoke.py's full width (B = 128, D = 512, C = 2^20, Arc, k = 1,
    a 0.01·N(0, 1) classifier and momentum, a repeated label), the checks
    pass the real kernels and fail a margin_ce.cu built without weight decay
    and one whose d_w is 1.1× too large, on the rows the kernel computes
    alone. Prints each reading, and for d_w and mom' the error and limit of
    an all-rows check (1e-4 × max|d_w|, 1e-4 × max|mom'| over every row)
    for comparison."""
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
    assert ck == {"margin_ce_fwd": 1, "margin_ce_bwd": 1, "margin_ce_bwd_fused_sgd": 0,
                  "margin_ce_bwd_sparse": 0, "margin_partial_fwd": 0, "margin_partial_bwd": 0}
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
                ("SV", 8, 700, 64, 3, 0.3, 64), ("Arc", 128, 40000, 512, 16, 0.2, 512)]


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
    assert tms.LAUNCH_COUNTS == {"margin_ce_fwd": 1, "margin_ce_bwd": 0,
                                 "margin_ce_bwd_fused_sgd": 0, "margin_ce_bwd_sparse": 2,
                                 "margin_partial_fwd": 0, "margin_partial_bwd": 0}


# source edits that break the sparse backward: each must fail the checks above
SPARSE_FAULTS = {
    "no_dwl_add": ("if (tgt[b] == t) g += dwl[(long long)b * a.D + d];",
                   "if (tgt[b] == t) g += 0.f;"),
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
                     ("Arc", 128, 1_000_000, 512, 1, 0.0, 4)]


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
    assert tms.LAUNCH_COUNTS == {"margin_ce_fwd": 1, "margin_ce_bwd": 1,
                                 "margin_ce_bwd_fused_sgd": 0, "margin_ce_bwd_sparse": 0,
                                 "margin_partial_fwd": 2 * n_shards,  # merge input + checks
                                 "margin_partial_bwd": n_shards}


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
    columns (the backward's rounding follows 64-column tiles, so a chunk
    is a whole number of tiles)."""
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
                                     ("AM", 128, 40000, 512, 16))]


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
    # clean tiles: d_cos (× the int8 scale) not rounded to bf16
    "no_clean_dcos_rounding": ("dq = SCALED ? bf16r(d * sc) : bf16r(d);",
                               "dq = SCALED ? d * sc : d;"),
    # bf16 queue, written tiles: each view's d_cos not rounded
    "bf16_written_unrounded": ("d1 = bf16r(d1);\n              d2 = bf16r(d2);", "(void)0;"),
    # int8 tile loader: every row reads its first words again
    "int8_word_offset": ("X[g * words + k0 + kk]", "X[g * words + kk]"),
}


@pytest.mark.gpu
def test_form_checks_reject_planted_faults(tmp_path, monkeypatch):
    """The rounded forms' checks (``parity.quad_checks`` with
    ``rounded_demb``, and ``int8_dot_checks`` for int8c) pass the real
    kernels and fail a quad_margin.cu that skips the clean tiles' bf16
    rounding of d_cos (every form), one that skips the bf16 written tiles'
    (bf16), and one whose int8 loader reads the wrong words (int8c), at
    Arc, b = 64, Q = 5000, D = 128 and AM, b = 128, Q = 40000, D = 512.
    Prints each reading. Not planted: Arc / AM's combined clean-tile d_cos
    replaced by the sum of the two views' — the same function up to f32
    rounding, which no limit tells from another summation order; the CPU
    tests hold the plain version's form to the Pallas kernel's."""
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
                checks, _ = parity.quad_checks(*case)
                if form == "int8c":
                    checks += parity.int8_dot_checks(*kw["e8"], queue[0], kw["qscales"])
                torch.cuda.synchronize()
                for c in checks:
                    print(f"{name} {form} {lt}: {parity.describe(c)}")
                failed[name, form, lt] = {c["name"] for c in parity.failures(checks)}
    rows = f"d_emb rows beyond {parity.DEMB_TIGHT:g} x max"
    for form in FORMS:
        for lt in ("Arc", "AM"):
            assert failed["real", form, lt] == set()
            assert rows in failed["no_clean_dcos_rounding", form, lt]
    assert rows in failed["bf16_written_unrounded", "bf16", "Arc"]
    assert rows in failed["bf16_written_unrounded", "bf16", "AM"]
    for lt in ("Arc", "AM"):
        assert {"int8 raw dot (kernel, forward tiles)",
                "int8 raw dot (kernel, backward tiles)"} <= failed["int8_word_offset", "int8c", lt]
