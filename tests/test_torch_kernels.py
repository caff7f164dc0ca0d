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
quad d_emb 1e-4 × its max. The softmax kernels' gradients are held where
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
from vlsfr_tpu_torch.utils import parity


def make_packed(seed, b, q, d, k, device="cpu", loss_type="Arc"):
    rng = np.random.default_rng(seed)
    unit = lambda x: (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)  # noqa: E731
    queue = torch.from_numpy(unit(rng.standard_normal((2, q, d)))).to(device)
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
    packed = ttm.pack_dirs(pa[0], pb[0], ttm.dir_inputs(queue, *pa[1:5]),
                           ttm.dir_inputs(queue, *pb[1:5]), pa[5], pb[5],
                           ttm.compute_twin_gt(pa[0], queue, *pa[1:]),
                           ttm.compute_twin_gt(pb[0], queue, *pb[1:]))
    kw = dict(b=b, loss_type=loss_type, margin=0.5, scale=32.0, k=k, mask_svfc=1.2)
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
                             lastb, b)
    assert float(c1[0, 5]) == 0.75


def test_cpu_tensors_never_launch():
    ttm.reset_launch_counts()
    queue, packed, kw, dce, dneg = make_packed(2, b=8, q=50, d=16, k=3)
    _, _, logz, topk = ttm.quad_fwd(packed[0], queue, *packed[1:], **kw)
    ttm.quad_bwd(packed[0], queue, *packed[1:], logz, topk[:, :, -1].contiguous(), dce, dneg,
                 **kw)
    assert ttm.LAUNCH_COUNTS == {"quad_fwd": 0, "quad_bwd": 0}


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
    assert ttm.LAUNCH_COUNTS == {"quad_fwd": 1, "quad_bwd": 1}
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
                                 "margin_ce_bwd_fused_sgd": 1}


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
    src = (cuda_build.CSRC / "margin_ce.cu").read_text()
    procs = {}
    for name, (old, new) in PLANTED_FAULTS.items():
        assert src.count(old) == 1, name
        out = tmp_path / name
        out.mkdir()
        shutil.copy(cuda_build.CSRC / "margin_common.cuh", out)
        (out / "margin_ce.cu").write_text(src.replace(old, new))
        procs[name] = cuda_build.start_nvcc(out / "margin_ce.cu", out / "libmargin_ce.so")
    real = tms._lib()
    for proc in procs.values():
        log, _ = proc.communicate()
        assert proc.returncode == 0, log

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
    for name in ("real", *PLANTED_FAULTS):
        lib = real if name == "real" else ctypes.CDLL(str(tmp_path / name / "libmargin_ce.so"))
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
    assert ck == {"margin_ce_fwd": 1, "margin_ce_bwd": 1, "margin_ce_bwd_fused_sgd": 0}
    assert cp == {"margin_ce_fwd": 0, "margin_ce_bwd": 0, "margin_ce_bwd_fused_sgd": 0}
    np.testing.assert_allclose(lk, lp, rtol=1e-5)
    np.testing.assert_allclose(ek.numpy(), ep.numpy(), atol=1e-4 * float(ep.abs().max()))
    np.testing.assert_allclose(wk.numpy(), wp.numpy(), atol=1e-4 * float(wp.abs().max()))
