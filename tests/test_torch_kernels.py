"""The quad head's CUDA kernels against their plain PyTorch versions.

This file imports neither JAX nor the JAX package, so the ``gpu`` tests run
on a machine with a card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -m gpu

Without a card the ``gpu`` tests skip; the CPU tests here check properties
of the plain versions the kernels are held to (chunking invariance, the
last-writer rule, no kernel launch on CPU tensors).

Kernel tolerances (f32 FMA in another summation order than cuBLAS, over up
to Q columns): ce / neg / logz 1e-4 absolute, top-k 1e-5, d_emb 1e-4 ×
max|d_emb|, d_gt 1e-5.
"""

import numpy as np
import pytest
import torch

from vlsfr_tpu_torch.ops import twin_margin as ttm


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
