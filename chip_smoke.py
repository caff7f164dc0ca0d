#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (``vlsfr_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA card:

    python3 chip_smoke.py

It drives both ported paths, each with its kernels' launch counters set to
0 just before the run and read just after. Phases (any failure raises and
exits non-zero; nothing is caught):

1. device — the card's name and power limit (nvidia-smi), TF32 off for
   both cuDNN and cuBLAS (the f32 paths must be IEEE f32);
2. build — every CUDA source in ``vlsfr_tpu_torch/csrc`` with nvcc, one
   process per source, all started together, printing the ``-Xptxas -v``
   report;
FFC slice (the fused-pool FFC step, ir50, 2^20-slot f32 queue):
3. parity — each quad kernel against its plain PyTorch version at the
   slice's full width (b = 128 rows per direction, D = 512, Q = 2^20,
   k = 10, Arc, scale 32, margin 0.5, a write plan from the port's DCP
   planner with a duplicate slot), then AM and SV at Q = 4096. Tolerances:
   ce / neg / logz 1e-4 absolute and top-k 1e-5 (f32 sums in another order
   over 2^20 columns); d_emb 1e-4 × max|d_emb|; d_gt 1e-5;
4. timing — CUDA events over repeated launches: each kernel, its plain
   version, and a PyTorch composition of the forward's function
   (matmul + logsumexp + topk) as a yardstick; the bound is the larger of
   FLOP / 67 TFLOP/s (f32, no tensor cores) and bytes / 3.35 TB/s;
5. training — the port's ``Trainer`` on the slice config (ir50, 512-d,
   batch 128, 2^20-slot f32 queue, Arc, fuse_forward, bf16 compute) over a
   raw-pixel synthetic store, a few steps: each quad kernel must launch
   once per step;
6. profile — two more (warm) steps under torch.profiler: the device's
   busy and idle share of the wall time, time by kernel family, top kernels;
Softmax slice (the full-softmax head, ir50, 2^20 classes, f32 classifier):
7. parity — the three margin_ce kernels against their plain versions at
   full width (B = 128, D = 512, C = 2^20, k = 1, Arc, scale 32, margin
   0.5, a repeated label, a random momentum, lr 0.1, μ 0.9 Nesterov, wd
   1e-4; the plain fused version gets clones of W and mom taken before the
   kernel), then AM, SV and k = 3 with outlier rows at C = 4096. d_w, w'
   and mom' are held per row set: the batch's label rows, whose target
   gradient plain torch adds on both sides, and the other rows, which the
   kernel computes alone (``vlsfr_tpu_torch/utils/parity.py``); each limit
   is printed with its reason;
8. timing — as phase 4, with ``torch.matmul`` / ``logsumexp`` / ``topk`` /
   elementwise SGD compositions as yardsticks;
9. training — ``Trainer`` with ``pool.head=full_softmax`` on route B
   (``fused_update=off``) and then route A (the default): from one seed and
   one batch, A's first step must agree with B's (loss, and the classifier
   per row set as in phase 7);
   then route A trains 4 steps through ``Trainer.train`` and route B 2:
   each must launch its kernels once per step;
10. profile — two warm route-A steps, as phase 6;
11. the ``kernels`` JSON line, then the device JSON line last.

The script imports nothing of JAX. Without a CUDA device it exits non-zero
before printing any result.
"""

from __future__ import annotations

import copy
import gc
import json
import math
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

PEAK_F32_FLOPS = 67e12  # H100 SXM, f32 outside the tensor cores
PEAK_HBM_BYTES = 3.35e12  # H100 SXM HBM3
SLICE = dict(b=128, d=512, q=1 << 20, k=10)
SOFTMAX = dict(b=128, d=512, c=1 << 20)
TRAIN_STEPS = 4
ROUTE_B_STEPS = 2


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, n: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def make_case(q: int, b: int, d: int, k: int, loss_type: str, seed: int):
    """Packed kernel inputs from a realistic write plan: the port's DCP
    planner after a few warm-up steps (pool hits, seen flags, in-pool probe
    labels), with one label three times in each gallery half so two writes
    land on the same (row, slot)."""
    from vlsfr_tpu_torch.core.dcp import DCPManager
    from vlsfr_tpu_torch.core.ffc import init_queue
    from vlsfr_tpu_torch.ops import twin_margin as ttm

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    queue = init_queue(q, d, device=dev, generator=gen)
    rng = np.random.default_rng(seed)
    dcp = DCPManager(q)
    n_ids = 4 * b
    for _ in range(3):
        dcp.plan_step(rng.integers(0, n_ids, b), rng.integers(0, n_ids, b))
    xl, yl = rng.integers(0, n_ids, b), rng.integers(0, n_ids, b)
    xl[:3], yl[:3] = xl[0], yl[0]
    plan = dcp.plan_step(xl, yl)
    for side in (plan.a, plan.b):
        key = side.rows.astype(np.int64) * q + side.cols
        assert len(np.unique(key)) < b, "the plan must hold a duplicate (row, slot)"

    def unit(n):
        x = torch.randn((n, d), generator=gen, device=dev)
        return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)

    p_x, p_y, g_a, g_b = unit(b), unit(b), unit(b), unit(b)
    t = lambda a: torch.from_numpy(np.asarray(a)).to(dev)  # noqa: E731
    pa = (t(plan.a.rows), t(plan.a.cols), t(plan.a.seen))
    pb = (t(plan.b.rows), t(plan.b.cols), t(plan.b.seen))
    la, lb = t(plan.a.fake_labels), t(plan.b.fake_labels)
    packed = ttm.pack_dirs(p_x, p_y, ttm.dir_inputs(queue, g_a, *pa),
                           ttm.dir_inputs(queue, g_b, *pb), la, lb,
                           ttm.compute_twin_gt(p_x, queue, g_a, *pa, la),
                           ttm.compute_twin_gt(p_y, queue, g_b, *pb, lb))
    kw = dict(b=b, loss_type=loss_type, margin=0.5, scale=32.0, k=k, mask_svfc=1.2)
    cot = torch.randn((4, 2 * b), generator=gen, device=dev) / b
    pos = (packed[6] >= 0)[None, :]
    dce = torch.where(pos, cot[:2], 0.0).contiguous()
    dneg = torch.where(pos, 0.0, cot[2:]).contiguous()
    n_pos = int(pos.sum())
    print(f"  case Q={q} {loss_type}: {n_pos}/{2 * b} in-pool probe rows, "
          f"{int(packed[5].sum())} blend writes")
    return queue, packed, kw, dce, dneg


def check_pair(queue, packed, kw, dce, dneg):
    """Kernel vs plain on one case; raises above tolerance. Returns the
    forward outputs (plain) and the max errors."""
    from vlsfr_tpu_torch.ops import twin_margin as ttm

    E, rest = packed[0], packed[1:]
    got = ttm.quad_fwd(E, queue, *rest, **kw)
    want = ttm.quad_fwd_plain(E, queue, *rest, **kw)
    torch.cuda.synchronize()
    errs = {}
    for name, g, w, tol in zip(("ce", "neg", "logz", "topk"), got, want,
                               (1e-4, 1e-4, 1e-4, 1e-5)):
        err = float((g - w).abs().max())
        if not math.isfinite(err) or err > tol:
            raise RuntimeError(f"quad_fwd {name} disagrees: max |err| {err:.3e} > {tol}")
        errs[name] = err
    logz, kth = want[2], want[3][:, :, -1].contiguous()
    d_k, g_k = ttm.quad_bwd(E, queue, *rest, logz, kth, dce, dneg, **kw)
    d_p, g_p = ttm.quad_bwd_plain(E, queue, *rest, logz, kth, dce, dneg, **kw)
    torch.cuda.synchronize()
    tol = 1e-4 * float(d_p.abs().max())
    errs["d_emb"] = float((d_k - d_p).abs().max())
    errs["d_gt"] = float((g_k - g_p).abs().max())
    if not errs["d_emb"] <= tol:
        raise RuntimeError(f"quad_bwd d_emb disagrees: max |err| {errs['d_emb']:.3e} > {tol:.3e}")
    if not errs["d_gt"] <= 1e-5:
        raise RuntimeError(f"quad_bwd d_gt disagrees: max |err| {errs['d_gt']:.3e}")
    print("  max |kernel - plain|: " + " ".join(f"{k}={v:.3e}" for k, v in errs.items()))
    return want, errs


def bound(flop: float, nbytes: float) -> dict:
    """The least time the card could take: the larger of FLOP at the f32
    rate and bytes at the HBM rate, and which of the two it is."""
    t_ops, t_bytes = flop / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes
            else "bytes", "flop": flop, "bytes": nbytes}


def timing(queue, packed, kw, dce, dneg, fwd_plain):
    from vlsfr_tpu_torch.ops import twin_margin as ttm

    E, rest = packed[0], packed[1:]
    r_, d = E.shape
    q = queue.shape[1]
    logz, kth = fwd_plain[2], fwd_plain[3][:, :, -1].contiguous()
    out = {}
    out["quad_fwd"] = dict(
        ms=cuda_ms(lambda: ttm.quad_fwd(E, queue, *rest, **kw), 10),
        plain_ms=cuda_ms(lambda: ttm.quad_fwd_plain(E, queue, *rest, **kw), 3, 1))
    out["quad_bwd"] = dict(
        ms=cuda_ms(lambda: ttm.quad_bwd(E, queue, *rest, logz, kth, dce, dneg, **kw), 10),
        plain_ms=cuda_ms(lambda: ttm.quad_bwd_plain(E, queue, *rest, logz, kth, dce, dneg,
                                                    **kw), 3, 1))
    q0 = queue[0]

    def library_fwd():  # yardstick only: the port never calls this
        cos = torch.matmul(E, q0.T)
        torch.logsumexp(kw["scale"] * cos, dim=1)
        torch.topk(cos, kw["k"], dim=1)

    out["quad_fwd"]["library_ms"] = cuda_ms(library_fwd, 5, 1)
    out["quad_bwd"]["library_ms"] = None
    vec_bytes = 4 * (3 * r_ * d + 6 * r_)  # E, G, V + the [R] / [2, R] row vectors
    q0_bytes = 4 * q * d
    fwd_flop = 2.0 * r_ * d * q
    fwd_bytes = q0_bytes + vec_bytes + 4 * 2 * r_ * (3 + kw["k"])
    bwd_flop = 4.0 * r_ * d * q
    bwd_bytes = q0_bytes + vec_bytes + 4 * 8 * r_ + 4 * (r_ * d + 2 * r_)
    out["quad_fwd"].update(bound(fwd_flop, fwd_bytes))
    out["quad_bwd"].update(bound(bwd_flop, bwd_bytes))
    for name, v in out.items():
        lib = "null" if v["library_ms"] is None else f"{v['library_ms']:.3f}"
        print(f"  {name}: ms={v['ms']:.3f} bound_ms={v['bound_ms']:.3f} ({v['bound_by']}: "
              f"{v['flop']:.3e} FLOP, {v['bytes']:.3e} B) plain_ms={v['plain_ms']:.3f} "
              f"library_ms={lib}")
    return out


def kernel_family(name: str) -> str:
    low = name.lower()
    if "quad_" in low:
        return "quad kernels"
    if "margin_" in low:
        return "margin_ce kernels"
    if any(s in low for s in ("conv", "cudnn", "xmma", "gemm", "cutlass", "wgrad", "dgrad")):
        return "convolution / GEMM"
    if any(s in low for s in ("elementwise", "reduce", "batch_norm", "softmax")):
        return "elementwise / reduce"
    if "memcpy" in low or "memset" in low:
        return "copies"
    return "other"


def profile_steps(run_step, batches) -> None:
    """Device activity of one warm training step per batch
    (torch.profiler): the busy time as the union of the card's kernel and
    copy intervals, its share of the wall time, the time by kernel family
    and the top kernels. The batches are decoded before the window, so the
    window holds the steps themselves (in training a prefetch thread
    decodes them meanwhile)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    n = len(batches)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches:
            m = run_step(b)
        float(m["loss"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans, by_name, families = [], {}, {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        ms = (e.time_range.end - e.time_range.start) / 1e3
        tot, cnt = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + ms, cnt + 1)
        fam = kernel_family(e.name)
        families[fam] = families.get(fam, 0.0) + ms
    if not spans:
        raise RuntimeError("the profiler recorded no device activity in the training steps")
    busy_us, end = 0.0, -math.inf
    for s, t in sorted(spans):  # union of intervals: overlapping streams count once
        if t > end:
            busy_us += t - max(s, end)
            end = t
    busy = busy_us / 1e3
    print(f"  {n} steps: wall {wall_ms:.1f} ms under the profiler ({wall_ms / n:.1f} ms/step); "
          f"device busy {busy:.1f} ms, idle {100 * (1 - busy / wall_ms):.1f} % of wall")
    print("  device time by family (ms over the window): "
          + ", ".join(f"{k} {v:.1f}" for k, v in sorted(families.items(), key=lambda x: -x[1])))
    for name, (ms, count) in sorted(by_name.items(), key=lambda x: -x[1][0])[:12]:
        print(f"    {ms:9.3f} ms  x{count:<5d} {name[:110]}")


def train_phase(card: str):
    from vlsfr_tpu_torch.config import Config
    from vlsfr_tpu_torch.ops import twin_margin as ttm
    from vlsfr_tpu_torch.train.trainer import Trainer

    cfg = Config().apply_overrides([
        "model.net_type=ir50", "model.feat_dim=512", "model.dtype=bfloat16",
        "data.batch_size=128", "data.image_size=112", f"pool.queue_size={1 << 20}",
        "pool.queue_dtype=float32", "loss.loss_type=Arc", "loss.margin=0.5", "loss.scale=32",
        "pool.fuse_forward=true", "data.synthetic_ids=200", "data.synthetic_images_per_id=3",
        "data.num_workers=4", "train.print_freq=1", "optim.lr=0.1"])
    cfg.data.synthetic = True
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        cfg.train.saved_dir = tmp
        torch.cuda.reset_peak_memory_stats()
        trainer = Trainer(cfg)  # the normal entry point; runs on cuda
        try:
            if trainer.steps_per_epoch < TRAIN_STEPS:
                raise RuntimeError(f"the store holds {trainer.steps_per_epoch} steps, "
                                   f"fewer than {TRAIN_STEPS}")
            ttm.reset_launch_counts()
            t0 = time.perf_counter()
            out = trainer.train(max_steps=TRAIN_STEPS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(ttm.LAUNCH_COUNTS)
            peak = torch.cuda.max_memory_allocated()
            print(f"  {TRAIN_STEPS} steps: {json.dumps(out)}")
            print(f"  quad launches in the training run: {launches}")
            check_training(trainer, out, launches)
            step_ms = 2 * 128 / out["images_per_sec"] * 1e3
            print(f"  step time {step_ms:.1f} ms (last window, {card}); {TRAIN_STEPS} steps "
                  f"{wall:.2f} s wall incl. first-step warm-up; peak memory "
                  f"{peak / 2**30:.2f} GiB ({card})")
            print("== phase 6: profile of two more training steps")
            state, scale = trainer.state, trainer.plateau.scale
            profile_steps(lambda b: trainer.train_step(state, b.x, b.y, trainer.dcp.plan_step(
                b.x_label, b.y_label), scale), [trainer.pipeline.make_batch(0, s) for s in range(2)])
        finally:
            trainer.close()
    return launches


def check_training(trainer, out: dict, launches: dict) -> None:
    """Finite loss, one launch of each quad kernel per step, unit rows in
    the queue, and probe embeddings that agree with the same net on the CPU."""
    if not all(n == TRAIN_STEPS for n in launches.values()):
        raise RuntimeError(f"each quad kernel must launch once per step: {launches}")
    if not (math.isfinite(out["loss"]) and out["loss"] > 0 and out["final_step"] == TRAIN_STEPS):
        raise RuntimeError(f"training did not produce a finite loss: {out}")
    state = trainer.state
    norms = torch.linalg.vector_norm(state.queue[0, :1024], dim=-1)
    if not torch.allclose(norms, torch.ones_like(norms), atol=1e-4):
        raise RuntimeError("queue rows are not unit vectors after training")
    x = torch.from_numpy(trainer.pipeline.make_batch(0, 0).x[:4]).cuda()
    probe_cpu = copy.deepcopy(state.probe).cpu().eval()
    state.probe.eval()
    with torch.no_grad():
        emb = state.probe(x)
        emb_cpu = probe_cpu(x.cpu())
    if emb.shape != (4, 512) or not torch.isfinite(emb).all():
        raise RuntimeError(f"bad embeddings: {emb.shape}")
    agree = float((emb.cpu() * emb_cpu).sum(-1).min())
    if agree < 0.99:
        raise RuntimeError(f"card and CPU embeddings disagree: min cosine {agree:.4f}")
    print(f"  queue rows unit; card/CPU embedding cosine >= {agree:.5f}")


def softmax_case(c: int, loss_type: str, k: int, frac_outlier: float, seed: int):
    """Unit embeddings [128, 512], a 0.01·N(0, 1) classifier and momentum
    [c, 512], labels with one class twice (rows 0 and 1) and optionally
    outlier rows; d_ce = 1/B on labelled rows, d_neg = 1/B on outliers."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    b, d = SOFTMAX["b"], SOFTMAX["d"]
    emb = torch.randn((b, d), generator=gen, device=dev)
    emb /= torch.linalg.vector_norm(emb, dim=-1, keepdim=True)
    w = torch.randn((c, d), generator=gen, device=dev).mul_(0.01)
    mom = torch.randn((c, d), generator=gen, device=dev).mul_(0.01)
    labels = torch.randint(0, c, (b,), generator=gen, device=dev, dtype=torch.int32)
    labels[1] = labels[0]
    if frac_outlier:
        labels[torch.rand((b,), generator=gen, device=dev) < frac_outlier] = -1
        labels[2] = -1
    pos = labels >= 0
    d_ce = torch.where(pos, 1.0 / b, 0.0)
    d_neg = torch.where(pos, 0.0, 1.0 / b)
    kw = dict(loss_type=loss_type, margin=0.5, scale=32.0, k=k, mask_svfc=1.2)
    print(f"  case C={c} {loss_type} k={k}: {int(pos.sum())}/{b} labelled rows, class "
          f"{int(labels[0])} twice")
    return emb, w, mom, labels, d_ce, d_neg, kw


SGD = dict(momentum=0.9, nesterov=True, weight_decay=1e-4)
LR = 0.1


SOFTMAX_LIMITS = (
    "ce / neg / logz 1e-4 and top-k 1e-5 absolute: f32 sums in another order over C columns",
    "d_emb 1e-4 x max of its streamed part (d_emb less the target term plain torch adds on both "
    "sides) + 2 f32 eps x max|d_emb|: scale*cos turns a 1e-7 cosine difference into 3e-6 of p",
    "d_w, w', mom' per row set (the batch's label rows / the other rows, which the kernel "
    "computes alone): d_w 1e-4 x the set's max|d_w|; mom' 1e-4 x max|g| and w' 1e-4 x "
    "lr(1+mu) max|g|, g = mom' - mu*mom the gradient the plain update applied, each + 2 f32 "
    "eps x the set's max stored value",
)


def check_softmax(emb, w, mom, labels, d_ce, d_neg, kw, verbose=False):
    """The three margin_ce kernels against their plain versions on one
    case (limits: SOFTMAX_LIMITS); raises above a limit. Returns (gt, plain
    logz, plain top-k, max errors). W and mom are updated in place by the
    fused kernel."""
    from vlsfr_tpu_torch.ops import margin_stream as tms
    from vlsfr_tpu_torch.utils import parity

    def require(key, checks):
        for c in checks:
            if verbose:
                print("    " + parity.describe(c))
        bad = parity.failures(checks)
        if bad:
            raise RuntimeError("margin_ce disagrees: " + "; ".join(map(parity.describe, bad)))
        errs[key] = max(c["err"] for c in checks)

    errs = {}
    gt = tms.compute_gt(emb, w, labels)
    got = tms.margin_ce_fwd(emb, w, labels, gt, **kw)
    want = tms.margin_ce_fwd_plain(emb, w, labels, gt, **kw)
    for name, g, wn, tol in zip(("ce", "neg", "logz", "topk"), got, want,
                                (1e-4, 1e-4, 1e-4, 1e-5)):
        require(name, [{"name": name, "err": float((g - wn).abs().max()), "limit": tol}])
    logz, topk = want[2], want[3]
    bwd, fused = parity.margin_ce_bwd_checks(emb, w, mom, labels, gt, logz, topk, d_ce, d_neg,
                                             kw, LR, SGD)
    require("margin_ce_bwd", bwd)
    require("margin_ce_bwd_fused_sgd", fused)
    return gt, logz, topk, errs


def softmax_timing(emb, w, mom, labels, d_ce, d_neg, kw, gt, logz, topk):
    """Each margin_ce kernel, its plain version and a PyTorch composition of
    the same function (a yardstick the port never calls), with its bound."""
    import torch.nn.functional as F

    from vlsfr_tpu_torch.ops import margin_stream as tms

    b, d = emb.shape
    c, k = w.shape[0], kw["k"]
    args = (emb, w, labels, gt)
    bwd_args = (*args, logz, topk, d_ce, d_neg)
    out = {
        "margin_ce_fwd": dict(
            ms=cuda_ms(lambda: tms.margin_ce_fwd(*args, **kw), 10),
            plain_ms=cuda_ms(lambda: tms.margin_ce_fwd_plain(*args, **kw), 3, 1)),
        "margin_ce_bwd": dict(
            ms=cuda_ms(lambda: tms.margin_ce_bwd(*bwd_args, **kw), 5),
            plain_ms=cuda_ms(lambda: tms.margin_ce_bwd_plain(*bwd_args, **kw), 3, 1)),
        # the fused pair updates W and mom in place on every call; the work is the same
        "margin_ce_bwd_fused_sgd": dict(
            ms=cuda_ms(lambda: tms.margin_ce_bwd_fused_sgd(emb, w, mom, labels, gt, logz, topk,
                                                           d_ce, d_neg, LR, **SGD, **kw), 5),
            plain_ms=cuda_ms(lambda: tms.margin_ce_bwd_fused_sgd_plain(
                emb, w, mom, labels, gt, logz, topk, d_ce, d_neg, LR, **SGD, **kw), 3, 1)),
    }

    def library_fwd():  # yardsticks only: the port never calls these
        cos = emb @ F.normalize(w, dim=1).T
        torch.logsumexp(kw["scale"] * cos, dim=1)
        torch.topk(cos, k, dim=1)

    out["margin_ce_fwd"]["library_ms"] = cuda_ms(library_fwd, 5, 1)
    wn = F.normalize(w, dim=1)
    d_cos = torch.randn((b, c), device=emb.device).mul_(1e-4)
    w_s, mom_s = w.clone(), mom.clone()

    def library_bwd():
        torch.matmul(d_cos, wn)
        return torch.matmul(d_cos.T, emb)

    def library_fused():
        g = library_bwd().add_(w_s, alpha=SGD["weight_decay"])
        mom_s.mul_(SGD["momentum"]).add_(g)
        w_s.sub_(g.add_(mom_s, alpha=SGD["momentum"]), alpha=LR)

    out["margin_ce_bwd"]["library_ms"] = cuda_ms(library_bwd, 5, 1)
    out["margin_ce_bwd_fused_sgd"]["library_ms"] = cuda_ms(library_fused, 5, 1)
    del wn, d_cos, w_s, mom_s
    product = 2.0 * b * d * c
    vecs = 4 * (b * d + 4 * b)  # emb + labels, gt, logz/d_ce, d_neg
    out["margin_ce_fwd"].update(bound(product, 4 * c * d + vecs + 4 * b * (3 + k)))
    out["margin_ce_bwd"].update(bound(3 * product, 8 * c * d + vecs + 4 * b + 4 * b * d))
    out["margin_ce_bwd_fused_sgd"].update(
        bound(3 * product + 8.0 * c * d, 16 * c * d + vecs + 4 * b + 8 * b * d))
    for name, v in out.items():
        print(f"  {name}: ms={v['ms']:.3f} bound_ms={v['bound_ms']:.3f} ({v['bound_by']}: "
              f"{v['flop']:.3e} FLOP, {v['bytes']:.3e} B) plain_ms={v['plain_ms']:.3f} "
              f"library_ms={v['library_ms']:.3f}")
    return out


def softmax_trainer(route_a: bool, saved_dir: str):
    from vlsfr_tpu_torch.config import Config
    from vlsfr_tpu_torch.train.trainer import Trainer

    cfg = Config().apply_overrides([
        "model.net_type=ir50", "model.feat_dim=512", "model.dtype=bfloat16",
        "data.batch_size=128", "data.image_size=112", "pool.head=full_softmax",
        f"pool.num_classes={SOFTMAX['c']}", "pool.classifier_dtype=float32",
        "pool.classifier_mom_dtype=float32", "loss.loss_type=Arc", "loss.margin=0.5",
        "loss.scale=32", "data.synthetic_ids=200", "data.synthetic_images_per_id=3",
        "data.num_workers=4", "train.print_freq=1", "optim.lr=0.1",
        f"pool.fused_update={'auto' if route_a else 'off'}"])
    cfg.data.synthetic = True
    cfg.train.saved_dir = saved_dir
    trainer = Trainer(cfg)  # the normal entry point; runs on cuda
    if (trainer.state.classifier_mom is not None) != route_a:
        raise RuntimeError(f"route {'A' if route_a else 'B'} was not selected")
    return trainer


def softmax_train_phase(card: str):
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        return softmax_routes(card, tmp)


def softmax_routes(card: str, tmp: str):
    """Routes B and A through the Trainer; A's first step against B's."""
    from vlsfr_tpu_torch.ops import margin_stream as tms
    from vlsfr_tpu_torch.utils import parity

    print("  route B (pool.fused_update=off): one step from the seed on batch (0, 0)")
    trainer = softmax_trainer(route_a=False, saved_dir=tmp)
    batch = trainer.pipeline.make_batch(0, 0)
    w0 = trainer.state.classifier.detach().clone()
    loss_b = float(trainer.train_step(trainer.state, batch.images, batch.labels, 1.0)["loss"])
    w_b = trainer.state.classifier.detach().clone()
    tms.reset_launch_counts()
    out_b = trainer.train(max_steps=ROUTE_B_STEPS)
    torch.cuda.synchronize()
    launches_b = dict(tms.LAUNCH_COUNTS)
    trainer.close()
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  route B {ROUTE_B_STEPS} steps: {json.dumps(out_b)}")
    print(f"  margin_ce launches in the route-B run: {launches_b}")
    if launches_b != {"margin_ce_fwd": ROUTE_B_STEPS, "margin_ce_bwd": ROUTE_B_STEPS,
                      "margin_ce_bwd_fused_sgd": 0} or not math.isfinite(out_b["loss"]):
        raise RuntimeError(f"route B must launch fwd and bwd once per step: {launches_b}")

    print("  route A (the default): the same step from the same seed")
    trainer = softmax_trainer(route_a=True, saved_dir=tmp)
    try:
        batch = trainer.pipeline.make_batch(0, 0)
        loss_a = float(trainer.train_step(trainer.state, batch.images, batch.labels,
                                          1.0)["loss"])
        w_a = trainer.state.classifier
        # the first step's momentum is 0 on both routes, so w' - w is
        # -lr(1 + mu) g: the limit per row set is 1e-4 x max|w' - w| there
        checks = parity.by_rows("classifier A vs B", w_a, w_b, w_b - w0,
                                torch.from_numpy(batch.labels), 1e-4, rounding=2.0)
        print(f"    first-step loss A {loss_a:.6f} B {loss_b:.6f} (1e-5 relative); the fused "
              f"kernel against the unfused kernel + torch SGD on the same embeddings, per row "
              f"set, 1e-4 x max|w' - w| + 2 f32 eps x max|w'|:")
        for c in checks:
            print("      " + parity.describe(c))
        if not abs(loss_a - loss_b) <= 1e-5 * abs(loss_b) or parity.failures(checks):
            raise RuntimeError("route A's first step disagrees with route B's")
        del w0, w_b
        torch.cuda.empty_cache()
        tms.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = trainer.train(max_steps=TRAIN_STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(tms.LAUNCH_COUNTS)
        peak = torch.cuda.max_memory_allocated()
        print(f"  route A {TRAIN_STEPS} steps: {json.dumps(out)}")
        print(f"  margin_ce launches in the route-A run: {launches}")
        if launches != {"margin_ce_fwd": TRAIN_STEPS, "margin_ce_bwd": 0,
                        "margin_ce_bwd_fused_sgd": TRAIN_STEPS}:
            raise RuntimeError(f"route A must launch fwd and fused once per step: {launches}")
        if not (math.isfinite(out["loss"]) and out["loss"] > 0
                and out["final_step"] == TRAIN_STEPS
                and bool(torch.isfinite(trainer.state.classifier[:65536]).all())):
            raise RuntimeError(f"route A did not produce a finite loss and classifier: {out}")
        step_ms = 128 / out["images_per_sec"] * 1e3
        print(f"  route A step time {step_ms:.1f} ms (last window, {card}); {TRAIN_STEPS} steps "
              f"{wall:.2f} s wall incl. first-step warm-up; peak memory "
              f"{peak / 2**30:.2f} GiB ({card})")
        print("== phase 10: profile of two more route-A steps")
        state, scale = trainer.state, trainer.plateau.scale
        profile_steps(lambda b: trainer.train_step(state, b.images, b.labels, scale),
                      [trainer.pipeline.make_batch(0, s) for s in range(2)])
    finally:
        trainer.close()
    launches["margin_ce_bwd"] = launches_b["margin_ce_bwd"]  # the route-B run's count
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from vlsfr_tpu_torch.ops.cuda_build import build_all

    print("== phase 1: device")
    card = smi_line()
    print(card)
    print(f"  torch {torch.__version__} cuda {torch.version.cuda}; device "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"  torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"torch.backends.cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")

    print("== phase 2: build")
    t0 = time.perf_counter()
    for name, log in build_all().items():
        print(f"  {name}.cu ptxas report:")
        print("\n".join("    " + ln for ln in log.splitlines()
                        if "registers" in ln or "spill" in ln or "entry function" in ln))
    print(f"  build {time.perf_counter() - t0:.1f} s")

    print("== phase 3: quad parity at full width")
    full = make_case(SLICE["q"], SLICE["b"], SLICE["d"], SLICE["k"], "Arc", seed=0)
    fwd_plain, errs = check_pair(*full)
    for loss_type in ("AM", "SV"):
        check_pair(*make_case(4096, SLICE["b"], SLICE["d"], SLICE["k"], loss_type, seed=1))

    print("== phase 4: quad timing (full width)")
    times = timing(*full, fwd_plain)
    del full, fwd_plain
    torch.cuda.empty_cache()

    print("== phase 5: FFC training through the Trainer")
    launches = train_phase(card)
    gc.collect()
    torch.cuda.empty_cache()

    print("== phase 7: margin_ce parity at full width; limits:")
    for line in SOFTMAX_LIMITS:
        print(f"  {line}")
    full = softmax_case(SOFTMAX["c"], "Arc", 1, 0.0, seed=2)
    gt, logz, topk, serrs = check_softmax(*full, verbose=True)
    for loss_type, k, frac in (("AM", 1, 0.0), ("SV", 1, 0.0), ("Arc", 3, 0.3)):
        check_softmax(*softmax_case(4096, loss_type, k, frac, seed=3), verbose=True)

    print("== phase 8: margin_ce timing (full width)")
    times.update(softmax_timing(*full, gt, logz, topk))
    del full, gt, logz, topk
    gc.collect()
    torch.cuda.empty_cache()

    print("== phase 9: softmax training through the Trainer")
    launches.update(softmax_train_phase(card))

    fwd_keys = ("ce", "neg", "logz", "topk")
    kernels = []
    for name, src, replaces, err in (
            ("quad_fwd", "quad_margin", "twin_margin.py:1840", max(errs[k] for k in fwd_keys)),
            ("quad_bwd", "quad_margin", "twin_margin.py:1891", errs["d_emb"]),
            ("margin_ce_fwd", "margin_ce", "margin_pallas.py:390",
             max(serrs[k] for k in fwd_keys)),
            ("margin_ce_bwd", "margin_ce", "margin_pallas.py:557", serrs["margin_ce_bwd"]),
            ("margin_ce_bwd_fused_sgd", "margin_ce", "margin_pallas.py:803",
             serrs["margin_ce_bwd_fused_sgd"])):
        t = times[name]
        if launches[name] < 1:
            raise RuntimeError(f"{name} was not launched on its path")
        kernels.append({"name": name, "route": "cuda",
                        "source": f"vlsfr_tpu_torch/csrc/{src}.cu",
                        "replaces": f"vlsfr_tpu/ops/{replaces}",
                        "launches": launches[name], "max_abs_err": err, "ms": t["ms"],
                        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                        "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    print(smi_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
