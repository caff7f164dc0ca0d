#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (``vlsfr_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA card:

    python3 chip_smoke.py

It drives every ported path, each with its kernels' launch counters set to
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
   version, and a PyTorch composition of the same function as a yardstick
   (forward: matmul + logsumexp + topk; backward: the cosine recompute and
   d_cos @ queue over a materialised [2b, Q] d_cos); the bound is the
   larger of FLOP / 67 TFLOP/s (f32, no tensor cores) and bytes / 3.35 TB/s;
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
Sparse-classifier routes (D: sparse-d_w streaming at sparse_grad_rate 0.05,
E: partial-FC at sample_rate 0.1, both with sparse row updates):
11. parity — the forward with tile statistics and the sparse backward
   against their plain versions at full width (B = 128, D = 512, C = 2^20,
   tile 512, Arc, k = 1, a repeated label): ce / neg / logz / top-k as in
   phase 7, maxcos 1e-5 and maxz 32 × 1e-5 absolute; M = 128 tiles picked
   from the PLAIN statistics with a seeded random fill, and both backward
   versions given those same tiles; the d_w rows per row set (the rows
   that hold a batch label / the others) to 1e-4 × the set's max, d_emb's
   streamed part to 1e-4 × its max, d_gt 1e-5; then AM, SV and k = 3 with
   outlier rows at C = 4096, and Arc at C = 4000 (a ragged last tile);
12. timing — the sparse kernel, its plain version, a cuBLAS composition
   (index_select of the rows, three matmuls, the elementwise d_cos) and
   its bound; the forward with and without statistics, in turns;
13. training, route D — at sparse_grad_rate 1.0 (every tile, weight 1,
   so the gradient is exact) its first step against route B's from phase 9
   (loss 1e-5 relative, classifier per row set); then 4 steps at 0.05
   through ``Trainer.train``, each of margin_ce_fwd (with statistics),
   margin_ce_bwd (the exact d_emb) and margin_ce_bwd_sparse launching once
   per step; one more step after which the rows not selected must be
   bit-unchanged and the selected ones must equal an f64 plain update from
   the step's d_w rows (catch-up included); a profile of two warm steps;
14. training, route E — 2 steps: finite loss, 104,857 sampled classes, no
   margin_ce launch;
Sharded FFC slice (the FFC step model-sharded, ``pool.force_sharded`` on one
card over a real NCCL group of one):
15. parity — the partial kernels at the FFC slice's full width (phase 3's
   case, its slots spread over the queue by an odd multiplier so that every
   block owns targets and some row's target and write lie in different
   blocks): the queue as one block of 2^20 and as four emulated shards of
   2^18, each block's kernels against their plain versions and the blocks
   merged as the collectives merge them against quad_fwd / quad_bwd on the
   whole queue (``vlsfr_tpu_torch/utils/parity.py: quad_shard_checks``,
   limits there); then AM and SV at Q = 4096 in four blocks;
16. timing — both partial kernels over a 2^20 block (world 1) and a 2^18
   block (a 4-card shard): kernel, plain version, the phase-4 yardstick over
   the block, bound;
17. training — ``Trainer`` with ``pool.force_sharded=true``: its first step
   against the single-shard Trainer's first step from the same seed and
   batch, both with an f32 backbone (loss 1e-5 relative, probe parameters
   and BN statistics 1e-5 relative + 2e-5 absolute, the queue after the
   write bit-equal; bf16 compute rounds each weight gradient to 8 bits,
   which would hide the head behind its rounding); then, on the slice's
   bf16 config, 4
   steps through ``Trainer.train``, each partial kernel launching once per
   step and quad_fwd / quad_bwd never; step time, peak memory and a profile
   of two warm steps (NCCL's share included); the process group destroyed;
Class-sharded softmax head (routes A, B and D over a class-sharded classifier,
``make_softmax_train_step(..., mesh=)`` on one card over an NCCL group of one):
18. parity — the partial margin_ce kernels against their plain versions at
   full width (B = 128, D = 512, k = 1, Arc, scale 32, margin 0.5, a
   repeated label): the classifier as one 2^20 block, then a 5,000,000-class
   classifier as 4 emulated blocks of 1,250,000 (one card's block of the
   shipped ``configs/partial_fc_ir50_5m_ids.json``; ragged last tiles), each
   block's kernels against their plain versions and the blocks merged as
   the collectives merge them against margin_ce_fwd / margin_ce_bwd on the
   whole classifier (``vlsfr_tpu_torch/utils/parity.py: margin_shard_checks``,
   limits there); on one emulated block with its −2 rows, the fused-SGD
   kernel and margin_ce_bwd with ``pos_rows`` and route D's forward with
   statistics, selection and sparse backward against their plain versions;
   then AM and SV (and Arc at k = 3 with outlier rows) at C = 4096 in 4
   blocks;
19. timing — both partial kernels over a 2^20 block and a 1,250,000 block:
   kernel, plain version, a cuBLAS composition as a yardstick, bound;
20. training — ``make_softmax_train_step(cfg, schedule, mesh=<NCCL group of
   one>)`` on the softmax slice (ir50, 2^20 f32 classes) for routes A, B and
   D: each first step against the single-device route's first step from the
   same seed and batch on an f32 backbone (loss 1e-5 relative, classifier
   per row set as phase 9, backbone parameters 1e-5 relative + 2e-5
   absolute); then on the bf16 config route A 4 steps, B and D 2 each, each
   step launching its kernels once (A: margin_partial_fwd and the fused
   kernel; B: both partial kernels; D: the forward with statistics, the
   sparse kernel and margin_ce_bwd); step time, peak memory, and a profile
   of two warm route-A steps (NCCL's share included); the group destroyed;
then the ``kernels`` JSON line (ten kernels), and the device JSON line last.

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
ROUTE_E_STEPS = 2
SPARSE_RATE = 0.05  # route D's pool.sparse_grad_rate: 128 of 2048 tiles
SAMPLE_RATE = 0.1  # route E's pool.sample_rate: 104,857 sampled classes
SHARDS = 4  # the emulated shards of phase 15: a 4-card run's 2^18-slot blocks
SHIPPED_CLASSES = 5_000_000  # configs/partial_fc_ir50_5m_ids.json: mesh.model = 4
CLASS_SHARDS = 4  # its blocks of 1,250,000 classes, emulated in phase 18
SLOT_MULT = 0x9E3779B1  # odd: slot -> slot * SLOT_MULT mod Q permutes a 2^k queue


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


def raw_case(q: int, b: int, d: int, seed: int):
    """A queue, probes, gallery rows and a realistic write plan: the port's
    DCP planner after a few warm-up steps (pool hits, seen flags, in-pool
    probe labels), with one label three times in each gallery half so two
    writes land on the same (row, slot). Returns the queue, the generator
    (for more draws) and (p_x, p_y, g_a, g_b, plan_a, plan_b, labels_a,
    labels_b)."""
    from vlsfr_tpu_torch.core.dcp import DCPManager
    from vlsfr_tpu_torch.core.ffc import init_queue

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
    return queue, gen, (p_x, p_y, g_a, g_b, pa, pb, la, lb)


def make_case(q: int, b: int, d: int, k: int, loss_type: str, seed: int):
    """Packed kernel inputs of ``raw_case``, and cotangents."""
    from vlsfr_tpu_torch.ops import twin_margin as ttm

    queue, gen, (p_x, p_y, g_a, g_b, pa, pb, la, lb) = raw_case(q, b, d, seed)
    packed = ttm.pack_dirs(p_x, p_y, ttm.dir_inputs(queue, g_a, *pa),
                           ttm.dir_inputs(queue, g_b, *pb), la, lb,
                           ttm.compute_twin_gt(p_x, queue, g_a, *pa, la),
                           ttm.compute_twin_gt(p_y, queue, g_b, *pb, lb))
    kw = dict(b=b, loss_type=loss_type, margin=0.5, scale=32.0, k=k, mask_svfc=1.2)
    cot = torch.randn((4, 2 * b), generator=gen, device=queue.device) / b
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
    d_cos = torch.randn((r_, q), device=E.device).mul_(1e-4)  # [2b, Q] f32: 1 GB

    def library_bwd():  # the cosine recompute and d_emb = d_cos @ queue
        torch.matmul(E, q0.T)
        torch.matmul(d_cos, q0)

    out["quad_bwd"]["library_ms"] = cuda_ms(library_bwd, 5, 1)
    del d_cos
    vec_bytes = 4 * (3 * r_ * d + 6 * r_)  # E, G, V + the [R] / [2, R] row vectors
    q0_bytes = 4 * q * d
    fwd_flop = 2.0 * r_ * d * q
    fwd_bytes = q0_bytes + vec_bytes + 4 * 2 * r_ * (3 + kw["k"])
    bwd_flop = 4.0 * r_ * d * q
    bwd_bytes = q0_bytes + vec_bytes + 4 * 8 * r_ + 4 * (r_ * d + 2 * r_)
    out["quad_fwd"].update(bound(fwd_flop, fwd_bytes))
    out["quad_bwd"].update(bound(bwd_flop, bwd_bytes))
    print_times(out)
    return out


def print_times(out: dict) -> None:
    for name, v in out.items():
        print(f"  {name}: ms={v['ms']:.3f} bound_ms={v['bound_ms']:.3f} ({v['bound_by']}: "
              f"{v['flop']:.3e} FLOP, {v['bytes']:.3e} B) plain_ms={v['plain_ms']:.3f} "
              f"library_ms={v['library_ms']:.3f}")


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
    if "nccl" in low:
        return "NCCL collectives"
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


def ffc_trainer(saved_dir: str, *overrides: str):
    """The FFC slice's Trainer (ir50, 512-d, batch 128, 2^20-slot f32 queue,
    Arc, fuse_forward, bf16 compute) over a raw-pixel synthetic store."""
    from vlsfr_tpu_torch.config import Config
    from vlsfr_tpu_torch.train.trainer import Trainer

    cfg = Config().apply_overrides([
        "model.net_type=ir50", "model.feat_dim=512", "model.dtype=bfloat16",
        "data.batch_size=128", "data.image_size=112", f"pool.queue_size={1 << 20}",
        "pool.queue_dtype=float32", "loss.loss_type=Arc", "loss.margin=0.5", "loss.scale=32",
        "pool.fuse_forward=true", "data.synthetic_ids=200", "data.synthetic_images_per_id=3",
        "data.num_workers=4", "train.print_freq=1", "optim.lr=0.1", *overrides])
    cfg.data.synthetic = True
    cfg.train.saved_dir = saved_dir
    return Trainer(cfg)  # the normal entry point; runs on cuda


def train_phase(card: str):
    from vlsfr_tpu_torch.ops import twin_margin as ttm

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        torch.cuda.reset_peak_memory_stats()
        trainer = ffc_trainer(tmp)
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
    if launches != {"quad_fwd": TRAIN_STEPS, "quad_bwd": TRAIN_STEPS, "quad_partial_fwd": 0,
                    "quad_partial_bwd": 0}:
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
    print_times(out)
    return out


def softmax_trainer(saved_dir: str, *overrides: str):
    from vlsfr_tpu_torch.config import Config
    from vlsfr_tpu_torch.train.trainer import Trainer

    cfg = Config().apply_overrides([
        "model.net_type=ir50", "model.feat_dim=512", "model.dtype=bfloat16",
        "data.batch_size=128", "data.image_size=112", "pool.head=full_softmax",
        f"pool.num_classes={SOFTMAX['c']}", "pool.classifier_dtype=float32",
        "pool.classifier_mom_dtype=float32", "loss.loss_type=Arc", "loss.margin=0.5",
        "loss.scale=32", "data.synthetic_ids=200", "data.synthetic_images_per_id=3",
        "data.num_workers=4", "train.print_freq=1", "optim.lr=0.1", *overrides])
    cfg.data.synthetic = True
    cfg.train.saved_dir = saved_dir
    return Trainer(cfg)  # the normal entry point; runs on cuda


def softmax_train_phase(card: str, tmp: str):
    """Routes B and A through the Trainer; A's first step against B's.
    Returns the launch counts and route B's first step (loss, the
    classifier before and after it, on the host, and the batch's labels)
    for route D's check."""
    from vlsfr_tpu_torch.ops import margin_stream as tms
    from vlsfr_tpu_torch.utils import parity

    print("  route B (pool.fused_update=off): one step from the seed on batch (0, 0)")
    trainer = softmax_trainer(tmp, "pool.fused_update=off")
    if trainer.state.classifier_mom is not None:
        raise RuntimeError("route B was not selected")
    batch = trainer.pipeline.make_batch(0, 0)
    w0 = trainer.state.classifier.detach().clone()
    loss_b = float(trainer.train_step(trainer.state, batch.images, batch.labels, 1.0)["loss"])
    w_b = trainer.state.classifier.detach().clone()
    ref_b = dict(loss=loss_b, w0=w0.cpu(), w=w_b.cpu(), labels=torch.from_numpy(batch.labels))
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
                      "margin_ce_bwd_fused_sgd": 0, "margin_ce_bwd_sparse": 0,
                      "margin_partial_fwd": 0, "margin_partial_bwd": 0} \
            or not math.isfinite(out_b["loss"]):
        raise RuntimeError(f"route B must launch fwd and bwd once per step: {launches_b}")

    print("  route A (the default): the same step from the same seed")
    trainer = softmax_trainer(tmp)
    try:
        if trainer.state.classifier_mom is None:
            raise RuntimeError("route A was not selected")
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
                        "margin_ce_bwd_fused_sgd": TRAIN_STEPS, "margin_ce_bwd_sparse": 0,
                        "margin_partial_fwd": 0, "margin_partial_bwd": 0}:
            raise RuntimeError(f"route A must launch fwd and fused once per step: {launches}")
        if not (math.isfinite(out["loss"]) and out["loss"] > 0
                and out["final_step"] == TRAIN_STEPS
                and bool(torch.isfinite(trainer.state.classifier[:65536]).all())):
            raise RuntimeError(f"route A did not produce a finite loss and classifier: {out}")
        print_step(f"route A", out, wall, peak, card)
        print("== phase 10: profile of two more route-A steps")
        profile_trainer(trainer)
    finally:
        trainer.close()
    launches["margin_ce_bwd"] = launches_b["margin_ce_bwd"]  # the route-B run's count
    return launches, ref_b


def print_step(route: str, out: dict, wall: float, peak: int, card: str) -> None:
    step_ms = SOFTMAX["b"] / out["images_per_sec"] * 1e3
    print(f"  {route} step time {step_ms:.1f} ms (last window, {card}); {out['final_step']} "
          f"steps {wall:.2f} s wall incl. first-step warm-up; peak memory "
          f"{peak / 2**30:.2f} GiB ({card})")


def profile_trainer(trainer) -> None:
    state, scale = trainer.state, trainer.plateau.scale
    profile_steps(lambda b: trainer.train_step(state, b.images, b.labels, scale),
                  [trainer.pipeline.make_batch(0, s) for s in range(2)])


def free_trainer(trainer) -> None:
    trainer.close()
    del trainer
    gc.collect()
    torch.cuda.empty_cache()


def route_d_rows() -> int:
    """The classifier rows route D gives a gradient each step at
    SPARSE_RATE, from the trainer's own geometry and tile budget (65,536
    at the slice's width)."""
    from vlsfr_tpu_torch.ops import margin_stream as tms

    tile, n_tiles = tms.sparse_bwd_geometry(SOFTMAX["b"], SOFTMAX["d"], SOFTMAX["c"])
    return tile * tms.sparse_m_tiles(SPARSE_RATE, n_tiles, SOFTMAX["b"])


def check_sparse(c: int, loss_type: str, k: int, frac_outlier: float, seed: int):
    """The forward with statistics and the sparse backward against their
    plain versions on one case (``parity.sparse_path_checks``); raises
    above a limit. Returns the case, the tiles and the max errors."""
    from vlsfr_tpu_torch.ops import margin_stream as tms
    from vlsfr_tpu_torch.utils import parity

    emb, w, mom, labels, d_ce, d_neg, kw = softmax_case(c, loss_type, k, frac_outlier, seed)
    del mom
    b, d = emb.shape
    tile, n_tiles = tms.sparse_bwd_geometry(b, d, c)
    m = tms.sparse_m_tiles(SPARSE_RATE, n_tiles, b)
    gen = torch.Generator(device=emb.device).manual_seed(seed)
    u = torch.rand((n_tiles,), generator=gen, device=emb.device)
    checks, tile_idx, (gt, logz, topk) = parity.sparse_path_checks(emb, w, labels, d_ce, d_neg,
                                                                    kw, tile, m, u)
    torch.cuda.synchronize()
    print(f"    tile {tile}, {m} of {n_tiles} tiles selected from the plain statistics")
    for ch in checks:
        print("    " + parity.describe(ch))
    bad = parity.failures(checks)
    if bad:
        raise RuntimeError("forward statistics / sparse backward disagree: "
                           + "; ".join(map(parity.describe, bad)))
    errs = {"stats": max(ch["err"] for ch in checks if ch["name"] in ("maxz", "maxcos")),
            "sparse": max(ch["err"] for ch in checks if ch["name"].startswith("sparse"))}
    return (emb, w, labels, d_ce, d_neg, kw, tile, tile_idx, gt, logz, topk), errs


def sparse_timing(emb, w, labels, d_ce, d_neg, kw, tile, tile_idx, gt, logz, topk):
    """The sparse kernel, its plain version, a cuBLAS composition of the
    same function (a yardstick the port never calls) and its bound; the
    forward with and without statistics, in turns."""
    import torch.nn.functional as F

    from vlsfr_tpu_torch.ops import margin_stream as tms

    b, d = emb.shape
    m = tile_idx.shape[0]
    ncols = m * tile
    args = (emb, w, labels, gt, logz, topk, d_ce, d_neg, tile_idx)
    out = dict(ms=cuda_ms(lambda: tms.margin_ce_bwd_sparse(*args, tile=tile, **kw), 10),
               plain_ms=cuda_ms(lambda: tms.margin_ce_bwd_sparse_plain(*args, tile=tile, **kw),
                                3, 1))
    cols = (tile_idx.long()[:, None] * tile
            + torch.arange(tile, device=emb.device)[None, :]).reshape(-1)
    scale = kw["scale"]

    def library_sparse():  # the gather reference's composition in cuBLAS f32
        wn = F.normalize(torch.index_select(w, 0, cols), dim=1)
        d_cos = torch.exp(scale * torch.matmul(emb, wn.T) - logz[:, None])
        d_cos.mul_(d_ce[:, None] * scale)
        torch.matmul(d_cos, wn)
        torch.matmul(d_cos.T, emb)

    out["library_ms"] = cuda_ms(library_sparse, 10, 1)
    # three products over the selected columns; W tiles read, d_w rows
    # written, emb and the row vectors read, d_emb written
    out.update(bound(3 * 2.0 * b * d * ncols, 8 * ncols * d + 4 * (b * d + 4 * b) + 4 * m
                     + 4 * b * d))
    print_times({"margin_ce_bwd_sparse": out})
    def fwd(with_stats):
        return lambda: tms.margin_ce_fwd(emb, w, labels, gt, with_stats=with_stats, tile=tile,
                                         **kw)

    t = [cuda_ms(fwd(ws), 10) for ws in (False, True, True, False)]
    print(f"  margin_ce_fwd without / with statistics, in turns: {t[0]:.3f} / {t[1]:.3f} / "
          f"{t[2]:.3f} / {t[3]:.3f} ms")
    return {"margin_ce_bwd_sparse": out}


def route_d_phase(card: str, tmp: str, ref_b: dict) -> dict:
    """Route D against route B's first step at rate 1.0, then 4 steps at
    SPARSE_RATE, the row-update check on one more step and a profile."""
    from vlsfr_tpu_torch.ops import margin_stream as tms
    from vlsfr_tpu_torch.train import softmax_head
    from vlsfr_tpu_torch.utils import parity

    print("  route D at pool.sparse_grad_rate=1.0 (every tile, weight 1): the first step of "
          "phase 9's route B")
    trainer = softmax_trainer(tmp, "pool.sparse_update=true", "pool.sparse_grad_rate=1.0")
    try:
        batch = trainer.pipeline.make_batch(0, 0)
        m = trainer.train_step(trainer.state, batch.images, batch.labels, 1.0)
        loss_d = float(m["loss"])
        w0, w_b = ref_b["w0"].cuda(), ref_b["w"].cuda()
        if m["grad_rows"] != SOFTMAX["c"] or not torch.equal(ref_b["labels"],
                                                             torch.from_numpy(batch.labels)):
            raise RuntimeError(f"route D at rate 1.0 must cover every row of the same batch: {m}")
        checks = parity.by_rows("classifier D vs B", trainer.state.classifier, w_b, w_b - w0,
                                ref_b["labels"], 1e-4, rounding=2.0)
        print(f"    first-step loss D {loss_d:.6f} B {ref_b['loss']:.6f} (1e-5 relative); the "
              f"sparse kernel + sparse row update against the dense kernel + torch SGD, per row "
              f"set, 1e-4 x max|w' - w| + 2 f32 eps x max|w'|:")
        for c in checks:
            print("      " + parity.describe(c))
        if not abs(loss_d - ref_b["loss"]) <= 1e-5 * abs(ref_b["loss"]) or parity.failures(checks):
            raise RuntimeError("route D at rate 1.0 disagrees with route B's first step")
        del w0, w_b
    finally:
        free_trainer(trainer)

    print(f"  route D at pool.sparse_grad_rate={SPARSE_RATE}: {TRAIN_STEPS} steps")
    trainer = softmax_trainer(tmp, "pool.sparse_update=true",
                              f"pool.sparse_grad_rate={SPARSE_RATE}")
    try:
        state = trainer.state
        tms.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = trainer.train(max_steps=TRAIN_STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(tms.LAUNCH_COUNTS)
        peak = torch.cuda.max_memory_allocated()
        print(f"  route D {TRAIN_STEPS} steps: {json.dumps(out)}")
        print(f"  margin_ce launches in the route-D run: {launches}")
        if launches != {"margin_ce_fwd": TRAIN_STEPS, "margin_ce_bwd": TRAIN_STEPS,
                        "margin_ce_bwd_fused_sgd": 0, "margin_ce_bwd_sparse": TRAIN_STEPS,
                        "margin_partial_fwd": 0, "margin_partial_bwd": 0}:
            raise RuntimeError(f"route D must launch fwd, bwd and sparse once per step: {launches}")
        if not (math.isfinite(out["loss"]) and out["loss"] > 0
                and out["grad_rows"] == route_d_rows() and out["final_step"] == TRAIN_STEPS):
            raise RuntimeError(f"route D did not produce a finite loss over {route_d_rows()} "
                               f"rows: {out}")
        print_step("route D", out, wall, peak, card)
        check_row_update(trainer, softmax_head)
        print("== phase 13b: profile of two more route-D steps")
        profile_trainer(trainer)
    finally:
        free_trainer(trainer)
    return launches


def check_row_update(trainer, softmax_head) -> None:
    """One more route-D step: the rows not selected (last-visit not this
    step) are bit-unchanged, classifier and momentum; the selected rows
    equal an f64 plain update from the pre-step state and the step's d_w
    rows (recorded), catch-up over each row's gap included."""
    state = trainer.state
    s = state.step
    w_before, mom_before = state.classifier.clone(), state.classifier_mom.clone()
    last_before = state.classifier_last.clone()
    rec = {}
    update = softmax_head.sparse_sgd_rows

    def recording(w, mom, idx, grad_rows, **kw):
        rec.update(idx=idx.clone(), grad=grad_rows.clone(), **kw)
        return update(w, mom, idx, grad_rows, **kw)

    softmax_head.sparse_sgd_rows = recording
    try:
        batch = trainer.pipeline.make_batch(0, TRAIN_STEPS % trainer.steps_per_epoch)
        trainer.train_step(state, batch.images, batch.labels, trainer.plateau.scale)
    finally:
        softmax_head.sparse_sgd_rows = update
    sel = state.classifier_last == s
    changed = ((state.classifier != w_before).any(dim=1)
               | (state.classifier_mom != mom_before).any(dim=1))
    n_sel, stray = int(sel.sum()), int((changed & ~sel).sum())
    idx = rec["idx"].long()
    mu, nesterov, wd, lr = rec["momentum"], rec["nesterov"], rec["weight_decay"], rec["lr"]
    w0, m0 = w_before[idx].double(), mom_before[idx].double()
    gap = (s - last_before[idx].double() - 1).clamp(min=0)[:, None]
    geo = mu * (1 - mu ** gap) / (1 - mu)
    catchup = (mu * geo if nesterov else geo) * m0
    g = rec["grad"].double() + wd * w0
    m_new = mu * (mu ** gap) * m0 + g
    w_want = w0 - lr * ((g + mu * m_new if nesterov else m_new) + catchup)
    err = float((state.classifier[idx].double() - w_want).abs().max())
    limit = 1e-5 * float((w_want - w0).abs().max()) + 4 * 1.19e-7 * float(w_want.abs().max())
    print(f"  one more step: {n_sel} rows selected (gaps {int(gap.min())}-{int(gap.max())} "
          f"steps), {stray} other rows changed (0 allowed); selected rows against an f64 plain "
          f"update: max |err| {err:.3e} <= {limit:.3e} (1e-5 x max|w' - w| + 4 f32 eps x max|w'|)")
    if n_sel != route_d_rows() or stray or not err <= limit:
        raise RuntimeError("route D's row update touched other rows or disagrees")


def route_e_phase(card: str, tmp: str) -> None:
    from vlsfr_tpu_torch.ops import margin_stream as tms

    trainer = softmax_trainer(tmp, f"pool.sample_rate={SAMPLE_RATE}", "pool.sparse_update=true")
    try:
        tms.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = trainer.train(max_steps=ROUTE_E_STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        print(f"  route E {ROUTE_E_STEPS} steps: {json.dumps(out)}")
        print(f"  margin_ce launches in the route-E run: {dict(tms.LAUNCH_COUNTS)}")
        want_s = max(SOFTMAX["b"], int(SOFTMAX["c"] * SAMPLE_RATE))
        if any(tms.LAUNCH_COUNTS.values()) or not (
                math.isfinite(out["loss"]) and out["loss"] > 0
                and out["sampled_classes"] == want_s and out["final_step"] == ROUTE_E_STEPS):
            raise RuntimeError(f"route E must train {want_s} sampled classes, no margin_ce: {out}")
        print_step("route E", out, wall, peak, card)
    finally:
        free_trainer(trainer)


def shard_case(q: int, loss_type: str, seed: int):
    """``raw_case`` with its slots moved by slot -> slot·SLOT_MULT mod q (a
    permutation: duplicates, written labels and pool hits keep their
    structure) so that the targets spread over the SHARDS blocks; asserts
    that every block owns targets and that some row's target and write lie
    in different blocks. Returns quad_shard_checks's inputs and the loss
    arguments."""
    b, d, k = SLICE["b"], SLICE["d"], SLICE["k"]
    queue, gen, (p_x, p_y, g_a, g_b, pa, pb, la, lb) = raw_case(q, b, d, seed)
    move = lambda c: torch.where(c >= 0, (c.long() * SLOT_MULT) % q, c.long()).to(c.dtype)  # noqa: E731
    pa, pb = (pa[0], move(pa[1]), pa[2]), (pb[0], move(pb[1]), pb[2])
    la, lb = move(la), move(lb)
    c_local = q // SHARDS
    labels = torch.cat([la, lb])
    owners = set((labels[labels >= 0] // c_local).tolist())
    split = ((la >= 0) & (la // c_local != pa[1] // c_local)).any()
    if owners != set(range(SHARDS)) or not split:
        raise RuntimeError(f"the case must put targets in every block ({sorted(owners)}) and a "
                           f"row's target and write in different blocks ({bool(split)})")
    cot = torch.randn((4, 2 * b), generator=gen, device=queue.device) / b
    pos = (labels >= 0)[None, :]
    dce = torch.where(pos, cot[:2], 0.0).contiguous()
    dneg = torch.where(pos, 0.0, cot[2:]).contiguous()
    kw = dict(loss_type=loss_type, margin=0.5, scale=32.0, k=k, mask_svfc=1.2)
    print(f"  case Q={q} {loss_type}: {int(pos.sum())}/{2 * b} in-pool probe rows, targets in "
          f"all {SHARDS} blocks")
    return (p_x, p_y, queue, g_a, g_b, pa, pb, la, lb, dce, dneg), kw


def shard_parity(case, kw, n_shards: int) -> dict:
    """quad_shard_checks on one case; raises above a limit. Returns the
    max errors of the partial forward (state and top-k) and backward
    (d_emb)."""
    from vlsfr_tpu_torch.utils import parity

    checks = parity.quad_shard_checks(*case, kw, n_shards=n_shards)
    torch.cuda.synchronize()
    for c in checks:
        print("    " + parity.describe(c))
    bad = parity.failures(checks)
    if bad:
        raise RuntimeError("the sharded quad head disagrees: "
                           + "; ".join(map(parity.describe, bad)))
    errs = lambda *keys: max(c["err"] for c in checks  # noqa: E731
                             if c["name"].startswith("block") and c["name"].endswith(keys))
    return {"quad_partial_fwd": errs("m + log s", "top-k"),
            "quad_partial_bwd": errs("d_emb", "d_gt")}


def partial_timing(case, kw) -> dict:
    """Both partial kernels over a 2^20 block (world 1) and a 2^18 block (a
    4-card shard): kernel, plain version, the phase-4 yardstick over the
    block, and the bound. Returns {(name, columns): times}."""
    from vlsfr_tpu_torch.ops import twin_margin as ttm
    from vlsfr_tpu_torch.parallel.sharded_quad import shard_inputs

    p_x, p_y, queue, g_a, g_b, pa, pb, la, lb, dce, dneg = case
    b, q = p_x.shape[0], queue.shape[1]
    labels = torch.cat([la, lb]).to(torch.int32)
    out = {}
    for n in (1, SHARDS):
        q_l = queue[:, :q // n]
        si = shard_inputs(p_x, p_y, q_l, 0, g_a, g_b, pa, pb, la, lb)
        if n == 1:  # the global gt, logz and kth, from the whole queue as one block
            gt = si.gt_parts
            m, s, t = ttm.quad_partial_fwd(*si.kernel_args(q_l), gt, b=b, bp=b, **kw)
            logz, topk = ttm.finalize_fwd(m, s, t, labels, gt, loss_type=kw["loss_type"],
                                          margin=kw["margin"], scale=kw["scale"])[2:]
            kth = topk[:, :, -1].contiguous()
        args, pkw = si.kernel_args(q_l), dict(b=b, bp=b, **kw)
        bwd_args = (*args, gt, logz, kth, dce, dneg)
        q0 = q_l[0]
        r_, d = si.E.shape
        cols = q0.shape[0]
        fwd = dict(ms=cuda_ms(lambda: ttm.quad_partial_fwd(*args, gt, **pkw), 10),
                   plain_ms=cuda_ms(lambda: ttm.quad_partial_fwd_plain(*args, gt, **pkw), 3, 1))
        bwd = dict(ms=cuda_ms(lambda: ttm.quad_partial_bwd(*bwd_args, **pkw), 10),
                   plain_ms=cuda_ms(lambda: ttm.quad_partial_bwd_plain(*bwd_args, **pkw), 3, 1))

        def library_fwd():  # yardsticks only: the port never calls these
            cos = torch.matmul(si.E, q0.T)
            torch.logsumexp(kw["scale"] * cos, dim=1)
            torch.topk(cos, kw["k"], dim=1)

        d_cos = torch.randn((r_, cols), device=q0.device).mul_(1e-4)

        def library_bwd():
            torch.matmul(si.E, q0.T)
            torch.matmul(d_cos, q0)

        fwd["library_ms"] = cuda_ms(library_fwd, 5, 1)
        bwd["library_ms"] = cuda_ms(library_bwd, 5, 1)
        del d_cos
        vec_bytes = 4 * (3 * r_ * d + 6 * r_)  # E, G, V + the [R] / [2, R] row vectors
        q0_bytes = 4 * cols * d
        fwd.update(bound(2.0 * r_ * d * cols, q0_bytes + vec_bytes + 4 * 2 * r_ * (2 + kw["k"])))
        bwd.update(bound(4.0 * r_ * d * cols,
                         q0_bytes + vec_bytes + 4 * 8 * r_ + 4 * (r_ * d + 2 * r_)))
        print(f"  a block of {cols} columns:")
        print_times({"quad_partial_fwd": fwd, "quad_partial_bwd": bwd})
        out[("quad_partial_fwd", cols)], out[("quad_partial_bwd", cols)] = fwd, bwd
    return out


def sharded_first_step(tmp: str) -> None:
    """The force_sharded Trainer's first step against the single-shard
    Trainer's, from phase 5's seed and batch with an f32 backbone: under
    bf16 compute a weight gradient is rounded to 8 bits, so the last-bit
    differences of the two heads' d_emb (a torch finalize against the
    kernel's) move a parameter by up to lr·2^-8·|g|, far above the limits;
    in f32 the comparison sees the head."""
    import torch.distributed as dist

    def first_step(*overrides):
        trainer = ffc_trainer(tmp, "model.dtype=float32", *overrides)
        try:
            if overrides and (trainer.mesh is None or dist.get_backend() != "nccl"
                              or dist.get_world_size() != 1):
                raise RuntimeError("the sharded route did not run over an NCCL group of one")
            batch = trainer.pipeline.make_batch(0, 0)
            idx = trainer.dcp.plan_step(batch.x_label, batch.y_label)
            loss = float(trainer.train_step(trainer.state, batch.x, batch.y, idx, 1.0)["loss"])
            params = {k: v.detach().clone() for k, v in trainer.state.probe.state_dict().items()}
            return loss, params, trainer.state.queue.clone()
        finally:
            free_trainer(trainer)

    loss_ref, params_ref, queue_ref = first_step()
    loss, params, queue = first_step("pool.force_sharded=true")
    worst = max(float(((v.double() - params_ref[k].double()).abs()
                       - 1e-5 * params_ref[k].double().abs()).max()) for k, v in params.items())
    same_queue = torch.equal(queue, queue_ref)
    print(f"  first step (f32 backbone), sharded against single-shard: loss {loss:.6f} / "
          f"{loss_ref:.6f} (1e-5 relative); probe parameters and BN statistics "
          f"max(|diff| - 1e-5 |ref|) {worst:.3e} <= 2e-5; queue after the write bit-equal: "
          f"{same_queue}")
    if not (abs(loss - loss_ref) <= 1e-5 * abs(loss_ref) and worst <= 2e-5 and same_queue):
        raise RuntimeError("the sharded first step disagrees with the single-shard step")


def sharded_train_phase(card: str, tmp: str) -> dict:
    """The sharded first step against the single-shard one, then the
    force_sharded Trainer (the slice's bf16 config) 4 steps, a profile, and
    the process group destroyed. Returns the launch counts of the 4-step
    run."""
    import torch.distributed as dist

    from vlsfr_tpu_torch.ops import twin_margin as ttm

    sharded_first_step(tmp)
    gc.collect()
    torch.cuda.empty_cache()
    trainer = ffc_trainer(tmp, "pool.force_sharded=true")
    try:
        ttm.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = trainer.train(max_steps=TRAIN_STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ttm.LAUNCH_COUNTS)
        peak = torch.cuda.max_memory_allocated()
        print(f"  {TRAIN_STEPS} sharded steps: {json.dumps(out)}")
        print(f"  quad launches in the sharded run: {launches}")
        want = {"quad_fwd": 0, "quad_bwd": 0, "quad_partial_fwd": TRAIN_STEPS,
                "quad_partial_bwd": TRAIN_STEPS}
        if launches != want or not (math.isfinite(out["loss"]) and out["loss"] > 0
                                    and out["final_step"] == TRAIN_STEPS):
            raise RuntimeError(f"the sharded step must launch each partial kernel once per "
                               f"step and no quad kernel: {launches}, {out}")
        step_ms = 2 * SLICE["b"] / out["images_per_sec"] * 1e3
        print(f"  sharded step time {step_ms:.1f} ms (last window, {card}); {TRAIN_STEPS} steps "
              f"{wall:.2f} s wall incl. the first window; peak memory {peak / 2**30:.2f} GiB "
              f"({card})")
        print("== phase 17b: profile of two more sharded steps")
        state, scale = trainer.state, trainer.plateau.scale
        profile_steps(lambda b: trainer.train_step(state, b.x, b.y, trainer.dcp.plan_step(
            b.x_label, b.y_label), scale), [trainer.pipeline.make_batch(0, s) for s in range(2)])
    finally:
        free_trainer(trainer)
    if dist.is_initialized():
        raise RuntimeError("the process group outlived its trainer")
    return launches


def class_shard_parity(c: int, loss_type: str, k: int, frac_outlier: float, n_shards: int,
                       seed: int):
    """``parity.margin_shard_checks`` on one softmax case cut into
    ``n_shards`` blocks; raises above a limit. Returns the case with the
    merged (gt, logz, topk), and the max errors of the partial kernels."""
    from vlsfr_tpu_torch.parallel._shard_common import localize_labels
    from vlsfr_tpu_torch.utils import parity

    emb, w, mom, labels, d_ce, d_neg, kw = softmax_case(c, loss_type, k, frac_outlier, seed)
    cl = c // n_shards
    for j in range(n_shards):
        ll, _ = localize_labels(j * cl, cl, labels)
        if n_shards > 1 and not ((ll >= 0).any() and (ll == -2).any()):
            raise RuntimeError(f"block {j} must own targets and see rows owned elsewhere")
    checks, (gt, logz, topk) = parity.margin_shard_checks(emb, w, labels, d_ce, d_neg, kw,
                                                          n_shards)
    torch.cuda.synchronize()
    for ch in checks:
        print("    " + parity.describe(ch))
    bad = parity.failures(checks)
    if bad:
        raise RuntimeError("the class-sharded softmax head disagrees: "
                           + "; ".join(map(parity.describe, bad)))
    errs = lambda *keys: max(ch["err"] for ch in checks  # noqa: E731
                             if any(f"partial {key}" in ch["name"] for key in keys))
    return ((emb, w, mom, labels, d_ce, d_neg, kw, gt, logz, topk),
            {"margin_partial_fwd": errs("m + log s", "top-k"),
             "margin_partial_bwd": errs("d_emb", "d_w")})


def block_pos_rows_parity(case, n_shards: int, j: int = 1) -> None:
    """On emulated block ``j`` with its block-local labels (−2 rows), the
    merged gt / logz / top-k and the global positive rows as ``pos_rows``:
    margin_ce_bwd (both grad_w) and the fused-SGD kernel (route A), and
    route D's forward with statistics, selection and sparse backward, each
    against its plain version; raises above a limit."""
    from vlsfr_tpu_torch.ops import margin_stream as tms
    from vlsfr_tpu_torch.parallel._shard_common import localize_labels
    from vlsfr_tpu_torch.utils import parity

    emb, w, mom, labels, d_ce, d_neg, kw, gt, logz, topk = case
    b, d = emb.shape
    cl = w.shape[0] // n_shards
    rows = slice(j * cl, (j + 1) * cl)
    ll, _ = localize_labels(j * cl, cl, labels)
    pos = labels >= 0
    print(f"  block {j}: {int((ll >= 0).sum())} owned rows, {int((ll == -2).sum())} rows owned "
          f"elsewhere (-2)")
    bwd, fused = parity.margin_ce_bwd_checks(emb, w[rows].clone(), mom[rows].clone(), ll, gt, logz,
                                             topk, d_ce, d_neg, kw, LR, SGD, pos_rows=pos)
    tile, n_tiles = tms.sparse_bwd_geometry(b, d, cl)
    m = tms.sparse_m_tiles(SPARSE_RATE, n_tiles, b)
    u = torch.rand((n_tiles,), generator=torch.Generator(device=emb.device).manual_seed(j),
                   device=emb.device)
    sparse, _, _ = parity.sparse_path_checks(emb, w[rows], ll, d_ce, d_neg, kw, tile, m, u,
                                             pos_rows=pos, gt=gt)
    torch.cuda.synchronize()
    print(f"    route D on the block: tile {tile}, {m} of {n_tiles} tiles")
    checks = bwd + fused + sparse
    for ch in checks:
        print("    " + parity.describe(ch))
    bad = parity.failures(checks)
    if bad:
        raise RuntimeError("a pos_rows kernel disagrees on a block: "
                           + "; ".join(map(parity.describe, bad)))


def margin_partial_timing(case) -> dict:
    """Both partial margin_ce kernels over a 2^20 block (world 1 at the
    slice's width) and a 1,250,000 block (one card's block of the shipped
    5M config): kernel, plain version, a cuBLAS composition (a yardstick the
    port never calls) and the bound. Returns {(name, columns): times}."""
    import torch.nn.functional as F

    from vlsfr_tpu_torch.ops import margin_stream as tms
    from vlsfr_tpu_torch.parallel._shard_common import localize_labels

    emb, w, _, labels, d_ce, d_neg, kw, gt, logz, topk = case
    b, d = emb.shape
    k = kw["k"]
    kth = topk[:, -1].contiguous()
    d_ce_m, d_neg_m = tms._mask_cotangents(labels >= 0, d_ce, d_neg)
    out = {}
    for cols in (SOFTMAX["c"], SHIPPED_CLASSES // CLASS_SHARDS):
        blk = w[:cols]
        ll, _ = localize_labels(0, cols, labels)
        _, d_wl = tms._target_rows(emb, blk, ll, gt, logz, d_ce_m, loss_type=kw["loss_type"],
                                   margin=kw["margin"], scale=kw["scale"])
        fargs, bargs = (emb, blk, ll, gt), (emb, blk, ll, gt, logz, kth, d_ce_m, d_neg_m, d_wl)
        fwd = dict(ms=cuda_ms(lambda: tms.margin_partial_fwd(*fargs, **kw), 10),
                   plain_ms=cuda_ms(lambda: tms.margin_partial_fwd_plain(*fargs, **kw), 3, 1))
        bwd = dict(ms=cuda_ms(lambda: tms.margin_partial_bwd(*bargs, **kw), 5),
                   plain_ms=cuda_ms(lambda: tms.margin_partial_bwd_plain(*bargs, **kw), 3, 1))

        def library_fwd():  # yardsticks only: the port never calls these
            cos = emb @ F.normalize(blk, dim=1).T
            torch.logsumexp(kw["scale"] * cos, dim=1)
            torch.topk(cos, k, dim=1)

        wn = F.normalize(blk, dim=1)
        d_cos = torch.randn((b, cols), device=emb.device).mul_(1e-4)

        def library_bwd():
            torch.matmul(d_cos, wn)
            torch.matmul(d_cos.T, emb)

        fwd["library_ms"] = cuda_ms(library_fwd, 5, 1)
        bwd["library_ms"] = cuda_ms(library_bwd, 5, 1)
        del wn, d_cos
        product = 2.0 * b * d * cols
        vecs = 4 * (b * d + 2 * b)  # emb; labels, gt
        fwd.update(bound(product, 4 * cols * d + vecs + 4 * b * (2 + k)))
        # W read and d_w written; emb and d_wl read, d_emb written; the [B] vectors
        bwd.update(bound(3 * product, 8 * cols * d + 12 * b * d + 4 * 7 * b))
        print(f"  a block of {cols} classes:")
        print_times({"margin_partial_fwd": fwd, "margin_partial_bwd": bwd})
        out[("margin_partial_fwd", cols)], out[("margin_partial_bwd", cols)] = fwd, bwd
    return out


SHARDED_ROUTES = {"A": (), "B": ("pool.fused_update=off",),
                  "D": ("pool.sparse_update=true", f"pool.sparse_grad_rate={SPARSE_RATE}")}


def sharded_softmax_run(tmp: str, route: str, mesh, *overrides: str):
    """The single-device softmax Trainer of ``route`` (its data pipeline,
    schedule and seeded backbone) and, from its backbone before any step
    and the classifier the same seed draws, the class-sharded state and
    step on ``mesh``. Returns (trainer, sharded state, sharded step)."""
    from vlsfr_tpu_torch.train.softmax_head import create_softmax_state, make_softmax_train_step

    trainer = softmax_trainer(tmp, *SHARDED_ROUTES[route], *overrides)
    cfg = trainer.cfg
    state = create_softmax_state(copy.deepcopy(trainer.state.backbone), cfg,
                                 cfg.pool.num_classes, seed=cfg.data.seed, mesh=mesh)
    return trainer, state, make_softmax_train_step(cfg, trainer.schedule, mesh=mesh)


def sharded_softmax_first_step(tmp: str, route: str, mesh) -> None:
    """The sharded route's first step against the single-device route's
    first step from the same seed and batch, on an f32 backbone (phase 17's
    reason): loss 1e-5 relative, the classifier per row set (1e-4 x
    max|w' - w| + 2 f32 eps x max|w'|, as phase 9), backbone parameters and
    BN statistics 1e-5 relative + 2e-5 absolute."""
    from vlsfr_tpu_torch.utils import parity

    trainer, state, step = sharded_softmax_run(tmp, route, mesh, "model.dtype=float32")
    try:
        if not torch.equal(state.classifier, trainer.state.classifier.detach()):
            raise RuntimeError("the sharded state's block is not the seeded classifier")
        batch = trainer.pipeline.make_batch(0, 0)
        w0 = state.classifier.detach().clone()
        loss_ref = float(trainer.train_step(trainer.state, batch.images, batch.labels,
                                            1.0)["loss"])
        loss = float(step(state, batch.images, batch.labels, 1.0)["loss"])
        w_ref = trainer.state.classifier.detach()
        checks = parity.by_rows(f"route {route} classifier, sharded vs single",
                                state.classifier.detach(), w_ref, w_ref - w0,
                                torch.from_numpy(batch.labels), 1e-4, rounding=2.0)
        ref = trainer.state.backbone.state_dict()
        worst = max(float(((v.double() - ref[k].double()).abs() - 1e-5 * ref[k].double().abs())
                          .max()) for k, v in state.backbone.state_dict().items())
        print(f"  route {route} first step (f32 backbone), sharded against single-device: loss "
              f"{loss:.6f} / {loss_ref:.6f} (1e-5 relative); backbone max(|diff| - 1e-5 |ref|) "
              f"{worst:.3e} <= 2e-5")
        for ch in checks:
            print("    " + parity.describe(ch))
        if not (abs(loss - loss_ref) <= 1e-5 * abs(loss_ref) and worst <= 2e-5) \
                or parity.failures(checks):
            raise RuntimeError(f"the sharded route {route}'s first step disagrees")
    finally:
        free_trainer(trainer)
        del state, step
        gc.collect()
        torch.cuda.empty_cache()


SHARDED_LAUNCHES = {  # route: {kernel: launches per step}
    "A": {"margin_partial_fwd": 1, "margin_ce_bwd_fused_sgd": 1},
    "B": {"margin_partial_fwd": 1, "margin_partial_bwd": 1},
    "D": {"margin_ce_fwd": 1, "margin_ce_bwd_sparse": 1, "margin_ce_bwd": 1},
}


def sharded_softmax_phase(card: str, tmp: str) -> dict:
    """Phase 20: the first steps, then route A 4 steps, B and D 2 each on
    the bf16 config over an NCCL group of one, with launch counts, step
    time, peak memory and a profile of two warm route-A steps. Returns the
    launch counts of the A and B runs."""
    import torch.distributed as dist

    from vlsfr_tpu_torch.ops import margin_stream as tms
    from vlsfr_tpu_torch.parallel import distributed
    from vlsfr_tpu_torch.parallel.mesh import make_mesh

    if not distributed.initialize("cuda"):
        raise RuntimeError("a process group outlived its phase")
    try:
        mesh = make_mesh(1, 1)
        if dist.get_backend() != "nccl" or mesh.model != 1:
            raise RuntimeError("the sharded routes must run over an NCCL group of one")
        for route in SHARDED_ROUTES:
            sharded_softmax_first_step(tmp, route, mesh)
        launches = {}
        for route, n in (("A", TRAIN_STEPS), ("B", ROUTE_B_STEPS), ("D", ROUTE_B_STEPS)):
            trainer, state, step = sharded_softmax_run(tmp, route, mesh)
            trainer.state = None  # the single-device state is not used here
            gc.collect()
            torch.cuda.empty_cache()
            try:
                batches = [trainer.pipeline.make_batch(0, s) for s in range(n)]
                tms.reset_launch_counts()
                torch.cuda.reset_peak_memory_stats()
                for bt in batches:
                    t0 = time.perf_counter()
                    m = step(state, bt.images, bt.labels, 1.0)
                    loss = float(m["loss"])
                    torch.cuda.synchronize()
                    step_ms = (time.perf_counter() - t0) * 1e3
                got = dict(tms.LAUNCH_COUNTS)
                peak = torch.cuda.max_memory_allocated()
                want = {name: n * SHARDED_LAUNCHES[route].get(name, 0) for name in got}
                print(f"  sharded route {route}, {n} steps: last loss {loss:.6f}, last step "
                      f"{step_ms:.1f} ms ({card}), peak memory {peak / 2**30:.2f} GiB ({card})")
                print(f"  launches: {got}")
                if got != want or not math.isfinite(loss) or loss <= 0:
                    raise RuntimeError(f"sharded route {route} must launch {want}: {got}")
                launches[route] = got
                if route == "A":
                    print("== phase 20b: profile of two more sharded route-A steps")
                    profile_steps(lambda bt: step(state, bt.images, bt.labels, 1.0),
                                  [trainer.pipeline.make_batch(0, s) for s in range(2)])
            finally:
                free_trainer(trainer)
                del state, step
                gc.collect()
                torch.cuda.empty_cache()
    finally:
        distributed.destroy()
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

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        print("== phase 9: softmax training through the Trainer")
        softmax_launches, ref_b = softmax_train_phase(card, tmp)
        launches.update(softmax_launches)
        gc.collect()
        torch.cuda.empty_cache()

        print("== phase 11: forward statistics and sparse backward parity at full width; limits "
              "in the module docstring")
        full, sp_errs = check_sparse(SOFTMAX["c"], "Arc", 1, 0.0, seed=4)
        for c, loss_type, k, frac in ((4096, "AM", 1, 0.0), (4096, "SV", 1, 0.0),
                                      (4096, "Arc", 3, 0.3), (4000, "Arc", 1, 0.0)):
            print(f"  C={c} {loss_type} k={k}:")
            check_sparse(c, loss_type, k, frac, seed=5)

        print("== phase 12: sparse backward timing (full width)")
        times.update(sparse_timing(*full))
        del full
        gc.collect()
        torch.cuda.empty_cache()

        print("== phase 13: route D (sparse d_w) through the Trainer")
        launches["margin_ce_bwd_sparse"] = route_d_phase(card, tmp, ref_b)["margin_ce_bwd_sparse"]
        print("== phase 14: route E (partial-FC sampling, sparse rows) through the Trainer")
        route_e_phase(card, tmp)
        gc.collect()
        torch.cuda.empty_cache()

        print("== phase 15: partial quad kernels and the shard merge at full width; limits in "
              "vlsfr_tpu_torch/utils/parity.py")
        full, kw = shard_case(SLICE["q"], "Arc", seed=6)
        for n in (1, SHARDS):
            print(f"  the queue as {n} block(s) of {SLICE['q'] // n} columns:")
            for name, err in shard_parity(full, kw, n).items():
                errs[name] = max(errs.get(name, 0.0), err)
        for loss_type in ("AM", "SV"):
            print(f"  Q=4096 {loss_type} in {SHARDS} blocks:")
            shard_parity(*shard_case(4096, loss_type, seed=7), SHARDS)

        print("== phase 16: partial quad timing (full width, one block and one 4-card shard)")
        ptimes = partial_timing(full, kw)
        times.update({name: t for (name, cols), t in ptimes.items() if cols == SLICE["q"]})
        del full
        gc.collect()
        torch.cuda.empty_cache()

        print("== phase 17: the sharded FFC step (pool.force_sharded) through the Trainer")
        sharded = sharded_train_phase(card, tmp)
        launches.update({k: sharded[k] for k in ("quad_partial_fwd", "quad_partial_bwd")})
        gc.collect()
        torch.cuda.empty_cache()

        print("== phase 18: partial margin_ce kernels and the class-shard merge at full width; "
              "limits in vlsfr_tpu_torch/utils/parity.py")
        print(f"  the classifier as 1 block of {SOFTMAX['c']} classes:")
        perrs = class_shard_parity(SOFTMAX["c"], "Arc", 1, 0.0, 1, seed=8)[1]
        print(f"  {SHIPPED_CLASSES} classes as {CLASS_SHARDS} blocks of "
              f"{SHIPPED_CLASSES // CLASS_SHARDS}:")
        full, errs4 = class_shard_parity(SHIPPED_CLASSES, "Arc", 1, 0.0, CLASS_SHARDS, seed=9)
        perrs = {name: max(perrs[name], errs4[name]) for name in perrs}
        block_pos_rows_parity(full, CLASS_SHARDS)
        for loss_type, k, frac in (("AM", 1, 0.0), ("SV", 1, 0.0), ("Arc", 3, 0.3)):
            print(f"  C=4096 {loss_type} k={k} in {CLASS_SHARDS} blocks:")
            class_shard_parity(4096, loss_type, k, frac, CLASS_SHARDS, seed=10)

        print("== phase 19: partial margin_ce timing (a 2^20 block and a 1,250,000 block)")
        ptimes = margin_partial_timing(full)
        times.update({name: t for (name, cols), t in ptimes.items() if cols == SOFTMAX["c"]})
        del full
        gc.collect()
        torch.cuda.empty_cache()

        print("== phase 20: the class-sharded softmax head (make_softmax_train_step with a mesh)")
        sharded = sharded_softmax_phase(card, tmp)
        launches["margin_partial_fwd"] = sharded["A"]["margin_partial_fwd"]
        launches["margin_partial_bwd"] = sharded["B"]["margin_partial_bwd"]
        errs.update(perrs)

    fwd_keys = ("ce", "neg", "logz", "topk")
    kernels = []
    for name, src, replaces, err in (
            ("quad_fwd", "quad_margin", "twin_margin.py:1840", max(errs[k] for k in fwd_keys)),
            ("quad_bwd", "quad_margin", "twin_margin.py:1891", errs["d_emb"]),
            ("margin_ce_fwd", "margin_ce", "margin_pallas.py:390",
             max([serrs[k] for k in fwd_keys] + [sp_errs["stats"]])),
            ("margin_ce_bwd", "margin_ce", "margin_pallas.py:557", serrs["margin_ce_bwd"]),
            ("margin_ce_bwd_fused_sgd", "margin_ce", "margin_pallas.py:803",
             serrs["margin_ce_bwd_fused_sgd"]),
            ("margin_ce_bwd_sparse", "margin_ce", "margin_pallas.py:1447", sp_errs["sparse"]),
            ("quad_partial_fwd", "quad_margin", "twin_margin.py:1676", errs["quad_partial_fwd"]),
            ("quad_partial_bwd", "quad_margin", "twin_margin.py:1748",
             errs["quad_partial_bwd"]),
            ("margin_partial_fwd", "margin_ce", "margin_pallas.py:991", errs["margin_partial_fwd"]),
            ("margin_partial_bwd", "margin_ce", "margin_pallas.py:1036",
             errs["margin_partial_bwd"])):
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
