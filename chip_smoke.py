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
   over 2^20 columns); d_emb 1e-4 × max|d_emb|; d_gt 1e-5; then the f32
   clean cosines of the forward's and the backward's tilings over the first
   2^18 slots, bit for bit, and the forward's within 1e-5 of the plain
   product (``parity.f32_cos_checks``);
4. timing — CUDA events over repeated launches: each kernel, its plain
   version, and a PyTorch composition of the same function as a yardstick
   (forward: matmul + logsumexp + topk; backward: the cosine recompute and
   d_cos @ queue over a materialised [2b, Q] d_cos); the bound is the
   larger of FLOP / 67 TFLOP/s (f32, no tensor cores) and bytes / 3.35 TB/s;
   the backward also with the step's write columns and labels set to -1
   (what the written columns and the targets cost);
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
   kernel), then AM, SV and k = 3 with outlier rows at C = 4096; first the
   f32 cosines as the forward and the backward form them, bit for bit
   (``parity.margin_cos_checks``). d_w, w' and mom' are held per row set:
   the batch's label rows, whose target gradient plain torch adds on both
   sides, and the other rows, which the kernel computes alone
   (``vlsfr_tpu_torch/utils/parity.py``); each limit is printed with its
   reason;
8. timing — as phase 4, with ``torch.matmul`` / ``logsumexp`` / ``topk`` /
   elementwise SGD compositions as yardsticks (the backward's: the cosine
   recompute ``emb @ F.normalize(w).T`` and both products, as the kernel
   does); margin_ce_bwd also with grad_w=False, in turns, and d_w's share
   as the difference;
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
   kernel, plain version, a cuBLAS composition as a yardstick (the
   backward's with the cosine recompute), bound;
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
The 10M-identity int8 pool (the quad kernels' bf16, int8 and int8-compute
forms; ``capacity_10m_int8c``: ir50, 10,485,760-slot int8 queue, int8
compute):
21. parity — each form's quad_fwd / quad_bwd kernel against its plain
   version: int8c and int8 storage at Q = 10,485,760, bf16 at 4,194,304,
   with phase 3's write plan (a duplicate slot), then AM and SV at 4096;
   int8c's dot bit for bit (the kernels' clean cosines with unit scales
   against torch._int_mm: the forward's __dp4a and the backward's s8
   mma.sync); the bf16 and int8 forms' clean cosines (tensor cores,
   mma.sync over bf16 operands, int8 rows widened) in the forward's and
   the backward's tiling bit for bit equal over the first 65,536 slots,
   and within 1e-6 of the plain version's;
   limits printed with their reasons (``utils/parity.py``);
22. timing — each form's kernels at full width: kernel, plain version,
   yardsticks (bf16 matmul over int8 -> bf16 chunks scaled after the dot,
   torch._int_mm chunks for int8c, bf16 matmul for bf16; then logsumexp and
   top-k), and the bound at the H100's dense tensor-core rates (989 TFLOP/s
   bf16, 1,979 TOPS int8) or 3.35 TB/s;
23. partial kernels — each form as one block of the whole queue and as 4
   emulated blocks (2,621,440 slots at 10,485,760), merged against quad_fwd
   / quad_bwd (``quad_shard_checks``), then AM and SV at 4096; their timing
   over one 4-card block;
24. training — ``Trainer`` on capacity_10m_int8c, 4 steps, each int8c kernel
   once per step, step time, peak memory, a profile of two warm steps; after
   one more step every written slot holds quantize_rows(g) bit for bit and
   every live row dequantises to unit norm within 1e-4; ``pool.force_sharded``
   on the same config over an NCCL group of one, its first step against the
   single-shard first step on an f32 backbone, then 2 steps; int8 storage at
   2^20 and bf16 at 4,194,304, single and force-sharded, 2 steps each;
   phases 21-23 hold and time the rounded forms' backward at the tile their
   step requests (2048 at pool.queue_tile = 0), which resolves as in JAX to
   2048 columns at 10,485,760 int8 slots and 1024 at 4,194,304 bf16 slots;
The twin FFC head (``twin_add_margin``, ``directional_loss(use_fused=True)``,
``make_sharded_twin_loss``; tools/bench_sharded_twin.py's widths, b = 128,
D = 512, 2^20 slots, f32 and bf16 queues):
25. parity — twin_fwd / twin_bwd against their plain versions at full
   width (k = 10, Arc, scale 32, margin 0.5, one direction of phase 3's DCP
   write plan with its duplicate slot, labels at written slots with 25 %
   outliers), f32 and bf16 at the tile request 512 (resolved as JAX
   resolves it), then AM and SV at Q = 4096 and bf16 at a request of 2048
   (resolved 1024); limits as phase 21's (``parity.twin_checks``);
26. partial kernels — the queue as one block and as 4 emulated blocks of
   2^18, each block's twin partial kernels against their plain versions
   and the merged blocks against twin_fwd / twin_bwd on the whole queue
   (``parity.twin_shard_checks``), then AM and SV at 4096 in 4 blocks;
27. timing — each twin kernel at full width (the partial ones over the
   2^20 queue as one block and over one 2^18 block, whose times the
   kernels line lists), its plain version, a PyTorch yardstick (forward: matmul +
   logsumexp + topk; backward: the recompute and d_cos @ q0) and its bound
   (f32 FLOP at 67 TFLOP/s, bf16 dots at 989 TFLOP/s, against bytes);
   twin_fwd, twin_partial_fwd and twin_bwd also without the step's writes
   and targets;
28. the slice — an ir50 probe and gallery in f32, one DCP batch pair at
   batch 128 on the Trainer's 2^20 f32 queue: directions A and B through
   directional_loss(use_fused=True, defer_scatter=True) against
   quad_add_margin on the same inputs (losses 1e-5 relative, probe
   parameter gradients 1e-5 relative + 2e-5 absolute), twin_fwd and
   twin_bwd launching once per directional loss and no quad kernel; the
   same through make_sharded_twin_loss over an NCCL group of one against
   twin_add_margin (losses 1e-5 relative, the head's d_emb at phase 25's
   limits), each partial kernel once per direction; then on the queue's
   bf16 copy: losses 1e-5 relative and the head's d_emb by
   ``parity.rounded_demb`` against the quad at the same tile request and
   at the step's own (2048, resolved 1024), and the sharded twin as above;
The softmax head's bf16 classifier (``softmax_1m_bf16``: ir50, 2^20 bf16
classes, bf16 momentum, fused SGD; the JAX bench suite's row):
29. parity — the six margin_ce kernels' bf16 forms against their plain
   versions at full width (B = 128, D = 512, C = 2^20, Arc, k = 1, a
   repeated label, a 0.01·N(0, 1) classifier and momentum, lr 0.1, μ 0.9
   Nesterov, wd 1e-4): the forward, the cosines as each pass forms them
   (the four tilings bit for bit, within 1e-6 of the plain version), the
   backward and the fused kernel against the plain versions on those
   cosines, in the (w, mom) pairs (bf16, bf16), (bf16, f32) and (f32,
   bf16), each also
   with the momentum scaled by 1e-4 at lr 100 so that the gradient and the
   decay move w' and mom' on every row; AM, SV and
   Arc k = 3 with outlier rows at C = 4096; route D's forward with its
   statistics tile (512) and the sparse backward over 65,536 rows; the
   partial kernels over a 2^20 block and 4 emulated blocks of 1,250,000
   merged against the whole-classifier kernels; limits printed with their
   reasons (``vlsfr_tpu_torch/utils/parity.py``); then four copies of
   margin_ce.cu built with planted faults (a W operand truncated, the
   stored row as the operand with its 1/||w|| applied to the products,
   <d_w_hat, w_hat> against the rounded w_hat, w' rounded twice), each of
   which margin_ce_bwd's or the fused update's checks must reject;
30. timing — each bf16 form at full width: kernel, plain version, a PyTorch
   composition on the tensor cores (bf16 matmuls with f32 accumulation, the
   backward's with the cosine recompute, logsumexp, topk, the SGD chain)
   and the bound (bytes at 3.35 TB/s against the dots at 989 TFLOP/s; the
   f32 classifier beside a bf16 momentum at the f32 rate);
   margin_partial_bwd also over a 1,250,000-column block;
31. training — softmax_1m_bf16 through ``Trainer``: its first step against
   the plain composition of the same step on the same recorded inputs (the
   loss 1e-5 relative, the step's forward by ``parity.rounded_fwd_checks``,
   then on its logz and top-k and the kernels' cosines the classifier by
   ``parity.bf16_ulps`` outside the rows whose d_w straddled and the
   momentum by ``parity.bf16_fresh_state``), then 4 steps (step
   time, peak memory, a finite loss, each kernel form once per step, a
   profile of two warm steps); route A with (bf16, f32) and (f32, bf16),
   route B and route D at a bf16 classifier, 2 steps each;
32. the class-sharded routes A, B and D at a bf16 classifier over an NCCL
   group of one: each first step (f32 backbone) against the single-device
   route's (loss 1e-5 relative, the classifier bit for bit, the momentum
   by ``parity.bf16_fresh_state`` or per row set, the backbone as phase
   20's),
   then 2 steps each with the partial kernels' launch counts;
The last two TPU kernels, on the paths of their JAX tools (no trainer
calls either, in JAX or here):
33. conv parity — ``conv3x3`` (``csrc/conv3x3.cu``; bf16 on the tensor
   cores, f32 on the FMA units) at tools/bench_conv.py's
   bf16 shapes [128, 56, 56, 64], [128, 112, 112, 64], [128, 28, 28, 128],
   both modes at strip 28, with and without the statistics epilogue, ir50's
   stem [128, 112, 112, 3] -> 64 (strip 28) and C = 256 -> 256 and 512 ->
   512 at [128, 14, 14] (strip 14), and the f32 form at [128, 56, 56, 64],
   against ``conv3x3_plain``
   (``parity.conv_checks``: bf16 y within one bf16 spacing plus the f32
   limit, at most 2e-3 of the elements apart; f32 y 2e-5 × max|y|; Σ and
   Σ² 1e-5 of Σ|y| and Σy² per channel), cuDNN's distance printed beside;
   copies of conv3x3.cu that read the bottom halo row one row off and that
   drop the last block of the statistics merge must fail;
34. conv timing — ``vlsfr_tpu_torch.tools.bench_conv.run`` (both modes over
   the strips dividing H, the statistics at 28 and 56, cuDNN and cuDNN +
   two f32 reductions as the library), then its f32 form, each with the
   counters set to 0 before and read after; the plain version's time and
   the bound per shape (bytes at 3.35 TB/s against the FLOP at 989 TFLOP/s
   bf16 or 67 f32); the kernels line takes [128, 56, 56, 64], taps9, strip
   28; then ir50's stem and C = 256 / 512 shapes (both modes, cuDNN, plain,
   bound);
35. the probe — ``vlsfr_tpu_torch.tools.probe_int8_mxu`` at B, D, T, NT =
   128, 512, 1024, 512: each form (``csrc/dot_probe.cu``, mma.sync) against
   its plain version (int8 bit for bit, the plain int8 against the exact
   sum; bf16 forms 1e-5 × Σ|a·w|), a copy that skips the last tile must
   fail, then the tool's ``run`` (its exact int8 check, kernel and library
   times) with the counters set to 0 before and read after; plain times and
   bounds (int8 at 1,979 TOP/s, bf16 at 989, against the bytes of w);
then the ``kernels`` JSON line (44 entries: the ten f32 kernels, the
twelve quad forms, the twin kernels in f32 and bf16, the eight bf16 forms
of the margin_ce kernels, ``conv3x3``, ``conv3x3[stats]``,
``conv3x3[f32]`` and the three probe forms), and the device JSON line
last.

The script imports nothing of JAX. Without a CUDA device it exits non-zero
before printing any result.
"""

from __future__ import annotations

import contextlib
import copy
import functools
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
PEAK_BF16_FLOPS = 989e12  # H100 SXM tensor cores, dense
PEAK_INT8_OPS = 1979e12  # H100 SXM tensor cores, dense
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
FORM_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8,
               "int8c": torch.int8}


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


def raw_case(q: int, b: int, d: int, seed: int, form: str = "f32"):
    """A queue, probes, gallery rows and a realistic write plan: the port's
    DCP planner after a few warm-up steps (pool hits, seen flags, in-pool
    probe labels), with one label three times in each gallery half so two
    writes land on the same (row, slot). The queue is stored as ``form``
    says (f32, bf16, or int8 with its scales for int8 / int8c). Returns the
    queue, its scales (None for float queues), the generator (for more
    draws) and (p_x, p_y, g_a, g_b, plan_a, plan_b, labels_a, labels_b)."""
    from vlsfr_tpu_torch.core.dcp import DCPManager
    from vlsfr_tpu_torch.core.ffc import init_queue

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    queue, scales = init_queue(q, d, device=dev, generator=gen, dtype=FORM_DTYPES[form])
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
    return queue, scales, gen, (p_x, p_y, g_a, g_b, pa, pb, la, lb)


def make_case(q: int, b: int, d: int, k: int, loss_type: str, seed: int, form: str = "f32"):
    """Packed kernel inputs of ``raw_case``, and cotangents; ``kw`` carries
    the form's plane-0 scales and int8-compute probes."""
    from vlsfr_tpu_torch.ops import twin_margin as ttm
    from vlsfr_tpu_torch.ops.qqueue import quantize_rows

    queue, qs, gen, (p_x, p_y, g_a, g_b, pa, pb, la, lb) = raw_case(q, b, d, seed, form)
    packed = ttm.pack_dirs(p_x, p_y, ttm.dir_inputs(queue, g_a, *pa, qs),
                           ttm.dir_inputs(queue, g_b, *pb, qs), la, lb,
                           ttm.compute_twin_gt(p_x, queue, g_a, *pa, la, qs),
                           ttm.compute_twin_gt(p_y, queue, g_b, *pb, lb, qs))
    kw = dict(b=b, loss_type=loss_type, margin=0.5, scale=32.0, k=k, mask_svfc=1.2)
    if form != "f32":
        kw.update(qscales=None if qs is None else qs[0],
                  e8=quantize_rows(packed[0]) if form == "int8c" else None)
    cot = torch.randn((4, 2 * b), generator=gen, device=queue.device) / b
    pos = (packed[6] >= 0)[None, :]
    dce = torch.where(pos, cot[:2], 0.0).contiguous()
    dneg = torch.where(pos, 0.0, cot[2:]).contiguous()
    n_pos = int(pos.sum())
    print(f"  case Q={q} {loss_type} {form}: {n_pos}/{2 * b} in-pool probe rows, "
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


def bound(flop: float, nbytes: float, ops_ms: float | None = None) -> dict:
    """The least time the card could take: the larger of FLOP at the f32
    rate (or ``ops_ms``, the operations' time at their own rates) and bytes
    at the HBM rate, and which of the two it is."""
    t_ops = flop / PEAK_F32_FLOPS * 1e3 if ops_ms is None else ops_ms
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
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
    print_override_share("quad_bwd", out["quad_bwd"]["ms"], ttm.quad_bwd, E, queue, rest, kw,
                         (logz, kth, dce, dneg))
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


def only_launched(launches: dict, want: dict) -> bool:
    """The launch counts are ``want`` and 0 for every other kernel form."""
    return all(n == want.get(name, 0) for name, n in launches.items())


def check_training(trainer, out: dict, launches: dict) -> None:
    """Finite loss, one launch of each quad kernel per step, unit rows in
    the queue, and probe embeddings that agree with the same net on the CPU."""
    if not only_launched(launches, {"quad_fwd": TRAIN_STEPS, "quad_bwd": TRAIN_STEPS}):
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


def margin_launches(tms, **counts) -> dict:
    """margin_stream's launch counters as a run that launched ``counts``
    (by kernel form) and nothing else leaves them."""
    return dict(dict.fromkeys(tms.LAUNCH_COUNTS, 0), **counts)


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
    d_cos = torch.randn((b, c), device=emb.device).mul_(1e-4)
    w_s, mom_s = w.clone(), mom.clone()

    def library_bwd():  # the kernel's work: the cosine recompute, then both products
        wn = F.normalize(w, dim=1)
        torch.matmul(emb, wn.T)
        torch.matmul(d_cos, wn)
        return torch.matmul(d_cos.T, emb)

    def library_fused():
        g = library_bwd().add_(w_s, alpha=SGD["weight_decay"])
        mom_s.mul_(SGD["momentum"]).add_(g)
        w_s.sub_(g.add_(mom_s, alpha=SGD["momentum"]), alpha=LR)

    out["margin_ce_bwd"]["library_ms"] = cuda_ms(library_bwd, 5, 1)
    out["margin_ce_bwd_fused_sgd"]["library_ms"] = cuda_ms(library_fused, 5, 1)
    del d_cos, w_s, mom_s
    # d_emb alone (grad_w=False: the cosines and d_emb += (d_cos inv) W) and
    # the whole backward, in turns; d_w's share (d_w_hat and the epilogue)
    # is the difference
    t = [cuda_ms(lambda: tms.margin_ce_bwd(*bwd_args, grad_w=gw, **kw), 5)
         for gw in (False, True, True, False)]
    print(f"  margin_ce_bwd with grad_w=False / with d_w, in turns: {t[0]:.3f} / {t[1]:.3f} / "
          f"{t[2]:.3f} / {t[3]:.3f} ms; d_w's share {(t[1] + t[2] - t[0] - t[3]) / 2:.3f} ms")
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
    if not trainer.state.classifier.requires_grad:  # B: the classifier in autograd
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
    print(f"  margin_ce launches in the route-B run: { {k: v for k, v in launches_b.items() if v} }")
    if launches_b != margin_launches(tms, margin_ce_fwd=ROUTE_B_STEPS,
                                     margin_ce_bwd=ROUTE_B_STEPS) \
            or not math.isfinite(out_b["loss"]):
        raise RuntimeError(f"route B must launch fwd and bwd once per step: {launches_b}")

    print("  route A (the default): the same step from the same seed")
    trainer = softmax_trainer(tmp)
    try:
        if trainer.state.classifier.requires_grad:
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
        print(f"  margin_ce launches in the route-A run: { {k: v for k, v in launches.items() if v} }")
        if launches != margin_launches(tms, margin_ce_fwd=TRAIN_STEPS,
                                       margin_ce_bwd_fused_sgd=TRAIN_STEPS):
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
        print(f"  margin_ce launches in the route-D run: { {k: v for k, v in launches.items() if v} }")
        if launches != margin_launches(tms, margin_ce_fwd=TRAIN_STEPS, margin_ce_bwd=TRAIN_STEPS,
                                       margin_ce_bwd_sparse=TRAIN_STEPS):
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


def shard_case(q: int, loss_type: str, seed: int, form: str = "f32"):
    """``raw_case`` with its slots moved by slot -> slot·SLOT_MULT mod q (a
    permutation: duplicates, written labels and pool hits keep their
    structure) so that the targets spread over the SHARDS blocks; asserts
    that every block owns targets and that some row's target and write lie
    in different blocks. Returns quad_shard_checks's inputs and the loss
    arguments."""
    b, d, k = SLICE["b"], SLICE["d"], SLICE["k"]
    queue, qs, gen, (p_x, p_y, g_a, g_b, pa, pb, la, lb) = raw_case(q, b, d, seed, form)
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
    print(f"  case Q={q} {loss_type} {form}: {int(pos.sum())}/{2 * b} in-pool probe rows, "
          f"targets in all {SHARDS} blocks")
    if form != "f32":
        kw = dict(kw, qscales=qs, int8_compute=form == "int8c")
    return (p_x, p_y, queue, g_a, g_b, pa, pb, la, lb, dce, dneg), kw


def shard_parity(case, kw, n_shards: int, tile: int = 512) -> dict:
    """quad_shard_checks on one case (the backward's tile request
    ``tile``); raises above a limit. Returns the max errors of the partial
    forward (state and top-k) and backward (d_emb)."""
    from vlsfr_tpu_torch.utils import parity

    fkw = {k: kw[k] for k in ("qscales", "int8_compute") if k in kw}
    kw = {k: v for k, v in kw.items() if k not in fkw}
    checks = parity.quad_shard_checks(*case, kw, n_shards=n_shards, tile=tile, **fkw)
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
        want = {"quad_partial_fwd": TRAIN_STEPS, "quad_partial_bwd": TRAIN_STEPS}
        if not only_launched(launches, want) or not (
                math.isfinite(out["loss"]) and out["loss"] > 0
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

        d_cos = torch.randn((b, cols), device=emb.device).mul_(1e-4)

        def library_bwd():  # the kernel's work: the cosine recompute, then both products
            wn = F.normalize(blk, dim=1)
            torch.matmul(emb, wn.T)
            torch.matmul(d_cos, wn)
            torch.matmul(d_cos.T, emb)

        fwd["library_ms"] = cuda_ms(library_fwd, 5, 1)
        bwd["library_ms"] = cuda_ms(library_bwd, 5, 1)
        del d_cos
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


def backbone_gap(state, trainer) -> float:
    """max(|diff| - 1e-5 |ref|) over the backbone's parameters and BN
    statistics of ``state`` against the single-device Trainer's."""
    ref = trainer.state.backbone.state_dict()
    return max(float(((v.double() - ref[k].double()).abs() - 1e-5 * ref[k].double().abs())
                     .max()) for k, v in state.backbone.state_dict().items())


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
        worst = backbone_gap(state, trainer)
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


# ----------------------------------------------------------------------
# the 10M-identity int8 pool: the quad kernels' bf16, int8 and int8c forms
# ----------------------------------------------------------------------

# the forms' full-width queues: capacity_10m_int8c's 10,485,760 slots for
# the int8 forms, and the JAX package's measured bf16 pool (4,194,304)
FORM_Q = {"int8c": 10 << 20, "int8": 10 << 20, "bf16": 4 << 20}
# their step's kernel tile request (core/ffc.quad_tile at pool.queue_tile =
# 0): the backward rounds per tile as JAX resolves it, 2048 columns for the
# int8 forms at 10,485,760 and 1024 for bf16 at 4,194,304
FORM_TILE = 2048
FORMS = ("int8c", "int8", "bf16")
CAPACITY = ("pool.queue_size=10485760", "pool.queue_dtype=int8", "pool.queue_int8_compute=true")
FORM_TRAIN = {"int8c": CAPACITY, "int8": (f"pool.queue_size={1 << 20}", "pool.queue_dtype=int8"),
              "bf16": (f"pool.queue_size={4 << 20}", "pool.queue_dtype=bfloat16")}
FORM_STEPS = 2  # steps of each form's short training runs (phase 24)


def form_limits() -> None:
    from vlsfr_tpu_torch.utils import parity

    print("  limits: ce / neg / logz 1e-4 absolute and top-k 1e-5 (f32 sums of exact "
          "bf16 / int8 products in another order over the queue); d_gt 1e-5; d_emb in two "
          f"parts: at most {parity.STRADDLE_ROWS} rows beyond {parity.DEMB_TIGHT:g} x its max "
          f"and none beyond {parity.ROUNDED_DEMB_RTOL:g} x its max (both sides round each "
          "d_cos to bf16 before its product with a row; where the kernel's f32 d_cos and the "
          "plain version's straddle a bf16 boundary one term moves by up to 2^-8 of itself, "
          "which moves one row; a kernel that skips a rounding moves every row); the "
          "int8-compute dot bit for bit (limit 0): the kernels' own clean cosines with unit "
          "scales against torch._int_mm, with the real scales against the plain version; "
          "the bf16 and int8 clean cosines of the backward's tiling equal the forward's bit "
          "for bit (limit 0: the backward's top-k test meets the forward's kth) and lie within "
          f"{parity.BF16_COS_ATOL:g} of the plain version's (exact products in another order)")


def form_parity(form: str, q: int, loss_type: str, seed: int):
    """``parity.quad_checks`` on one case of the form at FORM_TILE (and,
    over the first 65,536 slots, for int8c the int8 dot,
    ``parity.int8_dot_checks``, for bf16 and int8 the clean cosines of both
    tilings, ``parity.bf16_cos_checks`` / ``int8_cos_checks``); raises
    above a limit. Returns the case,
    the plain forward's outputs and the max errors of the forward and the
    backward."""
    from vlsfr_tpu_torch.ops import twin_margin as ttm
    from vlsfr_tpu_torch.utils import parity

    case = make_case(q, SLICE["b"], SLICE["d"], SLICE["k"], loss_type, seed, form)
    print(f"  rounding tile: {FORM_TILE} requested, "
          f"{ttm.round_tile(q, SLICE['b'], SLICE['d'], FORM_TILE, case[0].element_size())} "
          f"resolved")
    checks, want = parity.quad_checks(*case, tile=FORM_TILE)
    queue, kw = case[0], case[2]
    n = min(q, 65536)
    if form == "int8c":
        checks += parity.int8_dot_checks(*kw["e8"], queue[0, :n], kw["qscales"][:n],
                                         f"first {n:,} slots: ")
    if form == "bf16":
        checks += parity.bf16_cos_checks(case[1][0], queue[0, :n], f"first {n:,} slots: ")
    if form == "int8":
        checks += parity.int8_cos_checks(case[1][0], queue[0, :n], kw["qscales"][:n],
                                         f"first {n:,} slots: ")
    torch.cuda.synchronize()
    for c in checks:
        print("    " + parity.describe(c))
    bad = parity.failures(checks)
    if bad:
        raise RuntimeError(f"the {form} quad kernels disagree with their plain versions: "
                           + "; ".join(map(parity.describe, bad)))
    err = {c["name"]: c["err"] for c in checks}
    return case, want, {"fwd": max(err[k] for k in ("ce", "neg", "logz", "top-k")),
                        "bwd": max(err["d_emb"], err["d_gt"])}


def form_bound(form: str, fwd: bool, r_: int, d: int, q: int, k: int) -> dict:
    """The least time of one pass of the form at the H100's dense rates:
    the dots on the tensor cores that the TPU kernel's matrix unit stands
    for (int8 compute: the forward's dot and the backward's recompute at
    the int8 rate, the backward's d_emb dot at bf16; bf16 and int8
    storage: bf16), against the bytes (the plane, its scales, the [R, D]
    operands and the per-row vectors and outputs)."""
    dot = 2.0 * r_ * d * q
    item = 1 if form in ("int8", "int8c") else 2
    nbytes = item * q * d + (4 * q if item == 1 else 0) + 4 * 3 * r_ * d + 4 * 6 * r_
    if form == "int8c":
        nbytes += r_ * d + 4 * r_  # E8, se
    if fwd:
        nbytes += 4 * 2 * r_ * (3 + k)
        ops_ms = dot / (PEAK_INT8_OPS if form == "int8c" else PEAK_BF16_FLOPS) * 1e3
        return bound(dot, nbytes, ops_ms)
    nbytes += 4 * 8 * r_ + 4 * (r_ * d + 2 * r_)
    ops_ms = (dot / PEAK_INT8_OPS + dot / PEAK_BF16_FLOPS if form == "int8c"
              else 2 * dot / PEAK_BF16_FLOPS) * 1e3
    return bound(2 * dot, nbytes, ops_ms)


def library_passes(form: str, E, q0, qs, e8, scale: float, k: int, chunk: int = 1 << 20):
    """One PyTorch call per chunk of the same work as the kernels, as
    yardsticks the port never calls: the forward's dot (bf16 matmul over
    int8 -> bf16 rows scaled after the dot; torch._int_mm for int8
    compute; bf16 matmul for a bf16 queue), logsumexp and top-k; the
    backward's recompute and d_cos @ rows in bf16."""
    n_q = q0.shape[0]
    Eb = E.bfloat16()
    d_cos = torch.randn((E.shape[0], chunk), device=E.device).mul_(1e-4).bfloat16()

    def cos(lo, hi):
        w = q0[lo:hi]
        if form == "int8c":
            acc = torch._int_mm(e8[0], w.T)
            return acc.float() * (e8[1][:, None] * qs[None, lo:hi]), w.bfloat16()
        wb = w.bfloat16()
        c = torch.matmul(Eb, wb.T).float()
        return (c * qs[None, lo:hi] if form == "int8" else c), wb

    def fwd():
        for lo in range(0, n_q, chunk):
            c, _ = cos(lo, min(n_q, lo + chunk))
            torch.logsumexp(scale * c, dim=1)
            torch.topk(c, k, dim=1)

    def bwd():
        for lo in range(0, n_q, chunk):
            hi = min(n_q, lo + chunk)
            _, wb = cos(lo, hi)
            torch.matmul(d_cos[:, :hi - lo], wb)

    return fwd, bwd


def form_timing(form: str, case, want) -> dict:
    """Each form's kernels at full width: kernel, plain version, the
    library yardsticks, and the bound."""
    from vlsfr_tpu_torch.ops import twin_margin as ttm

    queue, packed, kw, dce, dneg = case
    E, rest = packed[0], packed[1:]
    r_, d = E.shape
    q = queue.shape[1]
    logz, kth = want[2], want[3][:, :, -1].contiguous()
    fwd = dict(ms=cuda_ms(lambda: ttm.quad_fwd(E, queue, *rest, **kw), 3, 1),
               plain_ms=cuda_ms(lambda: ttm.quad_fwd_plain(E, queue, *rest, **kw), 1, 0))
    bwd = dict(ms=cuda_ms(lambda: ttm.quad_bwd(E, queue, *rest, logz, kth, dce, dneg, **kw,
                                               tile=FORM_TILE), 3, 1),
               plain_ms=cuda_ms(lambda: ttm.quad_bwd_plain(E, queue, *rest, logz, kth, dce, dneg,
                                                           **kw, tile=FORM_TILE), 1, 0))
    lib_fwd, lib_bwd = library_passes(form, E, queue[0], kw.get("qscales"), kw.get("e8"),
                                      kw["scale"], kw["k"])
    fwd["library_ms"] = cuda_ms(lib_fwd, 2, 1)
    bwd["library_ms"] = cuda_ms(lib_bwd, 2, 1)
    fwd.update(form_bound(form, True, r_, d, q, kw["k"]))
    bwd.update(form_bound(form, False, r_, d, q, kw["k"]))
    out = {f"quad_fwd[{form}]": fwd, f"quad_bwd[{form}]": bwd}
    print_times(out)
    return out


def form_partial_timing(form: str, case, kw) -> dict:
    """Both partial kernels of the form over one card's block of a 4-card
    run (Q / 4 slots): kernel, plain version, the yardsticks over the
    block, and the bound."""
    from vlsfr_tpu_torch.ops import twin_margin as ttm
    from vlsfr_tpu_torch.parallel.sharded_quad import shard_inputs

    p_x, p_y, queue, g_a, g_b, pa, pb, la, lb, dce, dneg = case
    b, q = p_x.shape[0], queue.shape[1]
    qs = kw.get("qscales")
    int8c = kw.get("int8_compute", False)
    lkw = {k_: v for k_, v in kw.items() if k_ not in ("qscales", "int8_compute")}
    labels = torch.cat([la, lb]).to(torch.int32)
    whole = shard_inputs(p_x, p_y, queue, 0, g_a, g_b, pa, pb, la, lb, qs, int8c)
    gt = whole.gt_parts
    m, s_, t = ttm.quad_partial_fwd(*whole.kernel_args(queue), gt, b=b, bp=b, **lkw,
                                    **whole.form_kw())
    logz, topk = ttm.finalize_fwd(m, s_, t, labels, gt, loss_type=lkw["loss_type"],
                                  margin=lkw["margin"], scale=lkw["scale"])[2:]
    kth = topk[:, :, -1].contiguous()
    del whole
    cols = q // SHARDS
    q_l = queue[:, :cols]
    si = shard_inputs(p_x, p_y, q_l, 0, g_a, g_b, pa, pb, la, lb,
                      None if qs is None else qs[:, :cols], int8c)
    args, pkw = si.kernel_args(q_l), dict(b=b, bp=b, **lkw, **si.form_kw())
    bwd_args = (*args, gt, logz, kth, dce, dneg)
    fwd = dict(ms=cuda_ms(lambda: ttm.quad_partial_fwd(*args, gt, **pkw), 3, 1),
               plain_ms=cuda_ms(lambda: ttm.quad_partial_fwd_plain(*args, gt, **pkw), 1, 0))
    bwd = dict(ms=cuda_ms(lambda: ttm.quad_partial_bwd(*bwd_args, **pkw, tile=FORM_TILE), 3, 1),
               plain_ms=cuda_ms(lambda: ttm.quad_partial_bwd_plain(*bwd_args, **pkw,
                                                                   tile=FORM_TILE), 1, 0))
    lib_fwd, lib_bwd = library_passes(form, si.E, q_l[0], si.qs0,
                                      None if si.e8q is None else (si.e8q, si.e8s),
                                      lkw["scale"], lkw["k"])
    fwd["library_ms"] = cuda_ms(lib_fwd, 2, 1)
    bwd["library_ms"] = cuda_ms(lib_bwd, 2, 1)
    r_, d = si.E.shape
    fwd.update(form_bound(form, True, r_, d, cols, lkw["k"]))
    bwd.update(form_bound(form, False, r_, d, cols, lkw["k"]))
    out = {f"quad_partial_fwd[{form}]": fwd, f"quad_partial_bwd[{form}]": bwd}
    print(f"  {form}: a block of {cols} columns:")
    print_times(out)
    return out


class WriteRecorder:
    """Wraps ``core.ffc.write_rows_`` to keep the last write's arguments."""

    def __init__(self, ffc):
        self.ffc, self.orig, self.last = ffc, ffc.write_rows_, None

    def __enter__(self):
        def record(queue, g, rows, cols, col0=0, scales=None):
            self.last = (g.detach().clone(), rows.clone(), cols.clone(), col0)
            return self.orig(queue, g, rows, cols, col0, scales)

        self.ffc.write_rows_ = record
        return self

    def __exit__(self, *exc):
        self.ffc.write_rows_ = self.orig


def check_int8_queue(state, write) -> None:
    """Every slot the last step wrote holds quantize_rows(g) of its last
    writer, rows and scales bit for bit; every live row dequantises to a
    unit vector within 1e-4 (the whole queue, in chunks)."""
    from vlsfr_tpu_torch.ops.qqueue import dequant_rows, quantize_rows

    g, rows, cols, col0 = write
    q_rows, s_rows = quantize_rows(g)
    key = cols.long() * 2 + rows.long()
    last = ~torch.triu(key[:, None] == key[None, :], diagonal=1).any(dim=1)
    r, c = rows.long()[last], cols.long()[last] - col0
    ok_q = torch.equal(state.queue[r, c], q_rows[last])
    ok_s = torch.equal(state.queue_scales[r, c], s_rows[last])
    worst, n_live = 0.0, 0
    for lo in range(0, state.queue.shape[1], 1 << 20):
        qs = state.queue_scales[:, lo:lo + (1 << 20)]
        nrm = torch.linalg.vector_norm(dequant_rows(state.queue[:, lo:lo + (1 << 20)], qs), dim=-1)
        live = qs > 0
        n_live += int(live.sum())
        worst = max(worst, float((nrm[live] - 1.0).abs().max()))
    print(f"  the step's {int(last.sum())} written slots hold quantize_rows(g) bit for bit: rows "
          f"{ok_q}, scales {ok_s}; {n_live} live rows dequantise to unit norm within "
          f"{worst:.2e} (limit 1e-4)")
    if not (ok_q and ok_s and worst <= 1e-4):
        raise RuntimeError("the int8 queue does not hold what the step wrote")


def form_first_step(tmp: str, form: str) -> None:
    """The force_sharded Trainer's first step against the single-shard
    Trainer's on the form's config, from one seed and batch with an f32
    backbone (as phase 17): loss 1e-5 relative, parameters and BN
    statistics 1e-5 relative + 2e-5 absolute, the queue (and scales) after
    the write bit-equal."""
    import torch.distributed as dist

    def first_step(*overrides):
        trainer = ffc_trainer(tmp, "model.dtype=float32", *FORM_TRAIN[form], *overrides)
        try:
            if overrides and (trainer.mesh is None or dist.get_backend() != "nccl"
                              or dist.get_world_size() != 1):
                raise RuntimeError("the sharded route did not run over an NCCL group of one")
            batch = trainer.pipeline.make_batch(0, 0)
            idx = trainer.dcp.plan_step(batch.x_label, batch.y_label)
            loss = float(trainer.train_step(trainer.state, batch.x, batch.y, idx, 1.0)["loss"])
            params = {k: v.detach().clone() for k, v in trainer.state.probe.state_dict().items()}
            st = trainer.state
            return loss, params, st.queue.clone(), st.queue_scales
        finally:
            free_trainer(trainer)

    loss_ref, params_ref, queue_ref, scales_ref = first_step()
    loss, params, queue, scales = first_step("pool.force_sharded=true")
    worst = max(float(((v.double() - params_ref[k].double()).abs()
                       - 1e-5 * params_ref[k].double().abs()).max()) for k, v in params.items())
    same = torch.equal(queue, queue_ref) and (scales is None or torch.equal(scales, scales_ref))
    print(f"  {form} first step (f32 backbone), sharded against single-shard: loss {loss:.6f} / "
          f"{loss_ref:.6f} (1e-5 relative); probe parameters and BN statistics "
          f"max(|diff| - 1e-5 |ref|) {worst:.3e} <= 2e-5; queue and scales after the write "
          f"bit-equal: {same}")
    if not (abs(loss - loss_ref) <= 1e-5 * abs(loss_ref) and worst <= 2e-5 and same):
        raise RuntimeError(f"the sharded {form} first step disagrees with the single-shard step")
    del queue, queue_ref, scales, scales_ref
    gc.collect()
    torch.cuda.empty_cache()


def form_train(card: str, tmp: str, form: str, steps: int, *overrides: str,
               profile: bool = False, check_queue: bool = False) -> dict:
    """``steps`` steps of the form's config through ``Trainer.train``, each
    of the form's kernels (single-shard or, with ``pool.force_sharded``, the
    partial ones) launching once per step. Returns the launch counts."""
    from vlsfr_tpu_torch.core import ffc
    from vlsfr_tpu_torch.ops import twin_margin as ttm

    sharded = "pool.force_sharded=true" in overrides
    trainer = ffc_trainer(tmp, *FORM_TRAIN[form], *overrides)
    try:
        ttm.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = trainer.train(max_steps=steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ttm.LAUNCH_COUNTS)
        peak = torch.cuda.max_memory_allocated()
        kinds = ("quad_partial_fwd", "quad_partial_bwd") if sharded else ("quad_fwd", "quad_bwd")
        want = {ttm.kernel_name(k_, form): steps for k_ in kinds}
        tag = f"{form}{' sharded' if sharded else ''}"
        print(f"  {tag}, {steps} steps: {json.dumps(out)}")
        print(f"  launches: { {k_: v for k_, v in launches.items() if v} }")
        if not only_launched(launches, want) or not (
                math.isfinite(out["loss"]) and out["loss"] > 0 and out["final_step"] == steps):
            raise RuntimeError(f"each {form} kernel must launch once per step: {launches}, {out}")
        step_ms = 2 * SLICE["b"] / out["images_per_sec"] * 1e3
        print(f"  {tag} step time {step_ms:.1f} ms (last window, {card}); {steps} steps "
              f"{wall:.2f} s wall incl. the first window; peak memory {peak / 2**30:.2f} GiB "
              f"({card})")
        if check_queue:
            # a whole batch the run has not trained on: the epoch's last step
            batch = trainer.pipeline.make_batch(1, trainer.pipeline.steps_per_epoch() - 1)
            with WriteRecorder(ffc) as rec:
                trainer.train_step(trainer.state, batch.x, batch.y,
                                   trainer.dcp.plan_step(batch.x_label, batch.y_label), 1.0)
            check_int8_queue(trainer.state, rec.last)
        if profile:
            print(f"== phase 24b: profile of two more {tag} steps")
            state, scale = trainer.state, trainer.plateau.scale
            profile_steps(lambda b: trainer.train_step(state, b.x, b.y, trainer.dcp.plan_step(
                b.x_label, b.y_label), scale), [trainer.pipeline.make_batch(1, s)
                                                for s in range(2)])
    finally:
        free_trainer(trainer)
    return {k_: v for k_, v in launches.items() if v}


def forms_phases(card: str, tmp: str) -> tuple[dict, dict, dict]:
    """Phases 21-24. Returns (times, max errors, launch counts) by kernel
    entry name."""
    times, errs, launches = {}, {}, {}
    print("== phase 21: the quad kernels' bf16, int8 and int8c forms at full width")
    form_limits()
    full = {}
    for form in FORMS:
        case, want, e = form_parity(form, FORM_Q[form], "Arc", seed=11)
        errs[f"quad_fwd[{form}]"], errs[f"quad_bwd[{form}]"] = e["fwd"], e["bwd"]
        full[form] = (case, want)
        print(f"== phase 22: {form} timing (Q = {FORM_Q[form]})")
        times.update(form_timing(form, case, want))
        del case, want
        full.pop(form)
        gc.collect()
        torch.cuda.empty_cache()
        for loss_type in ("AM", "SV"):
            e = form_parity(form, 4096, loss_type, seed=12)[2]
            errs[f"quad_fwd[{form}]"] = max(errs[f"quad_fwd[{form}]"], e["fwd"])
            errs[f"quad_bwd[{form}]"] = max(errs[f"quad_bwd[{form}]"], e["bwd"])

    print("== phase 23: the forms' partial kernels and the shard merge at full width; limits "
          "in vlsfr_tpu_torch/utils/parity.py")
    for form in FORMS:
        q = FORM_Q[form]
        case, kw = shard_case(q, "Arc", seed=13, form=form)
        for n in (1, SHARDS):
            print(f"  {form}: the queue as {n} block(s) of {q // n} columns:")
            for name, err in shard_parity(case, kw, n, FORM_TILE).items():
                key = f"{name}[{form}]"
                errs[key] = max(errs.get(key, 0.0), err)
        times.update(form_partial_timing(form, case, kw))
        del case, kw
        gc.collect()
        torch.cuda.empty_cache()
        for loss_type in ("AM", "SV"):
            print(f"  {form}: Q=4096 {loss_type} in {SHARDS} blocks:")
            shard_parity(*shard_case(4096, loss_type, seed=14, form=form), SHARDS, FORM_TILE)

    print("== phase 24: capacity_10m_int8c (ir50, 10,485,760-slot int8 queue, int8 compute) "
          "through the Trainer")
    launches.update(form_train(card, tmp, "int8c", TRAIN_STEPS, profile=True, check_queue=True))
    form_first_step(tmp, "int8c")
    launches.update(form_train(card, tmp, "int8c", FORM_STEPS, "pool.force_sharded=true"))
    for form in ("int8", "bf16"):
        print(f"  {form}: the single-shard and the force-sharded Trainer, {FORM_STEPS} steps each")
        launches.update(form_train(card, tmp, form, FORM_STEPS,
                                   check_queue=form == "int8"))
        launches.update(form_train(card, tmp, form, FORM_STEPS, "pool.force_sharded=true"))
    return times, errs, launches


# ----------------------------------------------------------------------
# the twin FFC head: twin_add_margin, directional_loss(use_fused=True),
# make_sharded_twin_loss
# ----------------------------------------------------------------------

# tools/bench_sharded_twin.py's widths: b = 128, D = 512, 2^20 slots, f32
# and bf16 queues, Arc; JAX's default twin tile request
TWIN_Q = 1 << 20
TWIN_FORMS = ("f32", "bf16")
TWIN_TILE = 512


def twin_case(q: int, loss_type: str, seed: int, form: str):
    """One direction of ``raw_case`` (its DCP write plan, a duplicate
    slot) with labels at written slots and 25 % outliers, as
    tools/bench_sharded_twin.py:45-50 builds them; the in-pool probes near
    their written rows (0.9 cosine on average), so that the target term
    carries weight in logz (random probes leave it ~e^-15 of the sum).
    Returns (queue, the twin kernels' inputs, kw, dce, dneg) and the raw
    (emb, g, plan, labels)."""
    from vlsfr_tpu_torch.ops import twin_margin as ttm

    b, d = SLICE["b"], SLICE["d"]
    queue, _, gen, (p_x, _, g_a, _, pa, _, _, _) = raw_case(q, b, d, seed, form)
    rng = np.random.default_rng(seed)
    out = torch.from_numpy(rng.random(b) < 0.25).to(queue.device)
    labels = torch.where(out, -1, pa[1].long()).to(torch.int32)
    near = g_a + torch.randn((b, d), generator=gen, device=queue.device) * (0.5 / math.sqrt(d))
    near = near / torch.linalg.vector_norm(near, dim=-1, keepdim=True)
    p_x = torch.where((labels >= 0)[:, None], near, p_x)
    g32, rows_i, cols_i, v, blend = ttm.dir_inputs(queue, g_a, *pa)
    gt = torch.stack(ttm.compute_twin_gt(p_x, queue, g_a, *pa, labels))
    inputs = tuple(x.contiguous() for x in (p_x, g32, v, rows_i, cols_i, blend.to(torch.int32),
                                            labels, gt))
    kw = dict(loss_type=loss_type, margin=0.5, scale=32.0, k=SLICE["k"], mask_svfc=1.2)
    cot = torch.randn((4, b), generator=gen, device=queue.device) / b
    pos = (labels >= 0)[None, :]
    dce = torch.where(pos, cot[:2], 0.0).contiguous()
    dneg = torch.where(pos, 0.0, cot[2:]).contiguous()
    print(f"  case Q={q} {loss_type} {form}: {int(pos.sum())}/{b} in-pool probe rows, "
          f"{int(blend.sum())} blend writes")
    return (queue, inputs, kw, dce, dneg), (p_x, g_a, pa, labels)


def report(checks, what: str) -> None:
    from vlsfr_tpu_torch.utils import parity

    torch.cuda.synchronize()
    for c in checks:
        print("    " + parity.describe(c))
    bad = parity.failures(checks)
    if bad:
        raise RuntimeError(f"{what} disagree: " + "; ".join(map(parity.describe, bad)))


def twin_parity(case, tile: int = TWIN_TILE):
    """``parity.twin_checks`` on one case; raises above a limit. Returns
    the plain forward's outputs and the max errors of the forward and the
    backward."""
    from vlsfr_tpu_torch.ops import twin_margin as ttm
    from vlsfr_tpu_torch.utils import parity

    queue = case[0]
    rt = ttm.round_tile(queue.shape[1], SLICE["b"], SLICE["d"], tile, queue.element_size())
    print(f"  rounding tile: {tile} requested, {rt} resolved")
    checks, want = parity.twin_checks(*case, tile=tile)
    report(checks, "the twin kernels")
    err = {c["name"]: c["err"] for c in checks}
    return want, {"fwd": max(err[k] for k in ("ce", "neg", "logz", "top-k")),
                  "bwd": max(err["d_emb"], err["d_gt"])}


def twin_bound(form: str, fwd: bool, r_: int, d: int, q: int, k: int) -> dict:
    """The least time of one twin pass: f32 dots at 67 TFLOP/s, bf16 dots at
    the tensor cores' 989 TFLOP/s (``form_bound``), against the bytes."""
    if form == "bf16":
        return form_bound("bf16", fwd, r_, d, q, k)
    nbytes = 4 * q * d + 4 * 3 * r_ * d + 4 * 6 * r_
    if fwd:
        return bound(2.0 * r_ * d * q, nbytes + 4 * 2 * r_ * (3 + k))
    return bound(4.0 * r_ * d * q, nbytes + 4 * 8 * r_ + 4 * (r_ * d + 2 * r_))


def twin_library(E, q0, scale: float, k: int, chunk: int = 1 << 20):
    """Yardsticks the port never calls: the forward's matmul (bf16 for a
    bf16 plane), logsumexp and top-k; the backward's recompute and d_cos @
    q0, per chunk of columns."""
    n_q = q0.shape[0]
    Eo = E.bfloat16() if q0.dtype == torch.bfloat16 else E
    d_cos = torch.randn((E.shape[0], min(chunk, n_q)), device=E.device).mul_(1e-4).to(Eo.dtype)

    def fwd():
        for lo in range(0, n_q, chunk):
            c = torch.matmul(Eo, q0[lo:lo + chunk].T).float()
            torch.logsumexp(scale * c, dim=1)
            torch.topk(c, k, dim=1)

    def bwd():
        for lo in range(0, n_q, chunk):
            w = q0[lo:lo + chunk]
            torch.matmul(Eo, w.T)
            torch.matmul(d_cos[:, :w.shape[0]], w)

    return fwd, bwd


def twin_timing(form: str, case, want) -> dict:
    """Phase 27 for one form: twin_fwd / twin_bwd at full width (kernel,
    plain version, yardstick, bound)."""
    from vlsfr_tpu_torch.ops import twin_margin as ttm

    queue, inputs, kw, dce, dneg = case
    E, rest = inputs[0], inputs[1:]
    r_, d = E.shape
    q = queue.shape[1]
    logz, kth = want[2], want[3][:, :, -1].contiguous()
    bargs = (E, queue, *rest, logz, kth, dce, dneg)
    fwd = dict(ms=cuda_ms(lambda: ttm.twin_fwd(E, queue, *rest, **kw), 10),
               plain_ms=cuda_ms(lambda: ttm.twin_fwd_plain(E, queue, *rest, **kw), 3, 1))
    bwd = dict(ms=cuda_ms(lambda: ttm.twin_bwd(*bargs, **kw, tile=TWIN_TILE), 10),
               plain_ms=cuda_ms(lambda: ttm.twin_bwd_plain(*bargs, **kw, tile=TWIN_TILE), 3, 1))
    lib_fwd, lib_bwd = twin_library(E, queue[0], kw["scale"], kw["k"])
    fwd["library_ms"] = cuda_ms(lib_fwd, 5, 1)
    bwd["library_ms"] = cuda_ms(lib_bwd, 5, 1)
    fwd.update(twin_bound(form, True, r_, d, q, kw["k"]))
    bwd.update(twin_bound(form, False, r_, d, q, kw["k"]))
    name = lambda k_: k_ if form == "f32" else f"{k_}[{form}]"  # noqa: E731
    out = {name("twin_fwd"): fwd, name("twin_bwd"): bwd}
    print_times(out)
    print_override_share(name("twin_fwd"), fwd["ms"], ttm.twin_fwd, E, queue, rest, kw)
    print_override_share(name("twin_bwd"), bwd["ms"], ttm.twin_bwd, E, queue, rest,
                         dict(kw, tile=TWIN_TILE), (logz, kth, dce, dneg))
    return out


def print_override_share(name: str, ms: float, fn, E, queue, rest, kw, tail=()) -> None:
    """A quad or twin kernel ``fn`` on the same inputs with every write and
    target taken away (write columns and labels −1; ``tail``: the
    backward's row vectors): the time the written tiles' override path
    adds. The port's DCP planner hands out consecutive slots, so a step's
    writes sit in a few tiles of one block."""
    G, V, rows, cols, blend, labels, gt = rest
    bare = (G, V, rows, torch.full_like(cols, -1), blend, torch.full_like(labels, -1), gt)
    bare_ms = cuda_ms(lambda: fn(E, queue, *bare, *tail, **kw), 10)
    local = cols[cols >= 0]
    where = f"{int(local.min())}-{int(local.max())}" if local.numel() else "none"
    print(f"  {name} without the step's writes and targets: {bare_ms:.3f} ms (with them "
          f"{ms:.3f}; the written slots here: {where})")


def twin_partial_timing(form: str, case, raw, want) -> dict:
    """The twin partial kernels over the whole queue as one block (world 1)
    and over one card's block of a 4-card run (2^18 of 2^20 slots), fed the
    whole queue's global row vectors: kernel, plain version, yardstick over
    the block, bound. Returns the 2^18 block's times."""
    from vlsfr_tpu_torch.ops import twin_margin as ttm
    from vlsfr_tpu_torch.parallel.sharded_twin import twin_shard_inputs

    queue, inputs, kw, dce, dneg = case
    emb, g, plan, labels = raw
    gt, logz, kth = inputs[7], want[2], want[3][:, :, -1].contiguous()
    name = lambda k_: k_ if form == "f32" else f"{k_}[{form}]"  # noqa: E731
    for n in (1, SHARDS):
        cols = queue.shape[1] // n
        q_l = queue[:, :cols]
        si = twin_shard_inputs(emb, q_l, 0, g, *plan, labels)
        args = si.kernel_args(q_l)
        bargs = (*args, gt, logz, kth, dce, dneg)
        fwd = dict(ms=cuda_ms(lambda: ttm.twin_partial_fwd(*args, gt, **kw), 10),
                   plain_ms=cuda_ms(lambda: ttm.twin_partial_fwd_plain(*args, gt, **kw), 3, 1))
        bwd = dict(ms=cuda_ms(lambda: ttm.twin_partial_bwd(*bargs, **kw, tile=TWIN_TILE), 10),
                   plain_ms=cuda_ms(lambda: ttm.twin_partial_bwd_plain(*bargs, **kw,
                                                                       tile=TWIN_TILE), 3, 1))
        lib_fwd, lib_bwd = twin_library(si.E, q_l[0], kw["scale"], kw["k"])
        fwd["library_ms"] = cuda_ms(lib_fwd, 5, 1)
        bwd["library_ms"] = cuda_ms(lib_bwd, 5, 1)
        r_, d = si.E.shape
        fwd.update(twin_bound(form, True, r_, d, cols, kw["k"]))
        bwd.update(twin_bound(form, False, r_, d, cols, kw["k"]))
        out = {name("twin_partial_fwd"): fwd, name("twin_partial_bwd"): bwd}
        print(f"  {form}: a block of {cols} columns:")
        print_times(out)
        print_override_share(name("twin_partial_fwd"), fwd["ms"], ttm.twin_partial_fwd, si.E,
                             q_l[0], (*args[2:], gt), kw)
    return out


def twin_shard_parity(case, raw, n_shards: int) -> dict:
    """``parity.twin_shard_checks`` on one case; raises above a limit.
    Returns the max errors of the partial forward and backward."""
    from vlsfr_tpu_torch.utils import parity

    queue, _, kw, dce, dneg = case
    emb, g, plan, labels = raw
    checks = parity.twin_shard_checks(emb, queue, g, plan, labels, dce, dneg, kw, n_shards,
                                      tile=TWIN_TILE)
    report(checks, "the sharded twin head")
    errs = lambda *keys: max(c["err"] for c in checks  # noqa: E731
                             if c["name"].startswith("block") and c["name"].endswith(keys))
    return {"twin_partial_fwd": errs("m + log s", "top-k"),
            "twin_partial_bwd": errs("d_emb", "d_gt")}


def twin_kernel_phases() -> tuple[dict, dict]:
    """Phases 25-27. Returns (times, max errors) by kernel entry name."""
    times, errs = {}, {}
    name = lambda k_, form: k_ if form == "f32" else f"{k_}[{form}]"  # noqa: E731
    print("== phase 25: twin parity at full width; limits in vlsfr_tpu_torch/utils/parity.py "
          "(the quad's: ce / neg / logz 1e-4, top-k 1e-5, d_gt 1e-5, d_emb 1e-4 x max on f32, "
          "parity.rounded_demb on bf16)")
    for form in TWIN_FORMS:
        case, raw = twin_case(TWIN_Q, "Arc", seed=15, form=form)
        want, e = twin_parity(case)
        errs[name("twin_fwd", form)], errs[name("twin_bwd", form)] = e["fwd"], e["bwd"]
        print(f"== phase 26: {form} twin partial kernels, the queue as 1 block and as "
              f"{SHARDS} blocks of {TWIN_Q // SHARDS}")
        for n in (1, SHARDS):
            print(f"  {form}: {n} block(s):")
            for k_, err in twin_shard_parity(case, raw, n).items():
                errs[name(k_, form)] = max(errs.get(name(k_, form), 0.0), err)
        print(f"== phase 27: {form} twin timing (Q = {TWIN_Q})")
        times.update(twin_timing(form, case, want))
        times.update(twin_partial_timing(form, case, raw, want))
        del case, raw, want
        gc.collect()
        torch.cuda.empty_cache()
        for loss_type in ("AM", "SV"):
            e = twin_parity(twin_case(4096, loss_type, seed=16, form=form)[0])
            errs[name("twin_fwd", form)] = max(errs[name("twin_fwd", form)], e[1]["fwd"])
            errs[name("twin_bwd", form)] = max(errs[name("twin_bwd", form)], e[1]["bwd"])
            print(f"  {form}: Q=4096 {loss_type} in {SHARDS} blocks:")
            twin_shard_parity(*twin_case(4096, loss_type, seed=17, form=form), SHARDS)
    print("  bf16 at a resolved tile other than 512 (2048 requested, Q = 65,536):")
    _, e = twin_parity(twin_case(1 << 16, "Arc", seed=18, form="bf16")[0], tile=2048)
    errs["twin_bwd[bf16]"] = max(errs["twin_bwd[bf16]"], e["bwd"])
    return times, errs


def twin_slice_losses(trainer, batch, idx, queue, head: str, mesh=None, tile: int = TWIN_TILE):
    """Both directional losses of one batch pair and its plan ``idx`` on
    ``queue`` through ``head``: "twin" (directional_loss(use_fused=True,
    defer_scatter=True) per direction), "sharded" (the same with
    make_sharded_twin_loss over ``mesh``) or "quad" (quad_add_margin at the
    tile request ``tile``). Returns (loss_a, loss_b, the probe's parameter
    gradients, the head's d_emb [2b, D], the launch counts of the head)."""
    from vlsfr_tpu_torch.core.ffc import _pass_to, directional_loss
    from vlsfr_tpu_torch.ops import twin_margin as ttm
    from vlsfr_tpu_torch.parallel.sharded_twin import make_sharded_twin_loss

    st, dev = trainer.state, queue.device
    ia, ib = _pass_to(idx.a, dev), _pass_to(idx.b, dev)
    x, y = (torch.as_tensor(a).to(dev) for a in (batch.x, batch.y))
    b = x.shape[0]
    kw = dict(loss_type="Arc", margin=0.5, scale=32.0, hard_neg=SLICE["k"], mask_svfc=1.2)
    st.probe.train()
    st.gallery.train()
    st.probe.zero_grad(set_to_none=True)
    p_xy = st.probe(torch.cat([x, y]))
    with torch.no_grad():
        g_yx = st.gallery(torch.cat([y, x]))
    p_head = p_xy.detach().requires_grad_(True)  # the head's d_emb, then the backbone's
    p_x, p_y, g_y, g_x = p_head[:b], p_head[b:], g_yx[:b], g_yx[b:]
    ttm.reset_launch_counts()
    if head == "quad":
        (la, lb), _ = ttm.quad_add_margin(p_x, p_y, queue, g_y, g_x, (ia.rows, ia.cols, ia.seen),
                                          (ib.rows, ib.cols, ib.seen), ia.fake_labels,
                                          ib.fake_labels, tile=tile, with_acc=True, **kw)
    else:
        fn = None if mesh is None else make_sharded_twin_loss(mesh, with_acc=True, tile=tile,
                                                              **kw)
        la, plan_a, _ = directional_loss(p_x, g_y, queue, ia.rows, ia.cols, ia.seen,
                                         ia.fake_labels, use_fused=True, sharded_loss_fn=fn,
                                         defer_scatter=True, with_acc=True, **kw)
        lb, plan_b, _ = directional_loss(p_y, g_x, queue, ib.rows, ib.cols, ib.seen,
                                         ib.fake_labels, use_fused=True, sharded_loss_fn=fn,
                                         defer_scatter=True, with_acc=True, **kw)
        if not (torch.equal(plan_b[0], g_x) and torch.equal(plan_b[2], ib.cols)):
            raise RuntimeError("directional_loss(defer_scatter=True) must return the write plan")
    (la + lb).backward()
    launches = dict(ttm.LAUNCH_COUNTS)
    p_xy.backward(p_head.grad)
    torch.cuda.synchronize()
    grads = {k_: v.grad.detach().clone() for k_, v in st.probe.named_parameters()
             if v.grad is not None}
    return float(la.detach()), float(lb.detach()), grads, p_head.grad.detach().clone(), launches


def twin_slice_phase(card: str, tmp: str) -> dict:
    """Phase 28: the twin slice end to end on an ir50 probe and gallery in
    f32, one DCP batch pair at batch 128, the 2^20 f32 queue, then its bf16
    copy. Returns the twin launch counts of the twin runs."""
    from vlsfr_tpu_torch.parallel import distributed
    from vlsfr_tpu_torch.parallel.mesh import make_mesh
    from vlsfr_tpu_torch.utils import parity

    kernels = ("twin_fwd", "twin_bwd", "twin_partial_fwd", "twin_partial_bwd")
    trainer = ffc_trainer(tmp, "model.dtype=float32")
    launches = {}
    try:
        for s_ in range(3):  # warm the pool: pool hits, seen flags and blend writes
            bt = trainer.pipeline.make_batch(0, s_)
            trainer.dcp.plan_step(bt.x_label, bt.y_label)
        batch = trainer.pipeline.make_batch(0, 3)
        idx = trainer.dcp.plan_step(batch.x_label, batch.y_label)
        print(f"  the batch pair: {int((idx.a.fake_labels >= 0).sum())} + "
              f"{int((idx.b.fake_labels >= 0).sum())} in-pool probe rows, "
              f"{int(idx.a.seen.sum())} + {int(idx.b.seen.sum())} pool hits")
        run = functools.partial(twin_slice_losses, trainer, batch, idx)
        q32 = trainer.state.queue
        for form, queue in (("f32", q32), ("bf16", None)):
            if queue is None:
                queue = q32.bfloat16()
            name = lambda k_: k_ if form == "f32" else f"{k_}[{form}]"  # noqa: E731
            t0 = time.perf_counter()
            la, lb, g_t, d_t, got = run(queue, "twin")
            wall = (time.perf_counter() - t0) * 1e3
            want = {name(k_): 2 for k_ in ("twin_fwd", "twin_bwd")}
            print(f"  {form} twin: losses A {la:.6f} B {lb:.6f}; launches "
                  f"{ {k_: v for k_, v in got.items() if v} }; forward + backward "
                  f"{wall:.1f} ms ({card})")
            if not only_launched(got, want):
                raise RuntimeError(f"each directional loss must launch twin_fwd and twin_bwd "
                                   f"once and no quad kernel: {got}")
            launches.update(want)
            qa, qb, g_q, d_q, _ = run(queue, "quad", tile=TWIN_TILE)
            rel = max(abs(la - qa) / abs(qa), abs(lb - qb) / abs(qb))
            print(f"  {form} quad (tile {TWIN_TILE}): losses A {qa:.6f} B {qb:.6f}; max "
                  f"relative difference {rel:.3e} <= 1e-5")
            if not rel <= 1e-5:
                raise RuntimeError(f"the {form} twin pair's losses disagree with the quad's")
            if form == "f32":
                worst = max(float(((v.double() - g_q[k_].double()).abs()
                                   - 1e-5 * g_q[k_].double().abs()).max())
                            for k_, v in g_t.items())
                print(f"  f32 probe parameter gradients, twin against quad: "
                      f"max(|diff| - 1e-5 |quad|) {worst:.3e} <= 2e-5")
                if not worst <= 2e-5:
                    raise RuntimeError("the twin pair's gradients disagree with the quad's")
            else:
                checks = parity.rounded_demb("head d_emb, twin vs quad (both tile 512)", d_t, d_q)
                report(checks, "the bf16 twin pair's head d_emb and the quad's")
                qa2, qb2, _, d_q2, _ = run(queue, "quad", tile=FORM_TILE)
                rel2 = max(abs(la - qa2) / abs(qa2), abs(lb - qb2) / abs(qb2))
                print(f"  bf16 quad at the step's tile request {FORM_TILE} (d_cos rounded on "
                      f"other tiles): losses max relative difference {rel2:.3e} <= 1e-5")
                if not rel2 <= 1e-5:
                    raise RuntimeError("the bf16 twin pair's losses disagree with the quad's")
                report(parity.rounded_demb(f"head d_emb, twin ({TWIN_TILE}) vs quad "
                                           f"({FORM_TILE})", d_t, d_q2),
                       "the bf16 twin pair's head d_emb and the quad's at its own tile")
            if not distributed.initialize("cuda"):
                raise RuntimeError("a process group outlived its phase")
            try:
                mesh = make_mesh(1, 1)
                sa, sb, _, d_s, got = run(queue, "sharded", mesh=mesh)
            finally:
                distributed.destroy()
            want = {name(k_): 2 for k_ in ("twin_partial_fwd", "twin_partial_bwd")}
            rel = max(abs(sa - la) / abs(la), abs(sb - lb) / abs(lb))
            print(f"  {form} sharded twin (NCCL group of one): losses A {sa:.6f} B {sb:.6f}, "
                  f"max relative difference to twin_add_margin {rel:.3e} <= 1e-5; launches "
                  f"{ {k_: v for k_, v in got.items() if v} }")
            checks = parity.demb_checks("head d_emb, sharded vs single", d_s, d_t, queue.dtype)
            report(checks, f"the {form} sharded twin head")
            if not (rel <= 1e-5 and only_launched(got, want)):
                raise RuntimeError(f"the {form} sharded twin must match twin_add_margin and "
                                   f"launch each partial kernel once per direction: {got}")
            launches.update(want)
            del queue
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        free_trainer(trainer)
    return {k_: v for k_, v in launches.items() if k_.split("[")[0] in kernels}


# ----------------------------------------------------------------------
# the softmax head's bf16 classifier (softmax_1m_bf16: ir50, 2^20 bf16
# classes, bf16 momentum, fused SGD)
# ----------------------------------------------------------------------

BF16 = ("pool.classifier_dtype=bfloat16",)
# phase 29's second fused case: at LR and a 0.01-scale momentum the gradient
# and wd·w of an unlabelled row fall below one bf16 spacing of w and mom, so
# w' / mom' there only show that they stayed; with the momentum scaled down
# and a large lr, lr·wd·w (1 % of w) and lr·d_w move w', and g moves mom'
MOVING_MOM, MOVING_LR = 1e-4, 100.0
FUSED_PAIRS = {"bf16,bf16": (torch.bfloat16, torch.bfloat16),
               "bf16,f32": (torch.bfloat16, torch.float32),
               "f32,bf16": (torch.float32, torch.bfloat16)}
# source edits of csrc/margin_ce.cu that break the bf16 form, each of which
# the bf16 checks must reject (vlsfr_tpu_torch/utils/parity.py): an (old,
# new) pair or a tuple of them. The first three are planted in the tensor-
# core staging and d_w epilogue that margin_ce_bwd runs (the forward shares
# the staging), the last in the fused update
BF16_FAULTS = {
    "truncates the W operand (rounds toward zero)": (
        "h = __floats2bfloat162_rn(f.x * s, f.y * s);",
        "h = __halves2bfloat162(__float2bfloat16_rz(f.x * s), __float2bfloat16_rz(f.y * s));"),
    "rounds the stored row and scales afterwards": (
        ("h = __floats2bfloat162_rn(f.x * s, f.y * s);", "h = __floats2bfloat162_rn(f.x, f.y);"),
        ("? dcos_of(acc1[0][ni][2 * h + j], p0 + c + j,",
         "? dcos_of(acc1[0][ni][2 * h + j] * inv[c + j], p0 + c + j,"),
        ("*reinterpret_cast<__nv_bfloat162*>(Dq + swz(lr, c, E_TC / 8)) =\n"
         "            __floats2bfloat162_rn(d[0], d[1]);",
         "*reinterpret_cast<__nv_bfloat162*>(Dq + swz(lr, c, E_TC / 8)) =\n"
         "            __floats2bfloat162_rn(d[0] * inv[c], d[1] * inv[c + 1]);"),
        ("? dcos_of(acc[mi][ni][2 * h + j], t0 + c + j,",
         "? dcos_of(acc[mi][ni][2 * h + j] * inv[c + j], t0 + c + j,")),
    "takes <d_w_hat, w_hat> against the rounded w_hat": (
        "s = fmaf(dwh[mi][j][2 * h], wf.x * iv, s);\n"
        "          s = fmaf(dwh[mi][j][2 * h + 1], wf.y * iv, s);",
        "s = fmaf(dwh[mi][j][2 * h], bf16r(wf.x * iv), s);\n"
        "          s = fmaf(dwh[mi][j][2 * h + 1], bf16r(wf.y * iv), s);"),
    "rounds new_w twice": (
        "          store_as(w_upd + off, wv - sgd.lr * upd);",
        "          store_as(w_upd + off, wv + bf16r(-sgd.lr * upd));"),
}


def bf16_case(c: int, loss_type: str, k: int, frac_outlier: float, seed: int,
              pair: str = "bf16,bf16"):
    """``softmax_case`` with the classifier and momentum stored in the
    pair's dtypes (the f32 draw cast, as JAX casts its init)."""
    emb, w, mom, labels, d_ce, d_neg, kw = softmax_case(c, loss_type, k, frac_outlier, seed)
    w_dt, m_dt = FUSED_PAIRS[pair]
    return emb, w.to(w_dt), mom.to(m_dt), labels, d_ce, d_neg, kw


def bf16_softmax_checks(case, tag: str, lr: float = LR) -> dict:
    """The forward (bf16 classifier) and both backward kernels against their
    plain versions on one case (``parity.margin_ce_bwd_checks``: the bf16
    forms' limits; the fused update at ``lr``); raises above a limit.
    Returns the max errors by kernel form, and the forward's (gt, logz,
    topk)."""
    from vlsfr_tpu_torch.ops import margin_stream as tms
    from vlsfr_tpu_torch.utils import parity

    emb, w, mom, labels, d_ce, d_neg, kw = case
    gt = tms.compute_gt(emb, w, labels)
    got = tms.margin_ce_fwd(emb, w, labels, gt, **kw)
    want = tms.margin_ce_fwd_plain(emb, w, labels, gt, **kw)
    rounded = w.dtype == torch.bfloat16
    fwd = (parity.rounded_fwd_checks(got, want) if rounded else
           [parity._err(n, g, wn, t) for n, g, wn, t in
            zip(("ce", "neg", "logz", "top-k"), got, want, (1e-4, 1e-4, 1e-4, 1e-5))])
    logz, topk = want[2], want[3]
    del got, want
    bwd, fused = parity.margin_ce_bwd_checks(emb, w, mom, labels, gt, logz, topk, d_ce, d_neg,
                                             kw, lr, SGD)
    print(f"  {tag}:")
    report(fwd + bwd + fused, f"the bf16 margin_ce forms ({tag})")
    value = lambda checks: max((c["err"] for c in checks if not c.get("count")  # noqa: E731
                                and not c.get("excess")), default=0.0)
    pair = ",".join("bf16" if t.dtype == torch.bfloat16 else "f32" for t in (w, mom))
    out = {f"margin_ce_bwd_fused_sgd[{pair}]": value(fused)}
    if rounded:
        out.update({"margin_ce_fwd[bf16]": value(fwd), "margin_ce_bwd[bf16]": value(bwd)})
    return out, (gt, logz, topk)


def start_faulty_builds(tmp: str, source: str = "margin_ce", faults: dict = BF16_FAULTS) -> dict:
    """One nvcc per planted fault (source edits of ``csrc/<source>.cu``: an
    (old, new) pair or a tuple of them), all started together: {fault:
    (process, library path)}."""
    import pathlib
    import shutil

    from vlsfr_tpu_torch.ops import cuda_build

    src = (cuda_build.CSRC / f"{source}.cu").read_text()
    procs = {}
    for i, (name, spec) in enumerate(faults.items()):
        edited = src
        for old, new in (spec if isinstance(spec[0], tuple) else (spec,)):
            if src.count(old) != 1:
                raise RuntimeError(f"the planted fault {name!r} does not match {source}.cu once")
            edited = edited.replace(old, new)
        out = pathlib.Path(tmp) / f"{source}_fault{i}"
        out.mkdir()
        shutil.copy(cuda_build.CSRC / "margin_common.cuh", out)
        (out / f"{source}.cu").write_text(edited)
        procs[name] = (cuda_build.start_nvcc(out / f"{source}.cu", out / f"lib{source}.so"),
                       out / f"lib{source}.so")
    return procs


@contextlib.contextmanager
def planted(source: str, name: str, proc_and_path):
    """The wrappers of ``csrc/<source>.cu`` launch the planted fault's
    library (its build awaited) inside the block, the real one after."""
    import ctypes

    from vlsfr_tpu_torch.ops import cuda_build

    proc, lib_path = proc_and_path
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for the planted fault {name!r}:\n{log}")
    real = cuda_build._LOADED.get(source)
    cuda_build._LOADED[source] = ctypes.CDLL(str(lib_path))
    try:
        yield
    finally:
        if real is None:
            cuda_build._LOADED.pop(source, None)
        else:
            cuda_build._LOADED[source] = real


# what each planted fault must fail: margin_ce_bwd's d_emb and d_w row
# counts (the staging faults), its d_w count alone (the projection's), the
# fused update's w' count
FAULT_MUST_FAIL = {
    "truncates the W operand (rounds toward zero)": (
        "d_emb (grad_w=True) rows beyond 1e-05 x max", "d_w (other rows) rows beyond 1e-05 x max"),
    "rounds the stored row and scales afterwards": (
        "d_emb (grad_w=True) rows beyond 1e-05 x max", "d_w (other rows) rows beyond 1e-05 x max"),
    "takes <d_w_hat, w_hat> against the rounded w_hat": (
        "d_w (other rows) rows beyond 1e-05 x max",),
    "rounds new_w twice": ("w' elements apart",),
}


def check_planted_faults(procs: dict) -> None:
    """Each faulty margin_ce.cu, built, at full width (B = 128, D = 512,
    C = 2^20, Arc, bf16 classifier and momentum) against the plain versions
    from the plain forward's logz / top-k: margin_ce_bwd's d_emb and d_w by
    the bf16 checks and the fused update's w' by ``parity.bf16_ulps``; each
    fault must fail its FAULT_MUST_FAIL checks (the projection fault no
    d_emb check); the real library passes the same checks (phase 29)."""
    from vlsfr_tpu_torch.ops import margin_stream as tms
    from vlsfr_tpu_torch.utils import parity

    emb, w, mom, labels, d_ce, d_neg, kw = bf16_case(SOFTMAX["c"], "Arc", 1, 0.0, seed=21)
    # the references are the plain versions on the real kernels' cosines
    gt = tms.compute_gt(emb, w, labels)
    want = tms.margin_ce_fwd_plain(emb, w, labels, gt, **kw)
    logz, topk = want[2], want[3]
    bwd = (emb, w, labels, gt, logz, topk, d_ce, d_neg)
    d_ce_m, _ = tms._mask_cotangents(labels >= 0, d_ce, d_neg)
    term, _ = tms._target_rows(emb, w, labels, gt, logz, d_ce_m, loss_type=kw["loss_type"],
                               margin=kw["margin"], scale=kw["scale"])
    cos = tms.clean_cos(emb, w)  # the real kernels' cosines (parity's module docstring)
    de_p, dw_p = tms.margin_ce_bwd_plain(*bwd, cos=cos, **kw)
    w0, mom0 = w.clone(), mom.clone()
    tms.margin_ce_bwd_fused_sgd_plain(emb, w, mom, labels, gt, logz, topk, d_ce, d_neg, LR,
                                      cos=cos, **SGD, **kw)
    del cos
    w_p = w
    for name, proc_and_path in procs.items():
        with planted("margin_ce", name, proc_and_path):
            de_k, dw_k = tms.margin_ce_bwd(emb, w0, *bwd[2:], **kw)
            w_k, mom_k = w0.clone(), mom0.clone()
            tms.margin_ce_bwd_fused_sgd(emb, w_k, mom_k, labels, gt, logz, topk, d_ce, d_neg, LR,
                                        **SGD, **kw)
        checks = (parity.softmax_demb("d_emb (grad_w=True)", de_k, de_p, de_p - term,
                                      cols=SOFTMAX["c"])
                  + parity.rounded_rows("d_w", dw_k, dw_p, dw_p, labels)
                  + parity.bf16_ulps("w'", w_k, w_p, w0))
        failed = {c["name"] for c in parity.failures(checks)}
        print(f"  planted fault ({name}): fails " + "; ".join(
            parity.describe(c) for c in checks if c["name"] in failed))
        demb_ok = name != "takes <d_w_hat, w_hat> against the rounded w_hat" or not any(
            n.startswith("d_emb") for n in failed)
        if not (set(FAULT_MUST_FAIL[name]) <= failed and demb_ok):
            raise RuntimeError(f"the bf16 checks pass a margin_ce.cu that {name}")
        del de_k, dw_k, w_k, mom_k


def bf16_parity_phase(tmp: str) -> dict:
    """Phase 29: the bf16 forms at full width, each against its plain
    version; the planted faults. Returns the max errors by kernel form."""
    from vlsfr_tpu_torch.ops import margin_stream as tms
    from vlsfr_tpu_torch.utils import parity

    procs = start_faulty_builds(tmp)
    errs = {}
    for pair in FUSED_PAIRS:
        for moving in (False, True):
            case = bf16_case(SOFTMAX["c"], "Arc", 1, 0.0, 2, pair)
            tag = f"C={SOFTMAX['c']} Arc k=1, (w, mom) = ({pair})"
            if moving:  # g and wd·w move w' and mom' on every row (module docstring)
                case = (*case[:2], (case[2].float() * MOVING_MOM).to(case[2].dtype), *case[3:])
                tag += f", momentum x {MOVING_MOM:g}, lr {MOVING_LR:g}"
            e, _ = bf16_softmax_checks(case, tag, MOVING_LR if moving else LR)
            errs.update({k: max(v, errs.get(k, 0.0)) for k, v in e.items()})
            del case
            gc.collect()
            torch.cuda.empty_cache()
    for loss_type, k, frac in (("AM", 1, 0.0), ("SV", 1, 0.0), ("Arc", 3, 0.3)):
        bf16_softmax_checks(bf16_case(4096, loss_type, k, frac, 3),
                            f"C=4096 {loss_type} k={k} (bf16, bf16)")
    emb, w, _, labels, d_ce, d_neg, kw = bf16_case(SOFTMAX["c"], "Arc", 1, 0.0, 4)
    b, d = emb.shape
    tile, n_tiles = tms.sparse_bwd_geometry(b, d, SOFTMAX["c"])
    m = tms.sparse_m_tiles(SPARSE_RATE, n_tiles, b)
    print(f"  route D's pieces: the forward with statistics (tile {tile}) and the sparse "
          f"backward over {m} of {n_tiles} tiles ({m * tile} rows)")
    u = torch.rand((n_tiles,), generator=torch.Generator(device=emb.device).manual_seed(4),
                   device=emb.device)
    checks, tile_idx, (gt, logz, topk) = parity.sparse_path_checks(emb, w, labels, d_ce, d_neg,
                                                                    kw, tile, m, u)
    report(checks, "the bf16 forward statistics / sparse backward")
    errs["margin_ce_bwd_sparse[bf16]"] = max(c["err"] for c in checks if c["name"].startswith(
        "sparse") and not c.get("count") and not c.get("excess"))
    errs["margin_ce_fwd[bf16]"] = max(errs["margin_ce_fwd[bf16]"], max(
        c["err"] for c in checks if c["name"] in ("maxz", "maxcos")))
    sparse_case = (emb, w, labels, d_ce, d_neg, kw, tile, tile_idx, gt, logz, topk)
    for c, n in ((SOFTMAX["c"], 1), (SHIPPED_CLASSES, CLASS_SHARDS)):
        print(f"  the partial kernels, the bf16 classifier as {n} block(s) of {c // n}:")
        e, w, mom, labels, d_ce, d_neg, kw = bf16_case(c, "Arc", 1, 0.0, 8 + n)
        checks, _ = parity.margin_shard_checks(e, w, labels, d_ce, d_neg, kw, n)
        report(checks, "the bf16 partial kernels")
        for key, names in (("margin_partial_fwd[bf16]", ("m + log s", "top-k")),
                           ("margin_partial_bwd[bf16]", ("d_emb", "d_w"))):
            errs[key] = max(errs.get(key, 0.0), max(
                ch["err"] for ch in checks if any(f"partial {x}" in ch["name"] for x in names)
                and not ch.get("count") and not ch.get("excess")))
        del e, w, mom
        gc.collect()
        torch.cuda.empty_cache()
    print("  planted faults of the bf16 form (margin_ce.cu copies built at the start of this "
          "phase):")
    check_planted_faults(procs)
    return errs, sparse_case



def bf16_timing_phase(sparse_case) -> dict:
    """Phase 30: each bf16 form at full width: kernel, plain version, a
    PyTorch composition on the tensor cores (bf16 matmuls, f32 accumulate;
    the port never calls it) and the bound: bytes at 3.35 TB/s against the
    dots at 989 TFLOP/s (bf16), or at the f32 rate for the f32 classifier
    beside a bf16 momentum."""
    import torch.nn.functional as F

    from vlsfr_tpu_torch.ops import margin_stream as tms
    from vlsfr_tpu_torch.parallel._shard_common import localize_labels

    out = {}
    emb, w, mom, labels, d_ce, d_neg, kw = bf16_case(SOFTMAX["c"], "Arc", 1, 0.0, 13)
    b, d = emb.shape
    c, k = w.shape[0], kw["k"]
    gt = tms.compute_gt(emb, w, labels)
    _, _, logz, topk = tms.margin_ce_fwd(emb, w, labels, gt, **kw)
    args, bargs = (emb, w, labels, gt), (emb, w, labels, gt, logz, topk, d_ce, d_neg)
    product = 2.0 * b * d * c
    vecs = 4 * (b * d + 4 * b)
    wb = w.bfloat16()
    eb = emb.bfloat16()

    def lib_fwd(blk=wb):  # yardsticks only: the port never calls these
        cos = (eb @ F.normalize(blk.float(), dim=1).bfloat16().T).float()
        torch.logsumexp(kw["scale"] * cos, dim=1)
        torch.topk(cos, k, dim=1)

    d_cos = torch.randn((b, c), device=emb.device).mul_(1e-4).bfloat16()

    def lib_bwd():  # the kernel's work: the cosine recompute, then both products
        wn = F.normalize(w.float(), dim=1).bfloat16()
        (eb @ wn.T).float()
        torch.matmul(d_cos, wn).float()
        return torch.matmul(d_cos.T, eb).float()

    out["margin_ce_fwd[bf16]"] = dict(
        ms=cuda_ms(lambda: tms.margin_ce_fwd(*args, **kw), 10),
        plain_ms=cuda_ms(lambda: tms.margin_ce_fwd_plain(*args, **kw), 3, 1),
        library_ms=cuda_ms(lib_fwd, 5, 1),
        **bound(product, 2 * c * d + vecs + 4 * b * (3 + k), product / PEAK_BF16_FLOPS * 1e3))
    out["margin_ce_bwd[bf16]"] = dict(
        ms=cuda_ms(lambda: tms.margin_ce_bwd(*bargs, **kw), 5),
        plain_ms=cuda_ms(lambda: tms.margin_ce_bwd_plain(*bargs, **kw), 3, 1),
        library_ms=cuda_ms(lib_bwd, 5, 1),
        **bound(3 * product, 6 * c * d + vecs + 4 * b + 4 * b * d,
                3 * product / PEAK_BF16_FLOPS * 1e3))
    for pair, (w_dt, m_dt) in FUSED_PAIRS.items():
        w_s, mom_s = w.to(w_dt), mom.to(m_dt)
        wi, mi = w_s.element_size(), mom_s.element_size()
        ops_ms = 3 * product / (PEAK_BF16_FLOPS if w_dt == torch.bfloat16
                                else PEAK_F32_FLOPS) * 1e3

        def lib_fused():  # the bf16 products, then the SGD chain in f32 stored back
            g = lib_bwd().add_(w_s.float(), alpha=SGD["weight_decay"])
            m_new = mom_s.float().mul_(SGD["momentum"]).add_(g)
            w_s.copy_(w_s.float().sub_(g.add_(m_new, alpha=SGD["momentum"]), alpha=LR))
            mom_s.copy_(m_new)

        fused = lambda: tms.margin_ce_bwd_fused_sgd(emb, w_s, mom_s, labels, gt, logz,  # noqa
                                                    topk, d_ce, d_neg, LR, **SGD, **kw)
        plain = lambda: tms.margin_ce_bwd_fused_sgd_plain(emb, w_s, mom_s, labels, gt,  # noqa
                                                          logz, topk, d_ce, d_neg, LR, **SGD,
                                                          **kw)
        out[f"margin_ce_bwd_fused_sgd[{pair}]"] = dict(
            ms=cuda_ms(fused, 5), plain_ms=cuda_ms(plain, 3, 1),
            library_ms=cuda_ms(lib_fused, 3, 1),
            **bound(3 * product + 8.0 * c * d, 2 * (wi + mi) * c * d + vecs + 4 * b + 8 * b * d,
                    ops_ms))
        del w_s, mom_s
        gc.collect()
        torch.cuda.empty_cache()
    semb, sw, slabels, sd_ce, sd_neg, skw, tile, tile_idx, sgt, slogz, stopk = sparse_case
    ncols = tile_idx.shape[0] * tile
    sargs = (semb, sw, slabels, sgt, slogz, stopk, sd_ce, sd_neg, tile_idx)
    cols = (tile_idx.long()[:, None] * tile
            + torch.arange(tile, device=emb.device)[None, :]).reshape(-1)

    def lib_sparse():
        wn_s = F.normalize(torch.index_select(sw, 0, cols).float(), dim=1).bfloat16()
        dc = torch.exp(skw["scale"] * (semb.bfloat16() @ wn_s.T).float() - slogz[:, None])
        dc = dc.mul_(sd_ce[:, None] * skw["scale"]).bfloat16()
        torch.matmul(dc, wn_s).float()
        torch.matmul(dc.T, semb.bfloat16()).float()

    sp = 2.0 * b * d * ncols
    out["margin_ce_bwd_sparse[bf16]"] = dict(
        ms=cuda_ms(lambda: tms.margin_ce_bwd_sparse(*sargs, tile=tile, **skw), 10),
        plain_ms=cuda_ms(lambda: tms.margin_ce_bwd_sparse_plain(*sargs, tile=tile, **skw), 3, 1),
        library_ms=cuda_ms(lib_sparse, 10, 1),
        **bound(3 * sp, 6 * ncols * d + 4 * (b * d + 4 * b) + 4 * tile_idx.shape[0] + 4 * b * d,
                3 * sp / PEAK_BF16_FLOPS * 1e3))
    kth = topk[:, -1].contiguous()
    d_ce_m, d_neg_m = tms._mask_cotangents(labels >= 0, d_ce, d_neg)
    ll, _ = localize_labels(0, c, labels)
    _, d_wl = tms._target_rows(emb, w, ll, gt, logz, d_ce_m, loss_type=kw["loss_type"],
                               margin=kw["margin"], scale=kw["scale"])
    fargs, pargs = (emb, w, ll, gt), (emb, w, ll, gt, logz, kth, d_ce_m, d_neg_m, d_wl)
    out["margin_partial_fwd[bf16]"] = dict(
        ms=cuda_ms(lambda: tms.margin_partial_fwd(*fargs, **kw), 10),
        plain_ms=cuda_ms(lambda: tms.margin_partial_fwd_plain(*fargs, **kw), 3, 1),
        library_ms=cuda_ms(lib_fwd, 5, 1),
        **bound(product, 2 * c * d + 4 * (b * d + 2 * b) + 4 * b * (2 + k),
                product / PEAK_BF16_FLOPS * 1e3))
    out["margin_partial_bwd[bf16]"] = dict(
        ms=cuda_ms(lambda: tms.margin_partial_bwd(*pargs, **kw), 5),
        plain_ms=cuda_ms(lambda: tms.margin_partial_bwd_plain(*pargs, **kw), 3, 1),
        library_ms=cuda_ms(lib_bwd, 5, 1),
        **bound(3 * product, 6 * c * d + 12 * b * d + 4 * 7 * b,
                3 * product / PEAK_BF16_FLOPS * 1e3))
    del d_cos
    print_times(out)
    # margin_partial_bwd over a 4-card block of the shipped 5,000,000 classes
    # (1,250,000 columns: not a multiple of 64); not on the kernels line
    cb = SHIPPED_CLASSES // CLASS_SHARDS
    w_b = bf16_case(cb, "Arc", 1, 0.0, 14)[1]
    ll_b, _ = localize_labels(0, cb, labels)
    gt_b = tms.compute_gt(emb, w_b, ll_b)
    _, d_wl_b = tms._target_rows(emb, w_b, ll_b, gt_b, logz, d_ce_m, loss_type=kw["loss_type"],
                                 margin=kw["margin"], scale=kw["scale"])
    bargs_b = (emb, w_b, ll_b, gt_b, logz, kth, d_ce_m, d_neg_m, d_wl_b)
    d_cos_b = torch.randn((b, cb), device=emb.device).mul_(1e-4).bfloat16()

    def lib_bwd_b():
        wn_b = F.normalize(w_b.float(), dim=1).bfloat16()
        (eb @ wn_b.T).float()
        torch.matmul(d_cos_b, wn_b).float()
        return torch.matmul(d_cos_b.T, eb).float()

    pb = 2.0 * b * d * cb
    v = dict(ms=cuda_ms(lambda: tms.margin_partial_bwd(*bargs_b, **kw), 5),
             plain_ms=cuda_ms(lambda: tms.margin_partial_bwd_plain(*bargs_b, **kw), 3, 1),
             library_ms=cuda_ms(lib_bwd_b, 5, 1),
             **bound(3 * pb, 6 * cb * d + 12 * b * d + 4 * 7 * b, 3 * pb / PEAK_BF16_FLOPS * 1e3))
    print(f"  margin_partial_bwd[bf16] over {cb} columns: ms={v['ms']:.3f} "
          f"plain_ms={v['plain_ms']:.3f} library_ms={v['library_ms']:.3f} "
          f"bound_ms={v['bound_ms']:.3f} ({v['bound_by']})")
    return out


def bf16_first_step(tmp: str) -> None:
    """softmax_1m_bf16's first step through the Trainer against the plain
    composition of the same step on the same inputs: the embeddings, the
    classifier and momentum before it and the lr the step handed its head
    (recorded). The loss against margin_ce_fwd_plain's (1e-5 relative) and
    the step's forward (margin_ce_fwd again on those inputs: the kernel's
    outputs are bit-stable) by ``parity.rounded_fwd_checks``; then the
    update against margin_ce_bwd_fused_sgd_plain on the step's logz and
    top-k (on the plain forward's, whose last bits differ, more terms of
    bf16(d_cos) straddle: read on an H100, 405 momentum rows of 2^20 past
    d_w's tight limit). The classifier by ``parity.bf16_ulps``
    from the classifier before the step, outside the rows whose d_w
    straddled (margin_ce_bwd against its plain version on the same inputs,
    ``parity.straddled_rows``); the momentum, bf16(g) after a zero start, by
    ``parity.bf16_fresh_state``."""
    from vlsfr_tpu_torch.ops import margin_stream as tms
    from vlsfr_tpu_torch.train import softmax_head
    from vlsfr_tpu_torch.utils import parity

    rec = {}
    head = softmax_head.streaming_margin_grads_fused_sgd

    def recording(emb, w, mom, labels, d_ce, d_neg, lr, **kw):
        rec.update(args=[x.clone() for x in (emb, w, mom, labels, d_ce, d_neg)], lr=lr, kw=kw)
        return head(emb, w, mom, labels, d_ce, d_neg, lr, **kw)

    softmax_head.streaming_margin_grads_fused_sgd = recording
    try:
        trainer = softmax_trainer(tmp, *BF16, "pool.classifier_mom_dtype=bfloat16",
                                  "pool.fused_update=on")
    finally:
        softmax_head.streaming_margin_grads_fused_sgd = head
    try:
        st = trainer.state
        if (st.classifier.dtype, st.classifier_mom.dtype) != (torch.bfloat16, torch.bfloat16):
            raise RuntimeError("softmax_1m_bf16 must hold a bf16 classifier and momentum")
        batch = trainer.pipeline.make_batch(0, 0)
        loss = float(trainer.train_step(st, batch.images, batch.labels, 1.0)["loss"])
        emb, w0, mom0, labels, d_ce, d_neg = rec["args"]
        kw = rec["kw"]
        fkw = dict(loss_type=kw["loss_type"], margin=float(kw["margin"]),
                   scale=float(kw["scale"]), k=int(kw["hard_neg"]),
                   mask_svfc=float(kw["mask_svfc"]))
        emb = emb.float().contiguous()
        labels = labels.to(torch.int32)
        gt = tms.compute_gt(emb, w0, labels)
        want = tms.margin_ce_fwd_plain(emb, w0, labels, gt, **fkw)
        got = tms.margin_ce_fwd(emb, w0, labels, gt, **fkw)  # the step's forward, bit-stable
        checks = parity.rounded_fwd_checks(got, want)
        loss_p = float(want[0].mean())
        logz, topk = got[2], got[3]
        checks += parity.margin_cos_checks(emb, w0)
        cos = tms.clean_cos(emb, w0)  # the plain versions on the kernels' cosines
        w_p, mom_p = w0.clone(), mom0.clone()
        tms.margin_ce_bwd_fused_sgd_plain(emb, w_p, mom_p, labels, gt, logz, topk, d_ce, d_neg,
                                          rec["lr"], momentum=kw["momentum"],
                                          nesterov=kw["nesterov"],
                                          weight_decay=kw["weight_decay"], cos=cos, **fkw)
        bwd = (emb, w0, labels, gt, logz, topk, d_ce, d_neg)
        _, dw_k = tms.margin_ce_bwd(*bwd, **fkw)
        _, dw_p = tms.margin_ce_bwd_plain(*bwd, cos=cos, **fkw)
        del cos
        straddled = parity.straddled_rows(dw_k, dw_p, labels)
        del dw_k, dw_p
        checks += parity.bf16_ulps("classifier", st.classifier, w_p, w0, straddled)
        checks += parity.bf16_fresh_state("momentum", st.classifier_mom, mom_p, labels)
        print(f"  rows whose d_w straddled a bf16 boundary: {int(straddled.sum())} of "
              f"{straddled.numel()}")
        print(f"  first step: loss {loss:.6f} against the plain composition's {loss_p:.6f} "
              f"(1e-5 relative); the forward, then the classifier and momentum against the "
              f"plain update on the step's forward:")
        report(checks, "softmax_1m_bf16's first step")
        if not abs(loss - loss_p) <= 1e-5 * abs(loss_p):
            raise RuntimeError("softmax_1m_bf16's first-step loss disagrees")
    finally:
        free_trainer(trainer)
        rec.clear()
        gc.collect()
        torch.cuda.empty_cache()


BF16_TRAIN = {  # run: (overrides, steps, {kernel form: launches per step})
    "softmax_1m_bf16 (route A, bf16 momentum)": (
        (*BF16, "pool.classifier_mom_dtype=bfloat16", "pool.fused_update=on"), TRAIN_STEPS,
        {"margin_ce_fwd[bf16]": 1, "margin_ce_bwd_fused_sgd[bf16,bf16]": 1}),
    "route A, bf16 classifier, f32 momentum": (
        (*BF16, "pool.fused_update=on"), ROUTE_B_STEPS,
        {"margin_ce_fwd[bf16]": 1, "margin_ce_bwd_fused_sgd[bf16,f32]": 1}),
    "route A, f32 classifier, bf16 momentum": (
        ("pool.classifier_mom_dtype=bfloat16", "pool.fused_update=on"), ROUTE_B_STEPS,
        {"margin_ce_fwd": 1, "margin_ce_bwd_fused_sgd[f32,bf16]": 1}),
    "route B, bf16 classifier": (
        (*BF16, "pool.fused_update=off"), ROUTE_B_STEPS,
        {"margin_ce_fwd[bf16]": 1, "margin_ce_bwd[bf16]": 1}),
    "route D, bf16 classifier": (
        (*BF16, "pool.sparse_update=true", f"pool.sparse_grad_rate={SPARSE_RATE}"), ROUTE_B_STEPS,
        {"margin_ce_fwd[bf16]": 1, "margin_ce_bwd[bf16]": 1, "margin_ce_bwd_sparse[bf16]": 1}),
}


def bf16_train_phase(card: str, tmp: str) -> dict:
    """Phase 31: softmax_1m_bf16's first step against the plain composition,
    then each BF16_TRAIN run through ``Trainer.train`` with its launch
    counts, step time and peak memory. Returns the launches by kernel form
    (each form from its run)."""
    from vlsfr_tpu_torch.ops import margin_stream as tms

    bf16_first_step(tmp)
    launches = {}
    for run, (overrides, n, per_step) in BF16_TRAIN.items():
        trainer = softmax_trainer(tmp, *overrides)
        try:
            tms.reset_launch_counts()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = trainer.train(max_steps=n)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = dict(tms.LAUNCH_COUNTS)
            peak = torch.cuda.max_memory_allocated()
            want = {name: n * per_step.get(name, 0) for name in got}
            print(f"  {run}, {n} steps: {json.dumps(out)}")
            print(f"  launches: { {k: v for k, v in got.items() if v} }")
            if got != want or not (math.isfinite(out["loss"]) and out["loss"] > 0
                                   and out["final_step"] == n):
                raise RuntimeError(f"{run} must launch {want} and train to a finite loss: "
                                   f"{got}, {out}")
            print_step(run, out, wall, peak, card)
            for name in per_step:
                launches.setdefault(name, got[name])
            if run.startswith("softmax_1m_bf16"):
                print("== phase 31b: profile of two more softmax_1m_bf16 steps")
                profile_trainer(trainer)
        finally:
            free_trainer(trainer)
    return launches


BF16_SHARDED_LAUNCHES = {  # route: {kernel form: launches per step}
    "A": {"margin_partial_fwd[bf16]": 1, "margin_ce_bwd_fused_sgd[bf16,bf16]": 1},
    "B": {"margin_partial_fwd[bf16]": 1, "margin_partial_bwd[bf16]": 1},
    "D": {"margin_ce_fwd[bf16]": 1, "margin_ce_bwd_sparse[bf16]": 1, "margin_ce_bwd[bf16]": 1},
}


def bf16_sharded_phase(card: str, tmp: str) -> dict:
    """Phase 32: the class-sharded routes A (bf16 momentum), B and D at a
    bf16 classifier over an NCCL group of one: each first step against the
    single-device route's first step from the same seed and batch on an f32
    backbone: loss 1e-5 relative, the classifier bit for bit, its momentum
    (bf16 on A, B's trace, D's f32) by ``parity.bf16_fresh_state`` or per
    row set to 1e-4 x its max, and the backbone as phase 20's (1e-5
    relative + 2e-5 absolute); then 2 steps each on the bf16 config with the
    partial kernels' launch counts. Returns the launches by kernel form of
    the B run (and A's)."""
    import torch.distributed as dist

    from vlsfr_tpu_torch.ops import margin_stream as tms
    from vlsfr_tpu_torch.parallel import distributed
    from vlsfr_tpu_torch.parallel.mesh import make_mesh
    from vlsfr_tpu_torch.utils import parity

    extra = {"A": ("pool.classifier_mom_dtype=bfloat16",), "B": (), "D": ()}
    if not distributed.initialize("cuda"):
        raise RuntimeError("a process group outlived its phase")
    launches = {}
    try:
        mesh = make_mesh(1, 1)
        if dist.get_backend() != "nccl" or mesh.model != 1:
            raise RuntimeError("the sharded routes must run over an NCCL group of one")
        for route in ("A", "B", "D"):
            trainer, state, step = sharded_softmax_run(tmp, route, mesh, "model.dtype=float32",
                                                       *BF16, *extra[route])
            try:
                w0 = state.classifier.detach().clone()
                if not torch.equal(w0, trainer.state.classifier.detach()):
                    raise RuntimeError("the sharded state's block is not the seeded classifier")
                batch = trainer.pipeline.make_batch(0, 0)
                loss_ref = float(trainer.train_step(trainer.state, batch.images, batch.labels,
                                                    1.0)["loss"])
                loss = float(step(state, batch.images, batch.labels, 1.0)["loss"])
                w_ref, w1 = trainer.state.classifier.detach(), state.classifier.detach()
                m_ref, m1 = trainer.state.classifier_mom, state.classifier_mom
                name = f"route {route} momentum, sharded vs single"
                labels = torch.from_numpy(batch.labels).to(m_ref.device)
                checks = (parity.bf16_fresh_state(name, m1, m_ref, labels)
                          if m_ref.dtype == torch.bfloat16 else
                          parity.by_rows(name, m1, m_ref, m_ref, labels, 1e-4, rounding=2.0))
                same = bool(torch.equal(w1, w_ref))
                worst = backbone_gap(state, trainer)
                print(f"  route {route} first step (f32 backbone, bf16 classifier), sharded "
                      f"against single-device: loss {loss:.6f} / {loss_ref:.6f} (1e-5 "
                      f"relative); classifier bit-equal: {same}; momentum bit-equal: "
                      f"{bool(torch.equal(m1, m_ref))}; backbone max(|diff| - 1e-5 |ref|) "
                      f"{worst:.3e} <= 2e-5")
                report(checks, f"the sharded bf16 route {route}'s first step")
                if not (abs(loss - loss_ref) <= 1e-5 * abs(loss_ref) and same and worst <= 2e-5):
                    raise RuntimeError(f"the sharded bf16 route {route}'s first step disagrees")
            finally:
                free_trainer(trainer)
                del state, step
                gc.collect()
                torch.cuda.empty_cache()
        for route in ("A", "B", "D"):
            trainer, state, step = sharded_softmax_run(tmp, route, mesh, *BF16, *extra[route])
            trainer.state = None
            gc.collect()
            torch.cuda.empty_cache()
            try:
                batches = [trainer.pipeline.make_batch(0, s) for s in range(ROUTE_B_STEPS)]
                tms.reset_launch_counts()
                torch.cuda.reset_peak_memory_stats()
                for bt in batches:
                    t0 = time.perf_counter()
                    loss = float(step(state, bt.images, bt.labels, 1.0)["loss"])
                    torch.cuda.synchronize()
                    step_ms = (time.perf_counter() - t0) * 1e3
                got = dict(tms.LAUNCH_COUNTS)
                peak = torch.cuda.max_memory_allocated()
                want = {k: ROUTE_B_STEPS * BF16_SHARDED_LAUNCHES[route].get(k, 0) for k in got}
                print(f"  sharded bf16 route {route}, {ROUTE_B_STEPS} steps: last loss "
                      f"{loss:.6f}, last step {step_ms:.1f} ms ({card}), peak memory "
                      f"{peak / 2**30:.2f} GiB ({card})")
                print(f"  launches: { {k: v for k, v in got.items() if v} }")
                if got != want or not math.isfinite(loss) or loss <= 0:
                    raise RuntimeError(f"sharded bf16 route {route} must launch {want}: {got}")
                for name in BF16_SHARDED_LAUNCHES[route]:
                    if name.startswith("margin_partial"):
                        launches.setdefault(name, got[name])
            finally:
                free_trainer(trainer)
                del state, step
                gc.collect()
                torch.cuda.empty_cache()
    finally:
        distributed.destroy()
    return launches


# ----------------------------------------------------------------------
# the last two TPU kernels: the 3x3 conv (tools/bench_conv.py) and the
# int8 / bf16 dot probe (tools/probe_int8_mxu.py)
# ----------------------------------------------------------------------

CONV_STRIP = 28  # conv3x3_pallas's default strip; it divides every bench shape's H
CONV_F32_SHAPE = (128, 56, 56, 64)  # the f32 form: the bench's first shape
# ir50's widths outside the bench (x shape, Cout, strip), bf16: the stem (C =
# 3, padded to 8 channels by the wrapper) and C = 256 / 512 at 14² (their
# weight slices streamed; ir50 runs 512 at 7², which no even strip divides,
# in JAX's contract as here)
CONV_IR50 = (((128, 112, 112, 3), 64, 28), ((128, 14, 14, 256), 256, 14),
             ((128, 14, 14, 512), 512, 14))
# source edits of csrc/conv3x3.cu and csrc/dot_probe.cu, each of which the
# checks must reject (vlsfr_tpu_torch/utils/parity.py: conv_checks, probe_checks)
CONV_FAULTS = {
    "reads the bottom halo row one row off": (  # the bf16 kernel's x staging
        "const int hh = gr0 + hr - 1,", "const int hh = gr0 + hr - 1 + (hr == tr + 1),"),
    "drops the last block in the statistics merge": (
        "for (int b = 0; b < n_blocks; ++b)", "for (int b = 0; b < n_blocks - 1; ++b)"),
}
PROBE_FAULTS = {
    "skips the last tile": ("const int n_chunks = (t_hi - t_lo) * chunks_per_tile;",
                            "const int n_chunks = (t_hi - t_lo - (t_hi == NT)) * chunks_per_tile;"),
}


def conv_case(shape, dtype, seed: int, cout: int | None = None):
    """The bench's inputs on the card: x ~ N(0, 1), w ~ 0.045 N(0, 1) (HWIO,
    C -> ``cout``, C by default), in ``dtype``."""
    b, h, w, c = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    wt = (torch.randn((3, 3, c, cout or c), generator=gen, device="cuda") * 0.045).to(dtype)
    return x, wt


def conv_parity(x, w, strip: int = CONV_STRIP) -> dict:
    """Both modes at ``strip``, with and without statistics, against
    conv3x3_plain (``parity.conv_checks``, limits there; raises above one),
    cuDNN's y printed beside. Returns the max |kernel - plain| of y and of
    the statistics."""
    from vlsfr_tpu_torch.ops import conv3x3 as tconv
    from vlsfr_tpu_torch.utils import parity

    y_p, st_p = tconv.conv3x3_plain(x, w, with_stats=True)
    lib = tconv.conv3x3_library(x, w).float()
    out = {"y": 0.0, "stats": 0.0}
    for mode in tconv.MODES:
        y = tconv.conv3x3(x, w, mode=mode, strip=strip)
        ys, st = tconv.conv3x3(x, w, mode=mode, strip=strip, with_stats=True)
        print(f"  {mode}: max |y - cuDNN| {float((y.float() - lib).abs().max()):.3e}, "
              f"max |plain - cuDNN| {float((y_p.float() - lib).abs().max()):.3e}")
        report(parity.conv_checks(y, y_p, tag=mode)
               + parity.conv_checks(ys, y_p, st, st_p, tag=f"{mode}+stats"),
               f"conv3x3 {tuple(x.shape)} {mode}")
        out["y"] = max(out["y"], float((y.float() - y_p.float()).abs().max()),
                       float((ys.float() - y_p.float()).abs().max()))
        out["stats"] = max(out["stats"], *(float((a - b).abs().max())
                                          for a, b in zip(st, st_p)))
    return out


def conv_parity_phase(tmp: str) -> dict:
    """Phase 33: the bench's three bf16 shapes and the f32 form at full
    width against the plain version; the planted faults. Returns the max
    errors by kernel entry."""
    from vlsfr_tpu_torch.ops import conv3x3 as tconv
    from vlsfr_tpu_torch.tools import bench_conv
    from vlsfr_tpu_torch.utils import parity

    procs = start_faulty_builds(tmp, "conv3x3", CONV_FAULTS)
    print(f"  limits: bf16 y within one bf16 spacing (+ {parity.CONV_F32_RTOL:g} x max|y|), at "
          f"most {parity.CONV_BF16_SHARE:g} of the elements apart; f32 y "
          f"{parity.CONV_F32_RTOL:g} x max|y|; the statistics {parity.CONV_STATS_RTOL:g} of "
          "sum |y| and sum y^2 per channel")
    errs = {"conv3x3": 0.0, "conv3x3[stats]": 0.0}
    for shape in bench_conv.SHAPES:
        print(f"  bf16 {shape}, strip {CONV_STRIP}:")
        e = conv_parity(*conv_case(shape, torch.bfloat16, seed=33))
        errs["conv3x3"] = max(errs["conv3x3"], e["y"])
        errs["conv3x3[stats]"] = max(errs["conv3x3[stats]"], e["y"], e["stats"])
        gc.collect()
        torch.cuda.empty_cache()
    for shape, cout, strip in CONV_IR50:
        print(f"  bf16 {shape} -> {cout}, strip {strip}:")
        e = conv_parity(*conv_case(shape, torch.bfloat16, seed=37, cout=cout), strip)
        errs["conv3x3"] = max(errs["conv3x3"], e["y"])
        errs["conv3x3[stats]"] = max(errs["conv3x3[stats]"], e["y"], e["stats"])
        gc.collect()
        torch.cuda.empty_cache()
    print(f"  f32 {CONV_F32_SHAPE}, strip {CONV_STRIP}:")
    errs["conv3x3[f32]"] = conv_parity(*conv_case(CONV_F32_SHAPE, torch.float32, seed=34))["y"]
    print("  planted faults (conv3x3.cu copies built at the start of this phase), at "
          f"bf16 {CONV_F32_SHAPE}:")
    x, w = conv_case(CONV_F32_SHAPE, torch.bfloat16, seed=35)
    y_p, st_p = tconv.conv3x3_plain(x, w, with_stats=True)
    for name, must in (("reads the bottom halo row one row off", "y elements more than one"),
                       ("drops the last block in the statistics merge", "Σ² per channel")):
        with planted("conv3x3", name, procs[name]):
            y, st = tconv.conv3x3(x, w, strip=CONV_STRIP, with_stats=True)
        failed = parity.failures(parity.conv_checks(y, y_p, st, st_p))
        print(f"    {name}: fails " + "; ".join(parity.describe(c) for c in failed))
        if not any(c["name"].startswith(must) for c in failed):
            raise RuntimeError(f"the conv checks pass a conv3x3.cu that {name}")
    return errs


def conv_bound(shape, dtype, with_stats: bool, cout: int | None = None) -> dict:
    """x read and y written once, w read once (+ the statistics), against
    the FLOP at the bf16 tensor-core rate (bf16) or the f32 rate."""
    b, h, w, c = shape
    co = cout or c
    item = 2 if dtype == torch.bfloat16 else 4
    flop = 2.0 * b * h * w * 9 * c * co
    nbytes = item * (b * h * w * (c + co) + 9 * c * co) + (2 * 4 * co if with_stats else 0)
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
    return bound(flop, nbytes, flop / peak * 1e3)


def conv_timing_phase() -> tuple[dict, dict]:
    """Phase 34: ``bench_conv.run`` on the card (bf16, the bench's shapes,
    both modes over the strips dividing H, the statistics at 28 and 56),
    then its f32 form at CONV_F32_SHAPE, each with the launch counters set
    to 0 just before and read just after; the plain version's time and the
    bound per shape. Returns (the kernels line's times, launches)."""
    from vlsfr_tpu_torch.ops import conv3x3 as tconv
    from vlsfr_tpu_torch.tools import bench_conv

    launches, runs = {}, {}
    for dtype, kw in ((torch.bfloat16, {}),
                      (torch.float32, dict(shapes=[CONV_F32_SHAPE], strips=(CONV_STRIP,),
                                           stats_strips=(CONV_STRIP,)))):
        tconv.reset_launch_counts()
        runs[dtype] = bench_conv.run(device="cuda", dtype=dtype, **kw)
        launches.update({k: v for k, v in tconv.LAUNCH_COUNTS.items() if v})
        gc.collect()
        torch.cuda.empty_cache()
    print(f"  launches in the two bench runs: {launches}")
    times = {}
    for dtype, recs in runs.items():
        for shape in dict.fromkeys(tuple(r["shape"]) for r in recs):
            x, w = conv_case(shape, dtype, seed=36)
            plain = cuda_ms(lambda: tconv.conv3x3_plain(x, w), 3, 1)
            plain_st = cuda_ms(lambda: tconv.conv3x3_plain(x, w, with_stats=True), 3, 1)
            del x, w
            for st in (False, True):
                v = conv_bound(shape, dtype, st)
                print(f"  {list(shape)} {str(dtype)[6:]}{' +stats' if st else ''}: bound_ms="
                      f"{v['bound_ms']:.4f} ({v['bound_by']}: {v['flop']:.4e} FLOP, "
                      f"{v['bytes']:.4e} B) plain_ms={plain_st if st else plain:.3f}")
            lib = {r["case"]: r["ms"] for r in recs if tuple(r["shape"]) == shape
                   and r["case"].startswith("library")}
            for r in recs:
                if tuple(r["shape"]) != shape or not r["case"].startswith("conv3x3"):
                    continue
                st = r["case"] == "conv3x3+stats"
                print(f"    {r['case']} {r['mode']} strip={r['strip']}: ms={r['ms']:.3f} "
                      f"({r['tflops']:.1f} TFLOP/s) library_ms="
                      f"{lib['library+stats' if st else 'library']:.3f}")
                if shape == CONV_F32_SHAPE and r["mode"] == "taps9" and r["strip"] == CONV_STRIP:
                    name = tconv.kernel_name(dtype, st)
                    times[name] = dict(ms=r["ms"], plain_ms=plain_st if st else plain,
                                       library_ms=lib["library+stats" if st else "library"],
                                       **conv_bound(shape, dtype, st))
    print("  ir50's other widths (bf16, taps9 and im2col at the strip; not on the kernels line):")
    for shape, cout, strip in CONV_IR50:
        x, w = conv_case(shape, torch.bfloat16, seed=38, cout=cout)
        v = conv_bound(shape, torch.bfloat16, False, cout)
        ms = {mode: cuda_ms(lambda m=mode: tconv.conv3x3(x, w, mode=m, strip=strip), 10)
              for mode in tconv.MODES}
        print(f"    {list(shape)} -> {cout} strip={strip}: ms taps9={ms['taps9']:.3f} im2col="
              f"{ms['im2col']:.3f} ({v['flop'] / ms['taps9'] / 1e9:.1f} TFLOP/s) library_ms="
              f"{cuda_ms(lambda: tconv.conv3x3_library(x, w), 10):.3f} plain_ms="
              f"{cuda_ms(lambda: tconv.conv3x3_plain(x, w), 3, 1):.3f} bound_ms="
              f"{v['bound_ms']:.4f} ({v['bound_by']})")
        del x, w
        gc.collect()
        torch.cuda.empty_cache()
    return times, launches


def probe_bound(kind: str) -> dict:
    from vlsfr_tpu_torch.tools import probe_int8_mxu as tprobe

    b, d, t, nt = tprobe.B, tprobe.D, tprobe.T, tprobe.NT
    ops = 2.0 * b * d * t * nt
    a_item, w_item = (1, 1) if kind == "int8" else (2, 2) if kind == "bf16" else (2, 1)
    nbytes = w_item * nt * t * d + a_item * b * d + 4 * b * t
    return bound(ops, nbytes, ops / (PEAK_INT8_OPS if kind == "int8" else PEAK_BF16_FLOPS) * 1e3)


def probe_phase(tmp: str) -> tuple[dict, dict, dict]:
    """Phase 35: each probe form at the probe's shapes against its plain
    version (int8 bit for bit, and the plain int8 result against the exact
    one; ``parity.probe_checks``); a dot_probe.cu that skips the last tile
    must fail; then ``probe_int8_mxu.run`` with the counters set to 0 just
    before and read just after (its int8 check against the exact result,
    the kernels' and the library calls' times); plain times and bounds.
    Returns (times, max errors, launches) by kernel entry."""
    from vlsfr_tpu_torch.tools import probe_int8_mxu as tprobe
    from vlsfr_tpu_torch.utils import parity

    procs = start_faulty_builds(tmp, "dot_probe", PROBE_FAULTS)
    dev = torch.device("cuda")
    inputs = tprobe.make_inputs(tprobe.B, tprobe.D, tprobe.T, tprobe.NT, seed=35, dev=dev)
    errs, plain_ms = {}, {}
    for kind in tprobe.KINDS:
        a, w = inputs[kind]
        got = tprobe.probe_dot(kind, a, w)
        want = tprobe.probe_dot_plain(kind, a, w)
        checks = parity.probe_checks(kind, got, want, a, w)
        if kind == "int8":
            checks += parity.probe_checks(kind, want, tprobe.exact_int8(a, w), a, w,
                                          tag="plain against exact:")
        report(checks, f"the {kind} probe")
        errs[f"probe_{kind}"] = float((got.double() - want.double()).abs().max())
        plain_ms[kind] = cuda_ms(lambda: tprobe.probe_dot_plain(kind, a, w), 2, 1)
    a, w = inputs["int8"]
    want = tprobe.probe_dot_plain("int8", a, w)
    for name, proc_and_path in procs.items():
        with planted("dot_probe", name, proc_and_path):
            got = tprobe.probe_dot("int8", a, w)
        failed = parity.failures(parity.probe_checks("int8", got, want, a, w))
        print(f"  planted fault ({name}): fails " + "; ".join(map(parity.describe, failed)))
        if not failed:
            raise RuntimeError(f"the probe checks pass a dot_probe.cu that {name}")
    del inputs, a, w, got, want
    gc.collect()
    torch.cuda.empty_cache()
    tprobe.reset_launch_counts()
    recs = tprobe.run(dev)
    launches = {k: v for k, v in tprobe.LAUNCH_COUNTS.items() if v}
    print(f"  probe_int8_mxu.run: int8 equal to the exact int32 sum; launches {launches}")
    times = {}
    for r in recs:
        v = probe_bound(r["kind"])
        times[f"probe_{r['kind']}"] = dict(ms=r["ms"], plain_ms=plain_ms[r["kind"]],
                                           library_ms=r["library_ms"], **v)
        print(f"  {r['kind']}: ms={r['ms']:.4f} ({r['tops']:.1f} TOP/s) bound_ms="
              f"{v['bound_ms']:.4f} ({v['bound_by']}: {v['flop']:.4e} operations, "
              f"{v['bytes']:.4e} B) plain_ms={plain_ms[r['kind']]:.3f} "
              f"library_ms={r['library_ms']:.4f}")
    return times, errs, launches


BF16_KERNELS = (  # the kernels line's bf16 forms: (name, the TPU kernel it replaces)
    ("margin_ce_fwd[bf16]", "margin_pallas.py:390"),
    ("margin_ce_bwd[bf16]", "margin_pallas.py:557"),
    ("margin_ce_bwd_fused_sgd[bf16,bf16]", "margin_pallas.py:803"),
    ("margin_ce_bwd_fused_sgd[bf16,f32]", "margin_pallas.py:803"),
    ("margin_ce_bwd_fused_sgd[f32,bf16]", "margin_pallas.py:803"),
    ("margin_ce_bwd_sparse[bf16]", "margin_pallas.py:1447"),
    ("margin_partial_fwd[bf16]", "margin_pallas.py:991"),
    ("margin_partial_bwd[bf16]", "margin_pallas.py:1036"))


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
    from vlsfr_tpu_torch.utils.parity import f32_cos_checks
    n = 1 << 18
    print(f"  the f32 clean cosines of both tilings over the first {n:,} slots (limit 0 apart; "
          "the forward's within 1e-5 of the plain product):")
    report(f32_cos_checks(full[1][0], full[0][0, :n], f"first {n:,} slots: "),
           "the f32 clean cosines of the tilings")

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
    print("  the f32 cosines as the forward and the backward form them:")
    from vlsfr_tpu_torch.utils.parity import margin_cos_checks
    report(margin_cos_checks(full[0], full[1]), "the f32 cosines of the tilings")
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
        gc.collect()
        torch.cuda.empty_cache()

        ftimes, ferrs, flaunches = forms_phases(card, tmp)
        times.update(ftimes)
        errs.update(ferrs)
        launches.update(flaunches)
        gc.collect()
        torch.cuda.empty_cache()

        ttimes, terrs = twin_kernel_phases()
        times.update(ttimes)
        errs.update(terrs)
        print("== phase 28: the twin slice (ir50 f32 probe and gallery, batch 128, the 2^20 f32 "
              "queue, then its bf16 copy): directional_loss(use_fused=True) and "
              "make_sharded_twin_loss against quad_add_margin and twin_add_margin")
        launches.update(twin_slice_phase(card, tmp))
        gc.collect()
        torch.cuda.empty_cache()

        print("== phase 29: the bf16 classifier's margin_ce forms at full width (B = 128, D = "
              "512, C = 2^20, Arc; limits in vlsfr_tpu_torch/utils/parity.py)")
        berrs, sparse_case = bf16_parity_phase(tmp)
        errs.update(berrs)
        print("== phase 30: the bf16 forms' timing (full width)")
        times.update(bf16_timing_phase(sparse_case))
        del sparse_case
        gc.collect()
        torch.cuda.empty_cache()
        print("== phase 31: softmax_1m_bf16 (ir50, batch 128, bf16 compute, 2^20 bf16 classes, "
              "bf16 momentum, fused SGD) through the Trainer; routes A at the other dtype pairs, "
              "B and D at a bf16 classifier")
        launches.update(bf16_train_phase(card, tmp))
        print("== phase 32: the class-sharded routes A, B and D at a bf16 classifier over an "
              "NCCL group of one")
        launches.update(bf16_sharded_phase(card, tmp))

        print("== phase 33: conv3x3 at full width (the bench's bf16 shapes and ir50's stem, C = "
              f"256 and 512 at 14², both modes, with and without statistics; f32 at "
              f"{CONV_F32_SHAPE}) against the plain version")
        errs.update(conv_parity_phase(tmp))
        print("== phase 34: conv3x3 timing through vlsfr_tpu_torch.tools.bench_conv")
        ctimes, claunches = conv_timing_phase()
        times.update(ctimes)
        launches.update(claunches)
        gc.collect()
        torch.cuda.empty_cache()
        print("== phase 35: the int8 / bf16 dot probe through vlsfr_tpu_torch.tools.probe_int8_mxu "
              "(B, D, T, NT = 128, 512, 1024, 512)")
        ptimes, perrs, plaunches = probe_phase(tmp)
        times.update(ptimes)
        errs.update(perrs)
        launches.update(plaunches)

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
             errs["margin_partial_bwd"]),
            *((f"{name}[{form}]", "quad_margin", replaces, errs[f"{name}[{form}]"])
              for form in FORMS for name, replaces in (
                  ("quad_fwd", "twin_margin.py:1840"), ("quad_bwd", "twin_margin.py:1891"),
                  ("quad_partial_fwd", "twin_margin.py:1676"),
                  ("quad_partial_bwd", "twin_margin.py:1748"))),
            *((name if form == "f32" else f"{name}[{form}]", "quad_margin", replaces,
               errs[name if form == "f32" else f"{name}[{form}]"])
              for form in TWIN_FORMS for name, replaces in (
                  ("twin_fwd", "twin_margin.py:786"), ("twin_bwd", "twin_margin.py:910"),
                  ("twin_partial_fwd", "twin_margin.py:984"),
                  ("twin_partial_bwd", "twin_margin.py:1042"))),
            *((name, "margin_ce", replaces, errs[name]) for name, replaces in BF16_KERNELS),
            *((name, "conv3x3", "conv_pallas.py:94", errs[name])
              for name in ("conv3x3", "conv3x3[stats]", "conv3x3[f32]")),
            *((f"probe_{kind}", "dot_probe", "tools/probe_int8_mxu.py:73", errs[f"probe_{kind}"])
              for kind in ("int8", "bf16", "i8st_bf16dot"))):
        t = times[name]
        if launches.get(name, 0) < 1:
            raise RuntimeError(f"{name} was not launched on its path")
        kernels.append({"name": name, "route": "cuda",
                        "source": f"vlsfr_tpu_torch/csrc/{src}.cu",
                        "replaces": replaces if replaces.startswith("tools/")
                        else f"vlsfr_tpu/ops/{replaces}",
                        "launches": launches[name], "max_abs_err": err, "ms": t["ms"],
                        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                        "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    if len(kernels) != 44:
        raise RuntimeError(f"the kernels line must list 44 entries, has {len(kernels)}")
    print(smi_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
