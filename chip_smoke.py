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
   report; then the SASS of ``conv3x3`` and ``dot_probe``, whose kernels
   take ``wgmma``'s A from registers, read by
   ``vlsfr_tpu_torch/tools/wgmma_sass_check.py``: no A register or
   accumulator of a product may be written before the wait that retires
   its group;
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
   the forward and the backward also with the step's write columns and
   labels set to -1 (what the written columns and the targets cost; the
   partial and form forwards of phases 16, 22 and 23 as well);
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
   against torch._int_mm: the forward's and the backward's s8 mma.sync);
   the bf16 and int8 forms' clean cosines (tensor cores,
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
   (the three tilings bit for bit, within 1e-6 of the plain version), the
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
   cores: ``mma.sync`` where the weight slice stays resident and for the
   stem (C < 8, x read at its own C), ``wgmma`` where it streams (C = 256,
   512); f32 on the FMA units) at tools/bench_conv.py's
   bf16 shapes [128, 56, 56, 64], [128, 112, 112, 64], [128, 28, 28, 128],
   both modes at strip 28, with and without the statistics epilogue, ir50's
   stem [128, 112, 112, 3] -> 64 (strip 28) and C = 256 -> 256 and 512 ->
   512 at [128, 14, 14] (strip 14), and the f32 form at [128, 56, 56, 64],
   each case printing the kernel it ran, against ``conv3x3_plain``
   (``parity.conv_checks``: bf16 y within one bf16 spacing plus the f32
   limit, at most 2e-3 of the elements apart; f32 y 2e-5 × max|y|; Σ and
   Σ² 1e-5 of Σ|y| and Σy² per channel), cuDNN's distance printed beside;
   copies of conv3x3.cu that read the resident kernel's bottom halo row
   one row off and that drop the last block of the statistics merge (at
   bf16 [128, 56, 56, 64]), whose streamed kernel drops its last channel
   chunk (at C = 256), whose f32 kernel reads one tap one pixel off and
   whose stem kernel reads one tap one pixel off (at the stem) must fail;
34. conv timing — ``vlsfr_tpu_torch.tools.bench_conv.run`` (both modes over
   the strips dividing H, the statistics at 28 and 56, cuDNN and cuDNN +
   two f32 reductions as the library), then its f32 form, each with the
   counters set to 0 before and read after; the plain version's time and
   the bound per shape (bytes at 3.35 TB/s against the FLOP at 989 TFLOP/s
   bf16 or 67 f32); the kernels line takes [128, 56, 56, 64], taps9, strip
   28; then ir50's stem and C = 256 / 512 shapes (the kernel each ran,
   both modes, with statistics, cuDNN, plain, bound);
35. the probe — ``vlsfr_tpu_torch.tools.probe_int8_mxu`` at B, D, T, NT =
   128, 512, 1024, 512: each form (``csrc/dot_probe.cu``: a resident, w
   through a TMA ring, ``wgmma``) against its plain version (int8 bit for
   bit, the plain int8 against the exact sum; bf16 forms 1e-5 × Σ|a·w|),
   copies that skip the last tile (int8) and that widen i8st's int8 with
   the sign bit flipped must fail, then the tool's ``run`` (its exact int8
   check, kernel and library times) with the counters set to 0 before and
   read after; plain times and bounds (int8 at 1,979 TOP/s, bf16 at 989,
   against the bytes of w);
The backbones, checkpoints and serving (no TPU kernel: stock convs, BN,
matmul and top-k, as XLA ran them in JAX):
36. backbones — one FFC training step (the second of two) of ``r50``
   (224², bf16, batch 64, the CLI's default 1000-slot dense head) and of
   ``mobile`` (112², batch 128) through ``Trainer``: a finite loss, step
   time and peak memory; then an f32 forward of each net (eval mode, TF32
   off) on 4 images on the card against the CPU with the same weights,
   embeddings within 1e-4 (f32 sums in other orders over the net's depth);
37. checkpoint and resume — ``configs/ffc_ir50_1m_ids.json`` (ir50, bf16,
   65,536-slot dense head, batch 256) on a 2,560-record synthetic store,
   under ``torch.use_deterministic_algorithms(True)`` (cuBLAS's workspace
   ``:4096:8``, set at the start): 3 steps straight; 2 steps, ``_save``,
   a fresh ``Trainer`` resuming (every tensor and value of the state bit
   for bit against the saved one) and 1 more step, bit for bit against the
   straight run; the checkpoint's size and its save and restore times; one
   in-training eval at the config's eval_records 2048 / eval_pairs 2000;
38. serving — ``Embedder`` on ir50 bf16 at batch 128 with flip TTA
   (images/s); ``FaceIndex.from_arrays`` over a 10,485,760-row int8
   gallery made on the card from a seeded generator, Q = 1024, k = 10,
   tile 65,536, in bf16 and in int8 compute (probes/s): 1,024 noisy copies
   of known rows must come back at rank 1; the top-10 of an index over the
   first 2^20 rows against one dense product plus ``torch.topk`` (scores
   within 1e-5; a row may differ only where the dense scores tie within
   1e-5), and the script's whole time;
The shipped configs' batch (the kernels above 128 rows: row groups in
batch order, no float atomics):
39. the FFC head at b = 512 rows per direction (R = 1024), D = 512, k =
   10, Arc, a DCP write plan of 512 writes per direction with a duplicate
   slot: the quad kernels in their int8c (10,485,760 slots), f32 (2^20),
   bf16 (4,194,304) and int8 (10,485,760) forms and the twin (f32, bf16;
   2^20) against their plain versions with phases 21 and 25's limits
   (the int8c dot and the tilings' cosines over the first 65,536 slots),
   each kernel timed beside its plain version, yardstick and bound, each
   backward run twice and compared bit for bit; every form at b = 200 (not
   a multiple of 64) over 2^18 slots; the int8c partial kernels as 4
   emulated blocks of 2,621,440 (mesh.model = 4's shard of the 10M queue)
   merged against quad_fwd / quad_bwd, and timed over one block; then
   ``configs/ffc_10m_ids.json`` through ``Trainer`` at mesh.model = 1 and
   batch 256 (its one-card batch, PERF.md §5): 3 steps, a finite loss,
   each int8c kernel launched once a step, step time and peak memory;
40. the softmax head at B = 512, D = 512: the f32 margin_ce forward,
   backward, fused SGD and sparse backward over 5,000,000 classes against
   their plain versions (phases 7 and 11's limits; the three tilings'
   cosines bit for bit over the first 2^18 classes), timed (the yardsticks
   per 2^20-column chunk), the backward and the fused update (d_emb, W and
   mom) run twice and compared bit for bit; the bf16 forms in the three
   (w, mom) pairs at 2^20 classes and route D's sparse backward on a bf16
   classifier (phase 29's limits), each bf16 form timed as in phase 30;
   every form at B = 200 over 2^18 classes; the partial kernels as 4 blocks of 1,250,000
   merged against the whole classifier, and timed over one block; then
   ``configs/partial_fc_ir50_5m_ids.json`` through ``Trainer`` at
   mesh.model = 1 and its batch of 512 (route A): 3 steps, a finite loss,
   the forward and the fused kernel launched once a step, step time and
   peak memory;
int8 conv inference (``vlsfr_tpu_torch/ops/quant.py``; no kernel: an
im2col through ``torch._int_mm``, as JAX ran these convs through XLA):
41. every distinct ungrouped conv shape of ir50 and of mobile (bf16, 112²)
    at batch 128: the int path's int32 product against its f64 plain
    version (``int_conv_plain``) bit for bit; the wrapper
    ``int8_conv2d`` itself (its chunks, dequantisation and a seeded bias)
    against ``f32(plain product) · (sx · sw) + bias`` in bf16 bit for bit;
    the card's xq, sx, wq and sw against the CPU port's from the same
    tensor (8 images) bit for bit; the int path (quantise, im2col,
    ``_int_mm``, dequantise) timed beside cuDNN's bf16 ``F.conv2d``, with
    its peak memory, and traced (torch.profiler: device busy time against
    wall time a call, the four aten ops that take the most of it); then
    ``Embedder(int8=True)`` against the bf16 ``Embedder`` (ir50 bf16,
    batch 128, flip, phase 38's net and images) in turns, images/s and
    the int8-against-bf16 cosine over 256 images (a reading), and on an
    f32 ir50 with the same weights the card's int8 embeddings of 4 images
    against the CPU port's (cosine ≥ 0.999 each); then
    ``configs/ffc_ir50_1m_ids.json`` through ``Trainer`` 3 steps straight
    and with ``pool.gallery_int8``: a finite loss, 53 int8 convs a step
    (``quant.LAUNCH_COUNTS``; the stem, 2 in each of 24 blocks, 4
    shortcuts, on the one 512-image gallery forward), none straight, step
    time and peak memory of both, the first batch's gallery embeddings'
    cosine int8 against float (a reading);
the dense heads on the model axis (``parallel/sharded_dense.py``; no
kernel: dense torch per block and the group's collectives, as XLA ran
them in JAX), over an NCCL group of one:
42. the dense FFC head (the reference's 1000-slot queue), route C
    (100,000 classes, below the streaming threshold) and route E (2^20
    classes, ``sample_rate`` 0.1, with and without ``sparse_update``): each
    first step on an f32 backbone over the mesh against the single-device
    head's from the same seed and batch (phase 17's limits; the queue after
    the write bit-equal, the classifier per row set as phase 20's); the
    head on the first batch from 4 emulated blocks (``block_stats``,
    ``merge_stats``, ``finalize``, ``block_grad`` on one card) against the
    single-device head at full width (losses 1e-5 relative, d_emb and d_w
    1e-4 x their max, train_acc equal); then on the bf16 config one
    untimed and two timed warm steps of the single-device step and of the
    step over the mesh, each with its peak memory, and their ratio, and
    one more step of each under the profiler;
the data axis of the FFC step (``mesh.data`` > 1; no kernel: the quad
kernels above on the gathered batch, ``core/ffc.py``), ranks spawned as
processes on this one card over a gloo group on CUDA tensors, each running
the port's ``Trainer`` on ``configs/ffc_ir50_1m_ids.json`` with
``pool.use_fused=on`` (ir50, 512-d, 65,536 slots, the quad kernels):
43. (a) ``mesh = 2 x 1`` at the config's global batch of 256 and (b) ``2 x
    2`` at 128 (four f32 processes at 256 do not fit beside each other),
    the sharded quad head and the sharded dense head: each first step on
    an f32 backbone against the same config at ``mesh.data = 1`` in this
    process (loss 1e-5 and grad_norm 1e-4 relative; each parameter and BN
    statistics tensor within 1e-5 relative + 2e-5 + 4x the data-1 step's
    own move when its images move by one f32 spacing, measured here, and
    for (a) the data-1 step against a second run of itself; the queue 1e-5
    and bit-equal on every unwritten row), the data replicas bit-equal on
    metrics, parameters and queue, each kernel launched once (the partial
    ones at 2 x 2), the peak device memory of each process; (c) one warm
    bf16 step of (a) over gloo and of its data-1 twin in this process, and
    the gradient sum alone, with the card's name and power limit (the
    ranks' collectives go through host memory: no measure of NCCL);
the data axis of the softmax head (no kernel: the margin_ce kernels above
on the gathered batch, ``train/softmax_head.py``), ranks spawned on this
card over gloo as in phase 43, each running the port's ``Trainer`` on the
softmax slice config (ir50, 512-d, 2^20 f32 classes, global batch 128):
44. (a) ``mesh = 2 x 1`` on routes A, B, D (``SPARSE_RATE``) and E
    (``SAMPLE_RATE``, sparse rows) and (b) ``2 x 2`` on routes A and D (D
    at rate 1.0: every tile, so the step is the single-device one whatever
    the model index's draws), each first step on an f32 backbone against
    the same config at ``mesh.data = 1`` in this process by phase 43's
    rule, applied to every backbone tensor and to the classifier and its
    momentum (the rank's block of them), the last-visit steps equal; the
    data replicas bit-equal on metrics, backbone and blocks; the route's
    margin_ce kernels launched (the partial forward at 2 x 2 on route A);
    each process's peak device memory; (c) one warm bf16 step of (a)'s
    route A over gloo and of its data-1 twin in this process;
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
import os
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
    print_override_share("quad_fwd", ttm.quad_fwd, E, queue, rest, kw)
    print_override_share("quad_bwd", ttm.quad_bwd, E, queue, rest, kw,
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


def busy_ms(spans) -> float:
    """The union of the profiler's device intervals (µs), in ms:
    overlapping streams count once."""
    busy_us, end = 0.0, -math.inf
    for s, t in sorted(spans):
        if t > end:
            busy_us += t - max(s, end)
            end = t
    return busy_us / 1e3


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
    busy = busy_ms(spans)
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


def softmax_case(c: int, loss_type: str, k: int, frac_outlier: float, seed: int,
                 b: int = SOFTMAX["b"]):
    """Unit embeddings [b, 512] (the slice's 128 rows unless given), a
    0.01·N(0, 1) classifier and momentum [c, 512], labels with one class
    twice (rows 0 and 1) and optionally outlier rows; d_ce = 1/B on
    labelled rows, d_neg = 1/B on outliers."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    d = SOFTMAX["d"]
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
    print(f"  case B={b} C={c} {loss_type} k={k}: {int(pos.sum())}/{b} labelled rows, class "
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
    for check in parity.fwd_out_checks(got, want, rounded=False):
        require(check["name"], [check])
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

    # above 2^20 classes the yardsticks run per 2^20-column chunk: [B, C]
    # f32 intermediates at 5,000,000 classes would not fit beside W and mom
    chunk = 1 << 20
    d_cos = torch.randn((b, min(c, chunk)), device=emb.device).mul_(1e-4)
    w_s, mom_s = w.clone(), mom.clone()

    def library_fwd():  # yardsticks only: the port never calls these
        for lo in range(0, c, chunk):
            cos = emb @ F.normalize(w[lo:lo + chunk], dim=1).T
            torch.logsumexp(kw["scale"] * cos, dim=1)
            torch.topk(cos, k, dim=1)

    def library_bwd(lo=0):  # the kernel's work: the cosine recompute, then both products
        wn = F.normalize(w[lo:lo + chunk], dim=1)
        dc = d_cos[:, :wn.shape[0]]
        torch.matmul(emb, wn.T)
        torch.matmul(dc, wn)
        return torch.matmul(dc.T, emb)

    def library_bwd_all():
        for lo in range(0, c, chunk):
            library_bwd(lo)

    def library_fused():
        for lo in range(0, c, chunk):
            ws, ms = w_s[lo:lo + chunk], mom_s[lo:lo + chunk]
            g = library_bwd(lo).add_(ws, alpha=SGD["weight_decay"])
            ms.mul_(SGD["momentum"]).add_(g)
            ws.sub_(g.add_(ms, alpha=SGD["momentum"]), alpha=LR)

    out["margin_ce_fwd"]["library_ms"] = cuda_ms(library_fwd, 5, 1)

    out["margin_ce_bwd"]["library_ms"] = cuda_ms(library_bwd_all, 5, 1)
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


def check_sparse(c: int, loss_type: str, k: int, frac_outlier: float, seed: int,
                 b: int = SOFTMAX["b"]):
    """The forward with statistics and the sparse backward against their
    plain versions on one case (``parity.sparse_path_checks``); raises
    above a limit. Returns the case, the tiles and the max errors."""
    from vlsfr_tpu_torch.ops import margin_stream as tms
    from vlsfr_tpu_torch.utils import parity

    emb, w, mom, labels, d_ce, d_neg, kw = softmax_case(c, loss_type, k, frac_outlier, seed, b)
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


def shard_case(q: int, loss_type: str, seed: int, form: str = "f32", b: int = SLICE["b"]):
    """``raw_case`` with its slots moved by slot -> slot·SLOT_MULT mod q (a
    permutation: duplicates, written labels and pool hits keep their
    structure) so that the targets spread over the SHARDS blocks; asserts
    that every block owns targets and that some row's target and write lie
    in different blocks. Returns quad_shard_checks's inputs and the loss
    arguments."""
    d, k = SLICE["d"], SLICE["k"]
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
        print_override_share("quad_partial_fwd", ttm.quad_partial_fwd, args[0], args[1],
                             (*args[2:], gt), pkw)
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
                       seed: int, b: int = SOFTMAX["b"]):
    """``parity.margin_shard_checks`` on one softmax case cut into
    ``n_shards`` blocks; raises above a limit. Returns the case with the
    merged (gt, logz, topk), and the max errors of the partial kernels."""
    from vlsfr_tpu_torch.parallel._shard_common import localize_labels
    from vlsfr_tpu_torch.utils import parity

    emb, w, mom, labels, d_ce, d_neg, kw = softmax_case(c, loss_type, k, frac_outlier, seed, b)
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


def margin_partial_timing(case, blocks=(SOFTMAX["c"], SHIPPED_CLASSES // CLASS_SHARDS)) -> dict:
    """Both partial margin_ce kernels over a 2^20 block (world 1 at the
    slice's width) and a 1,250,000 block (one card's block of the shipped
    5M config), or the ``blocks`` given: kernel, plain version, a cuBLAS
    composition (a yardstick the port never calls) and the bound. Returns
    {(name, columns): times}."""
    import torch.nn.functional as F

    from vlsfr_tpu_torch.ops import margin_stream as tms
    from vlsfr_tpu_torch.parallel._shard_common import localize_labels

    emb, w, _, labels, d_ce, d_neg, kw, gt, logz, topk = case
    b, d = emb.shape
    k = kw["k"]
    kth = topk[:, -1].contiguous()
    d_ce_m, d_neg_m = tms._mask_cotangents(labels >= 0, d_ce, d_neg)
    out = {}
    for cols in blocks:
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

    trainer = softmax_trainer(tmp, *SHARDED_ROUTES.get(route, ()), *overrides)
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


def sharded_softmax_first_step(tmp: str, route: str, mesh, *overrides: str) -> None:
    """The sharded route's first step against the single-device route's
    first step from the same seed and batch, on an f32 backbone (phase 17's
    reason): loss 1e-5 relative, the classifier per row set (1e-4 x
    max|w' - w| + 2 f32 eps x max|w'|, as phase 9), backbone parameters and
    BN statistics 1e-5 relative + 2e-5 absolute."""
    from vlsfr_tpu_torch.utils import parity

    trainer, state, step = sharded_softmax_run(tmp, route, mesh, "model.dtype=float32",
                                               *overrides)
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
          f"parts: at most {parity.STRADDLE_ROWS} rows in each 256 beyond {parity.DEMB_TIGHT:g} "
          f"x its max "
          f"and none beyond {parity.ROUNDED_DEMB_RTOL:g} x its max (both sides round each "
          "d_cos to bf16 before its product with a row; where the kernel's f32 d_cos and the "
          "plain version's straddle a bf16 boundary one term moves by up to 2^-8 of itself, "
          "which moves one row; a kernel that skips a rounding moves every row); the "
          "int8-compute dot bit for bit (limit 0): the kernels' own clean cosines with unit "
          "scales against torch._int_mm, with the real scales against the plain version; "
          "the bf16 and int8 clean cosines of the backward's tiling equal the forward's bit "
          "for bit (limit 0: the backward's top-k test meets the forward's kth) and lie within "
          f"{parity.BF16_COS_ATOL:g} of the plain version's (exact products in another order)")


def form_parity(form: str, q: int, loss_type: str, seed: int, b: int = SLICE["b"]):
    """``parity.quad_checks`` on one case of the form at FORM_TILE (and,
    over the first 65,536 slots, for int8c the int8 dot,
    ``parity.int8_dot_checks``, for bf16 and int8 the clean cosines of both
    tilings, ``parity.bf16_cos_checks`` / ``int8_cos_checks``); raises
    above a limit. Returns the case,
    the plain forward's outputs and the max errors of the forward and the
    backward."""
    from vlsfr_tpu_torch.ops import twin_margin as ttm
    from vlsfr_tpu_torch.utils import parity

    case = make_case(q, b, SLICE["d"], SLICE["k"], loss_type, seed, form)
    print(f"  rounding tile: {FORM_TILE} requested, "
          f"{ttm.round_tile(q, b, SLICE['d'], FORM_TILE, case[0].element_size())} "
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
    print_override_share(f"quad_fwd[{form}]", ttm.quad_fwd, E, queue, rest, kw)
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
    print_override_share(f"quad_partial_fwd[{form}]", ttm.quad_partial_fwd, args[0], args[1],
                         (*args[2:], gt), pkw)
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


def twin_case(q: int, loss_type: str, seed: int, form: str, b: int = SLICE["b"]):
    """One direction of ``raw_case`` (its DCP write plan, a duplicate
    slot) with labels at written slots and 25 % outliers, as
    tools/bench_sharded_twin.py:45-50 builds them; the in-pool probes near
    their written rows (0.9 cosine on average), so that the target term
    carries weight in logz (random probes leave it ~e^-15 of the sum).
    Returns (queue, the twin kernels' inputs, kw, dce, dneg) and the raw
    (emb, g, plan, labels)."""
    from vlsfr_tpu_torch.ops import twin_margin as ttm

    d = SLICE["d"]
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

    queue, b = case[0], case[1][0].shape[0]
    rt = ttm.round_tile(queue.shape[1], b, SLICE["d"], tile, queue.element_size())
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
    print_override_share(name("twin_fwd"), ttm.twin_fwd, E, queue, rest, kw)
    print_override_share(name("twin_bwd"), ttm.twin_bwd, E, queue, rest,
                         dict(kw, tile=TWIN_TILE), (logz, kth, dce, dneg))
    return out


def print_override_share(name: str, fn, E, queue, rest, kw, tail=()) -> None:
    """A quad or twin kernel ``fn`` with and without every write and target
    (write columns and labels −1; ``tail``: the backward's row vectors),
    timed in turns: the time the written tiles' override path adds. The
    port's DCP planner hands out consecutive slots, so a step's writes sit
    in a few tiles of one block."""
    G, V, rows, cols, blend, labels, gt = rest
    bare = (G, V, rows, torch.full_like(cols, -1), blend, torch.full_like(labels, -1), gt)
    with_ms, bare_ms = [], []
    for _ in range(2):
        with_ms.append(cuda_ms(lambda: fn(E, queue, *rest, *tail, **kw), 5))
        bare_ms.append(cuda_ms(lambda: fn(E, queue, *bare, *tail, **kw), 5))
    local = cols[cols >= 0]
    where = f"{int(local.min())}-{int(local.max())}" if local.numel() else "none"
    print(f"  {name} without the step's writes and targets: {sum(bare_ms) / 2:.3f} ms (with them "
          f"{sum(with_ms) / 2:.3f}, timed in turns; the written slots here: {where})")


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
        print_override_share(name("twin_partial_fwd"), ttm.twin_partial_fwd, si.E, q_l[0],
                             (*args[2:], gt), kw)
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
        ("? dcos_of(acc[mi][ni][2 * h + j], p0 + c + j,",
         "? dcos_of(acc[mi][ni][2 * h + j] * inv[c + j], p0 + c + j,")),
    "takes <d_w_hat, w_hat> against the rounded w_hat": (
        "s = fmaf(dwh[mi][j][2 * h], wf.x * iv, s);\n"
        "          s = fmaf(dwh[mi][j][2 * h + 1], wf.y * iv, s);",
        "s = fmaf(dwh[mi][j][2 * h], __bfloat162float(__float2bfloat16_rn(wf.x * iv)), s);\n"
        "          s = fmaf(dwh[mi][j][2 * h + 1], __bfloat162float(__float2bfloat16_rn(wf.y * iv)), "
        "s);"),
    "rounds new_w twice": (
        "store2(w_upd + off, make_float2(wf.x - sgd.lr * upd.x, wf.y - sgd.lr * upd.y));",
        "store2(w_upd + off, make_float2(wf.x + __bfloat162float(__float2bfloat16_rn(-sgd.lr * "
        "upd.x)), wf.y + __bfloat162float(__float2bfloat16_rn(-sgd.lr * upd.y))));"),
}


def bf16_case(c: int, loss_type: str, k: int, frac_outlier: float, seed: int,
              pair: str = "bf16,bf16", b: int = SOFTMAX["b"]):
    """``softmax_case`` with the classifier and momentum stored in the
    pair's dtypes (the f32 draw cast, as JAX casts its init)."""
    emb, w, mom, labels, d_ce, d_neg, kw = softmax_case(c, loss_type, k, frac_outlier, seed, b)
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
    fwd = parity.fwd_out_checks(got, want, rounded)
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



def bf16_timing_phase(sparse_case, b: int = SOFTMAX["b"]) -> dict:
    """Phase 30: each bf16 form at full width: kernel, plain version, a
    PyTorch composition on the tensor cores (bf16 matmuls, f32 accumulate;
    the port never calls it) and the bound: bytes at 3.35 TB/s against the
    dots at 989 TFLOP/s (bf16), or at the f32 rate for the f32 classifier
    beside a bf16 momentum."""
    import torch.nn.functional as F

    from vlsfr_tpu_torch.ops import margin_stream as tms
    from vlsfr_tpu_torch.parallel._shard_common import localize_labels

    out = {}
    emb, w, mom, labels, d_ce, d_neg, kw = bf16_case(SOFTMAX["c"], "Arc", 1, 0.0, 13, b=b)
    d = emb.shape[1]
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
# 3, the stem kernel, x read at its own C) and C = 256 / 512 at 14² (their
# weight slices streamed; ir50 runs 512 at 7², which no even strip divides,
# in JAX's contract as here)
CONV_IR50 = (((128, 112, 112, 3), 64, 28), ((128, 14, 14, 256), 256, 14),
             ((128, 14, 14, 512), 512, 14))
# source edits of csrc/conv3x3.cu and csrc/dot_probe.cu, each of which the
# checks must reject (vlsfr_tpu_torch/utils/parity.py: conv_checks, probe_checks)
CONV_FAULTS = {
    "reads the bottom halo row one row off": (  # the resident bf16 kernel's x staging
        "const int hh = gr0 + hr - 1,", "const int hh = gr0 + hr - 1 + (hr == tr + 1),"),
    "drops the last block in the statistics merge": (
        "hi = min(n_blocks, lo + r);", "hi = min(n_blocks - 1, lo + r);"),
    "drops the streamed kernel's last channel chunk": (  # its products skip the chunk
        "if (st > 0 && c0 + 16 * cb >= C) continue;",
        "if ((st > 0 && c0 + 16 * cb >= C) || i == n_ch - 1) continue;"),
    "reads the f32 kernel's tap 5 one pixel off": (
        "const int toff = (tap / 3) * WP + tap % 3;",
        "const int toff = (tap / 3) * WP + tap % 3 + (tap == 5);"),
    "reads the stem kernel's tap 5 one pixel off": (  # its K table
        "const int dy = tap / 3 - 1, dx = tap % 3 - 1;",
        "const int dy = tap / 3 - 1, dx = tap % 3 - 1 + (tap == 5);"),
}
# each conv fault's case (x shape, dtype, Cout, strip) and a check it must fail
CONV_FAULT_CASES = {
    "reads the bottom halo row one row off": (
        CONV_F32_SHAPE, torch.bfloat16, 64, CONV_STRIP, "y elements more than one"),
    "drops the last block in the statistics merge": (
        CONV_F32_SHAPE, torch.bfloat16, 64, CONV_STRIP, "Σ² per channel"),
    "drops the streamed kernel's last channel chunk": (
        CONV_IR50[1][0], torch.bfloat16, CONV_IR50[1][1], CONV_IR50[1][2],
        "y elements more than one"),
    "reads the f32 kernel's tap 5 one pixel off": (
        CONV_F32_SHAPE, torch.float32, 64, CONV_STRIP, "y"),
    "reads the stem kernel's tap 5 one pixel off": (
        CONV_IR50[0][0], torch.bfloat16, CONV_IR50[0][1], CONV_IR50[0][2],
        "y elements more than one"),
}
PROBE_FAULTS = {
    "skips the last tile": (  # the last split's chunk count, its producer's and consumers'
        "const int n = (int)(n_q * (s + 1) / splits - q_lo);",
        "const int n = (int)(n_q * (s + 1) / splits - q_lo - (s == splits - 1 ? kpc : 0));"),
    "widens i8st's int8 with the sign bit flipped": (
        "for (int q = 0; q < 4; ++q) widen4(v[q], lo[q], hi[q]);",
        "for (int q = 0; q < 4; ++q) widen4(v[q] ^ 0x80808080u, lo[q], hi[q]);"),
}
PROBE_FAULT_KINDS = {"skips the last tile": "int8",
                     "widens i8st's int8 with the sign bit flipped": "i8st_bf16dot"}


def conv_case(shape, dtype, seed: int, cout: int | None = None):
    """The bench's inputs on the card: x ~ N(0, 1), w ~ 0.045 N(0, 1) (HWIO,
    C -> ``cout``, C by default), in ``dtype``."""
    b, h, w, c = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    wt = (torch.randn((3, 3, c, cout or c), generator=gen, device="cuda") * 0.045).to(dtype)
    return x, wt


def conv_kind(x, w, strip: int) -> str:
    """The conv3x3.cu kernel ``conv3x3`` launches for (x, w) (``KINDS``)."""
    from vlsfr_tpu_torch.ops import conv3x3 as tconv

    b, h, wd, c = x.shape
    return tconv.conv_geometry(x.dtype == torch.bfloat16, b, h, wd,
                               tconv.kernel_channels(x.dtype, c), w.shape[-1], strip).kind


def conv_parity(x, w, strip: int = CONV_STRIP) -> dict:
    """Both modes at ``strip``, with and without statistics, against
    conv3x3_plain (``parity.conv_checks``, limits there; raises above one),
    cuDNN's y printed beside. Returns the max |kernel - plain| of y and of
    the statistics."""
    from vlsfr_tpu_torch.ops import conv3x3 as tconv
    from vlsfr_tpu_torch.utils import parity

    y_p, st_p = tconv.conv3x3_plain(x, w, with_stats=True)
    lib = tconv.conv3x3_library(x, w).float()
    print(f"  kernel: {conv_kind(x, w, strip)}")
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
    print("  planted faults (conv3x3.cu copies built at the start of this phase):")
    for name, (shape, dtype, cout, strip, must) in CONV_FAULT_CASES.items():
        x, w = conv_case(shape, dtype, seed=35, cout=cout)
        y_p, st_p = tconv.conv3x3_plain(x, w, with_stats=True)
        with planted("conv3x3", name, procs[name]):
            y, st = tconv.conv3x3(x, w, strip=strip, with_stats=True)
        failed = parity.failures(parity.conv_checks(y, y_p, st, st_p))
        print(f"    {name} ({str(dtype)[6:]} {shape} -> {cout}, {conv_kind(x, w, strip)}): fails "
              + "; ".join(parity.describe(c) for c in failed))
        if not any(c["name"].startswith(must) for c in failed):
            raise RuntimeError(f"the conv checks pass a conv3x3.cu that {name}")
        del x, w, y, st, y_p, st_p
        gc.collect()
        torch.cuda.empty_cache()
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
        ms_st = cuda_ms(lambda: tconv.conv3x3(x, w, strip=strip, with_stats=True), 10)
        print(f"    {list(shape)} -> {cout} strip={strip} ({conv_kind(x, w, strip)}): ms "
              f"taps9={ms['taps9']:.4f} +stats={ms_st:.4f} im2col="
              f"{ms['im2col']:.4f} ({v['flop'] / ms['taps9'] / 1e9:.1f} TFLOP/s) library_ms="
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
    for name, proc_and_path in procs.items():
        kind = PROBE_FAULT_KINDS[name]
        a, w = inputs[kind]
        want = tprobe.probe_dot_plain(kind, a, w)
        with planted("dot_probe", name, proc_and_path):
            got = tprobe.probe_dot(kind, a, w)
        failed = parity.failures(parity.probe_checks(kind, got, want, a, w))
        print(f"  planted fault ({name}, {kind}): fails "
              + "; ".join(map(parity.describe, failed)))
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


# ----------------------------------------------------------------------
# phases 36-38: the backbones, checkpoint and resume, serving (no kernel:
# stock convs, BN, matmul and top-k, as XLA ran them in JAX)
# ----------------------------------------------------------------------

BACKBONES = (("r50", 64), ("mobile", 128))  # (net, batch): the CLI's default, the light net
BACKBONE_STEPS = 2  # the first warms up; the step time is the second's window
FWD_F32_LIMIT = 1e-4  # card vs CPU f32 embeddings: sum-order noise over 50 layers
CKPT_CONFIG = "configs/ffc_ir50_1m_ids.json"
CKPT_STORE = (256, 10)  # ids x images: 2,560 records, so 2,304 are held out (eval_records 2048)
SERVE_ROWS = 10_485_760  # the 10M-identity gallery, int8 rows + f32 scales
SERVE_Q, SERVE_K, SERVE_TILE = 1024, 10, 65536
DENSE_ROWS = 1 << 20  # the rows the dense product + torch.topk reference covers
SCORE_LIMIT = 1e-5  # index vs dense scores: f32 sums of the same bf16 products, other orders


def calibrate_bn(model, x: torch.Tensor):
    """Set every BatchNorm's running statistics to those of the batch ``x``
    (one train-mode forward at momentum 0), then eval mode: a random net's
    eval-mode forward at the initial statistics (0, 1) grows its
    activations block by block, ir50's to overflow."""
    from vlsfr_tpu_torch.models.layers import BatchNorm

    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    kept = [m.momentum for m in bns]
    for m in bns:
        m.momentum = 0.0
    model.train()
    with torch.no_grad():
        model(x)
    for m, k in zip(bns, kept):
        m.momentum = k
    return model.eval()


def backbone_phase(card: str) -> None:
    """Phase 36: one FFC training step of r50 (224², bf16, batch 64, the
    CLI's default 1000-slot dense head) and of mobile (112², batch 128)
    through ``Trainer`` (the second of two steps timed), then an f32
    forward of each net on 4 images, eval mode, on the card and on the CPU
    with the same weights (TF32 off)."""
    from vlsfr_tpu_torch.config import Config
    from vlsfr_tpu_torch.models import create_net, native_image_size
    from vlsfr_tpu_torch.train.trainer import Trainer

    for net, batch in BACKBONES:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            cfg = Config().apply_overrides([
                f"model.net_type={net}", "model.feat_dim=512", "model.dtype=bfloat16",
                f"data.batch_size={batch}", "data.image_size=0", "pool.queue_size=1000",
                "data.synthetic_ids=100", "data.synthetic_images_per_id=3",
                "data.num_workers=4", "train.print_freq=1", "optim.lr=0.1"])
            cfg.data.synthetic = True
            cfg.train.saved_dir = tmp
            torch.cuda.reset_peak_memory_stats()
            trainer = Trainer(cfg)
            try:
                t0 = time.perf_counter()
                out = trainer.train(max_steps=BACKBONE_STEPS)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                peak = torch.cuda.max_memory_allocated()
            finally:
                trainer.close()
        if not (math.isfinite(out["loss"]) and out["final_step"] == BACKBONE_STEPS):
            raise RuntimeError(f"{net}: training did not give a finite loss: {out}")
        size = native_image_size(net)
        step_ms = 2 * batch / out["images_per_sec"] * 1e3
        print(f"  {net} ({size}², bf16, batch {batch}, 1000-slot dense FFC head): loss "
              f"{out['loss']:.4f}; step {step_ms:.1f} ms ({card}); {BACKBONE_STEPS} steps "
              f"{wall:.2f} s wall incl. the first; peak memory {peak / 2**30:.2f} GiB ({card})")
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(1)
            model = create_net(net, feat_dim=512)
        x = torch.from_numpy(np.random.default_rng(2).standard_normal(
            (12, size, size, 3)).astype(np.float32))
        calibrate_bn(model, x[4:])  # statistics from 8 other images
        x = x[:4]
        with torch.no_grad():
            want = model(x)
            got = model.cuda()(x.cuda()).cpu()
        err = float((got - want).abs().max())
        print(f"  {net} f32 forward, 4 images, eval mode, card vs CPU: max |Δemb| {err:.3e} "
              f"(limit {FWD_F32_LIMIT:g}: f32 sums in other orders over the net's depth)")
        if not (got.shape == (4, 512) and torch.isfinite(got).all() and err <= FWD_F32_LIMIT):
            raise RuntimeError(f"{net}: the card's f32 embeddings disagree with the CPU's")
        del model
        gc.collect()
        torch.cuda.empty_cache()


def host_state(trainer) -> dict:
    """The trainer's whole checkpoint state (``_checkpoint_state``), copied
    to the host, by key."""
    out = {}

    def walk(x, key):
        if isinstance(x, dict):
            for k, v in x.items():
                walk(v, f"{key}/{k}")
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                walk(v, f"{key}/{i}")
        elif isinstance(x, torch.Tensor):
            out[key] = x.detach().cpu().clone()
        else:
            out[key] = x
    walk(trainer._checkpoint_state(), "")
    return out


def same_state(a: dict, b: dict, what: str) -> None:
    """Every tensor and value of two host states bit for bit, or raise
    naming the keys that differ."""
    diff = sorted(set(a) ^ set(b))
    for k in sorted(set(a) & set(b)):
        x, y = a[k], b[k]
        if isinstance(x, torch.Tensor):
            if x.dtype != y.dtype or x.shape != y.shape or not torch.equal(x, y):
                d = (x.float() - y.float()).abs().max() if x.shape == y.shape else "shape"
                diff.append(f"{k} (max |Δ| {d})")
        elif x != y:
            diff.append(f"{k} ({x} vs {y})")
    n = sum(v.numel() for v in a.values() if isinstance(v, torch.Tensor))
    if diff:
        raise RuntimeError(f"{what}: {len(diff)} entries differ: {diff[:8]}")
    print(f"  {what}: {len(a)} entries, {n:,} tensor elements, bit for bit")


def checkpoint_phase(card: str) -> None:
    """Phase 37: configs/ffc_ir50_1m_ids.json (ir50, bf16, 65,536-slot
    dense FFC head, batch 256) on a synthetic store, under
    ``torch.use_deterministic_algorithms(True)``: 3 steps straight; 2
    steps, ``_save``, a fresh Trainer resuming (the round trip bit for bit)
    and 1 more step, against the straight run bit for bit; the checkpoint's
    size, save and restore times; one in-training eval at the config's
    eval_records / eval_pairs."""
    from vlsfr_tpu_torch.config import Config
    from vlsfr_tpu_torch.data.synthetic import generate_synthetic_store
    from vlsfr_tpu_torch.train.trainer import Trainer

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        store = os.path.join(tmp, "store")
        generate_synthetic_store(store, num_ids=CKPT_STORE[0], images_per_id=CKPT_STORE[1],
                                 image_size=112, seed=0)

        def trainer(run: str):
            cfg = Config.load(CKPT_CONFIG)
            cfg.data.sources = [store]
            cfg.train.saved_dir = os.path.join(tmp, run)
            return Trainer(cfg)

        torch.use_deterministic_algorithms(True)
        try:
            t = trainer("straight")
            try:
                print(f"  {CKPT_CONFIG}: {len(t.reader):,} records, record_limit "
                      f"{t.record_limit} (holdout_records {t.cfg.train.holdout_records}), "
                      f"{t.steps_per_epoch} step(s) an epoch, batch {t.cfg.data.batch_size}, "
                      f"queue {t.cfg.pool.queue_size:,} (dense head)")
                out = t.train(max_steps=3)
                straight = host_state(t)
            finally:
                t.close()
            t = trainer("resumed")
            try:
                t.train(max_steps=2)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                t._save(2)
                save_s = time.perf_counter() - t0
                saved = host_state(t)
            finally:
                t.close()
            step_dir = os.path.join(tmp, "resumed", "2")
            size = sum(os.path.getsize(os.path.join(step_dir, f)) for f in os.listdir(step_dir))
            gc.collect()
            torch.cuda.empty_cache()
            t = trainer("resumed")
            try:
                if t.state.step != 2:
                    raise RuntimeError(f"the fresh Trainer did not resume at step 2: "
                                       f"{t.state.step}")
                same_state(saved, host_state(t), "save -> restore round trip")
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                t._load_checkpoint_state(*t.ckpt.restore(2, map_location="cpu"))
                torch.cuda.synchronize()
                restore_s = time.perf_counter() - t0
                print(f"  checkpoint at step 2: {size / 2**20:.1f} MiB in "
                      f"{len(os.listdir(step_dir))} files; save {save_s:.2f} s, restore "
                      f"{restore_s:.2f} s (read to the host and copied onto the card, warm "
                      f"file cache) ({card})")
                res = t.train(max_steps=3)
                if not (math.isfinite(out["loss"]) and res["loss"] == out["loss"]):
                    raise RuntimeError(f"the resumed step's loss {res['loss']} is not the "
                                       f"straight run's {out['loss']}")
                same_state(straight, host_state(t),
                           "2 steps + resume + 1 step vs 3 straight steps (deterministic)")
                t0 = time.perf_counter()
                ev = t.evaluate()
                ev_s = time.perf_counter() - t0
            finally:
                t.close()
        finally:
            torch.use_deterministic_algorithms(False)
        acc = ev.get("verification_acc_holdout", float("nan"))
        print(f"  in-training eval (eval_records {t.cfg.train.eval_records}, eval_pairs "
              f"{t.cfg.train.eval_pairs}, the EMA gallery net): {json.dumps(ev)}; "
              f"{ev_s:.2f} s ({card})")
        if not (0.0 <= acc <= 1.0):
            raise RuntimeError(f"the in-training eval gave no holdout accuracy: {ev}")


def make_gallery(rows: int, d: int, gen: torch.Generator):
    """int8 rows uniform in [-127, 127] and f32 scales making each row a
    unit vector (scale · row), drawn on the card 2^20 rows at a time."""
    gallery = torch.empty((rows, d), dtype=torch.int8, device="cuda")
    scales = torch.empty(rows, device="cuda")
    for lo in range(0, rows, 1 << 20):
        hi = min(rows, lo + (1 << 20))
        g = torch.randint(-127, 128, (hi - lo, d), generator=gen, device="cuda",
                          dtype=torch.int8)
        gallery[lo:hi] = g
        scales[lo:hi] = 1.0 / torch.linalg.vector_norm(g.float(), dim=1)
    return gallery, scales


def noisy_copies(gallery, scales, src, gen, sigma: float = 0.02) -> np.ndarray:
    """Queries: the rows ``src`` dequantised plus N(0, sigma²) noise."""
    q = gallery[src].float() * scales[src, None]
    q = q + sigma * torch.randn(q.shape, generator=gen, device="cuda")
    return q.cpu().numpy()


def serving_phase(card: str) -> None:
    """Phase 38: ``Embedder`` on ir50 bf16 at batch 128 with flip TTA; a
    ``FaceIndex.from_arrays`` over a 10,485,760-row int8 gallery made on the
    card (Q = 1024, k = 10, tile 65,536) in bf16 and in int8 compute, whose
    queries are noisy copies of known rows and must find them at rank 1;
    then the top-10 of an index over the first 2^20 rows against one dense
    product plus ``torch.topk``."""
    from vlsfr_tpu_torch.eval.extract import Embedder
    from vlsfr_tpu_torch.eval.index import FaceIndex
    from vlsfr_tpu_torch.models import create_net

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(3)
        net = create_net("ir50", feat_dim=512, dtype="bfloat16")
    images = np.random.default_rng(4).standard_normal((1024, 112, 112, 3), dtype=np.float32)
    calibrate_bn(net.cuda(), torch.from_numpy(images[:128]).cuda())
    emb = Embedder(net, batch_size=128, flip_average=True)
    emb(images[:256])  # warm-up
    t0 = time.perf_counter()
    e = emb(images)
    wall = time.perf_counter() - t0
    norms = np.linalg.norm(e, axis=1)
    if not (e.shape == (1024, 512) and np.isfinite(e).all() and np.abs(norms - 1).max() < 1e-5):
        raise RuntimeError(f"Embedder gave bad embeddings: shape {e.shape}, finite "
                           f"{np.isfinite(e).mean():.3f}, max |norm - 1| "
                           f"{np.nanmax(np.abs(norms - 1)):.3e}")
    print(f"  Embedder, ir50 bf16, batch 128, flip TTA: {1024 / wall:.1f} images/s over 1,024 "
          f"images from host memory ({wall * 1e3:.1f} ms; {card})")
    del emb, net
    gc.collect()
    torch.cuda.empty_cache()

    gen = torch.Generator(device="cuda").manual_seed(20)
    t0 = time.perf_counter()
    gallery, scales = make_gallery(SERVE_ROWS, 512, gen)
    labels = np.arange(SERVE_ROWS, dtype=np.int64)
    src = torch.randint(0, SERVE_ROWS, (SERVE_Q,), generator=gen, device="cuda")
    queries = noisy_copies(gallery, scales, src, gen)
    torch.cuda.synchronize()
    print(f"  gallery {SERVE_ROWS:,} x 512 int8 + f32 scales made on the card in "
          f"{time.perf_counter() - t0:.2f} s")
    for cd in (torch.bfloat16, torch.int8):
        index = FaceIndex.from_arrays(gallery, labels, scales, tile=SERVE_TILE, compute_dtype=cd)
        index.search(queries[:64], SERVE_K)  # warm-up
        t0 = time.perf_counter()
        v, r, lab = index.search(queries, SERVE_K)
        wall = time.perf_counter() - t0
        hits = int((r[:, 0] == src.cpu().numpy()).sum())
        print(f"  FaceIndex {str(cd).split('.')[-1]} compute, {SERVE_ROWS:,} int8 rows "
              f"({index.nbytes() / 2**30:.2f} GiB), Q = {SERVE_Q}, k = {SERVE_K}, tile "
              f"{SERVE_TILE:,}: {SERVE_Q / wall:.1f} probes/s ({wall * 1e3:.1f} ms a search; "
              f"{card}); {hits}/{SERVE_Q} noisy copies at rank 1, top-1 score "
              f"{float(np.median(v[:, 0])):.4f} median")
        if hits != SERVE_Q or not (lab[:, 0] == r[:, 0]).all():
            raise RuntimeError(f"{hits}/{SERVE_Q} noisy copies came back at rank 1")
        del index
        gc.collect()

    n = DENSE_ROWS
    half = SERVE_Q // 2
    src2 = torch.randint(0, n, (half,), generator=gen, device="cuda")
    q2 = np.concatenate([noisy_copies(gallery, scales, src2, gen),
                         torch.randn((SERVE_Q - half, 512), generator=gen,
                                     device="cuda").cpu().numpy()])
    index = FaceIndex.from_arrays(gallery[:n], labels[:n], scales[:n], tile=SERVE_TILE,
                                  compute_dtype=torch.bfloat16)
    v, r, _ = index.search(q2, SERVE_K)
    qn = q2 / np.maximum(np.linalg.norm(q2, axis=-1, keepdims=True), 1e-12)
    w = gallery[:n].to(torch.bfloat16) * scales[:n, None].to(torch.bfloat16)
    z = torch.mm(torch.from_numpy(qn).cuda().to(torch.bfloat16), w.t(), out_dtype=torch.float32)
    dv, di = torch.topk(z, SERVE_K, dim=1)
    at = z.gather(1, torch.from_numpy(r).cuda()).cpu().numpy()
    dv, di = dv.cpu().numpy(), di.cpu().numpy()
    swapped = int((r != di).sum())
    verr = float(np.abs(v - dv).max())
    terr = float(np.abs(at - dv).max())
    print(f"  top-{SERVE_K} over the first {n:,} rows against one dense product + torch.topk "
          f"(Q = {SERVE_Q}: {half} noisy copies, {SERVE_Q - half} random): max |Δscore| "
          f"{verr:.2e}; {swapped} entries at another row, whose dense scores are within "
          f"{terr:.2e} of the dense top-k's (limit {SCORE_LIMIT:g}: f32 sums in other orders)")
    if verr > SCORE_LIMIT or terr > SCORE_LIMIT:
        raise RuntimeError("the streamed top-k disagrees with the dense product's")
    del gallery, scales, index, w, z
    gc.collect()
    torch.cuda.empty_cache()


# ----------------------------------------------------------------------
# the shipped batch: the quad / twin and margin_ce kernels above 128 rows
# (phases 39-40)
# ----------------------------------------------------------------------

SHIPPED_B = 512  # data.batch_size of configs/ffc_10m_ids.json and partial_fc_ir50_5m_ids.json
RAGGED_B, RAGGED_Q = 200, 1 << 18  # a batch that is not a multiple of 64, and its queue
FFC_CONFIG, FFC_CONFIG_B = "configs/ffc_10m_ids.json", 256  # its one-card batch (PERF.md §5)
SOFTMAX_CONFIG = "configs/partial_fc_ir50_5m_ids.json"  # at its own batch of 512
SHIPPED_Q = {"int8c": 10 << 20, "f32": 1 << 20, "bf16": 4 << 20, "int8": 10 << 20}
SHIPPED_STEPS = 3


def same_bits(what: str, first, second) -> None:
    """Two runs' outputs equal bit for bit (the kernels merge in a fixed
    order, no float atomics); raises otherwise."""
    for i, (x, y) in enumerate(zip(first, second)):
        if not torch.equal(x, y):
            raise RuntimeError(f"{what}: output {i} differs between two runs "
                               f"({int((x != y).sum())} elements)")
    print(f"  {what}: two runs equal bit for bit")


def quad_shipped_parity(form: str, q: int, b: int, seed: int, timed: bool) -> None:
    """One quad form at b rows per direction against its plain version
    (``form_parity``'s checks, phase 21's limits; f32: phase 3's), and with
    ``timed`` each kernel's time beside its plain version, yardstick and
    bound, and the backward run twice, bit for bit."""
    from vlsfr_tpu_torch.ops import twin_margin as ttm
    from vlsfr_tpu_torch.utils import parity

    if form == "f32":
        case = make_case(q, b, SLICE["d"], SLICE["k"], "Arc", seed)
        checks, want = parity.quad_checks(*case)
        n = min(q, 1 << 16)
        checks += parity.f32_cos_checks(case[1][0], case[0][0, :n], f"first {n:,} slots: ")
        report(checks, f"the f32 quad kernels at b = {b}")
    else:
        case, want, _ = form_parity(form, q, "Arc", seed, b)
    if timed:
        queue, packed, kw, dce, dneg = case
        E, rest = packed[0], packed[1:]
        logz, kth = want[2], want[3][:, :, -1].contiguous()
        tile = dict(tile=FORM_TILE) if form != "f32" else {}
        bwd = lambda: ttm.quad_bwd(E, queue, *rest, logz, kth, dce, dneg, **kw, **tile)  # noqa: E731
        same_bits(f"{ttm.kernel_name('quad_bwd', form)} at b = {b}", bwd(), bwd())
        if form == "f32":
            timing(queue, packed, kw, dce, dneg, want)
        else:
            form_timing(form, case, want)
    del case, want
    gc.collect()
    torch.cuda.empty_cache()


def twin_shipped_parity(form: str, q: int, b: int, seed: int, timed: bool) -> None:
    """The twin kernels at b rows against their plain versions (phase 25's
    limits); with ``timed`` their times and the backward twice, bit for
    bit."""
    from vlsfr_tpu_torch.ops import twin_margin as ttm

    case, _ = twin_case(q, "Arc", seed, form, b)
    want, _ = twin_parity(case)
    if timed:
        queue, inputs, kw, dce, dneg = case
        logz, kth = want[2], want[3][:, :, -1].contiguous()
        bwd = lambda: ttm.twin_bwd(inputs[0], queue, *inputs[1:], logz, kth, dce, dneg,  # noqa: E731
                                   **kw, tile=TWIN_TILE)
        name = "twin_bwd" if form == "f32" else f"twin_bwd[{form}]"
        same_bits(f"{name} at b = {b}", bwd(), bwd())
        twin_timing(form, case, want)
    del case, want
    gc.collect()
    torch.cuda.empty_cache()


def shipped_trainer(config: str, tmp: str, *overrides: str):
    """A shipped config through the Trainer on one card (``mesh.model=1``,
    no eval, no held-out records) over a synthetic store of 1,600 images."""
    from vlsfr_tpu_torch.config import Config
    from vlsfr_tpu_torch.train.trainer import Trainer

    cfg = Config.load(config).apply_overrides([
        "mesh.model=1", "mesh.data=1", "train.eval_freq=0", "train.holdout_records=0",
        "train.print_freq=1",
        "data.synthetic_ids=200", "data.synthetic_images_per_id=8", "data.num_workers=4",
        *overrides])
    cfg.data.synthetic = True
    cfg.train.saved_dir = tmp
    return Trainer(cfg)


def shipped_train(config: str, tmp: str, card: str, counts, want: set, *overrides: str) -> None:
    """SHIPPED_STEPS steps of ``config`` through the Trainer: finite loss,
    the wanted kernels launched once a step and nothing else of the
    family (``counts``: its module's LAUNCH_COUNTS); prints the step time
    and the peak device memory."""
    torch.cuda.reset_peak_memory_stats()
    trainer = shipped_trainer(config, tmp, *overrides)
    try:
        b, trainer_is_ffc = trainer.cfg.data.batch_size, trainer.is_ffc
        print(f"  {config} at batch {b}: {trainer.steps_per_epoch} steps an epoch")
        for key in counts:
            counts[key] = 0
        t0 = time.perf_counter()
        out = trainer.train(max_steps=SHIPPED_STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(counts)
        peak = torch.cuda.max_memory_allocated()
    finally:
        trainer.close()
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
    print(f"  {SHIPPED_STEPS} steps: {json.dumps(out)}")
    print(f"  launches: { {k: v for k, v in launches.items() if v} }")
    if not only_launched(launches, {k: SHIPPED_STEPS for k in want}):
        raise RuntimeError(f"each of {sorted(want)} must launch once a step: {launches}")
    if not (math.isfinite(out["loss"]) and out["final_step"] == SHIPPED_STEPS):
        raise RuntimeError(f"{config} did not train {SHIPPED_STEPS} finite steps: {out}")
    images = 2 * b if trainer_is_ffc else b  # the FFC step embeds a pair of batches
    print(f"  step time {images / out['images_per_sec'] * 1e3:.1f} ms (last window, {card}); "
          f"{SHIPPED_STEPS} steps {wall:.2f} s wall incl. first-step warm-up; peak memory "
          f"{peak / 2**30:.2f} GiB ({card})")


def bf16_sparse_case(b: int, seed: int):
    """Route D's forward statistics and sparse backward on a bf16
    classifier of 2^20 classes at B = b against their plain versions
    (``parity.sparse_path_checks``, phase 29's limits); returns the case
    ``bf16_timing_phase`` times."""
    from vlsfr_tpu_torch.ops import margin_stream as tms
    from vlsfr_tpu_torch.utils import parity

    emb, w, _, labels, d_ce, d_neg, kw = bf16_case(SOFTMAX["c"], "Arc", 1, 0.0, seed, b=b)
    tile, n_tiles = tms.sparse_bwd_geometry(b, emb.shape[1], w.shape[0])
    m = tms.sparse_m_tiles(SPARSE_RATE, n_tiles, b)
    u = torch.rand((n_tiles,), generator=torch.Generator(device=emb.device).manual_seed(seed),
                   device=emb.device)
    checks, tile_idx, (gt, logz, topk) = parity.sparse_path_checks(emb, w, labels, d_ce, d_neg,
                                                                    kw, tile, m, u)
    print(f"    tile {tile}, {m} of {n_tiles} tiles")
    report(checks, "the bf16 forward statistics / sparse backward")
    return emb, w, labels, d_ce, d_neg, kw, tile, tile_idx, gt, logz, topk


def ffc_shipped_phase(card: str, tmp: str) -> None:
    """Phase 39: the quad / twin kernels at the 10M-identity config's batch
    (b = 512 rows per direction, R = 1024): every form against its plain
    version at full width (int8c and int8 at 10,485,760 slots, bf16 at
    4,194,304, f32 at 2^20; the twin f32 and bf16 at 2^20), timed, each
    backward twice bit for bit; every form at b = 200 over 2^18 slots; the
    int8c partial kernels as 4 emulated blocks of 2,621,440 (mesh.model =
    4's shard of the 10M queue), and timed over one; then
    configs/ffc_10m_ids.json through the Trainer at mesh.model = 1, batch
    256."""
    from vlsfr_tpu_torch.ops import twin_margin as ttm

    for i, form in enumerate(("int8c", "f32", "bf16", "int8")):
        print(f"  the {form} form at b = {SHIPPED_B}, Q = {SHIPPED_Q[form]:,}:")
        quad_shipped_parity(form, SHIPPED_Q[form], SHIPPED_B, 40 + i, timed=True)
    for i, form in enumerate(TWIN_FORMS):
        print(f"  the {form} twin at b = {SHIPPED_B}, Q = {TWIN_Q:,}:")
        twin_shipped_parity(form, TWIN_Q, SHIPPED_B, 44 + i, timed=True)
    for i, form in enumerate(("f32", *FORMS)):
        print(f"  the {form} form at b = {RAGGED_B}, Q = {RAGGED_Q:,}:")
        quad_shipped_parity(form, RAGGED_Q, RAGGED_B, 46 + i, timed=False)
    for i, form in enumerate(TWIN_FORMS):
        print(f"  the {form} twin at b = {RAGGED_B}, Q = {RAGGED_Q:,}:")
        twin_shipped_parity(form, RAGGED_Q, RAGGED_B, 50 + i, timed=False)
    q = SHIPPED_Q["int8c"]
    print(f"  the int8c partial kernels at b = {SHIPPED_B}: the queue as {SHARDS} blocks of "
          f"{q // SHARDS:,}")
    case, kw = shard_case(q, "Arc", 52, "int8c", SHIPPED_B)
    shard_parity(case, kw, SHARDS, tile=FORM_TILE)
    form_partial_timing("int8c", case, kw)
    del case
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  {FFC_CONFIG} through the Trainer (mesh.model=1, data.batch_size={FFC_CONFIG_B}):")
    shipped_train(FFC_CONFIG, os.path.join(tmp, "ffc10m"), card, ttm.LAUNCH_COUNTS,
                  {"quad_fwd[int8c]", "quad_bwd[int8c]"}, f"data.batch_size={FFC_CONFIG_B}")


def softmax_shipped_phase(card: str, tmp: str) -> None:
    """Phase 40: the margin_ce kernels at the 5M-class config's batch (B =
    512): the f32 forward, backward, fused SGD and sparse backward over
    5,000,000 classes against their plain versions (phases 7 / 11's
    limits; the cosines of the three tilings bit for bit over the first
    2^18 classes), timed, the fused update's W and mom twice bit for bit;
    the bf16 forms at 2^20 classes (phase 29's limits); every form at B =
    200 over 2^18 classes; the partial kernels as 4 blocks of 1,250,000
    and timed over one; then configs/partial_fc_ir50_5m_ids.json through
    the Trainer at mesh.model = 1, its batch of 512 (route A)."""
    from vlsfr_tpu_torch.ops import margin_stream as tms
    from vlsfr_tpu_torch.utils.parity import margin_cos_checks

    b, c = SHIPPED_B, SHIPPED_CLASSES
    full = softmax_case(c, "Arc", 1, 0.0, 60, b)
    n = 1 << 18
    print(f"  the f32 cosines of the three tilings over the first {n:,} classes:")
    report(margin_cos_checks(full[0], full[1][:n].contiguous()), "the f32 cosines of the tilings")
    gt, logz, topk, _ = check_softmax(*full, verbose=True)
    emb, w, mom, labels, d_ce, d_neg, kw = full
    start = (w.cpu(), mom.cpu())  # 20 GB at 5M classes: the runs' copies wait on the host
    runs = []
    for _ in range(2):
        w.copy_(start[0])
        mom.copy_(start[1])
        d_emb = tms.margin_ce_bwd_fused_sgd(emb, w, mom, labels, gt, logz, topk, d_ce, d_neg, LR,
                                            **SGD, **kw)[0]
        runs.append((d_emb.cpu(), w.cpu(), mom.cpu()))
    same_bits("margin_ce_bwd_fused_sgd (d_emb, W, mom) at B = 512", *runs)
    del runs, start
    same_bits("margin_ce_bwd (d_emb, d_w) at B = 512",
              *(tms.margin_ce_bwd(emb, w, labels, gt, logz, topk, d_ce, d_neg, **kw)
                for _ in range(2)))
    softmax_timing(*full, gt, logz, topk)
    del full, emb, w, mom, gt, logz, topk
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  the sparse backward at B = {b}, C = {c:,}:")
    sparse = check_sparse(c, "Arc", 1, 0.0, 61, b)[0]
    sparse_timing(*sparse)
    del sparse
    gc.collect()
    torch.cuda.empty_cache()
    for pair in FUSED_PAIRS:
        print(f"  the bf16 forms ({pair}) at B = {b}, C = {SOFTMAX['c']:,}:")
        bf16_softmax_checks(bf16_case(SOFTMAX["c"], "Arc", 1, 0.0, 62, pair, b), pair)
        gc.collect()
        torch.cuda.empty_cache()
    print(f"  the bf16 sparse backward at B = {b}, C = {SOFTMAX['c']:,}, and every bf16 form "
          "timed:")
    bf16_timing_phase(bf16_sparse_case(b, 67), b)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  every form at B = {RAGGED_B}, C = {RAGGED_Q:,}:")
    check_softmax(*softmax_case(RAGGED_Q, "Arc", 3, 0.3, 63, RAGGED_B))
    check_sparse(RAGGED_Q, "Arc", 3, 0.3, 64, RAGGED_B)
    for pair in FUSED_PAIRS:
        bf16_softmax_checks(bf16_case(RAGGED_Q, "Arc", 3, 0.3, 65, pair, RAGGED_B), pair)
    print(f"  the partial kernels at B = {b}: {c:,} classes as {CLASS_SHARDS} blocks of "
          f"{c // CLASS_SHARDS:,}:")
    full = class_shard_parity(c, "Arc", 1, 0.0, CLASS_SHARDS, 66, b)[0]
    margin_partial_timing(full, (c // CLASS_SHARDS,))
    del full
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  {SOFTMAX_CONFIG} through the Trainer (mesh.model=1, its batch of {b}; route A):")
    shipped_train(SOFTMAX_CONFIG, os.path.join(tmp, "softmax5m"), card, tms.LAUNCH_COUNTS,
                  {"margin_ce_fwd", "margin_ce_bwd_fused_sgd"})


# ----------------------------------------------------------------------
# phase 41: int8 conv inference (ops/quant.py; no kernel: im2col and
# torch._int_mm, cuBLASLt's int8 product, as JAX ran it through XLA)
# ----------------------------------------------------------------------

INT8_NETS = ("ir50", "mobile")  # every distinct ungrouped conv of each, bf16, 112²
INT8_BATCH = 128
INT8_CHECK_IMAGES = 8  # the card's quantised operands against the CPU's, on this many
INT8_SERVE_IMAGES = 1024
INT8_COS_IMAGES = 256  # int8 against bf16 embeddings: a reading
INT8_CPU_IMAGES, INT8_CPU_COS = 4, 0.999  # f32 ir50, card int8 against CPU int8, per image
IR50_INT8_CONVS = 53  # the stem, 2 in each of 24 blocks, 4 shortcut 1x1s
INT8_STEPS = 3


def int8_conv_shapes(net) -> dict:
    """Every distinct ungrouped conv of ``net`` (bf16, on the card) at its
    input shape: {(C, H, W, O, k, stride, pad): the first such Conv}."""
    from vlsfr_tpu_torch.models.layers import Conv
    from vlsfr_tpu_torch.ops import quant

    shapes, hooks = {}, []

    def record(m, inputs):
        _, c, h, w = inputs[0].shape
        shapes.setdefault((c, h, w, m.out_channels, m.kernel_size[0], m.stride[0],
                           m.padding[0]), m)

    for m in net.modules():
        if isinstance(m, Conv) and quant.eligible(m):
            hooks.append(m.register_forward_pre_hook(record))
    with torch.no_grad():
        net.eval()(torch.zeros((2, 112, 112, 3), device="cuda"))
    for h in hooks:
        h.remove()
    return shapes


def int8_trace(fn, reps: int = 3):
    """``fn`` traced (torch.profiler) over ``reps`` warm calls: (wall ms a
    call under the profiler, device busy ms a call, the union of kernel and
    copy intervals, and the four aten ops whose own kernels take the most
    device time, as (op, ms a call, calls a call))."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # a trace has come back once with no device event at all, and the same
    # shape's did not in the next run: the window is traced again, and only
    # three empty traces in a row fail
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        if spans:
            break
    if not spans:
        raise RuntimeError("the profiler recorded no device activity in the int path, three "
                           "times")
    ops = []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        us = ev.self_cuda_time_total if us is None else us
        if ev.key.startswith("aten::") and us > 0:
            ops.append((ev.key[6:], us / 1e3 / reps, ev.count / reps))
    return wall / reps, busy_ms(spans) / reps, sorted(ops, key=lambda o: -o[1])[:4]


def int8_conv_checks(name: str, shapes: dict, card: str) -> None:
    """Each shape at batch INT8_BATCH on a seeded bf16 input, as the main
    path feeds it: the int path's int32 product against its f64 plain
    version bit for bit; the wrapper ``int8_conv2d`` itself (its chunks,
    dequantisation and bias) against ``f32(plain product) · (sx · sw) +
    bias`` in bf16 bit for bit; the card's xq, sx, wq and sw against the
    CPU's from the same tensor (INT8_CHECK_IMAGES images) bit for bit; the
    wrapper timed beside cuDNN's bf16 ``F.conv2d``, with its peak memory
    above its input, then traced: the device's busy time a call against
    the wall time, and the aten ops that take the most of it."""
    import torch.nn.functional as F

    from vlsfr_tpu_torch.ops import quant

    gen = torch.Generator(device="cuda").manual_seed(41)
    print(f"  {name}: {len(shapes)} distinct ungrouped conv shapes at batch {INT8_BATCH} "
          f"(C, H, W -> O, k, stride, pad)")
    for (c, h, w, o, k, stride, pad), m in shapes.items():
        shape = (c, h, w, o, k, stride, pad)
        x = torch.randn((INT8_BATCH, c, h, w), generator=gen, device="cuda").to(torch.bfloat16)
        bias = torch.randn((o,), generator=gen, device="cuda")
        wt = m.weight.detach()
        d, sx, wq, sw = quant.conv_scales(x, wt)
        xq = quant.quantize_input(x, d)
        got = quant.int_conv(xq, wq, stride, pad)
        want = quant.int_conv_plain(xq, wq, stride, pad)
        if not torch.equal(got, want):
            raise RuntimeError(f"{name} conv {shape}: the int path's product differs from the "
                               f"f64 plain version's at {int((got != want).sum())} of "
                               f"{got.numel()} elements")
        del got, xq
        chunks = len(quant._Geometry(x.shape, wt.shape, stride, pad).chunks(INT8_BATCH))
        want = (want.float() * (sx * sw)[None, :, None, None]
                + bias[None, :, None, None]).to(torch.bfloat16)
        got = quant.int8_conv2d(x, wt, bias, stride, pad, torch.bfloat16)
        if not (got.dtype == torch.bfloat16 and torch.equal(got, want)):
            raise RuntimeError(f"{name} conv {shape}: int8_conv2d ({chunks} chunks) differs "
                               f"from its formula over the plain product")
        del got, want
        xs = x[:INT8_CHECK_IMAGES]
        card_ops = quant.conv_scales(xs, wt)
        cpu_ops = quant.conv_scales(xs.cpu(), wt.cpu())
        card_ops = (quant.quantize_input(xs, card_ops[0]), *card_ops[1:])
        cpu_ops = (quant.quantize_input(xs.cpu(), cpu_ops[0]), *cpu_ops[1:])
        for what, a, b in zip(("xq", "sx", "wq", "sw"), card_ops, cpu_ops):
            if not torch.equal(a.cpu(), b):
                raise RuntimeError(f"{name} conv {shape}: the card's {what} differs from the "
                                   f"CPU's")
        wb = wt.to(torch.bfloat16)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()

        def run():
            return quant.int8_conv2d(x, wt, None, stride, pad, torch.bfloat16)

        int_ms = cuda_ms(run, 5)
        peak = torch.cuda.max_memory_allocated() - base
        bf16_ms = cuda_ms(lambda: F.conv2d(x, wb, None, stride, pad), 5)
        wall, busy, top = int8_trace(run)
        print(f"    {c:4d} {h:3d} {w:3d} -> {o:4d}  {k}x{k} s{stride} p{pad}: int product and "
              f"int8_conv2d ({chunks} chunk{'s' * (chunks > 1)}, bias) bit for bit; operands "
              f"card = CPU; int path {int_ms:.3f} ms, cuDNN bf16 {bf16_ms:.3f} ms "
              f"({int_ms / bf16_ms:.2f}x); int path peak {peak / 2**20:.0f} MiB above its "
              f"input ({card})")
        print(f"      traced: device busy {busy:.3f} ms of {wall:.3f} ms wall a call "
              f"({100 * busy / wall:.1f} %); device time by op: "
              + ", ".join(f"{n} {t:.3f} ms x{cnt:g}" for n, t, cnt in top))
        del x, wb
    gc.collect()
    torch.cuda.empty_cache()


def int8_serving(card: str) -> None:
    """``Embedder(int8=True)`` against the bf16 ``Embedder`` on ir50 (bf16,
    batch 128, flip, phase 38's net and images): images/s of both in
    turns, the int8-against-bf16 cosine; then an f32 ir50 with the same
    weights (TF32 off), the card's int8 embeddings of 4 images against the
    CPU port's."""
    from vlsfr_tpu_torch.eval.extract import Embedder
    from vlsfr_tpu_torch.models import create_net
    from vlsfr_tpu_torch.ops import quant

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(3)
        net = create_net("ir50", feat_dim=512, dtype="bfloat16")
    images = np.random.default_rng(4).standard_normal((INT8_SERVE_IMAGES, 112, 112, 3),
                                                      dtype=np.float32)
    calibrate_bn(net.cuda(), torch.from_numpy(images[:128]).cuda())
    embs, rates = {}, {}
    for int8 in (False, True, True, False):  # in turns
        emb = Embedder(net, batch_size=128, flip_average=True, int8=int8)
        emb(images[:256])  # warm-up
        quant.reset_launch_counts()
        t0 = time.perf_counter()
        e = emb(images)
        wall = time.perf_counter() - t0
        rates.setdefault(int8, []).append(INT8_SERVE_IMAGES / wall)
        launches = quant.LAUNCH_COUNTS["int8_conv"]
        want = 2 * IR50_INT8_CONVS * INT8_SERVE_IMAGES // 128 if int8 else 0
        if launches != want:
            raise RuntimeError(f"Embedder(int8={int8}): {launches} int8 convs, want {want}")
        if not (e.shape == (INT8_SERVE_IMAGES, 512) and np.isfinite(e).all()):
            raise RuntimeError(f"Embedder(int8={int8}) gave bad embeddings")
        embs[int8] = e
    for int8, r in rates.items():
        print(f"  Embedder(int8={int8}), ir50 bf16, batch 128, flip TTA: "
              f"{', '.join(f'{v:.1f}' for v in r)} images/s over {INT8_SERVE_IMAGES:,} images "
              f"from host memory, in turns ({card})")
    a, b = embs[True][:INT8_COS_IMAGES], embs[False][:INT8_COS_IMAGES]
    cos = (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))
    print(f"  int8 against bf16 embeddings, {INT8_COS_IMAGES} images: cosine min "
          f"{cos.min():.5f}, mean {cos.mean():.5f} (a reading)")
    with torch.random.fork_rng(devices=[]):
        f32 = create_net("ir50", feat_dim=512)
    f32.load_state_dict(net.state_dict())
    del net
    x = images[:INT8_CPU_IMAGES]
    got = Embedder(f32, batch_size=INT8_CPU_IMAGES, int8=True)(x)
    want = Embedder(f32, batch_size=INT8_CPU_IMAGES, int8=True, device="cpu")(x)
    cos = (got * want).sum(1) / (np.linalg.norm(got, axis=1) * np.linalg.norm(want, axis=1))
    print(f"  f32 ir50, int8, {INT8_CPU_IMAGES} images, card against CPU: cosine "
          f"{', '.join(f'{v:.6f}' for v in cos)} (limit {INT8_CPU_COS}: a conv input that "
          f"differs in its last bit rounds an int8 value the other way)")
    if not (got.shape == (INT8_CPU_IMAGES, 512) and cos.min() >= INT8_CPU_COS):
        raise RuntimeError("the card's int8 embeddings disagree with the CPU's")
    del f32
    gc.collect()
    torch.cuda.empty_cache()


def int8_gallery(card: str, tmp: str) -> None:
    """``CKPT_CONFIG`` (phase 37's: ir50 bf16, batch 256, fuse_forward)
    through the Trainer for INT8_STEPS steps, straight and with
    ``pool.gallery_int8``: a finite loss, IR50_INT8_CONVS int convs a
    step (the one 512-image gallery forward), step time and peak memory of
    both, and the gallery embeddings' cosine to the float gallery's on the
    first batch."""
    from vlsfr_tpu_torch.ops import quant

    first = {}

    def keep_first(tag):
        def hook(module, inputs, out):
            if tag not in first:
                first[tag] = (inputs[0].clone(), out.clone())
        return hook

    for int8 in (False, True):
        torch.cuda.reset_peak_memory_stats()
        trainer = shipped_trainer(CKPT_CONFIG, os.path.join(tmp, f"gallery_int8_{int8}"),
                                  f"pool.gallery_int8={str(int8).lower()}")
        try:
            hook = trainer.state.gallery.register_forward_hook(keep_first(int8))
            quant.reset_launch_counts()
            t0 = time.perf_counter()
            out = trainer.train(max_steps=INT8_STEPS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = quant.LAUNCH_COUNTS["int8_conv"]
            peak = torch.cuda.max_memory_allocated()
            hook.remove()
            b = trainer.cfg.data.batch_size
        finally:
            trainer.close()
            del trainer
            gc.collect()
            torch.cuda.empty_cache()
        want = IR50_INT8_CONVS * INT8_STEPS if int8 else 0
        print(f"  pool.gallery_int8={int8}: {json.dumps(out)}")
        print(f"    step time {2 * b / out['images_per_sec'] * 1e3:.1f} ms (last window, {card}); "
              f"{INT8_STEPS} steps {wall:.2f} s wall incl. the first; peak memory "
              f"{peak / 2**30:.2f} GiB ({card}); {launches} int8 convs "
              f"({launches / INT8_STEPS:g} a step)")
        if not (math.isfinite(out["loss"]) and out["final_step"] == INT8_STEPS
                and launches == want):
            raise RuntimeError(f"gallery_int8={int8}: {out}, {launches} int8 convs (want {want})")
    (xf, ef), (xi, ei) = first[False], first[True]
    cos = torch.nn.functional.cosine_similarity(ef.float(), ei.float(), dim=1)
    print(f"  the first batch's gallery embeddings ({ef.shape[0]} images, same batch: "
          f"{torch.equal(xf, xi)}), int8 against float: cosine min {float(cos.min()):.5f}, "
          f"mean {float(cos.mean()):.5f} (a reading)")
    if not torch.isfinite(ei).all():
        raise RuntimeError("the int8 gallery's embeddings are not finite")


def int8_phase(card: str) -> None:
    """Phase 41: int8 conv inference on the card (``ops/quant.py``)."""
    from vlsfr_tpu_torch.models import create_net

    for name in INT8_NETS:
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(5)
            net = create_net(name, feat_dim=512, dtype="bfloat16").cuda()
        int8_conv_checks(name, int8_conv_shapes(net), card)
        del net
    int8_serving(card)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        int8_gallery(card, tmp)


# ----------------------------------------------------------------------
# phase 42: the dense heads on the model axis (parallel/sharded_dense.py;
# no kernel: dense torch per block and the group's collectives, as XLA ran
# these heads in JAX)
# ----------------------------------------------------------------------

MESH_FFC_Q = 1000  # the reference's queue (config.py:106): the dense FFC head
MESH_C = 100_000  # route C: below pool.streaming_threshold = 131072, so dense
MESH_BLOCKS = 4  # the emulated blocks: a 4-card run's
MESH_ROUTES = {  # route: its overrides of the FFC / softmax slice config (E at 2^20 classes)
    "dense FFC": (f"pool.queue_size={MESH_FFC_Q}",),
    "C": (f"pool.num_classes={MESH_C}",),
    "E sparse": (f"pool.sample_rate={SAMPLE_RATE}", "pool.sparse_update=true"),
    "E dense": (f"pool.sample_rate={SAMPLE_RATE}",),
}
MESH_STEPS = 2  # the timed warm steps of each route, after one untimed


def rel_gap(got, want) -> float:
    """max |got − want| / max |want|."""
    return float((got.double() - want.double()).abs().max() / want.double().abs().max())


def emulated_ffc_check(p_x, p_y, g_y, g_x, queue, plan_a, plan_b, la, lb, kw: dict,
                       k: int) -> None:
    """The dense FFC head from MESH_BLOCKS emulated blocks of ``queue``
    against the single-device ``directional_loss`` pair at full width:
    losses 1e-5 relative, d_emb 1e-4 × max |d_emb|."""
    from vlsfr_tpu_torch.core.ffc import dense_views, directional_loss
    from vlsfr_tpu_torch.ops.twin_margin import reduce_margin_dir
    from vlsfr_tpu_torch.parallel.sharded_dense import emulate, held_columns

    b, n = p_x.shape[0], queue.shape[1] // MESH_BLOCKS
    px, py = (p.detach().float().requires_grad_(True) for p in (p_x, p_y))
    loss_a = directional_loss(px, g_y, queue, *plan_a, la, **kw, hard_neg=k)[0]
    loss_b = directional_loss(py, g_x, queue, *plan_b, lb, **kw, hard_neg=k)[0]
    (loss_a + loss_b).backward()
    e = torch.cat([p_x, p_y]).detach().float().requires_grad_(True)
    labels = torch.stack([la, la, lb, lb])
    parts = []
    for j in range(MESH_BLOCKS):
        cos = []
        for p, g, plan in ((e[:b], g_y, plan_a), (e[b:], g_x, plan_b)):
            _, view1, view2 = dense_views(queue[:, j * n:(j + 1) * n], g, *plan, j * n)
            cos += [p @ view1.T, p @ view2.T]
        col_ids = torch.arange(j * n, (j + 1) * n, device=queue.device)
        parts.append((torch.stack(cos), held_columns(col_ids, labels), col_ids))
    pos = (labels >= 0).float()
    d_ce = pos / pos.sum(-1, keepdim=True).clamp(min=1.0)
    d_neg = (1 - pos) / (1 - pos).sum(-1, keepdim=True).clamp(min=1.0)
    (ce, neg, *_), grads = emulate(parts, k, kw, d_ce, d_neg)
    blk_a = reduce_margin_dir(ce[0], neg[0], ce[1], neg[1], la)
    blk_b = reduce_margin_dir(ce[2], neg[2], ce[3], neg[3], lb)
    torch.autograd.backward([cos for cos, _, _ in parts], grads)
    blk_a, blk_b, loss_a, loss_b = (x.detach() for x in (blk_a, blk_b, loss_a, loss_b))
    gaps = [abs(float(blk_a) - float(loss_a)) / abs(float(loss_a)),
            abs(float(blk_b) - float(loss_b)) / abs(float(loss_b))]
    d_gap = rel_gap(e.grad, torch.cat([px.grad, py.grad]))
    print(f"  dense FFC, {MESH_BLOCKS} emulated blocks of {n} slots against the single-device "
          f"head (b = {b} per direction, D = {queue.shape[2]}, k = {k}): losses "
          f"{float(blk_a):.6f} / {float(loss_a):.6f}, {float(blk_b):.6f} / {float(loss_b):.6f} "
          f"(relative gaps {max(gaps):.2e} <= 1e-5); d_emb {d_gap:.2e} x max|d_emb| <= 1e-4")
    if not (max(gaps) <= 1e-5 and d_gap <= 1e-4):
        raise RuntimeError("the emulated dense FFC blocks disagree with the single-device head")


def emulated_softmax_check(route: str, emb, w, labels, kw: dict, rand=None,
                           num_sampled: int = 0) -> None:
    """Route C (or E, given its draws ``rand``) from MESH_BLOCKS emulated
    blocks of the classifier ``w`` against the single-device head at full
    width: loss 1e-5 relative, train_acc equal, d_emb and the classifier's
    gradient 1e-4 × their max."""
    from vlsfr_tpu_torch.parallel.partial_fc import (
        l2_normalize_rows,
        margin_softmax_loss,
        sample_classes,
    )
    from vlsfr_tpu_torch.parallel.sharded_dense import emulate, held_columns

    c, n = w.shape[0], w.shape[0] // MESH_BLOCKS
    e_ref = emb.detach().float().requires_grad_(True)
    w_ref = w.detach().clone().requires_grad_(True)
    if rand is None:
        targets = labels
        loss_ref, m_ref = margin_softmax_loss(e_ref, w_ref, labels, **kw)
    else:
        sampled, targets, valid = sample_classes(labels, c, num_sampled, rand)
        loss_ref, m_ref = margin_softmax_loss(e_ref, w_ref[sampled.long()], targets,
                                              col_mask=valid, **kw)
    loss_ref.backward()
    e = emb.detach().float().requires_grad_(True)
    parts, leaves = [], []
    for j in range(MESH_BLOCKS):
        if rand is None:
            col_ids = torch.arange(j * n, (j + 1) * n, device=w.device)
            rows = col_ids
        else:
            mine = valid & (sampled >= j * n) & (sampled < (j + 1) * n)
            col_ids = torch.nonzero(mine).flatten()
            rows = sampled[col_ids].long()
        leaf = w[rows].detach().requires_grad_(True)
        cos = e @ l2_normalize_rows(leaf).float().T
        parts.append((cos[None], held_columns(col_ids, targets)[None], col_ids))
        leaves.append((rows, leaf))
    b = emb.shape[0]
    d_ce = torch.full((1, b), 1.0 / b, device=w.device)
    (ce, _, _, _, ids), grads = emulate(parts, 1, kw, d_ce, torch.zeros_like(d_ce))
    loss = ce[0].mean()
    acc = (ids[0, :, 0] == targets.long()).float().mean()
    torch.autograd.backward([cos for cos, _, _ in parts], grads)
    d_w = torch.zeros_like(w_ref.grad)
    for rows, leaf in leaves:
        d_w.index_copy_(0, rows, leaf.grad)
    loss, loss_ref = loss.detach(), loss_ref.detach()
    gap = abs(float(loss) - float(loss_ref)) / abs(float(loss_ref))
    d_emb_gap, d_w_gap = rel_gap(e.grad, e_ref.grad), rel_gap(d_w, w_ref.grad)
    same_acc = float(acc) == float(m_ref["train_acc"])
    print(f"  route {route}, {MESH_BLOCKS} emulated blocks of {n} classes against the "
          f"single-device head: loss {float(loss):.6f} / {float(loss_ref):.6f} (relative gap "
          f"{gap:.2e} <= 1e-5); train_acc {float(acc):.4f} / {float(m_ref['train_acc']):.4f}; "
          f"d_emb {d_emb_gap:.2e}, d_w {d_w_gap:.2e} x their max <= 1e-4")
    if not (gap <= 1e-5 and same_acc and d_emb_gap <= 1e-4 and d_w_gap <= 1e-4):
        raise RuntimeError(f"the emulated route-{route} blocks disagree with the single-device "
                           f"head")


def dense_ffc_mesh_run(tmp: str, mesh, *overrides: str):
    """The single-device dense FFC Trainer (its pipeline, planner, schedule
    and seeded probe) and, from its modules before any step and the queue
    the same seed draws, the state and step over ``mesh``. Returns
    (trainer, mesh state, mesh step)."""
    from vlsfr_tpu_torch.core.ffc import create_ffc_state, make_train_step

    trainer = ffc_trainer(tmp, *MESH_ROUTES["dense FFC"], *overrides)
    cfg = trainer.cfg
    state = create_ffc_state(copy.deepcopy(trainer.state.probe), cfg, seed=cfg.data.seed,
                             mesh=mesh)
    return trainer, state, make_train_step(cfg, trainer.schedule, mesh=mesh)


def dense_ffc_first_step(tmp: str, mesh) -> None:
    """The dense FFC head's first step over the mesh against the
    single-device Trainer's from the same seed, batch and plan, on an f32
    backbone (phase 17's limits: loss 1e-5 relative, probe parameters and
    BN statistics 1e-5 relative + 2e-5 absolute, the queue after the write
    bit-equal); then the same batch's head from MESH_BLOCKS emulated
    blocks (``emulated_ffc_check``)."""
    from vlsfr_tpu_torch.core.ffc import _pass_to
    from vlsfr_tpu_torch.ops.margin import default_hard_neg

    trainer, state, step = dense_ffc_mesh_run(tmp, mesh, "model.dtype=float32")
    try:
        if not torch.equal(state.queue, trainer.state.queue):
            raise RuntimeError("the mesh state's block is not the seeded queue")
        batch = trainer.pipeline.make_batch(0, 0)
        idx = trainer.dcp.plan_step(batch.x_label, batch.y_label)
        probe0 = copy.deepcopy(state.probe)
        queue0 = state.queue.clone()
        loss_ref = float(trainer.train_step(trainer.state, batch.x, batch.y, idx, 1.0)["loss"])
        loss = float(step(state, batch.x, batch.y, idx, 1.0)["loss"])
        ref = trainer.state.probe.state_dict()
        worst = max(float(((v.double() - ref[k].double()).abs() - 1e-5 * ref[k].double().abs())
                          .max()) for k, v in state.probe.state_dict().items())
        same_queue = bool(torch.equal(state.queue, trainer.state.queue))
        print(f"  dense FFC first step (f32 backbone, Q = {MESH_FFC_Q}), over the mesh against "
              f"single-device: loss {loss:.6f} / {loss_ref:.6f} (1e-5 relative); probe "
              f"parameters and BN statistics max(|diff| - 1e-5 |ref|) {worst:.3e} <= 2e-5; queue "
              f"after the write bit-equal: {same_queue}")
        if not (abs(loss - loss_ref) <= 1e-5 * abs(loss_ref) and worst <= 2e-5 and same_queue):
            raise RuntimeError("the dense FFC head's first step over the mesh disagrees")
        cfg, dev = trainer.cfg, queue0.device
        x, y = (torch.as_tensor(a).to(dev) for a in (batch.x, batch.y))
        probe0.train()
        gallery = copy.deepcopy(probe0)
        with torch.no_grad():
            p_x, p_y, g_y, g_x = probe0(x), probe0(y), gallery(y), gallery(x)
        ia, ib = _pass_to(idx.a, dev), _pass_to(idx.b, dev)
        kw = dict(loss_type=cfg.loss.loss_type, margin=cfg.loss.margin, scale=cfg.loss.scale,
                  mask_svfc=cfg.loss.mask_svfc)
        k = cfg.pool.hard_neg if cfg.pool.hard_neg > 0 else default_hard_neg(MESH_FFC_Q)
        emulated_ffc_check(p_x, p_y, g_y, g_x, queue0, (ia.rows, ia.cols, ia.seen),
                           (ib.rows, ib.cols, ib.seen), ia.fake_labels, ib.fake_labels, kw,
                           min(k, MESH_FFC_Q))
    finally:
        free_trainer(trainer)
        del state, step
        gc.collect()
        torch.cuda.empty_cache()


def emulated_softmax_first_batch(tmp: str, route: str) -> None:
    """The softmax route's head on the first batch's f32 embeddings (the
    seeded f32 backbone) and the seeded classifier, from MESH_BLOCKS
    emulated blocks (``emulated_softmax_check``)."""
    from vlsfr_tpu_torch.train.softmax_head import sample_draws

    trainer = softmax_trainer(tmp, *MESH_ROUTES[route], "model.dtype=float32")
    try:
        cfg = trainer.cfg
        batch = trainer.pipeline.make_batch(0, 0)
        dev = trainer.state.classifier.device
        trainer.state.backbone.train()
        with torch.no_grad():
            emb = trainer.state.backbone(torch.as_tensor(batch.images).to(dev))
        labels = torch.as_tensor(batch.labels).to(dev).to(torch.int32)
        kw = dict(loss_type=cfg.loss.loss_type, margin=cfg.loss.margin, scale=cfg.loss.scale,
                  mask_svfc=cfg.loss.mask_svfc)
        w = trainer.state.classifier.detach()
        if route == "C":
            emulated_softmax_check(route, emb, w, labels, kw)
        else:
            b, c = labels.shape[0], cfg.pool.num_classes
            s = max(b, int(c * cfg.pool.sample_rate))
            emulated_softmax_check(route, emb, w, labels, kw, sample_draws(0, s - b, c, dev), s)
    finally:
        free_trainer(trainer)


def timed_steps(run, batches) -> tuple[list[float], float]:
    """One untimed step, then one timed step per later batch (host clock
    around each step, ended by a synchronise); (ms per step, peak GiB)."""
    torch.cuda.reset_peak_memory_stats()
    out = []
    for i, bt in enumerate(batches):
        t0 = time.perf_counter()
        loss = float(run(bt)["loss"])
        torch.cuda.synchronize()
        if not math.isfinite(loss):
            raise RuntimeError(f"a non-finite loss: {loss}")
        if i:
            out.append((time.perf_counter() - t0) * 1e3)
    return out, torch.cuda.max_memory_allocated() / 2**30


def mesh_warm_steps(tmp: str, route: str, mesh, card: str) -> None:
    """The route on the bf16 config: MESH_STEPS warm steps of the
    single-device Trainer's step, then, from the same initial modules and
    seed, of the step over the NCCL group of one, each with its peak
    memory, and their ratio; then one more step of each under the
    profiler (``profile_steps``)."""
    from vlsfr_tpu_torch.core.dcp import DCPManager
    from vlsfr_tpu_torch.core.ffc import create_ffc_state, make_train_step
    from vlsfr_tpu_torch.train.softmax_head import create_softmax_state, make_softmax_train_step

    ffc = route == "dense FFC"
    trainer = (ffc_trainer if ffc else softmax_trainer)(tmp, *MESH_ROUTES[route])
    try:
        cfg, st = trainer.cfg, trainer.state
        net0 = copy.deepcopy(st.probe if ffc else st.backbone).cpu()
        batches = [trainer.pipeline.make_batch(0, s) for s in range(2 + MESH_STEPS)]
        if ffc:
            def run_with(state, step, dcp):
                return lambda b: step(state, b.x, b.y, dcp.plan_step(b.x_label, b.y_label), 1.0)
            single = run_with(st, trainer.train_step, trainer.dcp)
        else:
            def run_with(state, step):
                return lambda b: step(state, b.images, b.labels, 1.0)
            single = run_with(st, trainer.train_step)
        single_ms, single_peak = timed_steps(single, batches[:-1])
        print(f"  {route}, one more single-device step under the profiler:")
        profile_steps(single, batches[-1:])
        trainer.state = st = single = None  # the single-device state freed before the mesh run
        gc.collect()
        torch.cuda.empty_cache()
        if ffc:
            state = create_ffc_state(net0, cfg, seed=cfg.data.seed, mesh=mesh)
            run = run_with(state, make_train_step(cfg, trainer.schedule, mesh=mesh),
                           DCPManager(cfg.pool.queue_size))
        else:
            state = create_softmax_state(net0, cfg, cfg.pool.num_classes, seed=cfg.data.seed,
                                         mesh=mesh)
            run = run_with(state, make_softmax_train_step(cfg, trainer.schedule, mesh=mesh))
        mesh_ms, mesh_peak = timed_steps(run, batches[:-1])
        print(f"  {route}, one more step over the mesh under the profiler:")
        profile_steps(run, batches[-1:])
        del state, run
        ratio = (sum(mesh_ms) / len(mesh_ms)) / (sum(single_ms) / len(single_ms))
        print(f"  {route} (bf16 backbone): {MESH_STEPS} warm steps single-device "
              f"{', '.join(f'{t:.1f}' for t in single_ms)} ms (peak {single_peak:.2f} GiB), over "
              f"the NCCL group of one {', '.join(f'{t:.1f}' for t in mesh_ms)} ms (peak "
              f"{mesh_peak:.2f} GiB); mesh / single {ratio:.3f} ({card})")
    finally:
        free_trainer(trainer)


def dense_mesh_phase(card: str, tmp: str) -> None:
    """Phase 42: the dense FFC head (Q = 1000), route C (100,000 classes)
    and route E (2^20 classes, rate 0.1, sparse and dense update) over an
    NCCL group of one: each first step on an f32 backbone against the
    single-device head's (phase 17's and phase 20's limits), the head from
    4 emulated blocks against the single-device head at full width, and
    MESH_STEPS warm steps of both on the bf16 config."""
    import torch.distributed as dist

    from vlsfr_tpu_torch.parallel import distributed
    from vlsfr_tpu_torch.parallel.mesh import make_mesh

    if not distributed.initialize("cuda"):
        raise RuntimeError("a process group outlived its phase")
    try:
        mesh = make_mesh(1, 1)
        if dist.get_backend() != "nccl" or mesh.model != 1:
            raise RuntimeError("the dense heads must run over an NCCL group of one")
        dense_ffc_first_step(tmp, mesh)
        for route in ("C", "E sparse", "E dense"):
            sharded_softmax_first_step(tmp, route, mesh, *MESH_ROUTES[route])
            gc.collect()
            torch.cuda.empty_cache()
        for route in ("C", "E sparse"):
            emulated_softmax_first_batch(tmp, route)
        print(card)
        for route in MESH_ROUTES:
            mesh_warm_steps(tmp, route, mesh, card)
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        distributed.destroy()


# ----------------------------------------------------------------------
# phase 43: the data axis of the FFC step (mesh.data > 1; no kernel: the
# quad kernels of phases 3-6, 21-24 and 39 run on the gathered batch)
# ----------------------------------------------------------------------

DATA_CONFIG = CKPT_CONFIG  # configs/ffc_ir50_1m_ids.json: ir50, 512-d, batch 256, mesh.data -1
DATA_B = 256  # (a): the config's global batch
DATA_B4 = 128  # (b): four f32 ranks of 128 rows (a global 256) would not fit beside each
# other in 80 GB, of 64 rows each they do ((a) and (b) print each rank's peak)
DATA_STORE = (200, 4)  # ids x images: 800 records, 3 steps of 256
DATA_RUNS = {  # run: (global batch, backbone dtype, mesh (data, model), overrides)
    "a": (DATA_B, "float32", (2, 1), ("pool.use_fused=on",)),
    "c": (DATA_B, "bfloat16", (2, 1), ("pool.use_fused=on",)),
    "b quad": (DATA_B4, "float32", (2, 2), ("pool.use_fused=on",)),
    "b dense": (DATA_B4, "float32", (2, 2), ("pool.use_fused=off",)),
}


def data_trainer(store: str, saved_dir: str, run: str, shape=(1, 1)):
    """The Trainer of ``DATA_CONFIG`` for ``run`` at the mesh ``shape``
    (data, model) over the raw-pixel store ``store``: no eval, no held-out
    records, no checkpoint to resume."""
    from vlsfr_tpu_torch.config import Config
    from vlsfr_tpu_torch.train.trainer import Trainer

    b, dtype, _, overrides = DATA_RUNS[run]
    cfg = Config.load(DATA_CONFIG).apply_overrides([
        f"data.batch_size={b}", f"model.dtype={dtype}", f"mesh.data={shape[0]}",
        f"mesh.model={shape[1]}", "train.eval_freq=0", "train.holdout_records=0",
        "train.print_freq=1", "train.resume=false", "data.num_workers=4", *overrides])
    cfg.data.sources = [store]
    cfg.train.saved_dir = saved_dir
    return Trainer(cfg)


def data_first_step(trainer, ulp: bool = False) -> tuple[dict, dict]:
    """The first batch's step: (its metrics, the quad launch counts); with
    ``ulp`` its images each moved by one f32 spacing, up or down (a seeded
    draw)."""
    from vlsfr_tpu_torch.ops import twin_margin as ttm

    batch = trainer.pipeline.make_batch(0, 0)
    idx = trainer.dcp.plan_step(batch.x_label, batch.y_label)
    x, y = batch.x, batch.y
    if ulp:
        rng = np.random.default_rng(1)
        x, y = (np.nextafter(a, np.where(rng.random(a.shape) < 0.5, -np.inf, np.inf)
                             .astype(np.float32)) for a in (x, y))
    ttm.reset_launch_counts()
    m = trainer.train_step(trainer.state, x, y, idx, 1.0)
    torch.cuda.synchronize()
    return {k: float(v) for k, v in m.items()}, dict(ttm.LAUNCH_COUNTS)


def data_warm_ms(trainer, barrier=None) -> float:
    """One untimed step (batch 0), then the wall time of one more (batch 1),
    ended by a synchronise (after ``barrier``, the ranks starting together)."""
    for s in range(2):
        batch = trainer.pipeline.make_batch(0, s)
        idx = trainer.dcp.plan_step(batch.x_label, batch.y_label)
        torch.cuda.synchronize()
        if barrier is not None:
            barrier()
        t0 = time.perf_counter()
        loss = float(trainer.train_step(trainer.state, batch.x, batch.y, idx, 1.0)["loss"])
        torch.cuda.synchronize()
        if not math.isfinite(loss):
            raise RuntimeError(f"a non-finite loss: {loss}")
    return (time.perf_counter() - t0) * 1e3


def digest(tensors) -> str:
    """sha256 of the tensors' bytes, in order (bit-equality across ranks)."""
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def data_axis_rank(rank: int, world: int, store_path: str, tmp: str, store: str,
                   runs: tuple) -> None:
    """One rank of phase 43 on the one card over a gloo group: for each run
    the port's Trainer at its mesh, the first step held to the data-1
    reference the parent wrote (``ref_<run>.pt``), or the warm step timed;
    writes ``<run>_rank<r>.pt``."""
    import torch.distributed as dist

    from vlsfr_tpu_torch.parallel import distributed

    # the ranks share one card: without expandable segments the caching
    # allocator reserves about a third more than the step allocates, and
    # (a)'s two ranks would not fit; read when CUDA starts, below
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    distributed.initialize("cuda", backend="gloo", rank=rank, world_size=world,
                           store_path=store_path)
    try:
        for run in runs:
            shape = DATA_RUNS[run][2]
            torch.cuda.reset_peak_memory_stats()
            trainer = data_trainer(store, os.path.join(tmp, f"{run}_{rank}"), run, shape)
            try:
                mesh = trainer.mesh
                if (mesh.data, mesh.model) != shape or dist.get_backend() != "gloo":
                    raise RuntimeError(f"run {run}: mesh {mesh} over {dist.get_backend()}")
                out = {"mesh": (mesh.data, mesh.data_rank, mesh.model, mesh.rank),
                       "local_rows": DATA_RUNS[run][0] // mesh.data}
                if run == "c":
                    out["ms"] = data_warm_ms(trainer, dist.barrier)
                    grads = [p.grad for p in trainer.state.probe.parameters()]
                    dist.barrier()
                    t0 = time.perf_counter()
                    distributed.sum_(grads, mesh.data_group)  # the step's gradient sum, again
                    torch.cuda.synchronize()
                    out["grad_sum_ms"] = (time.perf_counter() - t0) * 1e3
                    out["grad_mib"] = sum(g.numel() * g.element_size() for g in grads) / 2**20
                else:
                    out["metrics"], out["launches"] = data_first_step(trainer)
                    ref = torch.load(os.path.join(tmp, f"ref_{run}.pt"), map_location="cuda")
                    st = trainer.state
                    params = st.probe.state_dict()
                    # per tensor: max(|diff| - 1e-5 |ref|) over its limit, 2e-5 plus four
                    # times the data-1 step's own move under a one-spacing change of its images
                    out["params"] = sorted(
                        (float(((v.double() - ref["params"][k].double()).abs()
                                - 1e-5 * ref["params"][k].double().abs()).max())
                         / (2e-5 + 4 * ref["floor"][k]), k, ref["floor"][k])
                        for k, v in params.items())[-3:]
                    most = max(ref["floor"], key=ref["floor"].get)
                    out["most_moved"] = (most, float((params[most].double()
                                                      - ref["params"][most].double()).abs().max()))
                    c0, cl = mesh.class_block(st.queue.shape[1] * mesh.model)
                    want = ref["queue"][:, c0:c0 + cl]
                    out["queue_gap"] = float((st.queue - want).abs().max())
                    out["queue_same_rows"] = int((st.queue == want).all(-1).sum())
                    out["params_digest"] = digest(params.values())
                    out["queue_digest"] = digest([st.queue])
                    del ref
                out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
            finally:
                trainer.close()
                del trainer
                gc.collect()
                torch.cuda.empty_cache()
            torch.save(out, os.path.join(tmp, f"{run}_rank{rank}.pt"))
    finally:
        distributed.destroy()


def data_reference(store: str, tmp: str, run: str, again: bool = False) -> dict:
    """The run's config at mesh.data = 1 in this process: the first step's
    metrics, and its parameters and queue written for the ranks; then the
    same step from a fresh Trainer on images moved by one f32 spacing,
    whose distance from the first per parameter tensor (``floor``) is the
    step's own conditioning; with ``again`` once more on the same images
    (``spread``: the step against itself)."""
    out, params = {}, None
    for variant in ("ref", "ulp", "again")[:3 if again else 2]:
        trainer = data_trainer(store, os.path.join(tmp, f"ref_{run}_{variant}"), run)
        try:
            if trainer.mesh is not None:
                raise RuntimeError("the data-1 reference must run without a mesh")
            torch.cuda.reset_peak_memory_stats()
            metrics, launches = data_first_step(trainer, variant == "ulp")
            got = trainer.state.probe.state_dict()
            if variant == "ref":
                params = {k: v.clone() for k, v in got.items()}
                out = dict(metrics=metrics, launches=launches,
                           peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                           queue_size=trainer.cfg.pool.queue_size, queue=trainer.state.queue)
            else:
                out["floor" if variant == "ulp" else "spread"] = {
                    k: float((v.double() - params[k].double()).abs().max()) for k, v in got.items()}
        finally:
            free_trainer(trainer)
    torch.save({"params": params, "queue": out.pop("queue"), "floor": out["floor"]},
               os.path.join(tmp, f"ref_{run}.pt"))
    return out


def data_spawn(world: int, tmp: str, store: str, runs: tuple) -> list[list[dict]]:
    """``runs`` over ``world`` spawned ranks on the one card; per run the
    ranks' records."""
    import torch.multiprocessing as mp

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mp.spawn(data_axis_rank, args=(world, os.path.join(tmp, f"store{world}"), tmp, store, runs),
             nprocs=world, join=True)
    print(f"  {world} ranks spawned and joined in {time.perf_counter() - t0:.1f} s")
    return [[torch.load(os.path.join(tmp, f"{run}_rank{r}.pt"), weights_only=False)
             for r in range(world)] for run in runs]


def data_check(run: str, ref: dict, ranks: list[dict], want_launches: dict) -> None:
    """The ranks' first step against the data-1 reference (f32 backbone):
    loss 1e-5 and grad_norm 1e-4 relative; each parameter and BN
    statistics tensor within 1e-5 relative + 2e-5 + 4x the data-1 step's
    own move when its images move by one f32 spacing (the stem's weight
    gradient sums 6.4M products with cancellation: such a move shifts it
    by ~4e-4 after the step, as far as the data axis's other summation
    order does); the queue within 1e-5 (the written rows: gallery
    embeddings whose BN statistics summed in another order) and bit-equal
    on every unwritten row; the data replicas bit-equal; the quad kernels
    launched as ``want_launches``."""
    b, _, (d, m), _ = DATA_RUNS[run]
    loss_ref, gn_ref = ref["metrics"]["loss"], ref["metrics"]["grad_norm"]
    loss_gap = max(abs(r["metrics"]["loss"] / loss_ref - 1) for r in ranks)
    gn_gap = max(abs(r["metrics"]["grad_norm"] / gn_ref - 1) for r in ranks)
    worst = max(r["params"][-1][0] for r in ranks)
    queue_gap = max(r["queue_gap"] for r in ranks)
    q = ref["queue_size"]
    unwritten = min(r["queue_same_rows"] for r in ranks)
    written = b  # direction B writes at most one row a sample of the global batch
    replicas = (len({r["params_digest"] for r in ranks}) == 1
                and all(ranks[i]["queue_digest"] == ranks[i % m]["queue_digest"]
                        for i in range(len(ranks)))
                and len({json.dumps(r["metrics"], sort_keys=True) for r in ranks}) == 1)
    launches_ok = all(only_launched(r["launches"], want_launches) for r in ranks)
    most, apart = ranks[0]["most_moved"]
    launched = {k: v for k, v in ranks[0]["launches"].items() if v}
    spread = ""
    if "spread" in ref:
        k = max(ref["spread"], key=ref["spread"].get)
        spread = (f"; the data-1 step against itself (a second run) at most "
                  f"{ref['spread'][k]:.3e} ({k}; {most} {ref['spread'][most]:.3e})")
    print(f"  ({run}) mesh {d} x {m}, global batch {b} ({b // d} rows a rank), f32 backbone, "
          f"first step against mesh.data = 1 in one process: loss {ranks[0]['metrics']['loss']:.6f}"
          f" / {loss_ref:.6f} (apart {loss_gap:.2e}, limit 1e-5 relative); grad_norm "
          f"{ranks[0]['metrics']['grad_norm']:.6f} / {gn_ref:.6f} (apart {gn_gap:.2e}, limit 1e-4 "
          f"relative); parameters and BN statistics after SGD, max(|diff| - 1e-5 |ref|) over "
          f"(2e-5 + 4 x the data-1 step's move under a one-spacing change of its images), the "
          f"three highest (ratio, tensor, move): {ranks[0]['params'][::-1]} (limit 1); the "
          f"tensor moved most, {most}: apart {apart:.3e}, moved {ref['floor'][most]:.3e}"
          f"{spread}; queue after the write max |diff| {queue_gap:.3e} (limit "
          f"1e-5), rows bit-equal {unwritten:,} of {2 * q // m:,} a block (limit: all but "
          f"{written} written); data replicas bit-equal on the metrics, parameters and queue: "
          f"{replicas}; quad launches {launched} (want {want_launches})")
    print(f"  ({run}) peak device memory a process: "
          + ", ".join(f"rank {i} {r['peak_gib']:.2f} GiB" for i, r in enumerate(ranks))
          + f"; the data-1 reference {ref['peak_gib']:.2f} GiB")
    if not (loss_gap <= 1e-5 and gn_gap <= 1e-4 and worst <= 1 and queue_gap <= 1e-5
            and unwritten >= 2 * q // m - written and replicas and launches_ok):
        raise RuntimeError(f"phase 43 ({run}): the data axis disagrees with mesh.data = 1")


def data_axis_phase(card: str, tmp: str) -> None:
    """Phase 43: ``DATA_CONFIG`` with the quad kernels on the data axis, its
    ranks spawned as processes on the one card over a gloo group on CUDA
    tensors: (a) mesh 2 x 1 at the config's batch of 256 and (b) 2 x 2,
    the sharded quad and the sharded dense head, at DATA_B4, each first
    step on an f32 backbone held to the same config at mesh.data = 1 in
    this process; (c) one warm bf16 step of (a) and of its data-1 twin."""
    from vlsfr_tpu_torch.data.synthetic import generate_synthetic_store

    store = os.path.join(tmp, "store")
    generate_synthetic_store(store, num_ids=DATA_STORE[0], images_per_id=DATA_STORE[1],
                             image_size=112, seed=0)
    refs = {"a": data_reference(store, tmp, "a", again=True)}
    twin = data_trainer(store, os.path.join(tmp, "twin"), "c")
    try:
        twin_ms = data_warm_ms(twin)
    finally:
        free_trainer(twin)
    got = dict(zip(("a", "c"), data_spawn(2, tmp, store, ("a", "c"))))
    data_check("a", refs["a"], got["a"], {"quad_fwd": 1, "quad_bwd": 1})
    for run in ("b quad", "b dense"):
        refs[run] = data_reference(store, tmp, run)
    got.update(zip(("b quad", "b dense"), data_spawn(4, tmp, store, ("b quad", "b dense"))))
    data_check("b quad", refs["b quad"], got["b quad"],
               {"quad_partial_fwd": 1, "quad_partial_bwd": 1})
    data_check("b dense", refs["b dense"], got["b dense"], {})
    each = [r["ms"] for r in got["c"]]
    print(f"  (c) one warm bf16 step at global batch {DATA_B}: mesh 2 x 1 over gloo (the "
          f"ranks' collectives through host memory, both on this card) {max(each):.1f} ms (the "
          f"slower rank; ranks {', '.join(f'{t:.1f}' for t in each)}), mesh.data = 1 in one "
          f"process {twin_ms:.1f} ms; ratio {max(each) / twin_ms:.3f}, no measure of NCCL; "
          f"the gradient sum over the data group alone (gloo, {got['c'][0]['grad_mib']:.1f} "
          f"MiB of f32 gradients) {max(r['grad_sum_ms'] for r in got['c']):.1f} ms ({card})")


# ----------------------------------------------------------------------
# phase 44: the data axis of the softmax head (mesh.data > 1; no kernel: the
# margin_ce kernels of phases 7-8, 11-12 and 18-19 run on the gathered batch)
# ----------------------------------------------------------------------

ROUTE_E = (f"pool.sample_rate={SAMPLE_RATE}", "pool.sparse_update=true")
SOFTMAX_DATA_RUNS = {  # run: (mesh (data, model), backbone dtype, overrides, kernels it launches)
    "a A": ((2, 1), "float32", (), ("margin_ce_fwd", "margin_ce_bwd_fused_sgd")),
    "a B": ((2, 1), "float32", SHARDED_ROUTES["B"], ("margin_ce_fwd", "margin_ce_bwd")),
    "a D": ((2, 1), "float32", SHARDED_ROUTES["D"],
            ("margin_ce_fwd", "margin_ce_bwd_sparse", "margin_ce_bwd")),
    "a E": ((2, 1), "float32", ROUTE_E, ()),
    "b A": ((2, 2), "float32", (), ("margin_partial_fwd", "margin_ce_bwd_fused_sgd")),
    "b D": ((2, 2), "float32", ("pool.sparse_update=true", "pool.sparse_grad_rate=1.0"),
            ("margin_ce_fwd", "margin_ce_bwd_sparse", "margin_ce_bwd")),
    "c": ((2, 1), "bfloat16", (), ()),
}
SOFTMAX_DATA_REF = {"b A": "a A"}  # a run held to another run's data-1 reference
CLASS_TENSORS = ("classifier", "classifier_mom")  # split over the model axis by rows
CHUNK = 1 << 24  # elements a f64 comparison takes at a time


def softmax_data_trainer(store: str, saved_dir: str, run: str, shape=(1, 1)):
    """The Trainer of the softmax slice config for ``run`` at the mesh
    ``shape`` (data, model) over the raw-pixel store ``store``: no eval, no
    held-out records, no checkpoint to resume."""
    from vlsfr_tpu_torch.config import Config
    from vlsfr_tpu_torch.train.trainer import Trainer

    _, dtype, overrides, _ = SOFTMAX_DATA_RUNS[run]
    cfg = Config().apply_overrides([
        "model.net_type=ir50", "model.feat_dim=512", f"model.dtype={dtype}",
        f"data.batch_size={SOFTMAX['b']}", "data.image_size=112", "pool.head=full_softmax",
        f"pool.num_classes={SOFTMAX['c']}", "pool.classifier_dtype=float32",
        "pool.classifier_mom_dtype=float32", "loss.loss_type=Arc", "loss.margin=0.5",
        "loss.scale=32", "optim.lr=0.1", f"mesh.data={shape[0]}", f"mesh.model={shape[1]}",
        "train.eval_freq=0", "train.holdout_records=0", "train.print_freq=1",
        "train.resume=false", "data.num_workers=4", *overrides])
    cfg.data.sources = [store]
    cfg.train.saved_dir = saved_dir
    return Trainer(cfg)


def softmax_step(trainer, state, batch, ulp: bool = False) -> tuple[dict, dict]:
    """One step of ``trainer``'s step on ``state`` and the batch: (its
    metrics, the margin_ce launch counts); with ``ulp`` the images each
    moved by one f32 spacing, up or down (a seeded draw)."""
    from vlsfr_tpu_torch.ops import margin_stream as tms

    images = batch.images
    if ulp:
        rng = np.random.default_rng(1)
        images = np.nextafter(images, np.where(rng.random(images.shape) < 0.5, -np.inf, np.inf)
                              .astype(np.float32))
    tms.reset_launch_counts()
    m = trainer.train_step(state, images, batch.labels, 1.0)
    torch.cuda.synchronize()
    return {k: float(v) for k, v in m.items()}, dict(tms.LAUNCH_COUNTS)


def held_tensors(state) -> dict:
    """The first step's tensors phase 44 holds: the backbone's parameters
    and BN statistics, the classifier (block) and its momentum."""
    out = dict(state.backbone.state_dict())
    out.update({k: getattr(state, k).detach() for k in CLASS_TENSORS
                if getattr(state, k) is not None})
    return out


def held_bytes(state) -> int:
    """The device bytes of a softmax state's tensors."""
    tensors = [*state.backbone.state_dict().values(), state.classifier, state.classifier_mom,
               state.classifier_last]
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def max_excess(got, want, rel: float) -> float:
    """max(|got - want| - rel |want|) in f64, CHUNK elements at a time."""
    return max(float(((g.double() - w.double()).abs() - rel * w.double().abs()).max())
               for g, w in zip(got.reshape(-1).split(CHUNK), want.reshape(-1).split(CHUNK)))


def softmax_data_reference(store: str, tmp: str, run: str) -> tuple[dict, dict]:
    """The run's config at mesh.data = 1 in this process: the first step's
    metrics, and its tensors (and last-visit steps) for the ranks, kept on
    the card (the ranks map them through CUDA IPC: no copy through the
    host); then the same step from a copy of the state before it on images
    moved by one f32 spacing, whose distance from the first per tensor
    (``floor``) is the step's own conditioning. Returns (the readings, the
    tensors)."""
    t0 = time.perf_counter()
    base = torch.cuda.memory_allocated()  # the other runs' references
    trainer = softmax_data_trainer(store, os.path.join(tmp, f"ref_{run}"), run)
    try:
        if trainer.mesh is not None:
            raise RuntimeError("the data-1 reference must run without a mesh")
        batch = trainer.pipeline.make_batch(0, 0)
        before = copy.deepcopy(trainer.state)
        torch.cuda.reset_peak_memory_stats()
        metrics, launches = softmax_step(trainer, trainer.state, batch)
        peak = (torch.cuda.max_memory_allocated() - base - held_bytes(before)) / 2**30
        ref = held_tensors(trainer.state)
        softmax_step(trainer, before, batch, ulp=True)
        floor = {k: max_excess(v, ref[k], 0.0) for k, v in held_tensors(before).items()}
        held = {"tensors": ref, "floor": floor, "last": trainer.state.classifier_last}
        del before
    finally:
        free_trainer(trainer)
    return dict(metrics=metrics, launches=launches, peak_gib=peak, floor=floor,
                seconds=time.perf_counter() - t0), held


def softmax_data_rank(rank: int, world: int, store_path: str, tmp: str, store: str,
                      runs: tuple, refs: dict) -> None:
    """One rank of phase 44 on the one card over a gloo group: for each run
    the port's Trainer at its mesh, the first step held to the data-1
    reference ``refs[run]`` (the parent's tensors on the card), or the warm
    step timed; writes ``<run>_rank<r>.pt``."""
    import torch.distributed as dist

    from vlsfr_tpu_torch.parallel import distributed

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    distributed.initialize("cuda", backend="gloo", rank=rank, world_size=world,
                           store_path=store_path)
    try:
        for run in runs:
            shape = SOFTMAX_DATA_RUNS[run][0]
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            trainer = softmax_data_trainer(store, os.path.join(tmp, f"{run}_{rank}"), run, shape)
            built = time.perf_counter() - t0
            try:
                mesh = trainer.mesh
                if (mesh.data, mesh.model) != shape or dist.get_backend() != "gloo":
                    raise RuntimeError(f"run {run}: mesh {mesh} over {dist.get_backend()}")
                out = {"mesh": (mesh.data, mesh.data_rank, mesh.model, mesh.rank)}
                st = trainer.state
                if run == "c":
                    out["ms"] = softmax_warm_ms(trainer, dist.barrier)
                else:
                    out["metrics"], out["launches"] = softmax_step(
                        trainer, st, trainer.pipeline.make_batch(0, 0))
                    # taken out of refs, so the mapping closes with the run: the parent
                    # frees a block once no rank maps it (torch.cuda.ipc_collect)
                    ref = refs.pop(run)
                    c0, cl = mesh.class_block(SOFTMAX["c"], "pool.num_classes")
                    ratios = []
                    for k, v in held_tensors(st).items():
                        want = ref["tensors"][k]
                        want = want[c0:c0 + cl] if k in CLASS_TENSORS else want
                        # max(|diff| - 1e-5 |ref|) over 2e-5 plus four times the data-1
                        # step's own move under a one-spacing change of its images
                        ratios.append((max_excess(v, want, 1e-5) / (2e-5 + 4 * ref["floor"][k]),
                                       k, ref["floor"][k]))
                    out["tensors"] = sorted(ratios)[-3:]
                    out["classifier_ratio"] = next(r for r in ratios if r[1] == "classifier")
                    if st.classifier_last is not None:
                        out["last_equal"] = torch.equal(st.classifier_last,
                                                        ref["last"][c0:c0 + cl])
                    out["backbone_digest"] = digest(st.backbone.state_dict().values())
                    out["block_digest"] = fingerprint(
                        [t for t in (st.classifier, st.classifier_mom, st.classifier_last)
                         if t is not None])
                    del ref, want
                out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
            finally:
                trainer.close()
                del trainer
                gc.collect()
                torch.cuda.empty_cache()
            out["seconds"] = (built, time.perf_counter() - t0)  # the Trainer built, all of it
            torch.save(out, os.path.join(tmp, f"{run}_rank{rank}.pt"))
    finally:
        refs.clear()
        gc.collect()
        distributed.destroy()


def softmax_warm_ms(trainer, barrier=None) -> float:
    """One untimed step (batch 0), then the wall time of one more (batch 1),
    ended by a synchronise (after ``barrier``, the ranks starting together)."""
    for s in range(2):
        batch = trainer.pipeline.make_batch(0, s)
        torch.cuda.synchronize()
        if barrier is not None:
            barrier()
        t0 = time.perf_counter()
        loss = float(trainer.train_step(trainer.state, batch.images, batch.labels, 1.0)["loss"])
        torch.cuda.synchronize()
        if not math.isfinite(loss):
            raise RuntimeError(f"a non-finite loss: {loss}")
    return (time.perf_counter() - t0) * 1e3


def fingerprint(tensors) -> int:
    """A position-weighted sum of the tensors' 32-bit words on their device,
    wrapping in int64: equal for equal bits, and for a [C, D] block no copy
    to the host (bit-equality across ranks)."""
    total, pos = 0, 0
    for t in tensors:
        for chunk in t.detach().contiguous().view(torch.int32).reshape(-1).split(CHUNK):
            w = torch.arange(pos, pos + chunk.numel(), device=chunk.device) * 2654435761 + 1
            total += int((w * chunk).sum())
            pos += chunk.numel()
    return total


def softmax_twin_ms(store: str, tmp: str) -> float:
    """(c)'s data-1 twin in this process: ``softmax_warm_ms``, its state
    freed before the references are built."""
    twin = softmax_data_trainer(store, os.path.join(tmp, "twin"), "c")
    try:
        return softmax_warm_ms(twin)
    finally:
        free_trainer(twin)


def softmax_data_spawn(world: int, tmp: str, store: str, runs: tuple,
                       refs: dict) -> list[list[dict]]:
    """``runs`` over ``world`` spawned ranks on the one card, each held to
    its data-1 reference in ``refs`` (CUDA tensors of this process, which
    the ranks map through CUDA IPC); per run the ranks' records."""
    import torch.multiprocessing as mp

    gc.collect()
    torch.cuda.empty_cache()
    print(f"  this process holds {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
          f"({torch.cuda.memory_reserved() / 2**30:.2f} reserved) as {world} ranks start")
    t0 = time.perf_counter()
    # the ranks share one card: without expandable segments the caching
    # allocator reserves about a third more than the step allocates (phase
    # 43); the ranks read it when CUDA starts, which unpickling refs does
    conf = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        mp.spawn(softmax_data_rank,
                 args=(world, os.path.join(tmp, f"softmax_store{world}"), tmp, store, runs,
                       {run: refs[SOFTMAX_DATA_REF.get(run, run)] for run in runs
                        if run in refs or run in SOFTMAX_DATA_REF}),
                 nprocs=world, join=True)
    finally:
        if conf is None:
            del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = conf
    print(f"  {world} ranks spawned and joined in {time.perf_counter() - t0:.1f} s")
    return [[torch.load(os.path.join(tmp, f"{run}_rank{r}.pt"), weights_only=False)
             for r in range(world)] for run in runs]


def softmax_data_check(run: str, ref: dict, ranks: list[dict]) -> None:
    """The ranks' first step against the data-1 reference (f32 backbone):
    loss 1e-5 relative; each tensor of ``held_tensors`` by phase 43's rule
    (ratio at most 1); the last-visit steps equal; the data replicas
    bit-equal; the run's kernels launched at least once on every rank."""
    (d, m), _, _, kernels = SOFTMAX_DATA_RUNS[run]
    loss_ref = ref["metrics"]["loss"]
    loss_gap = max(abs(r["metrics"]["loss"] / loss_ref - 1) for r in ranks)
    worst = max(r["tensors"][-1][0] for r in ranks)
    last_ok = all(r.get("last_equal", True) for r in ranks)
    replicas = (len({r["backbone_digest"] for r in ranks}) == 1
                and all(ranks[i]["block_digest"] == ranks[i % m]["block_digest"]
                        for i in range(len(ranks)))
                and len({json.dumps(r["metrics"], sort_keys=True) for r in ranks}) == 1)
    launched = {k: v for k, v in ranks[0]["launches"].items() if v}
    launches_ok = all(r["launches"].get(k, 0) >= 1 for r in ranks for k in kernels)
    cls = max((r["classifier_ratio"] for r in ranks), key=lambda t: t[0])
    print(f"  ({run}) mesh {d} x {m}, global batch {SOFTMAX['b']} ({SOFTMAX['b'] // d} rows a "
          f"rank), f32 backbone, first step against mesh.data = 1 in one process: loss "
          f"{ranks[0]['metrics']['loss']:.6f} / {loss_ref:.6f} (apart {loss_gap:.2e}, limit 1e-5 "
          f"relative); backbone, classifier and momentum after the step, max(|diff| - 1e-5 "
          f"|ref|) over (2e-5 + 4 x the data-1 step's move under a one-spacing change of its "
          f"images), the three highest (ratio, tensor, move): {ranks[0]['tensors'][::-1]} "
          f"(limit 1; the classifier's {cls[0]:.3e}, move {cls[2]:.3e}); last-visit steps "
          f"equal: {last_ok}; data replicas bit-equal on the metrics, backbone and blocks: "
          f"{replicas}; margin_ce launches {launched} (want at least one of {list(kernels)})")
    print(f"  ({run}) peak device memory a process: "
          + ", ".join(f"rank {i} {r['peak_gib']:.2f} GiB" for i, r in enumerate(ranks))
          + f"; the data-1 reference {ref['peak_gib']:.2f} GiB; seconds a rank (the Trainer "
          f"built, the run) {[tuple(round(t, 1) for t in r['seconds']) for r in ranks]}, the "
          f"reference {ref['seconds']:.1f}")
    if not (loss_gap <= 1e-5 and worst <= 1 and last_ok and replicas and launches_ok):
        raise RuntimeError(f"phase 44 ({run}): the data axis disagrees with mesh.data = 1")


def softmax_data_phase(card: str, tmp: str) -> None:
    """Phase 44: the softmax slice config on the data axis, its ranks
    spawned as processes on the one card over a gloo group on CUDA tensors:
    (a) mesh 2 x 1 on routes A, B, D and E, (b) 2 x 2 on routes A and D,
    each first step on an f32 backbone held to the same config at
    mesh.data = 1 in this process; (c) one warm bf16 step of (a)'s route A
    and of its data-1 twin."""
    from vlsfr_tpu_torch.data.synthetic import generate_synthetic_store

    store = os.path.join(tmp, "store")
    generate_synthetic_store(store, num_ids=DATA_STORE[0], images_per_id=DATA_STORE[1],
                             image_size=112, seed=0)
    runs_a, runs_b = ("a A", "a B", "a D", "a E"), ("b A", "b D")
    twin_ms = softmax_twin_ms(store, tmp)
    refs, held = {}, {}
    for run in runs_a:
        refs[run], held[run] = softmax_data_reference(store, tmp, run)
    got = dict(zip(runs_a + ("c",), softmax_data_spawn(2, tmp, store, runs_a + ("c",), held)))
    for run in runs_a:
        softmax_data_check(run, refs[run], got[run])
    for run in ("a B", "a D", "a E"):  # (b) holds to "a A" and its own
        del held[run]
    gc.collect()
    torch.cuda.ipc_collect()  # the blocks the ranks mapped, now released
    torch.cuda.empty_cache()
    refs["b D"], held["b D"] = softmax_data_reference(store, tmp, "b D")
    refs["b A"] = refs["a A"]
    got.update(zip(runs_b, softmax_data_spawn(4, tmp, store, runs_b, held)))
    del held
    gc.collect()
    torch.cuda.ipc_collect()
    torch.cuda.empty_cache()
    for run in runs_b:
        softmax_data_check(run, refs[run], got[run])
    each = [r["ms"] for r in got["c"]]
    times = ", ".join(f"{t:.1f}" for t in each)
    peaks = ", ".join(f"{r['peak_gib']:.2f}" for r in got["c"])
    print(f"  (c) one warm bf16 route-A step at global batch {SOFTMAX['b']}: mesh 2 x 1 over gloo "
          f"(the ranks' collectives through host memory, both on this card) {max(each):.1f} ms "
          f"(the slower rank; ranks {times}), mesh.data = 1 in one process {twin_ms:.1f} ms; "
          f"ratio {max(each) / twin_ms:.3f}, no measure of NCCL; peak {peaks} GiB a rank "
          f"({card})")


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

    t_start = time.perf_counter()
    # cuBLAS's deterministic workspace (phase 37 runs under
    # torch.use_deterministic_algorithms); set before the first cuBLAS call
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    from vlsfr_tpu_torch.ops.cuda_build import library_path
    from vlsfr_tpu_torch.tools.wgmma_sass_check import check_library
    for name in ("conv3x3", "dot_probe"):  # register-A wgmma: no operand rewritten in flight
        for fn, res in check_library(str(library_path(name))).items():
            print(f"  {name} SASS {fn[-60:]}: {res['products']} HGMMA, A registers "
                  f"{res['a_regs']}, at most {res['max_in_flight']} groups in flight, "
                  f"{len(res['hazards'])} hazards")
            if res["hazards"]:
                raise RuntimeError(f"{name}: register-A wgmma operands rewritten in flight: "
                                   f"{res['hazards'][:4]}")

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
    gc.collect()
    torch.cuda.empty_cache()

    print("== phase 36: the backbones r50 and mobile through the Trainer; their f32 forward on "
          "the card against the CPU")
    backbone_phase(card)
    print(f"== phase 37: checkpoint and resume, {CKPT_CONFIG} through the Trainer")
    checkpoint_phase(card)
    print("== phase 38: serving: Embedder and FaceIndex")
    serving_phase(card)
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        print(f"== phase 39: the quad / twin kernels at the 10M config's batch (b = {SHIPPED_B}, "
              f"R = {2 * SHIPPED_B}, D = 512; limits as phases 21 and 25), b = {RAGGED_B}, "
              f"the int8c shard, and {FFC_CONFIG} through the Trainer")
        ffc_shipped_phase(card, tmp)
        print(f"== phase 40: the margin_ce kernels at the 5M config's batch (B = {SHIPPED_B}, "
              f"D = 512; limits as phases 7, 11 and 29), B = {RAGGED_B}, the class shard, and "
              f"{SOFTMAX_CONFIG} through the Trainer")
        softmax_shipped_phase(card, tmp)
    gc.collect()
    torch.cuda.empty_cache()
    print("== phase 41: int8 conv inference (ops/quant.py): every ungrouped conv shape of ir50 "
          "and mobile, Embedder(int8=True), pool.gallery_int8 through the Trainer")
    t0 = time.perf_counter()
    int8_phase(card)
    print(f"  phase 41 {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    print(f"== phase 42: the dense heads on the model axis over an NCCL group of one: the dense "
          f"FFC head (Q = {MESH_FFC_Q}), route C ({MESH_C} classes), route E (2^20 classes, "
          f"rate {SAMPLE_RATE}, sparse and dense update)")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        dense_mesh_phase(card, tmp)
    print(f"  phase 42 {time.perf_counter() - t0:.1f} s")
    print(f"== phase 43: the data axis of the FFC step, {DATA_CONFIG} with the quad kernels: "
          f"(a) mesh 2 x 1 at batch {DATA_B}, (b) 2 x 2 (sharded quad and dense heads) at "
          f"batch {DATA_B4}, ranks spawned on this card over gloo, each first step (f32 "
          f"backbone) against mesh.data = 1; (c) a warm bf16 step of (a) and its data-1 twin")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        data_axis_phase(card, tmp)
    print(f"  phase 43 {time.perf_counter() - t0:.1f} s")
    print(f"== phase 44: the data axis of the softmax head, the softmax slice (ir50, 2^20 f32 "
          f"classes, global batch {SOFTMAX['b']}): (a) mesh 2 x 1 on routes A, B, D and E, (b) "
          f"2 x 2 on routes A and D, ranks spawned on this card over gloo, each first step (f32 "
          f"backbone) against mesh.data = 1; (c) a warm bf16 route-A step of (a) and its data-1 "
          f"twin")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        softmax_data_phase(card, tmp)
    print(f"  phase 44 {time.perf_counter() - t0:.1f} s")
    print(f"  chip_smoke.py {time.perf_counter() - t_start:.1f} s ({card})")

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
