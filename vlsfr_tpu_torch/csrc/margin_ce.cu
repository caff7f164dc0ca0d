// Streaming margin-softmax cross-entropy over a [C, D] classifier for NVIDIA
// Hopper (sm_90a): forward (optionally with per-tile statistics), backward,
// backward with the classifier's SGD-momentum update fused in, the
// backward over selected class tiles only (sparse d_w), and the forward and
// backward of one block of a class-sharded classifier.
//
// Replaces the TPU kernels in vlsfr_tpu/ops/margin_pallas.py:
//   pallas_margin_ce_fwd (:390)           -> margin_ce_fwd_launch
//   pallas_margin_ce_bwd (:557)           -> margin_ce_bwd_launch
//   pallas_margin_ce_bwd_fused_sgd (:803) -> margin_ce_bwd_fused_sgd_launch
//   pallas_margin_ce_bwd_sparse (:1447)   -> margin_ce_bwd_sparse_launch
//   pallas_margin_partial_fwd (:991)      -> margin_partial_fwd_launch
//   pallas_margin_partial_bwd (:1036)     -> margin_partial_bwd_launch
// Semantics are those of the scan references _stream_fwd / _stream_bwd,
// the gather reference _sparse_bwd_gather and apply_sgd_dense there, and
// of vlsfr_tpu/parallel/sharded_margin.py's _local_partials /
// dense_local_bwd_scan; the plain PyTorch versions beside the wrappers
// (vlsfr_tpu_torch/ops/margin_stream.py *_plain) compute the same functions.
//
// Layout: emb [B][D] f32 (any B, D a multiple of 64 up to 512), W [C][D]
// f32 or bf16, mom [C][D] f32 or bf16 (the fused kernel), labels [B] int32
// (-1 = outlier row), gt / logz / kth / d_ce / d_neg [B] f32 (d_ce 0 on
// outlier rows, d_neg 0 on positive rows). Column offsets are 64-bit (C * D
// passes 2^31 at 5M classes). The f32 form's arithmetic is IEEE f32 FMA (no
// TF32: "f32 means f32"); the bf16 form's products run on the tensor cores.
//
// Forms (template TW, the stored W type; TM, the fused kernel's momentum
// type), as JAX selects them from w.dtype (mxu_bf16, _mxu_pair):
//  * f32 W: f32 throughout; the forward scales each raw dot by 1/||w_j||.
//  * bf16 W: both operands of every dot are rounded to bf16 and summed in
//    f32. The W operand is the NORMALISED row, bf16(w_j * inv_j), not the
//    stored one, so inv_j comes first: 1 / ||w_j|| with the squares summed
//    in f64 (exact for bf16 values in any order), max(., 1e-24), 1 / sqrt in
//    f64 and one rounding to f32, as the plain version's bf16_row_inv.
//    inv_norm_bf16_kernel writes it per logical column into a scratch the
//    wrapper passes, for the forward; the bf16 d_w pass computes it from
//    each W tile it stages and, where it runs before the d_emb pass (every
//    form but the fused one), writes it there for that pass, which
//    computes it from its own tiles where nothing wrote it (grad_w=False,
//    fused).
//    The wrapper passes emb already rounded to bf16 (held in f32, and as
//    bf16): every use of emb here is an operand of a dot. The backward
//    rounds d_cos to bf16 before both products; the normalisation backprop
//    takes <d_w_hat, w_hat> against the UNROUNDED w_hat. A product of two
//    bf16 values is exact in f32, so the tensor core's product is the MXU's
//    bf16 dot up to the order of the sums. d_w is stored in f32. The fused
//    update computes in f32 from the stored W and mom and rounds w' and
//    mom' once each to their storage types.
//
// Bound (H100 SXM, 67 TFLOP/s f32, 989 TFLOP/s bf16 tensor cores, 3.35
// TB/s) at B = 128, D = 512, C = 2^20: forward 2*B*D*C = 1.37e11 FLOP >=
// 2.05 ms (f32) against 2.15 GB of W (0.64 ms); backward three such
// products, 4.12e11 FLOP >= 6.15 ms, against 4.3 GB (W read, d_w written)
// or, fused, 8.6 GB (W and mom read and written, 2.56 ms): the f32 forms
// are compute-bound. The bf16 forms' dots against bytes: forward 0.14 ms of
// tensor time under 0.32 ms (1.07 GB of W), backward 0.42 ms under 0.96 ms
// (W read, f32 d_w written), fused 1.28 ms (bf16 mom) or 1.92 ms (f32 mom):
// bytes-bound.
//
// Design.
//  * The TPU walked the class tiles in order and carried (max, sumexp,
//    top-k) and the [B, D] d_emb in VMEM. Here blocks own disjoint column
//    ranges and write partials; a second launch merges them in a fixed
//    order (logsumexp merge, k-way top-k merge, sum of d_emb partials). No
//    float atomics anywhere: every output is bit-stable run to run.
//  * Shared with quad_margin.cu (margin_common.cuh): the margin transform,
//    the forward's row pass pieces (Lane, stream4, topk_push) and its f32
//    product (fdots_*), the partial merge, d_cos of a column and the
//    backward's f32 tile product (ftile_dots); the tensor-core pieces in
//    mma_bf16.cuh.
//  * Forward (margin_fwd_kernel<TW, STATS>: margin_ce_fwd with and without
//    statistics, margin_partial_fwd, f32 and bf16 W): one block an SM
//    holds a row group of 128 rows (all of B up to 128, so each W tile is
//    read once; above, the ceil(B / 128) row groups of a column range are
//    adjacent in launch order and share its W tiles through L2, and their
//    partials join the merge at the rows they hold) over a column range; per
//    128-column tile the product fills a cosine tile Cs [128][132]. The f32
//    form on the CUDA cores in IEEE f32 FMA (no TF32, no mma): emb's rows
//    and the W tile's staged 32 features a chunk by 16-byte cp.async into
//    padded rows, three stages (two chunks in flight beside the one in
//    use), an 8 x 8 register micro-tile that reads four features a float4
//    load (margin_common.cuh's fdots_*, quad_margin.cu's F32 forward's
//    product): 16 LDS.128 for 256 FMA, 1 byte of shared memory per FMA.
//    Each column's ||w||^2 comes from the same chunks, and each cosine is
//    acc * rsqrt(max(||w||^2, 1e-24)), one fmaf chain over the features in
//    index order from 0: the f32 backward's (ftile_dots), so its top-k
//    test meets this kth (margin_ce_clean_cos_launch writes both tilings'
//    for a check). The bf16 form: the same tile on the tensor cores
//    (chunk_cos, below), 16 warps of 32 rows x 32 columns (at 8 warps of
//    32 x 64 the kernel took 2.11 ms against 1.98-2.00 on an H100: more
//    warps to hide the copies and the mma latency), the row pass on the
//    first 8. Then each row's stream is split over two lanes
//    (threads r and r + 128), lane l taking the tile's columns [64 l, 64 l
//    + 64): two (m, s) chains a lane in base 2, a pair of quads at a time,
//    16 independent terms and no branch, and the top-k insertions only
//    where a column beats kth, a select network in registers
//    (margin_common.cuh: stream4, topk_push; quad_margin.cu's row pass).
//    Each lane folds its chains to base e in order and writes its own
//    partial ([2 * nblk][B]), so the lanes' value-only lists merge exactly
//    in the merge launch. The target column is left out of the stream and
//    the top-k and joins at the merge as scale * phi(gt) (gt comes from
//    outside, as in JAX). Tile t's row pass runs between the products of
//    tiles t and t + 1, with tile t + 1's first chunks in flight. What
//    bounds it on an H100: f32 the FMA rate (2.05 ms at C = 2^20); bf16 W's
//    bytes (0.32 ms), beside emb's rows restaged from L2 for every tile (as
//    many bytes, from L2) and the row pass's instructions
//    (tools/margin_fwd_variants.py times each phase).
//  * Forward statistics (only when asked for: the STATS instance): the
//    row pass also takes, per lane's 64-column half tile, the row's max of
//    z (scale * phi(gt) at the target column) and of the raw cosine (the
//    target's own included) into a [2][C/64][B] scratch; a third launch
//    reduces them to the caller's stats tile (a multiple of 64), so the
//    block column ranges need not align with it. Without statistics
//    nothing of this runs.
//  * The bf16 cosine is one chain wherever it is formed: k16 steps over the
//    feature axis in order, each step's product from a zero accumulator
//    added in f32 (mma_bf16.cuh: mma_nt), over bf16(emb) and bf16(w_hat).
//    The backward's top-k test (cos >= kth - KTH_TIE_TOL) compares its
//    recomputed cosine with the forward's kth, so both must be the same
//    bits: the forward stages W 64 features at a time (chunk_cos), the
//    bf16 d_emb and d_w passes whole tiles, and margin_ce_clean_cos_launch
//    writes each tiling's cosines for a check.
//  * Backward, f32 (margin_bwd_f32_kernel; every f32 form: margin_ce_bwd,
//    margin_partial_bwd, fused, sparse): IEEE f32 FMA on the CUDA cores,
//    register-blocked (margin_common.cuh: ftile_dots, 16-byte cp.async
//    staging into padded rows, float4 shared loads, a micro-tile a thread).
//    One pass of three products: a block (16 warps, one an SM) owns whole
//    64-column tiles with every batch row; per tile it stages W's chunks
//    into a whole tile [64][D + 4] that stays while emb's chunks stream
//    from L2 through two stages, and forms the raw dots [128, 64] (4 x 4 a
//    thread) and ||w||^2: each cosine is the forward's in-order fmaf chain
//    (fdots_chunk), the forward's bits (margin_ce_clean_cos_launch writes both tilings'
//    for a check). d_cos * inv goes to shared memory, transposed, with
//    <d_w_hat, w_hat> = sum_b d_cos cos from the tile; inv * d_w_hat [64,
//    D] = (d_cos * inv)^T . emb (8 x 8 a thread, emb streamed 15 rows a
//    stage), and the epilogue below takes the stored rows from the tile
//    (the fused update reads them before it writes them). Then the block's
//    d_emb partial [B, D], which lives in global memory (L2: 256 KB a block
//    at B = 128, D = 512), takes (d_cos * inv) . W from the same tile, 8 x 8
//    a thread, 256 features at a time; margin_bwd_demb_merge_kernel sums
//    the blocks' partials in block order. W is read once (2.15 GB at C =
//    2^20) and d_w written once: the three products' 6.15 ms bound, no
//    recompute. grad_w=False runs the cosines and the d_emb product alone.
//    Above 128 batch rows (GROUPS) the block walks each tile's batch in row
//    groups of 128, in batch order: the group's cosines from the tile
//    (restaged, the same bits), d_cos, its share of <d_w_hat, w_hat>, and
//    d_w_hat += its rows' product, kept in registers across the groups; the
//    epilogue then as above, the label rows' d_wl group by group. d_emb
//    leaves the pass (its [B, D] partial a block would be 1 MiB at B = 512,
//    132 MiB over the card, beyond L2; and d_w_hat's registers beside the
//    d_emb product's would spill): margin_bwd_demb_f32_kernel, 64 rows x a
//    column chunk a block, its partial [64, D] in registers, recomputes the
//    cosines and takes (d_cos * inv) . W (four products in all), launched
//    first, so the fused update's d_emb reads W before any of it is
//    written. At B = 512, C = 5,000,000: 7.86e12 FLOP of three products
//    (>= 117.4 ms at the f32 rate; W and mom read and written 41 GB,
//    12.2 ms).
//  * Backward, bf16 d_emb pass (margin_bwd_demb_bf16_kernel, every bf16
//    form): a block owns 64 rows x a column range, its emb rows resident
//    and two W tiles [64, D] in flight (cp.async, zero-filled past the
//    valid columns). Each tile is scaled in place into bf16(w_hat) once and
//    serves both products: cos [64, 64] = emb . w_hat^T, d_cos rounded to
//    bf16 into shared memory, then d_emb += d_cos . w_hat, each k16 step's
//    product from a zero accumulator added in f32; the d_emb partial [64,
//    D] lives in mma accumulators, as in quad_margin.cu's
//    quad_bwd_bf16_kernel. At B = 128 two row groups read W: 2.15 GB.
//    Both bf16 passes run 16 warps a block (64 accumulators a thread at D =
//    512): with one block an SM (its shared memory), 8 warps left each
//    phase between two barriers waiting on its own latencies (H100: every
//    phase removed in turn took 0.5-1.7 ms off a 7.2 ms d_w pass).
//  * Backward, d_w epilogue (both passes that write d_w): the normalisation
//    backprop d_w = inv * (d_w_hat - w_hat <d_w_hat, w_hat>). Each d_w row
//    has one owner block, so no reduction is needed; the owner adds the
//    label rows' d_wl (every batch row whose label is the column, in batch
//    order: a sum, no scatter). Fused: then g = d_w + wd*w, mom' = mu*mom +
//    g, upd = g + mu*mom' (Nesterov) | mom' | g (mu = 0), w' = w - lr*upd
//    from the stored w and mom, each of w' and mom' rounded once to its
//    storage type, written in place over the rows the block owns. Every
//    row decays every step: no relevance gate skips a tile. The f32 pass
//    sums <d_w_hat, w_hat> = sum_b d_cos[b, t] cos[b, t] from the tile and
//    takes d_emb from its staged copy of the rows it overwrites.
//  * Backward, bf16 d_w pass (margin_bwd_dw_bf16_kernel<MODE, TM>, every
//    bf16 form: DW_DENSE for margin_ce_bwd / margin_partial_bwd, DW_SPARSE
//    for the sparse backward, DW_SGD for the fused one with a momentum of
//    type TM): a block owns whole 64-column tiles with every batch row, one
//    block an SM; emb [128, D] bf16 stays resident (128 KB at D = 512; above
//    128 rows, GROUPS: the tile's cosines, d_cos and d_w_hat product run per
//    row group of 128, in batch order, each group's emb rows staged into
//    the same 128 KB in turn, d_w_hat summed in the accumulators across the
//    groups, the label rows' d_wl group by group)
//    beside one W tile (64 KB), so W is read once (1.07 GB at C = 2^20) and
//    d_w written once (2.15 GB): the 0.96 ms bound; fused, W and mom read
//    and written instead of d_w (1.28 ms at (bf16, bf16), 1.92 at (bf16,
//    f32)). Per tile: 1/||w|| from the staged rows; cos [128, 64] on the
//    tensor cores, each W fragment scaled into bf16(w_hat) as it is read,
//    so the stored tile stays in shared memory for the epilogue; d_cos
//    rounded to bf16 into shared memory; d_w_hat [64, D] = d_cos^T . emb in
//    mma accumulators; then <d_w_hat, w_hat> from the finished d_w_hat row
//    against the f32 w_hat = w * inv from the stored tile (JAX's and the
//    plain version's order of operations, no second product), reduced over
//    the four lanes and then the eight warps that share a row in a fixed
//    order, and the epilogue above: d_w stored in f32, or the update (each
//    row's momentum loads in flight together); then the next tile's copies
//    start. The label rows' d_wl loop
//    walks only the batch rows whose target lies in the tile (a list built
//    once a tile, in batch order). DW_DENSE and DW_SPARSE run before the
//    d_emb pass and leave 1/||w|| for it; DW_SGD runs after it, so the
//    d_emb pass reads W before any of it is written, and no tile's copies
//    read a row already written (each block owns its rows). d_emb and d_w
//    stay two passes: the [B, D] d_emb partial of a column-owning block
//    (256 KB f32 at B = 128, D = 512) fits neither its registers nor its
//    shared memory beside the tile (the f32 pass keeps it in L2 up to 128
//    rows). The d_emb pass's 64-row groups take any B (8 at B = 512).
//  * Sparse backward: the passes walk M * tile logical columns instead of
//    C. Each 64-column tile maps through tile_idx [M] (device memory, read
//    by every block: the counterpart of scalar prefetch) onto the class
//    rows it stands for; tile is a multiple of 64, so no 64-column tile
//    straddles two selected tiles. d_w rows are written in logical order
//    (rows past C in a ragged last tile, or of a tile index out of range,
//    as 0, their W not read); the owner of a row's target column also
//    writes d_gt[b], that column's dz, for the caller's target term. Bound
//    at B = 128, D = 512, M * tile = 65,536: three products 2.58e10 FLOP >=
//    0.385 ms against 0.27 GB (W tiles read, d_w rows written, 0.080 ms):
//    compute-bound; the bf16 form's three products on the tensor cores,
//    0.026 ms, under 0.20 GB (bf16 W tiles read, f32 d_w rows written,
//    0.060 ms): bytes-bound.
//  * One block of a class-sharded classifier (labels block-local: -1 an
//    outlier, -2 a positive row whose target another block owns, >= 0 an
//    owned target; gt, and backward logz / kth, global). The forward is the
//    forward's block pass; its merge folds the partials in the same fixed
//    order, then folds the owned target term scale * phi(gt) into (M, S),
//    and writes the raw (M, S, top-k) for the merge across ranks instead of
//    finalizing. The backward is the backward's passes as they are; the
//    caller masks d_ce / d_neg with the GLOBAL positive rows (a -2 row's
//    outlier test then adds d_neg = 0), and the owner's label-row gradient
//    d_wl is added by the owner block. Bound
//    at B = 128, D = 512 over a block of C_l columns: forward 2*B*D*C_l FLOP
//    (2^20: 2.05 ms), backward with d_w 3x that (6.15 ms): compute-bound.

#include <type_traits>

#include "margin_common.cuh"
#include "mma_bf16.cuh"

namespace {

struct Args {
  const float* emb;               // bf16 W: rounded to bf16 by the wrapper
  const __nv_bfloat16* eb;        // bf16 W: the same embedding stored as bf16 [B][D]
  const void* w;                  // [C][D] float or __nv_bfloat16
  const float* inv;  // bf16 W: 1 / ||w|| per logical column (scratch); f32 W: nullptr
  long long C;
  int D, B;
  const int* labels;
  const float* gt;
  int k, loss_type;
  float margin, scale, mask_svfc, cos_m, sin_m;
  // the backward's column space: C class columns, or (sparse) ncols =
  // M * sel_tile logical columns, tile i standing for class tile sel[i]
  const int* sel;  // nullptr: dense
  int sel_tile;
  long long ncols;
};

struct BwdRows {
  const float* logz;
  const float* kth;
  const float* dce;   // 0 on outlier rows
  const float* dneg;  // 0 on positive rows
};

struct Sgd {
  void* w;    // == Args::w, updated in place
  void* mom;  // updated in place, float or __nv_bfloat16
  float lr, mu, wd;
  int nesterov;
};

// 1 / ||w_j|| as the JAX package normalises f32 rows: rsqrt(max(||w||^2, 1e-24))
__device__ __forceinline__ float inv_norm(float n2) { return rsqrtf(fmaxf(n2, 1e-24f)); }

// 1 / ||w_j|| of a bf16 row from its f64 sum of squares (module header)
__device__ __forceinline__ float inv_norm_f64(double n2) {
  return (float)(1.0 / sqrt(fmax(n2, 1e-24)));
}

template <class TW>
__device__ __forceinline__ const TW* wrows(const Args& a) {
  return static_cast<const TW*>(a.w);
}

// d loss / d cos of one non-padding column; 0 at the target column, whose
// gradient joins outside through d_gt
__device__ __forceinline__ float dcos_of(float c, long long col, int label, float gt, float logz,
                                         float kth, float dce, float dneg, const Args& a) {
  return col == (long long)label ? 0.f : dcos_col(c, gt, logz, kth, dce, dneg, label < 0, a);
}

// the class column of logical column l (itself unless tiles are selected)
__device__ __forceinline__ long long phys_col(const Args& a, long long l) {
  return a.sel == nullptr ? l : (long long)a.sel[l / a.sel_tile] * a.sel_tile + l % a.sel_tile;
}

// how many of the tc columns from logical t0 (class column p0) exist: not
// past the block's range, not past C; none for a selected tile index outside
// [0, ceil(C / tile)), whose rows are then written as 0 and whose W is not read
__device__ __forceinline__ int valid_cols(const Args& a, long long t0, long long p0,
                                          long long c_end, int tc) {
  return p0 < 0 ? 0 : (int)max(0LL, min((long long)tc, min(c_end - t0, a.C - p0)));
}

// one warp per logical column: inv[l] = 1 / ||w_j|| of its class row j (0
// for a column that stands for no class): the squares summed in f64, exact
// for bf16 values in any order, so the sum does not depend on the lanes'
// order; max(., 1e-24), 1 / sqrt in f64, one rounding to f32
__global__ void inv_norm_bf16_kernel(Args a, float* inv) {
  const long long l = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (l >= a.ncols) return;
  const long long j = phys_col(a, l);
  const bool ok = j >= 0 && j < a.C;
  const __nv_bfloat16* row = wrows<__nv_bfloat16>(a) + (ok ? j : 0) * a.D;
  double n2 = 0.0;
  if (ok)
    for (int k = lane; k < a.D; k += 32) {
      const double x = (double)__bfloat162float(row[k]);
      n2 += x * x;
    }
  for (int o = 16; o > 0; o >>= 1) n2 += __shfl_down_sync(0xffffffffu, n2, o);
  if (lane == 0) inv[l] = ok ? inv_norm_f64(n2) : 0.f;
}

// ----------------------------------------------- bf16 staging (tensor cores)

// a backward row's inputs (a row past B: label -1, cotangents 0)
struct RowIn {
  int lab;
  float gt, lz, kth, dce, dneg;
};

// rows [r_base, r_base + n) of the backward's row inputs into rin [n]
__device__ __forceinline__ void load_row_in(RowIn* rin, int n, int r_base, const Args& a,
                                            const BwdRows& br) {
  for (int r = threadIdx.x; r < n; r += blockDim.x) {
    const int gr = r_base + r;
    RowIn v = {-1, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (gr < a.B) v = {a.labels[gr], a.gt[gr], br.logz[gr], br.kth[gr], br.dce[gr], br.dneg[gr]};
    rin[r] = v;
  }
}

// rows [0, rows) of D bf16 values into a swizzled [rows][D] buffer by
// cp.async: row r from src + (row0 + r) * D for r < n, zeros from n on
__device__ __forceinline__ void stage_rows_bf16(unsigned char* dst, const __nv_bfloat16* src,
                                                long long row0, int n, int rows, int D) {
  const int rc = D / 8;
  for (int i = threadIdx.x; i < rows * rc; i += blockDim.x) {
    const int r = i / rc, ch = i - r * rc;
    const bool ok = r < n;
    cp_async_cg(dst + swz(r, 8 * ch, rc), ok ? src + (row0 + r) * D + 8 * ch : src, ok);
  }
}

// inv[r] = 1 / ||row r|| of a staged W tile [64][D] (swizzled) for r < n,
// else 0, with inv_norm_bf16_kernel's bits (module header): BW_THREADS
// threads, eight to a row, each summing every eighth 16-byte chunk in f64
constexpr int BW_THREADS = 512;  // the bf16 backward passes: 16 warps a block
__device__ __forceinline__ void row_inv_tile(const unsigned char* T, int n, int D, float* inv) {
  const int rc = D / 8, r = threadIdx.x >> 3, q = threadIdx.x & 7;
  double n2 = 0.0;
  for (int ch = q; ch < rc; ch += 8) {
    const uint4 v = *reinterpret_cast<const uint4*>(T + swz(r, 8 * ch, rc));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      n2 += (double)f.x * (double)f.x;
      n2 += (double)f.y * (double)f.y;
    }
  }
  for (int o = 1; o < 8; o <<= 1) n2 += __shfl_xor_sync(0xffffffffu, n2, o);
  if (q == 0) inv[r] = r < n ? inv_norm_f64(n2) : 0.f;
}

// two stored W values scaled by their row's 1 / ||w||, each rounded once:
// bf16(w * inv), the dots' W operand
__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t v, float s) {
  __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&v);
  const float2 f = __bfloat1622float2(h);
  h = __floats2bfloat162_rn(f.x * s, f.y * s);
  return *reinterpret_cast<uint32_t*>(&h);
}

// a staged bf16 W block [rows][rc chunks] (swizzled) scaled in place, row r
// by inv[r] (scale_bf16x2)
__device__ __forceinline__ void scale_rows_bf16(unsigned char* T, int rows, int rc,
                                                const float* inv) {
  for (int i = threadIdx.x; i < rows * rc; i += blockDim.x) {
    const int r = i / rc, ch = i - r * rc;
    uint4* p = reinterpret_cast<uint4*>(T + swz(r, 8 * ch, rc));
    uint4 v = *p;
    v = make_uint4(scale_bf16x2(v.x, inv[r]), scale_bf16x2(v.y, inv[r]),
                   scale_bf16x2(v.z, inv[r]), scale_bf16x2(v.w, inv[r]));
    *p = v;
  }
}

// The forward's bf16 cosines: emb rows [r_base, r_base + ROWS) and a tile
// of TC columns staged 64 features at a time, CH_ST chunks in flight
constexpr int CH_ST = 3;
template <int ROWS, int TC>
__host__ __device__ constexpr int chunk_bytes() {
  return (ROWS + TC) * 64 * 2;
}

// features [64 kc, + 64) of emb rows [r_base, r_base + ROWS) (zero past B)
// and of the W rows p0 .. p0 + n of the tile (zero from n) into stage s
template <int ROWS, int TC>
__device__ __forceinline__ void load_chunk(const Args& a, unsigned char* stg, int s, int r_base,
                                           long long p0, int n, int kc) {
  const __nv_bfloat16* W = wrows<__nv_bfloat16>(a);
  unsigned char* Es = stg + s * chunk_bytes<ROWS, TC>();
  unsigned char* Ts = Es + ROWS * 64 * 2;
  const int f0 = 64 * kc;
  for (int i = threadIdx.x; i < (ROWS + TC) * 8; i += blockDim.x) {
    const int r = i >> 3, ch = i & 7;
    if (r < ROWS) {
      const bool ok = r_base + r < a.B;
      cp_async_cg(Es + swz(r, 8 * ch, 8),
                  ok ? a.eb + (long long)(r_base + r) * a.D + f0 + 8 * ch : a.eb, ok);
    } else {
      const bool ok = r - ROWS < n;
      cp_async_cg(Ts + swz(r - ROWS, 8 * ch, 8), ok ? W + (p0 + r - ROWS) * a.D + f0 + 8 * ch : W,
                  ok);
    }
  }
}

// the first CH_ST - 1 chunks of the tile of class rows p0 .. p0 + n - 1,
// each its own cp.async group (chunk_cos stages the rest)
template <int ROWS, int TC>
__device__ __forceinline__ void chunk_prologue(const Args& a, unsigned char* stg, int r_base,
                                               long long p0, int n) {
  const int n_kc = a.D / 64;
#pragma unroll
  for (int s = 0; s < CH_ST - 1; ++s) {
    if (s < n_kc) load_chunk<ROWS, TC>(a, stg, s, r_base, p0, n, s);
    cp_async_commit();
  }
}

// acc[mi][ni] = the cosines of emb rows r_base + m0 + 16 mi .. against the tile's
// columns n0 + 8 ni .. (class rows p0 .., n of them): each chunk's W part
// scaled in place by inv [TC] (shared memory, written before the first
// barrier here) into bf16(w_hat), the k16 chain over the feature axis in
// order (module header). Its first chunks in flight (chunk_prologue);
// leaves none in flight and ends with a barrier.
template <int ROWS, int TC, int NI>
__device__ __forceinline__ void chunk_cos(const Args& a, unsigned char* stg, const float* inv,
                                          int r_base, long long p0, int n, int m0, int n0,
                                          float (&acc)[2][NI][4]) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
  const int n_kc = a.D / 64;
  for (int kc = 0; kc < n_kc; ++kc) {
    cp_async_wait<CH_ST - 2>();
    __syncthreads();  // chunk kc has landed; chunk kc - 1's stage is free
    unsigned char* Es = stg + (kc % CH_ST) * chunk_bytes<ROWS, TC>();
    scale_rows_bf16(Es + ROWS * 64 * 2, TC, 8, inv);
    if (kc + CH_ST - 1 < n_kc)
      load_chunk<ROWS, TC>(a, stg, (kc + CH_ST - 1) % CH_ST, r_base, p0, n, kc + CH_ST - 1);
    cp_async_commit();
    __syncthreads();  // the chunk holds bf16(w_hat)
    mma_nt<2, NI>(acc, Es, 8, m0, Es + ROWS * 64 * 2, 8, n0, 4);
  }
  cp_async_wait<0>();
  __syncthreads();  // every stage is free for the next tile
}

// ---------------------------------------------------------------- forward

// A block holds F_ROWS batch rows, a row group (all of B up to 128; the ceil(B /
// F_ROWS) row groups of a column range adjacent in launch order), over a column
// range, f_threads threads, one block an SM (fwd_smem; ops/margin_stream.py's
// fwd_geometry computes the same). Per F_TC-column tile the product fills the
// cosine tile Cs [F_ROWS][F_CLD] from chunks staged by cp.async in F_NST stages:
// f32 W FFK features of emb's rows and of the W tile (margin_common.cuh's
// fdots_*, an F_TI x F_TJ micro-tile), bf16 W 64 features (chunk_cos). Each
// row's stream is split over F_LANES lanes (threads r and r + F_ROWS), lane l
// taking the tile's columns [64 l, 64 l + 64): its statistics half tile, so no
// two lanes share one.
constexpr int F_ROWS = 128, F_TC = 128, F_THREADS = 256, F_CLD = F_TC + 4, F_NST = CH_ST;
constexpr int F_LANES = F_THREADS / F_ROWS, F_TI = 8, F_TJ = 8;
constexpr int F_SA = F_ROWS / F_TI, F_SB = F_TC / F_TJ;  // the micro-tile's row and column steps
constexpr int STAT_COLS = 64;  // columns per statistics partial: one lane's share of a tile
static_assert(F_TC / F_LANES == STAT_COLS,
              "a lane's columns of a tile are one statistics half tile");
static_assert(F_SA * F_SB == F_THREADS, "the micro-tiles cover the tile");

// threads a block: f32 W F_THREADS; bf16 W twice as many for the tensor-core
// product (warps of 32 rows x 32 columns), the row pass on the first
// F_THREADS
template <class TW>
__host__ __device__ constexpr int f_threads() {
  return std::is_same<TW, float>::value ? F_THREADS : 2 * F_THREADS;
}

// bytes of a stage: f32 W emb's and the W tile's rows, FFK features at a
// row stride of FFK + 4 floats; bf16 W 64 features of each, swizzled
template <class TW>
__host__ __device__ constexpr int fwd_stage_bytes() {
  return std::is_same<TW, float>::value ? 4 * fdots_stage_floats<F_ROWS, F_TC>()
                                        : chunk_bytes<F_ROWS, F_TC>();
}
// a block's shared memory: the stages, Cs and the tile's columns' 1 / ||w_j||
template <class TW>
__host__ __device__ constexpr int fwd_smem() {
  return F_NST * fwd_stage_bytes<TW>() + 4 * (F_ROWS * F_CLD + F_TC);
}
static_assert(fwd_smem<float>() <= 232448 && fwd_smem<__nv_bfloat16>() <= 232448,
              "the forward fits a block's shared memory");

// the first F_NST - 1 chunks of the tile at t0 (n valid columns; emb rows
// from r_base), each its own cp.async group; bf16 W also the tile's 1 /
// ||w_j|| (a.inv, 0 from n) into inv, which chunk_cos reads after its
// first barrier
template <class TW>
__device__ __forceinline__ void fwd_prologue(const Args& a, unsigned char* stg, float* inv,
                                             int r_base, long long t0, int n) {
  if constexpr (std::is_same<TW, float>::value) {
    const int nk = a.D / FFK;
#pragma unroll
    for (int s = 0; s < F_NST - 1; ++s) {
      if (s < nk)
        fdots_load<F_THREADS, F_ROWS, F_TC>(
            reinterpret_cast<float*>(stg + s * fwd_stage_bytes<TW>()), a.emb, r_base,
            min(F_ROWS, a.B - r_base), wrows<float>(a), t0, n, a.D, s);
      cp_async_commit();
    }
  } else {
    if (threadIdx.x < F_TC) inv[threadIdx.x] = (int)threadIdx.x < n ? a.inv[t0 + threadIdx.x] : 0.f;
    chunk_prologue<F_ROWS, F_TC>(a, stg, r_base, t0, n);
  }
}

// the f32 W tile at t0 (n valid columns), its first chunks in flight
// (fwd_prologue): the raw dots of the thread's micro-tile (emb rows r_base +
// ax + F_SA i, columns by + F_SB j) into acc, and 1 / ||w_j|| of the tile's
// columns into inv, their squares summed from the same chunks by threads
// t < F_TC. Leaves no copy in flight and ends with a barrier (every stage
// read, inv written).
__device__ __forceinline__ void fwd_dots_f32(const Args& a, unsigned char* stg, float* inv,
                                             int r_base, long long t0, int n, int ax, int by,
                                             float (&acc)[F_TI][F_TJ]) {
  constexpr int SB = fwd_stage_bytes<float>();
  const int nk = a.D / FFK;
#pragma unroll
  for (int i = 0; i < F_TI; ++i)
#pragma unroll
    for (int j = 0; j < F_TJ; ++j) acc[i][j] = 0.f;
  float n2 = 0.f;
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<F_NST - 2>();
    __syncthreads();  // chunk kc has landed; chunk kc - 1's stage is free
    if (kc + F_NST - 1 < nk)
      fdots_load<F_THREADS, F_ROWS, F_TC>(
          reinterpret_cast<float*>(stg + ((kc + F_NST - 1) % F_NST) * SB), a.emb, r_base,
          min(F_ROWS, a.B - r_base), wrows<float>(a), t0, n, a.D, kc + F_NST - 1);
    cp_async_commit();
    const float* st = reinterpret_cast<const float*>(stg + (kc % F_NST) * SB);
    if (threadIdx.x < F_TC) fdots_norm<F_ROWS>(n2, st, threadIdx.x);
    fdots_chunk<F_ROWS, F_TC, F_TI, F_TJ>(acc, st, ax, by);
  }
  if (threadIdx.x < F_TC) inv[threadIdx.x] = inv_norm(n2);
  __syncthreads();  // every read of the stages is done; inv is written
}

// a thread's batch row in the row pass
struct RowPass {
  int r, lane, label;  // the batch row, the thread's lane, the row's label
  float gt, zt;        // the target cosine and its z = scale * phi(gt)
  float zs;            // scale * log2(e): the chains stream z / ln 2
  long long n64;       // the classifier's statistics half tiles
};

// One lane's share of row rp.r in the tile at t0 (n valid columns; crow
// the row's Cs row): its columns [64 lane, + 64) into ln, a pair of quads
// at a time, the pair's two quads into the lane's two chains (stream4, 16
// independent terms); the target column stays out of the stream and the
// top-k, whose insertions run only where a column beats kth. With STATS,
// the half tile's max of z (scale * phi(gt) at the target column) and of
// the raw cosine (the target's own included) over its valid columns into
// the [2][n64][B] scratch (a half tile past C holds no column and is not
// written).
template <bool STATS>
__device__ __forceinline__ void row_pass(const Args& a, const float* crow, long long t0, int n,
                                         const RowPass& rp, Lane<1>& ln, float* stats) {
  constexpr int NP = F_TC / F_LANES / 8;  // quad pairs a lane
  const int c0 = rp.lane * (F_TC / F_LANES);
  const long long tgt = rp.label - t0;  // the target's tile column, if here
  float zm = -INFINITY, cm = -INFINITY;
  for (int i = 0; i < NP; ++i) {
    float c[2][4];
    bool ok[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = c0 + 8 * i + 4 * h;
      const float4 v = *reinterpret_cast<const float4*>(crow + q);
      c[h][0] = v.x, c[h][1] = v.y, c[h][2] = v.z, c[h][3] = v.w;
#pragma unroll
      for (int j = 0; j < 4; ++j) ok[h][j] = q + j < n && q + j != tgt;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) stream4(a, rp.zs, c[h], ok[h], rp.gt, ln.m[0][h], ln.s[0][h]);
    float mx = -INFINITY;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (ok[h][j]) mx = fmaxf(mx, c[h][j]);
        if constexpr (STATS) {
          const int col = c0 + 8 * i + 4 * h + j;
          if (col < n) {
            cm = fmaxf(cm, c[h][j]);
            zm = fmaxf(zm, col == tgt ? rp.zt : a.scale * mod_of(a, c[h][j], rp.gt));
          }
        }
      }
    // the insertions: one copy of topk_push, in a loop over the pair's columns
    if (mx > ln.kth[0]) {
#pragma unroll 1
      for (int j = 0; j < 8; ++j) {
        float x = -INFINITY;
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (e == j && ok[e >> 2][e & 3]) x = c[e >> 2][e & 3];
        topk_push(ln.tk[0], ln.kth[0], x, a.k);
      }
    }
  }
  if constexpr (STATS) {
    const long long g = t0 / STAT_COLS + rp.lane;
    if (g < rp.n64) {
      stats[g * a.B + rp.r] = zm;
      stats[(rp.n64 + g) * a.B + rp.r] = cm;
    }
  }
}

// The forward's block pass (module header) over n_rg row groups x the
// column ranges. part: [F_LANES * nblk][B][PART] (nblk column ranges),
// each lane's (m, s, top-k) of its columns of the range at (range * F_LANES
// + lane); STATS: stats the [2][ceil(C / 64)][B] scratch of per-64-column
// maxima (z first, then the raw cosine), else unused.
template <class TW, bool STATS>
__global__ void __launch_bounds__(f_threads<TW>(), 1)
    margin_fwd_kernel(Args a, long long cols_per_blk, int n_rg, float* part, float* stats) {
  constexpr bool BF16 = !std::is_same<TW, float>::value;
  extern __shared__ __align__(16) unsigned char f_sm[];
  unsigned char* stg = f_sm;                                                   // [F_NST] stages
  float* Cs = reinterpret_cast<float*>(stg + F_NST * fwd_stage_bytes<TW>());  // [F_ROWS][F_CLD]
  float* inv = Cs + F_ROWS * F_CLD;  // 1 / ||w_j|| of the tile's columns

  const int tid = threadIdx.x;
  const int chunk = blockIdx.x / n_rg, r_base = (blockIdx.x % n_rg) * F_ROWS;
  const long long c_begin = (long long)chunk * cols_per_blk;
  const long long c_end = min(a.C, c_begin + cols_per_blk);
  const int n_tiles = c_end > c_begin ? (int)((c_end - c_begin + F_TC - 1) / F_TC) : 0;
  auto cols = [&](int ti) {  // valid columns of tile ti
    return (int)min((long long)F_TC, c_end - c_begin - (long long)F_TC * ti);
  };
  const int lr = tid % F_ROWS;  // the thread's row of Cs
  RowPass rp;
  rp.r = r_base + lr;
  rp.lane = tid / F_ROWS;
  const bool row_ok = rp.r < a.B && rp.lane < F_LANES;
  rp.label = row_ok ? a.labels[rp.r] : -1;
  rp.gt = row_ok ? a.gt[rp.r] : 0.f;
  rp.zt = a.scale * phi_target(rp.gt, a);
  rp.zs = a.scale * LOG2E;
  rp.n64 = (a.C + STAT_COLS - 1) / STAT_COLS;
  Lane<1> ln;
  lane_init(ln);

  if (n_tiles > 0) fwd_prologue<TW>(a, stg, inv, r_base, c_begin, cols(0));
  // tile ti's product after tile ti - 1's row pass, with tile ti's first
  // chunks in flight; a last turn streams the last tile
  for (int ti = 0; ti <= n_tiles; ++ti) {
    __syncthreads();  // tile ti - 1 is in Cs
    if (ti > 0 && row_ok)
      row_pass<STATS>(a, Cs + lr * F_CLD, c_begin + (long long)F_TC * (ti - 1), cols(ti - 1), rp,
                      ln, stats);
    if (ti == n_tiles) break;
    const long long t0 = c_begin + (long long)F_TC * ti;
    const int n = cols(ti);
    // the product's first barrier follows every read of Cs by the row pass
    if constexpr (BF16) {  // the dots of the rounded operands are the cosines
      constexpr int NI = F_TC * 4 * 32 / f_threads<TW>() / 8;  // n8 tiles a warp
      const int warp = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
      const int wr = (warp & 3) * 32, wc = (warp >> 2) * 8 * NI;  // warps of 32 rows x 8 NI columns
      float acc[2][NI][4];
      chunk_cos<F_ROWS, F_TC, NI>(a, stg, inv, r_base, t0, n, wr, wc, acc);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float* cp = Cs + (wr + 16 * mi + g + 8 * h) * F_CLD + wc + 8 * ni + 2 * t;
            *reinterpret_cast<float2*>(cp) = make_float2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
          }
    } else {
      int ax, by;
      fdots_map<F_ROWS, F_TC, F_TI, F_TJ>(ax, by);
      float acc[F_TI][F_TJ];
      fwd_dots_f32(a, stg, inv, r_base, t0, n, ax, by, acc);
#pragma unroll
      for (int i = 0; i < F_TI; ++i)
#pragma unroll
        for (int j = 0; j < F_TJ; ++j)
          Cs[(ax + F_SA * i) * F_CLD + by + F_SB * j] = acc[i][j] * inv[by + F_SB * j];
    }
    if (ti + 1 < n_tiles) fwd_prologue<TW>(a, stg, inv, r_base, t0 + F_TC, cols(ti + 1));
  }

  // the lane's chains folded to base e in order; its partial, merged with
  // the other lanes' and blocks' in a fixed order by the merge launch
  if (!row_ok) return;
  float M, S;
  lane_fold(ln, 0, M, S);
  float* p = part + (((long long)chunk * F_LANES + rp.lane) * a.B + rp.r) * PART;
  p[0] = M;
  p[1] = S;
  tk_store<0>(p + 2, ln.tk[0]);
}

// one thread per row: merge the partials in order, finalize ce / neg / logz / top-k
__global__ void margin_fwd_merge_kernel(Args a, int nparts, const float* part, float* ce,
                                        float* neg, float* logz, float* topk) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= a.B) return;
  float M = -INFINITY, S = 0.f;
  float tk[KMAX];
  for (int j = 0; j < KMAX; ++j) tk[j] = NEG_INF_F;
  for (int q = 0; q < nparts; ++q)
    merge_partial(part + ((long long)q * a.B + r) * PART, a.k, M, S, tk);
  const float zt = a.scale * phi_target(a.gt[r], a);
  finalize_row(M, S, tk, a.k, a.labels[r] >= 0, zt, ce[r], neg[r], logz[r]);
  for (int j = 0; j < a.k; ++j) topk[(long long)r * a.k + j] = tk[j];
}

// one thread per row: merge the partials in order into the block's raw
// (m, s, top-k); a row that owns its target (label >= 0) folds in
// scale * phi(gt), the column the block pass left out
__global__ void margin_partial_merge_kernel(Args a, int nparts, const float* part, float* m,
                                            float* s, float* topk) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= a.B) return;
  float M = -INFINITY, S = 0.f;
  float tk[KMAX];
  for (int j = 0; j < KMAX; ++j) tk[j] = NEG_INF_F;
  for (int q = 0; q < nparts; ++q)
    merge_partial(part + ((long long)q * a.B + r) * PART, a.k, M, S, tk);
  if (a.labels[r] >= 0) lse_fold(a.scale * phi_target(a.gt[r], a), 1.f, M, S);
  m[r] = M;
  s[r] = S;
  for (int j = 0; j < a.k; ++j) topk[(long long)r * a.k + j] = tk[j];
}

// one thread per (stats tile, row): maxz / maxcos [n_tiles][B] as the max
// of the tile's per-64-column partials
__global__ void margin_fwd_stats_kernel(int B, long long n64, int per_tile, long long n_tiles,
                                        const float* stats, float* maxz, float* maxcos) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n_tiles * B) return;
  const long long t = idx / B;
  const int r = (int)(idx % B);
  const long long g_end = min(n64, (t + 1) * per_tile);
  float zm = -INFINITY, cm = -INFINITY;
  for (long long g = t * per_tile; g < g_end; ++g) {
    zm = fmaxf(zm, stats[g * B + r]);
    cm = fmaxf(cm, stats[(n64 + g) * B + r]);
  }
  maxz[idx] = zm;
  maxcos[idx] = cm;
}

// ------------------------------------------------------- backward: f32 pass

// four consecutive momentum values as f32, and stored back each rounded
// once to the storage type
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
  *reinterpret_cast<uint2*>(p) = make_uint2(*reinterpret_cast<const unsigned*>(&lo),
                                            *reinterpret_cast<const unsigned*>(&hi));
}

// The f32 backward (margin_bwd_f32_kernel, module header): one pass, a block
// owns whole 64-column tiles with every batch row, 16 warps, one block an SM
constexpr int FB_ROWS = 128, FB_TC = 64, FB_THREADS = 512;
constexpr int FB_NST = 2, FB_FK = 32;  // the cosines' emb stages, features a chunk
constexpr int FB_EK = 15, FB_ENST = 2;  // d_w_hat: emb rows a stage, stages
constexpr int FB_QLD = FB_ROWS + 4;    // (d_cos * inv)^T's row stride: one row a tile column
constexpr int FB_DEMB = 0, FB_DW = 1, FB_SGD = 2;  // what the pass writes besides d_emb

// the stages at feature width D: the cosines' emb stages, then d_w_hat's,
// then the row groups' partials of <d_w_hat, w_hat> [32][FB_TC]
constexpr int FB_XSTG = ftile_stage_floats<FB_ROWS, FB_NST, FB_FK>();
__host__ __device__ constexpr int fb_stg_floats(int D) {
  return FB_XSTG > FB_ENST * FB_EK * (D + 4) ? FB_XSTG : FB_ENST * FB_EK * (D + 4);
}
static_assert(32 * FB_TC <= FB_XSTG, "the row groups' partials reuse the stages");
// shared memory of the f32 pass at feature width D: the W tile [FB_TC][D +
// 4], the stages, (d_cos * inv)^T, 1 / ||w|| and <d_w_hat, w_hat> of the
// tile's columns, the rows' inputs and targets
__host__ __device__ constexpr int fb_smem(int D) {
  return 4 * (FB_TC * (D + 4) + fb_stg_floats(D) + FB_TC * FB_QLD + 2 * FB_TC) +
         FB_ROWS * (int)(sizeof(RowIn) + sizeof(int));
}
static_assert(fb_smem(512) <= 232448, "the f32 pass fits a block's shared memory at D = 512");

// the cosine map: warp w holds row groups 4 (w % 8) .. + 3 and column groups
// 8 (w / 8) .. + 7, so the eight threads of a quarter warp read one emb row
// (a broadcast) and eight consecutive W rows; row group g: rows g + 32 i (i
// < 4), column group g: columns g + 16 j (j < 4)
__device__ __forceinline__ void fb_cos_map(int& gr, int& gc) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  gr = 4 * (warp & 7) + (lane >> 3);
  gc = 8 * (warp >> 3) + (lane & 7);
}

// the raw dots of the f32 pass, emb rows r_base + gr + 32 i (the first nr
// valid) with the tile's columns gc + 16 j, class rows p0 .. p0 + n - 1
// staged into Wt [FB_TC][D + 4], and of thread t < FB_TC ||w||^2 of column t
__device__ __forceinline__ void fb_dots(float (&acc)[4][4], float& n2, float* stg, float* Wt,
                                        const Args& a, int r_base, int nr, long long p0, int n,
                                        int gr, int gc) {
  ftile_dots<FB_ROWS, FB_TC, FB_THREADS, FB_NST, FB_FK, 4, 4, 32, 16>(
      acc, n2, stg, Wt, a.emb, r_base, nr, wrows<float>(a), p0, n, a.D, gr, gc);
}

// part [gridDim.x][B][D]: each block's d_emb partial over its columns.
// MODE FB_DW: d_w to dw (row by logical column), each column's owner adding
// d_wl [B][D] (the label rows' gradient) for every batch row labelled with
// it, in batch order; dgt: nullptr, or [B] zeros where the owner of a row's
// target column writes that column's dz. FB_SGD: the SGD update applied to
// sgd.w and sgd.mom (type TM) in place instead. FB_DEMB: d_emb alone.
// GROUPS (B > FB_ROWS): each tile's cosines, d_cos and d_w_hat product run
// over the batch in row groups of FB_ROWS, in batch order, before the
// epilogue, and the pass forms no d_emb (part unused): the d_emb pass
// (margin_bwd_demb_f32_kernel) runs before it.
template <class TM, int MODE, bool GROUPS>
__global__ void __launch_bounds__(FB_THREADS, 1)
    margin_bwd_f32_kernel(Args a, BwdRows br, long long cols_per_blk, const float* dwl,
                          float* dw, Sgd sgd, float* dgt, float* part) {
  static_assert(!GROUPS || MODE != FB_DEMB, "the row-group pass writes d_w or the update");
  extern __shared__ __align__(16) float fb_sm[];
  const int D = a.D, wld = D + 4;
  float* w_upd = static_cast<float*>(sgd.w);
  TM* mom = static_cast<TM*>(sgd.mom);
  float* Wt = fb_sm;                                     // the W tile [FB_TC][D + 4]
  float* stg = Wt + FB_TC * wld;                         // the stages
  float* red = stg;                                      // [32][FB_TC] partials of <d_w_hat, w_hat>
  float* Dq = stg + fb_stg_floats(D);                    // (d_cos * inv)^T [FB_TC][FB_QLD]
  float* inv = Dq + FB_TC * FB_QLD;                      // [FB_TC]
  float* sdot = inv + FB_TC;                             // [FB_TC] <d_w_hat, w_hat>
  RowIn* rin = reinterpret_cast<RowIn*>(sdot + FB_TC);  // [FB_ROWS]: the row group's
  int* tgt = reinterpret_cast<int*>(rin + FB_ROWS);      // label - p0 in this tile, else -1

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long c_begin = (long long)blockIdx.x * cols_per_blk;
  const long long c_end = min(a.ncols, c_begin + cols_per_blk);
  const int n_grp = GROUPS ? (a.B + FB_ROWS - 1) / FB_ROWS : 1;
  float* pblk = part + (long long)blockIdx.x * a.B * D;
  if (!GROUPS) load_row_in(rin, FB_ROWS, 0, a, br);  // thread t < FB_ROWS writes row t
  int gr, gc;
  fb_cos_map(gr, gc);
  // the d_w_hat map: warp w holds the columns 8 (w % 8) .. + 7, and lane l
  // the features 4 (32 (w / 8) + l) + 256 h .. + 3 (h < 2) below D
  const int g2 = warp & 7, fx = 32 * (warp >> 3) + lane;
  // the d_emb map: warp w holds row groups 4 (w % 4) .. + 3 and feature
  // groups 8 (w / 4) .. + 7; row group g: rows 8 g .. 8 g + 7; feature group
  // f: features 4 f + 128 q .. + 3 (q < 2) of a 256-feature half
  const int g3 = 4 * (warp & 3) + (lane >> 3), fx3 = 8 * (warp >> 2) + (lane & 7);
  bool first = true;  // the block's partial is written before it is read

  for (long long t0 = c_begin; t0 < c_end;) {
    const int nl = (int)min((long long)FB_TC, c_end - t0);  // output rows of this tile
    const long long p0 = phys_col(a, t0);
    const int n = valid_cols(a, t0, p0, t0 + nl, FB_TC);  // ... that stand for a class
    bool tile_tgt = false;
    float acc3[8][8];  // inv * d_w_hat [column][4 h + feature], summed over the batch in order
    for (int g = 0; g < n_grp; ++g) {
      const int rb = g * FB_ROWS, nr = min(FB_ROWS, a.B - rb);  // the row group
      if constexpr (GROUPS) {
        __syncthreads();  // the previous group's reads of rin, tgt, the stages and Wt are done
        load_row_in(rin, FB_ROWS, rb, a, br);  // fb_dots' barriers publish it
      }
      bool hit = false;
      if (MODE != FB_DEMB && tid < FB_ROWS) {
        const RowIn v = rin[tid];
        const long long off = (long long)v.lab - p0;
        hit = v.lab >= 0 && off >= 0 && off < n;
        tgt[tid] = hit ? (int)off : -1;
        if (hit && dgt != nullptr)  // the target column's dz: (p_t - 1) d_ce scale
          dgt[rb + tid] = (expf(a.scale * phi_target(v.gt, a) - v.lz) - 1.f) * v.dce * a.scale;
      }
      {
        float acc[4][4], n2;
        fb_dots(acc, n2, stg, Wt, a, rb, nr, p0, n, gr, gc);
        if (tid < FB_TC) inv[tid] = inv_norm(n2);
        __syncthreads();  // inv is visible
        float sp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int b = gr + 32 * i;  // the group's row
          const RowIn v = rin[b];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = gc + 16 * j;
            float d = 0.f;
            if (b < nr && c < n) {
              const float cv = acc[i][j] * inv[c];
              d = dcos_of(cv, p0 + c, v.lab, v.gt, v.lz, v.kth, v.dce, v.dneg, a);
              sp[j] = fmaf(d, cv, sp[j]);
            }
            Dq[c * FB_QLD + b] = d * inv[c];  // folds w_hat = inv * w into both products
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) red[gr * FB_TC + gc + 16 * j] = sp[j];
      }
      tile_tgt = __syncthreads_or(hit) || tile_tgt;  // Dq, red and tgt are visible

      if constexpr (MODE != FB_DEMB) {
        if (tid < FB_TC) {  // the row groups' sums in batch order
          float s = g == 0 ? 0.f : sdot[tid];
          for (int y = 0; y < 32; ++y) s += red[y * FB_TC + tid];
          sdot[tid] = s;
        }
        // inv * d_w_hat [FB_TC, D] += (d_cos * inv)^T . emb over the
        // group's rows in order, FB_EK emb rows a stage
        const int nbk = (nr + FB_EK - 1) / FB_EK;
        auto load = [&](int bk) {
          if (bk < nbk)
            stage_f32<FB_THREADS>(stg + (bk % FB_ENST) * FB_EK * wld, wld, a.emb,
                                  rb + FB_EK * bk, min(FB_EK, nr - FB_EK * bk), FB_EK, D, 0, D);
          cp_async_commit();
        };
        __syncthreads();  // red is read: the stages are free; sdot is visible
        for (int s = 0; s < FB_ENST - 1; ++s) load(s);
        if (g == 0)
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc3[i][j] = 0.f;
        for (int bk = 0; bk < nbk; ++bk) {
          cp_async_wait<FB_ENST - 2>();
          __syncthreads();  // stage bk has landed; stage bk - 1 is free
          load(bk + FB_ENST - 1);
          const float* Eb = stg + (bk % FB_ENST) * FB_EK * wld;
          const float* Dqb = Dq + 8 * g2 * FB_QLD + FB_EK * bk;
          const int nb = min(FB_EK, nr - FB_EK * bk);
#pragma unroll 2
          for (int bb = 0; bb < nb; ++bb) {
            float dv[8];
#pragma unroll
            for (int i = 0; i < 8; ++i) dv[i] = Dqb[i * FB_QLD + bb];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              if (4 * fx + 256 * h >= D) continue;
              const float4 e = *reinterpret_cast<const float4*>(Eb + bb * wld + 4 * fx + 256 * h);
#pragma unroll
              for (int i = 0; i < 8; ++i) {
                acc3[i][4 * h] = fmaf(dv[i], e.x, acc3[i][4 * h]);
                acc3[i][4 * h + 1] = fmaf(dv[i], e.y, acc3[i][4 * h + 1]);
                acc3[i][4 * h + 2] = fmaf(dv[i], e.z, acc3[i][4 * h + 2]);
                acc3[i][4 * h + 3] = fmaf(dv[i], e.w, acc3[i][4 * h + 3]);
              }
            }
          }
        }
        cp_async_wait<0>();
      }
    }

    if constexpr (MODE != FB_DEMB) {
      // d_w = inv * (d_w_hat - w_hat <d_w_hat, w_hat>), in place, the
      // stored rows from the tile
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int t = 8 * g2 + i;
        if (t >= n) continue;
        const float iv = inv[t], sd = sdot[t];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int f = 4 * fx + 256 * h;
          if (f >= D) continue;
          const float4 w4 = *reinterpret_cast<const float4*>(Wt + t * wld + f);
          const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc3[i][4 * h + e] = acc3[i][4 * h + e] - wv[e] * iv * (iv * sd);
        }
      }
      // + the label rows' d_wl, group by group in batch order (GROUPS: each
      // group's targets found anew from the labels)
      if (tile_tgt)
        for (int g = 0; g < n_grp; ++g) {
          const int rb = g * FB_ROWS, nr = min(FB_ROWS, a.B - rb);
          if constexpr (GROUPS) {
            __syncthreads();  // every read of the previous group's tgt is done
            if (tid < FB_ROWS) {
              const int lab = tid < nr ? a.labels[rb + tid] : -1;
              const long long off = (long long)lab - p0;
              tgt[tid] = lab >= 0 && off >= 0 && off < n ? (int)off : -1;
            }
            __syncthreads();
          }
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int t = 8 * g2 + i;
            if (t >= n) continue;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int f = 4 * fx + 256 * h;
              if (f >= D) continue;
              for (int b = 0; b < nr; ++b)
                if (tgt[b] == t)
#pragma unroll
                  for (int e = 0; e < 4; ++e)
                    acc3[i][4 * h + e] += dwl[(long long)(rb + b) * D + f + e];
            }
          }
        }
      // d_w stored, or (FB_SGD) the update from the stored w and mom
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int t = 8 * g2 + i;
        if (t >= nl) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int f = 4 * fx + 256 * h;
          if (f >= D) continue;
          const long long off_out = (t0 + t) * D + f;  // the output row: logical column
          if (t >= n) {  // a selected ragged last tile's rows past C
            store4(dw + off_out, make_float4(0.f, 0.f, 0.f, 0.f));
            continue;
          }
          float g[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) g[e] = acc3[i][4 * h + e];
          if (MODE == FB_DW) {
            store4(dw + off_out, make_float4(g[0], g[1], g[2], g[3]));
            continue;
          }
          const float4 w4 = *reinterpret_cast<const float4*>(Wt + t * wld + f);
          const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
          const long long off = (p0 + t) * D + f;  // the class row
          const float4 m4 = load4(mom + off);
          float mv[4] = {m4.x, m4.y, m4.z, m4.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (sgd.wd != 0.f) g[e] += sgd.wd * wv[e];
            float upd = g[e];
            if (sgd.mu != 0.f) {
              mv[e] = sgd.mu * mv[e] + g[e];
              upd = sgd.nesterov ? g[e] + sgd.mu * mv[e] : mv[e];
            } else {
              mv[e] = g[e];
            }
            g[e] = wv[e] - sgd.lr * upd;  // w'
          }
          store4(mom + off, make_float4(mv[0], mv[1], mv[2], mv[3]));
          store4(w_upd + off, make_float4(g[0], g[1], g[2], g[3]));
        }
      }
    }

    // the block's d_emb partial += (d_cos * inv) . (the tile's stored rows),
    // column by column, 256 features at a time (one row group: GROUPS
    // leaves d_emb to its own pass)
    if constexpr (!GROUPS)
      for (int f0 = 0; f0 < D; f0 += 256) {
        float acc2[8][8];  // [row][4 q + feature]
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int r = 8 * g3 + i;
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int f = f0 + 4 * fx3 + 128 * q;
            const float4 v = first || r >= a.B || f >= D
                                 ? make_float4(0.f, 0.f, 0.f, 0.f)
                                 : *reinterpret_cast<const float4*>(pblk + (long long)r * D + f);
            acc2[i][4 * q] = v.x, acc2[i][4 * q + 1] = v.y;
            acc2[i][4 * q + 2] = v.z, acc2[i][4 * q + 3] = v.w;
          }
        }
#pragma unroll 4
        for (int c = 0; c < n; ++c) {
          const float* qp = Dq + c * FB_QLD + 8 * g3;
          const float4 qa = *reinterpret_cast<const float4*>(qp);
          const float4 qb = *reinterpret_cast<const float4*>(qp + 4);
          const float qv[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int f = f0 + 4 * fx3 + 128 * q;
            if (f >= D) continue;
            const float4 w = *reinterpret_cast<const float4*>(Wt + c * wld + f);
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              acc2[i][4 * q] = fmaf(qv[i], w.x, acc2[i][4 * q]);
              acc2[i][4 * q + 1] = fmaf(qv[i], w.y, acc2[i][4 * q + 1]);
              acc2[i][4 * q + 2] = fmaf(qv[i], w.z, acc2[i][4 * q + 2]);
              acc2[i][4 * q + 3] = fmaf(qv[i], w.w, acc2[i][4 * q + 3]);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int r = 8 * g3 + i;
          if (r >= a.B) continue;
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int f = f0 + 4 * fx3 + 128 * q;
            if (f < D)
              store4(pblk + (long long)r * D + f,
                     make_float4(acc2[i][4 * q], acc2[i][4 * q + 1], acc2[i][4 * q + 2],
                                 acc2[i][4 * q + 3]));
          }
        }
      }
    first = false;
    __syncthreads();  // Wt, the stages, Dq, inv, sdot and tgt are rebuilt by the next tile
    t0 += nl;
  }
  if (!GROUPS && first)  // a block without columns: its partial is 0
    for (long long i = tid; i < (long long)a.B * D; i += FB_THREADS) pblk[i] = 0.f;
}

// ---------------------------------------------------- backward: f32 d_emb pass

// Above FB_ROWS batch rows the f32 backward forms d_emb in a pass of its
// own, as quad_margin.cu's quad_bwd_f32_kernel does (the f32 pass's [B, D]
// d_emb partial a column-owning block, in global memory, would be 1 MiB a
// block at B = 512 and 132 MiB over the card: beyond L2): a block holds
// DF_RB rows x a column range, 8 warps, one block an SM, its d_emb partial
// [DF_RB, D] in registers (8 rows x 16 features a thread at D = 512). Per
// 64-column tile, ftile_dots stages the W tile once into [DF_TC][D + 4]
// while emb's rows stream from L2, and forms the raw dots (each cosine the
// forward's in-order fmaf chain) and ||w||^2; (d_cos * inv) goes to shared
// memory transposed, and d_emb += (d_cos * inv) . the stored tile. It runs
// before the d_w pass, so the fused update's d_emb reads W before any of it
// is written. One product more than the one pass (the cosines twice).
constexpr int DF_RB = 64, DF_TC = 64, DF_THREADS = 256, DF_NST = 2, DF_FK = 64;
constexpr int DF_QLD = DF_RB + 4;  // (d_cos * inv)^T's row stride: one row a tile column
constexpr int DF_STG = ftile_stage_floats<DF_RB, DF_NST, DF_FK>();

// shared memory at feature width D: the W tile, emb's stages, (d_cos *
// inv)^T, the tile's 1 / ||w|| and the rows' inputs
__host__ __device__ constexpr int demb_f32_smem(int D) {
  return 4 * (DF_TC * (D + 4) + DF_STG + DF_TC * DF_QLD + DF_TC) + DF_RB * (int)sizeof(RowIn);
}
static_assert(demb_f32_smem(512) <= 232448, "the f32 d_emb pass fits a block's shared memory");

// the cosine map: rows ax + 16 i, columns by + 16 j (i, j < 4); the eight
// threads of a quarter warp read one emb row (a broadcast) and eight
// consecutive W rows
__device__ __forceinline__ void df_cos_map(int& ax, int& by) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  ax = 4 * (warp >> 1) + (lane >> 3);
  by = 8 * (warp & 1) + (lane & 7);
}

__device__ __forceinline__ void df_dots(float (&acc)[4][4], float& n2, float* stg, float* Wt,
                                        const Args& a, int r_base, int nr, long long p0, int n,
                                        int ax, int by) {
  ftile_dots<DF_RB, DF_TC, DF_THREADS, DF_NST, DF_FK, 4, 4, 16, 16>(
      acc, n2, stg, Wt, a.emb, r_base, nr, wrows<float>(a), p0, n, a.D, ax, by);
}

// part [nchunk][B][D]: each block's d_emb partial of its rows over its
// column chunk (row groups of a chunk adjacent in launch order)
__global__ void __launch_bounds__(DF_THREADS, 1)
    margin_bwd_demb_f32_kernel(Args a, BwdRows br, long long cols_per_chunk, int n_rg,
                               float* part) {
  extern __shared__ __align__(16) float df_sm[];
  const int D = a.D, wld = D + 4;
  float* Wt = df_sm;                 // the W tile [DF_TC][D + 4]
  float* stg = Wt + DF_TC * wld;     // emb's stages
  float* Dq = stg + DF_STG;          // (d_cos * inv)^T [DF_TC][DF_QLD]
  float* inv = Dq + DF_TC * DF_QLD;  // [DF_TC]
  RowIn* rin = reinterpret_cast<RowIn*>(inv + DF_TC);  // [DF_RB]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = blockIdx.x % n_rg, chunk = blockIdx.x / n_rg;
  const int r_base = rg * DF_RB, nr = min(DF_RB, a.B - r_base);
  const long long c_begin = (long long)chunk * cols_per_chunk;
  const long long c_end = min(a.ncols, c_begin + cols_per_chunk);
  load_row_in(rin, DF_RB, r_base, a, br);  // published by df_dots' barriers
  int ax, by;
  df_cos_map(ax, by);
  // the d_emb map: thread t holds the rows er .. er + 7 and the features
  // ef + 128 q .. + 3 (q < 4) below D; a quarter warp reads one d_cos
  // column's 8 rows (a broadcast) and 32 consecutive features of one W row
  const int er = 8 * (4 * (warp & 1) + (lane >> 3)), ef = 4 * (8 * (warp >> 1) + (lane & 7));
  float demb[8][16];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int f = 0; f < 16; ++f) demb[i][f] = 0.f;

  for (long long t0 = c_begin; t0 < c_end; t0 += DF_TC) {
    const int nl = (int)min((long long)DF_TC, c_end - t0);
    const long long p0 = phys_col(a, t0);
    const int n = valid_cols(a, t0, p0, t0 + nl, DF_TC);
    float acc[4][4], n2;
    df_dots(acc, n2, stg, Wt, a, r_base, nr, p0, n, ax, by);
    if (tid < DF_TC) inv[tid] = inv_norm(n2);
    __syncthreads();  // inv is visible
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int lr = ax + 16 * i;
      const RowIn v = rin[lr];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = by + 16 * j;
        float d = 0.f;
        if (lr < nr && c < n)
          d = dcos_of(acc[i][j] * inv[c], p0 + c, v.lab, v.gt, v.lz, v.kth, v.dce, v.dneg, a);
        Dq[c * DF_QLD + lr] = d * inv[c];
      }
    }
    __syncthreads();  // Dq is complete

    // demb += (d_cos * inv) . the stored tile, column by column in order
#pragma unroll 4
    for (int c = 0; c < n; ++c) {
      const float4 dlo = *reinterpret_cast<const float4*>(Dq + c * DF_QLD + er);
      const float4 dhi = *reinterpret_cast<const float4*>(Dq + c * DF_QLD + er + 4);
      const float dv[8] = {dlo.x, dlo.y, dlo.z, dlo.w, dhi.x, dhi.y, dhi.z, dhi.w};
      const float* wrow = Wt + c * wld + ef;
      float wv[16];  // the column's features, 0 from D
#pragma unroll
      for (int fq = 0; fq < 4; ++fq) {
        const float4 w = ef + 128 * fq < D ? *reinterpret_cast<const float4*>(wrow + 128 * fq)
                                           : make_float4(0.f, 0.f, 0.f, 0.f);
        wv[4 * fq] = w.x, wv[4 * fq + 1] = w.y, wv[4 * fq + 2] = w.z, wv[4 * fq + 3] = w.w;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int f = 0; f < 16; ++f) demb[i][f] = fmaf(dv[i], wv[f], demb[i][f]);
    }
    __syncthreads();  // Wt, the stages and Dq are rebuilt by the next tile
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = er + i;
    if (r >= nr) continue;
    float* p = part + ((long long)chunk * a.B + r_base + r) * D + ef;
#pragma unroll
    for (int fq = 0; fq < 4; ++fq)
      if (ef + 128 * fq < D)
        *reinterpret_cast<float4*>(p + 128 * fq) = make_float4(
            demb[i][4 * fq], demb[i][4 * fq + 1], demb[i][4 * fq + 2], demb[i][4 * fq + 3]);
  }
}

constexpr int E_RB = 64, E_TC = 64;  // bf16 d_emb pass: rows, tile columns

// shared memory of the bf16 d_emb pass at feature width D: the block's emb
// rows, two W tiles, bf16(d_cos), the tile's 1 / ||w||, the rows' inputs
__host__ __device__ constexpr int demb_bf16_smem(int D) {
  return E_RB * D * 2 + 2 * E_TC * D * 2 + E_RB * E_TC * 2 + E_TC * 4 +
         E_RB * (int)sizeof(RowIn);
}

// The bf16 d_emb pass (module header), every bf16 form's. inv_ready: a.inv
// holds 1 / ||w|| of every logical column; else each tile's comes from its
// staged rows.
__global__ void __launch_bounds__(BW_THREADS, 1)
    margin_bwd_demb_bf16_kernel(Args a, BwdRows br, long long cols_per_chunk, int n_rg,
                                int inv_ready, float* part) {
  extern __shared__ __align__(16) unsigned char demb_sm[];
  const int D = a.D, rcd = D / 8;
  const __nv_bfloat16* W = wrows<__nv_bfloat16>(a);
  unsigned char* Es = demb_sm;                 // emb rows [E_RB][D]
  unsigned char* Ws = Es + E_RB * D * 2;       // W tiles [2][E_TC][D]: stored, then bf16(w_hat)
  unsigned char* Dq = Ws + 2 * E_TC * D * 2;   // bf16(d_cos) [E_RB][E_TC]
  float* inv = reinterpret_cast<float*>(Dq + E_RB * E_TC * 2);  // [E_TC]
  RowIn* rin = reinterpret_cast<RowIn*>(inv + E_TC);            // [E_RB]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int rg = blockIdx.x % n_rg, chunk = blockIdx.x / n_rg;
  const int r_base = rg * E_RB;
  const long long c_begin = (long long)chunk * cols_per_chunk;
  const long long c_end = min(a.ncols, c_begin + cols_per_chunk);
  const int n_tiles = c_end > c_begin ? (int)((c_end - c_begin + E_TC - 1) / E_TC) : 0;

  auto load_tile = [&](int ti) {  // tile ti into stage ti & 1
    const long long t0 = c_begin + (long long)ti * E_TC, p0 = phys_col(a, t0);
    stage_rows_bf16(Ws + (ti & 1) * E_TC * D * 2, W, p0, valid_cols(a, t0, p0, c_end, E_TC),
                    E_TC, D);
  };
  stage_rows_bf16(Es, a.eb, r_base, min(E_RB, a.B - r_base), E_RB, D);
  if (n_tiles > 0) load_tile(0);
  cp_async_commit();
  load_row_in(rin, E_RB, r_base, a, br);

  // the cosine map: warp w holds rows 16 (w % 4) .., columns 16 (w / 4) ..;
  // the d_emb map: rows 32 (w % 2) .., features 16 p .. 16 p + 15 of the
  // pairs of n8 tiles p = w / 2 + 8 i (i < 4; D / 16 pairs)
  const int m1 = (warp & 3) * 16, n1 = (warp >> 2) * 16;
  const int m2 = (warp & 1) * 32, q2 = warp >> 1, np = D / 16;
  float acc2[2][8][4] = {};

  for (int ti = 0; ti < n_tiles; ++ti) {
    const long long t0 = c_begin + (long long)ti * E_TC, p0 = phys_col(a, t0);
    const int n = valid_cols(a, t0, p0, c_end, E_TC);
    if (ti + 1 < n_tiles) load_tile(ti + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // tile ti (and the emb rows) landed; the row inputs are visible
    unsigned char* T = Ws + (ti & 1) * E_TC * D * 2;
    if (!inv_ready)
      row_inv_tile(T, n, D, inv);
    else if (tid < E_TC)
      inv[tid] = tid < n ? a.inv[t0 + tid] : 0.f;
    __syncthreads();
    scale_rows_bf16(T, E_TC, rcd, inv);
    __syncthreads();  // the tile holds bf16(w_hat)

    float acc1[1][2][4] = {};
    mma_nt<1, 2>(acc1, Es, rcd, m1, T, rcd, n1, D / 16);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int lr = m1 + g + 8 * h;
      const RowIn v = rin[lr];
#pragma unroll
      for (int ni = 0; ni < 2; ++ni) {
        const int c = n1 + 8 * ni + 2 * t;
        float d[2];
#pragma unroll
        for (int j = 0; j < 2; ++j)
          d[j] = r_base + lr < a.B && c + j < n
                     ? dcos_of(acc1[0][ni][2 * h + j], p0 + c + j, v.lab, v.gt, v.lz, v.kth,
                               v.dce, v.dneg, a)
                     : 0.f;
        *reinterpret_cast<__nv_bfloat162*>(Dq + swz(lr, c, E_TC / 8)) =
            __floats2bfloat162_rn(d[0], d[1]);
      }
    }
    __syncthreads();  // Dq is complete

    // d_emb += bf16(d_cos) . bf16(w_hat): each k16 step's product (16
    // columns) from a zero accumulator, added to d_emb in f32
#pragma unroll
    for (int ks = 0; ks < E_TC / 16; ++ks) {
      uint32_t av[2][4];
      load_a(av[0], Dq, E_TC / 8, m2, ks);
      load_a(av[1], Dq, E_TC / 8, m2 + 16, ks);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (q2 + 8 * i >= np) continue;
        uint32_t b[4];
        load_b_kn(b, T, rcd, 16 * (q2 + 8 * i), ks);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) mma_add(acc2[mi], 2 * i, av[mi], b);
      }
    }
    __syncthreads();  // the tile's stage and Dq are rebuilt next
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gr = r_base + m2 + 16 * mi + g + 8 * h;
      if (gr >= a.B) continue;
      float* p = part + ((long long)chunk * a.B + gr) * D + 2 * t;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (q2 + 8 * (j >> 1) < np)
          *reinterpret_cast<float2*>(p + 16 * (q2 + 8 * (j >> 1)) + 8 * (j & 1)) =
              make_float2(acc2[mi][j][2 * h], acc2[mi][j][2 * h + 1]);
    }
}

// d_emb = sum of the chunk partials in chunk order
__global__ void margin_bwd_demb_merge_kernel(int nchunk, long long n, const float* part,
                                             float* d_emb) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  float acc = 0.f;
  for (int c = 0; c < nchunk; ++c) acc += part[(long long)c * n + idx];
  d_emb[idx] = acc;
}

// -------------------------------------------------------- backward: d_w pass

constexpr int WB_ROWS = 128, WB_TC = 64;  // bf16 d_w pass: batch rows, tile columns
// what the bf16 d_w pass writes: d_w (margin_ce_bwd, margin_partial_bwd);
// the selected tiles' d_w rows and d_gt (the sparse backward); or the SGD
// update of W and mom in place, and no d_w (the fused backward)
constexpr int DW_DENSE = 0, DW_SPARSE = 1, DW_SGD = 2;

// shared memory of the bf16 d_w pass at feature width D: emb, the W tile,
// bf16(d_cos), the tile's 1 / ||w|| and <d_w_hat, w_hat> partials (eight
// feature groups), the rows' inputs, target offsets and the rows with a
// target in the tile
__host__ __device__ constexpr int dw_bf16_smem(int D) {
  return WB_ROWS * D * 2 + WB_TC * D * 2 + WB_ROWS * WB_TC * 2 + 9 * WB_TC * 4 +
         WB_ROWS * (int)sizeof(RowIn) + (2 * WB_ROWS + 1) * 4;
}

// two consecutive momentum values as f32, and stored back each rounded once
// to the storage type
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float2 v) { *reinterpret_cast<float2*>(p) = v; }
__device__ __forceinline__ void store2(__nv_bfloat16* p, float2 v) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v.x, v.y);
}

// mma_nt's product against a stored W tile B [n][k] (swizzled, rcb chunks a
// row) whose rows are scaled as they are read: each B fragment's pair of
// row n scaled by inv[n] and rounded once (scale_bf16x2), the operand
// bf16(w_hat) that scale_rows_bf16 writes, so the chain and its bits are
// mma_nt's on the scaled tile and the stored tile stays for the epilogue
template <int MI, int NI>
__device__ __forceinline__ void mma_nt_scaled(float (&acc)[MI][NI][4], const unsigned char* A,
                                              int rca, int m0, const unsigned char* B, int rcb,
                                              int n0, int n_ks, const float* inv) {
  static_assert(NI % 2 == 0, "B fragments load two n8 tiles at a time");
  const int lane = threadIdx.x & 31;
  float sc[NI];  // the thread's B rows n0 + 8 ni + lane / 4
#pragma unroll
  for (int ni = 0; ni < NI; ++ni) sc[ni] = inv[n0 + 8 * ni + (lane >> 2)];
#pragma unroll 4
  for (int ks = 0; ks < n_ks; ++ks) {
    uint32_t a[MI][4];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) load_a(a[mi], A, rca, m0 + 16 * mi, ks);
#pragma unroll
    for (int nj = 0; nj < NI / 2; ++nj) {
      uint32_t b[4];
      ldsm_x4(b, B + swz(n0 + 16 * nj + (lane & 7) + (lane >> 4) * 8,
                         ks * 16 + ((lane >> 3) & 1) * 8, rcb));
#pragma unroll
      for (int e = 0; e < 4; ++e) b[e] = scale_bf16x2(b[e], sc[2 * nj + (e >> 1)]);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        float p0[4], p1[4];
        mma_bf16_0(p0, a[mi], b[0], b[1]);
        mma_bf16_0(p1, a[mi], b[2], b[3]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[mi][2 * nj][e] += p0[e];
          acc[mi][2 * nj + 1][e] += p1[e];
        }
      }
    }
  }
}

// The bf16 d_w pass (module header), in its MODE. DW_DENSE: d_w [C][D] f32
// to dw. DW_SPARSE: the d_w rows [ncols][D] of the selected tiles to dw in
// logical order (rows that stand for no class as 0), and d_gt [B] (zeros
// from the caller) where the pass owns a row's target column. Both add each
// label row's d_wl [B][D] in the column's owner, in batch order, and write
// 1 / ||w|| of each logical column into inv_out for the d_emb pass. DW_SGD:
// the SGD update of sgd.w (== W) and sgd.mom (type TM) in place. GROUPS (B
// > WB_ROWS): emb cannot stay resident, so each tile's cosines, d_cos and
// d_w_hat product run over the batch in row groups of WB_ROWS, each
// group's emb rows staged into Es in turn (from L2), d_w_hat summed in the
// mma accumulators in batch order; the label rows' d_wl, group by group.
template <int MODE, class TM, bool GROUPS>
__global__ void __launch_bounds__(BW_THREADS, 1)
    margin_bwd_dw_bf16_kernel(Args a, BwdRows br, long long cols_per_blk, const float* dwl,
                              float* dw, float* inv_out, Sgd sgd, float* dgt) {
  extern __shared__ __align__(16) unsigned char dw_sm[];
  const int D = a.D, rcd = D / 8;
  const __nv_bfloat16* W = wrows<__nv_bfloat16>(a);
  __nv_bfloat16* w_upd = static_cast<__nv_bfloat16*>(sgd.w);
  TM* mom = static_cast<TM*>(sgd.mom);
  unsigned char* Es = dw_sm;                   // emb [WB_ROWS][D]: the row group's
  unsigned char* Ws = Es + WB_ROWS * D * 2;    // the W tile [WB_TC][D], as stored
  unsigned char* Dc = Ws + WB_TC * D * 2;      // bf16(d_cos) [WB_ROWS][WB_TC]
  float* inv = reinterpret_cast<float*>(Dc + WB_ROWS * WB_TC * 2);  // [WB_TC]
  float* sdp = inv + WB_TC;  // [8][WB_TC] <d_w_hat, w_hat> over each feature group
  RowIn* rin = reinterpret_cast<RowIn*>(sdp + 8 * WB_TC);  // [WB_ROWS]
  int* tgt = reinterpret_cast<int*>(rin + WB_ROWS);        // label - p0 in this tile, else -1
  int* hits = tgt + WB_ROWS;  // [1 + WB_ROWS]: how many rows have tgt >= 0, then they in order

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const long long c_begin = (long long)blockIdx.x * cols_per_blk;
  const long long c_end = min(a.ncols, c_begin + cols_per_blk);
  const int n_tiles = c_end > c_begin ? (int)((c_end - c_begin + WB_TC - 1) / WB_TC) : 0;
  const int n_grp = GROUPS ? (a.B + WB_ROWS - 1) / WB_ROWS : 1;

  // tile ti: the output rows of the logical columns [t0, t0 + nl), of which
  // the first n (returned) stand for the class rows p0 .. p0 + n - 1
  auto tile_at = [&](int ti, long long& t0, long long& p0, int& nl) {
    t0 = c_begin + (long long)ti * WB_TC;
    p0 = phys_col(a, t0);
    nl = (int)min((long long)WB_TC, c_end - t0);
    return valid_cols(a, t0, p0, c_end, WB_TC);
  };
  // the rows of the group at rb (nr of them) whose target lies in the
  // tile's n columns from p0, in batch order, into hits (one warp)
  auto list_hits = [&](int nr) {
    int cnt = 0;
    for (int r0 = 0; r0 < WB_ROWS; r0 += 32) {
      const bool in = r0 + lane < nr && tgt[r0 + lane] >= 0;
      const unsigned m = __ballot_sync(0xffffffffu, in);
      if (in) hits[1 + cnt + __popc(m & ((1u << lane) - 1u))] = r0 + lane;
      cnt += __popc(m);
    }
    if (lane == 0) hits[0] = cnt;
  };
  long long t0, p0;
  int nl;
  if (!GROUPS) stage_rows_bf16(Es, a.eb, 0, a.B, WB_ROWS, D);  // resident
  if (n_tiles > 0) {
    const int n = tile_at(0, t0, p0, nl);
    stage_rows_bf16(Ws, W, p0, n, WB_TC, D);
  }
  cp_async_commit();
  if (!GROUPS) load_row_in(rin, WB_ROWS, 0, a, br);

  // the cosine map: warp w holds rows 32 (w % 4) .., columns 16 (w / 4) ..;
  // the d_w_hat map: columns 32 (w % 2) .., features 16 p .. 16 p + 15 of
  // the pairs of n8 tiles p = w / 2 + 8 i (i < 4; D / 16 pairs), so a
  // column's features lie in eight warps (feature group w / 2)
  const int m0 = (warp & 3) * 32, n0 = (warp >> 2) * 16;
  const int m2 = (warp & 1) * 32, q2 = warp >> 1, np = D / 16;

  for (int ti = 0; ti < n_tiles; ++ti) {
    const int n = tile_at(ti, t0, p0, nl);
    cp_async_wait<0>();
    __syncthreads();  // the tile (and emb) landed
    row_inv_tile(Ws, n, D, inv);
    bool any_tgt = false;
    float dwh[2][8][4];  // d_w_hat, summed over the batch in order
    for (int gi = 0; gi < n_grp; ++gi) {
      const int rb = gi * WB_ROWS, nr = min(WB_ROWS, a.B - rb);  // the row group
      if constexpr (GROUPS) {
        __syncthreads();  // the previous group's reads of Es, Dc, rin and tgt are done
        stage_rows_bf16(Es, a.eb, rb, nr, WB_ROWS, D);
        cp_async_commit();
        load_row_in(rin, WB_ROWS, rb, a, br);
        cp_async_wait<0>();
        __syncthreads();  // the group's emb rows and inputs are visible
      }
      bool hit = false;
      if (tid < WB_ROWS) {
        const RowIn v = rin[tid];
        const long long off = (long long)v.lab - p0;
        hit = v.lab >= 0 && off >= 0 && off < n;
        tgt[tid] = hit ? (int)off : -1;
        if (MODE == DW_SPARSE && hit)  // the target column's dz: (p_t - 1) d_ce scale
          dgt[rb + tid] = (expf(a.scale * phi_target(v.gt, a) - v.lz) - 1.f) * v.dce * a.scale;
      }
      const bool group_tgt = __syncthreads_or(hit);  // inv and tgt visible
      any_tgt = any_tgt || group_tgt;
      if (!GROUPS && group_tgt && warp == 0) list_hits(WB_ROWS);
      if (MODE != DW_SGD && gi == 0 && tid < nl) inv_out[t0 + tid] = inv[tid];

      float acc[2][2][4] = {};
      mma_nt_scaled<2, 2>(acc, Es, rcd, m0, Ws, rcd, n0, D / 16, inv);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int b = m0 + 16 * mi + g + 8 * h;  // the group's row
          const RowIn v = rin[b];
#pragma unroll
          for (int ni = 0; ni < 2; ++ni) {
            const int c = n0 + 8 * ni + 2 * t;
            float d[2];
#pragma unroll
            for (int j = 0; j < 2; ++j)
              d[j] = b < nr && c + j < n
                         ? dcos_of(acc[mi][ni][2 * h + j], p0 + c + j, v.lab, v.gt, v.lz, v.kth,
                                   v.dce, v.dneg, a)
                         : 0.f;
            *reinterpret_cast<__nv_bfloat162*>(Dc + swz(b, c, WB_TC / 8)) =
                __floats2bfloat162_rn(d[0], d[1]);
          }
        }
      __syncthreads();  // Dc is complete

      // d_w_hat += bf16(d_cos)^T . bf16(emb): each k16 step's product (16
      // batch rows) from a zero accumulator, added in f32
      if (gi == 0)
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) dwh[mi][j][e] = 0.f;
      const int nb = (nr + 15) / 16;  // k16 steps over the group's rows
      for (int ks = 0; ks < nb; ++ks) {
        uint32_t av[2][4];
        load_a_t(av[0], Dc, WB_TC / 8, m2, ks);
        load_a_t(av[1], Dc, WB_TC / 8, m2 + 16, ks);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (q2 + 8 * i >= np) continue;
          uint32_t bf[4];
          load_b_kn(bf, Es, rcd, 16 * (q2 + 8 * i), ks);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) mma_add(dwh[mi], 2 * i, av[mi], bf);
        }
      }
    }

    // the stored values of the thread's d_w elements (column c: m2 + 16 mi +
    // g + 8 h; features fj + 2 t, + 1 of its n8 tiles j: fj = 16 (q2 + 8 (j
    // / 2)) + 8 (j % 2)) from the tile, read for <d_w_hat, w_hat> and again
    // in the epilogue
    auto feat = [&](int j) { return 16 * (q2 + 8 * (j >> 1)) + 8 * (j & 1) + 2 * t; };
    auto stored = [&](int c, int j) {
      const unsigned char* p = Ws + swz(c, feat(j), rcd);
      return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    };

    // <d_w_hat, w_hat> of each column from its finished row against the f32
    // w_hat = w * inv: the thread's features, its row's four lanes, then the
    // eight warps of the row in order
    float sd[2][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = m2 + 16 * mi + g + 8 * h;
        const float iv = inv[c];
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (q2 + 8 * (j >> 1) >= np || c >= n) continue;
          const float2 wf = stored(c, j);
          s = fmaf(dwh[mi][j][2 * h], wf.x * iv, s);
          s = fmaf(dwh[mi][j][2 * h + 1], wf.y * iv, s);
        }
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        sd[mi][h] = s;
      }
    if (t == 0)
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) sdp[q2 * WB_TC + m2 + 16 * mi + g + 8 * h] = sd[mi][h];
    __syncthreads();

    // d_w = inv * (d_w_hat - w_hat <d_w_hat, w_hat>) of the thread's row
    // (mi, h), in place of d_w_hat
    auto finish_row = [&](int mi, int h) {
      const int c = m2 + 16 * mi + g + 8 * h;
      const float iv = inv[c];
      float s = 0.f;
      for (int q = 0; q < 8; ++q) s += sdp[q * WB_TC + c];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 wf = q2 + 8 * (j >> 1) < np ? stored(c, j) : make_float2(0.f, 0.f);
        dwh[mi][j][2 * h] = iv * (dwh[mi][j][2 * h] - wf.x * iv * s);
        dwh[mi][j][2 * h + 1] = iv * (dwh[mi][j][2 * h + 1] - wf.y * iv * s);
      }
    };
    // + the label rows' d_wl of the group at rb listed in hits, in batch order
    auto add_dwl = [&](int mi, int h, int rb) {
      const int c = m2 + 16 * mi + g + 8 * h;
      for (int k = 1; k <= hits[0]; ++k) {
        const int b = hits[k];
        if (tgt[b] != c) continue;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (q2 + 8 * (j >> 1) >= np) continue;
          const float2 l = *reinterpret_cast<const float2*>(dwl + (long long)(rb + b) * D + feat(j));
          dwh[mi][j][2 * h] += l.x;
          dwh[mi][j][2 * h + 1] += l.y;
        }
      }
    };
    // GROUPS: every row's d_w first, then the label rows' d_wl group by
    // group in batch order, each group's targets found anew from the labels
    // (one group: both per row below, after the row's momentum loads)
    if constexpr (GROUPS) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (m2 + 16 * mi + g + 8 * h < n) finish_row(mi, h);
      if (any_tgt)
        for (int gi = 0; gi < n_grp; ++gi) {
          const int rb = gi * WB_ROWS, nr = min(WB_ROWS, a.B - rb);
          __syncthreads();  // every read of the previous group's list is done
          if (tid < WB_ROWS) {
            const int lab = tid < nr ? a.labels[rb + tid] : -1;
            const long long off = (long long)lab - p0;
            tgt[tid] = lab >= 0 && off >= 0 && off < n ? (int)off : -1;
          }
          __syncthreads();
          if (warp == 0) list_hits(nr);
          __syncthreads();
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              if (m2 + 16 * mi + g + 8 * h < n) add_dwl(mi, h, rb);
        }
    }

    // d_w stored; DW_SGD: g = d_w + wd * w, mom' = mu * mom + g, upd = g +
    // mu * mom' (Nesterov) | mom' | g (mu = 0), w' = w - lr * upd, from the
    // stored w and mom, each of w' and mom' rounded once to its storage type
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = m2 + 16 * mi + g + 8 * h;
        if (c >= nl) continue;
        float* out = dw + (t0 + c) * D;  // the output row: logical column
        if (c >= n) {  // a selected tile's rows past C, or of a tile index out of range
          if constexpr (MODE == DW_SPARSE)
#pragma unroll
            for (int j = 0; j < 8; ++j)
              if (q2 + 8 * (j >> 1) < np) store2(out + feat(j), make_float2(0.f, 0.f));
          continue;
        }
        // DW_SGD: the row's momentum values, all loads in flight before the
        // first store (and, one group, before the row's d_w is formed)
        float2 mv[8];
        if constexpr (MODE == DW_SGD)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            mv[j] = q2 + 8 * (j >> 1) < np && sgd.mu != 0.f ? load2(mom + (p0 + c) * D + feat(j))
                                                              : make_float2(0.f, 0.f);
        if constexpr (!GROUPS) {
          finish_row(mi, h);
          if (any_tgt) add_dwl(mi, h, 0);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (q2 + 8 * (j >> 1) >= np) continue;
          float2 gv = make_float2(dwh[mi][j][2 * h], dwh[mi][j][2 * h + 1]);
          if constexpr (MODE != DW_SGD) {
            store2(out + feat(j), gv);
          } else {
            const float2 wf = stored(c, j);
            const long long off = (p0 + c) * D + feat(j);  // the class row
            if (sgd.wd != 0.f) gv = make_float2(gv.x + sgd.wd * wf.x, gv.y + sgd.wd * wf.y);
            float2 mn = gv, upd = gv;
            if (sgd.mu != 0.f) {
              mn = make_float2(sgd.mu * mv[j].x + gv.x, sgd.mu * mv[j].y + gv.y);
              upd = sgd.nesterov ? make_float2(gv.x + sgd.mu * mn.x, gv.y + sgd.mu * mn.y) : mn;
            }
            store2(mom + off, mn);
            store2(w_upd + off, make_float2(wf.x - sgd.lr * upd.x, wf.y - sgd.lr * upd.y));
          }
        }
      }
    __syncthreads();  // every warp is done with the tile: the next one's copies start
    if (ti + 1 < n_tiles) {
      long long t1, p1;
      int nl1;
      const int n1 = tile_at(ti + 1, t1, p1, nl1);
      stage_rows_bf16(Ws, W, p1, n1, WB_TC, D);
    }
    cp_async_commit();
  }
  cp_async_wait<0>();
}

// ------------------------------------------------------------ clean cosines

// out [B][C] = the bf16 cosines of every column (no labels read) as the
// forward's chunk staging forms them (chunk_cos, F_TC columns and a row
// group a block); 1 / ||w|| from a.inv
__global__ void __launch_bounds__(F_THREADS) clean_cos_chunk_kernel(Args a, float* out) {
  extern __shared__ __align__(16) unsigned char cc_sm[];
  float* inv = reinterpret_cast<float*>(cc_sm + CH_ST * chunk_bytes<F_ROWS, F_TC>());
  const int tid = threadIdx.x, warp = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
  const int r_base = blockIdx.y * F_ROWS;
  const long long t0 = (long long)blockIdx.x * F_TC;
  const int n = (int)min((long long)F_TC, a.C - t0);
  if (tid < F_TC) inv[tid] = tid < n ? a.inv[t0 + tid] : 0.f;
  const int wr = (warp & 3) * 32, wc = (warp >> 2) * (F_TC / 2);
  float acc[2][F_TC / 16][4];
  chunk_prologue<F_ROWS, F_TC>(a, cc_sm, r_base, t0, n);
  chunk_cos<F_ROWS, F_TC, F_TC / 16>(a, cc_sm, inv, r_base, t0, n, wr, wc, acc);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < F_TC / 16; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const long long r = r_base + wr + 16 * mi + g + 8 * (e >> 1);
        const int c = wc + 8 * ni + 2 * t + (e & 1);
        if (r < a.B && c < n) out[r * a.C + t0 + c] = acc[mi][ni][e];
      }
}

// ... and as the bf16 d_emb pass (ROWS = 64, a block per row group) and
// d_w pass (ROWS = 128) form them from whole staged tiles, 1 / ||w|| from
// the staged rows
template <int ROWS>
__global__ void __launch_bounds__(BW_THREADS) clean_cos_tile_kernel(Args a, float* out) {
  extern __shared__ __align__(16) unsigned char ct_sm[];
  constexpr int MI = ROWS / 64;
  const int D = a.D, rcd = D / 8;
  unsigned char* Es = ct_sm;              // emb rows [ROWS][D]
  unsigned char* Ws = Es + ROWS * D * 2;  // the W tile [64][D]
  float* inv = reinterpret_cast<float*>(Ws + 64 * D * 2);
  const int tid = threadIdx.x, warp = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
  const int r_base = blockIdx.y * ROWS;
  const long long t0 = (long long)blockIdx.x * 64;
  const int n = (int)min(64LL, a.C - t0);
  stage_rows_bf16(Es, a.eb, r_base, min(ROWS, a.B - r_base), ROWS, D);
  stage_rows_bf16(Ws, wrows<__nv_bfloat16>(a), t0, n, 64, D);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  row_inv_tile(Ws, n, D, inv);
  __syncthreads();
  scale_rows_bf16(Ws, 64, rcd, inv);
  __syncthreads();
  const int m0 = (warp & 3) * 16 * MI, n0 = (warp >> 2) * 16;
  float acc[MI][2][4] = {};
  mma_nt<MI, 2>(acc, Es, rcd, m0, Ws, rcd, n0, D / 16);
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const long long r = r_base + m0 + 16 * mi + g + 8 * (e >> 1);
        const int c = n0 + 8 * ni + 2 * t + (e & 1);
        if (r < a.B && c < n) out[r * a.C + t0 + c] = acc[mi][ni][e];
      }
}

// out [B][C] = the f32 cosines of every column (no labels read) as the f32
// kernels form them: the forward's product (fwd_dots_f32, 128 columns and
// a row group a block) and the backward's ftile_dots (64 columns and a row
// group a block: the f32 pass's 128 rows, or the d_emb pass's 64 rows
// above 128 batch rows)
__global__ void __launch_bounds__(F_THREADS) clean_cos_f32_fwd_kernel(Args a, float* out) {
  extern __shared__ __align__(16) unsigned char cf_sm[];
  float* inv = reinterpret_cast<float*>(cf_sm + F_NST * fwd_stage_bytes<float>());
  const int r_base = blockIdx.y * F_ROWS;
  const long long t0 = (long long)blockIdx.x * F_TC;
  const int n = (int)min((long long)F_TC, a.C - t0);
  int ax, by;
  fdots_map<F_ROWS, F_TC, F_TI, F_TJ>(ax, by);
  float acc[F_TI][F_TJ];
  fwd_prologue<float>(a, cf_sm, inv, r_base, t0, n);
  fwd_dots_f32(a, cf_sm, inv, r_base, t0, n, ax, by, acc);
#pragma unroll
  for (int i = 0; i < F_TI; ++i)
#pragma unroll
    for (int j = 0; j < F_TJ; ++j) {
      const long long r = r_base + ax + F_SA * i;
      const int c = by + F_SB * j;
      if (r < a.B && c < n) out[r * a.C + t0 + c] = acc[i][j] * inv[c];
    }
}

__global__ void __launch_bounds__(FB_THREADS, 1) clean_cos_f32_bwd_kernel(Args a, float* out) {
  extern __shared__ __align__(16) float cb_sm[];
  float* Wt = cb_sm;
  float* stg = Wt + FB_TC * (a.D + 4);
  float* inv = stg + FB_XSTG;
  const int r_base = blockIdx.y * FB_ROWS;
  const long long t0 = (long long)blockIdx.x * FB_TC;
  const int n = (int)min((long long)FB_TC, a.C - t0);
  int gr, gc;
  fb_cos_map(gr, gc);
  float acc[4][4], n2;
  fb_dots(acc, n2, stg, Wt, a, r_base, min(FB_ROWS, a.B - r_base), t0, n, gr, gc);
  if (threadIdx.x < FB_TC) inv[threadIdx.x] = inv_norm(n2);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long r = r_base + gr + 32 * i;
      const int c = gc + 16 * j;
      if (r < a.B && c < n) out[r * a.C + t0 + c] = acc[i][j] * inv[c];
    }
}

// ... as the f32 d_emb pass forms them (df_dots: 64 rows a block)
__global__ void __launch_bounds__(DF_THREADS, 1) clean_cos_f32_demb_kernel(Args a, float* out) {
  extern __shared__ __align__(16) float cd_sm[];
  float* Wt = cd_sm;
  float* stg = Wt + DF_TC * (a.D + 4);
  float* inv = stg + DF_STG;
  const int r_base = blockIdx.y * DF_RB;
  const long long t0 = (long long)blockIdx.x * DF_TC;
  const int n = (int)min((long long)DF_TC, a.C - t0);
  int ax, by;
  df_cos_map(ax, by);
  float acc[4][4], n2;
  df_dots(acc, n2, stg, Wt, a, r_base, min(DF_RB, a.B - r_base), t0, n, ax, by);
  if (threadIdx.x < DF_TC) inv[threadIdx.x] = inv_norm(n2);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long r = r_base + ax + 16 * i;
      const int c = by + 16 * j;
      if (r < a.B && c < n) out[r * a.C + t0 + c] = acc[i][j] * inv[c];
    }
}

Args make_args(const float* emb, const void* eb, const void* w, const float* inv, long long C,
               int D, int B, const int* labels, const float* gt, int k, int loss_type,
               float margin, float scale, float mask_svfc, float cos_m, float sin_m) {
  Args a;
  a.emb = emb;
  a.eb = static_cast<const __nv_bfloat16*>(eb);
  a.w = w;
  a.inv = inv;
  a.C = C;
  a.D = D;
  a.B = B;
  a.labels = labels;
  a.gt = gt;
  a.k = k;
  a.loss_type = loss_type;
  a.margin = margin;
  a.scale = scale;
  a.mask_svfc = mask_svfc;
  a.cos_m = cos_m;
  a.sin_m = sin_m;
  a.sel = nullptr;
  a.sel_tile = 0;
  a.ncols = C;
  return a;
}

// bf16 W: fill a.inv (1 / ||w|| per logical column) before the passes read it
int launch_inv(const Args& a, cudaStream_t st) {
  const long long threads = a.ncols * 32;
  inv_norm_bf16_kernel<<<(unsigned)((threads + 255) / 256), 256, 0, st>>>(a,
                                                                          const_cast<float*>(a.inv));
  return (int)cudaGetLastError();
}

// `kernel` with `smem` bytes of dynamic shared memory allowed
template <class K>
int allow_smem(K kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// the forward's block pass over nblk column ranges x the row groups (bf16
// W: 1 / ||w|| first), with the statistics where stats is not nullptr
template <class TW>
int launch_fwd_pass(const Args& a, int nblk, long long cols_per_blk, float* part, float* stats,
                    cudaStream_t st) {
  if (!std::is_same<TW, float>::value) {
    const int err = launch_inv(a, st);
    if (err != 0) return err;
  }
  constexpr int smem = fwd_smem<TW>();
  auto kernel = stats != nullptr ? margin_fwd_kernel<TW, true> : margin_fwd_kernel<TW, false>;
  const int err = allow_smem(kernel, smem);
  if (err != 0) return err;
  const int n_rg = (a.B + F_ROWS - 1) / F_ROWS;
  kernel<<<nblk * n_rg, f_threads<TW>(), smem, st>>>(a, cols_per_blk, n_rg, part, stats);
  return (int)cudaGetLastError();
}

int launch_fwd_pass_form(int w_bf16, const Args& a, int nblk, long long cols_per_blk,
                         float* part, float* stats, cudaStream_t st) {
  return w_bf16 ? launch_fwd_pass<__nv_bfloat16>(a, nblk, cols_per_blk, part, stats, st)
                : launch_fwd_pass<float>(a, nblk, cols_per_blk, part, stats, st);
}

// the f32 pass over nblk column ranges in its mode (FB_DEMB, FB_DW, FB_SGD;
// above FB_ROWS batch rows FB_DW or FB_SGD in row groups, no d_emb)
template <class TM>
int launch_f32_pass(int mode, const Args& a, const BwdRows& br, int nblk, long long cols_per_blk,
                    const float* dwl, float* dw, const Sgd& sgd, float* dgt, float* part,
                    cudaStream_t st) {
  const bool groups = a.B > FB_ROWS;
  if (groups && mode == FB_DEMB) return (int)cudaErrorInvalidValue;
  auto kernel = mode == FB_SGD  ? (groups ? margin_bwd_f32_kernel<TM, FB_SGD, true>
                                          : margin_bwd_f32_kernel<TM, FB_SGD, false>)
                : mode == FB_DW ? (groups ? margin_bwd_f32_kernel<float, FB_DW, true>
                                          : margin_bwd_f32_kernel<float, FB_DW, false>)
                                : margin_bwd_f32_kernel<float, FB_DEMB, false>;
  const size_t smem = fb_smem(a.D);
  const int e = allow_smem(kernel, smem);
  if (e != 0) return e;
  kernel<<<nblk, FB_THREADS, smem, st>>>(a, br, cols_per_blk, dwl, dw, sgd, dgt, part);
  return (int)cudaGetLastError();
}

// the bf16 d_w pass in its MODE (DW_DENSE, DW_SPARSE, DW_SGD) over nblk
// column ranges (above WB_ROWS batch rows, in row groups)
template <int MODE, class TM>
int launch_dw_bf16(const Args& a, const BwdRows& br, int nblk, long long cols_per_blk,
                   const float* dwl, float* dw, const Sgd& sgd, float* dgt, cudaStream_t st) {
  const size_t smem = dw_bf16_smem(a.D);
  auto kernel = a.B > WB_ROWS ? margin_bwd_dw_bf16_kernel<MODE, TM, true>
                              : margin_bwd_dw_bf16_kernel<MODE, TM, false>;
  const int e = allow_smem(kernel, smem);
  if (e != 0) return e;
  kernel<<<nblk, BW_THREADS, smem, st>>>(a, br, cols_per_blk, dwl, dw,
                                         const_cast<float*>(a.inv), sgd, dgt);
  return (int)cudaGetLastError();
}

// the f32 d_emb pass (above FB_ROWS batch rows) over nchunk column chunks x
// the row groups, then the merge of the chunks' partials
int launch_demb_f32(const Args& a, const BwdRows& br, float* part, int nchunk,
                    long long cols_per_chunk, float* d_emb, cudaStream_t st) {
  const size_t smem = demb_f32_smem(a.D);
  const int n_rg = (a.B + DF_RB - 1) / DF_RB;
  int e = allow_smem(margin_bwd_demb_f32_kernel, smem);
  if (e != 0) return e;
  margin_bwd_demb_f32_kernel<<<nchunk * n_rg, DF_THREADS, smem, st>>>(a, br, cols_per_chunk,
                                                                      n_rg, part);
  if ((e = (int)cudaGetLastError()) != 0) return e;
  const long long n = (long long)a.B * a.D;
  margin_bwd_demb_merge_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(nchunk, n, part,
                                                                            d_emb);
  return (int)cudaGetLastError();
}

// the backward. f32 W: the one pass (column owners, each with its d_emb
// partial), then the merge of the nchunk (= dw_nblk) partials; above
// FB_ROWS batch rows the d_emb pass (row groups of DF_RB rows x nchunk
// column chunks) and its merge, then the pass in row groups for d_w or the
// update (after the d_emb pass: it reads W before any of it is written).
// bf16 W: the
// d_emb pass (row groups of 64 rows x nchunk column chunks), the merge, and
// the d_w pass (column owners). The d_w pass runs first where it writes d_w
// (its 1 / ||w|| serves the d_emb pass), and last where it updates W in
// place (fused: the d_emb pass reads W before any of it is written, and
// takes 1 / ||w|| from its own tiles). grad_w=False: dw nullptr and not
// fused.
template <class TW, class TM>
int launch_bwd(const Args& a, const BwdRows& br, float* part, int nchunk,
               long long cols_per_chunk, float* d_emb, int dw_nblk, long long dw_cols_per_blk,
               const float* dwl, float* dw, const Sgd& sgd, int fused, float* dgt,
               cudaStream_t st) {
  const bool with_dw = dw != nullptr || fused;
  const long long n = (long long)a.B * a.D;
  int e = 0;
  if constexpr (std::is_same<TW, float>::value) {
    if (a.B > FB_ROWS) {
      if ((e = launch_demb_f32(a, br, part, nchunk, cols_per_chunk, d_emb, st)) != 0 || !with_dw)
        return e;
      return launch_f32_pass<TM>(fused ? FB_SGD : FB_DW, a, br, dw_nblk, dw_cols_per_blk, dwl,
                                 dw, sgd, dgt, nullptr, st);
    }
    e = launch_f32_pass<TM>(fused ? FB_SGD : with_dw ? FB_DW : FB_DEMB, a, br, dw_nblk,
                            dw_cols_per_blk, dwl, dw, sgd, dgt, part, st);
    if (e != 0) return e;
    margin_bwd_demb_merge_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(nchunk, n, part,
                                                                              d_emb);
    return (int)cudaGetLastError();
  } else {
    const bool dw_first = with_dw && !fused;
    if (dw_first)
      e = a.sel == nullptr ? launch_dw_bf16<DW_DENSE, float>(a, br, dw_nblk, dw_cols_per_blk, dwl,
                                                             dw, sgd, dgt, st)
                           : launch_dw_bf16<DW_SPARSE, float>(a, br, dw_nblk, dw_cols_per_blk,
                                                              dwl, dw, sgd, dgt, st);
    if (e != 0) return e;
    const size_t smem = demb_bf16_smem(a.D);
    const int n_rg = (a.B + E_RB - 1) / E_RB;
    if ((e = allow_smem(margin_bwd_demb_bf16_kernel, smem)) != 0) return e;
    margin_bwd_demb_bf16_kernel<<<nchunk * n_rg, BW_THREADS, smem, st>>>(
        a, br, cols_per_chunk, n_rg, (int)dw_first, part);
    if ((e = (int)cudaGetLastError()) != 0) return e;
    margin_bwd_demb_merge_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(nchunk, n, part,
                                                                              d_emb);
    if ((e = (int)cudaGetLastError()) != 0 || !fused) return e;
    return launch_dw_bf16<DW_SGD, TM>(a, br, dw_nblk, dw_cols_per_blk, dwl, nullptr, sgd, nullptr,
                                      st);
  }
}

// the unfused backward of either W form (the momentum type is unused)
int launch_bwd_form(int w_bf16, const Args& a, const BwdRows& br, float* part, int nchunk,
                    long long cols_per_chunk, float* d_emb, int dw_nblk,
                    long long dw_cols_per_blk, const float* dwl, float* dw, float* dgt,
                    cudaStream_t st) {
  const Sgd none = {nullptr, nullptr, 0.f, 0.f, 0.f, 0};
  return w_bf16 ? launch_bwd<__nv_bfloat16, float>(a, br, part, nchunk, cols_per_chunk, d_emb,
                                                   dw_nblk, dw_cols_per_blk, dwl, dw, none, 0,
                                                   dgt, st)
                : launch_bwd<float, float>(a, br, part, nchunk, cols_per_chunk, d_emb, dw_nblk,
                                           dw_cols_per_blk, dwl, dw, none, 0, dgt, st);
}

// the bf16 cosines in tiling 0 (the forward), 1 (the d_emb pass) or 2 (the
// d_w pass, every mode)
int launch_clean_cos(const Args& a, int tiling, float* out, cudaStream_t st) {
  int e = 0;
  if (tiling == 0) {
    if ((e = launch_inv(a, st)) != 0) return e;
    const size_t smem = CH_ST * chunk_bytes<F_ROWS, F_TC>() + F_TC * 4;
    if ((e = allow_smem(clean_cos_chunk_kernel, smem)) != 0) return e;
    const dim3 grid((unsigned)((a.C + F_TC - 1) / F_TC), (unsigned)((a.B + F_ROWS - 1) / F_ROWS));
    clean_cos_chunk_kernel<<<grid, F_THREADS, smem, st>>>(a, out);
  } else if (tiling == 1 || tiling == 2) {
    const int rows = tiling == 1 ? 64 : 128;
    const size_t smem = (size_t)(rows + 64) * a.D * 2 + 64 * 4;
    const dim3 grid((unsigned)((a.C + 63) / 64), (unsigned)((a.B + rows - 1) / rows));
    if (tiling == 1) {
      if ((e = allow_smem(clean_cos_tile_kernel<64>, smem)) != 0) return e;
      clean_cos_tile_kernel<64><<<grid, BW_THREADS, smem, st>>>(a, out);
    } else {
      if ((e = allow_smem(clean_cos_tile_kernel<128>, smem)) != 0) return e;
      clean_cos_tile_kernel<128><<<grid, BW_THREADS, smem, st>>>(a, out);
    }
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// the f32 cosines in tiling 0 (the forward) or 1, 2 (the backward's one
// pass, which every f32 backward form runs; above FB_ROWS batch rows 1 is
// the d_emb pass, 2 the pass in row groups)
int launch_clean_cos_f32(const Args& a, int tiling, float* out, cudaStream_t st) {
  int e = 0;
  if (tiling == 0) {
    const size_t smem = F_NST * fwd_stage_bytes<float>() + F_TC * 4;
    if ((e = allow_smem(clean_cos_f32_fwd_kernel, smem)) != 0) return e;
    const dim3 grid((unsigned)((a.C + F_TC - 1) / F_TC), (unsigned)((a.B + F_ROWS - 1) / F_ROWS));
    clean_cos_f32_fwd_kernel<<<grid, F_THREADS, smem, st>>>(a, out);
  } else if (tiling == 1 && a.B > FB_ROWS) {
    const size_t smem = sizeof(float) * (DF_TC * (a.D + 4) + DF_STG + DF_TC);
    if ((e = allow_smem(clean_cos_f32_demb_kernel, smem)) != 0) return e;
    const dim3 grid((unsigned)((a.C + DF_TC - 1) / DF_TC), (unsigned)((a.B + DF_RB - 1) / DF_RB));
    clean_cos_f32_demb_kernel<<<grid, DF_THREADS, smem, st>>>(a, out);
  } else if (tiling == 1 || tiling == 2) {
    const size_t smem = sizeof(float) * (FB_TC * (a.D + 4) + FB_XSTG + FB_TC);
    if ((e = allow_smem(clean_cos_f32_bwd_kernel, smem)) != 0) return e;
    const dim3 grid((unsigned)((a.C + FB_TC - 1) / FB_TC),
                    (unsigned)((a.B + FB_ROWS - 1) / FB_ROWS));
    clean_cos_f32_bwd_kernel<<<grid, FB_THREADS, smem, st>>>(a, out);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

#define MCE_COMMON_PARAMS                                                                       \
  const float *emb, const void *eb, const void *w, int w_bf16, float *inv, long long C, int D,  \
      int B, const int *labels, const float *gt, int k, int loss_type, float margin,             \
      float scale, float mask_svfc, float cos_m, float sin_m
#define MCE_COMMON_ARGS \
  emb, eb, w, inv, C, D, B, labels, gt, k, loss_type, margin, scale, mask_svfc, cos_m, sin_m
#define MCE_BWD_PARAMS                                                                          \
  const float *logz, const float *kth, const float *dce, const float *dneg, float *part,        \
      int nchunk, long long cols_per_chunk, float *d_emb, int dw_nblk, long long dw_cols_per_blk

extern "C" {

const char* margin_ce_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Every entry takes W as f32 (w_bf16 = 0, eb and inv nullptr) or bf16
// (w_bf16 = 1, emb rounded to bf16 by the caller and eb the same values
// stored as bf16 [B][D], inv a float scratch of one entry per logical
// column: C, or M * tile for the sparse backward).

// the forward's shared memory a block (bytes) of the W form:
// ops/margin_stream.py's fwd_geometry computes the same
int margin_fwd_smem(int w_bf16) { return w_bf16 ? fwd_smem<__nv_bfloat16>() : fwd_smem<float>(); }

// forward: nblk column ranges of cols_per_blk (a multiple of 128) columns;
// part is [2 * nblk][B][2 + 16] f32 scratch; outputs [B] and [B][k]. With
// stats (else nullptr): [2][ceil(C / 64)][B] f32 scratch, and the outputs
// maxz / maxcos [ceil(C / stats_tile)][B] (stats_tile a multiple of 64)
int margin_ce_fwd_launch(MCE_COMMON_PARAMS, float* part, int nblk, long long cols_per_blk,
                         float* ce, float* neg, float* logz, float* topk, float* stats,
                         int stats_tile, float* maxz, float* maxcos, void* stream) {
  const Args a = make_args(MCE_COMMON_ARGS);
  cudaStream_t st = (cudaStream_t)stream;
  int e = launch_fwd_pass_form(w_bf16, a, nblk, cols_per_blk, part, stats, st);
  if (e != 0) return e;
  margin_fwd_merge_kernel<<<(B + 127) / 128, 128, 0, st>>>(a, F_LANES * nblk, part, ce, neg,
                                                           logz, topk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || stats == nullptr) return (int)err;
  const long long n64 = (C + STAT_COLS - 1) / STAT_COLS;
  const long long n_tiles = (C + stats_tile - 1) / stats_tile, n = n_tiles * B;
  margin_fwd_stats_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      B, n64, stats_tile / STAT_COLS, n_tiles, stats, maxz, maxcos);
  return (int)cudaGetLastError();
}

// backward: part is [nchunk][B][D] f32 scratch (chunks of cols_per_chunk,
// a multiple of 64); d_w [C][D] f32 with the label rows' d_wl [B][D] added,
// or both nullptr for grad_w=False
int margin_ce_bwd_launch(MCE_COMMON_PARAMS, MCE_BWD_PARAMS, float* dw, const float* dwl,
                         void* stream) {
  const Args a = make_args(MCE_COMMON_ARGS);
  const BwdRows br = {logz, kth, dce, dneg};
  return launch_bwd_form(w_bf16, a, br, part, nchunk, cols_per_chunk, d_emb, dw_nblk,
                         dw_cols_per_blk, dwl, dw, nullptr, (cudaStream_t)stream);
}

// fused backward: w_upd (== w) and mom (bf16 when mom_bf16) are updated in
// place; d_wl [B][D]
int margin_ce_bwd_fused_sgd_launch(MCE_COMMON_PARAMS, MCE_BWD_PARAMS, void* w_upd, void* mom,
                                   int mom_bf16, const float* dwl, float lr, float momentum,
                                   int nesterov, float weight_decay, void* stream) {
  const Args a = make_args(MCE_COMMON_ARGS);
  const BwdRows br = {logz, kth, dce, dneg};
  const Sgd sgd = {w_upd, mom, lr, momentum, weight_decay, nesterov};
  cudaStream_t st = (cudaStream_t)stream;
#define MCE_FUSED(TW, TM)                                                                      \
  launch_bwd<TW, TM>(a, br, part, nchunk, cols_per_chunk, d_emb, dw_nblk, dw_cols_per_blk, dwl, \
                     nullptr, sgd, 1, nullptr, st)
  if (w_bf16) return mom_bf16 ? MCE_FUSED(__nv_bfloat16, __nv_bfloat16)
                              : MCE_FUSED(__nv_bfloat16, float);
  return mom_bf16 ? MCE_FUSED(float, __nv_bfloat16) : MCE_FUSED(float, float);
#undef MCE_FUSED
}

// sparse backward over the M tiles tile_idx [M] (distinct, each below
// ceil(C / tile)) of tile columns each, tile a multiple of 64: ncols =
// M * tile logical columns; part is [nchunk][B][D] scratch over them; d_w
// rows [ncols][D] f32 in tile_idx order, the label rows' d_wl [B][D] added
// by their owners; d_gt [B] zeros, the target column's dz written where
// its tile is selected
int margin_ce_bwd_sparse_launch(MCE_COMMON_PARAMS, MCE_BWD_PARAMS, const int* tile_idx, int tile,
                                long long ncols, float* dw_rows, const float* dwl, float* dgt,
                                void* stream) {
  Args a = make_args(MCE_COMMON_ARGS);
  a.sel = tile_idx;
  a.sel_tile = tile;
  a.ncols = ncols;
  const BwdRows br = {logz, kth, dce, dneg};
  return launch_bwd_form(w_bf16, a, br, part, nchunk, cols_per_chunk, d_emb, dw_nblk,
                         dw_cols_per_blk, dwl, dw_rows, dgt, (cudaStream_t)stream);
}

// one block's forward: the forward's block pass, then the partial merge into
// the raw m, s [B] and topk [B][k] (labels block-local, gt global)
int margin_partial_fwd_launch(MCE_COMMON_PARAMS, float* part, int nblk, long long cols_per_blk,
                              float* m, float* s, float* topk, void* stream) {
  const Args a = make_args(MCE_COMMON_ARGS);
  cudaStream_t st = (cudaStream_t)stream;
  const int e = launch_fwd_pass_form(w_bf16, a, nblk, cols_per_blk, part, nullptr, st);
  if (e != 0) return e;
  margin_partial_merge_kernel<<<(B + 127) / 128, 128, 0, st>>>(a, F_LANES * nblk, part, m, s,
                                                               topk);
  return (int)cudaGetLastError();
}

// one block's backward against the global logz / kth and cotangents masked
// with the global positive rows: d_emb's streamed part; d_w [C][D] with the
// owned label rows' d_wl [B][D] added by their owners, or both nullptr
int margin_partial_bwd_launch(MCE_COMMON_PARAMS, MCE_BWD_PARAMS, float* dw, const float* dwl,
                              void* stream) {
  const Args a = make_args(MCE_COMMON_ARGS);
  const BwdRows br = {logz, kth, dce, dneg};
  return launch_bwd_form(w_bf16, a, br, part, nchunk, cols_per_chunk, d_emb, dw_nblk,
                         dw_cols_per_blk, dwl, dw, nullptr, (cudaStream_t)stream);
}

// the cosines [B][C] of every column (no labels read) as tiling forms them
// (0 the forward, 1 the d_emb pass, 2 the d_w pass of every bf16 backward
// form; f32 W: 1 and 2 are the one pass): a parity probe of the chain they
// share
int margin_ce_clean_cos_launch(MCE_COMMON_PARAMS, int tiling, float* out, void* stream) {
  const Args a = make_args(MCE_COMMON_ARGS);
  if (!w_bf16) return launch_clean_cos_f32(a, tiling, out, (cudaStream_t)stream);
  if (eb == nullptr || inv == nullptr) return (int)cudaErrorInvalidValue;
  return launch_clean_cos(a, tiling, out, (cudaStream_t)stream);
}

}  // extern "C"
