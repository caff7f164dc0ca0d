// Fused FFC heads for NVIDIA Hopper (sm_90a): the quad head (both FFC
// directions x both queue views in one pass over q0) and the twin head (one
// direction x both views), forward and backward.
//
// Replaces the TPU kernels vlsfr_tpu/ops/twin_margin.py:pallas_quad_fwd
// (:1840) and :pallas_quad_bwd (:1891), their per-shard forms
// :pallas_quad_partial_fwd (:1676) and :pallas_quad_partial_bwd (:1748), and
// the twin kernels :pallas_twin_fwd (:786), :pallas_twin_bwd (:910),
// :pallas_twin_partial_fwd (:984) and :pallas_twin_partial_bwd (:1042).
// Semantics are those of the scan reference _twin_stream_fwd /
// _twin_stream_bwd there; the plain PyTorch versions beside the wrappers
// (vlsfr_tpu_torch/ops/twin_margin.py quad_[partial_]fwd_plain /
// quad_[partial_]bwd_plain, twin_[partial_]fwd_plain /
// twin_[partial_]bwd_plain) compute the same functions.
//
// Layout ("packed"): probe rows E [R = 2B, D], rows [0, B) direction A and
// [B, 2B) direction B; the writes of each direction come apart from its
// probes, BP per direction (BP = B on one device; under a data axis a shard
// holds B / data probes but the whole write plan): G (gallery writes), V
// (view-2 write values) [2 BP, D], rows / cols / blend [2 BP] int32;
// labels [R] int32; gt [2][R] (view-major); q0 is plane 0 of the queue (of
// the shard's block of it, for the partial forms). The twin head takes the
// same layout with one direction (R = B probes, BP writes; ND = 1). The
// F32 form's arithmetic is IEEE f32 FMA (no TF32); the other forms'
// products run on the tensor cores (below), INT8C's an exact int32 sum.
//
// Queue forms (template FORM; the wrapper's module docstring has the JAX
// rounding points each follows):
//  * F32:   q0 f32; E, G, V f32.
//  * BF16:  q0 bf16; E, G, V come rounded to bf16 (held in f32), so every
//           product is exact in f32 and the FMA chain computes what the TPU's
//           matrix unit computes, up to the order of summation.
//  * INT8:  q0 int8 with per-row scales qs [Q]; cos = (E . q) * qs[col], E
//           rounded to bf16 as above (int8 -> bf16 is exact).
//  * INT8C: as INT8, but the clean dot is E8 . q with E8 the per-row int8
//           probes (scales se [R]): an exact int32 sum (mma.sync s8 in
//           both passes: the same integer whatever the tiling), then
//           cos = f32(acc) * (se[row] * qs[col]).
// Written columns dot the bf16-rounded E with the bf16-rounded G / V rows in
// every form but F32. The backward rounds d_cos to bf16 before its product
// with a stored row (INT8/INT8C: bf16(d_cos * qs[col]) times the int8 row).
// The clean / written choice is JAX's, per tile of its kernel: the rounding
// tile rtile (a multiple of 64, resolved by the wrapper as JAX resolves its
// tile) — a 64-column compute tile is "written" when its direction writes
// any column of the enclosing [floor(t0 / rtile) * rtile, + rtile) span. A
// clean tile takes the quad's Arc/AM combined d_cos of both views
// (exp(z - ref) * c12 + the hard-negative terms), and the quad's SV and the
// twin's sum of the two views, rounded once; a written tile routes each
// view's d_cos to the row that view reads (BF16 rounds each view alone).
//
// The partial forms (the model-sharded head, parallel/sharded_quad.py)
// take shard-local columns and labels: a write column of -1 belongs to
// another shard and never matches a column here; a label of -1 is an
// outlier row and -2 a positive row whose target lies on another shard, so
// only the owner excludes the target column and only the owner's d_gt is
// nonzero (the caller sums d_gt over the shards). The partial forward
// writes each row's merged (max, sumexp, top-k) without the finalize; the
// caller merges the shards' states and adds the target term. The partial
// backward is the backward kernel fed the GLOBAL logz, kth and cotangents
// (d_neg zero on every globally positive row, so a -2 row's outlier test
// adds nothing).
//
// Bound (H100 SXM, 67 TFLOP/s f32, 989 TFLOP/s bf16 tensor cores, 3.35
// TB/s) at R = 256, D = 512, Q = 2^20: the f32 forward's 2*R*D*Q = 2.75e11
// FLOP take >= 4.1 ms while its 2.15 GB of q0 take >= 0.64 ms, so it is
// compute-bound; the backward does the cosine recompute plus d_cos @ q0,
// 5.5e11 FLOP, >= 8.2 ms. The bf16 form at Q = 4,194,304: 2.2e12 FLOP in
// the backward (>= 2.2 ms on the tensor cores) against 4.3 GB of q0
// (>= 1.3 ms): operations-bound. The int8 forms at Q = 10,485,760: 5.5e12
// operations in the backward (INT8 two bf16 products, >= 5.6 ms; INT8C the
// recompute at the int8 rate, >= 4.2 ms) against 5.4 GB of q0 (>= 1.6 ms):
// operations-bound. At the shipped 10M-identity config's batch (b = 512, R
// = 1024) the int8c forward's 2*R*D*Q = 1.10e13 int8 operations take >=
// 5.56 ms (q0's bytes 1.6 ms) and its backward >= 16.67 ms (the recompute
// at the int8 rate and the bf16 d_emb product).
//
// Rows: any B. Every kernel runs row groups (the forward 128 or 256 rows,
// the backward 64) over column ranges, so a larger batch adds row-group
// blocks and shortens each block's range; each q0 tile is then read by R /
// rows blocks, adjacent in launch order (through L2). The per-tile write
// plan (mark_writes) scans all ND * BP writes, so its cost grows with the
// batch (two loads a thread a tile at b = 512 in the tensor-core forward);
// the merge sums wcoef [R][2][BP] (32-bit indices up to R * 2 * BP < 2^31).
//
// Design.
//  * The TPU carried (m, s, top-k) and d_emb in VMEM across a sequential
//    grid; here blocks run in parallel, so every block writes a partial
//    over its own contiguous column range and a second launch merges the
//    partials in a fixed order (logsumexp merge, k-way top-k merge, sum of
//    d_emb partials). No float atomics: results are bit-stable.
//  * Forward (quad_fwd_kernel, every form): one block an SM, each a row
//    group over a column range. The F32 block holds 256 probe rows (all of R up
//    to R = 256, so each q0 tile is read once for both directions; 128 for R <=
//    128; above 256, row groups of 256 as below), and stages 32 features of E's
//    rows and of the q0 tile a chunk by 16-byte cp.async, two chunks in flight
//    beside the one in use; an 8 x 8 register micro-tile (8 x 4 at 128 rows)
//    reads four features a float4 load, each cosine one fmaf chain over the
//    features in index order from 0 (the backward's ftile_dots chain: the same
//    bits). The tensor-core forms' block holds 128 rows (a row group: the R /
//    128 row groups of a range are adjacent in launch order, and the later ones
//    read the q0 tiles from L2; any R) with its E rows resident in shared
//    memory (bf16, 128 KiB at D = 512; INT8C's E8, 64 KiB), so only the q0
//    tiles stream: restaged from L2 for every 64-column tile, E's rows were 4-8
//    times the q0 bytes. Per 64-column tile the product fills a cosine tile Cs
//    [ROWS][64 + 4]. Each probe row's stream is split over threads / ROWS
//    threads (lanes: 256 threads a block for F32, 512 for the tensor-core
//    forms; one quad
//    of 4 columns each in turn) and, within a lane, two (m, s) chains per
//    view, a pair of quads at a time: each quad's largest z, then the
//    chain rescaled to it and the four exp terms, 16 independent terms a
//    pair and no branch, so the pass is not one serial chain through expf;
//    the top-k insertions only where a column beats kth, a network of
//    selects (topk_push), every index constant, so the lists stay in
//    registers. The chains run in base 2 (z / ln 2, one MUFU exp2 a term)
//    and fold to base e, in a fixed order (lse_fold; the value-only top-k
//    lists merge exactly), at the end of the block's range. Tile t's row
//    pass runs between the products of tiles t and t + 1, with the first
//    chunks of tile t + 1 in flight (run as shares under each chunk of the
//    product instead, it was slower in every case: the shares lengthen
//    each chunk's path between two barriers).
//    The written columns' cosines come from wcos [R][2][BP], formed once a
//    launch by quad_written_cos_kernel (row_dot's chain over E and the
//    rows G / V as the dots read them), not in the tile loop: the port's
//    DCP planner hands out consecutive slots, so a step's writes gather in
//    a few tiles of one block, which ran R x 2 row_dots a written column.
//    What bounds it on an H100: F32 the FMA rate (the micro-tile reads 1
//    byte of shared memory per FMA, the 128 B a clock an SM the FMA rate
//    needs); the tensor-core forms the row pass's instructions (about 15
//    a column, view and row: 2.1e9 exp for the quad at Q = 4,194,304)
//    against the q0 bytes (tools/quad_fwd_variants.py times each phase).
//  * Backward, F32 (quad_bwd_f32_kernel; IEEE f32 FMA on the CUDA cores,
//    no TF32): a block holds 64 probe rows x a column range, 8 warps, one
//    block an SM (186 KiB of shared memory at D = 512), so each q0 tile is
//    read by R / 64 blocks (4 at the quad's R = 256, 2 at the twin's 128),
//    adjacent in launch order, which share it through L2; the grid is one
//    wave. Its d_emb partial [64, D] stays in registers over the whole
//    range (128 f32 a thread at D = 512: 8 rows x 16 features; 244
//    registers, no spill). Per 64-column tile, one staging for both
//    products: margin_common.cuh's ftile_dots stages the q0 tile by 16-byte
//    cp.async into [64][D + 4] (zero from c_end) while E's 64 rows stream
//    through two stages of 64 features from L2, and forms cos [64, 64] (4 x
//    4 a thread), each an fmaf chain over the features in index order from
//    0: the forward's chain, so the forward's bits for the top-k test
//    (quad_clean_cos_launch shows both tilings). d_cos, the two views'
//    dcos_col terms summed in f32, goes to shared memory transposed ([64
//    columns][64 + 4]); then d_emb += d_cos . the tile still staged, float4
//    loads of both operands, 128 FMAs for six 16-byte shared loads. The
//    written columns stay out of both products: their cosines come from
//    wcos [R][2][BP], formed once a launch by row_dot (the forward's
//    chain), and their d_cos towards the g / v row goes to wcoef [R][2][BP]
//    at (row, writer), which only that column's thread writes; the merge
//    adds wcoef . G / V (no atomics). What bounds it on an H100: shared
//    memory's 128 B a clock an SM. The cosine micro-tile reads 32 B for 16
//    FMAs (two 16-byte loads a feature step for each of 4 rows and 4
//    columns), so its product runs at most at half the f32 rate; the d_emb
//    product's 96 B for 128 FMAs leave it FMA-bound
//    (tools/quad_bwd_variants.py times each phase).
//  * This step's queue writes: per tile, the block finds for every column
//    the last (highest batch index) parity-0 writer and blend writer of
//    each direction (shared-memory atomicMax on the index: deterministic).
//    A written column's cosine is the probe's dot with that g (view 1) or
//    v (view 2) row; q1 is never read.
//  * Quad: target columns are excluded from the stream and the top-k; the
//    target term scale*phi(gt) joins at the merge (gt comes from outside).
//    Twin (a.twin): the block holding the target column adds z =
//    scale*phi(gt) to its stream, as JAX's twin kernels do, after its other
//    columns (the sum's order; see quad_fwd_kernel), so the merge adds
//    nothing (the partial form: only the owner shard sees its target); the
//    top-k still excludes it. d_gt is the target column's dz, (exp(z_t - logz) - 1) *
//    d_ce * scale, on rows whose (shard-local) label is >= 0 — the one
//    nonzero term of JAX's in-kernel sum; the quad computes the same.
//  * The forward block holds 256 probe rows (the quad's 2B) or, for R <=
//    128 (the twin's B), 128, so a twin tile costs half a quad tile.
//  * Shared with margin_ce.cu (margin_common.cuh): the margin transform,
//    the forward's row pass pieces (Lane, stream4, topk_push) and its F32
//    product (fdots_*), the partial merge, d_cos of a column and the
//    backward's f32 tile product (ftile_dots).
//  * The BF16 and INT8 forms on the tensor cores (mma.sync m16n8k16, csrc/
//    mma_bf16.cuh; operands staged in shared memory as bf16, swizzled for
//    conflict-free ldmatrix: by cp.async, an int8 tile widened to bf16 in
//    shared memory, exact). Their clean cosines are one chain over the
//    feature axis in k16 steps, in order, each step's product added in f32
//    (mma_bf16.cuh: kept in the tensor core's accumulator, the chain
//    drifted enough at D = 512 to put 20 d_emb rows beyond 1e-5 of the max,
//    against a limit of 8; with the f32 adds, 3), INT8 then times qs[col],
//    in the forward (E and q0 staged 64 features at a time, three stages,
//    INT8's q0 words loaded into registers under the previous chunk's
//    product and widened after it; warps of 32 rows x 64 or 32 columns)
//    and in the backward's recompute (E's 64 rows held whole,
//    warps of 16 rows x 32 columns), so that the two produce the same bits
//    and the backward's top-k test meets the forward's kth exactly
//    (quad_clean_cos_launch shows both tilings). INT8C's forward and
//    recompute are mma.sync m16n8k32 s8 on E8 and the int8 tile as staged
//    (the forward 128 features a chunk, zero past D): an exact int32 sum,
//    the same integer whatever the tiling.
//    Backward (quad_bwd_tc_kernel<FORM>): a block holds 64 probe rows x a
//    column range, so each q0 tile is read by R / 64 blocks (4 at the
//    quad's R = 256, as in the F32 form's kernel); its d_emb
//    partial [64, D] lives in mma accumulators, 128 f32 a thread at D =
//    512. Per 64-column tile (two tiles in flight as stored, int8: 32 KiB a
//    tile at D = 512 and its 64 column scales, plus one widened to bf16 for
//    the d_emb product):
//    cos = E . q0^T; d_cos in registers from the fragments, rounded to bf16
//    (exact as an mma operand; int8: bf16(d_cos * qs[col]), the scale
//    folded into the coefficient as JAX does) into shared memory; d_emb +=
//    d_cos . q0 tile, the tile's product added in f32. A row whose rounding
//    tile holds no write takes the clean route only, unrolled; one whose
//    tile does takes every route an element at a time (inlined into every
//    unrolled element, the written routes' code slowed the whole kernel by
//    a sixth on an H100 at Q = 4,194,304, though they run on few tiles).
//    Where both of a BF16 written tile's views score against q0's row,
//    their separately rounded d_cos go in as two bf16 products (a second
//    pass over the tile, taken only when the block has one; the int8 forms
//    sum the views before they round). A column this step writes keeps the
//    FMA chain `row_dot` in both passes; its d_cos towards the g / v row
//    goes to wcoef [R][2][BP] at (row, writer), which only that column's
//    thread writes, and the merge adds wcoef . G / V: no atomics.
//    Shared memory at D = 512: BF16 214 KiB (E 64, two q0 tiles 128, d_cos
//    16), INT8 206 KiB (E 64, two int8 tiles 64, the bf16 tile 64, d_cos
//    8), INT8C 174 KiB (E8 32); one block an SM, BB_NW = 8 warps (16 warps
//    hold at 128 registers a thread and spill: on an H100 a few percent
//    faster on the int8 forms, slower on bf16). With one block an SM the
//    phases between barriers add up; tools/quad_bwd_variants.py times the
//    kernel without each of them, and with 16 warps.

#include "margin_common.cuh"
#include "mma_bf16.cuh"

namespace {

enum { FORM_F32 = 0, FORM_BF16 = 1, FORM_INT8 = 2, FORM_INT8C = 3 };

template <int FORM> struct Stored { using T = float; };
template <> struct Stored<FORM_BF16> { using T = __nv_bfloat16; };
template <> struct Stored<FORM_INT8> { using T = signed char; };
template <> struct Stored<FORM_INT8C> { using T = signed char; };

__device__ __forceinline__ float bf16r(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

struct Args {
  const void* q0;  // [Q][D] of Stored<FORM>::T
  long long Q;
  int D;
  const float* E;
  const float* G;
  const float* V;
  const int* rows;
  const int* cols;
  const int* blend;
  const int* labels;
  const float* gt;  // [2][R]
  int B, R, k;
  int BP;  // writes per direction (G, V, rows, cols, blend hold ND BP)
  int ND;  // directions: 2 (quad, R = 2 B) or 1 (twin, R = B)
  int loss_type;
  float margin, scale, mask_svfc, cos_m, sin_m;
  const float* qs;         // INT8 / INT8C: q0's per-row scales [Q]
  const signed char* E8;   // INT8C: the quantised probes [R][D]
  const float* se;         // INT8C: their scales [R]
  int rtile;               // the backward's rounding tile, a multiple of 64
  int twin;                // the twin head: the target column in the stream
  const __nv_bfloat16* Eb;  // BF16: E as bf16 [R][D] (the same values)
};

// dot product in index order, the same FMA chain as the tile products
__device__ __forceinline__ float row_dot(const float* x, const float* y, int n) {
  float acc = 0.f;
  for (int i = 0; i < n; ++i) acc = fmaf(x[i], y[i], acc);
  return acc;
}

// per-tile write plan: last0/lastb[d * TC + c] = highest writer index (in
// direction d) of column t0 + c, or -1; written[d] = whether the tile holds
// any write of direction d (whatever its parity and blend), written[2 + d]
// whether the rounding tile around it does (header).
template <int TC>
__device__ __forceinline__ void mark_writes(const Args& a, long long t0, int* last0, int* lastb,
                                            int* written) {
  const int tid = threadIdx.x;
  for (int i = tid; i < 2 * TC; i += blockDim.x) {
    last0[i] = -1;
    lastb[i] = -1;
  }
  if (tid < 4) written[tid] = 0;
  __syncthreads();
  const long long span0 = t0 / a.rtile * a.rtile;
  for (int e = tid; e < a.ND * a.BP; e += blockDim.x) {
    const long long col = a.cols[e];  // a column of -1 never matches
    const long long off = col - t0;
    const int d = e / a.BP, i = e - d * a.BP;
    if (off >= 0 && off < TC) {
      if (a.rows[e] == 0) atomicMax(&last0[d * TC + off], i);
      if (a.blend[e] > 0) atomicMax(&lastb[d * TC + off], i);
      written[d] = 1;  // every writer stores the same value
    }
    if (col >= span0 && col < span0 + a.rtile) written[2 + d] = 1;
  }
  __syncthreads();
}

// the written columns' cosines, once a launch, for the forward and the F32
// backward: wcos[r][v][i] = E[r] . (v ? V : G)[dir(r) BP + i] by row_dot
// (E, G and V as the dots read them: bf16-rounded in f32 on every form but
// F32)
__global__ void quad_written_cos_kernel(Args a, float* wcos) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;  // (2 r + v) BP + i
  if (idx >= (long long)a.R * 2 * a.BP) return;
  const int i = (int)(idx % a.BP), rv = (int)(idx / a.BP), r = rv >> 1;
  const float* w = ((rv & 1) ? a.V : a.G) + (long long)(r / a.B * a.BP + i) * a.D;
  wcos[idx] = row_dot(a.E + (long long)r * a.D, w, a.D);
}

// ---------------------------------------------------------------- forward

// A block holds ROWS probe rows, a row group, f_threads threads: the F32 form
// 256 (R > 128) or 128, the tensor-core forms 128 (any R: row groups [r_base,
// r_base + ROWS), zero from R), the tensor-core forms with their E rows
// resident in shared memory for the whole range (bf16, or INT8C's E8; up to D =
// F_DMAX). Per F_TC-column tile the cosine product fills Cs [ROWS][F_CLD] from
// feature chunks staged by cp.async in f_nst stages: F32 stages F_FK features
// of E's rows and of the q0 tile, the others 128 bytes of each q0 row (64 bf16
// features, or INT8C's 128).
constexpr int F_ROWS = 256, F_TC = 64, F_THREADS = 256, F_CLD = F_TC + 4, F_FK = FFK;
constexpr int F_TC_ROWS = 128, F_DMAX = 512;  // the tensor-core forms' block rows; their largest D
constexpr int F_PLAN = 4 * F_TC + 4;  // a tile's write plan: last0, lastb [2][F_TC], written [4]
static_assert(F_THREADS == 4 * F_TC, "the INT8 forward widens one 16-byte word a thread");

// threads a block: the F32 form F_THREADS, the tensor-core forms twice as
// many (their row pass is latency-bound: at 16 warps 5-12 % faster than at
// 8, though 128 registers a thread spill a few words on INT8 and BF16)
template <int FORM>
__host__ __device__ constexpr int f_threads() {
  return FORM == FORM_F32 ? F_THREADS : 2 * F_THREADS;
}

// stages: F32 and INT8 (whose q0 words wait in registers) three, two
// chunks in flight beside the one in use; BF16 and INT8C, staging only
// q0, six
template <int FORM>
__host__ __device__ constexpr int f_nst() {
  return FORM == FORM_BF16 || FORM == FORM_INT8C ? 6 : 3;
}

template <int FORM>
__host__ __device__ constexpr int f_chunk() {
  return FORM == FORM_F32 ? F_FK : FORM == FORM_INT8C ? 128 : 64;
}

// bytes of the resident E rows (the tensor-core forms: [D / chunk][ROWS]
// rows of 128 bytes, swizzled, at D = F_DMAX)
template <int FORM, int ROWS>
__host__ __device__ constexpr int f_e_bytes() {
  return FORM == FORM_F32 ? 0 : ROWS * F_DMAX * (FORM == FORM_INT8C ? 1 : 2);
}

// bytes of a stage: F32 E's ROWS rows and q0's F_TC rows of one chunk at a
// row stride of F_FK + 4 floats; the others q0's F_TC rows, 128 bytes a
// row, swizzled
template <int FORM, int ROWS>
__host__ __device__ constexpr int f_stage_bytes() {
  return FORM == FORM_F32 ? 4 * fdots_stage_floats<ROWS, F_TC>() : 128 * F_TC;
}

// shared memory of a block: the resident E rows, the stages, Cs, and two
// tiles' write plans
template <int FORM, int ROWS>
__host__ __device__ constexpr int f_smem() {
  return f_e_bytes<FORM, ROWS>() + f_nst<FORM>() * f_stage_bytes<FORM, ROWS>() + 4 * ROWS * F_CLD +
         4 * 2 * F_PLAN;
}
static_assert(f_smem<FORM_F32, F_ROWS>() <= 232448 &&
                  f_smem<FORM_BF16, F_TC_ROWS>() <= 232448,
              "the forward fits a block's shared memory");

// One thread's accumulators of the cosine tile. F32: an 8 x TJ micro-tile,
// probe rows ax + SA i and tile columns by + SB j (fwd_f32_map), 1 byte of
// shared memory read per FMA at 256 rows (1.5 at 128); the tensor-core
// forms: the fragments of the warp's 32 rows x F_TC / WN columns (INT8C
// int32, exact).
template <int FORM, int ROWS>
struct FwdAcc {
  static constexpr int WM = ROWS / 32, WN = f_threads<FORM>() / 32 / WM, NI = 8 / WN;
  float v[2][NI][4];
};
template <int ROWS>
struct FwdAcc<FORM_INT8C, ROWS> {
  static constexpr int WM = ROWS / 32, WN = f_threads<FORM_INT8C>() / 32 / WM, NI = 8 / WN;
  int v[2][NI][4];
};
template <int ROWS>
struct FwdAcc<FORM_F32, ROWS> {
  static constexpr int TI = 8, TJ = ROWS == F_ROWS ? 8 : 4, SA = ROWS / TI, SB = F_TC / TJ;
  float v[TI][TJ];
};

template <int FORM, int ROWS>
__device__ __forceinline__ void fwd_zero(FwdAcc<FORM, ROWS>& acc) {
  using A = FwdAcc<FORM, ROWS>;
  if constexpr (FORM == FORM_F32) {
#pragma unroll
    for (int i = 0; i < A::TI; ++i)
#pragma unroll
      for (int j = 0; j < A::TJ; ++j) acc.v[i][j] = 0.f;
  } else {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < A::NI; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc.v[mi][ni][e] = 0;
  }
}

// the F32 micro-tile map (margin_common.cuh's fdots_map)
template <int ROWS>
__device__ __forceinline__ void fwd_f32_map(int& ax, int& by) {
  using A = FwdAcc<FORM_F32, ROWS>;
  fdots_map<ROWS, F_TC, A::TI, A::TJ>(ax, by);
}

// the tensor-core forms' E rows [r_base, r_base + ROWS) (zero from R) into
// the resident region Es, every chunk (bf16 E, or INT8C's E8, zero from
// D), by cp.async; the caller commits
template <int FORM, int ROWS>
__device__ __forceinline__ void fwd_load_e(const Args& a, unsigned char* Es, int r_base) {
  const int n_kc = (a.D + f_chunk<FORM>() - 1) / f_chunk<FORM>();
  for (int i = threadIdx.x; i < n_kc * ROWS * 8; i += f_threads<FORM>()) {
    const int p = i & 7, r = (i >> 3) % ROWS, kc = (i >> 3) / ROWS, gr = r_base + r;
    unsigned char* dst = Es + kc * ROWS * 128 + swz(r, 8 * p, 8);
    if constexpr (FORM == FORM_INT8C) {
      const int f = 128 * kc + 16 * p;  // the piece's 16 features
      const bool ok = f < a.D && gr < a.R;
      cp_async_cg(dst, ok ? a.E8 + (long long)gr * a.D + f : a.E8, ok);
    } else {
      const bool ok = gr < a.R;
      cp_async_cg(dst, ok ? a.Eb + (long long)gr * a.D + 64 * kc + 8 * p : a.Eb, ok);
    }
  }
}

// stage s: chunk kc of q0 rows [t0, t0 + F_TC) (zero from c_end), by
// cp.async, and (F32) of probe rows [r_base, r_base + ROWS) (zero from R); INT8C zero
// from D as well; INT8: q0's 64 x 64 int8 features are one 16-byte word a
// thread, returned for fwd_widen_q once they land (the caller's product
// hides the load)
template <int FORM, int ROWS>
__device__ __forceinline__ uint4 fwd_load(const Args& a, unsigned char* stg, int s, int r_base,
                                          long long t0, long long c_end, int kc) {
  unsigned char* Qs = stg + s * f_stage_bytes<FORM, ROWS>();
  uint4 v = make_uint4(0, 0, 0, 0);
  if constexpr (FORM == FORM_F32) {
    fdots_load<F_THREADS, ROWS, F_TC>(reinterpret_cast<float*>(Qs), a.E, r_base,
                                      min(ROWS, a.R - r_base),
                                      static_cast<const float*>(a.q0), t0,
                                      (int)min((long long)F_TC, c_end - t0), a.D, kc);
  } else if constexpr (FORM == FORM_INT8) {
    const long long col = t0 + (threadIdx.x >> 2);
    const signed char* q0 = static_cast<const signed char*>(a.q0);
    if (threadIdx.x < 4 * F_TC && col < c_end)
      v = __ldg(reinterpret_cast<const uint4*>(q0 + col * a.D + 64 * kc + 16 * (threadIdx.x & 3)));
  } else {
    for (int i = threadIdx.x; i < F_TC * 8; i += f_threads<FORM>()) {
      const int r = i >> 3, p = i & 7;
      const long long col = t0 + r;
      if constexpr (FORM == FORM_INT8C) {
        const signed char* q0 = static_cast<const signed char*>(a.q0);
        const int f = 128 * kc + 16 * p;  // the piece's 16 features
        const bool ok = f < a.D && col < c_end;
        cp_async_cg(Qs + swz(r, 8 * p, 8), ok ? q0 + col * a.D + f : q0, ok);
      } else {
        const __nv_bfloat16* q0 = static_cast<const __nv_bfloat16*>(a.q0);
        const bool ok = col < c_end;
        cp_async_cg(Qs + swz(r, 8 * p, 8), ok ? q0 + col * a.D + 64 * kc + 8 * p : q0, ok);
      }
    }
  }
  return v;
}

// INT8: this thread's word of fwd_load (threads below 4 F_TC), widened to
// bf16 into stage s
template <int ROWS>
__device__ __forceinline__ void fwd_widen_q(unsigned char* stg, int s, uint4 v) {
  if (threadIdx.x < 4 * F_TC)
    widen16(stg + s * f_stage_bytes<FORM_INT8, ROWS>(), threadIdx.x >> 2, 16 * (threadIdx.x & 3),
            8, v);
}

// the first f_nst - 1 chunks of the tile at t0, each its own cp.async group
// (fwd_product stages the rest); INT8: q0's words in v, for
// fwd_widen_first once they are wanted
template <int FORM, int ROWS>
__device__ __forceinline__ void fwd_prologue(const Args& a, unsigned char* stg, int r_base,
                                             long long t0, long long c_end,
                                             uint4 (&v)[f_nst<FORM>() - 1]) {
  const int n_kc = (a.D + f_chunk<FORM>() - 1) / f_chunk<FORM>();
#pragma unroll
  for (int s = 0; s < f_nst<FORM>() - 1; ++s) {
    if (s < n_kc) v[s] = fwd_load<FORM, ROWS>(a, stg, s, r_base, t0, c_end, s);
    cp_async_commit();
  }
}

template <int FORM, int ROWS>
__device__ __forceinline__ void fwd_widen_first(const Args& a, unsigned char* stg,
                                                const uint4 (&v)[f_nst<FORM>() - 1]) {
  if constexpr (FORM == FORM_INT8)
#pragma unroll
    for (int s = 0; s < f_nst<FORM>() - 1; ++s)
      if (s < a.D / 64) fwd_widen_q<ROWS>(stg, s, v[s]);
}

// chunk kc's product, staged at st (the tensor-core forms: E's chunk kc
// resident at Es), into acc. F32: each cosine one fmaf
// chain over the features in index order from 0 (the backward's
// ftile_dots chain); BF16 / INT8: the k16 chain, each step's product added
// in f32 (mma_bf16.cuh; the backward's recompute); INT8C: the exact int32
// sum over the chunk's k32 steps below D (mma.sync s8, the backward's)
template <int FORM, int ROWS>
__device__ __forceinline__ void fwd_chunk(const Args& a, const unsigned char* st,
                                          const unsigned char* Es, int kc,
                                          FwdAcc<FORM, ROWS>& acc) {
  using A = FwdAcc<FORM, ROWS>;
  if constexpr (FORM == FORM_F32) {
    int ax, by;
    fwd_f32_map<ROWS>(ax, by);
    fdots_chunk<ROWS, F_TC, A::TI, A::TJ>(acc.v, reinterpret_cast<const float*>(st), ax, by);
  } else {
    const int warp = threadIdx.x >> 5;
    const int wr = (warp % A::WM) * 32, wc = (warp / A::WM) * (F_TC / A::WN);
    const unsigned char* Ek = Es + kc * ROWS * 128;
    if constexpr (FORM == FORM_INT8C)
      mma_nt_s8<2, A::NI>(acc.v, Ek, 8, wr, st, 8, wc, min(4, (a.D - 128 * kc) / 32));
    else
      mma_nt<2, A::NI>(acc.v, Ek, 8, wr, st, 8, wc, 4);
  }
}

// INT8 / INT8C: q0's scale of column c (0 from c_end)
__device__ __forceinline__ float col_scale(const Args& a, long long c, long long c_end) {
  return c < c_end ? a.qs[c] : 0.f;
}

// the tile's cosines from acc into Cs [ROWS][F_CLD]: INT8 times q0's column
// scale, INT8C f32(acc) * (se[row] * qs[col]) (tile_cos's expression)
template <int FORM, int ROWS>
__device__ __forceinline__ void fwd_store(const Args& a, const FwdAcc<FORM, ROWS>& acc,
                                          float* Cs, int r_base, long long t0, long long c_end) {
  using A = FwdAcc<FORM, ROWS>;
  if constexpr (FORM == FORM_F32) {
    int ax, by;
    fwd_f32_map<ROWS>(ax, by);
#pragma unroll
    for (int i = 0; i < A::TI; ++i)
#pragma unroll
      for (int j = 0; j < A::TJ; ++j) Cs[(ax + A::SA * i) * F_CLD + by + A::SB * j] = acc.v[i][j];
  } else {
    const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
    const int wr = (warp % A::WM) * 32, wc = (warp / A::WM) * (F_TC / A::WN);
    float se[2][2];  // INT8C: the probe rows' scales (0 from R)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r_base + wr + 16 * mi + g + 8 * h;
        se[mi][h] = FORM == FORM_INT8C && r < a.R ? a.se[r] : 0.f;
      }
#pragma unroll
    for (int ni = 0; ni < A::NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = wc + 8 * ni + 2 * t + (e & 1);
        const float sc = FORM == FORM_BF16 ? 1.f : col_scale(a, t0 + c, c_end);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          float& x = Cs[(wr + 16 * mi + g + 8 * (e >> 1)) * F_CLD + c];
          if constexpr (FORM == FORM_INT8C) x = (float)acc.v[mi][ni][e] * (se[mi][e >> 1] * sc);
          else if constexpr (FORM == FORM_INT8) x = acc.v[mi][ni][e] * sc;
          else x = acc.v[mi][ni][e];
        }
      }
  }
}

// a thread's probe row in the row pass and the write plan of the tile it
// streams
struct RowPass {
  const int* plan;    // the tile's write plan
  const float* wcos;  // the written cosines [R][2][BP]
  int r, lr, lane, dir, label;  // the row, its row in Cs, the thread's lane
  float gt0, gt1;
  float zs;  // scale * log2(e): the row pass streams z / ln 2
};

// quad q (columns 4q .. 4q + 3) of row rp.r (Cs row rp.lr) in the tile at
// t0 with n valid columns: its cosines in view 1 (c1) and view 2 (c2), and
// which columns stream (ok: not the target, below n). A written column
// takes its cosine with the last parity-0 writer g (view 1) and the last
// blend writer v (view 2) from wcos.
__device__ __forceinline__ void load_quad(const Args& a, const float* Cs, const RowPass& rp,
                                          long long t0, int n, int q, float (&c1)[4],
                                          float (&c2)[4], bool (&ok)[4]) {
  const int* plan = rp.plan;
  const int dir = rp.dir, c0 = 4 * q;
  const long long tgt = rp.label - t0;  // the target's tile column, if here
  const float4 cv = *reinterpret_cast<const float4*>(Cs + rp.lr * F_CLD + c0);
  c1[0] = cv.x, c1[1] = cv.y, c1[2] = cv.z, c1[3] = cv.w;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    ok[j] = c0 + j < n && c0 + j != tgt;
    c2[j] = c1[j];
  }
  if (plan[4 * F_TC + dir] != 0) {  // the tile holds a write of the row's direction
    const float* w1 = rp.wcos + (long long)(2 * rp.r) * a.BP;
    const float* w2 = w1 + a.BP;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i0 = plan[dir * F_TC + c0 + j], ib = plan[(2 + dir) * F_TC + c0 + j];
      if (i0 >= 0) c1[j] = w1[i0];
      c2[j] = ib >= 0 ? w2[ib] : c1[j];
    }
  }
}

// this lane's share of the tile at t0 (n valid columns, its write plan
// rp.plan) into ln (margin_common.cuh's Lane, both views: a row's columns
// are split over L = threads / ROWS lanes, each taking every L-th quad of a
// tile), a pair of quads at a time: a pair's two quads feed the
// two chains of each view, 16 independent terms; the target column stays
// out of the stream and the top-k, whose insertions run only where a column
// beats the view's kth
template <int L>
__device__ __forceinline__ void row_pass(const Args& a, const float* Cs, const RowPass& rp,
                                         long long t0, int n, Lane<2>& ln) {
  constexpr int NP = F_TC / 8 / L;  // quad pairs a lane
  for (int i = 0; i < NP; ++i) {
    float c1[2][4], c2[2][4];
    bool ok[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      load_quad(a, Cs, rp, t0, n, rp.lane + L * (2 * i + h), c1[h], c2[h], ok[h]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      stream4(a, rp.zs, c1[h], ok[h], rp.gt0, ln.m[0][h], ln.s[0][h]);
      stream4(a, rp.zs, c2[h], ok[h], rp.gt1, ln.m[1][h], ln.s[1][h]);
    }
    float mx1 = -INFINITY, mx2 = -INFINITY;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (ok[h][j]) {
          mx1 = fmaxf(mx1, c1[h][j]);
          mx2 = fmaxf(mx2, c2[h][j]);
        }
    // the insertions: one copy of topk_push a view, in a loop over the
    // pair's columns
    if (mx1 > ln.kth[0] || mx2 > ln.kth[1]) {
#pragma unroll 1
      for (int j = 0; j < 8; ++j) {
        float x1 = -INFINITY, x2 = -INFINITY;
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (e == j && ok[e >> 2][e & 3]) {
            x1 = c1[e >> 2][e & 3];
            x2 = c2[e >> 2][e & 3];
          }
        topk_push(ln.tk[0], ln.kth[0], x1, a.k);
        topk_push(ln.tk[1], ln.kth[1], x2, a.k);
      }
    }
  }
}

// the tile at t0's cosines of rows [r_base, r_base + ROWS) into Cs, its
// first chunks in flight (fwd_prologue), the tensor-core forms' E rows
// resident at Es. Ends with the tile in Cs, after a barrier that follows
// every thread's reads of the previous tile there.
template <int FORM, int ROWS>
__device__ __forceinline__ void fwd_product(const Args& a, const unsigned char* Es,
                                            unsigned char* stg, int r_base, long long t0,
                                            long long c_end, float* Cs) {
  const int n_kc = (a.D + f_chunk<FORM>() - 1) / f_chunk<FORM>();
  FwdAcc<FORM, ROWS> acc;
  fwd_zero(acc);
  constexpr int NST = f_nst<FORM>();
  for (int kc = 0; kc < n_kc; ++kc) {
    cp_async_wait<NST - 2>();
    __syncthreads();  // chunk kc has landed; chunk kc - 1's stage is free
    const bool more = kc + NST - 1 < n_kc;
    const int s_next = (kc + NST - 1) % NST;
    uint4 v;
    if (more) v = fwd_load<FORM, ROWS>(a, stg, s_next, r_base, t0, c_end, kc + NST - 1);
    cp_async_commit();
    fwd_chunk<FORM, ROWS>(a, stg + (kc % NST) * f_stage_bytes<FORM, ROWS>(), Es, kc, acc);
    if constexpr (FORM == FORM_INT8)
      if (more) fwd_widen_q<ROWS>(stg, s_next, v);
  }
  __syncthreads();  // every read of the previous tile in Cs is done
  fwd_store<FORM, ROWS>(a, acc, Cs, r_base, t0, c_end);
}

template <int FORM, int ROWS>
__global__ void __launch_bounds__(f_threads<FORM>(), 1)
    quad_fwd_kernel(Args a, long long cols_per_blk, const float* wcos, float* part) {
  constexpr int L = f_threads<FORM>() / ROWS;  // lanes a row
  extern __shared__ __align__(16) unsigned char f_sm[];
  unsigned char* Es = f_sm;                          // the tensor-core forms' resident E rows
  unsigned char* stg = Es + f_e_bytes<FORM, ROWS>();  // [f_nst] stages
  float* Cs = reinterpret_cast<float*>(stg + f_nst<FORM>() * f_stage_bytes<FORM, ROWS>());
  int* plans = reinterpret_cast<int*>(Cs + ROWS * F_CLD);  // [2][F_PLAN], by tile parity

  const int tid = threadIdx.x;
  // row groups of one column range adjacent in launch order (they share
  // its q0 tiles through L2)
  const int n_rg = (a.R + ROWS - 1) / ROWS, chunk = blockIdx.x / n_rg;
  const int r_base = (blockIdx.x % n_rg) * ROWS;
  const long long c_begin = (long long)chunk * cols_per_blk;
  const long long c_end = min(a.Q, c_begin + cols_per_blk);
  const int n_tiles = c_end > c_begin ? (int)((c_end - c_begin + F_TC - 1) / F_TC) : 0;
  RowPass rp;  // the thread's row: rows tid % ROWS, lanes tid / ROWS
  rp.wcos = wcos;
  rp.lr = tid % ROWS;
  rp.r = r_base + rp.lr;
  rp.lane = tid / ROWS;
  const int r = rp.r, lane = rp.lane;
  const bool row_ok = r < a.R;
  rp.dir = row_ok ? r / a.B : 0;
  rp.label = row_ok ? a.labels[r] : -1;
  rp.gt0 = row_ok ? a.gt[r] : 0.f;
  rp.gt1 = row_ok ? a.gt[a.R + r] : 0.f;
  rp.zs = a.scale * LOG2E;
  Lane<2> ln;
  lane_init(ln);

  if constexpr (FORM != FORM_F32) {
    fwd_load_e<FORM, ROWS>(a, Es, r_base);
    cp_async_commit();
  }
  uint4 first[f_nst<FORM>() - 1];  // INT8: the tile's first q0 words
  if (n_tiles > 0) fwd_prologue<FORM, ROWS>(a, stg, r_base, c_begin, c_end, first);
  // tile ti's product after tile ti - 1's row pass (Cs holds it), with
  // tile ti's first chunks in flight; a last turn streams the last tile
  for (int ti = 0; ti <= n_tiles; ++ti) {
    const long long t0 = c_begin + (long long)ti * F_TC;
    int* plan = plans + (ti & 1) * F_PLAN;
    if (ti < n_tiles) {
      mark_writes<F_TC>(a, t0, plan, plan + 2 * F_TC, plan + 4 * F_TC);
      fwd_widen_first<FORM, ROWS>(a, stg, first);
    } else {
      cp_async_wait<0>();
      __syncthreads();  // the last tile is in Cs
    }
    rp.plan = plans + ((ti + 1) & 1) * F_PLAN;  // the previous tile's
    if (ti > 0 && row_ok)
      row_pass<L>(a, Cs, rp, t0 - F_TC, (int)min((long long)F_TC, c_end - t0 + F_TC), ln);
    if (ti < n_tiles) {
      fwd_product<FORM, ROWS>(a, Es, stg, r_base, t0, c_end, Cs);
      if (ti + 1 < n_tiles) fwd_prologue<FORM, ROWS>(a, stg, r_base, t0 + F_TC, c_end, first);
    }
  }

  // each view's chains (to base e) folded in order, then (L = 2) the other
  // lane's state, through Cs
  float M[2], S[2];
#pragma unroll
  for (int v = 0; v < 2; ++v) {
#pragma unroll
    for (int ch = 0; ch < 2; ++ch) ln.m[v][ch] *= LN2;
    M[v] = ln.m[v][0];
    S[v] = ln.s[v][0];
    lse_fold(ln.m[v][1], ln.s[v][1], M[v], S[v]);
  }
  static_assert(2 * PART <= F_CLD, "one other lane's state a row fits Cs");
  float* x = Cs + rp.lr * F_CLD;  // [2][PART]
  for (int l = 1; l < L; ++l) {   // lane l's state into lane 0's, in lane order
    __syncthreads();              // Cs is free (the row passes, the previous lane)
    if (lane == l && row_ok) {
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        x[v * PART] = M[v];
        x[v * PART + 1] = S[v];
        tk_store<0>(x + v * PART + 2, ln.tk[v]);
      }
    }
    __syncthreads();
    if (lane == 0 && row_ok)
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        lse_fold(x[v * PART], x[v * PART + 1], M[v], S[v]);
        for (int j = 0; j < a.k; ++j)  // value-only lists: the union's top-k, exactly
          topk_push(ln.tk[v], ln.kth[v], x[v * PART + 2 + j], a.k);
      }
  }
  if (lane != 0 || !row_ok) return;
  float m0 = M[0], s0 = S[0], m1 = M[1], s1 = S[1];
  const float zt0 = a.scale * phi_target(rp.gt0, a), zt1 = a.scale * phi_target(rp.gt1, a);
  if (a.twin && rp.label >= c_begin && rp.label < c_end) {
    // the twin's target term z = scale * phi(gt), folded in after the
    // block's columns: streamed first, a dominant z would leave each later
    // column's e^(z - m) below half an ulp of s, and lose them (a bias of
    // up to ~1e-4 in logz at 4,000 columns a block)
    stream_z(zt0, m0, s0);
    stream_z(zt1, m1, s1);
  }
  float* p0 = part + (((long long)chunk * 2 + 0) * a.R + r) * PART;
  float* p1 = part + (((long long)chunk * 2 + 1) * a.R + r) * PART;
  p0[0] = m0;
  p0[1] = s0;
  p1[0] = m1;
  p1[1] = s1;
  tk_store<0>(p0 + 2, ln.tk[0]);
  tk_store<0>(p1 + 2, ln.tk[1]);
}

// (M, S, top-k) of (view v, row r): the block partials merged in block
// order; (-inf, 0) when the row has no column
__device__ __forceinline__ void merge_blocks(const Args& a, int nblk, const float* part, int v,
                                             int r, float& M, float& S, float (&tk)[KMAX]) {
  M = -INFINITY;
  S = 0.f;
  for (int j = 0; j < KMAX; ++j) tk[j] = NEG_INF_F;
  for (int blk = 0; blk < nblk; ++blk)
    merge_partial(part + (((long long)blk * 2 + v) * a.R + r) * PART, a.k, M, S, tk);
}

// one thread per (view, row): merge the block partials and finalize
// ce / neg / logz / top-k (the twin's (M, S) hold the target term already:
// logz = M + log S)
__global__ void quad_fwd_merge_kernel(Args a, int nblk, const float* part, float* ce, float* neg,
                                      float* logz, float* topk) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;  // v * R + r
  if (idx >= 2 * a.R) return;
  const int v = idx / a.R, r = idx - v * a.R;
  float M, S, tk[KMAX];
  merge_blocks(a, nblk, part, v, r, M, S, tk);
  const float zt = a.scale * phi_target(a.gt[v * a.R + r], a);
  const bool pos = a.labels[r] >= 0;
  finalize_row(M, S, tk, a.k, pos && !a.twin, zt, ce[idx], neg[idx], logz[idx]);
  if (a.twin && pos) {
    ce[idx] = logz[idx] - zt;
    neg[idx] = 0.f;
  }
  for (int j = 0; j < a.k; ++j) topk[(long long)idx * a.k + j] = tk[j];
}

// the partial form: the shard's merged (m, s, top-k) of the negative
// stream, no target term and no finalize
__global__ void quad_partial_merge_kernel(Args a, int nblk, const float* part, float* m, float* s,
                                          float* topk) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;  // v * R + r
  if (idx >= 2 * a.R) return;
  float M, S, tk[KMAX];
  merge_blocks(a, nblk, part, idx / a.R, idx % a.R, M, S, tk);
  m[idx] = M;
  s[idx] = S;
  for (int j = 0; j < a.k; ++j) topk[(long long)idx * a.k + j] = tk[j];
}

// --------------------------------------------------------------- backward

struct BwdRows {
  const float* logz;  // [2][R]
  const float* kth;   // [2][R]
  const float* dce;   // [2][R], 0 on outlier rows
  const float* dneg;  // [2][R], 0 on positive rows
};

// a backward row's inputs: label, direction, and per view its target
// cosine, logz, kth and cotangents; the Arc / AM clean tile's combined
// d_cos of both views (JAX's _quad_dir_bwd_shared) is exp(z - ref) * c12,
// plus dn_v where z >= zthr_v, with z = scale * cos
struct RowCoef {
  int lab, dir;
  bool ok, pos;
  float gt[2], lz[2], kth[2], dce[2], dneg[2], zthr[2], dn[2], ref, c12;
};

__device__ __forceinline__ RowCoef row_coef(const Args& a, const BwdRows& br, int gr) {
  RowCoef rc;
  const float inv_k = (float)(1.0 / (double)a.k);
  rc.ok = gr < a.R;
  const int rr = rc.ok ? gr : 0;
  rc.lab = a.labels[rr];
  rc.dir = rr / a.B;
  rc.pos = rc.lab >= 0;
#pragma unroll
  for (int v = 0; v < 2; ++v) {
    rc.gt[v] = a.gt[v * a.R + rr];
    rc.lz[v] = br.logz[v * a.R + rr];
    rc.kth[v] = br.kth[v * a.R + rr];
    rc.dce[v] = br.dce[v * a.R + rr];
    rc.dneg[v] = br.dneg[v * a.R + rr];
    rc.zthr[v] = fmaxf(a.scale * (rc.kth[v] - KTH_TIE_TOL), 1e-20f);
    rc.dn[v] = rc.dneg[v] * inv_k;
  }
  rc.ref = fminf(rc.lz[0], rc.lz[1]);
  rc.c12 = (rc.dce[0] * expf(rc.ref - rc.lz[0]) + rc.dce[1] * expf(rc.ref - rc.lz[1])) * a.scale;
  return rc;
}

// d_cos of row rc (global row gr) on a rounded form (the tensor-core
// backward; F32: bf_clean_dcos / bf_written_dcos below) at column c of a
// TC-column tile whose clean cosine is c1 and whose stored row q0's scale
// is sc (1 but on an int8 queue), routed per view to the row that view scores
// against: dq to q0's stored row, dg to the parity-0 write g, dv to the
// view-2 write v; i0 / ib return the column's last writers in the row's
// direction (-1: none). The BF16 form keeps the two views' rounded d_cos
// apart when both score against q0's row (dq, dq2: two bf16 operands); the
// others sum them into dq. With WRITES false the caller knows that the
// row's rounding tile holds no write (so neither does the tile), and only
// the clean route is compiled.
template <int FORM, int TC, bool WRITES = true>
__device__ __forceinline__ void route_dcos(const Args& a, const RowCoef& rc, int gr, int c,
                                           const int* last0, const int* lastb, const int* written,
                                           float c1, float sc, float& dq, float& dq2, float& dg,
                                           float& dv, int& i0, int& ib) {
  static_assert(FORM != FORM_F32, "the F32 form's d_cos rounds nothing");
  constexpr bool SCALED = FORM == FORM_INT8 || FORM == FORM_INT8C;
  const bool w64 = written[rc.dir] != 0;      // this tile holds a write of the row's direction
  const bool hit = written[2 + rc.dir] != 0;  // ... its rounding tile does
  float c2 = c1;
  i0 = -1;
  ib = -1;
  if (WRITES && w64) {
    const float* e_row = a.E + (long long)gr * a.D;
    i0 = last0[rc.dir * TC + c];
    ib = lastb[rc.dir * TC + c];
    if (i0 >= 0) c1 = row_dot(e_row, a.G + (long long)(rc.dir * a.BP + i0) * a.D, a.D);
    c2 = ib >= 0 ? row_dot(e_row, a.V + (long long)(rc.dir * a.BP + ib) * a.D, a.D) : c1;
  }
  if (!WRITES || !hit) {  // clean tile: both views read the stored row
    float d;
    if (a.loss_type == LOSS_SV || a.twin) {
      d = dcos_col(c1, rc.gt[0], rc.lz[0], rc.kth[0], rc.dce[0], rc.dneg[0], !rc.pos, a) +
          dcos_col(c1, rc.gt[1], rc.lz[1], rc.kth[1], rc.dce[1], rc.dneg[1], !rc.pos, a);
    } else {
      const float z = a.scale * c1;
      d = expf(z - rc.ref) * rc.c12;
      if (z >= rc.zthr[0]) d += rc.dn[0];
      if (z >= rc.zthr[1]) d += rc.dn[1];
    }
    dq = SCALED ? bf16r(d * sc) : bf16r(d);
  } else {
    float d1 = dcos_col(c1, rc.gt[0], rc.lz[0], rc.kth[0], rc.dce[0], rc.dneg[0], !rc.pos, a);
    float d2 = dcos_col(c2, rc.gt[1], rc.lz[1], rc.kth[1], rc.dce[1], rc.dneg[1], !rc.pos, a);
    if (FORM == FORM_BF16) {  // each view's d_cos rounded alone
      d1 = bf16r(d1);
      d2 = bf16r(d2);
    }
    if (ib >= 0) dv = d2;
    else if (FORM == FORM_BF16 && i0 < 0) dq2 = d2;  // both views on q0's row
    else d1 += d2;  // view 2 reads view 1's row
    if (i0 >= 0) dg = d1; else dq = d1;
    if (SCALED) {
      dv = bf16r(dv);
      dg = bf16r(dg);
      dq = bf16r(dq * sc);
    }
  }
}

// ------------------------------------------ backward, F32, on the CUDA cores

// quad_bwd_f32_kernel (module header): a block holds BF_RB probe rows x a
// column range, BF_THREADS threads, one block an SM
constexpr int BF_RB = 64, BF_TC = 64, BF_THREADS = 256;  // probe rows, tile columns
constexpr int BF_NST = 2, BF_FK = 64;  // the cosines' E stages, features a chunk
constexpr int BF_DLD = BF_RB + 4;      // d_cos^T's row stride: one row a tile column
// the cosine micro-tile (bf_cos_map): rows ax + BF_SA i (i < BF_TI), tile
// columns by + BF_SB j (j < BF_TJ)
constexpr int BF_TI = 4, BF_TJ = 4, BF_SA = 16, BF_SB = 16;
static_assert(BF_TI * BF_SA == BF_RB && BF_TJ * BF_SB == BF_TC, "the micro-tiles cover the tile");
constexpr int BF_STG = ftile_stage_floats<BF_RB, BF_NST, BF_FK>();

// shared memory at feature width D: the q0 tile [BF_TC][D + 4], E's stages,
// d_cos^T [BF_TC][BF_DLD], the rows' inputs and the write plan
__host__ __device__ constexpr int bf_smem(int D) {
  return 4 * (BF_TC * (D + 4) + BF_STG + BF_TC * BF_DLD) + BF_RB * (int)sizeof(RowCoef) +
         (4 * BF_TC + 4) * (int)sizeof(int);
}
static_assert(bf_smem(512) <= 232448, "the f32 backward fits a block's shared memory at D = 512");

// the cosine map: the eight threads of a quarter warp read one E row (a
// broadcast) and eight consecutive q0 rows (ftile_dots' banks)
__device__ __forceinline__ void bf_cos_map(int& ax, int& by) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  ax = 4 * (warp >> 1) + (lane >> 3);
  by = 8 * (warp & 1) + (lane & 7);
}

// the clean cosines acc[i][j] of probe rows r_base + ax + BF_SA i (the first
// nr valid) against q0 rows t0 + by + BF_SB j (the first n valid): E's rows
// stream through the stages stg, q0's are staged into Qt [BF_TC][D + 4] and
// stay there; ftile_dots' chain, the forward's bits
__device__ __forceinline__ void bf_dots(float (&acc)[BF_TI][BF_TJ], float* stg, float* Qt,
                                        const Args& a, int r_base, int nr, long long t0, int n,
                                        int ax, int by) {
  float n2;
  ftile_dots<BF_RB, BF_TC, BF_THREADS, BF_NST, BF_FK, BF_TI, BF_TJ, BF_SA, BF_SB, false>(
      acc, n2, stg, Qt, a.E, r_base, nr, static_cast<const float*>(a.q0), t0, n, a.D, ax, by);
}

// d_cos of row rc at a column whose clean cosine is c1: the F32 form's sum
// of both views' dcos_col terms (no rounding, no combined form)
__device__ __forceinline__ float bf_clean_dcos(const Args& a, const RowCoef& rc, float c1) {
  return dcos_col(c1, rc.gt[0], rc.lz[0], rc.kth[0], rc.dce[0], rc.dneg[0], !rc.pos, a) +
         dcos_col(c1, rc.gt[1], rc.lz[1], rc.kth[1], rc.dce[1], rc.dneg[1], !rc.pos, a);
}

// ... at the tile's column c of a tile that holds a write of the row's
// direction: a column this step writes takes its cosine with the last
// parity-0 writer g and the last blend writer v from wcos [R][2][BP]
// (row_dot's chain, the forward's bits) and sends the term each view owes
// that row to wcoef [R][2][BP], which only this thread writes at (gr,
// writer). Returns the term on q0's stored row.
__device__ __forceinline__ float bf_written_dcos(const Args& a, const RowCoef& rc, int gr, int c,
                                                 const int* last0, const int* lastb, float c1,
                                                 const float* wcos, float* wcoef) {
  const long long wrow = (long long)gr * 2 * a.BP;
  const int i0 = last0[rc.dir * BF_TC + c], ib = lastb[rc.dir * BF_TC + c];
  if (i0 >= 0) c1 = wcos[wrow + i0];
  const float c2 = ib >= 0 ? wcos[wrow + a.BP + ib] : c1;
  float d1 = dcos_col(c1, rc.gt[0], rc.lz[0], rc.kth[0], rc.dce[0], rc.dneg[0], !rc.pos, a);
  const float d2 = dcos_col(c2, rc.gt[1], rc.lz[1], rc.kth[1], rc.dce[1], rc.dneg[1], !rc.pos, a);
  if (ib >= 0) wcoef[wrow + a.BP + ib] = d2;  // view 2 reads v
  else d1 += d2;                              // ... or view 1's row
  if (i0 >= 0) {                              // view 1 reads g
    wcoef[wrow + i0] = d1;
    return 0.f;
  }
  return d1;
}

// The F32 form (module header)
__global__ void __launch_bounds__(BF_THREADS, 1)
    quad_bwd_f32_kernel(Args a, BwdRows br, long long cols_per_chunk, int n_rg,
                        const float* wcos, float* part, float* wcoef) {
  extern __shared__ __align__(16) float bf_sm[];
  const int D = a.D, ldq = D + 4;
  float* Qt = bf_sm;              // the q0 tile [BF_TC][D + 4]
  float* stg = Qt + BF_TC * ldq;  // E's stages
  float* Dq = stg + BF_STG;       // d_cos^T [BF_TC][BF_DLD]
  RowCoef* rcs = reinterpret_cast<RowCoef*>(Dq + BF_TC * BF_DLD);
  int* last0 = reinterpret_cast<int*>(rcs + BF_RB);
  int* lastb = last0 + 2 * BF_TC;
  int* written = lastb + 2 * BF_TC;  // [4]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = blockIdx.x % n_rg, chunk = blockIdx.x / n_rg;
  const int r_base = rg * BF_RB, nr = min(BF_RB, a.R - r_base);
  const long long c_begin = (long long)chunk * cols_per_chunk;
  const long long c_end = min(a.Q, c_begin + cols_per_chunk);
  for (int r = tid; r < BF_RB; r += BF_THREADS) rcs[r] = row_coef(a, br, r_base + r);
  int ax, by;
  bf_cos_map(ax, by);
  // the d_emb map: thread t holds the rows er .. er + 7 and the features
  // ef + 128 q .. + 3 (q < 4) below D, 128 f32 at D = 512; a quarter warp
  // reads one d_cos column's 8 rows (a broadcast) and 32 consecutive
  // features of one q0 row
  const int er = 8 * (4 * (warp & 1) + (lane >> 3)), ef = 4 * (8 * (warp >> 1) + (lane & 7));
  float demb[8][16];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int f = 0; f < 16; ++f) demb[i][f] = 0.f;

  for (long long t0 = c_begin; t0 < c_end; t0 += BF_TC) {
    const int n = (int)min((long long)BF_TC, c_end - t0);
    mark_writes<BF_TC>(a, t0, last0, lastb, written);  // its barriers publish rcs too
    float acc[BF_TI][BF_TJ];
    bf_dots(acc, stg, Qt, a, r_base, nr, t0, n, ax, by);

    // d_cos into Dq, transposed: one row a tile column. A row whose tile
    // holds no write of its direction takes the clean route, unrolled; one
    // whose tile does takes every route an element at a time (inlined into
    // every unrolled element, the written route slowed the clean one by 0.8
    // ms of 18.8 at Q = 2^20 on an H100: tools/quad_bwd_variants.py)
#pragma unroll
    for (int i = 0; i < BF_TI; ++i) {
      const int lr = ax + BF_SA * i, gr = r_base + lr;
      const RowCoef rc = rcs[lr];  // in registers: the Dq stores below may alias it
      if (written[rc.dir] == 0) {
#pragma unroll
        for (int j = 0; j < BF_TJ; ++j) {
          const int c = by + BF_SB * j;
          const bool live = rc.ok && c < n && t0 + c != (long long)rc.lab;
          Dq[c * BF_DLD + lr] = live ? bf_clean_dcos(a, rc, acc[i][j]) : 0.f;
        }
      } else {
        float cv[BF_TJ];
#pragma unroll
        for (int j = 0; j < BF_TJ; ++j) cv[j] = acc[i][j];
#pragma unroll 1
        for (int j = 0; j < BF_TJ; ++j) {
          const int c = by + BF_SB * j;
          const bool live = rc.ok && c < n && t0 + c != (long long)rc.lab;
          Dq[c * BF_DLD + lr] =
              live ? bf_written_dcos(a, rc, gr, c, last0, lastb, cv[j], wcos, wcoef) : 0.f;
        }
      }
    }
    __syncthreads();

    // demb += d_cos . the q0 tile, column by column in order
#pragma unroll 4
    for (int c = 0; c < n; ++c) {
      const float4 dlo = *reinterpret_cast<const float4*>(Dq + c * BF_DLD + er);
      const float4 dhi = *reinterpret_cast<const float4*>(Dq + c * BF_DLD + er + 4);
      const float dv[8] = {dlo.x, dlo.y, dlo.z, dlo.w, dhi.x, dhi.y, dhi.z, dhi.w};
      const float* qrow = Qt + c * ldq + ef;
      float wv[16];  // the column's features, 0 from D (a guard per load, none per product)
#pragma unroll
      for (int fq = 0; fq < 4; ++fq) {
        const float4 w = ef + 128 * fq < D ? *reinterpret_cast<const float4*>(qrow + 128 * fq)
                                           : make_float4(0.f, 0.f, 0.f, 0.f);
        wv[4 * fq] = w.x, wv[4 * fq + 1] = w.y, wv[4 * fq + 2] = w.z, wv[4 * fq + 3] = w.w;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int f = 0; f < 16; ++f) demb[i][f] = fmaf(dv[i], wv[f], demb[i][f]);
    }
    __syncthreads();  // Qt, Dq and the write plan are rebuilt by the next tile
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gr = r_base + er + i;
    if (gr >= a.R) continue;
    float* p = part + ((long long)chunk * a.R + gr) * D + ef;
#pragma unroll
    for (int fq = 0; fq < 4; ++fq)
      if (ef + 128 * fq < D)
        *reinterpret_cast<float4*>(p + 128 * fq) = make_float4(
            demb[i][4 * fq], demb[i][4 * fq + 1], demb[i][4 * fq + 2], demb[i][4 * fq + 3]);
  }
}

// ------------------------------------- backward on the tensor cores

constexpr int BB_RB = 64, BB_TC = 64;  // probe rows, tile columns
// warps a block; the recompute's warp holds 16 rows x BB_NI n8 column
// tiles, the d_emb product's BB_MI x 16 rows x D / 4 features
constexpr int BB_NW = 8, BB_THREADS = 32 * BB_NW, BB_NI = 32 / BB_NW, BB_MI = 16 / BB_NW;
static_assert(BB_NW == 8 || BB_NW == 16, "the maps below tile [64, 64] and [64, D] by 8 or 16");

// 16-byte chunks a staged int8 row of D features: whole groups of 8, so
// that swz's XOR stays inside the row (D = 64: half a group of padding)
__host__ __device__ constexpr int i8_rc(int D) { return (D / 16 + 7) / 8 * 8; }

// bytes of the block's staged E rows and of one staged q0 tile: bf16
// (INT8C: E8 and the tile int8; INT8: the tile int8)
template <int FORM>
__host__ __device__ constexpr int bb_rows_bytes(int D) {
  return FORM == FORM_INT8C ? BB_RB * i8_rc(D) * 16 : BB_RB * D * 2;
}
template <int FORM>
__host__ __device__ constexpr int bb_stage_bytes(int D) {
  return FORM == FORM_BF16 ? BB_TC * D * 2 : BB_TC * i8_rc(D) * 16;
}

// bytes of one staged q0 tile's scales (the int8 forms: qs [BB_TC] f32)
template <int FORM>
__host__ __device__ constexpr int bb_scale_bytes() {
  return FORM == FORM_BF16 ? 0 : BB_TC * 4;
}

// shared memory of the tensor-core backward at feature width D: the
// block's E rows, two staged q0 tiles (the int8 forms: with their scales,
// and the tile widened to bf16), the d_cos tiles (BF16: two, one a view's
// second term), the rows' inputs and the write plan
template <int FORM>
__host__ __device__ constexpr int bb_smem(int D) {
  return bb_rows_bytes<FORM>(D) + 2 * (bb_stage_bytes<FORM>(D) + bb_scale_bytes<FORM>()) +
         (FORM == FORM_BF16 ? 0 : BB_TC * D * 2) + (FORM == FORM_BF16 ? 2 : 1) * BB_RB * BB_TC * 2 +
         BB_RB * (int)sizeof(RowCoef) + (4 * BB_TC + 4) * (int)sizeof(int);
}

// rows [r0, r0 + n) of the row-major [*, D] int8 matrix X into S (i8_rc(D)
// chunks a row, swizzled; zero from end)
__device__ __forceinline__ void load_rows_i8(unsigned char* S, const signed char* X, long long r0,
                                             long long end, int D, int n) {
  const int ch = D / 16, rc = i8_rc(D);
  for (int i = threadIdx.x; i < n * ch; i += blockDim.x) {
    const int r = i / ch, c = i - r * ch;
    const bool ok = r0 + r < end;
    cp_async_cg(S + swz(r, 8 * c, rc), ok ? X + (r0 + r) * D + 16 * c : X, ok);
  }
}

// rows [r0, r0 + n) of the row-major [*, D] bf16 matrix X into S (D / 8
// chunks a row, swizzled; zero from end)
__device__ __forceinline__ void load_rows_bf16(unsigned char* S, const __nv_bfloat16* X,
                                               long long r0, long long end, int D, int n) {
  const int rc = D / 8;
  for (int i = threadIdx.x; i < n * rc; i += blockDim.x) {
    const int r = i / rc, ch = i - r * rc;
    const bool ok = r0 + r < end;
    cp_async_cg(S + swz(r, 8 * ch, rc), ok ? X + (r0 + r) * D + 8 * ch : X, ok);
  }
}

// the block's probe rows [r_base, + BB_RB) as the form's recompute reads
// them: bf16(E), or (INT8C) E8
template <int FORM>
__device__ __forceinline__ void bwd_load_rows(const Args& a, unsigned char* Es, int r_base) {
  if constexpr (FORM == FORM_INT8C) load_rows_i8(Es, a.E8, r_base, a.R, a.D, BB_RB);
  else load_rows_bf16(Es, a.Eb, r_base, a.R, a.D, BB_RB);
}

// q0 rows [t0, t0 + 64) as stored (zero from c_end); the int8 forms also
// their scales into sq [BB_TC] (qs may sit at any 4-byte offset)
template <int FORM>
__device__ __forceinline__ void bwd_load_tile(const Args& a, unsigned char* S, float* sq,
                                              long long t0, long long c_end) {
  if constexpr (FORM == FORM_BF16) {
    load_rows_bf16(S, static_cast<const __nv_bfloat16*>(a.q0), t0, c_end, a.D, BB_TC);
  } else {
    load_rows_i8(S, static_cast<const signed char*>(a.q0), t0, c_end, a.D, BB_TC);
    for (int i = threadIdx.x; i < BB_TC; i += blockDim.x)
      cp_async_ca4(sq + i, t0 + i < c_end ? a.qs + t0 + i : a.qs, t0 + i < c_end);
  }
}

// the int8 tile S widened to bf16 into Qb (D / 8 chunks a row, swizzled)
__device__ __forceinline__ void widen_tile(unsigned char* Qb, const unsigned char* S, int D) {
  const int ch = D / 16, rc = i8_rc(D);
  for (int i = threadIdx.x; i < BB_TC * ch; i += blockDim.x) {
    const int r = i / ch, c = i - r * ch;
    widen16(Qb, r, 16 * c, D / 8, *reinterpret_cast<const uint4*>(S + swz(r, 8 * c, rc)));
  }
}

// the backward's recompute map: warp w holds rows 16 (w % 4) .., columns
// 8 BB_NI (w / 4) .. of a [64, 64] cosine tile
__device__ __forceinline__ void bwd_cos_map(int& m1, int& n1) {
  const int warp = threadIdx.x >> 5;
  m1 = (warp & 3) * 16;
  n1 = (warp >> 2) * 8 * BB_NI;
}

// the clean cosines acc[0][ni][e] of the block's rows m1 + g (+ 8) and the
// tile's columns n1 + 8 ni + 2t (+ 1), ni < BB_NI, the tile staged in S (as
// bf16 in Q for the INT8 form; its scales in sq, 0 from c_end): BF16 / INT8
// the k16 chain over bf16 operands (the forward's: module header), INT8
// then times q0's column scale; INT8C the exact int32 sum of E8 . q, then
// f32(sum) * (se[row] * qs[col])
template <int FORM>
__device__ __forceinline__ void tile_cos(const Args& a, const unsigned char* Es,
                                         const unsigned char* S, const unsigned char* Q,
                                         const float* sq, int r_base, int m1, int n1,
                                         float (&acc)[1][BB_NI][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  if constexpr (FORM == FORM_INT8C) {
    int iacc[1][BB_NI][4] = {};
    mma_nt_s8<1, BB_NI>(iacc, Es, i8_rc(a.D), m1, S, i8_rc(a.D), n1, a.D / 32);
    float se[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r_base + m1 + g + 8 * h;
      se[h] = r < a.R ? a.se[r] : 0.f;
    }
#pragma unroll
    for (int ni = 0; ni < BB_NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[0][ni][e] = (float)iacc[0][ni][e] * (se[e >> 1] * sq[n1 + 8 * ni + 2 * t + (e & 1)]);
  } else {
#pragma unroll
    for (int ni = 0; ni < BB_NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[0][ni][e] = 0.f;
    mma_nt<1, BB_NI>(acc, Es, a.D / 8, m1, Q, a.D / 8, n1, a.D / 16);
    if constexpr (FORM == FORM_INT8)
#pragma unroll
      for (int ni = 0; ni < BB_NI; ++ni)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float sc = sq[n1 + 8 * ni + 2 * t + j];
          acc[0][ni][j] *= sc;
          acc[0][ni][2 + j] *= sc;
        }
  }
}

// the BF16, INT8 and INT8C forms (module header)
template <int FORM>
__global__ void __launch_bounds__(BB_THREADS, 1)
    quad_bwd_tc_kernel(Args a, BwdRows br, long long cols_per_chunk, int n_rg, float* part,
                       float* wcoef) {
  constexpr bool I8 = FORM != FORM_BF16;  // q0 stored int8
  constexpr int N_DQ = I8 ? 1 : 2;        // d_cos tiles
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  const int D = a.D, rcd = D / 8, stage = bb_stage_bytes<FORM>(D);
  unsigned char* Es = bwd_smem;                          // E rows [BB_RB][D]
  unsigned char* Qs = Es + bb_rows_bytes<FORM>(D);       // q0 tiles as stored [2][BB_TC][D]
  float* Sqs = reinterpret_cast<float*>(Qs + 2 * stage);  // int8: their scales [2][BB_TC]
  unsigned char* Qb = Qs + 2 * (stage + bb_scale_bytes<FORM>());  // int8: the tile as bf16
  unsigned char* Dq = Qb + (I8 ? BB_TC * D * 2 : 0);     // d_cos on q0's rows [N_DQ][BB_RB][BB_TC]
  RowCoef* rcs = reinterpret_cast<RowCoef*>(Dq + N_DQ * BB_RB * BB_TC * 2);
  int* last0 = reinterpret_cast<int*>(rcs + BB_RB);
  int* lastb = last0 + 2 * BB_TC;
  int* written = lastb + 2 * BB_TC;  // [4]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int rg = blockIdx.x % n_rg, chunk = blockIdx.x / n_rg;
  const int r_base = rg * BB_RB;
  const long long c_begin = (long long)chunk * cols_per_chunk;
  const long long c_end = min(a.Q, c_begin + cols_per_chunk);
  const int n_tiles = c_end > c_begin ? (int)((c_end - c_begin + BB_TC - 1) / BB_TC) : 0;

  bwd_load_rows<FORM>(a, Es, r_base);
  if (n_tiles > 0) bwd_load_tile<FORM>(a, Qs, Sqs, c_begin, c_end);
  cp_async_commit();
  for (int r = tid; r < BB_RB; r += BB_THREADS) rcs[r] = row_coef(a, br, r_base + r);

  int m1, n1;
  bwd_cos_map(m1, n1);
  // d_emb map: warp w holds rows 16 BB_MI (w % RS) .., features D / 4 *
  // (w / RS) .. (nj2 n8 tiles, 16 at D = 512)
  constexpr int RS = 4 / BB_MI;  // the warps' row slabs
  const int m2 = (warp % RS) * 16 * BB_MI, f2 = (warp / RS) * (D / 4), nj2 = D / 32;
  float acc2[BB_MI][16][4] = {};

  for (int ti = 0; ti < n_tiles; ++ti) {
    const long long t0 = c_begin + (long long)ti * BB_TC;
    if (ti + 1 < n_tiles)
      bwd_load_tile<FORM>(a, Qs + ((ti + 1) & 1) * stage, Sqs + ((ti + 1) & 1) * BB_TC,
                          t0 + BB_TC, c_end);
    cp_async_commit();
    cp_async_wait<1>();  // tile ti (and the E rows) landed
    mark_writes<BB_TC>(a, t0, last0, lastb, written);  // its barriers publish them
    const unsigned char* S = Qs + (ti & 1) * stage;
    const float* sq = Sqs + (ti & 1) * BB_TC;  // int8: the tile's column scales
    const unsigned char* Q = I8 ? Qb : S;  // the tile as bf16: the d_emb product's operand

    float acc1[1][BB_NI][4];
    if constexpr (FORM == FORM_INT8) {
      widen_tile(Qb, S, D);
      __syncthreads();
    }
    tile_cos<FORM>(a, Es, S, Q, sq, r_base, m1, n1, acc1);
    if constexpr (FORM == FORM_INT8C) widen_tile(Qb, S, D);  // read after the d_cos barrier

    // d_cos from the fragments into Dq as bf16 (BF16: what bf16 does not
    // hold of it, nothing, route_dcos having rounded it, with the second
    // view's term into the second tile); the written rows' into wcoef.
    // A row whose rounding tile holds no write takes the clean route,
    // unrolled over its 8 elements; one whose tile does takes every route
    // one element at a time (header).
    bool two = false;
    auto put = [&](int lr, int c, float dq, float dq2) {
      const float hq = bf16r(dq);
      *reinterpret_cast<__nv_bfloat16*>(Dq + swz(lr, c, BB_TC / 8)) = __float2bfloat16_rn(hq);
      if constexpr (!I8) {
        const float lq = dq2 + (dq - hq);
        *reinterpret_cast<__nv_bfloat16*>(Dq + BB_RB * BB_TC * 2 + swz(lr, c, BB_TC / 8)) =
            __float2bfloat16_rn(lq);
        two = two || lq != 0.f;
      }
    };
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int lr = m1 + g + 8 * h, gr = r_base + lr;
      const RowCoef rc = rcs[lr];
      if (written[2 + rc.dir] == 0) {
#pragma unroll
        for (int ni = 0; ni < BB_NI; ++ni)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int c = n1 + 8 * ni + 2 * t + j;
            const long long gc = t0 + c;
            float dq = 0.f, dq2 = 0.f, dg, dv;
            int i0, ib;
            if (rc.ok && gc < c_end && gc != (long long)rc.lab)
              route_dcos<FORM, BB_TC, false>(a, rc, gr, c, last0, lastb, written,
                                             acc1[0][ni][2 * h + j], I8 ? sq[c] : 1.f, dq, dq2,
                                             dg, dv, i0, ib);
            put(lr, c, dq, dq2);
          }
      } else {
        float cv[2 * BB_NI];
#pragma unroll
        for (int k = 0; k < 2 * BB_NI; ++k) cv[k] = acc1[0][k >> 1][2 * h + (k & 1)];
        float* wc = wcoef + (long long)gr * 2 * a.BP;
#pragma unroll 1
        for (int k = 0; k < 2 * BB_NI; ++k) {
          const int c = n1 + 8 * (k >> 1) + 2 * t + (k & 1);
          const long long gc = t0 + c;
          float dq = 0.f, dq2 = 0.f, dg = 0.f, dv = 0.f;
          if (rc.ok && gc < c_end && gc != (long long)rc.lab) {
            int i0, ib;
            route_dcos<FORM, BB_TC>(a, rc, gr, c, last0, lastb, written, cv[k],
                                    I8 ? sq[c] : 1.f, dq, dq2, dg, dv, i0, ib);
            if (i0 >= 0) wc[i0] = dg;  // this thread alone holds (row, writer)
            if (ib >= 0) wc[a.BP + ib] = dv;
          }
          put(lr, c, dq, dq2);
        }
      }
    }
    if constexpr (I8) __syncthreads();  // Dq (and the widened tile) complete
    else two = __syncthreads_or(two);

    // d_emb += d_cos . q0 tile (BF16: a second pass for the second views'
    // terms): the tile's product over its 64 columns on the tensor core from
    // a zero accumulator, added to d_emb in f32 (mma_bf16.cuh's header)
    for (int p = 0; p < (two ? 2 : 1); ++p) {
      const unsigned char* A = Dq + p * BB_RB * BB_TC * 2;
      uint32_t av[BB_TC / 16][BB_MI][4];
#pragma unroll
      for (int ks = 0; ks < BB_TC / 16; ++ks)
#pragma unroll
        for (int mi = 0; mi < BB_MI; ++mi) load_a(av[ks][mi], A, BB_TC / 8, m2 + 16 * mi, ks);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        if (2 * jj >= nj2) continue;
        float pt[BB_MI][2][4];
#pragma unroll
        for (int ks = 0; ks < BB_TC / 16; ++ks) {
          uint32_t b[4];
          load_b_kn(b, Q, rcd, f2 + 16 * jj, ks);
#pragma unroll
          for (int mi = 0; mi < BB_MI; ++mi) {
            if (ks == 0) {
              mma_bf16_0(pt[mi][0], av[ks][mi], b[0], b[1]);
              mma_bf16_0(pt[mi][1], av[ks][mi], b[2], b[3]);
            } else {
              mma_bf16(pt[mi][0], av[ks][mi], b[0], b[1]);
              mma_bf16(pt[mi][1], av[ks][mi], b[2], b[3]);
            }
          }
        }
#pragma unroll
        for (int mi = 0; mi < BB_MI; ++mi)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc2[mi][2 * jj + h][e] += pt[mi][h][e];
      }
    }
    __syncthreads();  // the tile's stages, Dq and the write plan are rebuilt next
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mi = 0; mi < BB_MI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gr = r_base + m2 + 16 * mi + g + 8 * h;
      if (gr >= a.R) continue;
      float* p = part + ((long long)chunk * a.R + gr) * D + f2 + 2 * t;
#pragma unroll
      for (int jj = 0; jj < 16; ++jj)
        if (jj < nj2)
          *reinterpret_cast<float2*>(p + 8 * jj) =
              make_float2(acc2[mi][jj][2 * h], acc2[mi][jj][2 * h + 1]);
    }
}

// d_emb = sum of the chunk partials in chunk order, the written rows
// after them (wcoef [R][2][BP] . G / V of the row's direction); d_gt, the
// target
// column's dz: (exp(scale*phi(gt_v) - logz_v) - 1) * d_ce_v * scale on rows
// whose (shard-local) label is >= 0
__global__ void quad_bwd_merge_kernel(Args a, BwdRows br, int nchunk, const float* part,
                                      const float* wcoef, float* d_emb, float* dgt) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n = (long long)a.R * a.D;
  if (idx < n) {
    float acc = 0.f;
    for (int c = 0; c < nchunk; ++c) acc += part[(long long)c * n + idx];
    const int r = (int)(idx / a.D), k = (int)(idx - (long long)r * a.D), d = r / a.B;
    const float* wc = wcoef + (long long)r * 2 * a.BP;
    for (int i = 0; i < a.BP; ++i) {
      const long long w = (long long)(d * a.BP + i) * a.D + k;
      if (wc[i] != 0.f) acc = fmaf(wc[i], a.G[w], acc);
      if (wc[a.BP + i] != 0.f) acc = fmaf(wc[a.BP + i], a.V[w], acc);
    }
    d_emb[idx] = acc;
  }
  if (idx < 2 * a.R) {
    const int v = (int)(idx / a.R), r = (int)(idx - (long long)v * a.R);
    const float zt = a.scale * phi_target(a.gt[idx], a);
    dgt[idx] = a.labels[r] >= 0 ? (expf(zt - br.logz[idx]) - 1.0f) * br.dce[idx] * a.scale : 0.f;
  }
}

Args make_args(const void* q0, long long Q, int D, const float* E, const float* G,
               const float* V, const int* rows, const int* cols, const int* blend,
               const int* labels, const float* gt, int B, int BP, int R, int k, int loss_type,
               float margin, float scale, float mask_svfc, float cos_m, float sin_m,
               const float* qs, const signed char* E8, const float* se, const void* Eb,
               int rtile, int twin) {
  Args a;
  a.q0 = q0;
  a.Q = Q;
  a.D = D;
  a.E = E;
  a.G = G;
  a.V = V;
  a.rows = rows;
  a.cols = cols;
  a.blend = blend;
  a.labels = labels;
  a.gt = gt;
  a.B = B;
  a.BP = BP;
  a.ND = R / B;
  a.R = R;
  a.k = k;
  a.loss_type = loss_type;
  a.margin = margin;
  a.scale = scale;
  a.mask_svfc = mask_svfc;
  a.cos_m = cos_m;
  a.sin_m = sin_m;
  a.qs = qs;
  a.E8 = E8;
  a.se = se;
  a.rtile = rtile;
  a.twin = twin;
  a.Eb = static_cast<const __nv_bfloat16*>(Eb);
  return a;
}

// the operands a tensor-core form reads are there: bf16(E) (INT8C: E8 and
// its scales), q0's scales on an int8 queue
template <int FORM>
bool tc_operands(const Args& a) {
  return (FORM == FORM_INT8C ? a.E8 != nullptr && a.se != nullptr : a.Eb != nullptr) &&
         (FORM == FORM_BF16 || a.qs != nullptr);
}

// the written cosines [R][2][BP] into wcos, once a launch (the forward and
// the F32 backward)
cudaError_t launch_written_cos(const Args& a, float* wcos, cudaStream_t st) {
  const long long nw = (long long)a.R * 2 * a.BP;
  if (nw == 0) return cudaSuccess;
  if (wcos == nullptr) return cudaErrorInvalidValue;
  quad_written_cos_kernel<<<(unsigned)((nw + 255) / 256), 256, 0, st>>>(a, wcos);
  return cudaGetLastError();
}

template <int FORM, int ROWS>
cudaError_t launch_fwd_rows(const Args& a, const float* wcos, float* part, int nchunk,
                            long long cols_per_chunk, cudaStream_t st) {
  constexpr int smem = f_smem<FORM, ROWS>();
  if (FORM != FORM_F32 && (!tc_operands<FORM>(a) || a.D > F_DMAX)) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(quad_fwd_kernel<FORM, ROWS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int n_rg = (a.R + ROWS - 1) / ROWS;
  quad_fwd_kernel<FORM, ROWS>
      <<<nchunk * n_rg, f_threads<FORM>(), smem, st>>>(a, cols_per_chunk, wcos, part);
  return cudaGetLastError();
}

template <int FORM>
cudaError_t launch_fwd_form(const Args& a, const float* wcos, float* part, int nchunk,
                            long long cols_per_chunk, cudaStream_t st) {
  if constexpr (FORM == FORM_F32)
    if (a.R > F_TC_ROWS)
      return launch_fwd_rows<FORM, F_ROWS>(a, wcos, part, nchunk, cols_per_chunk, st);
  return launch_fwd_rows<FORM, F_TC_ROWS>(a, wcos, part, nchunk, cols_per_chunk, st);
}

// the forward: the written cosines into wcos, then the block pass over
// nchunk column ranges (x the row groups) into part
cudaError_t launch_fwd_blocks(const Args& a, int form, float* wcos, float* part, int nchunk,
                              long long cols_per_chunk, cudaStream_t st) {
  const cudaError_t err = launch_written_cos(a, wcos, st);
  if (err != cudaSuccess) return err;
  switch (form) {
    case FORM_F32: return launch_fwd_form<FORM_F32>(a, wcos, part, nchunk, cols_per_chunk, st);
    case FORM_BF16: return launch_fwd_form<FORM_BF16>(a, wcos, part, nchunk, cols_per_chunk, st);
    case FORM_INT8: return launch_fwd_form<FORM_INT8>(a, wcos, part, nchunk, cols_per_chunk, st);
    case FORM_INT8C:
      return launch_fwd_form<FORM_INT8C>(a, wcos, part, nchunk, cols_per_chunk, st);
  }
  return cudaErrorInvalidValue;
}

// the F32 form: the written cosines, then the block pass
cudaError_t launch_bwd_f32(const Args& a, const BwdRows& br, float* part, float* wcoef,
                           float* wcos, int nchunk, long long cols_per_chunk, cudaStream_t st) {
  if (wcoef == nullptr || wcos == nullptr) return cudaErrorInvalidValue;
  cudaError_t err = launch_written_cos(a, wcos, st);
  if (err != cudaSuccess) return err;
  const int n_rg = (a.R + BF_RB - 1) / BF_RB, smem = bf_smem(a.D);
  err = cudaFuncSetAttribute(quad_bwd_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  quad_bwd_f32_kernel<<<nchunk * n_rg, BF_THREADS, smem, st>>>(a, br, cols_per_chunk, n_rg, wcos,
                                                               part, wcoef);
  return cudaGetLastError();
}

template <int FORM>
cudaError_t launch_bwd_tc(const Args& a, const BwdRows& br, float* part, float* wcoef, int nchunk,
                          long long cols_per_chunk, cudaStream_t st) {
  const int n_rg = (a.R + BB_RB - 1) / BB_RB, smem = bb_smem<FORM>(a.D);
  if (wcoef == nullptr || !tc_operands<FORM>(a)) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(quad_bwd_tc_kernel<FORM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  quad_bwd_tc_kernel<FORM><<<nchunk * n_rg, BB_THREADS, smem, st>>>(a, br, cols_per_chunk, n_rg,
                                                                    part, wcoef);
  return cudaGetLastError();
}

// ------------------------------------------------------------ clean cosines

// out [R][Q] = the clean-tile cosines with the forward's tiling: one block
// of ROWS rows per row group and 64 columns, fwd_product as the forward
// runs it (every form); the kernels below give the backward's. A parity
// probe that exposes the dot both kernels share.
template <int FORM, int ROWS>
__global__ void __launch_bounds__(f_threads<FORM>()) clean_cos_fwd_kernel(Args a, float* out) {
  extern __shared__ __align__(16) unsigned char ccf_smem[];
  unsigned char* stg = ccf_smem + f_e_bytes<FORM, ROWS>();
  float* Cs = reinterpret_cast<float*>(stg + f_nst<FORM>() * f_stage_bytes<FORM, ROWS>());
  const int r_base = blockIdx.y * ROWS;
  const long long t0 = (long long)blockIdx.x * F_TC;
  if constexpr (FORM != FORM_F32) {
    fwd_load_e<FORM, ROWS>(a, ccf_smem, r_base);
    cp_async_commit();
  }
  uint4 first[f_nst<FORM>() - 1];
  fwd_prologue<FORM, ROWS>(a, stg, r_base, t0, a.Q, first);
  fwd_widen_first<FORM, ROWS>(a, stg, first);
  fwd_product<FORM, ROWS>(a, ccf_smem, stg, r_base, t0, a.Q, Cs);
  __syncthreads();
  for (int i = threadIdx.x; i < ROWS * F_TC; i += f_threads<FORM>()) {
    const int r = i / F_TC, c = i % F_TC;
    if (r_base + r < a.R && t0 + c < a.Q) out[(r_base + r) * a.Q + t0 + c] = Cs[r * F_CLD + c];
  }
}

// ... with the backward's tiling: one 64-row block per row group and 64
// columns, staged and multiplied as quad_bwd_tc_kernel does (every
// tensor-core form)
template <int FORM>
__global__ void __launch_bounds__(BB_THREADS) clean_cos_bwd_tc_kernel(Args a, float* out) {
  extern __shared__ __align__(16) unsigned char ccb_smem[];
  const int r_base = blockIdx.y * BB_RB, g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const long long t0 = (long long)blockIdx.x * BB_TC;
  unsigned char* Es = ccb_smem;
  unsigned char* S = Es + bb_rows_bytes<FORM>(a.D);
  float* sq = reinterpret_cast<float*>(S + bb_stage_bytes<FORM>(a.D));
  unsigned char* Qb = S + bb_stage_bytes<FORM>(a.D) + bb_scale_bytes<FORM>();
  bwd_load_rows<FORM>(a, Es, r_base);
  bwd_load_tile<FORM>(a, S, sq, t0, a.Q);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if constexpr (FORM == FORM_INT8) {
    widen_tile(Qb, S, a.D);
    __syncthreads();
  }
  int m1, n1;
  bwd_cos_map(m1, n1);
  float acc[1][BB_NI][4];
  tile_cos<FORM>(a, Es, S, FORM == FORM_INT8 ? Qb : S, sq, r_base, m1, n1, acc);
#pragma unroll
  for (int ni = 0; ni < BB_NI; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const long long r = r_base + m1 + g + 8 * (e >> 1);
      const long long c = t0 + n1 + 8 * ni + 2 * t + (e & 1);
      if (r < a.R && c < a.Q) out[r * a.Q + c] = acc[0][ni][e];
    }
}

template <int FORM>
cudaError_t launch_clean_cos_bwd_tc(const Args& a, float* out, cudaStream_t st) {
  const unsigned n_t = (unsigned)((a.Q + BB_TC - 1) / BB_TC);
  const int smem = bb_rows_bytes<FORM>(a.D) + bb_stage_bytes<FORM>(a.D) + bb_scale_bytes<FORM>() +
                   (FORM == FORM_INT8 ? BB_TC * a.D * 2 : 0);
  if (!tc_operands<FORM>(a)) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(clean_cos_bwd_tc_kernel<FORM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  clean_cos_bwd_tc_kernel<FORM><<<dim3(n_t, (a.R + BB_RB - 1) / BB_RB), BB_THREADS, smem, st>>>(
      a, out);
  return cudaGetLastError();
}

template <int FORM>
cudaError_t launch_clean_cos_fwd(const Args& a, float* out, cudaStream_t st) {
  constexpr int ROWS = FORM == FORM_F32 ? F_ROWS : F_TC_ROWS, smem = f_smem<FORM, ROWS>();
  const unsigned n_t = (unsigned)((a.Q + F_TC - 1) / F_TC);
  if (FORM != FORM_F32 && (!tc_operands<FORM>(a) || a.D > F_DMAX)) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(clean_cos_fwd_kernel<FORM, ROWS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  clean_cos_fwd_kernel<FORM, ROWS>
      <<<dim3(n_t, (a.R + ROWS - 1) / ROWS), f_threads<FORM>(), smem, st>>>(a, out);
  return cudaGetLastError();
}

// ... the F32 form with the backward's tiling: one block per row group and
// 64 columns, bf_dots as quad_bwd_f32_kernel runs it (its staging, its
// micro-tiles)
__global__ void __launch_bounds__(BF_THREADS) clean_cos_bwd_f32_kernel(Args a, float* out) {
  extern __shared__ __align__(16) float ccb_f32[];
  const int r_base = blockIdx.y * BF_RB;
  const long long t0 = (long long)blockIdx.x * BF_TC;
  float* Qt = ccb_f32;
  float* stg = Qt + BF_TC * (a.D + 4);
  int ax, by;
  bf_cos_map(ax, by);
  float acc[BF_TI][BF_TJ];
  bf_dots(acc, stg, Qt, a, r_base, min(BF_RB, a.R - r_base), t0,
          (int)min((long long)BF_TC, a.Q - t0), ax, by);
#pragma unroll
  for (int i = 0; i < BF_TI; ++i) {
    const long long r = r_base + ax + BF_SA * i;
#pragma unroll
    for (int j = 0; j < BF_TJ; ++j) {
      const long long c = t0 + by + BF_SB * j;
      if (r < a.R && c < a.Q) out[r * a.Q + c] = acc[i][j];
    }
  }
}

cudaError_t launch_clean_cos_bwd_f32(const Args& a, float* out, cudaStream_t st) {
  const unsigned n_t = (unsigned)((a.Q + BF_TC - 1) / BF_TC);
  const int smem = 4 * (BF_TC * (a.D + 4) + BF_STG);
  const cudaError_t err = cudaFuncSetAttribute(
      clean_cos_bwd_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  clean_cos_bwd_f32_kernel<<<dim3(n_t, (a.R + BF_RB - 1) / BF_RB), BF_THREADS, smem, st>>>(a,
                                                                                          out);
  return cudaGetLastError();
}

}  // namespace

#define QUAD_COMMON_PARAMS                                                                     \
  const void *q0, long long Q, int D, const float *E, const float *G, const float *V,        \
      const int *rows, const int *cols, const int *blend, const int *labels, const float *gt, \
      int B, int BP, int R, int k, int loss_type, float margin, float scale, float mask_svfc, \
      float cos_m, float sin_m, const float *qs, const signed char *E8, const float *se,     \
      const void *Eb, int form, int rtile, int twin
#define QUAD_COMMON_ARGS                                                                    \
  q0, Q, D, E, G, V, rows, cols, blend, labels, gt, B, BP, R, k, loss_type, margin, scale, \
      mask_svfc, cos_m, sin_m, qs, E8, se, Eb, rtile, twin

extern "C" {

const char* quad_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// the forward's shared memory a block (bytes) of the form for R probe rows:
// ops/twin_margin.py's fwd_geometry computes the same
int quad_fwd_smem(int form, int R) {
  switch (form) {
    case FORM_F32: return R > F_TC_ROWS ? f_smem<FORM_F32, F_ROWS>() : f_smem<FORM_F32, 128>();
    case FORM_BF16: return f_smem<FORM_BF16, F_TC_ROWS>();
    case FORM_INT8: return f_smem<FORM_INT8, F_TC_ROWS>();
    case FORM_INT8C: return f_smem<FORM_INT8C, F_TC_ROWS>();
  }
  return -1;
}

// forward (quad, or twin with twin = 1): the written cosines into wcos
// ([R][2][BP] f32 scratch), then nchunk column ranges of cols_per_chunk (a
// multiple of 64) columns, each with every row group, into part
// ([nchunk][2][R][2 + 16] f32 scratch); outputs [2][R] and [2][R][k]
int quad_fwd_launch(QUAD_COMMON_PARAMS, float* part, float* wcos, int nchunk,
                    long long cols_per_chunk, float* ce, float* neg, float* logz, float* topk,
                    void* stream) {
  const Args a = make_args(QUAD_COMMON_ARGS);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = launch_fwd_blocks(a, form, wcos, part, nchunk, cols_per_chunk, st);
  if (err != cudaSuccess) return (int)err;
  quad_fwd_merge_kernel<<<(2 * R + 127) / 128, 128, 0, st>>>(a, nchunk, part, ce, neg, logz,
                                                              topk);
  return (int)cudaGetLastError();
}

// partial forward over a shard's block (Q = its columns, shard-local cols
// and labels): the same block pass, then m, s [2][R] and topk [2][R][k]
int quad_partial_fwd_launch(QUAD_COMMON_PARAMS, float* part, float* wcos, int nchunk,
                            long long cols_per_chunk, float* m, float* s, float* topk,
                            void* stream) {
  const Args a = make_args(QUAD_COMMON_ARGS);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = launch_fwd_blocks(a, form, wcos, part, nchunk, cols_per_chunk, st);
  if (err != cudaSuccess) return (int)err;
  quad_partial_merge_kernel<<<(2 * R + 127) / 128, 128, 0, st>>>(a, nchunk, part, m, s, topk);
  return (int)cudaGetLastError();
}

// backward (and the partial backward, with a shard's block, shard-local
// cols and labels and the global row vectors): nchunk column ranges x
// row groups of 64 rows; part is [nchunk][R][D] f32 scratch; wcoef
// [R][2][BP] f32 scratch, zeroed by the caller; wcos (F32, else null)
// [R][2][BP] f32 scratch; outputs d_emb [R][D] and d_gt [2][R]
int quad_bwd_launch(QUAD_COMMON_PARAMS, const float* logz, const float* kth, const float* dce,
                    const float* dneg, float* part, float* wcoef, float* wcos, int nchunk,
                    long long cols_per_chunk, float* d_emb, float* dgt, void* stream) {
  const Args a = make_args(QUAD_COMMON_ARGS);
  BwdRows br;
  br.logz = logz;
  br.kth = kth;
  br.dce = dce;
  br.dneg = dneg;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaErrorInvalidValue;
  switch (form) {
    case FORM_F32:
      err = launch_bwd_f32(a, br, part, wcoef, wcos, nchunk, cols_per_chunk, st);
      break;
    case FORM_BF16:
      err = launch_bwd_tc<FORM_BF16>(a, br, part, wcoef, nchunk, cols_per_chunk, st);
      break;
    case FORM_INT8:
      err = launch_bwd_tc<FORM_INT8>(a, br, part, wcoef, nchunk, cols_per_chunk, st);
      break;
    case FORM_INT8C:
      err = launch_bwd_tc<FORM_INT8C>(a, br, part, wcoef, nchunk, cols_per_chunk, st);
      break;
  }
  if (err != cudaSuccess) return (int)err;
  const long long n = (long long)R * D;
  quad_bwd_merge_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(a, br, nchunk, part, wcoef,
                                                                     d_emb, dgt);
  return (int)cudaGetLastError();
}

// the clean-tile cosines [R][Q] of q0 (no writes, no labels), with the
// forward's tiling (bwd_tiles = 0) or the backward's
int quad_clean_cos_launch(QUAD_COMMON_PARAMS, int bwd_tiles, float* out, void* stream) {
  const Args a = make_args(QUAD_COMMON_ARGS);
  cudaStream_t st = (cudaStream_t)stream;
  switch (form) {
    case FORM_F32:
      return (int)(bwd_tiles ? launch_clean_cos_bwd_f32(a, out, st)
                             : launch_clean_cos_fwd<FORM_F32>(a, out, st));
    case FORM_BF16:
      return (int)(bwd_tiles ? launch_clean_cos_bwd_tc<FORM_BF16>(a, out, st)
                             : launch_clean_cos_fwd<FORM_BF16>(a, out, st));
    case FORM_INT8:
      return (int)(bwd_tiles ? launch_clean_cos_bwd_tc<FORM_INT8>(a, out, st)
                             : launch_clean_cos_fwd<FORM_INT8>(a, out, st));
    case FORM_INT8C:
      return (int)(bwd_tiles ? launch_clean_cos_bwd_tc<FORM_INT8C>(a, out, st)
                             : launch_clean_cos_fwd<FORM_INT8C>(a, out, st));
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
