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
// F32, INT8 and INT8C forms' arithmetic is IEEE f32 FMA or exact int32 (no
// TF32); the BF16 form's two products run on the tensor cores (below).
//
// Queue forms (template FORM; the wrapper's module docstring has the JAX
// rounding points each follows):
//  * F32:   q0 f32; E, G, V f32.
//  * BF16:  q0 bf16; E, G, V come rounded to bf16 (held in f32), so every
//           product is exact in f32 and the FMA chain computes what the TPU's
//           matrix unit computes, up to the order of summation.
//  * INT8:  q0 int8 with per-row scales qs [Q]; cos = (E . q) * qs[col], E
//           rounded to bf16 as above.
//  * INT8C: as INT8, but the clean dot is E8 . q with E8 the per-row int8
//           probes (scales se [R]): an exact int32 sum by __dp4a, then
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
// (>= 1.3 ms): operations-bound.
//
// Design.
//  * The TPU carried (m, s, top-k) and d_emb in VMEM across a sequential
//    grid; here blocks run in parallel, so every block writes a partial
//    over its own contiguous column range and a second launch merges the
//    partials in a fixed order (logsumexp merge, k-way top-k merge, sum of
//    d_emb partials). No float atomics: results are bit-stable.
//  * Forward: one block holds all R <= 256 probe rows, so each q0 tile is
//    read once for both directions. A 256-thread register-tiled f32 GEMM
//    (8x8 outputs per thread) fills a [256, 64] cosine tile in shared
//    memory; then each thread owns one probe row and streams the tile's 64
//    columns into that row's running (max, sumexp) and register top-k for
//    both views.
//  * Backward: one block holds 32 probe rows x a column range, so its d_emb
//    partial [32, D] fits in registers (64 per thread at D = 512). The 8
//    row groups of one range are adjacent in launch order and share each
//    q0 tile through L2. Per tile: GEMM cos [32, 64] -> d_cos -> GEMM
//    d_cos @ q0 tile.
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
//    the streamed (max, sumexp) and top-k, the partial merge, d_cos of a
//    column and the shared-memory tile product.
//  * The BF16 form on the tensor cores (mma.sync m16n8k16, csrc/
//    mma_bf16.cuh; operands staged in shared memory as bf16 by cp.async,
//    swizzled for conflict-free ldmatrix). Its clean cosines are one chain
//    over the feature axis in k16 steps, in order, each step's product
//    added in f32 (mma_bf16.cuh: kept in the tensor core's accumulator, the
//    chain drifted enough at D = 512 to put 20 d_emb rows beyond 1e-5 of
//    the max, against a limit of 8; with the f32 adds, 3), in the forward (E and q0 staged 64 features at a time, three stages in
//    flight; warps of 32 rows x 64 or 32 columns) and in the backward's
//    recompute (E's 64 rows held whole, warps of 16 rows x 32 columns), so
//    that the two produce the same bits and the backward's top-k test meets
//    the forward's kth exactly (quad_clean_cos_launch shows both tilings).
//    Backward (quad_bwd_bf16_kernel): a block holds 64 probe rows x a
//    column range, so each q0 tile is read by R / 64 blocks (4 at the
//    quad's R = 256, half the 32-row FMA kernel's L2 traffic); its d_emb
//    partial [64, D] lives in mma accumulators, 128 f32 a thread at D =
//    512. Per 64-column tile (two tiles in flight): cos = E . q0^T; d_cos
//    in registers from the fragments, rounded to bf16 (exact as an mma
//    operand) into shared memory; d_emb += d_cos . q0 tile, the tile's
//    product added in f32. A row whose rounding tile holds no write takes
//    the clean route only, unrolled; one whose tile does takes every route
//    an element at a time (inlined into every unrolled element, the written
//    routes' code slowed the whole kernel by a sixth on an H100 at Q =
//    4,194,304, though they run on few tiles). Where both of a
//    written tile's views score against q0's row, their separately rounded
//    d_cos go in as two bf16 products (a second pass over the tile, taken
//    only when the block has one). A column this step writes keeps the
//    FMA chain `row_dot` in both passes; its d_cos towards the g / v row
//    goes to wcoef [R][2][BP] at (row, writer), which only that column's
//    thread writes, and the merge adds wcoef . G / V: no atomics.

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

// dot product in index order, the same FMA chain as the GEMM tiles
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

// acc[i][j] = the exact int32 dot, over the feature axis, of the int8 rows
// X[x0 + ay + SA*i] and Y[y0 + bx + SB*j] of row-major [*, D] int8 matrices
// read as D / 4 words: DW words (4 DW features) at a time into shared memory
// word-major (As [DW][ALD], Bs [DW][BLD]), four products per __dp4a; rows at
// or past x_end / y_end read as 0. |acc| <= 127^2 * D < 2^24 at D <= 1024,
// so f32(acc) is exact too.
template <int NX, int NY, int DW, int THREADS, int ALD, int BLD, int TI, int TJ, int SA, int SB>
__device__ __forceinline__ void tile_gemm_i8(int (&acc)[TI][TJ], int* As, int* Bs, const int* X,
                                             long long x0, long long x_end, const int* Y,
                                             long long y0, long long y_end, int words, int ay,
                                             int bx) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < TI; ++i)
#pragma unroll
    for (int j = 0; j < TJ; ++j) acc[i][j] = 0;
  for (int k0 = 0; k0 < words; k0 += DW) {
#pragma unroll
    for (int l = 0; l < NX * DW / THREADS; ++l) {
      const int idx = l * THREADS + tid, row = idx / DW, kk = idx % DW;
      const long long g = x0 + row;
      As[kk * ALD + row] = g < x_end ? X[g * words + k0 + kk] : 0;
    }
#pragma unroll
    for (int l = 0; l < NY * DW / THREADS; ++l) {
      const int idx = l * THREADS + tid, row = idx / DW, kk = idx % DW;
      const long long g = y0 + row;
      Bs[kk * BLD + row] = g < y_end ? Y[g * words + k0 + kk] : 0;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < DW; ++kk) {
      int av[TI], bv[TJ];
#pragma unroll
      for (int i = 0; i < TI; ++i) av[i] = As[kk * ALD + ay + SA * i];
#pragma unroll
      for (int j = 0; j < TJ; ++j) bv[j] = Bs[kk * BLD + bx + SB * j];
#pragma unroll
      for (int i = 0; i < TI; ++i)
#pragma unroll
        for (int j = 0; j < TJ; ++j) acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// the clean-tile cosines acc[i][j] of probe rows x0 + ay + SA*i against
// the stored rows t0 + bx + SB*j of q0, as the form computes them (header)
template <int FORM, int NX, int NY, int DK, int THREADS, int ALD, int BLD, int TI, int TJ, int SA,
          int SB>
__device__ __forceinline__ void cos_tile(const Args& a, float (&acc)[TI][TJ], float* As,
                                         float* Bs, long long x0, long long t0, long long c_end,
                                         int ay, int bx) {
  using TQ = typename Stored<FORM>::T;
  const TQ* q0 = static_cast<const TQ*>(a.q0);
  if constexpr (FORM == FORM_INT8C) {
    int iacc[TI][TJ];
    tile_gemm_i8<NX, NY, DK, THREADS, ALD, BLD, TI, TJ, SA, SB>(
        iacc, reinterpret_cast<int*>(As), reinterpret_cast<int*>(Bs),
        reinterpret_cast<const int*>(a.E8), x0, a.R, reinterpret_cast<const int*>(q0), t0, c_end,
        a.D / 4, ay, bx);
#pragma unroll
    for (int i = 0; i < TI; ++i) {
      const long long r = x0 + ay + SA * i;
      const float se = r < a.R ? a.se[r] : 0.f;
#pragma unroll
      for (int j = 0; j < TJ; ++j) {
        const long long c = t0 + bx + SB * j;
        acc[i][j] = (float)iacc[i][j] * (se * (c < c_end ? a.qs[c] : 0.f));
      }
    }
  } else {
    float n2;
    tile_gemm<NX, NY, DK, THREADS, ALD, BLD, TI, TJ, SA, SB, false>(acc, n2, As, Bs, a.E, x0, a.R,
                                                                    q0, t0, c_end, a.D, ay, bx);
    if constexpr (FORM == FORM_INT8) {
#pragma unroll
      for (int j = 0; j < TJ; ++j) {
        const long long c = t0 + bx + SB * j;
        const float sc = c < c_end ? a.qs[c] : 0.f;
#pragma unroll
        for (int i = 0; i < TI; ++i) acc[i][j] *= sc;
      }
    }
  }
}

// ---------------------------------------------------------------- forward

// F_DK f32 features (or, for INT8C, F_DK int32 words of 4 int8 features)
// per shared-memory stage; a block holds ROWS = 256 or 128 probe rows
constexpr int F_ROWS = 256, F_TC = 64, F_DK = 16, F_THREADS = 256;
constexpr int F_ALD = F_ROWS + 4, F_BLD = F_TC + 4, F_CLD = F_TC + 1;
// the BF16 form stages E [ROWS][64] and q0 [64][64] bf16 per 64 features,
// FB_ST stages in flight
constexpr int FB_ST = 3;
template <int ROWS>
__host__ __device__ constexpr int fb_stage_bytes() {
  return (ROWS + F_TC) * 64 * 2;
}
template <int FORM, int ROWS>
constexpr size_t f_smem() {
  return (FORM == FORM_BF16 ? FB_ST * fb_stage_bytes<ROWS>()
                            : sizeof(float) * (F_DK * (ROWS + 4) + F_DK * F_BLD)) +
         sizeof(float) * ROWS * F_CLD + sizeof(int) * (4 * F_TC + 4);
}

// BF16: stage features [64 kc, + 64) of probe rows [0, ROWS) (zero past R)
// and of q0 rows [t0, t0 + 64) (zero from c_end) into stage s
template <int ROWS>
__device__ __forceinline__ void fwd_load_bf16(const Args& a, unsigned char* stg, int s,
                                              long long t0, long long c_end, int kc) {
  const __nv_bfloat16* q0 = static_cast<const __nv_bfloat16*>(a.q0);
  unsigned char* Es = stg + s * fb_stage_bytes<ROWS>();
  unsigned char* Qs = Es + ROWS * 64 * 2;
  for (int i = threadIdx.x; i < (ROWS + F_TC) * 8; i += F_THREADS) {
    const int r = i >> 3, f = 64 * kc + 8 * (i & 7);
    if (r < ROWS) {
      const bool ok = r < a.R;
      cp_async_cg(Es + swz(r, f - 64 * kc, 8), ok ? a.Eb + (long long)r * a.D + f : a.Eb, ok);
    } else {
      const long long col = t0 + r - ROWS;
      const bool ok = col < c_end;
      cp_async_cg(Qs + swz(r - ROWS, f - 64 * kc, 8), ok ? q0 + col * a.D + f : q0, ok);
    }
  }
}

// BF16: the first FB_ST - 1 feature chunks of the tile at t0, each its own
// cp.async group (fwd_cos_bf16 stages the rest)
template <int ROWS>
__device__ __forceinline__ void fwd_prologue_bf16(const Args& a, unsigned char* stg, long long t0,
                                                  long long c_end) {
  for (int s = 0; s < FB_ST - 1; ++s) {
    if (s < a.D / 64) fwd_load_bf16<ROWS>(a, stg, s, t0, c_end, s);
    cp_async_commit();
  }
}

// BF16: the clean cosines acc[mi][ni] of probe rows m0 + 16 mi .. and tile
// columns n0 + 8 ni .. of the tile at t0, whose prologue is in flight: the
// k16 chain over the feature axis in order (module header)
template <int ROWS, int NI>
__device__ __forceinline__ void fwd_cos_bf16(const Args& a, unsigned char* stg, long long t0,
                                             long long c_end, int m0, int n0,
                                             float (&acc)[2][NI][4]) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
  const int n_kc = a.D / 64;
  for (int kc = 0; kc < n_kc; ++kc) {
    cp_async_wait<FB_ST - 2>();
    __syncthreads();  // chunk kc has landed; chunk kc - 1's stage is free
    if (kc + FB_ST - 1 < n_kc)
      fwd_load_bf16<ROWS>(a, stg, (kc + FB_ST - 1) % FB_ST, t0, c_end, kc + FB_ST - 1);
    cp_async_commit();
    const unsigned char* Es = stg + (kc % FB_ST) * fb_stage_bytes<ROWS>();
    mma_nt<2, NI>(acc, Es, 8, m0, Es + ROWS * 64 * 2, 8, n0, 4);
  }
}

template <int FORM, int ROWS>
__global__ void __launch_bounds__(F_THREADS)
    quad_fwd_kernel(Args a, long long cols_per_blk, float* part) {
  constexpr int ALD = ROWS + 4, TI = ROWS / 32;
  // BF16: WM warps along the rows (32 each) x WN along the 64 columns
  constexpr int WM = ROWS / 32, WN = 8 / WM, NI = 8 / WN;
  extern __shared__ __align__(16) float smem[];
  float* As = smem;               // E chunk, k-major [F_DK][ALD]
  float* Bs = As + F_DK * ALD;    // q0 chunk, k-major [F_DK][F_BLD]
  unsigned char* stg = reinterpret_cast<unsigned char*>(smem);  // BF16: [FB_ST] stages
  float* Cs = FORM == FORM_BF16  // cosine tile [ROWS][F_CLD]
                  ? reinterpret_cast<float*>(stg + FB_ST * fb_stage_bytes<ROWS>())
                  : Bs + F_DK * F_BLD;
  int* last0 = reinterpret_cast<int*>(Cs + ROWS * F_CLD);
  int* lastb = last0 + 2 * F_TC;
  int* written = lastb + 2 * F_TC;  // [4]

  const int tid = threadIdx.x;
  const int tx = tid & 7, ty = tid >> 3;  // GEMM outputs: rows ty + 32i, cols tx + 8j
  const long long c_begin = (long long)blockIdx.x * cols_per_blk;
  const long long c_end = min(a.Q, c_begin + cols_per_blk);

  const int r = tid;  // epilogue: one probe row per thread
  const bool row_ok = r < a.R;
  const int dir = row_ok ? r / a.B : 0;
  const int label = row_ok ? a.labels[r] : -1;
  const float gt0 = row_ok ? a.gt[r] : 0.f;
  const float gt1 = row_ok ? a.gt[a.R + r] : 0.f;
  const float zt0 = a.scale * phi_target(gt0, a), zt1 = a.scale * phi_target(gt1, a);
  float m0 = -INFINITY, s0 = 0.f, m1 = -INFINITY, s1 = 0.f;
  float tk0[KMAX], tk1[KMAX];
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    tk0[j] = NEG_INF_F;
    tk1[j] = NEG_INF_F;
  }
  float kth0 = NEG_INF_F, kth1 = NEG_INF_F;

  if constexpr (FORM == FORM_BF16)
    if (c_begin < c_end) fwd_prologue_bf16<ROWS>(a, stg, c_begin, c_end);
  for (long long t0 = c_begin; t0 < c_end; t0 += F_TC) {
    mark_writes<F_TC>(a, t0, last0, lastb, written);

    if constexpr (FORM == FORM_BF16) {
      const int warp = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
      const int wr = (warp % WM) * 32, wc = (warp / WM) * (F_TC / WN);  // the warp's tile
      float acc[2][NI][4];
      fwd_cos_bf16<ROWS, NI>(a, stg, t0, c_end, wr, wc, acc);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            Cs[(wr + 16 * mi + g + 8 * (e >> 1)) * F_CLD + wc + 8 * ni + 2 * t + (e & 1)] =
                acc[mi][ni][e];
    } else {
      float acc[TI][8];
      cos_tile<FORM, ROWS, F_TC, F_DK, F_THREADS, ALD, F_BLD, TI, 8, 32, 8>(a, acc, As, Bs, 0, t0,
                                                                            c_end, ty, tx);
#pragma unroll
      for (int i = 0; i < TI; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) Cs[(ty + 32 * i) * F_CLD + tx + 8 * j] = acc[i][j];
    }
    __syncthreads();
    if constexpr (FORM == FORM_BF16)  // the next tile's first chunks load under the epilogue
      if (t0 + F_TC < c_end) fwd_prologue_bf16<ROWS>(a, stg, t0 + F_TC, c_end);

    if (row_ok) {
      const bool any_w = written[dir] != 0;
      const float* e_row = a.E + (long long)r * a.D;
      const int n = (int)min((long long)F_TC, c_end - t0);
      for (int c = 0; c < n; ++c) {
        if (t0 + c == (long long)label) continue;  // the target: after the pass (twin) or merge
        float c1 = Cs[r * F_CLD + c], c2 = c1;
        if (any_w) {
          const int i0 = last0[dir * F_TC + c], ib = lastb[dir * F_TC + c];
          if (i0 >= 0) c1 = row_dot(e_row, a.G + (long long)(dir * a.BP + i0) * a.D, a.D);
          c2 = ib >= 0 ? row_dot(e_row, a.V + (long long)(dir * a.BP + ib) * a.D, a.D) : c1;
        }
        stream_update(c1, gt0, a, m0, s0);
        topk_insert(tk0, kth0, c1, a.k);
        stream_update(c2, gt1, a, m1, s1);
        topk_insert(tk1, kth1, c2, a.k);
      }
    }
    __syncthreads();  // Cs / write plan are rebuilt by the next tile
  }
  if (row_ok && a.twin && label >= c_begin && label < c_end) {
    // the twin's target term z = scale * phi(gt), folded in after the
    // block's columns: streamed first, a dominant z would leave each later
    // column's e^(z - m) below half an ulp of s, and lose them (a bias of
    // up to ~1e-4 in logz at 4,000 columns a block)
    stream_z(zt0, m0, s0);
    stream_z(zt1, m1, s1);
  }

  if (row_ok) {
    float* p0 = part + (((long long)blockIdx.x * 2 + 0) * a.R + r) * PART;
    float* p1 = part + (((long long)blockIdx.x * 2 + 1) * a.R + r) * PART;
    p0[0] = m0;
    p0[1] = s0;
    p1[0] = m1;
    p1[1] = s1;
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      p0[2 + j] = tk0[j];
      p1[2 + j] = tk1[j];
    }
  }
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

constexpr int B_RB = 32, B_TC = 64, B_DK = 16, B_THREADS = 256, B_JMAX = 8;  // D <= 64 * 8
constexpr int B_ALD = B_RB + 4, B_BLD = B_TC + 4, B_CLD = B_TC + 1;
constexpr size_t B_SMEM = sizeof(float) * (B_DK * B_ALD + B_DK * B_BLD + 3 * B_RB * B_CLD) +
                          sizeof(int) * (4 * B_TC + 4);

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

// d_cos of row rc (global row gr) at column gc = t0 + c of a TC-column tile
// whose clean cosine is c1, routed per view to the row that view scores
// against: dq to q0's stored row, dg to the parity-0 write g, dv to the
// view-2 write v; i0 / ib return the column's last writers in the row's
// direction (-1: none). The BF16 form keeps the two views' rounded d_cos
// apart when both score against q0's row (dq, dq2: two bf16 operands); the
// others sum them into dq. With WRITES false the caller knows that the
// row's rounding tile holds no write (so neither does the tile), and only
// the clean route is compiled.
template <int FORM, int TC, bool WRITES = true>
__device__ __forceinline__ void route_dcos(const Args& a, const RowCoef& rc, int gr, long long gc,
                                           int c, const int* last0, const int* lastb,
                                           const int* written, float c1, float& dq, float& dq2,
                                           float& dg, float& dv, int& i0, int& ib) {
  constexpr bool ROUND = FORM != FORM_F32;
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
  const float sc = SCALED ? a.qs[gc] : 1.f;
  if (ROUND && (!WRITES || !hit)) {  // clean tile: both views read the stored row
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

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const signed char* p) { return (float)*p; }

// the F32, INT8 and INT8C forms (f32 FMA; BF16: quad_bwd_bf16_kernel)
template <int FORM>
__global__ void __launch_bounds__(B_THREADS)
    quad_bwd_kernel(Args a, BwdRows br, long long cols_per_chunk, int n_rg, float* part) {
  using TQ = typename Stored<FORM>::T;
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                // E row-group chunk, k-major [B_DK][B_ALD]
  float* Bs = As + B_DK * B_ALD;   // q0 chunk, k-major [B_DK][B_BLD]
  float* Dq = Bs + B_DK * B_BLD;   // d_cos routed to q0 rows   [B_RB][B_CLD]
  float* Dg = Dq + B_RB * B_CLD;   // ... to the parity-0 write g
  float* Dv = Dg + B_RB * B_CLD;   // ... to the view-2 write v
  int* last0 = reinterpret_cast<int*>(Dv + B_RB * B_CLD);
  int* lastb = last0 + 2 * B_TC;
  int* written = lastb + 2 * B_TC;  // [4]

  const int tid = threadIdx.x;
  const int rg = blockIdx.x % n_rg, chunk = blockIdx.x / n_rg;
  const int r_base = rg * B_RB;
  const long long c_begin = (long long)chunk * cols_per_chunk;
  const long long c_end = min(a.Q, c_begin + cols_per_chunk);
  const int nj = a.D / 64;
  const TQ* q0 = static_cast<const TQ*>(a.q0);

  // GEMM-1 / d_cos map: rows ty + 16i (i < 2), cols tx + 16j (j < 4)
  const int tx = tid & 15, ty = tid >> 4;
  RowCoef rc[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) rc[i] = row_coef(a, br, r_base + ty + 16 * i);
  // GEMM-2 map: rows ry*8 + i (i < 8), features dx + 64j (j < nj)
  const int ry = tid >> 6, dx = tid & 63;
  float acc2[8][B_JMAX];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < B_JMAX; ++j) acc2[i][j] = 0.f;

  for (long long t0 = c_begin; t0 < c_end; t0 += B_TC) {
    mark_writes<B_TC>(a, t0, last0, lastb, written);
    const bool any_w = (written[0] | written[1]) != 0;

    float acc[2][4];
    cos_tile<FORM, B_RB, B_TC, B_DK, B_THREADS, B_ALD, B_BLD, 2, 4, 16, 16>(a, acc, As, Bs, r_base,
                                                                            t0, c_end, ty, tx);

    // d_cos, routed per view to the row that view scores against
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int lr = ty + 16 * i, gr = r_base + lr;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const long long gc = t0 + c;
        float dq = 0.f, dq2 = 0.f, dg = 0.f, dv = 0.f;  // dq2: the BF16 form only
        if (rc[i].ok && gc < c_end && gc != (long long)rc[i].lab) {
          int i0, ib;
          route_dcos<FORM, B_TC>(a, rc[i], gr, gc, c, last0, lastb, written, acc[i][j], dq, dq2,
                                 dg, dv, i0, ib);
        }
        Dq[lr * B_CLD + c] = dq;
        Dg[lr * B_CLD + c] = dg;
        Dv[lr * B_CLD + c] = dv;
      }
    }
    __syncthreads();

    // d_emb += d_cos @ (effective rows of this tile)
    const int n = (int)min((long long)B_TC, c_end - t0);
    for (int c = 0; c < n; ++c) {
      const TQ* wrow = q0 + (t0 + c) * a.D + dx;
      float w[B_JMAX];
#pragma unroll
      for (int j = 0; j < B_JMAX; ++j) w[j] = j < nj ? load_f32(wrow + 64 * j) : 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float d = Dq[(ry * 8 + i) * B_CLD + c];
#pragma unroll
        for (int j = 0; j < B_JMAX; ++j) acc2[i][j] = fmaf(d, w[j], acc2[i][j]);
      }
    }
    if (any_w) {
      for (int c = 0; c < n; ++c) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int lr = ry * 8 + i, gr = r_base + lr;
          if (gr >= a.R) continue;
          const int d = gr / a.B;
          const int i0 = last0[d * B_TC + c], ib = lastb[d * B_TC + c];
          if (i0 >= 0) {
            const float coef = Dg[lr * B_CLD + c];
            const float* g = a.G + (long long)(d * a.BP + i0) * a.D + dx;
#pragma unroll
            for (int j = 0; j < B_JMAX; ++j)
              if (j < nj) acc2[i][j] = fmaf(coef, g[64 * j], acc2[i][j]);
          }
          if (ib >= 0) {
            const float coef = Dv[lr * B_CLD + c];
            const float* vv = a.V + (long long)(d * a.BP + ib) * a.D + dx;
#pragma unroll
            for (int j = 0; j < B_JMAX; ++j)
              if (j < nj) acc2[i][j] = fmaf(coef, vv[64 * j], acc2[i][j]);
          }
        }
      }
    }
    __syncthreads();  // Dq/Dg/Dv and the write plan are rebuilt next tile
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gr = r_base + ry * 8 + i;
    if (gr >= a.R) continue;
    float* p = part + ((long long)chunk * a.R + gr) * a.D + dx;
#pragma unroll
    for (int j = 0; j < B_JMAX; ++j)
      if (j < nj) p[64 * j] = acc2[i][j];
  }
}

// ------------------------------------------------- backward, BF16 form

constexpr int BB_RB = 64, BB_TC = 64, BB_THREADS = 256;  // probe rows, tile columns

// shared memory of the BF16 backward at feature width D: the block's E rows,
// two q0 tiles, the two d_cos tiles, the rows' inputs and the write plan
__host__ __device__ constexpr int bb_smem(int D) {
  return BB_RB * D * 2 + 2 * BB_TC * D * 2 + 2 * BB_RB * BB_TC * 2 +
         BB_RB * (int)sizeof(RowCoef) + (4 * BB_TC + 4) * (int)sizeof(int);
}

// probe rows [r_base, + BB_RB) of Eb into Es, swizzled (zero past R)
__device__ __forceinline__ void bwd_load_rows_bf16(const Args& a, unsigned char* Es, int r_base) {
  const int rc = a.D / 8;
  for (int i = threadIdx.x; i < BB_RB * rc; i += blockDim.x) {
    const int r = i / rc, ch = i - r * rc;
    const bool ok = r_base + r < a.R;
    cp_async_cg(Es + swz(r, 8 * ch, rc), ok ? a.Eb + (long long)(r_base + r) * a.D + 8 * ch : a.Eb,
                ok);
  }
}

// q0 rows [t0, t0 + 64) into Qs, swizzled (zero from c_end)
__device__ __forceinline__ void bwd_load_tile_bf16(const Args& a, unsigned char* Qs, long long t0,
                                                   long long c_end) {
  const __nv_bfloat16* q0 = static_cast<const __nv_bfloat16*>(a.q0);
  const int rc = a.D / 8;
  for (int i = threadIdx.x; i < BB_TC * rc; i += blockDim.x) {
    const int r = i / rc, ch = i - r * rc;
    const bool ok = t0 + r < c_end;
    cp_async_cg(Qs + swz(r, 8 * ch, rc), ok ? q0 + (t0 + r) * a.D + 8 * ch : q0, ok);
  }
}

// the backward's recompute map: warp w holds rows 16 (w % 4) .., columns
// 32 (w / 4) .. of a [64, 64] cosine tile
__device__ __forceinline__ void bwd_cos_map(int& m1, int& n1) {
  const int warp = threadIdx.x >> 5;
  m1 = (warp & 3) * 16;
  n1 = (warp >> 2) * 32;
}

__global__ void __launch_bounds__(BB_THREADS, 1)
    quad_bwd_bf16_kernel(Args a, BwdRows br, long long cols_per_chunk, int n_rg, float* part,
                         float* wcoef) {
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  const int D = a.D, rcd = D / 8;
  unsigned char* Es = bwd_smem;                // E rows [BB_RB][D]
  unsigned char* Qs = Es + BB_RB * D * 2;      // q0 tiles [2][BB_TC][D]
  unsigned char* Dq = Qs + 2 * BB_TC * D * 2;  // d_cos on q0's rows [2][BB_RB][BB_TC]
  RowCoef* rcs = reinterpret_cast<RowCoef*>(Dq + 2 * BB_RB * BB_TC * 2);
  int* last0 = reinterpret_cast<int*>(rcs + BB_RB);
  int* lastb = last0 + 2 * BB_TC;
  int* written = lastb + 2 * BB_TC;  // [4]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int rg = blockIdx.x % n_rg, chunk = blockIdx.x / n_rg;
  const int r_base = rg * BB_RB;
  const long long c_begin = (long long)chunk * cols_per_chunk;
  const long long c_end = min(a.Q, c_begin + cols_per_chunk);
  const int n_tiles = c_end > c_begin ? (int)((c_end - c_begin + BB_TC - 1) / BB_TC) : 0;

  bwd_load_rows_bf16(a, Es, r_base);
  if (n_tiles > 0) bwd_load_tile_bf16(a, Qs, c_begin, c_end);
  cp_async_commit();
  for (int r = tid; r < BB_RB; r += BB_THREADS) rcs[r] = row_coef(a, br, r_base + r);

  int m1, n1;
  bwd_cos_map(m1, n1);
  // d_emb map: warp w holds rows 32 (w % 2) .., features D / 4 * (w / 2) ..
  // (nj2 n8 tiles, 16 at D = 512)
  const int m2 = (warp & 1) * 32, f2 = (warp >> 1) * (D / 4), nj2 = D / 32;
  float acc2[2][16][4] = {};

  for (int ti = 0; ti < n_tiles; ++ti) {
    const long long t0 = c_begin + (long long)ti * BB_TC;
    if (ti + 1 < n_tiles)
      bwd_load_tile_bf16(a, Qs + ((ti + 1) & 1) * BB_TC * D * 2, t0 + BB_TC, c_end);
    cp_async_commit();
    cp_async_wait<1>();  // tile ti (and the E rows) landed
    mark_writes<BB_TC>(a, t0, last0, lastb, written);  // its barriers publish them
    const unsigned char* Q = Qs + (ti & 1) * BB_TC * D * 2;

    float acc1[1][4][4] = {};
    mma_nt<1, 4>(acc1, Es, rcd, m1, Q, rcd, n1, D / 16);

    // d_cos from the fragments: q0's share into Dq as bf16 and into Dq2
    // what bf16 does not hold of it (nothing: route_dcos rounds it, so the
    // rounding is decided there alone) with the second view's term; the
    // written rows' into wcoef
    // A row whose rounding tile holds no write takes the clean route,
    // unrolled over its 8 elements; one whose tile does takes every route
    // one element at a time (header).
    bool two = false;
    auto put = [&](int lr, int c, float dq, float dq2) {
      const float hq = bf16r(dq), lq = dq2 + (dq - hq);
      *reinterpret_cast<__nv_bfloat16*>(Dq + swz(lr, c, BB_TC / 8)) = __float2bfloat16_rn(hq);
      *reinterpret_cast<__nv_bfloat16*>(Dq + BB_RB * BB_TC * 2 + swz(lr, c, BB_TC / 8)) =
          __float2bfloat16_rn(lq);
      two = two || lq != 0.f;
    };
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int lr = m1 + g + 8 * h, gr = r_base + lr;
      const RowCoef rc = rcs[lr];
      if (written[2 + rc.dir] == 0) {
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int c = n1 + 8 * ni + 2 * t + j;
            const long long gc = t0 + c;
            float dq = 0.f, dq2 = 0.f, dg, dv;
            int i0, ib;
            if (rc.ok && gc < c_end && gc != (long long)rc.lab)
              route_dcos<FORM_BF16, BB_TC, false>(a, rc, gr, gc, c, last0, lastb, written,
                                                  acc1[0][ni][2 * h + j], dq, dq2, dg, dv, i0,
                                                  ib);
            put(lr, c, dq, dq2);
          }
      } else {
        float cv[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) cv[k] = acc1[0][k >> 1][2 * h + (k & 1)];
        float* wc = wcoef + (long long)gr * 2 * a.BP;
#pragma unroll 1
        for (int k = 0; k < 8; ++k) {
          const int c = n1 + 8 * (k >> 1) + 2 * t + (k & 1);
          const long long gc = t0 + c;
          float dq = 0.f, dq2 = 0.f, dg = 0.f, dv = 0.f;
          if (rc.ok && gc < c_end && gc != (long long)rc.lab) {
            int i0, ib;
            route_dcos<FORM_BF16, BB_TC>(a, rc, gr, gc, c, last0, lastb, written, cv[k], dq, dq2,
                                         dg, dv, i0, ib);
            if (i0 >= 0) wc[i0] = dg;  // this thread alone holds (row, writer)
            if (ib >= 0) wc[a.BP + ib] = dv;
          }
          put(lr, c, dq, dq2);
        }
      }
    }
    two = __syncthreads_or(two);  // and Dq is complete

    // d_emb += d_cos . q0 tile (a second pass for the second views'
    // terms): the tile's product over its 64 columns on the tensor core from
    // a zero accumulator, added to d_emb in f32 (mma_bf16.cuh's header)
    for (int p = 0; p < (two ? 2 : 1); ++p) {
      const unsigned char* A = Dq + p * BB_RB * BB_TC * 2;
      uint32_t av[BB_TC / 16][2][4];
#pragma unroll
      for (int ks = 0; ks < BB_TC / 16; ++ks) {
        load_a(av[ks][0], A, BB_TC / 8, m2, ks);
        load_a(av[ks][1], A, BB_TC / 8, m2 + 16, ks);
      }
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        if (2 * jj >= nj2) continue;
        float pt[2][2][4];
#pragma unroll
        for (int ks = 0; ks < BB_TC / 16; ++ks) {
          uint32_t b[4];
          load_b_kn(b, Q, rcd, f2 + 16 * jj, ks);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
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
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc2[mi][2 * jj + h][e] += pt[mi][h][e];
      }
    }
    __syncthreads();  // the tile's stage, Dq and the write plan are rebuilt next
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
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

// d_emb = sum of the chunk partials in chunk order (the BF16 form's
// written rows after them: wcoef [R][2][BP] . G / V of the row's
// direction); d_gt, the target
// column's dz: (exp(scale*phi(gt_v) - logz_v) - 1) * d_ce_v * scale on rows
// whose (shard-local) label is >= 0
__global__ void quad_bwd_merge_kernel(Args a, BwdRows br, int nchunk, const float* part,
                                      const float* wcoef, float* d_emb, float* dgt) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n = (long long)a.R * a.D;
  if (idx < n) {
    float acc = 0.f;
    for (int c = 0; c < nchunk; ++c) acc += part[(long long)c * n + idx];
    if (wcoef != nullptr) {
      const int r = (int)(idx / a.D), k = (int)(idx - (long long)r * a.D), d = r / a.B;
      const float* wc = wcoef + (long long)r * 2 * a.BP;
      for (int i = 0; i < a.BP; ++i) {
        const long long w = (long long)(d * a.BP + i) * a.D + k;
        if (wc[i] != 0.f) acc = fmaf(wc[i], a.G[w], acc);
        if (wc[a.BP + i] != 0.f) acc = fmaf(wc[a.BP + i], a.V[w], acc);
      }
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

template <int FORM, int ROWS>
cudaError_t launch_fwd_rows(const Args& a, float* part, int nblk, long long cols_per_blk,
                            cudaStream_t st) {
  constexpr size_t smem = f_smem<FORM, ROWS>();
  cudaError_t err = cudaFuncSetAttribute(quad_fwd_kernel<FORM, ROWS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  quad_fwd_kernel<FORM, ROWS><<<nblk, F_THREADS, smem, st>>>(a, cols_per_blk, part);
  return cudaGetLastError();
}

template <int FORM>
cudaError_t launch_fwd_form(const Args& a, float* part, int nblk, long long cols_per_blk,
                            cudaStream_t st) {
  if (a.R <= 128) return launch_fwd_rows<FORM, 128>(a, part, nblk, cols_per_blk, st);
  return launch_fwd_rows<FORM, F_ROWS>(a, part, nblk, cols_per_blk, st);
}

// the forward's block pass over nblk column ranges into part
cudaError_t launch_fwd_blocks(const Args& a, int form, float* part, int nblk,
                              long long cols_per_blk, cudaStream_t st) {
  switch (form) {
    case FORM_F32: return launch_fwd_form<FORM_F32>(a, part, nblk, cols_per_blk, st);
    case FORM_BF16: return launch_fwd_form<FORM_BF16>(a, part, nblk, cols_per_blk, st);
    case FORM_INT8: return launch_fwd_form<FORM_INT8>(a, part, nblk, cols_per_blk, st);
    case FORM_INT8C: return launch_fwd_form<FORM_INT8C>(a, part, nblk, cols_per_blk, st);
  }
  return cudaErrorInvalidValue;
}

template <int FORM>
cudaError_t launch_bwd_form(const Args& a, const BwdRows& br, float* part, int nchunk,
                            long long cols_per_chunk, cudaStream_t st) {
  const int n_rg = (a.R + B_RB - 1) / B_RB;
  quad_bwd_kernel<FORM><<<nchunk * n_rg, B_THREADS, B_SMEM, st>>>(a, br, cols_per_chunk, n_rg,
                                                                  part);
  return cudaGetLastError();
}

cudaError_t launch_bwd_bf16(const Args& a, const BwdRows& br, float* part, float* wcoef,
                            int nchunk, long long cols_per_chunk, cudaStream_t st) {
  const int n_rg = (a.R + BB_RB - 1) / BB_RB, smem = bb_smem(a.D);
  if (wcoef == nullptr || a.Eb == nullptr) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(quad_bwd_bf16_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  quad_bwd_bf16_kernel<<<nchunk * n_rg, BB_THREADS, smem, st>>>(a, br, cols_per_chunk, n_rg, part,
                                                                wcoef);
  return cudaGetLastError();
}

// ------------------------------------------------------------ clean cosines

// out [R][Q] = the clean-tile cosines as cos_tile computes them, with the
// forward's tiling (blockIdx.y = 0) or the backward's (blockIdx.y = row
// group): a parity probe that exposes the dot both kernels share.
template <int FORM, int NX, int NY, int DK, int THREADS, int ALD, int BLD, int TI, int TJ, int SA,
          int SB>
__global__ void __launch_bounds__(THREADS) clean_cos_kernel(Args a, float* out) {
  __shared__ float As[DK * ALD], Bs[DK * BLD];
  const long long x0 = (long long)blockIdx.y * NX, t0 = (long long)blockIdx.x * NY;
  const int ay = threadIdx.x / SB, bx = threadIdx.x % SB;
  float acc[TI][TJ];
  cos_tile<FORM, NX, NY, DK, THREADS, ALD, BLD, TI, TJ, SA, SB>(a, acc, As, Bs, x0, t0, a.Q, ay,
                                                                bx);
#pragma unroll
  for (int i = 0; i < TI; ++i) {
    const long long r = x0 + ay + SA * i;
#pragma unroll
    for (int j = 0; j < TJ; ++j) {
      const long long c = t0 + bx + SB * j;
      if (r < a.R && c < a.Q) out[r * a.Q + c] = acc[i][j];
    }
  }
}

// the BF16 form's clean cosines with the forward's tiling: one 256-row
// block per 64 columns, fwd_cos_bf16 as the forward runs it
__global__ void __launch_bounds__(F_THREADS) clean_cos_fwd_bf16_kernel(Args a, float* out) {
  extern __shared__ __align__(16) unsigned char ccf_smem[];
  const long long t0 = (long long)blockIdx.x * F_TC;
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  fwd_prologue_bf16<F_ROWS>(a, ccf_smem, t0, a.Q);
  float acc[2][8][4];
  fwd_cos_bf16<F_ROWS, 8>(a, ccf_smem, t0, a.Q, warp * 32, 0, acc);
  cp_async_wait<0>();
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const long long r = warp * 32 + 16 * mi + g + 8 * (e >> 1);
        const long long c = t0 + 8 * ni + 2 * t + (e & 1);
        if (r < a.R && c < a.Q) out[r * a.Q + c] = acc[mi][ni][e];
      }
}

// ... with the backward's tiling: one 64-row block per row group and 64
// columns, staged and multiplied as quad_bwd_bf16_kernel does
__global__ void __launch_bounds__(BB_THREADS) clean_cos_bwd_bf16_kernel(Args a, float* out) {
  extern __shared__ __align__(16) unsigned char ccb_smem[];
  const int r_base = blockIdx.y * BB_RB, g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const long long t0 = (long long)blockIdx.x * BB_TC;
  unsigned char* Es = ccb_smem;
  unsigned char* Qs = Es + BB_RB * a.D * 2;
  bwd_load_rows_bf16(a, Es, r_base);
  bwd_load_tile_bf16(a, Qs, t0, a.Q);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  int m1, n1;
  bwd_cos_map(m1, n1);
  float acc[1][4][4] = {};
  mma_nt<1, 4>(acc, Es, a.D / 8, m1, Qs, a.D / 8, n1, a.D / 16);
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const long long r = r_base + m1 + g + 8 * (e >> 1);
      const long long c = t0 + n1 + 8 * ni + 2 * t + (e & 1);
      if (r < a.R && c < a.Q) out[r * a.Q + c] = acc[0][ni][e];
    }
}

cudaError_t launch_clean_cos_bf16(const Args& a, int bwd_tiles, float* out, cudaStream_t st) {
  const unsigned n_t = (unsigned)((a.Q + F_TC - 1) / F_TC);
  if (a.Eb == nullptr) return cudaErrorInvalidValue;
  if (bwd_tiles) {
    const int smem = (BB_RB + BB_TC) * a.D * 2;
    cudaError_t err = cudaFuncSetAttribute(clean_cos_bwd_bf16_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    clean_cos_bwd_bf16_kernel<<<dim3(n_t, (a.R + BB_RB - 1) / BB_RB), BB_THREADS, smem, st>>>(a,
                                                                                           out);
  } else {
    const int smem = FB_ST * fb_stage_bytes<F_ROWS>();
    cudaError_t err = cudaFuncSetAttribute(clean_cos_fwd_bf16_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    clean_cos_fwd_bf16_kernel<<<n_t, F_THREADS, smem, st>>>(a, out);
  }
  return cudaGetLastError();
}

template <int FORM>
cudaError_t launch_clean_cos_form(const Args& a, int bwd_tiles, float* out, cudaStream_t st) {
  const unsigned n_t = (unsigned)((a.Q + F_TC - 1) / F_TC);
  if (bwd_tiles) {
    clean_cos_kernel<FORM, B_RB, B_TC, B_DK, B_THREADS, B_ALD, B_BLD, 2, 4, 16, 16>
        <<<dim3(n_t, (a.R + B_RB - 1) / B_RB), B_THREADS, 0, st>>>(a, out);
  } else {
    clean_cos_kernel<FORM, F_ROWS, F_TC, F_DK, F_THREADS, F_ALD, F_BLD, 8, 8, 32, 8>
        <<<dim3(n_t, 1), F_THREADS, 0, st>>>(a, out);
  }
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

// forward (quad, or twin with twin = 1): nblk column ranges of cols_per_blk
// (a multiple of 64) columns; part is [nblk][2][R][2 + 16] f32 scratch;
// outputs [2][R] and [2][R][k]
int quad_fwd_launch(QUAD_COMMON_PARAMS, float* part, int nblk, long long cols_per_blk,
                    float* ce, float* neg, float* logz, float* topk, void* stream) {
  const Args a = make_args(QUAD_COMMON_ARGS);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = launch_fwd_blocks(a, form, part, nblk, cols_per_blk, st);
  if (err != cudaSuccess) return (int)err;
  quad_fwd_merge_kernel<<<(2 * R + 127) / 128, 128, 0, st>>>(a, nblk, part, ce, neg, logz, topk);
  return (int)cudaGetLastError();
}

// partial forward over a shard's block (Q = its columns, shard-local cols
// and labels): the same block pass, then m, s [2][R] and topk [2][R][k]
int quad_partial_fwd_launch(QUAD_COMMON_PARAMS, float* part, int nblk, long long cols_per_blk,
                            float* m, float* s, float* topk, void* stream) {
  const Args a = make_args(QUAD_COMMON_ARGS);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = launch_fwd_blocks(a, form, part, nblk, cols_per_blk, st);
  if (err != cudaSuccess) return (int)err;
  quad_partial_merge_kernel<<<(2 * R + 127) / 128, 128, 0, st>>>(a, nblk, part, m, s, topk);
  return (int)cudaGetLastError();
}

// backward (and the partial backward, with a shard's block, shard-local
// cols and labels and the global row vectors): nchunk column ranges x
// ceil(R / 32) row groups; part is [nchunk][R][D] f32
// scratch; wcoef (BF16 only, else null) [R][2][BP] f32 scratch, zeroed by
// the caller; outputs d_emb [R][D] and d_gt [2][R]
int quad_bwd_launch(QUAD_COMMON_PARAMS, const float* logz, const float* kth, const float* dce,
                    const float* dneg, float* part, float* wcoef, int nchunk,
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
    case FORM_F32: err = launch_bwd_form<FORM_F32>(a, br, part, nchunk, cols_per_chunk, st); break;
    case FORM_BF16: err = launch_bwd_bf16(a, br, part, wcoef, nchunk, cols_per_chunk, st); break;
    case FORM_INT8: err = launch_bwd_form<FORM_INT8>(a, br, part, nchunk, cols_per_chunk, st); break;
    case FORM_INT8C: err = launch_bwd_form<FORM_INT8C>(a, br, part, nchunk, cols_per_chunk, st); break;
  }
  if (err != cudaSuccess) return (int)err;
  const long long n = (long long)R * D;
  quad_bwd_merge_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      a, br, nchunk, part, form == FORM_BF16 ? wcoef : nullptr, d_emb, dgt);
  return (int)cudaGetLastError();
}

// the clean-tile cosines [R][Q] of q0 (no writes, no labels), with the
// forward's tiling (bwd_tiles = 0) or the backward's
int quad_clean_cos_launch(QUAD_COMMON_PARAMS, int bwd_tiles, float* out, void* stream) {
  const Args a = make_args(QUAD_COMMON_ARGS);
  cudaStream_t st = (cudaStream_t)stream;
  switch (form) {
    case FORM_F32: return (int)launch_clean_cos_form<FORM_F32>(a, bwd_tiles, out, st);
    case FORM_BF16: return (int)launch_clean_cos_bf16(a, bwd_tiles, out, st);
    case FORM_INT8: return (int)launch_clean_cos_form<FORM_INT8>(a, bwd_tiles, out, st);
    case FORM_INT8C: return (int)launch_clean_cos_form<FORM_INT8C>(a, bwd_tiles, out, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
