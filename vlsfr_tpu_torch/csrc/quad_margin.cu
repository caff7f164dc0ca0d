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
// same layout with one direction (R = B probes, BP writes; ND = 1). All
// arithmetic is IEEE f32 FMA or exact int32 — no TF32, no tensor cores (a
// later optimisation).
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
// Bound (H100 SXM, 67 TFLOP/s f32, 3.35 TB/s) at R = 256, D = 512,
// Q = 2^20: the forward's 2*R*D*Q = 2.75e11 FLOP take >= 4.1 ms while its
// 2.15 GB of q0 take >= 0.64 ms, so it is compute-bound; the backward does
// the cosine recompute plus d_cos @ q0, 5.5e11 FLOP, >= 8.2 ms.
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

#include "margin_common.cuh"

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
template <int ROWS>
constexpr size_t f_smem() {
  return sizeof(float) * (F_DK * (ROWS + 4) + F_DK * F_BLD + ROWS * F_CLD) +
         sizeof(int) * (4 * F_TC + 4);
}

template <int FORM, int ROWS>
__global__ void __launch_bounds__(F_THREADS)
    quad_fwd_kernel(Args a, long long cols_per_blk, float* part) {
  constexpr int ALD = ROWS + 4, TI = ROWS / 32;
  extern __shared__ float smem[];
  float* As = smem;               // E chunk, k-major [F_DK][ALD]
  float* Bs = As + F_DK * ALD;    // q0 chunk, k-major [F_DK][F_BLD]
  float* Cs = Bs + F_DK * F_BLD;  // cosine tile [ROWS][F_CLD]
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

  for (long long t0 = c_begin; t0 < c_end; t0 += F_TC) {
    mark_writes<F_TC>(a, t0, last0, lastb, written);

    float acc[TI][8];
    cos_tile<FORM, ROWS, F_TC, F_DK, F_THREADS, ALD, F_BLD, TI, 8, 32, 8>(a, acc, As, Bs, 0, t0,
                                                                          c_end, ty, tx);
#pragma unroll
    for (int i = 0; i < TI; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) Cs[(ty + 32 * i) * F_CLD + tx + 8 * j] = acc[i][j];
    __syncthreads();

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

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ float load_f32(const signed char* p) { return (float)*p; }

template <int FORM>
__global__ void __launch_bounds__(B_THREADS)
    quad_bwd_kernel(Args a, BwdRows br, long long cols_per_chunk, int n_rg, float* part) {
  using TQ = typename Stored<FORM>::T;
  constexpr bool ROUND = FORM != FORM_F32;
  constexpr bool SCALED = FORM == FORM_INT8 || FORM == FORM_INT8C;
  extern __shared__ float smem[];
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
  int lab[2], dirr[2];
  bool ok[2], pos[2];
  float gtv[2][2], lzv[2][2], kthv[2][2], dcev[2][2], dnegv[2][2];
  // Arc / AM clean-tile d_cos of both views (JAX's _quad_dir_bwd_shared):
  // exp(z - ref) * c12, plus dn_v where z >= zthr_v; z = scale * cos
  float ref[2], c12[2], zthr[2][2], dn[2][2];
  const float inv_k = (float)(1.0 / (double)a.k);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int gr = r_base + ty + 16 * i;
    ok[i] = gr < a.R;
    const int rr = ok[i] ? gr : 0;
    lab[i] = a.labels[rr];
    dirr[i] = rr / a.B;
    pos[i] = lab[i] >= 0;
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      gtv[i][v] = a.gt[v * a.R + rr];
      lzv[i][v] = br.logz[v * a.R + rr];
      kthv[i][v] = br.kth[v * a.R + rr];
      dcev[i][v] = br.dce[v * a.R + rr];
      dnegv[i][v] = br.dneg[v * a.R + rr];
      zthr[i][v] = fmaxf(a.scale * (kthv[i][v] - KTH_TIE_TOL), 1e-20f);
      dn[i][v] = dnegv[i][v] * inv_k;
    }
    ref[i] = fminf(lzv[i][0], lzv[i][1]);
    c12[i] = (dcev[i][0] * expf(ref[i] - lzv[i][0]) + dcev[i][1] * expf(ref[i] - lzv[i][1])) *
             a.scale;
  }
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
      const bool w64 = written[dirr[i]] != 0;      // this tile holds a write of the row's direction
      const bool hit = written[2 + dirr[i]] != 0;  // ... its rounding tile does
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const long long gc = t0 + c;
        float dq = 0.f, dg = 0.f, dv = 0.f;
        if (ok[i] && gc < c_end && gc != (long long)lab[i]) {
          float c1 = acc[i][j], c2 = c1;
          int i0 = -1, ib = -1;
          if (w64) {
            const float* e_row = a.E + (long long)gr * a.D;
            i0 = last0[dirr[i] * B_TC + c];
            ib = lastb[dirr[i] * B_TC + c];
            if (i0 >= 0) c1 = row_dot(e_row, a.G + (long long)(dirr[i] * a.BP + i0) * a.D, a.D);
            c2 = ib >= 0 ? row_dot(e_row, a.V + (long long)(dirr[i] * a.BP + ib) * a.D, a.D) : c1;
          }
          const float sc = SCALED ? a.qs[gc] : 1.f;
          if (ROUND && !hit) {  // clean tile: both views read the stored row
            float d;
            if (a.loss_type == LOSS_SV || a.twin) {
              d = dcos_col(c1, gtv[i][0], lzv[i][0], kthv[i][0], dcev[i][0], dnegv[i][0],
                           !pos[i], a) +
                  dcos_col(c1, gtv[i][1], lzv[i][1], kthv[i][1], dcev[i][1], dnegv[i][1],
                           !pos[i], a);
            } else {
              const float z = a.scale * c1;
              d = expf(z - ref[i]) * c12[i];
              if (z >= zthr[i][0]) d += dn[i][0];
              if (z >= zthr[i][1]) d += dn[i][1];
            }
            dq = SCALED ? bf16r(d * sc) : bf16r(d);
          } else {
            float d1 = dcos_col(c1, gtv[i][0], lzv[i][0], kthv[i][0], dcev[i][0], dnegv[i][0],
                                !pos[i], a);
            float d2 = dcos_col(c2, gtv[i][1], lzv[i][1], kthv[i][1], dcev[i][1], dnegv[i][1],
                                !pos[i], a);
            if (FORM == FORM_BF16) {  // each view's d_cos rounded alone
              d1 = bf16r(d1);
              d2 = bf16r(d2);
            }
            if (ib >= 0) dv = d2; else d1 += d2;  // view 2 reads view 1's row
            if (i0 >= 0) dg = d1; else dq = d1;
            if (SCALED) {
              dv = bf16r(dv);
              dg = bf16r(dg);
              dq = bf16r(dq * sc);
            }
          }
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

// d_emb = sum of the chunk partials in chunk order; d_gt, the target
// column's dz: (exp(scale*phi(gt_v) - logz_v) - 1) * d_ce_v * scale on rows
// whose (shard-local) label is >= 0
__global__ void quad_bwd_merge_kernel(Args a, BwdRows br, int nchunk, const float* part,
                                      float* d_emb, float* dgt) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n = (long long)a.R * a.D;
  if (idx < n) {
    float acc = 0.f;
    for (int c = 0; c < nchunk; ++c) acc += part[(long long)c * n + idx];
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
               const float* qs, const signed char* E8, const float* se, int rtile, int twin) {
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
  return a;
}

template <int FORM, int ROWS>
cudaError_t launch_fwd_rows(const Args& a, float* part, int nblk, long long cols_per_blk,
                            cudaStream_t st) {
  constexpr size_t smem = f_smem<ROWS>();
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
                            long long cols_per_chunk, int n_rg, cudaStream_t st) {
  quad_bwd_kernel<FORM><<<nchunk * n_rg, B_THREADS, B_SMEM, st>>>(a, br, cols_per_chunk, n_rg,
                                                                  part);
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
      int form, int rtile, int twin
#define QUAD_COMMON_ARGS                                                                    \
  q0, Q, D, E, G, V, rows, cols, blend, labels, gt, B, BP, R, k, loss_type, margin, scale, \
      mask_svfc, cos_m, sin_m, qs, E8, se, rtile, twin

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
// ceil(R / 32) row groups; part is [nchunk][R][D] f32 scratch; outputs
// d_emb [R][D] and d_gt [2][R]
int quad_bwd_launch(QUAD_COMMON_PARAMS, const float* logz, const float* kth, const float* dce,
                    const float* dneg, float* part, int nchunk, long long cols_per_chunk,
                    float* d_emb, float* dgt, void* stream) {
  const Args a = make_args(QUAD_COMMON_ARGS);
  BwdRows br;
  br.logz = logz;
  br.kth = kth;
  br.dce = dce;
  br.dneg = dneg;
  cudaStream_t st = (cudaStream_t)stream;
  const int n_rg = (R + B_RB - 1) / B_RB;
  cudaError_t err = cudaErrorInvalidValue;
  switch (form) {
    case FORM_F32: err = launch_bwd_form<FORM_F32>(a, br, part, nchunk, cols_per_chunk, n_rg, st); break;
    case FORM_BF16: err = launch_bwd_form<FORM_BF16>(a, br, part, nchunk, cols_per_chunk, n_rg, st); break;
    case FORM_INT8: err = launch_bwd_form<FORM_INT8>(a, br, part, nchunk, cols_per_chunk, n_rg, st); break;
    case FORM_INT8C: err = launch_bwd_form<FORM_INT8C>(a, br, part, nchunk, cols_per_chunk, n_rg, st); break;
  }
  if (err != cudaSuccess) return (int)err;
  const long long n = (long long)R * D;
  quad_bwd_merge_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(a, br, nchunk, part, d_emb,
                                                                     dgt);
  return (int)cudaGetLastError();
}

// the clean-tile cosines [R][Q] of q0 (no writes, no labels), with the
// forward's tiling (bwd_tiles = 0) or the backward's
int quad_clean_cos_launch(QUAD_COMMON_PARAMS, int bwd_tiles, float* out, void* stream) {
  const Args a = make_args(QUAD_COMMON_ARGS);
  cudaStream_t st = (cudaStream_t)stream;
  switch (form) {
    case FORM_F32: return (int)launch_clean_cos_form<FORM_F32>(a, bwd_tiles, out, st);
    case FORM_BF16: return (int)launch_clean_cos_form<FORM_BF16>(a, bwd_tiles, out, st);
    case FORM_INT8: return (int)launch_clean_cos_form<FORM_INT8>(a, bwd_tiles, out, st);
    case FORM_INT8C: return (int)launch_clean_cos_form<FORM_INT8C>(a, bwd_tiles, out, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
