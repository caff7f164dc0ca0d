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
// Layout: emb [B][D] f32 (B <= 128, D a multiple of 64 up to 512), W [C][D]
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
//    wrapper passes, for the forward and the fused and sparse d_w passes;
//    the d_w pass of margin_ce_bwd / margin_partial_bwd computes it from
//    each W tile it stages and writes it there for the d_emb pass, which
//    computes it from its own tiles where nothing wrote it (grad_w=False).
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
//    the streamed (max, sumexp) and top-k, the partial merge, d_cos of a
//    column and the shared-memory tile product; the tensor-core pieces in
//    mma_bf16.cuh.
//  * Forward: one block holds all B rows, so each W tile is read once. The
//    f32 form: a 256-thread register-tiled f32 GEMM (8x8 outputs per
//    thread) fills a [128, 128] raw-dot tile, scaled by each column's
//    1/||w_j|| (summed from the same shared-memory chunks). The bf16 form:
//    the same tile on the tensor cores (chunk_cos). Then two threads per
//    row stream the tile's columns into per-row (max, sumexp) and a
//    register top-k. The target column is left out of both and joins at
//    the merge as scale * phi(gt) (gt comes from outside, as in JAX).
//  * Forward statistics (only when asked for): the same two threads per
//    row also take, per 64-column half tile, the row's max of z (scale *
//    phi(gt) at the target column) and of the raw cosine (the target's own
//    included) into a [2][C/64][B] scratch; a third launch reduces them to
//    the caller's stats tile (a multiple of 64), so the block column ranges
//    need not align with it. Without statistics nothing of this runs.
//  * The bf16 cosine is one chain wherever it is formed: k16 steps over the
//    feature axis in order, each step's product from a zero accumulator
//    added in f32 (mma_bf16.cuh: mma_nt), over bf16(emb) and bf16(w_hat).
//    The backward's top-k test (cos >= kth - KTH_TIE_TOL) compares its
//    recomputed cosine with the forward's kth, so both must be the same
//    bits: the forward and the fused / sparse d_w pass stage W 64 features
//    at a time (chunk_cos), the bf16 d_emb and d_w passes whole tiles, and
//    margin_ce_clean_cos_launch writes each tiling's cosines for a check.
//  * Backward, f32 (margin_bwd_f32_kernel; every f32 form: margin_ce_bwd,
//    margin_partial_bwd, fused, sparse): IEEE f32 FMA on the CUDA cores,
//    register-blocked (margin_common.cuh: ftile_dots, 16-byte cp.async
//    staging into padded rows, float4 shared loads, a micro-tile a thread).
//    One pass of three products: a block (16 warps, one an SM) owns whole
//    64-column tiles with every batch row; per tile it stages W's chunks
//    into a whole tile [64][D + 4] that stays while emb's chunks stream
//    from L2 through two stages, and forms the raw dots [128, 64] (4 x 4 a
//    thread) and ||w||^2: each cosine is tile_gemm's in-order fmaf chain,
//    the forward's bits (margin_ce_clean_cos_launch writes both tilings'
//    for a check). d_cos * inv goes to shared memory, transposed, with
//    <d_w_hat, w_hat> = sum_b d_cos cos from the tile; inv * d_w_hat [64,
//    D] = (d_cos * inv)^T . emb (8 x 8 a thread, emb streamed 15 rows a
//    stage), and the epilogue below takes the stored rows from the tile
//    (the fused update reads them before it writes them). Then the block's
//    d_emb partial [B, D], which lives in global memory (L2: 256 KB a block
//    at B = 128, D = 512), takes (d_cos * inv) . W from the same tile, 8 x 8
//    a thread, 256 features at a time; margin_bwd_demb_merge_kernel sums
//    the blocks' partials in block order. W is read once (2.15 GB at C = 2^20) and
//    d_w written once: the three products' 6.15 ms bound, no recompute.
//    grad_w=False runs the cosines and the d_emb product alone.
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
//  * Backward, d_w epilogue (the f32 pass, and margin_bwd_dw_kernel, the
//    fused and sparse bf16 forms' d_w pass: a block owns whole 64-column
//    tiles with every batch row, its cosines on the tensor cores, d_w_hat
//    in 64-feature chunks on tile_gemm's FMA map): the normalisation
//    backprop d_w = inv * (d_w_hat - w_hat <d_w_hat, w_hat>), where
//    <d_w_hat, w_hat> = sum_b d_cos[b, t] cos[b, t] is summed from the tile
//    (bf16 W: against the dots of emb with the unrounded w_hat, a second
//    product). Each d_w row has one owner block, so no reduction is needed.
//    The owner adds the label rows' d_wl (every batch row whose label is the
//    column, in batch order: a sum, no scatter). Fused: then g = d_w + wd*w,
//    mom' = mu*mom + g, upd = g + mu*mom' (Nesterov) | mom' | g (mu = 0),
//    w' = w - lr*upd, written in place over the rows it has just read. The
//    bf16 d_emb pass runs first in stream order and reads W before any of it
//    is written; the f32 pass takes d_emb from the tile's copy. Every row
//    decays every step: no relevance gate skips a tile.
//  * Backward, bf16 d_w pass of margin_ce_bwd / margin_partial_bwd
//    (margin_bwd_dw_bf16_kernel): a block owns whole 64-column tiles with
//    every batch row; emb [128, D] bf16 stays resident (128 KB at D = 512)
//    beside one W tile (64 KB), so W is read once (1.07 GB) and d_w written
//    once (2.15 GB): the 0.96 ms bound. Per tile: 1/||w|| from the staged
//    rows, the tile scaled in place; cos [128, 64] on the tensor cores; the
//    next tile's copies start; d_cos rounded to bf16 into shared memory;
//    d_w_hat [64, D] = d_cos^T . emb in mma accumulators; the stored values
//    of the epilogue's elements read again (from L2); then <d_w_hat, w_hat>
//    from the finished d_w_hat row against the f32 w_hat = w * inv (JAX's
//    and the plain version's order of operations), reduced over the four
//    warps that share a row in a fixed order, d_w = inv * (d_w_hat - w_hat
//    <d_w_hat, w_hat>) plus the label rows' d_wl in batch order, stored in
//    f32. It runs before the d_emb pass (no update is in place here). d_emb
//    and d_w stay two passes: the [B, D] d_emb partial of a column-owning
//    block (256 KB f32 at B = 128, D = 512) fits neither its registers nor
//    its shared memory beside the tile (the f32 pass keeps it in L2).
//  * Sparse backward: the passes walk M * tile logical columns instead of
//    C. Each 64-column tile maps through tile_idx [M] (device memory, read
//    by every block: the counterpart of scalar prefetch) onto the class
//    rows it stands for; tile is a multiple of 64, so no 64-column tile
//    straddles two selected tiles. d_w rows are written in logical order
//    (rows past C in a ragged last tile as 0); the owner of a row's target
//    column also writes d_gt[b], that column's dz, for the caller's target
//    term. Bound at B = 128, D = 512, M * tile = 65,536: three products
//    2.58e10 FLOP >= 0.385 ms against 0.27 GB (W tiles read, d_w rows
//    written, 0.080 ms): compute-bound; the bf16 form's recompute adds a
//    fourth.
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

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

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

// the fused and sparse bf16 d_w pass's staging of a W element for tile_gemm
// as the UNROUNDED w_hat = w * inv of its row (inv indexed from the tile's
// first row): the product is <bf16(emb), w_hat>, for <d_w_hat, w_hat>
struct StageNormed {
  const float* inv;
  __device__ __forceinline__ float operator()(__nv_bfloat16 y, int row) const {
    return __bfloat162float(y) * inv[row];
  }
};

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

// The forward's and the fused / sparse d_w pass's bf16 cosines: emb rows
// [0, ROWS) and a tile of TC columns staged 64 features at a time, CH_ST
// chunks in flight
constexpr int CH_ST = 3;
template <int ROWS, int TC>
__host__ __device__ constexpr int chunk_bytes() {
  return (ROWS + TC) * 64 * 2;
}

// features [64 kc, + 64) of emb rows [0, ROWS) (zero past B) and of the W
// rows p0 .. p0 + n of the tile (zero from n) into stage s
template <int ROWS, int TC>
__device__ __forceinline__ void load_chunk(const Args& a, unsigned char* stg, int s, long long p0,
                                           int n, int kc) {
  const __nv_bfloat16* W = wrows<__nv_bfloat16>(a);
  unsigned char* Es = stg + s * chunk_bytes<ROWS, TC>();
  unsigned char* Ts = Es + ROWS * 64 * 2;
  const int f0 = 64 * kc;
  for (int i = threadIdx.x; i < (ROWS + TC) * 8; i += blockDim.x) {
    const int r = i >> 3, ch = i & 7;
    if (r < ROWS) {
      const bool ok = r < a.B;
      cp_async_cg(Es + swz(r, 8 * ch, 8), ok ? a.eb + (long long)r * a.D + f0 + 8 * ch : a.eb, ok);
    } else {
      const bool ok = r - ROWS < n;
      cp_async_cg(Ts + swz(r - ROWS, 8 * ch, 8), ok ? W + (p0 + r - ROWS) * a.D + f0 + 8 * ch : W,
                  ok);
    }
  }
}

// acc[mi][ni] = the cosines of emb rows m0 + 16 mi .. against the tile's
// columns n0 + 8 ni .. (class rows p0 .., n of them): each chunk's W part
// scaled in place by inv [TC] (shared memory, written before the call) into
// bf16(w_hat), the k16 chain over the feature axis in order (module
// header). Stages its own copies and leaves none in flight.
template <int ROWS, int TC, int NI>
__device__ __forceinline__ void chunk_cos(const Args& a, unsigned char* stg, const float* inv,
                                          long long p0, int n, int m0, int n0,
                                          float (&acc)[2][NI][4]) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
  const int n_kc = a.D / 64;
  for (int s = 0; s < CH_ST - 1; ++s) {
    if (s < n_kc) load_chunk<ROWS, TC>(a, stg, s, p0, n, s);
    cp_async_commit();
  }
  for (int kc = 0; kc < n_kc; ++kc) {
    cp_async_wait<CH_ST - 2>();
    __syncthreads();  // chunk kc has landed; chunk kc - 1's stage is free
    unsigned char* Es = stg + (kc % CH_ST) * chunk_bytes<ROWS, TC>();
    scale_rows_bf16(Es + ROWS * 64 * 2, TC, 8, inv);
    if (kc + CH_ST - 1 < n_kc)
      load_chunk<ROWS, TC>(a, stg, (kc + CH_ST - 1) % CH_ST, p0, n, kc + CH_ST - 1);
    cp_async_commit();
    __syncthreads();  // the chunk holds bf16(w_hat)
    mma_nt<2, NI>(acc, Es, 8, m0, Es + ROWS * 64 * 2, 8, n0, 4);
  }
  cp_async_wait<0>();
  __syncthreads();  // every stage is free for the next tile
}

// ---------------------------------------------------------------- forward

constexpr int F_ROWS = 128, F_TC = 128, F_DK = 16, F_THREADS = 256;
constexpr int F_ALD = F_ROWS + 4, F_BLD = F_TC + 4, F_CLD = F_TC + 1;
// the GEMM staging (f32: the FMA tile's chunks; bf16: the tensor cores'
// chunk stages), then the cosine tile and the columns' 1 / ||w_j||
template <class TW>
constexpr size_t fwd_smem() {
  return (std::is_same<TW, float>::value ? sizeof(float) * (F_DK * F_ALD + F_DK * F_BLD)
                                         : (size_t)CH_ST * chunk_bytes<F_ROWS, F_TC>()) +
         sizeof(float) * (F_ROWS * F_CLD + F_TC);
}
constexpr int STAT_COLS = 64;  // columns per statistics partial: one thread's half tile
static_assert(F_TC / 2 == STAT_COLS, "a statistics partial is one thread's half tile");

// stats: nullptr, or the [2][ceil(C / 64)][B] scratch of per-64-column maxima
// (z first, then the raw cosine)
template <class TW>
__global__ void __launch_bounds__(F_THREADS)
    margin_fwd_kernel(Args a, long long cols_per_blk, float* part, float* stats) {
  constexpr bool BF16 = !std::is_same<TW, float>::value;
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                   // f32: emb chunk, k-major [F_DK][F_ALD]
  float* Bs = As + F_DK * F_ALD;      // f32: W chunk, k-major [F_DK][F_BLD]
  unsigned char* stg = reinterpret_cast<unsigned char*>(smem);  // bf16: [CH_ST] chunk stages
  float* Cs = BF16 ? reinterpret_cast<float*>(stg + CH_ST * chunk_bytes<F_ROWS, F_TC>())
                   : Bs + F_DK * F_BLD;  // cosine tile [F_ROWS][F_CLD]
  float* inv = Cs + F_ROWS * F_CLD;   // 1 / ||w_j|| of the tile's columns

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;  // GEMM outputs: rows ty + 16i, cols tx + 16j
  const long long c_begin = (long long)blockIdx.x * cols_per_blk;
  const long long c_end = min(a.C, c_begin + cols_per_blk);

  const int r = tid % F_ROWS, half = tid / F_ROWS;  // epilogue: one row, half the columns
  const bool row_ok = r < a.B;
  const int label = row_ok ? a.labels[r] : -1;
  const float gt = row_ok ? a.gt[r] : 0.f;
  const float zt = a.scale * phi_target(gt, a);  // the target column's z, for the statistics
  const long long n64 = (a.C + STAT_COLS - 1) / STAT_COLS;
  float m = -INFINITY, s = 0.f, kth = NEG_INF_F;
  float tk[KMAX];
#pragma unroll
  for (int j = 0; j < KMAX; ++j) tk[j] = NEG_INF_F;

  for (long long t0 = c_begin; t0 < c_end; t0 += F_TC) {
    if constexpr (BF16) {  // the dots of the rounded operands are the cosines
      const int n = (int)min((long long)F_TC, c_end - t0);
      if (tid < F_TC) inv[tid] = tid < n ? a.inv[t0 + tid] : 0.f;
      // warps of 32 rows x 64 columns
      const int warp = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
      const int wr = (warp & 3) * 32, wc = (warp >> 2) * 64;
      float acc[2][8][4];
      chunk_cos<F_ROWS, F_TC, 8>(a, stg, inv, t0, n, wr, wc, acc);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 8; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            Cs[(wr + 16 * mi + g + 8 * (e >> 1)) * F_CLD + wc + 8 * ni + 2 * t + (e & 1)] =
                acc[mi][ni][e];
    } else {
      float acc[8][8];
      float n2;
      tile_gemm<F_ROWS, F_TC, F_DK, F_THREADS, F_ALD, F_BLD, 8, 8, 16, 16, true>(
          acc, n2, As, Bs, a.emb, 0, a.B, wrows<TW>(a), t0, c_end, a.D, ty, tx);
      if (tid < F_TC) inv[tid] = inv_norm(n2);
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          Cs[(ty + 16 * i) * F_CLD + tx + 16 * j] = acc[i][j] * inv[tx + 16 * j];
    }
    __syncthreads();

    if (row_ok) {
      const int n = (int)min((long long)F_TC, c_end - t0);
      const int c_hi = min(n, (half + 1) * (F_TC / 2));
      for (int c = half * (F_TC / 2); c < c_hi; ++c) {
        if (t0 + c == (long long)label) continue;  // target: joins at the merge
        const float cv = Cs[r * F_CLD + c];
        stream_update(cv, gt, a, m, s);
        topk_insert(tk, kth, cv, a.k);
      }
      if (stats != nullptr) {  // the target column counts here, as in _stream_fwd
        float zm = -INFINITY, cm = -INFINITY;
        for (int c = half * (F_TC / 2); c < c_hi; ++c) {
          const float cv = Cs[r * F_CLD + c];
          float mod = cv;
          if (a.loss_type == LOSS_SV && cv > gt - a.margin)
            mod = a.mask_svfc * cv + a.mask_svfc - 1.0f;
          zm = fmaxf(zm, t0 + c == (long long)label ? zt : a.scale * mod);
          cm = fmaxf(cm, cv);
        }
        const long long g = t0 / STAT_COLS + half;
        if (g < n64) {  // a half tile past C holds no column and is not written
          stats[g * a.B + r] = zm;
          stats[(n64 + g) * a.B + r] = cm;
        }
      }
    }
    __syncthreads();  // Cs and inv are rebuilt by the next tile
  }

  if (row_ok) {
    float* p = part + (((long long)blockIdx.x * 2 + half) * a.B + r) * PART;
    p[0] = m;
    p[1] = s;
#pragma unroll
    for (int j = 0; j < KMAX; ++j) p[2 + j] = tk[j];
  }
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

// the raw dots of the f32 pass, emb rows gr + 32 i with the tile's columns gc
// + 16 j, class rows p0 .. p0 + n - 1 staged into Wt [FB_TC][D + 4], and of
// thread t < FB_TC ||w||^2 of column t
__device__ __forceinline__ void fb_dots(float (&acc)[4][4], float& n2, float* stg, float* Wt,
                                        const Args& a, long long p0, int n, int gr, int gc) {
  ftile_dots<FB_ROWS, FB_TC, FB_THREADS, FB_NST, FB_FK, 4, 4, 32, 16>(
      acc, n2, stg, Wt, a.emb, 0, a.B, wrows<float>(a), p0, n, a.D, gr, gc);
}

// part [gridDim.x][B][D]: each block's d_emb partial over its columns.
// MODE FB_DW: d_w to dw (row by logical column), each column's owner adding
// d_wl [B][D] (the label rows' gradient) for every batch row labelled with
// it, in batch order; dgt: nullptr, or [B] zeros where the owner of a row's
// target column writes that column's dz. FB_SGD: the SGD update applied to
// sgd.w and sgd.mom (type TM) in place instead. FB_DEMB: d_emb alone.
template <class TM, int MODE>
__global__ void __launch_bounds__(FB_THREADS, 1)
    margin_bwd_f32_kernel(Args a, BwdRows br, long long cols_per_blk, const float* dwl,
                          float* dw, Sgd sgd, float* dgt, float* part) {
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
  RowIn* rin = reinterpret_cast<RowIn*>(sdot + FB_TC);  // [FB_ROWS]
  int* tgt = reinterpret_cast<int*>(rin + FB_ROWS);      // label - p0 in this tile, else -1

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long c_begin = (long long)blockIdx.x * cols_per_blk;
  const long long c_end = min(a.ncols, c_begin + cols_per_blk);
  float* pblk = part + (long long)blockIdx.x * a.B * D;
  load_row_in(rin, FB_ROWS, 0, a, br);  // thread t < FB_ROWS writes row t
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
    bool hit = false;
    if (MODE != FB_DEMB && tid < FB_ROWS) {
      const RowIn v = rin[tid];
      const long long off = (long long)v.lab - p0;
      hit = v.lab >= 0 && off >= 0 && off < n;
      tgt[tid] = hit ? (int)off : -1;
      if (hit && dgt != nullptr)  // the target column's dz: (p_t - 1) d_ce scale
        dgt[tid] = (expf(a.scale * phi_target(v.gt, a) - v.lz) - 1.f) * v.dce * a.scale;
    }
    {
      float acc[4][4], n2;
      fb_dots(acc, n2, stg, Wt, a, p0, n, gr, gc);
      if (tid < FB_TC) inv[tid] = inv_norm(n2);
      __syncthreads();  // inv is visible
      float sp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int b = gr + 32 * i;
        const RowIn v = rin[b];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = gc + 16 * j;
          float d = 0.f;
          if (b < a.B && c < n) {
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
    const bool tile_tgt = __syncthreads_or(hit);  // Dq, red and tgt are visible

    if constexpr (MODE != FB_DEMB) {
      if (tid < FB_TC) {
        float s = 0.f;
        for (int y = 0; y < 32; ++y) s += red[y * FB_TC + tid];
        sdot[tid] = s;
      }
      // inv * d_w_hat [FB_TC, D] = (d_cos * inv)^T . emb, summed over the
      // batch in order, FB_EK emb rows a stage
      const int nbk = (a.B + FB_EK - 1) / FB_EK;
      auto load = [&](int bk) {
        if (bk < nbk)
          stage_f32<FB_THREADS>(stg + (bk % FB_ENST) * FB_EK * wld, wld, a.emb, FB_EK * bk,
                                min(FB_EK, a.B - FB_EK * bk), FB_EK, D, 0, D);
        cp_async_commit();
      };
      __syncthreads();  // red is read: the stages are free; sdot is visible
      for (int s = 0; s < FB_ENST - 1; ++s) load(s);
      float acc3[8][8];  // [column][4 h + feature]
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
        const int nb = min(FB_EK, a.B - FB_EK * bk);
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

      // d_w = inv * (d_w_hat - w_hat <d_w_hat, w_hat>) + the label rows' d_wl,
      // the stored rows from the tile
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int t = 8 * g2 + i;
        if (t >= nl) continue;
        const float iv = inv[t], sd = sdot[t];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int f = 4 * fx + 256 * h;
          if (f >= D) continue;
          const long long off_out = (t0 + t) * D + f;  // the output row: logical column
          if (t >= n) {  // a selected ragged last tile's rows past C
            store4(dw + off_out, make_float4(0.f, 0.f, 0.f, 0.f));
            continue;
          }
          const float4 w4 = *reinterpret_cast<const float4*>(Wt + t * wld + f);
          const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
          float g[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) g[e] = acc3[i][4 * h + e] - wv[e] * iv * (iv * sd);
          if (tile_tgt)
            for (int b = 0; b < a.B; ++b)
              if (tgt[b] == t)
#pragma unroll
                for (int e = 0; e < 4; ++e) g[e] += dwl[(long long)b * D + f + e];
          if (MODE == FB_DW) {
            store4(dw + off_out, make_float4(g[0], g[1], g[2], g[3]));
            continue;
          }
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
    // column by column, 256 features at a time
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
  if (first)  // a block without columns: its partial is 0
    for (long long i = tid; i < (long long)a.B * D; i += FB_THREADS) pblk[i] = 0.f;
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

constexpr int W_ROWS = 128, W_TC = 64, W_DK = 16, W_THREADS = 256, W_DC = 64;
constexpr int W_ALD = W_ROWS + 4, W_BLD = W_TC + 4, W_CLD = W_TC + 1, W_ELD = W_DC + 4;
constexpr size_t W_SMEM =
    sizeof(float) * (W_DK * W_ALD + W_DK * W_BLD + W_ROWS * W_CLD + W_ROWS * W_ELD +
                     16 * W_TC + 2 * W_TC + 5 * W_ROWS) +
    sizeof(int) * (2 * W_ROWS + 1);
// bf16 W: the chunk stages of the tensor cores' cosines in front
constexpr size_t W_SMEM_BF16 = W_SMEM + CH_ST * chunk_bytes<W_ROWS, W_TC>();

// The fused and sparse bf16 forms' d_w pass (the bf16 d_w pass of
// margin_ce_bwd / margin_partial_bwd: margin_bwd_dw_bf16_kernel; f32 W:
// margin_bwd_f32_kernel, so TW is bf16 here). Each column's owner adds
// d_wl [B][D] (the label rows' gradient) for every batch row labelled with
// it. fused == 0: write d_w to dw (row by logical
// column). Otherwise apply the SGD update to sgd.w and sgd.mom (type TM) in
// place (dw unused). dgt: nullptr, or [B] zeros where the owner of a row's
// target column writes that column's dz.
template <class TW, class TM>
__global__ void __launch_bounds__(W_THREADS)
    margin_bwd_dw_kernel(Args a, BwdRows br, long long cols_per_blk, const float* dwl, float* dw,
                         Sgd sgd, int fused, float* dgt) {
  constexpr bool BF16 = !std::is_same<TW, float>::value;
  const TW* W = wrows<TW>(a);
  TW* w_upd = static_cast<TW*>(sgd.w);
  TM* mom = static_cast<TM*>(sgd.mom);
  extern __shared__ __align__(16) float smem[];
  unsigned char* stg = reinterpret_cast<unsigned char*>(smem);  // bf16: [CH_ST] chunk stages
  float* As = BF16 ? reinterpret_cast<float*>(stg + CH_ST * chunk_bytes<W_ROWS, W_TC>())
                   : smem;               // emb chunk, k-major [W_DK][W_ALD]
  float* Bs = As + W_DK * W_ALD;         // W chunk, k-major [W_DK][W_BLD]
  float* Dc = Bs + W_DK * W_BLD;         // d_cos [W_ROWS][W_CLD]
  float* Es = Dc + W_ROWS * W_CLD;       // emb feature chunk [W_ROWS][W_ELD]
  float* red = Es + W_ROWS * W_ELD;      // [16][W_TC] partial sums of d_cos * cos
  float* inv = red + 16 * W_TC;          // [W_TC]
  float* sdot = inv + W_TC;              // [W_TC] <d_w_hat, w_hat> = sum_b d_cos * cos
  float* r_gt = sdot + W_TC;             // per-row inputs [W_ROWS] each
  float* r_lz = r_gt + W_ROWS;
  float* r_kth = r_lz + W_ROWS;
  float* r_dce = r_kth + W_ROWS;
  float* r_dneg = r_dce + W_ROWS;
  int* r_lab = reinterpret_cast<int*>(r_dneg + W_ROWS);
  int* tgt = r_lab + W_ROWS;             // [W_ROWS] label - t0 if in this tile, else -1
  int* any_tgt = tgt + W_ROWS;

  const int tid = threadIdx.x;
  const long long c_begin = (long long)blockIdx.x * cols_per_blk;
  const long long c_end = min(a.ncols, c_begin + cols_per_blk);
  for (int b = tid; b < W_ROWS; b += W_THREADS) {
    const bool ok = b < a.B;
    r_lab[b] = ok ? a.labels[b] : -1;
    r_gt[b] = ok ? a.gt[b] : 0.f;
    r_lz[b] = ok ? br.logz[b] : 0.f;
    r_kth[b] = ok ? br.kth[b] : 0.f;
    r_dce[b] = ok ? br.dce[b] : 0.f;
    r_dneg[b] = ok ? br.dneg[b] : 0.f;
  }
  // cos / d_cos map: rows ty + 16i (i < 8), cols tx + 16j (j < 4);
  // d_w_hat map: cols ty + 16i (i < 4), features tx + 16j (j < 4) of a chunk
  const int tx = tid & 15, ty = tid >> 4;

  for (long long t0 = c_begin; t0 < c_end; t0 += W_TC) {
    const long long p0 = phys_col(a, t0);
    const int nl = (int)min((long long)W_TC, c_end - t0);  // output rows of this tile
    const int n = valid_cols(a, t0, p0, c_end, W_TC);       // ... that stand for a class
    if (tid == 0) *any_tgt = 0;
    __syncthreads();
    if (tid < W_ROWS) {
      const long long off = (long long)r_lab[tid] - p0;
      const bool in = r_lab[tid] >= 0 && off >= 0 && off < n;
      tgt[tid] = in ? (int)off : -1;
      if (in) *any_tgt = 1;  // every writer stores the same value
      if (in && dgt != nullptr)  // the target column's dz: (p_t - 1) d_ce scale
        dgt[tid] = (expf(a.scale * phi_target(r_gt[tid], a) - r_lz[tid]) - 1.f) * r_dce[tid] *
                   a.scale;
    }

    // acc: the cosines (f32 W: raw dots); bf16 W: also ce, the dots of the
    // rounded emb with the unrounded w_hat, for <d_w_hat, w_hat>
    float acc[8][4], ce[8][4];
    if constexpr (BF16) {
      if (tid < W_TC) inv[tid] = tid < n ? a.inv[t0 + tid] : 0.f;
      // the cosines on the tensor cores (the forward's chain; warps of 32
      // rows x 32 columns), handed to the thread map below through Dc
      const int warp = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
      const int wr = (warp & 3) * 32, wc = (warp >> 2) * 32;
      float mc[2][4][4];
      chunk_cos<W_ROWS, W_TC, 4>(a, stg, inv, p0, n, wr, wc, mc);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            Dc[(wr + 16 * mi + g + 8 * (e >> 1)) * W_CLD + wc + 8 * ni + 2 * t + (e & 1)] =
                mc[mi][ni][e];
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = Dc[(ty + 16 * i) * W_CLD + tx + 16 * j];
      float n2;  // tile_gemm's barriers order these reads before Dc is rewritten
      tile_gemm<W_ROWS, W_TC, W_DK, W_THREADS, W_ALD, W_BLD, 8, 4, 16, 16, false>(
          ce, n2, As, Bs, a.emb, 0, a.B, W, p0, p0 + n, a.D, ty, tx, StageNormed{inv});
    } else {
      float n2;
      tile_gemm<W_ROWS, W_TC, W_DK, W_THREADS, W_ALD, W_BLD, 8, 4, 16, 16, true>(
          acc, n2, As, Bs, a.emb, 0, a.B, W, p0, p0 + n, a.D, ty, tx);
      if (tid < W_TC) inv[tid] = inv_norm(n2);
    }
    __syncthreads();

    float sp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int b = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        float d = 0.f;
        if (b < a.B && c < n) {
          const float cv = BF16 ? acc[i][j] : acc[i][j] * inv[c];
          d = dcos_of(cv, p0 + c, r_lab[b], r_gt[b], r_lz[b], r_kth[b], r_dce[b], r_dneg[b], a);
          if constexpr (BF16) {
            d = bf16r(d);
            sp[j] = fmaf(d, ce[i][j], sp[j]);
          } else {
            sp[j] = fmaf(d, cv, sp[j]);
          }
        }
        Dc[b * W_CLD + c] = d;
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) red[ty * W_TC + tx + 16 * j] = sp[j];
    __syncthreads();
    if (tid < W_TC) {
      float sd = 0.f;
      for (int y = 0; y < 16; ++y) sd += red[y * W_TC + tid];
      sdot[tid] = sd;
    }
    const bool tile_tgt = *any_tgt != 0;

    for (int dc0 = 0; dc0 < a.D; dc0 += W_DC) {
      __syncthreads();  // Es free (previous chunk done); sdot visible
#pragma unroll
      for (int l = 0; l < W_ROWS * W_DC / W_THREADS; ++l) {
        const int idx = l * W_THREADS + tid, b = idx / W_DC, d = idx % W_DC;
        Es[b * W_ELD + d] = b < a.B ? a.emb[(long long)b * a.D + dc0 + d] : 0.f;
      }
      __syncthreads();
      float acc3[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc3[i][j] = 0.f;
      for (int b = 0; b < a.B; ++b) {
        float dv[4], ev[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) dv[i] = Dc[b * W_CLD + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) ev[j] = Es[b * W_ELD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc3[i][j] = fmaf(dv[i], ev[j], acc3[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
        if (t >= nl) continue;
        const float iv = inv[t], sd = sdot[t];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int d = dc0 + tx + 16 * j;
          const long long off_out = (t0 + t) * a.D + d;  // the output row: logical column
          if (t >= n) {  // a selected ragged last tile's rows past C
            dw[off_out] = 0.f;
            continue;
          }
          const long long off = (p0 + t) * a.D + d;  // the class row
          const float wv = to_f32(W[off]);  // plain load: the fused pass overwrites this row
          float g = iv * (acc3[i][j] - wv * iv * sd);
          if (tile_tgt) {
            for (int b = 0; b < a.B; ++b)
              if (tgt[b] == t) g += dwl[(long long)b * a.D + d];
          }
          if (!fused) {
            dw[off_out] = g;
            continue;
          }
          if (sgd.wd != 0.f) g = g + sgd.wd * wv;
          float mn = g, upd = g;
          if (sgd.mu != 0.f) {
            mn = sgd.mu * to_f32(mom[off]) + g;
            upd = sgd.nesterov ? g + sgd.mu * mn : mn;
          }
          store_as(mom + off, mn);  // each rounded once to its storage type
          store_as(w_upd + off, wv - sgd.lr * upd);
        }
      }
    }
    __syncthreads();  // Dc, sdot, tgt are rebuilt by the next tile
  }
}

constexpr int WB_ROWS = 128, WB_TC = 64;  // bf16 d_w pass: batch rows, tile columns

// shared memory of the bf16 d_w pass at feature width D: emb, the W tile,
// bf16(d_cos), the tile's 1 / ||w|| and <d_w_hat, w_hat> partials (eight
// feature groups), the rows' inputs and target offsets
__host__ __device__ constexpr int dw_bf16_smem(int D) {
  return WB_ROWS * D * 2 + WB_TC * D * 2 + WB_ROWS * WB_TC * 2 + 9 * WB_TC * 4 +
         WB_ROWS * ((int)sizeof(RowIn) + 4);
}

// The bf16 d_w pass of margin_ce_bwd / margin_partial_bwd (module header):
// d_w [C][D] f32 with each label row's d_wl [B][D] added by the column's
// owner in batch order; 1 / ||w|| of each column into inv_out for the d_emb
// pass.
__global__ void __launch_bounds__(BW_THREADS, 1)
    margin_bwd_dw_bf16_kernel(Args a, BwdRows br, long long cols_per_blk, const float* dwl,
                              float* dw, float* inv_out) {
  extern __shared__ __align__(16) unsigned char dw_sm[];
  const int D = a.D, rcd = D / 8;
  const __nv_bfloat16* W = wrows<__nv_bfloat16>(a);
  unsigned char* Es = dw_sm;                   // emb [WB_ROWS][D]
  unsigned char* Ws = Es + WB_ROWS * D * 2;    // the W tile [WB_TC][D]: stored, then bf16(w_hat)
  unsigned char* Dc = Ws + WB_TC * D * 2;      // bf16(d_cos) [WB_ROWS][WB_TC]
  float* inv = reinterpret_cast<float*>(Dc + WB_ROWS * WB_TC * 2);  // [WB_TC]
  float* sdp = inv + WB_TC;  // [8][WB_TC] <d_w_hat, w_hat> over each feature group
  RowIn* rin = reinterpret_cast<RowIn*>(sdp + 8 * WB_TC);  // [WB_ROWS]
  int* tgt = reinterpret_cast<int*>(rin + WB_ROWS);        // label - t0 in this tile, else -1

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const long long c_begin = (long long)blockIdx.x * cols_per_blk;
  const long long c_end = min(a.C, c_begin + cols_per_blk);
  const int n_tiles = c_end > c_begin ? (int)((c_end - c_begin + WB_TC - 1) / WB_TC) : 0;
  const int nb = (a.B + 15) / 16;  // k16 steps of d_w_hat over the batch

  stage_rows_bf16(Es, a.eb, 0, a.B, WB_ROWS, D);
  if (n_tiles > 0) stage_rows_bf16(Ws, W, c_begin, (int)min((long long)WB_TC, c_end - c_begin),
                                   WB_TC, D);
  cp_async_commit();
  load_row_in(rin, WB_ROWS, 0, a, br);

  // the cosine map: warp w holds rows 32 (w % 4) .., columns 16 (w / 4) ..;
  // the d_w_hat map: columns 32 (w % 2) .., features 16 p .. 16 p + 15 of
  // the pairs of n8 tiles p = w / 2 + 8 i (i < 4; D / 16 pairs), so a
  // column's features lie in eight warps (feature group w / 2)
  const int m0 = (warp & 3) * 32, n0 = (warp >> 2) * 16;
  const int m2 = (warp & 1) * 32, q2 = warp >> 1, np = D / 16;

  for (int ti = 0; ti < n_tiles; ++ti) {
    const long long t0 = c_begin + (long long)ti * WB_TC;
    const int n = (int)min((long long)WB_TC, c_end - t0);
    cp_async_wait<0>();
    __syncthreads();  // the tile (and emb) landed; the last tile's epilogue is done
    row_inv_tile(Ws, n, D, inv);
    bool hit = false;
    if (tid < WB_ROWS) {
      const long long off = (long long)rin[tid].lab - t0;
      tgt[tid] = rin[tid].lab >= 0 && off >= 0 && off < n ? (int)off : -1;
      hit = tgt[tid] >= 0;
    }
    const bool any_tgt = __syncthreads_or(hit);  // inv and tgt visible
    if (tid < n) inv_out[t0 + tid] = inv[tid];
    scale_rows_bf16(Ws, WB_TC, rcd, inv);
    __syncthreads();  // the tile holds bf16(w_hat)

    float acc[2][2][4] = {};
    mma_nt<2, 2>(acc, Es, rcd, m0, Ws, rcd, n0, D / 16);
    __syncthreads();  // every warp is done with the tile: the next one's copies start
    if (ti + 1 < n_tiles)
      stage_rows_bf16(Ws, W, t0 + WB_TC, (int)min((long long)WB_TC, c_end - t0 - WB_TC), WB_TC, D);
    cp_async_commit();
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int b = m0 + 16 * mi + g + 8 * h;
        const RowIn v = rin[b];
#pragma unroll
        for (int ni = 0; ni < 2; ++ni) {
          const int c = n0 + 8 * ni + 2 * t;
          float d[2];
#pragma unroll
          for (int j = 0; j < 2; ++j)
            d[j] = b < a.B && c + j < n
                       ? dcos_of(acc[mi][ni][2 * h + j], t0 + c + j, v.lab, v.gt, v.lz, v.kth,
                                 v.dce, v.dneg, a)
                       : 0.f;
          *reinterpret_cast<__nv_bfloat162*>(Dc + swz(b, c, WB_TC / 8)) =
              __floats2bfloat162_rn(d[0], d[1]);
        }
      }
    __syncthreads();  // Dc is complete

    // d_w_hat = bf16(d_cos)^T . bf16(emb): each k16 step's product (16
    // batch rows) from a zero accumulator, added in f32
    float dwh[2][8][4] = {};
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

    // the stored values of the thread's d_w elements (columns m2 + 16 mi + g
    // + 8 h, features fj + 2 t, + 1 of its n8 tiles j: fj = 16 (q2 + 8 (j /
    // 2)) + 8 (j % 2)), again from L2: the tile's copy in shared memory is
    // bf16(w_hat) now (issued before the product, they spill)
    auto feat = [&](int j) { return 16 * (q2 + 8 * (j >> 1)) + 8 * (j & 1) + 2 * t; };
    uint32_t wst[2][2][8];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = m2 + 16 * mi + g + 8 * h;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          wst[mi][h][j] = q2 + 8 * (j >> 1) < np && c < n
                              ? __ldg(reinterpret_cast<const unsigned*>(W + (t0 + c) * D + feat(j)))
                              : 0u;
      }

    // <d_w_hat, w_hat> of each column from its finished row against the f32
    // w_hat = w * inv: the thread's features, its row's four lanes, then the
    // eight warps of the row in order
    float sd[2][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float iv = inv[m2 + 16 * mi + g + 8 * h];
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (q2 + 8 * (j >> 1) >= np) continue;
          const float2 wf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&wst[mi][h][j]));
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
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = m2 + 16 * mi + g + 8 * h;
        if (c >= n) continue;
        const float iv = inv[c];
        float s = 0.f;
        for (int q = 0; q < 8; ++q) s += sdp[q * WB_TC + c];
        float* out = dw + (t0 + c) * D;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (q2 + 8 * (j >> 1) >= np) continue;
          const float2 wf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&wst[mi][h][j]));
          float2 gv = make_float2(iv * (dwh[mi][j][2 * h] - wf.x * iv * s),
                                  iv * (dwh[mi][j][2 * h + 1] - wf.y * iv * s));
          if (any_tgt)  // the label rows' d_wl, in batch order
            for (int b = 0; b < a.B; ++b) {
              if (tgt[b] != c) continue;
              const float2 l = *reinterpret_cast<const float2*>(dwl + (long long)b * D + feat(j));
              gv.x += l.x;
              gv.y += l.y;
            }
          *reinterpret_cast<float2*>(out + feat(j)) = gv;
        }
      }
  }
  cp_async_wait<0>();
}

// ------------------------------------------------------------ clean cosines

// out [B][C] = the bf16 cosines of every column (no labels read) as the
// chunk staging forms them: TC = 128 columns a block as the forward does,
// 64 as the fused and sparse d_w pass does; 1 / ||w|| from a.inv
template <int TC>
__global__ void __launch_bounds__(256) clean_cos_chunk_kernel(Args a, float* out) {
  extern __shared__ __align__(16) unsigned char cc_sm[];
  float* inv = reinterpret_cast<float*>(cc_sm + CH_ST * chunk_bytes<128, TC>());
  const int tid = threadIdx.x, warp = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
  const long long t0 = (long long)blockIdx.x * TC;
  const int n = (int)min((long long)TC, a.C - t0);
  if (tid < TC) inv[tid] = tid < n ? a.inv[t0 + tid] : 0.f;
  const int wr = (warp & 3) * 32, wc = (warp >> 2) * (TC / 2);
  float acc[2][TC / 16][4];
  chunk_cos<128, TC, TC / 16>(a, cc_sm, inv, t0, n, wr, wc, acc);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < TC / 16; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = wr + 16 * mi + g + 8 * (e >> 1), c = wc + 8 * ni + 2 * t + (e & 1);
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
        const int r = r_base + m0 + 16 * mi + g + 8 * (e >> 1), c = n0 + 8 * ni + 2 * t + (e & 1);
        if (r < a.B && c < n) out[r * a.C + t0 + c] = acc[mi][ni][e];
      }
}

// out [B][C] = the f32 cosines of every column (no labels read) as the f32
// kernels form them: the forward's tile_gemm (128 columns a block) and the
// backward's ftile_dots (64 columns a block, every row; the one pass of every
// f32 backward form)
__global__ void __launch_bounds__(F_THREADS) clean_cos_f32_fwd_kernel(Args a, float* out) {
  extern __shared__ __align__(16) float cf_sm[];
  float* As = cf_sm;
  float* Bs = As + F_DK * F_ALD;
  float* inv = Bs + F_DK * F_BLD;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long long t0 = (long long)blockIdx.x * F_TC;
  const long long c_end = min(a.C, t0 + F_TC);
  float acc[8][8], n2;
  tile_gemm<F_ROWS, F_TC, F_DK, F_THREADS, F_ALD, F_BLD, 8, 8, 16, 16, true>(
      acc, n2, As, Bs, a.emb, 0, a.B, wrows<float>(a), t0, c_end, a.D, ty, tx);
  if (tid < F_TC) inv[tid] = inv_norm(n2);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int r = ty + 16 * i, c = tx + 16 * j;
      if (r < a.B && t0 + c < c_end) out[r * a.C + t0 + c] = acc[i][j] * inv[c];
    }
}

__global__ void __launch_bounds__(FB_THREADS, 1) clean_cos_f32_bwd_kernel(Args a, float* out) {
  extern __shared__ __align__(16) float cb_sm[];
  float* Wt = cb_sm;
  float* stg = Wt + FB_TC * (a.D + 4);
  float* inv = stg + FB_XSTG;
  const long long t0 = (long long)blockIdx.x * FB_TC;
  const int n = (int)min((long long)FB_TC, a.C - t0);
  int gr, gc;
  fb_cos_map(gr, gc);
  float acc[4][4], n2;
  fb_dots(acc, n2, stg, Wt, a, t0, n, gr, gc);
  if (threadIdx.x < FB_TC) inv[threadIdx.x] = inv_norm(n2);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = gr + 32 * i, c = gc + 16 * j;
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

// the forward's block pass over nblk column ranges
template <class TW>
int launch_fwd_pass(const Args& a, int nblk, long long cols_per_blk, float* part, float* stats,
                    cudaStream_t st) {
  if (!std::is_same<TW, float>::value) {
    const int err = launch_inv(a, st);
    if (err != 0) return err;
  }
  constexpr size_t smem = fwd_smem<TW>();
  const int err = allow_smem(margin_fwd_kernel<TW>, smem);
  if (err != 0) return err;
  margin_fwd_kernel<TW><<<nblk, F_THREADS, smem, st>>>(a, cols_per_blk, part, stats);
  return (int)cudaGetLastError();
}

int launch_fwd_pass_form(int w_bf16, const Args& a, int nblk, long long cols_per_blk,
                         float* part, float* stats, cudaStream_t st) {
  return w_bf16 ? launch_fwd_pass<__nv_bfloat16>(a, nblk, cols_per_blk, part, stats, st)
                : launch_fwd_pass<float>(a, nblk, cols_per_blk, part, stats, st);
}

// the f32 pass over nblk column ranges in its mode (FB_DEMB, FB_DW, FB_SGD)
template <class TM>
int launch_f32_pass(int mode, const Args& a, const BwdRows& br, int nblk, long long cols_per_blk,
                    const float* dwl, float* dw, const Sgd& sgd, float* dgt, float* part,
                    cudaStream_t st) {
  auto kernel = mode == FB_SGD  ? margin_bwd_f32_kernel<TM, FB_SGD>
                : mode == FB_DW ? margin_bwd_f32_kernel<float, FB_DW>
                                : margin_bwd_f32_kernel<float, FB_DEMB>;
  const size_t smem = fb_smem(a.D);
  const int e = allow_smem(kernel, smem);
  if (e != 0) return e;
  kernel<<<nblk, FB_THREADS, smem, st>>>(a, br, cols_per_blk, dwl, dw, sgd, dgt, part);
  return (int)cudaGetLastError();
}

// the backward. f32 W: the one pass (column owners, each with its d_emb
// partial), then the merge of the nchunk (= dw_nblk) partials. bf16 W: the
// d_emb pass (row groups of 64 rows x nchunk column chunks), the merge, and
// the d_w pass (column owners) after it; the dense unfused d_w
// (margin_ce_bwd, margin_partial_bwd) runs the tensor-core pass before it,
// and that pass's 1 / ||w|| serves the d_emb pass. grad_w=False: dw nullptr
// and not fused.
template <class TW, class TM>
int launch_bwd(const Args& a, const BwdRows& br, float* part, int nchunk,
               long long cols_per_chunk, float* d_emb, int dw_nblk, long long dw_cols_per_blk,
               const float* dwl, float* dw, const Sgd& sgd, int fused, float* dgt,
               cudaStream_t st) {
  constexpr bool BF16 = !std::is_same<TW, float>::value;
  const bool with_dw = dw != nullptr || fused;
  const bool dw_tc = BF16 && with_dw && !fused && a.sel == nullptr;
  const long long n = (long long)a.B * a.D;
  int e = 0;
  if constexpr (!BF16) {
    e = launch_f32_pass<TM>(fused ? FB_SGD : with_dw ? FB_DW : FB_DEMB, a, br, dw_nblk,
                            dw_cols_per_blk, dwl, dw, sgd, dgt, part, st);
    if (e != 0) return e;
    margin_bwd_demb_merge_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(nchunk, n, part,
                                                                              d_emb);
    return (int)cudaGetLastError();
  } else {
    if (dw_tc) {
      const size_t smem = dw_bf16_smem(a.D);
      if ((e = allow_smem(margin_bwd_dw_bf16_kernel, smem)) != 0) return e;
      margin_bwd_dw_bf16_kernel<<<dw_nblk, BW_THREADS, smem, st>>>(
          a, br, dw_cols_per_blk, dwl, dw, const_cast<float*>(a.inv));
    } else if (with_dw) {  // the fused and sparse d_w pass reads a.inv
      e = launch_inv(a, st);
    }
    if (e != 0 || (e = (int)cudaGetLastError()) != 0) return e;
    const size_t smem = demb_bf16_smem(a.D);
    const int n_rg = (a.B + E_RB - 1) / E_RB;
    if ((e = allow_smem(margin_bwd_demb_bf16_kernel, smem)) != 0) return e;
    margin_bwd_demb_bf16_kernel<<<nchunk * n_rg, BW_THREADS, smem, st>>>(
        a, br, cols_per_chunk, n_rg, (int)with_dw, part);
    if ((e = (int)cudaGetLastError()) != 0) return e;
    margin_bwd_demb_merge_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(nchunk, n, part,
                                                                              d_emb);
    if ((e = (int)cudaGetLastError()) != 0 || !with_dw || dw_tc) return e;
    if ((e = allow_smem(margin_bwd_dw_kernel<TW, TM>, W_SMEM_BF16)) != 0) return e;
    margin_bwd_dw_kernel<TW, TM><<<dw_nblk, W_THREADS, W_SMEM_BF16, st>>>(a, br, dw_cols_per_blk,
                                                                        dwl, dw, sgd, fused, dgt);
    return (int)cudaGetLastError();
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

// the bf16 cosines in tiling 0 (the forward), 1 (the d_emb pass), 2 (the
// bf16 d_w pass) or 3 (the fused and sparse d_w pass)
int launch_clean_cos(const Args& a, int tiling, float* out, cudaStream_t st) {
  int e = 0;
  if (tiling == 0 || tiling == 3) {
    if ((e = launch_inv(a, st)) != 0) return e;
    const size_t smem = (tiling == 0 ? CH_ST * chunk_bytes<128, 128>() + 128 * 4
                                     : CH_ST * chunk_bytes<128, 64>() + 64 * 4);
    if (tiling == 0) {
      if ((e = allow_smem(clean_cos_chunk_kernel<128>, smem)) != 0) return e;
      clean_cos_chunk_kernel<128><<<(unsigned)((a.C + 127) / 128), 256, smem, st>>>(a, out);
    } else {
      if ((e = allow_smem(clean_cos_chunk_kernel<64>, smem)) != 0) return e;
      clean_cos_chunk_kernel<64><<<(unsigned)((a.C + 63) / 64), 256, smem, st>>>(a, out);
    }
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

// the f32 cosines in tiling 0 (the forward) or 1, 2, 3 (the backward's one
// pass, which every f32 backward form runs)
int launch_clean_cos_f32(const Args& a, int tiling, float* out, cudaStream_t st) {
  int e = 0;
  if (tiling == 0) {
    const size_t smem = sizeof(float) * (F_DK * F_ALD + F_DK * F_BLD + F_TC);
    clean_cos_f32_fwd_kernel<<<(unsigned)((a.C + F_TC - 1) / F_TC), F_THREADS, smem, st>>>(a, out);
  } else if (tiling >= 1 && tiling <= 3) {
    const size_t smem = sizeof(float) * (FB_TC * (a.D + 4) + FB_XSTG + FB_TC);
    if ((e = allow_smem(clean_cos_f32_bwd_kernel, smem)) != 0) return e;
    clean_cos_f32_bwd_kernel<<<(unsigned)((a.C + FB_TC - 1) / FB_TC), FB_THREADS, smem, st>>>(a,
                                                                                        out);
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
  margin_fwd_merge_kernel<<<(B + 127) / 128, 128, 0, st>>>(a, 2 * nblk, part, ce, neg, logz,
                                                           topk);
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
  margin_partial_merge_kernel<<<(B + 127) / 128, 128, 0, st>>>(a, 2 * nblk, part, m, s, topk);
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
// (0 the forward, 1 the d_emb pass, 2 the d_w pass of margin_ce_bwd, 3 the
// fused and sparse d_w pass; f32 W: 2 and 3 are one pass): a parity probe of
// the chain they share
int margin_ce_clean_cos_launch(MCE_COMMON_PARAMS, int tiling, float* out, void* stream) {
  const Args a = make_args(MCE_COMMON_ARGS);
  if (!w_bf16) return launch_clean_cos_f32(a, tiling, out, (cudaStream_t)stream);
  if (eb == nullptr || inv == nullptr) return (int)cudaErrorInvalidValue;
  return launch_clean_cos(a, tiling, out, (cudaStream_t)stream);
}

}  // extern "C"
