// Fused quad FFC head for NVIDIA Hopper (sm_90a): both FFC directions x
// both queue views in one pass over q0, forward and backward.
//
// Replaces the TPU kernels vlsfr_tpu/ops/twin_margin.py:pallas_quad_fwd
// (:1840) and :pallas_quad_bwd (:1891). Semantics are those of the scan
// reference _twin_stream_fwd / _twin_stream_bwd there; the plain PyTorch
// versions beside the wrappers (vlsfr_tpu_torch/ops/twin_margin.py
// quad_fwd_plain / quad_bwd_plain) compute the same function.
//
// Layout ("packed"): probe rows E [R = 2B, D], rows [0, B) direction A and
// [B, 2B) direction B; G (gallery writes), V (view-2 write values) [R, D];
// rows / cols / blend / labels [R] int32; gt [2][R] (view-major); q0 is
// plane 0 of the [2, Q, D] queue. All arithmetic is IEEE f32 FMA — no
// TF32, no tensor cores (a later optimisation).
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
//  * Target columns are excluded from the stream and the top-k; the
//    target term scale*phi(gt) joins at the merge (gt comes from outside).
//  * Shared with margin_ce.cu (margin_common.cuh): the margin transform,
//    the streamed (max, sumexp) and top-k, the partial merge, d_cos of a
//    column and the shared-memory tile product.

#include "margin_common.cuh"

namespace {

struct Args {
  const float* q0;
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
  int loss_type;
  float margin, scale, mask_svfc, cos_m, sin_m;
};

// dot product in index order, the same FMA chain as the GEMM tiles
__device__ __forceinline__ float row_dot(const float* x, const float* y, int n) {
  float acc = 0.f;
  for (int i = 0; i < n; ++i) acc = fmaf(x[i], y[i], acc);
  return acc;
}

// per-tile write plan: last0/lastb[d * TC + c] = highest writer index (in
// direction d) of column t0 + c, or -1. Returns via *written whether any
// column of the tile is written.
template <int TC>
__device__ __forceinline__ void mark_writes(const Args& a, long long t0, int* last0, int* lastb,
                                            int* written) {
  const int tid = threadIdx.x;
  for (int i = tid; i < 2 * TC; i += blockDim.x) {
    last0[i] = -1;
    lastb[i] = -1;
  }
  if (tid == 0) *written = 0;
  __syncthreads();
  for (int e = tid; e < a.R; e += blockDim.x) {
    const long long off = (long long)a.cols[e] - t0;
    if (off >= 0 && off < TC) {
      const int d = e / a.B, i = e - d * a.B;
      if (a.rows[e] == 0) atomicMax(&last0[d * TC + off], i);
      if (a.blend[e] > 0) atomicMax(&lastb[d * TC + off], i);
      *written = 1;  // every writer stores the same value
    }
  }
  __syncthreads();
}

// ---------------------------------------------------------------- forward

constexpr int F_ROWS = 256, F_TC = 64, F_DK = 16, F_THREADS = 256;
constexpr int F_ALD = F_ROWS + 4, F_BLD = F_TC + 4, F_CLD = F_TC + 1;
constexpr size_t F_SMEM =
    sizeof(float) * (F_DK * F_ALD + F_DK * F_BLD + F_ROWS * F_CLD) + sizeof(int) * (4 * F_TC + 1);

__global__ void __launch_bounds__(F_THREADS)
    quad_fwd_kernel(Args a, long long cols_per_blk, float* part) {
  extern __shared__ float smem[];
  float* As = smem;               // E chunk, k-major [F_DK][F_ALD]
  float* Bs = As + F_DK * F_ALD;  // q0 chunk, k-major [F_DK][F_BLD]
  float* Cs = Bs + F_DK * F_BLD;  // cosine tile [F_ROWS][F_CLD]
  int* last0 = reinterpret_cast<int*>(Cs + F_ROWS * F_CLD);
  int* lastb = last0 + 2 * F_TC;
  int* written = lastb + 2 * F_TC;

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

    float acc[8][8], n2;
    tile_gemm<F_ROWS, F_TC, F_DK, F_THREADS, F_ALD, F_BLD, 8, 8, 32, 8, false>(
        acc, n2, As, Bs, a.E, 0, a.R, a.q0, t0, c_end, a.D, ty, tx);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) Cs[(ty + 32 * i) * F_CLD + tx + 8 * j] = acc[i][j];
    __syncthreads();

    if (row_ok) {
      const bool any_w = *written != 0;
      const float* e_row = a.E + (long long)r * a.D;
      const int n = (int)min((long long)F_TC, c_end - t0);
      for (int c = 0; c < n; ++c) {
        if (t0 + c == (long long)label) continue;  // target: joins at the merge
        float c1 = Cs[r * F_CLD + c], c2 = c1;
        if (any_w) {
          const int i0 = last0[dir * F_TC + c], ib = lastb[dir * F_TC + c];
          if (i0 >= 0) c1 = row_dot(e_row, a.G + (long long)(dir * a.B + i0) * a.D, a.D);
          c2 = ib >= 0 ? row_dot(e_row, a.V + (long long)(dir * a.B + ib) * a.D, a.D) : c1;
        }
        stream_update(c1, gt0, a, m0, s0);
        topk_insert(tk0, kth0, c1, a.k);
        stream_update(c2, gt1, a, m1, s1);
        topk_insert(tk1, kth1, c2, a.k);
      }
    }
    __syncthreads();  // Cs / write plan are rebuilt by the next tile
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

// one thread per (view, row): merge the block partials in block order and
// finalize ce / neg / logz / top-k
__global__ void quad_fwd_merge_kernel(Args a, int nblk, const float* part, float* ce, float* neg,
                                      float* logz, float* topk) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;  // v * R + r
  if (idx >= 2 * a.R) return;
  const int v = idx / a.R, r = idx - v * a.R;
  float M = -INFINITY, S = 0.f;
  float tk[KMAX];
  for (int j = 0; j < KMAX; ++j) tk[j] = NEG_INF_F;
  for (int blk = 0; blk < nblk; ++blk)
    merge_partial(part + (((long long)blk * 2 + v) * a.R + r) * PART, a.k, M, S, tk);
  const float zt = a.scale * phi_target(a.gt[v * a.R + r], a);
  finalize_row(M, S, tk, a.k, a.labels[r] >= 0, zt, ce[idx], neg[idx], logz[idx]);
  for (int j = 0; j < a.k; ++j) topk[(long long)idx * a.k + j] = tk[j];
}

// --------------------------------------------------------------- backward

constexpr int B_RB = 32, B_TC = 64, B_DK = 16, B_THREADS = 256, B_JMAX = 8;  // D <= 64 * 8
constexpr int B_ALD = B_RB + 4, B_BLD = B_TC + 4, B_CLD = B_TC + 1;
constexpr size_t B_SMEM = sizeof(float) * (B_DK * B_ALD + B_DK * B_BLD + 3 * B_RB * B_CLD) +
                          sizeof(int) * (4 * B_TC + 1);

struct BwdRows {
  const float* logz;  // [2][R]
  const float* kth;   // [2][R]
  const float* dce;   // [2][R], 0 on outlier rows
  const float* dneg;  // [2][R], 0 on positive rows
};

__global__ void __launch_bounds__(B_THREADS)
    quad_bwd_kernel(Args a, BwdRows br, long long cols_per_chunk, int n_rg, float* part) {
  extern __shared__ float smem[];
  float* As = smem;                // E row-group chunk, k-major [B_DK][B_ALD]
  float* Bs = As + B_DK * B_ALD;   // q0 chunk, k-major [B_DK][B_BLD]
  float* Dq = Bs + B_DK * B_BLD;   // d_cos routed to q0 rows   [B_RB][B_CLD]
  float* Dg = Dq + B_RB * B_CLD;   // ... to the parity-0 write g
  float* Dv = Dg + B_RB * B_CLD;   // ... to the view-2 write v
  int* last0 = reinterpret_cast<int*>(Dv + B_RB * B_CLD);
  int* lastb = last0 + 2 * B_TC;
  int* written = lastb + 2 * B_TC;

  const int tid = threadIdx.x;
  const int rg = blockIdx.x % n_rg, chunk = blockIdx.x / n_rg;
  const int r_base = rg * B_RB;
  const long long c_begin = (long long)chunk * cols_per_chunk;
  const long long c_end = min(a.Q, c_begin + cols_per_chunk);
  const int nj = a.D / 64;

  // GEMM-1 / d_cos map: rows ty + 16i (i < 2), cols tx + 16j (j < 4)
  const int tx = tid & 15, ty = tid >> 4;
  int lab[2], dirr[2];
  bool ok[2], pos[2];
  float gtv[2][2], lzv[2][2], kthv[2][2], dcev[2][2], dnegv[2][2];
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
    }
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
    const bool any_w = *written != 0;

    float acc[2][4], n2;
    tile_gemm<B_RB, B_TC, B_DK, B_THREADS, B_ALD, B_BLD, 2, 4, 16, 16, false>(
        acc, n2, As, Bs, a.E, r_base, a.R, a.q0, t0, c_end, a.D, ty, tx);

    // d_cos, routed per view to the row that view scores against
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int lr = ty + 16 * i, gr = r_base + lr;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const long long gc = t0 + c;
        float dq = 0.f, dg = 0.f, dv = 0.f;
        if (ok[i] && gc < c_end && gc != (long long)lab[i]) {
          float c1 = acc[i][j], c2 = c1;
          int i0 = -1, ib = -1;
          if (any_w) {
            const float* e_row = a.E + (long long)gr * a.D;
            i0 = last0[dirr[i] * B_TC + c];
            ib = lastb[dirr[i] * B_TC + c];
            if (i0 >= 0) c1 = row_dot(e_row, a.G + (long long)(dirr[i] * a.B + i0) * a.D, a.D);
            c2 = ib >= 0 ? row_dot(e_row, a.V + (long long)(dirr[i] * a.B + ib) * a.D, a.D) : c1;
          }
          float d1 = dcos_col(c1, gtv[i][0], lzv[i][0], kthv[i][0], dcev[i][0], dnegv[i][0],
                              !pos[i], a);
          const float d2 = dcos_col(c2, gtv[i][1], lzv[i][1], kthv[i][1], dcev[i][1],
                                    dnegv[i][1], !pos[i], a);
          if (ib >= 0) dv = d2; else d1 += d2;  // view 2 reads view 1's row
          if (i0 >= 0) dg = d1; else dq = d1;
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
      const float* wrow = a.q0 + (t0 + c) * a.D + dx;
      float w[B_JMAX];
#pragma unroll
      for (int j = 0; j < B_JMAX; ++j) w[j] = j < nj ? __ldg(wrow + 64 * j) : 0.f;
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
            const float* g = a.G + (long long)(d * a.B + i0) * a.D + dx;
#pragma unroll
            for (int j = 0; j < B_JMAX; ++j)
              if (j < nj) acc2[i][j] = fmaf(coef, g[64 * j], acc2[i][j]);
          }
          if (ib >= 0) {
            const float coef = Dv[lr * B_CLD + c];
            const float* vv = a.V + (long long)(d * a.B + ib) * a.D + dx;
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

// d_emb = sum of the chunk partials in chunk order; d_gt analytic:
// (exp(scale*phi(gt_v) - logz_v) - 1) * d_ce_v * scale on positive rows
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

Args make_args(const float* q0, long long Q, int D, const float* E, const float* G,
               const float* V, const int* rows, const int* cols, const int* blend,
               const int* labels, const float* gt, int B, int R, int k, int loss_type,
               float margin, float scale, float mask_svfc, float cos_m, float sin_m) {
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
  a.R = R;
  a.k = k;
  a.loss_type = loss_type;
  a.margin = margin;
  a.scale = scale;
  a.mask_svfc = mask_svfc;
  a.cos_m = cos_m;
  a.sin_m = sin_m;
  return a;
}

}  // namespace

#define QUAD_COMMON_PARAMS                                                                     \
  const float *q0, long long Q, int D, const float *E, const float *G, const float *V,       \
      const int *rows, const int *cols, const int *blend, const int *labels, const float *gt, \
      int B, int R, int k, int loss_type, float margin, float scale, float mask_svfc,         \
      float cos_m, float sin_m
#define QUAD_COMMON_ARGS \
  q0, Q, D, E, G, V, rows, cols, blend, labels, gt, B, R, k, loss_type, margin, scale, mask_svfc, \
      cos_m, sin_m

extern "C" {

const char* quad_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// forward: nblk column ranges of cols_per_blk (a multiple of 64) columns;
// part is [nblk][2][R][2 + 16] f32 scratch; outputs [2][R] and [2][R][k]
int quad_fwd_launch(QUAD_COMMON_PARAMS, float* part, int nblk, long long cols_per_blk,
                    float* ce, float* neg, float* logz, float* topk, void* stream) {
  const Args a = make_args(QUAD_COMMON_ARGS);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaFuncSetAttribute(quad_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)F_SMEM);
  if (err != cudaSuccess) return (int)err;
  quad_fwd_kernel<<<nblk, F_THREADS, F_SMEM, st>>>(a, cols_per_blk, part);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  quad_fwd_merge_kernel<<<(2 * R + 127) / 128, 128, 0, st>>>(a, nblk, part, ce, neg, logz, topk);
  return (int)cudaGetLastError();
}

// backward: nchunk column ranges x ceil(R / 32) row groups; part is
// [nchunk][R][D] f32 scratch; outputs d_emb [R][D] and d_gt [2][R]
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
  quad_bwd_kernel<<<nchunk * n_rg, B_THREADS, B_SMEM, st>>>(a, br, cols_per_chunk, n_rg, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n = (long long)R * D;
  quad_bwd_merge_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(a, br, nchunk, part, d_emb,
                                                                     dgt);
  return (int)cudaGetLastError();
}

}  // extern "C"
