// Streaming margin-softmax cross-entropy over a [C, D] classifier for NVIDIA
// Hopper (sm_90a): forward, backward, and backward with the classifier's
// SGD-momentum update fused in.
//
// Replaces the TPU kernels in vlsfr_tpu/ops/margin_pallas.py:
//   pallas_margin_ce_fwd (:390)           -> margin_ce_fwd_launch
//   pallas_margin_ce_bwd (:557)           -> margin_ce_bwd_launch
//   pallas_margin_ce_bwd_fused_sgd (:803) -> margin_ce_bwd_fused_sgd_launch
// Semantics are those of the scan references _stream_fwd / _stream_bwd and
// apply_sgd_dense there; the plain PyTorch versions beside the wrappers
// (vlsfr_tpu_torch/ops/margin_stream.py *_plain) compute the same functions.
//
// Layout: emb [B][D] f32 (B <= 128, D a multiple of 64 up to 512), W and
// mom [C][D] f32, labels [B] int32 (-1 = outlier row), gt / logz / kth /
// d_ce / d_neg [B] f32 (d_ce 0 on outlier rows, d_neg 0 on positive rows).
// Column offsets are 64-bit (C * D passes 2^31 at 5M classes). All
// arithmetic is IEEE f32 FMA: no TF32, no tensor cores (later work).
//
// Bound (H100 SXM, 67 TFLOP/s f32, 3.35 TB/s) at B = 128, D = 512,
// C = 2^20: forward 2*B*D*C = 1.37e11 FLOP >= 2.05 ms against 2.15 GB of W
// (0.64 ms); backward three such products, 4.12e11 FLOP >= 6.15 ms, against
// 4.3 GB (W read, d_w written) or, fused, 8.6 GB (W and mom read and
// written, 2.56 ms). All three are compute-bound.
//
// Design.
//  * The TPU walked the class tiles in order and carried (max, sumexp,
//    top-k) and the [B, D] d_emb in VMEM. Here blocks own disjoint column
//    ranges and write partials; a second launch merges them in a fixed
//    order (logsumexp merge, k-way top-k merge, sum of d_emb partials). No
//    float atomics anywhere: every output is bit-stable run to run.
//  * Shared with quad_margin.cu (margin_common.cuh): the margin transform,
//    the streamed (max, sumexp) and top-k, the partial merge, d_cos of a
//    column and the shared-memory tile product.
//  * Forward: one block holds all B rows, so each W tile is read once. A
//    256-thread register-tiled f32 GEMM (8x8 outputs per thread) fills a
//    [128, 128] raw-dot tile, scaled by each column's 1/||w_j|| (summed from
//    the same shared-memory chunks); then two threads per row stream the
//    tile's columns into per-row (max, sumexp) and a register top-k. The
//    target column is left out of both and joins at the merge as
//    scale * phi(gt) (gt comes from outside, as in JAX).
//  * Backward, d_emb pass: a block owns 32 rows x a column range, so its
//    d_emb partial [32, D] lives in registers (64 per thread at D = 512).
//    Per 64-column tile: cos [32, 64] -> d_cos -> d_cos @ w_hat.
//  * Backward, d_w pass: a block owns whole 64-column tiles with every
//    batch row: it recomputes cos [B, 64] and d_cos, then d_w_hat[t] =
//    sum_b d_cos[b, t] emb[b] in 64-feature chunks, and the normalisation
//    backprop d_w = inv * (d_w_hat - w_hat <d_w_hat, w_hat>), where
//    <d_w_hat, w_hat> = sum_b d_cos[b, t] cos[b, t] is summed from the tile.
//    Each d_w row has one owner block, so no reduction is needed. The
//    owner adds the label rows' d_wl (every batch row whose label is the
//    column, in batch order: a sum, no scatter). Fused: then g = d_w + wd*w,
//    mom' = mu*mom + g,
//    upd = g + mu*mom' (Nesterov) | mom' | g (mu = 0), w' = w - lr*upd,
//    written in place over the rows it has just read. The d_emb pass runs
//    first in stream order and reads W before any of it is written. Every
//    row decays every step: no relevance gate skips a tile.

#include "margin_common.cuh"

namespace {

struct Args {
  const float* emb;
  const float* w;
  long long C;
  int D, B;
  const int* labels;
  const float* gt;
  int k, loss_type;
  float margin, scale, mask_svfc, cos_m, sin_m;
};

struct BwdRows {
  const float* logz;
  const float* kth;
  const float* dce;   // 0 on outlier rows
  const float* dneg;  // 0 on positive rows
};

struct Sgd {
  float* w;    // == Args::w, updated in place
  float* mom;  // updated in place
  float lr, mu, wd;
  int nesterov;
};

// 1 / ||w_j|| as the JAX package normalises rows: rsqrt(max(||w||^2, 1e-24))
__device__ __forceinline__ float inv_norm(float n2) { return rsqrtf(fmaxf(n2, 1e-24f)); }

// d loss / d cos of one non-padding column; 0 at the target column, whose
// gradient joins outside through d_gt
__device__ __forceinline__ float dcos_of(float c, long long col, int label, float gt, float logz,
                                         float kth, float dce, float dneg, const Args& a) {
  return col == (long long)label ? 0.f : dcos_col(c, gt, logz, kth, dce, dneg, label < 0, a);
}

// ---------------------------------------------------------------- forward

constexpr int F_ROWS = 128, F_TC = 128, F_DK = 16, F_THREADS = 256;
constexpr int F_ALD = F_ROWS + 4, F_BLD = F_TC + 4, F_CLD = F_TC + 1;
constexpr size_t F_SMEM = sizeof(float) * (F_DK * F_ALD + F_DK * F_BLD + F_ROWS * F_CLD + F_TC);

__global__ void __launch_bounds__(F_THREADS)
    margin_fwd_kernel(Args a, long long cols_per_blk, float* part) {
  extern __shared__ float smem[];
  float* As = smem;                   // emb chunk, k-major [F_DK][F_ALD]
  float* Bs = As + F_DK * F_ALD;      // W chunk, k-major [F_DK][F_BLD]
  float* Cs = Bs + F_DK * F_BLD;      // cosine tile [F_ROWS][F_CLD]
  float* inv = Cs + F_ROWS * F_CLD;   // 1 / ||w_j|| of the tile's columns

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;  // GEMM outputs: rows ty + 16i, cols tx + 16j
  const long long c_begin = (long long)blockIdx.x * cols_per_blk;
  const long long c_end = min(a.C, c_begin + cols_per_blk);

  const int r = tid % F_ROWS, half = tid / F_ROWS;  // epilogue: one row, half the columns
  const bool row_ok = r < a.B;
  const int label = row_ok ? a.labels[r] : -1;
  const float gt = row_ok ? a.gt[r] : 0.f;
  float m = -INFINITY, s = 0.f, kth = NEG_INF_F;
  float tk[KMAX];
#pragma unroll
  for (int j = 0; j < KMAX; ++j) tk[j] = NEG_INF_F;

  for (long long t0 = c_begin; t0 < c_end; t0 += F_TC) {
    float acc[8][8], n2;
    tile_gemm<F_ROWS, F_TC, F_DK, F_THREADS, F_ALD, F_BLD, 8, 8, 16, 16, true>(
        acc, n2, As, Bs, a.emb, 0, a.B, a.w, t0, c_end, a.D, ty, tx);
    if (tid < F_TC) inv[tid] = inv_norm(n2);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        Cs[(ty + 16 * i) * F_CLD + tx + 16 * j] = acc[i][j] * inv[tx + 16 * j];
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

// ------------------------------------------------------ backward: d_emb pass

constexpr int B_RB = 32, B_TC = 64, B_DK = 16, B_THREADS = 256, B_JMAX = 8;  // D <= 64 * 8
constexpr int B_ALD = B_RB + 4, B_BLD = B_TC + 4, B_CLD = B_TC + 1;
constexpr size_t B_SMEM = sizeof(float) * (B_DK * B_ALD + B_DK * B_BLD + B_RB * B_CLD + B_TC);

__global__ void __launch_bounds__(B_THREADS)
    margin_bwd_demb_kernel(Args a, BwdRows br, long long cols_per_chunk, int n_rg, float* part) {
  extern __shared__ float smem[];
  float* As = smem;                // emb row-group chunk, k-major [B_DK][B_ALD]
  float* Bs = As + B_DK * B_ALD;   // W chunk, k-major [B_DK][B_BLD]
  float* Dq = Bs + B_DK * B_BLD;   // d_cos * inv [B_RB][B_CLD]
  float* inv = Dq + B_RB * B_CLD;  // [B_TC]

  const int tid = threadIdx.x;
  const int rg = blockIdx.x % n_rg, chunk = blockIdx.x / n_rg;
  const int r_base = rg * B_RB;
  const long long c_begin = (long long)chunk * cols_per_chunk;
  const long long c_end = min(a.C, c_begin + cols_per_chunk);
  const int nj = a.D / 64;

  // cos / d_cos map: rows ty + 16i (i < 2), cols tx + 16j (j < 4)
  const int tx = tid & 15, ty = tid >> 4;
  int lab[2];
  bool ok[2];
  float gtv[2], lzv[2], kthv[2], dcev[2], dnegv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int gr = r_base + ty + 16 * i;
    ok[i] = gr < a.B;
    const int rr = ok[i] ? gr : 0;
    lab[i] = a.labels[rr];
    gtv[i] = a.gt[rr];
    lzv[i] = br.logz[rr];
    kthv[i] = br.kth[rr];
    dcev[i] = br.dce[rr];
    dnegv[i] = br.dneg[rr];
  }
  // d_emb map: rows ry*8 + i (i < 8), features dx + 64j (j < nj)
  const int ry = tid >> 6, dx = tid & 63;
  float acc2[8][B_JMAX];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < B_JMAX; ++j) acc2[i][j] = 0.f;

  for (long long t0 = c_begin; t0 < c_end; t0 += B_TC) {
    float acc[2][4], n2;
    tile_gemm<B_RB, B_TC, B_DK, B_THREADS, B_ALD, B_BLD, 2, 4, 16, 16, true>(
        acc, n2, As, Bs, a.emb, r_base, a.B, a.w, t0, c_end, a.D, ty, tx);
    if (tid < B_TC) inv[tid] = inv_norm(n2);
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const long long gc = t0 + c;
        float d = 0.f;
        if (ok[i] && gc < c_end)
          d = dcos_of(acc[i][j] * inv[c], gc, lab[i], gtv[i], lzv[i], kthv[i], dcev[i],
                      dnegv[i], a) * inv[c];  // folds w_hat = inv * w into the product
        Dq[(ty + 16 * i) * B_CLD + c] = d;
      }
    }
    __syncthreads();

    // d_emb += (d_cos * inv) @ (raw W rows of this tile)
    const int n = (int)min((long long)B_TC, c_end - t0);
    for (int c = 0; c < n; ++c) {
      const float* wrow = a.w + (t0 + c) * a.D + dx;
      float wv[B_JMAX];
#pragma unroll
      for (int j = 0; j < B_JMAX; ++j) wv[j] = j < nj ? __ldg(wrow + 64 * j) : 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float d = Dq[(ry * 8 + i) * B_CLD + c];
#pragma unroll
        for (int j = 0; j < B_JMAX; ++j) acc2[i][j] = fmaf(d, wv[j], acc2[i][j]);
      }
    }
    __syncthreads();  // Dq and inv are rebuilt by the next tile
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gr = r_base + ry * 8 + i;
    if (gr >= a.B) continue;
    float* p = part + ((long long)chunk * a.B + gr) * a.D + dx;
#pragma unroll
    for (int j = 0; j < B_JMAX; ++j)
      if (j < nj) p[64 * j] = acc2[i][j];
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

// Each column's owner adds d_wl [B][D] (the label rows' gradient) for every
// batch row labelled with it. fused == 0: write d_w to dw. Otherwise apply
// the SGD update to sgd.w and sgd.mom in place (dw unused).
__global__ void __launch_bounds__(W_THREADS)
    margin_bwd_dw_kernel(Args a, BwdRows br, long long cols_per_blk, const float* dwl, float* dw,
                         Sgd sgd, int fused) {
  extern __shared__ float smem[];
  float* As = smem;                      // emb chunk, k-major [W_DK][W_ALD]
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
  const long long c_end = min(a.C, c_begin + cols_per_blk);
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
    const int n = (int)min((long long)W_TC, c_end - t0);
    if (tid == 0) *any_tgt = 0;
    __syncthreads();
    if (tid < W_ROWS) {
      const long long off = (long long)r_lab[tid] - t0;
      const bool in = r_lab[tid] >= 0 && off >= 0 && off < n;
      tgt[tid] = in ? (int)off : -1;
      if (in) *any_tgt = 1;  // every writer stores the same value
    }

    float acc[8][4], n2;
    tile_gemm<W_ROWS, W_TC, W_DK, W_THREADS, W_ALD, W_BLD, 8, 4, 16, 16, true>(
        acc, n2, As, Bs, a.emb, 0, a.B, a.w, t0, c_end, a.D, ty, tx);
    if (tid < W_TC) inv[tid] = inv_norm(n2);
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
          const float cv = acc[i][j] * inv[c];
          d = dcos_of(cv, t0 + c, r_lab[b], r_gt[b], r_lz[b], r_kth[b], r_dce[b], r_dneg[b], a);
          sp[j] = fmaf(d, cv, sp[j]);
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
        if (t >= n) continue;
        const float iv = inv[t], sd = sdot[t];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int d = dc0 + tx + 16 * j;
          const long long off = (t0 + t) * a.D + d;
          const float wv = a.w[off];  // plain load: the fused pass overwrites this row
          float g = iv * (acc3[i][j] - wv * iv * sd);
          if (tile_tgt) {
            for (int b = 0; b < a.B; ++b)
              if (tgt[b] == t) g += dwl[(long long)b * a.D + d];
          }
          if (!fused) {
            dw[off] = g;
            continue;
          }
          if (sgd.wd != 0.f) g = g + sgd.wd * wv;
          float mn = g, upd = g;
          if (sgd.mu != 0.f) {
            mn = sgd.mu * sgd.mom[off] + g;
            upd = sgd.nesterov ? g + sgd.mu * mn : mn;
          }
          sgd.mom[off] = mn;
          sgd.w[off] = wv - sgd.lr * upd;
        }
      }
    }
    __syncthreads();  // Dc, sdot, tgt are rebuilt by the next tile
  }
}

Args make_args(const float* emb, const float* w, long long C, int D, int B, const int* labels,
               const float* gt, int k, int loss_type, float margin, float scale, float mask_svfc,
               float cos_m, float sin_m) {
  Args a;
  a.emb = emb;
  a.w = w;
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
  return a;
}

// both backward passes: d_emb (row groups + merge), then d_w (column owners)
int launch_bwd(const Args& a, const BwdRows& br, float* part, int nchunk,
               long long cols_per_chunk, float* d_emb, int dw_nblk, long long dw_cols_per_blk,
               const float* dwl, float* dw, const Sgd& sgd, int fused, cudaStream_t st) {
  const int n_rg = (a.B + B_RB - 1) / B_RB;
  margin_bwd_demb_kernel<<<nchunk * n_rg, B_THREADS, B_SMEM, st>>>(a, br, cols_per_chunk, n_rg,
                                                                    part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n = (long long)a.B * a.D;
  margin_bwd_demb_merge_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(nchunk, n, part,
                                                                            d_emb);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (dw == nullptr && !fused) return 0;  // grad_w=False
  err = cudaFuncSetAttribute(margin_bwd_dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)W_SMEM);
  if (err != cudaSuccess) return (int)err;
  margin_bwd_dw_kernel<<<dw_nblk, W_THREADS, W_SMEM, st>>>(a, br, dw_cols_per_blk, dwl, dw,
                                                           sgd, fused);
  return (int)cudaGetLastError();
}

}  // namespace

#define MCE_COMMON_PARAMS                                                                       \
  const float *emb, const float *w, long long C, int D, int B, const int *labels,              \
      const float *gt, int k, int loss_type, float margin, float scale, float mask_svfc,        \
      float cos_m, float sin_m
#define MCE_COMMON_ARGS \
  emb, w, C, D, B, labels, gt, k, loss_type, margin, scale, mask_svfc, cos_m, sin_m
#define MCE_BWD_PARAMS                                                                          \
  const float *logz, const float *kth, const float *dce, const float *dneg, float *part,        \
      int nchunk, long long cols_per_chunk, float *d_emb, int dw_nblk, long long dw_cols_per_blk

extern "C" {

const char* margin_ce_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// forward: nblk column ranges of cols_per_blk (a multiple of 128) columns;
// part is [2 * nblk][B][2 + 16] f32 scratch; outputs [B] and [B][k]
int margin_ce_fwd_launch(MCE_COMMON_PARAMS, float* part, int nblk, long long cols_per_blk,
                         float* ce, float* neg, float* logz, float* topk, void* stream) {
  const Args a = make_args(MCE_COMMON_ARGS);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaFuncSetAttribute(margin_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)F_SMEM);
  if (err != cudaSuccess) return (int)err;
  margin_fwd_kernel<<<nblk, F_THREADS, F_SMEM, st>>>(a, cols_per_blk, part);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  margin_fwd_merge_kernel<<<(B + 127) / 128, 128, 0, st>>>(a, 2 * nblk, part, ce, neg, logz,
                                                           topk);
  return (int)cudaGetLastError();
}

// backward: part is [nchunk][B][D] f32 scratch (chunks of cols_per_chunk,
// a multiple of 64); d_w [C][D] f32 with the label rows' d_wl [B][D] added,
// or both nullptr for grad_w=False
int margin_ce_bwd_launch(MCE_COMMON_PARAMS, MCE_BWD_PARAMS, float* dw, const float* dwl,
                         void* stream) {
  const Args a = make_args(MCE_COMMON_ARGS);
  const BwdRows br = {logz, kth, dce, dneg};
  const Sgd none = {nullptr, nullptr, 0.f, 0.f, 0.f, 0};
  return launch_bwd(a, br, part, nchunk, cols_per_chunk, d_emb, dw_nblk, dw_cols_per_blk, dwl,
                    dw, none, 0, (cudaStream_t)stream);
}

// fused backward: w_upd (== w) and mom are updated in place; d_wl [B][D]
int margin_ce_bwd_fused_sgd_launch(MCE_COMMON_PARAMS, MCE_BWD_PARAMS, float* w_upd, float* mom,
                                   const float* dwl, float lr, float momentum, int nesterov,
                                   float weight_decay, void* stream) {
  const Args a = make_args(MCE_COMMON_ARGS);
  const BwdRows br = {logz, kth, dce, dneg};
  const Sgd sgd = {w_upd, mom, lr, momentum, weight_decay, nesterov};
  return launch_bwd(a, br, part, nchunk, cols_per_chunk, d_emb, dw_nblk, dw_cols_per_blk, dwl,
                    nullptr, sgd, 1, (cudaStream_t)stream);
}

}  // extern "C"
