// Device helpers shared by the port's margin kernels (quad_margin.cu and
// margin_ce.cu): the margin transform, the streamed (max, sumexp) and
// value-only top-k, the merge of per-block partials, d loss / d cos of one
// column, and the shared-memory tile products of f32 rows (tile_gemm:
// margin_ce.cu's f32 forward; ftile_dots: its register-blocked form, staged
// by cp.async).
//
// Both kernels' top-k tie test (cos >= kth - KTH_TIE_TOL) compares cosines
// that the forward and the backward compute separately; they must be the
// same bits, so both passes take them from one chain: the FMA chain over
// the feature axis in index order from 0 (`tile_gemm`'s; the f32 backwards
// of both walk it in `ftile_dots`, quad_margin.cu's f32 forward in its
// register micro-tile, and its `row_dot` for the columns a step writes),
// or the tensor cores' (mma_bf16.cuh: the bf16 and int8 forms' k16 chain,
// mma_nt; int8c's exact s8 sum, mma_nt_s8).
//
// `A` is each kernel's argument struct: it has loss_type, k, margin, scale,
// mask_svfc, cos_m and sin_m.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "mma_bf16.cuh"  // cp.async

namespace {

constexpr int KMAX = 16;
constexpr float NEG_INF_F = -1e30f;  // top-k fill value (vlsfr NEG_INF)
constexpr float KTH_TIE_TOL = 1e-6f;
constexpr int LOSS_AM = 0, LOSS_ARC = 1, LOSS_SV = 2;
constexpr int PART = 2 + KMAX;  // a forward partial per row: (m, s, top-k)

template <class A>
__device__ __forceinline__ float phi_target(float gt, const A& a) {
  if (a.loss_type == LOSS_AM) return gt - a.margin;
  if (a.loss_type == LOSS_ARC) {
    const float gc = fminf(fmaxf(gt, -0.999999f), 0.999999f);
    const float sn = sqrtf(1.0f - gc * gc);
    return gc * a.cos_m - sn * a.sin_m;
  }
  return gt > a.margin ? gt - a.margin : gt;
}

// one logit z into a row's running (max, sumexp)
__device__ __forceinline__ void stream_z(float z, float& m, float& s) {
  if (z > m) {
    s = s * expf(m - z) + 1.0f;
    m = z;
  } else {
    s += expf(z - m);
  }
}

// one non-target column into a row's running (max, sumexp) of z = scale * mod
template <class A>
__device__ __forceinline__ void stream_update(float c, float gt, const A& a, float& m, float& s) {
  float mod = c;
  if (a.loss_type == LOSS_SV && c > gt - a.margin) mod = a.mask_svfc * c + a.mask_svfc - 1.0f;
  stream_z(a.scale * mod, m, s);
}

// values-only top-k, descending; `kth` mirrors tk[k - 1] so the common
// rejection is one compare and tk stays in registers (constant indices)
__device__ __forceinline__ void topk_insert(float (&tk)[KMAX], float& kth, float x, int k) {
  if (!(x > kth)) return;
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    if (j < k && x > tk[j]) {
      const float t = tk[j];
      tk[j] = x;
      x = t;
    }
  }
#pragma unroll
  for (int j = 0; j < KMAX; ++j)
    if (j == k - 1) kth = tk[j];
}

// fold a logsumexp state (pm, ps), ps > 0 or nothing, into (M, S)
__device__ __forceinline__ void lse_fold(float pm, float ps, float& M, float& S) {
  if (ps > 0.f) {
    if (pm > M) {
      S = S * expf(M - pm) + ps;
      M = pm;
    } else {
      S += ps * expf(pm - M);
    }
  }
}

// fold one block's partial p = (m, s, top-k descending) into (M, S, tk)
__device__ __forceinline__ void merge_partial(const float* p, int k, float& M, float& S,
                                              float (&tk)[KMAX]) {
  lse_fold(p[0], p[1], M, S);
  for (int j = 0; j < k; ++j) {
    float x = p[2 + j];
    if (!(x > tk[k - 1])) break;  // partial lists are sorted descending
    for (int i = 0; i < k; ++i) {
      if (x > tk[i]) {
        const float t = tk[i];
        tk[i] = x;
        x = t;
      }
    }
  }
}

// ce / neg / logz of one row from its merged (M, S, top-k); the target
// term zt = scale * phi(gt) joins the logsumexp on positive rows
__device__ __forceinline__ void finalize_row(float M, float S, const float (&tk)[KMAX], int k,
                                             bool pos, float zt, float& ce, float& neg,
                                             float& logz) {
  const float lse = S > 0.f ? M + logf(S) : -INFINITY;
  float lz = lse;
  if (pos) {
    const float mf = fmaxf(lse, zt);
    lz = mf + logf(expf(lse - mf) + expf(zt - mf));
  }
  float hinge = 0.f;
  for (int j = 0; j < k; ++j) hinge += fmaxf(tk[j], 0.f);
  ce = pos ? lz - zt : 0.f;
  neg = pos ? 0.f : hinge / (float)k;
  logz = lz;
}

// d loss / d cos of one non-target column: the softmax term (with the SV
// column factor) and, on outlier rows, the hard-negative term of a by-value
// top-k member. d_ce is 0 on outlier rows, d_neg 0 on positive rows.
template <class A>
__device__ __forceinline__ float dcos_col(float c, float gt, float logz, float kth, float dce,
                                          float dneg, bool outlier, const A& a) {
  float d = 0.f;
  if (dce != 0.f) {
    float mod = c, fac = 1.f;
    if (a.loss_type == LOSS_SV && c > gt - a.margin) {
      mod = a.mask_svfc * c + a.mask_svfc - 1.0f;
      fac = a.mask_svfc;
    }
    d = expf(a.scale * mod - logz) * dce * a.scale * fac;
  }
  if (outlier && c >= kth - KTH_TIE_TOL && c > 0.f) d += dneg / (float)a.k;
  return d;
}

// acc[i][j] = sum over the feature axis, in index order, of
// X[x0 + ay + SA*i] . Y[y0 + bx + SB*j] for row-major [*, D] f32 matrices X
// and Y, staged DK features at a time into shared memory k-major (As
// [DK][ALD], Bs [DK][BLD]); rows at or past x_end / y_end read as 0.
// Thread t < NY also sums ||Y[y0 + t]||^2 of the staged operands from the
// same chunks into n2.
template <int NX, int NY, int DK, int THREADS, int ALD, int BLD, int TI, int TJ, int SA, int SB>
__device__ __forceinline__ void tile_gemm(float (&acc)[TI][TJ], float& n2, float* As, float* Bs,
                                          const float* X, long long x0, long long x_end,
                                          const float* Y, long long y0, long long y_end, int D,
                                          int ay, int bx) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < TI; ++i)
#pragma unroll
    for (int j = 0; j < TJ; ++j) acc[i][j] = 0.f;
  n2 = 0.f;
  for (int k0 = 0; k0 < D; k0 += DK) {
#pragma unroll
    for (int l = 0; l < NX * DK / THREADS; ++l) {
      const int idx = l * THREADS + tid, row = idx / DK, kk = idx % DK;
      const long long g = x0 + row;
      As[kk * ALD + row] = g < x_end ? X[g * D + k0 + kk] : 0.f;
    }
#pragma unroll
    for (int l = 0; l < NY * DK / THREADS; ++l) {
      const int idx = l * THREADS + tid, row = idx / DK, kk = idx % DK;
      const long long g = y0 + row;
      Bs[kk * BLD + row] = g < y_end ? Y[g * D + k0 + kk] : 0.f;
    }
    __syncthreads();
    if (tid < NY) {
#pragma unroll
      for (int kk = 0; kk < DK; ++kk) n2 = fmaf(Bs[kk * BLD + tid], Bs[kk * BLD + tid], n2);
    }
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) {
      float av[TI], bv[TJ];
#pragma unroll
      for (int i = 0; i < TI; ++i) av[i] = As[kk * ALD + ay + SA * i];
#pragma unroll
      for (int j = 0; j < TJ; ++j) bv[j] = Bs[kk * BLD + bx + SB * j];
#pragma unroll
      for (int i = 0; i < TI; ++i)
#pragma unroll
        for (int j = 0; j < TJ; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// ------------------------------------ the f32 tile product on the CUDA cores
//
// `ftile_dots`: the register-blocked form of tile_gemm's product (margin_ce.cu's
// f32 backward). X and Y are row-major [*, D] f32 in global memory, staged FK
// features a chunk into shared memory by 16-byte cp.async, rows past the
// valid ones zero-filled: X through NST stages of [NX][FK + 4] (NST - 1
// chunks in flight beside the one in use), Y into a tile [NY][D + 4] that
// holds all of Y's rows afterwards. The pads of four floats put rows r .. r +
// 7 of a feature in eight different groups of four banks, so the eight
// threads of a quarter warp, reading one X row (a broadcast) and eight
// consecutive Y rows, are served in one pass. Each thread holds a TI x TJ
// micro-tile, X rows ax + SA*i and Y rows by + SB*j; per four features it
// reads a float4 of each of its rows and adds the products feature by
// feature. Every output is one fmaf chain over the features 0 .. D - 1 in
// index order from 0 (and ||y||^2 the same chain of y * y): tile_gemm's,
// whatever the tiling. margin_ce.cu's f32 pass takes the row norms
// (NORM), quad_margin.cu's f32 backward does not.

// features [k0, k0 + kw) (kw a multiple of 4) of the rows row0 .. row0 + n - 1
// of src [*, D] into dst rows 0 .. rows - 1 (row stride ld floats) by 16-byte
// cp.async; rows from n on are zero-filled
template <int THREADS>
__device__ __forceinline__ void stage_f32(float* dst, int ld, const float* src, long long row0,
                                          int n, int rows, int D, int k0, int kw) {
  const int q4 = kw / 4, dr = THREADS / q4, dq = THREADS - dr * q4;
  for (int r = threadIdx.x / q4, q = threadIdx.x % q4; r < rows;) {  // piece r * q4 + q
    const bool ok = r < n;
    cp_async_cg(dst + r * ld + 4 * q, ok ? src + (row0 + r) * D + k0 + 4 * q : src, ok);
    r += dr;
    q += dq;
    if (q >= q4) q -= q4, ++r;
  }
}

// the floats of ftile_dots' X stages
template <int NX, int NST, int FK>
__host__ __device__ constexpr int ftile_stage_floats() {
  return NST * NX * (FK + 4);
}

// acc[i][j] = sum over k = 0 .. D - 1 in order of X[x0 + ax + SA*i][k] *
// Y[y0 + by + SB*j][k], the X rows from nx on and the Y rows from ny on
// reading as 0; with NORM, thread t < NY also sums n2 = ||Y[y0 + t]||^2. X
// streams through the stages at stg (ftile_stage_floats), Y's chunk kc goes
// to yt + FK kc. Leaves no copy in flight and ends with a barrier.
template <int NX, int NY, int THREADS, int NST, int FK, int TI, int TJ, int SA, int SB,
          bool NORM = true>
__device__ __forceinline__ void ftile_dots(float (&acc)[TI][TJ], float& n2, float* stg, float* yt,
                                           const float* X, long long x0, int nx, const float* Y,
                                           long long y0, int ny, int D, int ax, int by) {
  constexpr int LD = FK + 4;
  const int ldy = D + 4, nk = D / FK;
#pragma unroll
  for (int i = 0; i < TI; ++i)
#pragma unroll
    for (int j = 0; j < TJ; ++j) acc[i][j] = 0.f;
  n2 = 0.f;
  auto load = [&](int kc) {
    if (kc < nk) {
      stage_f32<THREADS>(stg + (kc % NST) * NX * LD, LD, X, x0, nx, NX, D, FK * kc, FK);
      stage_f32<THREADS>(yt + FK * kc, ldy, Y, y0, ny, NY, D, FK * kc, FK);
    }
    cp_async_commit();
  };
  for (int s = 0; s < NST - 1; ++s) load(s);
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<NST - 2>();
    __syncthreads();  // chunk kc has landed; chunk kc - 1's stage is free
    load(kc + NST - 1);
    const float* Xs = stg + (kc % NST) * NX * LD;
    const float* Ys = yt + FK * kc;
    if (NORM && threadIdx.x < NY) {
#pragma unroll
      for (int k = 0; k < FK; k += 4) {
        const float4 y = *reinterpret_cast<const float4*>(Ys + threadIdx.x * ldy + k);
        n2 = fmaf(y.x, y.x, n2);
        n2 = fmaf(y.y, y.y, n2);
        n2 = fmaf(y.z, y.z, n2);
        n2 = fmaf(y.w, y.w, n2);
      }
    }
#pragma unroll
    for (int k = 0; k < FK; k += 4) {
      float4 x[TI], y[TJ];
#pragma unroll
      for (int i = 0; i < TI; ++i)
        x[i] = *reinterpret_cast<const float4*>(Xs + (ax + SA * i) * LD + k);
#pragma unroll
      for (int j = 0; j < TJ; ++j)
        y[j] = *reinterpret_cast<const float4*>(Ys + (by + SB * j) * ldy + k);
#pragma unroll
      for (int i = 0; i < TI; ++i)
#pragma unroll
        for (int j = 0; j < TJ; ++j) acc[i][j] = fmaf(x[i].x, y[j].x, acc[i][j]);
#pragma unroll
      for (int i = 0; i < TI; ++i)
#pragma unroll
        for (int j = 0; j < TJ; ++j) acc[i][j] = fmaf(x[i].y, y[j].y, acc[i][j]);
#pragma unroll
      for (int i = 0; i < TI; ++i)
#pragma unroll
        for (int j = 0; j < TJ; ++j) acc[i][j] = fmaf(x[i].z, y[j].z, acc[i][j]);
#pragma unroll
      for (int i = 0; i < TI; ++i)
#pragma unroll
        for (int j = 0; j < TJ; ++j) acc[i][j] = fmaf(x[i].w, y[j].w, acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every stage is free
}

}  // namespace
