// Device helpers shared by the port's margin kernels (quad_margin.cu and
// margin_ce.cu): the margin transform, the streamed (max, sumexp) and
// value-only top-k, the merge of per-block partials, d loss / d cos of one
// column, and the shared-memory tile product (f32 accumulate over f32, bf16
// or int8 rows, each converted exactly to f32).
//
// Both kernels' top-k tie test (cos >= kth - KTH_TIE_TOL) compares cosines
// that the forward and the backward compute separately; they must be the
// same bits, so both passes take them from `tile_gemm`, whose FMA chain runs
// over the feature axis in index order. quad_margin.cu's `row_dot` keeps
// that order for the columns this step writes.
//
// `A` is each kernel's argument struct: it has loss_type, k, margin, scale,
// mask_svfc, cos_m and sin_m.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

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

// one non-target column into a row's running (max, sumexp) of z = scale * mod
template <class A>
__device__ __forceinline__ void stream_update(float c, float gt, const A& a, float& m, float& s) {
  float mod = c;
  if (a.loss_type == LOSS_SV && c > gt - a.margin) mod = a.mask_svfc * c + a.mask_svfc - 1.0f;
  const float z = a.scale * mod;
  if (z > m) {
    s = s * expf(m - z) + 1.0f;
    m = z;
  } else {
    s += expf(z - m);
  }
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

// a stored element as f32 (exact for bf16 and int8)
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(signed char x) { return (float)x; }

// acc[i][j] = sum over the feature axis, in index order, of
// X[x0 + ay + SA*i] . Y[y0 + bx + SB*j] for row-major [*, D] matrices X (f32)
// and Y (f32, bf16 or int8), staged DK features at a time into shared memory
// k-major as f32 (As [DK][ALD], Bs [DK][BLD]); rows at or past x_end / y_end
// read as 0. With NORM, thread t < NY also sums ||Y[y0 + t]||^2 from the same
// chunks into n2.
template <int NX, int NY, int DK, int THREADS, int ALD, int BLD, int TI, int TJ, int SA, int SB,
          bool NORM, class TY = float>
__device__ __forceinline__ void tile_gemm(float (&acc)[TI][TJ], float& n2, float* As, float* Bs,
                                          const float* X, long long x0, long long x_end,
                                          const TY* Y, long long y0, long long y_end, int D,
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
      Bs[kk * BLD + row] = g < y_end ? to_f32(Y[g * D + k0 + kk]) : 0.f;
    }
    __syncthreads();
    if (NORM && tid < NY) {
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

}  // namespace
