// Device helpers shared by the port's margin kernels (quad_margin.cu and
// margin_ce.cu): the margin transform, the forward's row pass pieces (the
// base-2 (max, sumexp) chains and the select-network top-k of a lane), the
// merge of per-block partials, d loss / d cos of one column, and the
// shared-memory tile products of f32 rows (fdots_*: both forwards' product,
// staged by cp.async; ftile_dots: the f32 backwards').
//
// Both kernels' top-k tie test (cos >= kth - KTH_TIE_TOL) compares cosines
// that the forward and the backward compute separately; they must be the
// same bits, so both passes take them from one chain: the FMA chain over
// the feature axis in index order from 0 (the forwards' `fdots_chunk`, the
// f32 backwards' `ftile_dots`, and quad_margin.cu's `row_dot` for the
// columns a step writes), or the tensor cores' (mma_bf16.cuh: the bf16 and
// int8 forms' k16 chain, mma_nt; int8c's exact s8 sum, mma_nt_s8).
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

// ------------------------------------------------ the forwards' row pass
//
// Each probe row's stream is split over threads (lanes); within a lane, two
// (m, s) chains a view, a pair of quads (4 columns each) at a time: each
// quad's largest z, then the chain rescaled to it and the four exp terms, 16
// independent terms a pair and no branch, so the pass is not one serial
// chain through expf. The chains run in base 2 (z / ln 2, one MUFU exp2 a
// term) and fold to base e in a fixed order (lse_fold) at the end of the
// block's range. The top-k insertions run only where a column beats kth, a
// network of selects (topk_push), every index constant, so the lists stay
// in registers; value-only lists merge exactly.

constexpr float LOG2E = 1.4426950408889634f, LN2 = 0.6931471805599453f;

// One thread's share of a row's stream, NV views: per view two (m, s)
// chains, over the first and the second quad of each of its pairs, and the
// top-k of its columns.
template <int NV>
struct Lane {
  float m[NV][2], s[NV][2], tk[NV][KMAX], kth[NV];
};

// A lane's top-k list is walked by template recursion, each index a
// constant before any optimisation: walked by loops, unrolled too late for
// the list to be promoted to registers, it stayed in local memory (-Xptxas
// -v: a 168-byte stack frame) and the row pass took half as long again.
template <int J>
__device__ __forceinline__ void tk_fill(float (&tk)[KMAX], float v) {
  tk[J] = v;
  if constexpr (J + 1 < KMAX) tk_fill<J + 1>(tk, v);
}
template <int J>
__device__ __forceinline__ void tk_store(float* p, const float (&tk)[KMAX]) {
  p[J] = tk[J];
  if constexpr (J + 1 < KMAX) tk_store<J + 1>(p, tk);
}
template <int J>
__device__ __forceinline__ float tk_at(const float (&tk)[KMAX], int j) {  // tk[j], j >= J
  if constexpr (J + 1 == KMAX) return tk[J];
  else return j == J ? tk[J] : tk_at<J + 1>(tk, j);
}
// entries J .. 1 after inserting x: each takes its upper neighbour, x or
// itself (the old values, walked from the bottom)
template <int J>
__device__ __forceinline__ void tk_shift(float (&tk)[KMAX], float x) {
  tk[J] = x > tk[J - 1] ? tk[J - 1] : (x > tk[J] ? x : tk[J]);
  if constexpr (J > 1) tk_shift<J - 1>(tk, x);
}

// x into a lane's value-only top-k (descending; kth mirrors tk[k - 1]): the
// insertion as a network of selects (entries from k on carry what shifts
// past the k-th, read by no one)
__device__ __forceinline__ void topk_push(float (&tk)[KMAX], float& kth, float x, int k) {
  if (!(x > kth)) return;
  tk_shift<KMAX - 1>(tk, x);
  tk[0] = x > tk[0] ? x : tk[0];
  kth = tk_at<0>(tk, k - 1);
}

// a lane's chains empty and its lists filled with NEG_INF_F
template <int NV>
__device__ __forceinline__ void lane_init(Lane<NV>& ln) {
#pragma unroll
  for (int v = 0; v < NV; ++v) {
#pragma unroll
    for (int ch = 0; ch < 2; ++ch) {
      ln.m[v][ch] = -INFINITY;
      ln.s[v][ch] = 0.f;
    }
    tk_fill<0>(ln.tk[v], NEG_INF_F);
    ln.kth[v] = NEG_INF_F;
  }
}

// the modified cosine of a non-target column (SV's mask above gt - margin)
template <class A>
__device__ __forceinline__ float mod_of(const A& a, float c, float gt) {
  return a.loss_type == LOSS_SV && c > gt - a.margin ? a.mask_svfc * c + a.mask_svfc - 1.0f : c;
}

// z / ln 2 of a non-target column (z = scale * mod; zs = scale * LOG2E)
template <class A>
__device__ __forceinline__ float logit2(const A& a, float zs, float c, float gt) {
  return zs * mod_of(a, c, gt);
}

// four columns' cosines c (ok: in the stream) into a chain (m, s) held in
// base 2 (m = max z / ln 2, s = sum of 2^(z / ln 2 - m), the natural sum
// relative to e^(m ln 2)): their largest z first, then the chain's sum
// rescaled to it (by 2^0 = 1 where the chain's max stands) plus the four
// terms, one MUFU exp2 each; no branch
template <class A>
__device__ __forceinline__ void stream4(const A& a, float zs, const float (&c)[4],
                                        const bool (&ok)[4], float gt, float& m, float& s) {
  float z[4], zm = -INFINITY;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    z[j] = ok[j] ? logit2(a, zs, c[j], gt) : -INFINITY;
    zm = fmaxf(zm, z[j]);
  }
  const float mn = fmaxf(m, zm), ref = mn == -INFINITY ? 0.f : mn;
  s = s * exp2f(m - ref) +
      ((exp2f(z[0] - ref) + exp2f(z[1] - ref)) + (exp2f(z[2] - ref) + exp2f(z[3] - ref)));
  m = mn;
}

// a lane's view v folded to base e: its two chains in order into (M, S)
template <int NV>
__device__ __forceinline__ void lane_fold(Lane<NV>& ln, int v, float& M, float& S) {
  M = ln.m[v][0] * LN2;
  S = ln.s[v][0];
  lse_fold(ln.m[v][1] * LN2, ln.s[v][1], M, S);
}

// ------------------------------------ the f32 tile product on the CUDA cores
//
// `ftile_dots`: the f32 backwards' product (margin_ce.cu's one pass,
// quad_margin.cu's quad_bwd_f32_kernel). X and Y are row-major [*, D] f32 in global memory, staged FK
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
// index order from 0 (and ||y||^2 the same chain of y * y): the forwards'
// (fdots_chunk), whatever the tiling. margin_ce.cu's f32 pass takes the row norms
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


// ----------------------------------------- the forwards' f32 tile product
//
// `fdots_*` (quad_margin.cu's quad_fwd_kernel, F32 form; margin_ce.cu's
// margin_fwd_kernel, f32 W): a block of NX rows of X against a tile of NY
// rows of Y, both row-major [*, D] f32 in global memory, FFK features a
// chunk of each staged by 16-byte cp.async (stage_f32, rows past the valid
// ones zero-filled) into one stage [NX + NY][FFK + 4], the caller keeping
// two chunks in flight beside the one in use. Each thread holds a TI x TJ
// micro-tile, X rows ax + SA i and Y rows by + SB j (fdots_map: the eight
// threads of a quarter warp read one X row, a broadcast, and eight
// consecutive Y rows, in eight different groups of four banks at the
// stride FFK + 4), and per four features reads a float4 of each of its rows:
// at 8 x 8, 16 LDS.128 for 256 FMA, 1 byte of shared memory per FMA. Every
// output is one fmaf chain over the features 0 .. D - 1 in index order from
// 0, ftile_dots' chain, and fdots_norm's ||y||^2 the same chain of y * y.

constexpr int FFK = 32;  // features a chunk

template <int NX, int NY>
__host__ __device__ constexpr int fdots_stage_floats() {
  return (NX + NY) * (FFK + 4);
}

// chunk kc of X rows x0 .. x0 + nx - 1 and Y rows y0 .. y0 + ny - 1 into the
// stage st (rows from nx / ny on zero-filled); the caller commits
template <int THREADS, int NX, int NY>
__device__ __forceinline__ void fdots_load(float* st, const float* X, long long x0, int nx,
                                           const float* Y, long long y0, int ny, int D, int kc) {
  stage_f32<THREADS>(st, FFK + 4, X, x0, nx, NX, D, FFK * kc, FFK);
  stage_f32<THREADS>(st + NX * (FFK + 4), FFK + 4, Y, y0, ny, NY, D, FFK * kc, FFK);
}

// the thread's micro-tile: X rows ax + (NX / TI) i, Y rows by + (NY / TJ) j
template <int NX, int NY, int TI, int TJ>
__device__ __forceinline__ void fdots_map(int& ax, int& by) {
  constexpr int SB = NY / TJ, NB = SB / 8;  // warps across the Y rows
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  by = (lane & 7) + 8 * (warp % NB);
  ax = 4 * (warp / NB) + (lane >> 3);
}

// the products of one staged chunk into acc, each output's four features
// of a float4 step in order
template <int NX, int NY, int TI, int TJ>
__device__ __forceinline__ void fdots_chunk(float (&acc)[TI][TJ], const float* st, int ax, int by) {
  constexpr int LD = FFK + 4, SA = NX / TI, SB = NY / TJ;
  const float* Ys = st + NX * LD;
#pragma unroll
  for (int k = 0; k < FFK; k += 4) {
    float4 x[TI];
#pragma unroll
    for (int i = 0; i < TI; ++i)
      x[i] = *reinterpret_cast<const float4*>(st + (ax + SA * i) * LD + k);
#pragma unroll
    for (int j = 0; j < TJ; ++j) {  // a column at a time: its four features in order
      const float4 y = *reinterpret_cast<const float4*>(Ys + (by + SB * j) * LD + k);
#pragma unroll
      for (int i = 0; i < TI; ++i) {
        float& c = acc[i][j];
        c = fmaf(x[i].x, y.x, c);
        c = fmaf(x[i].y, y.y, c);
        c = fmaf(x[i].z, y.z, c);
        c = fmaf(x[i].w, y.w, c);
      }
    }
  }
}

// n2 += ||Y row t||^2 over one staged chunk (thread t < NY), in feature order
template <int NX>
__device__ __forceinline__ void fdots_norm(float& n2, const float* st, int t) {
  constexpr int LD = FFK + 4;
#pragma unroll
  for (int k = 0; k < FFK; k += 4) {
    const float4 y = *reinterpret_cast<const float4*>(st + (NX + t) * LD + k);
    n2 = fmaf(y.x, y.x, n2);
    n2 = fmaf(y.y, y.y, n2);
    n2 = fmaf(y.z, y.z, n2);
    n2 = fmaf(y.w, y.w, n2);
  }
}

}  // namespace
