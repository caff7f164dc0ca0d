// 3x3 stride-1 SAME convolution over NHWC activations for NVIDIA Hopper
// (sm_90a), with an optional BatchNorm-statistics epilogue: per output
// channel, the sum and the sum of squares of the f32 accumulator before it
// is rounded to the output type.
//
// Replaces the TPU kernel vlsfr_tpu/ops/conv_pallas.py:
//   conv3x3_pallas (:94, pallas_call :119) -> conv3x3_launch
// The plain PyTorch version beside the wrapper
// (vlsfr_tpu_torch/ops/conv3x3.py: conv3x3_plain) computes the same function.
//
// Layout: x [B][H][W][C], w [3][3][C][Cout] (HWIO, JAX's layout, already cast
// to x's type by the wrapper), y [B][H][W][Cout], all contiguous, f32 or
// bf16. y is rounded once from the f32 sum, round-to-nearest-even.
//
// Bound (H100 SXM): the bench's bf16 shapes do 2 * B*H*W * 9*C*Cout FLOP
// (2.96e10 at [128, 56, 56, 64], 1.18e11 at [128, 112, 112, 64], 2.96e10 at
// [128, 28, 28, 128]); at the 989 TFLOP/s bf16 tensor-core rate against
// 3.35 TB/s for x read and y written once, the two C = 64 shapes are
// bytes-bound and the C = 128 one operations-bound, all near 0.03-0.12 ms.
//
// Both forms: one block owns one (image, strip) pair of the TPU grid
// (B, H / strip) and a 64-wide slice of Cout (grid (B * H / strip,
// ceil(Cout / 64))), and walks the strip's strip * W output pixels as an
// implicit GEMM: M = pixels, N = output channels, K = 9 * C. The SAME
// padding is a zero load, so no spatially padded copy of x is made. mode selects the
// order of K: taps9 walks tap-major (JAX's nine accumulating dots), im2col
// channel-major (the order of PyTorch's unfold). Statistics: the block
// reduces its threads' per-channel sums in a fixed order into one partial
// per (block, channel), part [n_blocks][2][Cout]; a second launch sums the
// partials in block order. No float atomics: the result is the same on
// every run.
//
// bf16 form (conv3x3_bf16_kernel, conv3x3_bf16_stream_kernel): tensor
// cores, mma.sync m16n8k16 over operands staged in shared memory as bf16
// (csrc/mma_bf16.cuh).
//  * Resident where it fits: the block's weight slice, rows (tap, c) of K
//    padded to C16 = C rounded up to 16, x 64 channels, is staged once
//    (73.7 KB at C = 64, 147 KB at C = 128) and kept across the strip.
//  * x is read once (and its halo rows twice), not once per tap: the strip
//    is walked in groups of tr output rows, and each group's halo, (tr + 2)
//    rows x (W + 2) pixels x C16 channels, is staged by cp.async, zero-
//    filled for the SAME padding, the rows past the image and the channels
//    past C, while the previous group computes: two stages. tr is as large
//    as the shared memory beside the weights and one pass of 384 pixels
//    allow (6 rows at W = 56, 3 at W = 112). Where two stages would hold
//    fewer than 128 pixels (C = 128 at W = 28: 3 rows), one stage of more
//    rows is taken (8), and its copies wait for the previous group.
//  * Each tap reads its A fragments straight out of the halo: a lane's
//    ldmatrix row is its output pixel's halo index plus the tap's offset,
//    worked out once a pass. K is walked in k16 steps of one tap and 16
//    channels; mode is their order (taps9: tap-major, im2col:
//    channel-major). No step waits for a copy or a barrier.
//  * Streamed where the slice does not fit beside one halo row (C = 256:
//    295 KB, C = 512: 590 KB): K is cut into chunks of cch = 64 (or 32, 16)
//    channels; each (group, pass, chunk) stages that chunk's halo and its
//    weight rows [9 cch][64] together, two stages, the next under this
//    one's products (208 KB at cch = 64, W = 14, tr = 14). A pass sums its
//    chunks in channel order, each in the mode's order within it.
//  * 8 warps: 4 along the pixels, each up to 6 m16 slices (taken round
//    robin, so a short group spreads over the warps), x 2 along the
//    channels, 32 each; a slice past the group's pixels is skipped.
//  * Statistics: each thread sums its fragment values (rows g, g + 8 of each
//    m16 slice; two channels per n8 tile) over the block's pixels, the 8
//    lanes that share a channel combine by fixed xor shuffles, and the 4
//    pixel warps in order.
//  * C must be a multiple of 8 (16-byte cp.async pieces of a pixel's
//    channels): the wrapper pads x's (and w's) channel axis with zeros once
//    where it is not (ir50's stem, C = 3), as JAX's wrapper pads x's
//    spatial halo, and the zero channels add nothing to the sums.
//
// f32 form (conv3x3_f32_kernel): f32 FMA ("f32 means f32": no TF32). Each K
// chunk of 16 stages a [16][64] tile of x (gathered at the tap's offset)
// and a [16][64] tile of w in shared memory; 256 threads each keep a 4 x 4
// register tile of the accumulator.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_bf16.cuh"

namespace {

constexpr int BM = 64;       // output pixels per tile
constexpr int BN = 64;       // output channels per block
constexpr int KC = 16;       // K values per shared-memory chunk
constexpr int THREADS = 256;
constexpr int APAD = BM + 4;  // row stride of the staged x tile (floats)
constexpr int MODE_TAPS9 = 0, MODE_IM2COL = 1;


// the (tap, channel) of K index k in the mode's order
template <int MODE>
__device__ __forceinline__ void k_split(int k, int C, int& tap, int& c) {
  if (MODE == MODE_TAPS9) {
    tap = k / C;
    c = k - tap * C;
  } else {
    c = k / 9;
    tap = k - c * 9;
  }
}

template <int MODE, bool STATS>
__global__ void __launch_bounds__(THREADS)
    conv3x3_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                       float* __restrict__ y, float* __restrict__ part, int H, int W, int C,
                       int Cout, int strip) {
  __shared__ __align__(16) float As[KC][APAD];
  __shared__ __align__(16) float Bs[KC][BN];
  __shared__ float red[2][THREADS / 16][BN];

  const int tid = threadIdx.x;
  const int n_strips = H / strip;
  const int n = blockIdx.x / n_strips;
  const int row0 = (blockIdx.x - n * n_strips) * strip;
  const int co0 = blockIdx.y * BN;
  const int K = 9 * C;
  const int npix = strip * W;
  const float* xn = x + (long long)n * H * W * C;

  // the staging assignment: this thread loads K slot lk of pixels lm + 16 i
  const int lk = tid % KC, lm = tid / KC;
  // the compute assignment: pixels ty * 4 .. + 3, channels tx * 4 .. + 3
  const int ty = tid / 16, tx = tid % 16;
  float s1[4] = {0.f, 0.f, 0.f, 0.f}, s2[4] = {0.f, 0.f, 0.f, 0.f};

  for (int p0 = 0; p0 < npix; p0 += BM) {
    int ph[4], pw[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = p0 + lm + 16 * i;
      ph[i] = p < npix ? row0 + p / W : -1000;  // -1000: a pixel past the strip loads zeros
      pw[i] = p < npix ? p % W : 0;
    }
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < K; k0 += KC) {
      {  // x tile: K slot lk of four pixels
        const int k = k0 + lk;
        int tap = 0, c = 0;
        if (k < K) k_split<MODE>(k, C, tap, c);
        const int dy = tap / 3, dx = tap - 3 * (tap / 3);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int hh = ph[i] + dy - 1, ww = pw[i] + dx - 1;
          float v = 0.f;
          if (k < K && hh >= 0 && hh < H && ww >= 0 && ww < W)
            v = xn[((long long)hh * W + ww) * C + c];
          As[lk][lm + 16 * i] = v;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // w tile: rows k0 .. k0 + 15, channels co0 .. co0 + 63
        const int idx = tid + THREADS * i;
        const int kk = idx / BN, co = idx % BN;
        const int k = k0 + kk;
        float v = 0.f;
        if (k < K && co0 + co < Cout) {
          int tap, c;
          k_split<MODE>(k, C, tap, c);
          v = w[((long long)tap * C + c) * Cout + co0 + co];
        }
        Bs[kk][co] = v;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
        const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = p0 + ty * 4 + i;
      if (p >= npix) continue;
      const long long pix = ((long long)n * H + row0 + p / W) * W + p % W;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int co = co0 + tx * 4 + j;
        if (co >= Cout) continue;
        y[pix * Cout + co] = acc[i][j];
        if (STATS) {
          s1[j] += acc[i][j];
          s2[j] = fmaf(acc[i][j], acc[i][j], s2[j]);
        }
      }
    }
  }

  if (STATS) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      red[0][ty][tx * 4 + j] = s1[j];
      red[1][ty][tx * 4 + j] = s2[j];
    }
    __syncthreads();
    if (tid < 2 * BN) {
      const int which = tid / BN, co = tid % BN;
      float s = 0.f;
      for (int g = 0; g < THREADS / 16; ++g) s += red[which][g][co];
      if (co0 + co < Cout) part[((long long)blockIdx.x * 2 + which) * Cout + co0 + co] = s;
    }
  }
}

// ------------------------------------------------------------- bf16 form

constexpr int MS = 6;                  // m16 pixel slices a warp holds in a pass
constexpr int PASS_PX = 4 * MS * 16;   // pixels of one pass (4 pixel warps)
constexpr int BF16_MAX_SMEM = 232448;  // a block's dynamic shared memory on sm_90

// the resident kernel's shared memory with n_st halo stages of tr output
// rows: the weight slice [9 C16][BN], the stages of (tr + 2) x (W + 2)
// pixels x C16 channels, the statistics' reduction
__host__ __device__ constexpr int bf16_smem(int C, int W, int tr, int n_st) {
  return 9 * ((C + 15) / 16 * 16) * BN * 2 +
         n_st * (tr + 2) * (W + 2) * ((C + 15) / 16 * 16) * 2 + 2 * 4 * BN * 4;
}

// the streamed kernel's: two stages, each a halo of cch channels and the
// weight rows [9 cch][BN] of those channels, and the reduction
__host__ __device__ constexpr int stream_smem(int cch, int W, int tr) {
  return 2 * ((tr + 2) * (W + 2) * cch * 2 + 9 * cch * BN * 2) + 2 * 4 * BN * 4;
}

// output rows a halo stage holds: as many as fit (smem(tr) <= the block's
// shared memory), at most one pass of pixels and the strip; 0 where none fits
template <class F>
int fit_rows(int W, int strip, F smem) {
  int tr = min(strip, max(1, PASS_PX / W));
  while (tr > 0 && smem(tr) > BF16_MAX_SMEM) --tr;
  return tr;
}

// The plan of a bf16 launch. Resident (cch = 0) where the weight slice fits
// beside a halo stage of one row: two stages (the next group's copies under
// this group's products) where they still hold 8 m16 slices (two a pixel
// warp), else one stage of more rows (its copies wait, ~5 % of a group at
// C = 128). Else streamed: the widest chunk of cch = 64, 32 or 16 channels
// whose two stages hold 128 pixels, or a whole pass or strip, else the
// narrowest.
void bf16_plan(int C, int W, int strip, int& tr, int& n_st, int& cch) {
  cch = 0;
  n_st = 2;
  tr = fit_rows(W, strip, [&](int r) { return bf16_smem(C, W, r, 2); });
  if (tr * W < 128) {
    n_st = 1;
    tr = fit_rows(W, strip, [&](int r) { return bf16_smem(C, W, r, 1); });
  }
  if (tr > 0) return;
  n_st = 2;
  const int most = min(strip, max(1, PASS_PX / W));
  for (cch = 64; cch >= 16; cch /= 2) {
    tr = fit_rows(W, strip, [&](int r) { return stream_smem(cch, W, r); });
    if (tr * W >= 128 || tr == most || cch == 16) return;
  }
}

// this lane's A row of each of the warp's slices of the pass at pixel p0:
// its output pixel's halo index (rows past the group: any valid row)
__device__ __forceinline__ void pass_rows(int p0, int npix, int W, int WP, int wm, int lane,
                                          int (&hp)[MS], bool (&live)[MS]) {
#pragma unroll
  for (int j = 0; j < MS; ++j) {
    const int slice = p0 + 16 * (wm + 4 * j);
    live[j] = slice < npix;
    const int p = slice + (lane & 15);
    hp[j] = p < npix ? (p / W) * WP + p % W : 0;
  }
}

// acc += the pass's products over CB 16-channel blocks x 9 taps of a halo
// stage (rc chunks a pixel, swizzle m) and weight rows tap * tap_rows + c,
// in the mode's order of k16 steps (taps9: tap-major, im2col: channel-major).
// STEP0: each step's product from a zero accumulator, added in f32
// (mma_bf16.cuh's header: the streamed kernel's chain of up to 9 x 32 steps
// would drift in the tensor core's accumulator); else chained there.
template <int MODE, bool STEP0>
__device__ __forceinline__ void pass_mma(float (&acc)[MS][4][4], const unsigned char* buf, int rc,
                                         int m, const int (&hp)[MS], const bool (&live)[MS],
                                         int WP, const unsigned char* Ws, int tap_rows, int CB) {
  const int lane = threadIdx.x & 31, wn = threadIdx.x >> 7;
  int tap = 0, cb = 0;
  for (int s = 0; s < 9 * CB; ++s) {
    const int toff = (tap / 3) * WP + tap % 3, krow = tap * tap_rows + 16 * cb;
    const int col = 16 * cb + 8 * (lane >> 4);
    uint32_t a[MS][4];
#pragma unroll
    for (int j = 0; j < MS; ++j)
      if (live[j]) ldsm_x4(a[j], buf + swz(hp[j] + toff, col, rc, m));
#pragma unroll
    for (int nj = 0; nj < 2; ++nj) {
      uint32_t b[4];
      load_b_kn(b, Ws + krow * BN * 2, BN / 8, wn * 32 + 16 * nj, 0);
#pragma unroll
      for (int j = 0; j < MS; ++j) {
        if (!live[j]) continue;
        if (STEP0) {
          mma_add(acc[j], 2 * nj, a[j], b);
        } else {
          mma_bf16(acc[j][2 * nj], a[j], b[0], b[1]);
          mma_bf16(acc[j][2 * nj + 1], a[j], b[2], b[3]);
        }
      }
    }
    if (MODE == MODE_TAPS9) {  // the next step: tap-major or channel-major
      if (++cb == CB) cb = 0, ++tap;
    } else {
      if (++tap == 9) tap = 0, ++cb;
    }
  }
}

// y of the pass's pixels (from p0 of the group at image row gr0) rounded
// once; the statistics gathered
template <bool STATS>
__device__ __forceinline__ void store_pass(const float (&acc)[MS][4][4], __nv_bfloat16* y, int n,
                                           int H, int W, int gr0, int p0, int npix, int Cout,
                                           int co0, float (&s1)[4][2], float (&s2)[4][2]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp & 3, wn = warp >> 2, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < MS; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = p0 + 16 * (wm + 4 * j) + g + 8 * h;
      if (p >= npix) continue;
      __nv_bfloat16* yp = y + ((long long)(n * H + gr0) * W + p) * Cout;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int co = co0 + wn * 32 + 8 * ni + 2 * t;
        const float v0 = acc[j][ni][2 * h], v1 = acc[j][ni][2 * h + 1];
        if ((Cout & 1) == 0 && co + 1 < Cout) {
          *reinterpret_cast<__nv_bfloat162*>(yp + co) = __floats2bfloat162_rn(v0, v1);
        } else {
          if (co < Cout) yp[co] = __float2bfloat16_rn(v0);
          if (co + 1 < Cout) yp[co + 1] = __float2bfloat16_rn(v1);
        }
        if (STATS) {  // channels past Cout sum zeros and are never written
          s1[ni][0] += v0;
          s1[ni][1] += v1;
          s2[ni][0] = fmaf(v0, v0, s2[ni][0]);
          s2[ni][1] = fmaf(v1, v1, s2[ni][1]);
        }
      }
    }
}

// the block's statistics partial: the 8 lanes of a channel by fixed xor
// shuffles, then the 4 pixel warps in order, into part[block][2][Cout]
__device__ __forceinline__ void store_stats(float (&s1)[4][2], float (&s2)[4][2], float* red,
                                            float* part, int Cout, int co0) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        s1[ni][j] += __shfl_xor_sync(0xffffffffu, s1[ni][j], off);
        s2[ni][j] += __shfl_xor_sync(0xffffffffu, s2[ni][j], off);
      }
  if (g == 0) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = wn * 32 + 8 * ni + 2 * t + j;
        red[(0 * 4 + wm) * BN + col] = s1[ni][j];
        red[(1 * 4 + wm) * BN + col] = s2[ni][j];
      }
  }
  __syncthreads();
  if (tid < 2 * BN) {
    const int which = tid / BN, col = tid % BN;
    float s = 0.f;
    for (int q = 0; q < 4; ++q) s += red[(which * 4 + q) * BN + col];
    if (co0 + col < Cout) part[((long long)blockIdx.x * 2 + which) * Cout + co0 + col] = s;
  }
}

// weight rows (tap, c) for c in [c0, c0 + cch) of the block's Cout slice
// into Ws [9 cch][BN], swizzled: row tap * cch + c - c0, zero past C and Cout
__device__ __forceinline__ void stage_weights(unsigned char* Ws, const __nv_bfloat16* w, int C,
                                              int Cout, int co0, int c0, int cch) {
  for (int i = threadIdx.x; i < 9 * cch * (BN / 8); i += THREADS) {
    const int kk = i >> 3, piece = i & 7;
    const int tap = kk / cch, c = c0 + kk - tap * cch, co = co0 + 8 * piece;
    unsigned char* dst = Ws + swz(kk, 8 * piece, BN / 8);
    const __nv_bfloat16* src = w + ((long long)tap * C + c) * Cout + co;
    if ((Cout & 7) == 0) {
      const bool ok = c < C && co < Cout;
      cp_async_cg(dst, ok ? src : w, ok);
    } else {  // rows not 16-byte aligned: element by element
      __align__(16) __nv_bfloat16 v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        v[j] = c < C && co + j < Cout ? src[j] : __float2bfloat16_rn(0.f);
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
    }
  }
}

// the halo of the tr output rows from image row gr0: image rows gr0 - 1 ..
// gr0 + tr, columns -1 .. W, channels [c0, c0 + 8 rc), zero outside the
// image and past C, into buf [(tr + 2) (W + 2)][8 rc] (swizzle m); a thread
// copies chunk ch of pixels hp0, hp0 + step, ..
__device__ __forceinline__ void stage_halo(unsigned char* buf, const __nv_bfloat16* xn, int H,
                                           int W, int C, int gr0, int tr, int c0, int rc, int m) {
  const int WP = W + 2, hp_n = (tr + 2) * WP;
  const int lg = rc <= 1 ? 0 : rc <= 2 ? 1 : rc <= 4 ? 2 : rc <= 8 ? 3 : rc <= 16 ? 4 : 5;
  const int ch = threadIdx.x & ((1 << lg) - 1), step = THREADS >> lg, hp_first = threadIdx.x >> lg;
  if (ch >= rc) return;
  int hr = hp_first / WP, hc = hp_first - hr * WP;
  for (int hp = hp_first; hp < hp_n; hp += step) {
    const int hh = gr0 + hr - 1, ww = hc - 1;
    const int c = c0 + 8 * ch;
    const bool ok = hh >= 0 && hh < H && ww >= 0 && ww < W && c < C;
    cp_async_ca(buf + swz(hp, 8 * ch, rc, m), ok ? xn + ((long long)hh * W + ww) * C + c : xn, ok);
    for (hc += step; hc >= WP; hc -= WP) ++hr;
  }
}

// Resident: the block's whole weight slice stays in shared memory; the
// strip's groups of tr rows stream their halos (all channels) through n_st
// stages.
template <int MODE, bool STATS>
__global__ void __launch_bounds__(THREADS, 1)
    conv3x3_bf16_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                        __nv_bfloat16* __restrict__ y, float* __restrict__ part, int H, int W,
                        int C, int Cout, int strip, int tr, int n_st) {
  extern __shared__ __align__(16) unsigned char conv_smem[];
  const int CB = (C + 15) / 16, CP = 16 * CB, rc = CP / 8;
  const int m = min(rc & -rc, 8) - 1;  // the halo's swizzle (mma_bf16.cuh: swz)
  const int WP = W + 2, hp_n = (tr + 2) * WP;  // halo pixels a stage holds
  unsigned char* Ws = conv_smem;                // weights [9 CP][BN], swizzled
  unsigned char* Xs = Ws + 9 * CP * BN * 2;     // halo stages [n_st][hp_n][CP]
  float* red = reinterpret_cast<float*>(Xs + n_st * hp_n * CP * 2);  // [2][4][BN]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3;  // pixel slices wm + 4 j (channels (warp / 4) * 32 ..)
  const int n_strips = H / strip;
  const int n = blockIdx.x / n_strips;
  const int row0 = (blockIdx.x - n * n_strips) * strip;
  const int co0 = blockIdx.y * BN;
  const int n_groups = (strip + tr - 1) / tr;
  const __nv_bfloat16* xn = x + (long long)n * H * W * C;

  stage_weights(Ws, w, C, Cout, co0, 0, CP);  // once per block: row tap * CP + c
  auto stage = [&](int gi) {
    stage_halo(Xs + (gi & (n_st - 1)) * hp_n * CP * 2, xn, H, W, C, row0 + gi * tr, tr, 0, rc, m);
  };

  stage(0);
  cp_async_commit();  // with the weights
  float s1[4][2] = {}, s2[4][2] = {};
  for (int gi = 0; gi < n_groups; ++gi) {
    if (n_st == 2 && gi + 1 < n_groups) stage(gi + 1);
    cp_async_commit();
    if (n_st == 2)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();  // group gi's halo (and the weights) landed
    const unsigned char* buf = Xs + (gi & (n_st - 1)) * hp_n * CP * 2;
    const int gr0 = row0 + gi * tr;
    const int npix = min(tr, row0 + strip - gr0) * W;  // the group's output pixels
    for (int p0 = 0; p0 < npix; p0 += PASS_PX) {
      int hp[MS];
      bool live[MS];
      pass_rows(p0, npix, W, WP, wm, lane, hp, live);
      float acc[MS][4][4] = {};
      pass_mma<MODE, false>(acc, buf, rc, m, hp, live, WP, Ws, CP, CB);
      store_pass<STATS>(acc, y, n, H, W, gr0, p0, npix, Cout, co0, s1, s2);
    }
    __syncthreads();  // the next group's copies go into this group's stage
    if (n_st == 1 && gi + 1 < n_groups) stage(gi + 1);
  }
  cp_async_wait<0>();
  if (STATS) store_stats(s1, s2, red, part, Cout, co0);
}

// Streamed (a weight slice too large to stay): the block walks (group of tr
// rows, pass, chunk of cch channels) items; each item's halo of those
// channels and their weight rows [9 cch][BN] are staged by cp.async while
// the previous item computes (two stages). A pass sums its chunks in order,
// each chunk's k16 steps in the mode's order, each step's product added in
// f32, then rounds y once: im2col's order is channel-major overall; taps9
// is tap-major within a chunk.
template <int MODE, bool STATS>
__global__ void __launch_bounds__(THREADS, 1)
    conv3x3_bf16_stream_kernel(const __nv_bfloat16* __restrict__ x,
                               const __nv_bfloat16* __restrict__ w, __nv_bfloat16* __restrict__ y,
                               float* __restrict__ part, int H, int W, int C, int Cout, int strip,
                               int tr, int cch) {
  extern __shared__ __align__(16) unsigned char conv_smem[];
  const int CP = (C + 15) / 16 * 16, rc = cch / 8;
  const int m = min(rc & -rc, 8) - 1;
  const int WP = W + 2, hp_n = (tr + 2) * WP;
  const int stage_bytes = hp_n * cch * 2 + 9 * cch * BN * 2;  // halo, then weights
  float* red = reinterpret_cast<float*>(conv_smem + 2 * stage_bytes);  // [2][4][BN]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3;
  const int n_strips = H / strip;
  const int n = blockIdx.x / n_strips;
  const int row0 = (blockIdx.x - n * n_strips) * strip;
  const int co0 = blockIdx.y * BN;
  const int n_groups = (strip + tr - 1) / tr;
  const int n_pass = (tr * W + PASS_PX - 1) / PASS_PX, n_ch = (CP + cch - 1) / cch;
  const int n_items = n_groups * n_pass * n_ch;
  const __nv_bfloat16* xn = x + (long long)n * H * W * C;

  auto stage = [&](int it) {  // item it's halo chunk and weight rows into stage it & 1
    unsigned char* buf = conv_smem + (it & 1) * stage_bytes;
    const int ci = it % n_ch, gi = it / n_ch / n_pass;
    stage_halo(buf, xn, H, W, C, row0 + gi * tr, tr, ci * cch, rc, m);
    stage_weights(buf + hp_n * cch * 2, w, C, Cout, co0, ci * cch, cch);
  };

  stage(0);
  cp_async_commit();
  float s1[4][2] = {}, s2[4][2] = {};
  float acc[MS][4][4];
  for (int it = 0; it < n_items; ++it) {
    if (it + 1 < n_items) stage(it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // item it's stage landed
    const int ci = it % n_ch, pi = it / n_ch % n_pass, gi = it / n_ch / n_pass;
    const int gr0 = row0 + gi * tr, p0 = pi * PASS_PX;
    const int npix = min(tr, row0 + strip - gr0) * W;
    if (ci == 0) {
#pragma unroll
      for (int j = 0; j < MS; ++j)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][ni][e] = 0.f;
    }
    if (p0 < npix) {
      int hp[MS];
      bool live[MS];
      pass_rows(p0, npix, W, WP, wm, lane, hp, live);
      const unsigned char* buf = conv_smem + (it & 1) * stage_bytes;
      pass_mma<MODE, true>(acc, buf, rc, m, hp, live, WP, buf + hp_n * cch * 2, cch,
                           min(cch, CP - ci * cch) / 16);
      if (ci == n_ch - 1) store_pass<STATS>(acc, y, n, H, W, gr0, p0, npix, Cout, co0, s1, s2);
    }
    __syncthreads();  // item it + 2's copies go into this stage
  }
  cp_async_wait<0>();
  if (STATS) store_stats(s1, s2, red, part, Cout, co0);
}

// stats [2][Cout] = the partials [n_blocks][2][Cout] summed in block order
__global__ void conv3x3_stats_merge_kernel(const float* __restrict__ part,
                                           float* __restrict__ stats, int n_blocks, int Cout) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 2 * Cout) return;
  float s = 0.f;
  for (int b = 0; b < n_blocks; ++b) s += part[(long long)b * 2 * Cout + i];
  stats[i] = s;
}

template <int MODE, bool STATS>
cudaError_t launch_f32(const void* x, const void* w, void* y, float* part, int B, int H, int W,
                       int C, int Cout, int strip, cudaStream_t st) {
  const dim3 grid((unsigned)(B * (H / strip)), (unsigned)((Cout + BN - 1) / BN));
  conv3x3_f32_kernel<MODE, STATS><<<grid, THREADS, 0, st>>>(
      (const float*)x, (const float*)w, (float*)y, part, H, W, C, Cout, strip);
  return cudaGetLastError();
}

template <int MODE, bool STATS>
cudaError_t launch_bf16(const void* x, const void* w, void* y, float* part, int B, int H, int W,
                        int C, int Cout, int strip, cudaStream_t st) {
  int tr, n_st, cch;
  bf16_plan(C, W, strip, tr, n_st, cch);
  if (C % 8 || tr == 0) return cudaErrorInvalidValue;  // the wrapper pads C to a multiple of 8
  const dim3 grid((unsigned)(B * (H / strip)), (unsigned)((Cout + BN - 1) / BN));
  const __nv_bfloat16 *xb = (const __nv_bfloat16*)x, *wb = (const __nv_bfloat16*)w;
  __nv_bfloat16* yb = (__nv_bfloat16*)y;
  if (cch == 0) {
    const int smem = bf16_smem(C, W, tr, n_st);
    cudaError_t err = cudaFuncSetAttribute(conv3x3_bf16_kernel<MODE, STATS>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    conv3x3_bf16_kernel<MODE, STATS><<<grid, THREADS, smem, st>>>(xb, wb, yb, part, H, W, C, Cout,
                                                                  strip, tr, n_st);
  } else {
    const int smem = stream_smem(cch, W, tr);
    cudaError_t err = cudaFuncSetAttribute(conv3x3_bf16_stream_kernel<MODE, STATS>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    conv3x3_bf16_stream_kernel<MODE, STATS><<<grid, THREADS, smem, st>>>(
        xb, wb, yb, part, H, W, C, Cout, strip, tr, cch);
  }
  return cudaGetLastError();
}

template <bool STATS>
cudaError_t launch_form(int bf16, int mode, const void* x, const void* w, void* y, float* part,
                        int B, int H, int W, int C, int Cout, int strip, cudaStream_t st) {
  if (bf16)
    return mode == MODE_TAPS9
               ? launch_bf16<MODE_TAPS9, STATS>(x, w, y, part, B, H, W, C, Cout, strip, st)
               : launch_bf16<MODE_IM2COL, STATS>(x, w, y, part, B, H, W, C, Cout, strip, st);
  return mode == MODE_TAPS9
             ? launch_f32<MODE_TAPS9, STATS>(x, w, y, part, B, H, W, C, Cout, strip, st)
             : launch_f32<MODE_IM2COL, STATS>(x, w, y, part, B, H, W, C, Cout, strip, st);
}

}  // namespace

extern "C" {

const char* conv3x3_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// y = conv3x3(x, w); with stats (part and stats non-null): part is
// [B * H / strip][2][Cout] f32 scratch, stats [2][Cout] f32 (sum, sum of
// squares). x_bf16 selects the element type of x, w and y; mode 0 = taps9,
// 1 = im2col; strip divides H.
int conv3x3_launch(const void* x, const void* w, void* y, float* part, float* stats, int x_bf16,
                   int mode, int B, int H, int W, int C, int Cout, int strip, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const bool with_stats = stats != nullptr;
  cudaError_t err =
      with_stats ? launch_form<true>(x_bf16, mode, x, w, y, part, B, H, W, C, Cout, strip, st)
                 : launch_form<false>(x_bf16, mode, x, w, y, part, B, H, W, C, Cout, strip, st);
  if (err != cudaSuccess || !with_stats) return (int)err;
  conv3x3_stats_merge_kernel<<<(2 * Cout + 127) / 128, 128, 0, st>>>(part, stats,
                                                                    B * (H / strip), Cout);
  return (int)cudaGetLastError();
}

}  // extern "C"
