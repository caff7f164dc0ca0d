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
// bf16 (template T). Products are taken over operands widened to f32 (a
// bf16 product is exact in f32) and summed in f32 FMA; y is rounded once,
// round-to-nearest-even. No tensor cores yet: this is the simple kernel.
//
// Bound (H100 SXM): the bench's bf16 shapes do 2 * B*H*W * 9*C*Cout FLOP
// (2.96e10 at [128, 56, 56, 64], 1.18e11 at [128, 112, 112, 64], 2.96e10 at
// [128, 28, 28, 128]); at the 989 TFLOP/s bf16 tensor-core rate against
// 3.35 TB/s for x read and y written once, the two C = 64 shapes are
// bytes-bound and the C = 128 one operations-bound, all near 0.03-0.12 ms.
// This kernel runs on the f32 FMA units (67 TFLOP/s), so it sits far above
// that bound; wgmma over bf16 tiles is later work.
//
// Design.
//  * The TPU grid (B, H / strip) ran one image strip per step, with the
//    strip's two halo rows fetched as a second BlockSpec stream of a padded
//    copy. Here one block owns the same (image, strip) pair and a 64-wide
//    slice of Cout (grid (B * H / strip, ceil(Cout / 64))); it walks the
//    strip's strip * W output pixels in tiles of 64 as an implicit GEMM:
//    M = pixels, N = output channels, K = 9 * C. The SAME padding is a
//    bounds-checked zero load, so no padded copy of x is made.
//  * Each K chunk of 16 stages a [16][64] tile of x (gathered at the tap's
//    offset) and a [16][64] tile of w in shared memory as f32; 256 threads
//    each keep a 4 x 4 register tile of the accumulator.
//  * mode selects the order of K, which is the only thing that differs
//    between the two modes: taps9 walks tap-major (k = tap * C + c, JAX's
//    nine accumulating dots), im2col channel-major (k = c * 9 + tap, the
//    order of PyTorch's unfold). Both sum the same products in f32.
//  * Statistics: each thread sums its accumulator values (and their
//    squares) per channel over the block's pixels; the block reduces its 16
//    row groups in a fixed order and writes one partial per (block, channel)
//    into part [n_blocks][2][Cout]; a second launch sums the partials in
//    block order. No float atomics: the result is the same on every run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;       // output pixels per tile
constexpr int BN = 64;       // output channels per block
constexpr int KC = 16;       // K values per shared-memory chunk
constexpr int THREADS = 256;
constexpr int APAD = BM + 4;  // row stride of the staged x tile (floats)
constexpr int MODE_TAPS9 = 0, MODE_IM2COL = 1;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

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

template <class T, int MODE, bool STATS>
__global__ void __launch_bounds__(THREADS)
    conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y,
                   float* __restrict__ part, int H, int W, int C, int Cout, int strip) {
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
  const T* xn = x + (long long)n * H * W * C;

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
            v = to_f32(xn[((long long)hh * W + ww) * C + c]);
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
          v = to_f32(w[((long long)tap * C + c) * Cout + co0 + co]);
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
        store_out(y + pix * Cout + co, acc[i][j]);
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

// stats [2][Cout] = the partials [n_blocks][2][Cout] summed in block order
__global__ void conv3x3_stats_merge_kernel(const float* __restrict__ part,
                                           float* __restrict__ stats, int n_blocks, int Cout) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 2 * Cout) return;
  float s = 0.f;
  for (int b = 0; b < n_blocks; ++b) s += part[(long long)b * 2 * Cout + i];
  stats[i] = s;
}

template <class T, int MODE, bool STATS>
cudaError_t launch(const void* x, const void* w, void* y, float* part, int B, int H, int W, int C,
                   int Cout, int strip, cudaStream_t st) {
  const dim3 grid((unsigned)(B * (H / strip)), (unsigned)((Cout + BN - 1) / BN));
  conv3x3_kernel<T, MODE, STATS><<<grid, THREADS, 0, st>>>(
      (const T*)x, (const T*)w, (T*)y, part, H, W, C, Cout, strip);
  return cudaGetLastError();
}

template <class T, bool STATS>
cudaError_t launch_mode(int mode, const void* x, const void* w, void* y, float* part, int B, int H,
                        int W, int C, int Cout, int strip, cudaStream_t st) {
  if (mode == MODE_TAPS9)
    return launch<T, MODE_TAPS9, STATS>(x, w, y, part, B, H, W, C, Cout, strip, st);
  return launch<T, MODE_IM2COL, STATS>(x, w, y, part, B, H, W, C, Cout, strip, st);
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
  cudaError_t err;
  if (x_bf16)
    err = with_stats
              ? launch_mode<__nv_bfloat16, true>(mode, x, w, y, part, B, H, W, C, Cout, strip, st)
              : launch_mode<__nv_bfloat16, false>(mode, x, w, y, part, B, H, W, C, Cout, strip, st);
  else
    err = with_stats ? launch_mode<float, true>(mode, x, w, y, part, B, H, W, C, Cout, strip, st)
                     : launch_mode<float, false>(mode, x, w, y, part, B, H, W, C, Cout, strip, st);
  if (err != cudaSuccess || !with_stats) return (int)err;
  conv3x3_stats_merge_kernel<<<(2 * Cout + 127) / 128, 128, 0, st>>>(part, stats,
                                                                    B * (H / strip), Cout);
  return (int)cudaGetLastError();
}

}  // extern "C"
