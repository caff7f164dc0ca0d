// The matrix-unit probe for NVIDIA Hopper (sm_90a): o[b, t] = sum over NT
// tiles i and over d of a[b, d] * w[i, t, d], on the tensor cores, in three
// forms:
//   int8  - a, w int8, products and sums in int32 (mma.sync s8 m16n8k32;
//           the sum wraps mod 2^32 as JAX's int32 accumulator does);
//   bf16  - a, w bf16, f32 sums (mma.sync bf16 m16n8k16);
//   i8st  - a bf16, w stored int8 and widened to bf16 in shared memory
//           (exact for -128..127), f32 sums (the int8-queue path's dot).
//
// Replaces the TPU kernel tools/probe_int8_mxu.py:
//   make_call (:73, pallas_call :74), bodies _kernel_int8 (:33),
//   _kernel_bf16 (:46), _kernel_i8st_bf16dot (:59) -> dot_probe_launch
// The plain PyTorch version (vlsfr_tpu_torch/tools/probe_int8_mxu.py:
// probe_dot_plain) computes the same function.
//
// Layout: a [B][D], w [NT][T][D], o [B][T] (int32 or f32), contiguous;
// B <= 128, T a multiple of 64, D a multiple of 128 up to 512.
//
// Bound (H100 SXM) at the probe's shapes B = 128, D = 512, T = 1024,
// NT = 512: 2 * B * D * T * NT = 6.87e10 operations, which take 0.035 ms at
// 1,979 TOP/s int8 and 0.069 ms at 989 TFLOP/s bf16; w is 268 MB in int8
// and 537 MB in bf16, which take 0.080 and 0.160 ms at 3.35 TB/s. Each byte
// of w feeds 2 * B = 256 operations, under the card's ~590 (int8) and ~295
// (bf16) operations per byte, so all three forms are bound by the bytes of
// w, and the int8 / bf16 ratio this probe reads is mostly one of bytes.
//
// Design. The TPU walked the NT tiles in order and carried the [B, T] sum
// in its output block. Here a block owns 64 columns of T and a contiguous
// range of the tiles (grid (T / 64, splits)); it keeps all of a (128 rows,
// zero beyond B) in shared memory, streams its tiles' [64][D] slices of w
// through a double-buffered shared-memory chunk of 128 bytes per row (one
// register-prefetched chunk ahead), and its 8 warps (4 x 2) each hold a
// 32 x 32 accumulator tile in mma fragments across all its tiles. It writes
// a partial [splits][B][T]; a second launch sums the splits in order. Plain
// loads, no cp.async or TMA, no wgmma: the simple kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MROWS = 128;    // rows of a a block holds
constexpr int BN = 64;        // columns of T per block
constexpr int CHUNK_B = 128;  // bytes of a w row per streamed chunk
constexpr int PADB = 16;      // shared-memory row padding (bytes): conflict-free fragments
constexpr int FORM_INT8 = 0, FORM_BF16 = 1, FORM_I8ST = 2;

// the form's stored w type, the mma operand type's size, the accumulator
template <int FORM> struct Form;
template <> struct Form<FORM_INT8> {
  using W = int8_t;
  using Acc = int;
  static constexpr int OP = 1;  // bytes per mma operand element
};
template <> struct Form<FORM_BF16> {
  using W = __nv_bfloat16;
  using Acc = float;
  static constexpr int OP = 2;
};
template <> struct Form<FORM_I8ST> {
  using W = int8_t;
  using Acc = float;
  static constexpr int OP = 2;
};

__device__ __forceinline__ void mma(int (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// 16 stored bytes of w -> the shared-memory chunk: as they are, or (i8st)
// 16 int8 values widened to 16 bf16 (32 bytes)
template <int FORM>
__device__ __forceinline__ void stage(unsigned char* dst, const uint4& v) {
  if (FORM != FORM_I8ST) {
    *reinterpret_cast<uint4*>(dst) = v;
  } else {
    const int8_t* s = reinterpret_cast<const int8_t*>(&v);
    __align__(16) __nv_bfloat16 h[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) h[i] = __int2bfloat16_rn((int)s[i]);
    reinterpret_cast<uint4*>(dst)[0] = reinterpret_cast<const uint4*>(h)[0];
    reinterpret_cast<uint4*>(dst)[1] = reinterpret_cast<const uint4*>(h)[1];
  }
}

template <int FORM>
__global__ void __launch_bounds__(THREADS)
    dot_probe_kernel(const void* __restrict__ a_, const void* __restrict__ w_,
                     typename Form<FORM>::Acc* __restrict__ part, int B, int D, int T, int NT,
                     int splits) {
  using F = Form<FORM>;
  using Acc = typename F::Acc;
  constexpr int WB = sizeof(typename F::W);        // stored bytes per w element
  constexpr int KCH = CHUNK_B / WB;                // k values per chunk
  constexpr int WROW = KCH * F::OP + PADB;          // shared bytes per chunk row
  constexpr int KSTEP = F::OP == 1 ? 32 : 16;       // k per mma
  extern __shared__ __align__(16) unsigned char smem[];
  const int arow = D * F::OP + PADB;  // shared bytes per row of a
  unsigned char* As = smem;
  unsigned char* Ws = smem + MROWS * arow;  // two chunks of [BN][WROW]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;  // warp tile: rows wm * 32, columns wn * 32
  const int col0 = blockIdx.x * BN;
  const int s = blockIdx.y;
  const int t_lo = (int)((long long)NT * s / splits), t_hi = (int)((long long)NT * (s + 1) / splits);

  // a -> shared memory, rows past B zero (a's mma operand type is its own)
  const int a_vec = D * F::OP / 16;  // uint4 per row
  const uint4* a4 = reinterpret_cast<const uint4*>(a_);
  for (int i = tid; i < MROWS * a_vec; i += THREADS) {
    const int r = i / a_vec, c = i - r * a_vec;
    const uint4 v = r < B ? a4[(long long)r * a_vec + c] : make_uint4(0, 0, 0, 0);
    *reinterpret_cast<uint4*>(As + r * arow + c * 16) = v;
  }

  Acc acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  // the streamed chunks: (tile, k0) in order; thread tid stages row tid / 4,
  // bytes (tid % 4) * 16 .. + 15 and 64 further (two uint4 per chunk)
  const int chunks_per_tile = D / KCH;
  const int n_chunks = (t_hi - t_lo) * chunks_per_tile;
  const unsigned char* wb = reinterpret_cast<const unsigned char*>(w_);
  const int srow = tid >> 2, sbyte = (tid & 3) * 16;
  auto fetch = [&](int ch, uint4 (&v)[2]) {
    const int tile = t_lo + ch / chunks_per_tile, k0 = (ch % chunks_per_tile) * KCH;
    const unsigned char* p =
        wb + (((long long)tile * T + col0 + srow) * D + k0) * WB + sbyte;
    v[0] = *reinterpret_cast<const uint4*>(p);
    v[1] = *reinterpret_cast<const uint4*>(p + 64);
  };
  auto store = [&](int buf, const uint4 (&v)[2]) {
    unsigned char* dst = Ws + buf * BN * WROW + srow * WROW;
    const int scale = F::OP / WB;  // shared bytes per stored byte
    stage<FORM>(dst + sbyte * scale, v[0]);
    stage<FORM>(dst + (sbyte + 64) * scale, v[1]);
  };

  uint4 next[2];
  if (n_chunks > 0) {
    fetch(0, next);
    store(0, next);
  }
  __syncthreads();
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int buf = ch & 1;
    if (ch + 1 < n_chunks) fetch(ch + 1, next);
    const int k0 = (ch % chunks_per_tile) * KCH;
    const unsigned char* Wc = Ws + buf * BN * WROW;
#pragma unroll
    for (int kk = 0; kk < KCH; kk += KSTEP) {
      uint32_t af[2][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const unsigned char* r0 = As + (wm * 32 + i * 16 + g) * arow + (k0 + kk) * F::OP;
        const unsigned char* r8 = r0 + 8 * arow;
        af[i][0] = ld32(r0 + tg * 4);
        af[i][1] = ld32(r8 + tg * 4);
        af[i][2] = ld32(r0 + 16 + tg * 4);
        af[i][3] = ld32(r8 + 16 + tg * 4);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const unsigned char* c = Wc + (wn * 32 + j * 8 + g) * WROW + kk * F::OP;
        bf[j][0] = ld32(c + tg * 4);
        bf[j][1] = ld32(c + 16 + tg * 4);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma(acc[i][j], af[i], bf[j]);
    }
    // the other buffer was last read before the previous iteration's barrier
    if (ch + 1 < n_chunks) store(buf ^ 1, next);
    __syncthreads();
  }

  // the block's partial: the fragments' (row g / g + 8, columns tg * 2, + 1)
  Acc* out = part + (long long)s * B * T;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = wm * 32 + i * 16 + g, c = col0 + wn * 32 + j * 8 + tg * 2;
      if (r < B) {
        out[(long long)r * T + c] = acc[i][j][0];
        out[(long long)r * T + c + 1] = acc[i][j][1];
      }
      if (r + 8 < B) {
        out[(long long)(r + 8) * T + c] = acc[i][j][2];
        out[(long long)(r + 8) * T + c + 1] = acc[i][j][3];
      }
    }
}

// o = the splits' partials summed in split order (int32 wrapping mod 2^32)
__global__ void dot_probe_merge_int(const int* __restrict__ part, int* __restrict__ o,
                                    long long n, int splits) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  unsigned int s = 0;
  for (int k = 0; k < splits; ++k) s += (unsigned int)part[k * n + i];
  o[i] = (int)s;
}

__global__ void dot_probe_merge_f32(const float* __restrict__ part, float* __restrict__ o,
                                    long long n, int splits) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += part[k * n + i];
  o[i] = s;
}

template <int FORM>
int shared_bytes(int D) {
  using F = Form<FORM>;
  constexpr int WROW = CHUNK_B / (int)sizeof(typename F::W) * F::OP + PADB;
  return MROWS * (D * F::OP + PADB) + 2 * BN * WROW;
}

template <int FORM>
cudaError_t launch(const void* a, const void* w, void* part, void* o, int B, int D, int T, int NT,
                   int splits, cudaStream_t st) {
  using Acc = typename Form<FORM>::Acc;
  const int smem = shared_bytes<FORM>(D);
  cudaError_t err = cudaFuncSetAttribute(dot_probe_kernel<FORM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dot_probe_kernel<FORM><<<dim3((unsigned)(T / BN), (unsigned)splits), THREADS, smem, st>>>(
      a, w, (Acc*)part, B, D, T, NT, splits);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long n = (long long)B * T;
  const unsigned blocks = (unsigned)((n + 255) / 256);
  if (FORM == FORM_INT8)
    dot_probe_merge_int<<<blocks, 256, 0, st>>>((const int*)part, (int*)o, n, splits);
  else
    dot_probe_merge_f32<<<blocks, 256, 0, st>>>((const float*)part, (float*)o, n, splits);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* dot_probe_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// form 0 = int8 (o int32), 1 = bf16, 2 = int8-stored bf16 dot (o f32);
// part is [splits][B][T] scratch of o's type, splits <= NT
int dot_probe_launch(const void* a, const void* w, void* part, void* o, int form, int B, int D,
                     int T, int NT, int splits, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (form == FORM_INT8)
    return (int)launch<FORM_INT8>(a, w, part, o, B, D, T, NT, splits, st);
  if (form == FORM_BF16)
    return (int)launch<FORM_BF16>(a, w, part, o, B, D, T, NT, splits, st);
  return (int)launch<FORM_I8ST>(a, w, part, o, B, D, T, NT, splits, st);
}

}  // extern "C"
