// The matrix-unit probe for NVIDIA Hopper (sm_90a): o[b, t] = sum over NT
// tiles i and over d of a[b, d] * w[i, t, d], on the tensor cores, in three
// forms:
//   int8  - a, w int8, products and sums in int32 (wgmma s8 m64n256k32; the
//           sum wraps mod 2^32 as JAX's int32 accumulator does);
//   bf16  - a, w bf16, f32 sums (wgmma bf16 m64n256k16);
//   i8st  - a bf16, w stored int8 and widened to bf16 in registers (exact
//           for -128..127), f32 sums (the int8-queue path's dot; wgmma bf16
//           m64n128k16 with A from registers).
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
// w; i8st, bf16 products on int8 bytes, needs the tensor cores at 86 % of
// their bf16 rate to keep up with them.
//
// Design: a stream of w whose copies never wait on its products. The TPU
// walked the NT tiles in order and carried the [B, T] sum in its output
// block. Here the K axis (NT tiles x D) is cut into chunks of 128 bytes of
// a w row (64 bf16 or 128 int8 k), and a block owns BN = 256 columns of T
// and a contiguous range of the chunks (a split): grid (ceil(T / 256),
// splits), the geometry (probe_geometry, mirrored by
// tools/probe_int8_mxu.py: probe_geometry) choosing splits so that the grid
// fills the card (4 x 33 = 132 blocks on 132 SMs at the probe's shapes;
// splits cut chunks, not whole tiles, so they differ by one chunk at most).
//  * a stays resident: all 128 rows (zeros past B) are staged once, K-major
//    in 128-byte-swizzled rows (wgmma.cuh), 128 KB in bf16, 64 KB in int8.
//  * One producer thread (a warp of its own) stages each chunk of w, [256
//    rows][128 bytes] (i8st: 128 rows), by one TMA box (128-byte swizzle;
//    rows past T arrive as zeros) into a ring of nst stages (at D = 512:
//    3 in bf16, 5 in int8, 6 of 16 KB in i8st; 96 / 160 / 96 KB in flight)
//    on full / empty mbarriers. No block-wide barrier in the loop.
//  * Two consumer warpgroups. bf16 and int8: warpgroup c's 64 rows of a (A,
//    by descriptor) times the chunk's 256 rows of w (B, by descriptor), 4
//    wgmma a chunk chained in the accumulator across the split; a stage is
//    released when the next chunk's products are issued. i8st swaps the
//    roles, since wgmma's B must be bf16 in shared memory: warpgroup c's
//    64 rows of a 128-row stage of w are A, read by ldmatrix out of the
//    stage and widened to bf16 in registers (the s8 fragment of one k32
//    step is, widened, the bf16 fragments of two k16 steps whose k are
//    permuted within each 16), and a is B, staged with each 16 k in that
//    permutation (stage_a); a stage is released as soon as its rows are in
//    registers; a chunk's 8 products are one group, waited out before the
//    next chunk's fragments are loaded. 64 accumulators a thread, not 128
//    (at 128 with the fragments ptxas spilled and serialized the
//    products): the block walks its 256 columns as two halves of 128, each
//    over the whole split, a resident for both.
//  * Each split writes a partial [splits][B][T] (bf16, int8: through the
//    freed shared memory, as 16-byte pieces of whole rows); a second launch
//    sums the splits in order (int32 wrapping mod 2^32, f32 in split
//    order): no float atomics, the same bits on every run.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"  // smem_u32, ldsm_x4, widen4
#include "wgmma.cuh"

namespace {

constexpr int FORM_INT8 = 0, FORM_BF16 = 1, FORM_I8ST = 2;
constexpr int CW = 2;                   // consumer warpgroups
constexpr int THREADS = 128 * CW + 32;  // and one producer warp
constexpr int MROWS = 128;               // rows of a a block holds
constexpr int BN = 256;                  // columns of T a block
constexpr int ROWB = 128;                // bytes of a staged row: one swizzled line
constexpr int MAX_SMEM = 232448;         // a block's dynamic shared memory on sm_90
constexpr int MAX_NST = 8;
constexpr int TAIL = 1024 + 2 * MAX_NST * 8;  // alignment, the ring's barriers
constexpr int PART_LD = BN * 4 + 16;          // a partial row's bytes in shared memory

// the accumulator, and the bytes of an element of a (AB) and of stored w (WB)
template <int FORM> struct Form;
template <> struct Form<FORM_INT8> {
  using Acc = int;
  static constexpr int AB = 1, WB = 1;
};
template <> struct Form<FORM_BF16> {
  using Acc = float;
  static constexpr int AB = 2, WB = 2;
};
template <> struct Form<FORM_I8ST> {
  using Acc = float;
  static constexpr int AB = 2, WB = 1;
};

// The launch of one probe: grid (n_col, splits), k values a chunk, ring
// stages, dynamic shared memory. false where the contract does not hold.
struct Geometry {
  int n_col, splits, kc, nst, smem;
};

// a stage's bytes: 256 rows of w, 128 in i8st (dot_probe_kernel: RB)
constexpr int stage_bytes(int form) { return (form == FORM_I8ST ? BN / 2 : BN) * ROWB; }
// the bf16 and int8 partial's rows fit where a and the ring were (they
// hold at least all but one stage of the shared memory)
static_assert(MAX_SMEM - TAIL - stage_bytes(FORM_BF16) >= MROWS * PART_LD,
              "the partial does not fit");

bool probe_geometry(int form, int B, int D, int T, int NT, int n_sm, Geometry& g) {
  const int ab = form == FORM_INT8 ? 1 : 2, wb = form == FORM_BF16 ? 2 : 1;
  g.kc = ROWB / wb;
  g.n_col = (T + BN - 1) / BN;
  const long long n_q = (long long)NT * (D / g.kc);  // chunks along K
  const long long fill = n_sm / g.n_col;  // splits that fill the SMs
  g.splits = (int)(fill < 1 ? 1 : fill < n_q ? fill : n_q);
  const int a_bytes = MROWS * D * ab;
  g.nst = (MAX_SMEM - TAIL - a_bytes) / stage_bytes(form);
  if (g.nst > MAX_NST) g.nst = MAX_NST;
  g.smem = a_bytes + g.nst * stage_bytes(form) + TAIL;
  return B >= 1 && B <= MROWS && T >= 64 && T % 64 == 0 && D >= 128 && D % 128 == 0 &&
         D <= 512 && NT >= 1 && g.nst >= 2;
}

// a (rows past B zero) into As as the products read it: K-major rows of 128
// bytes, k block kb (64 bf16 or 128 int8 k) of all MROWS rows at As + kb *
// MROWS * 128, row r's 16-byte chunk j at j ^ (r & 7). i8st stores each 16
// k in the order of the widened fragments (header): a's words (pairs of k)
// 0, 2, 4, 6, 1, 3, 5, 7.
template <int FORM>
__device__ __forceinline__ void stage_a(unsigned char* As, const unsigned char* a, int B, int D) {
  const int row_bytes = D * Form<FORM>::AB, units = row_bytes / 32;  // 32-byte units a row
  for (int i = threadIdx.x; i < MROWS * units; i += THREADS) {
    const int r = i / units, u = i - r * units;
    uint4 v0 = make_uint4(0, 0, 0, 0), v1 = v0;
    if (r < B) {
      const uint4* src = reinterpret_cast<const uint4*>(a + (long long)r * row_bytes + 32 * u);
      v0 = src[0];
      v1 = src[1];
    }
    if (FORM == FORM_I8ST) {
      const uint4 p0 = make_uint4(v0.x, v0.z, v1.x, v1.z), p1 = make_uint4(v0.y, v0.w, v1.y, v1.w);
      v0 = p0;
      v1 = p1;
    }
    const int kb = 32 * u / ROWB, j = 32 * u % ROWB / 16;  // k block, first chunk
    unsigned char* row = As + kb * MROWS * ROWB + r * ROWB;
    *reinterpret_cast<uint4*>(row + ((j ^ (r & 7)) << 4)) = v0;
    *reinterpret_cast<uint4*>(row + (((j + 1) ^ (r & 7)) << 4)) = v1;
  }
}

template <int FORM>
__global__ void __launch_bounds__(THREADS, 1)
    dot_probe_kernel(const __grid_constant__ CUtensorMap tmw, const unsigned char* __restrict__ a,
                     typename Form<FORM>::Acc* __restrict__ part, int B, int D, int T, int NT,
                     int splits, int nst) {
  using F = Form<FORM>;
  constexpr int KC = ROWB / F::WB;                 // k values a chunk
  constexpr int RB = FORM == FORM_I8ST ? 128 : BN;  // w rows a stage
  constexpr int HALVES = BN / RB;                   // the block's passes over its split
  constexpr int STG = RB * ROWB;                    // a stage's bytes
  extern __shared__ __align__(16) unsigned char probe_smem[];
  unsigned char* As = probe_smem + ((1024 - (smem_u32(probe_smem) & 1023)) & 1023);
  unsigned char* Ws = As + MROWS * D * F::AB;  // the ring: nst stages of [RB][ROWB]
  uint64_t* full = reinterpret_cast<uint64_t*>(Ws + nst * STG);
  uint64_t* empty = full + MAX_NST;

  const int tid = threadIdx.x, col0 = blockIdx.x * BN, s = blockIdx.y;
  const int kpc = D / KC;  // chunks a tile
  const long long n_q = (long long)NT * kpc;
  const long long q_lo = n_q * s / splits;
  const int n = (int)(n_q * (s + 1) / splits - q_lo);  // this split's chunks
  const int halves = T - col0 > RB ? HALVES : 1;        // no half wholly past T

  stage_a<FORM>(As, a, B, D);
  fence_proxy_async();  // a's writes, before the products read it
  if (tid == 0) {
    for (int st = 0; st < nst; ++st) {
      mbar_init(&full[st], 1);            // the producer's arrival; then the copy's bytes
      mbar_init(&empty[st], 128 * CW);  // every consumer thread
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= 128 * CW) {  // the producer warp: one thread starts the copies
    if (tid == 128 * CW) {
      for (int c = 0; c < halves * n; ++c) {  // the half c / n's chunk c % n
        const int st = c % nst;
        if (c >= nst) mbar_wait(&empty[st], (c / nst - 1) & 1);
        const long long q = q_lo + c % n;
        const int tile = (int)(q / kpc), k0 = (int)(q - (long long)tile * kpc) * KC;
        mbar_expect_tx(&full[st], STG);
        tma_load_3d(Ws + st * STG, &tmw, k0, col0 + RB * (c / n), tile, &full[st]);
      }
    }
    return;
  }

  const int cw = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, t = lane & 3;
  typename F::Acc* out = part + (long long)s * B * T;
  if constexpr (FORM != FORM_I8ST) {
    // warpgroup cw: rows 64 cw .. 64 cw + 63 of a x the block's 256 columns
    typename F::Acc acc[128];
#pragma unroll
    for (int e = 0; e < 128; ++e) {
      acc[e] = 0;
      fence_operand(acc[e]);  // zeroed before the first product, not among them
    }
    const uint32_t a_wg = smem_u32(As) + cw * 64 * ROWB;
    for (int i = 0; i < n; ++i) {
      const int st = i % nst;
      mbar_wait(&full[st], (i / nst) & 1);
      const uint32_t a_kb = a_wg + (int)((q_lo + i) % kpc) * MROWS * ROWB;
      const uint32_t wa = smem_u32(Ws + st * STG);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {  // 32 bytes of K a product
        const uint64_t da = sw128_desc(a_kb + 32 * ks, 16, 1024);
        const uint64_t db = sw128_desc(wa + 32 * ks, 16, 1024);
        if constexpr (FORM == FORM_INT8)
          wgmma_ss_m64n256k32_s8(acc, da, db, 1);
        else
          wgmma_ss_m64n256k16(acc, da, db, 1);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous chunk's products done: its stage is free
      if (i > 0) mbar_arrive(&empty[(i - 1) % nst]);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int e = 0; e < 128; ++e) fence_operand(acc[e]);
    // the partial through shared memory (a and the ring are free once both
    // warpgroups are done): row 16 warp + g + 8 h of the warpgroup's,
    // columns 8 i + 2 t, + 1, into rows of PART_LD bytes; then 16-byte
    // pieces of whole rows
    asm volatile("bar.sync 1, %0;\n" ::"n"(128 * CW) : "memory");
    unsigned char* pt = As;
#pragma unroll
    for (int i = 0; i < 32; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        typename F::Acc* o = reinterpret_cast<typename F::Acc*>(
            pt + (64 * cw + 16 * warp + g + 8 * h) * PART_LD + 4 * (8 * i + 2 * t));
        o[0] = acc[4 * i + 2 * h];
        o[1] = acc[4 * i + 2 * h + 1];
      }
    asm volatile("bar.sync 1, %0;\n" ::"n"(128 * CW) : "memory");
    for (int q = tid; q < B * (BN / 4); q += 128 * CW) {  // row q / 64, columns 4 (q % 64) ..
      const int row = q / (BN / 4), col = col0 + 4 * (q % (BN / 4));
      if (col < T)
        *reinterpret_cast<uint4*>(out + (long long)row * T + col) =
            *reinterpret_cast<const uint4*>(pt + row * PART_LD + 16 * (q % (BN / 4)));
    }
  } else {
    // the block's 256 columns as two halves of 128, one after the other over
    // the split (a stays); warpgroup cw: w rows 64 cw .. + 63 of the half
    // (the products' rows, A) x all 128 rows of a (B)
    const uint32_t a_all = smem_u32(As);
#pragma unroll
    for (int half = 0; half < HALVES; ++half) {  // unrolled: a runtime loop spilled acc
      if (half >= halves) break;
      float acc[64];
#pragma unroll
      for (int e = 0; e < 64; ++e) {
        acc[e] = 0.f;
        fence_operand(acc[e]);  // zeroed before the first product, not among them
      }
      for (int i = 0; i < n; ++i) {
        const int c = half * n + i, st = c % nst;  // the ring's sequence runs on over the halves
        mbar_wait(&full[st], (c / nst) & 1);
        const int kk0 = (int)((q_lo + i) % kpc) * (KC / 16);  // the chunk's first k16 step of a
        const unsigned char* Wc = Ws + st * STG;
        uint32_t fa[KC / 32][2][4];  // per k32 step of the stored int8, its two k16 fragments
#pragma unroll
        for (int j = 0; j < KC / 32; ++j) {
          const int r = 64 * cw + 16 * warp + (lane & 15), ch = 2 * j + (lane >> 4);
          uint32_t v[4], lo[4], hi[4];
          ldsm_x4(v, Wc + r * ROWB + ((ch ^ (r & 7)) << 4));
#pragma unroll
          for (int q = 0; q < 4; ++q) widen4(v[q], lo[q], hi[q]);
          // v: rows g, g + 8 of chunk 2 j, then of 2 j + 1; k 4t .. 4t + 3 each
          fa[j][0][0] = lo[0], fa[j][0][1] = lo[1], fa[j][0][2] = hi[0], fa[j][0][3] = hi[1];
          fa[j][1][0] = lo[2], fa[j][1][1] = lo[3], fa[j][1][2] = hi[2], fa[j][1][3] = hi[3];
        }
        mbar_arrive(&empty[st]);  // the stage's rows are in registers
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < KC / 32; ++j)
#pragma unroll
          for (int sub = 0; sub < 2; ++sub) {
            const int kk = kk0 + 2 * j + sub;
            const uint32_t b_kk = a_all + (kk >> 2) * MROWS * ROWB + 32 * (kk & 3);
            wgmma_rs_m64n128k16_kmajor(acc, fa[j][sub], sw128_desc(b_kk, 16, 1024), 1);
          }
        wgmma_commit();
        // done before fa is loaded again: a product reads its A registers
        // until it completes, and nothing else keeps them (a group left in
        // flight over the next chunk's loads gave wrong sums)
        wgmma_wait<0>();
      }
#pragma unroll
      for (int e = 0; e < 64; ++e) fence_operand(acc[e]);
      // the half's partial, transposed: column 128 half + 64 cw + 16 warp + g
      // + 8 h of the block's, rows (of a) 8 i + 2 t, + 1
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = col0 + RB * half + 64 * cw + 16 * warp + g + 8 * h;
        if (col >= T) continue;
#pragma unroll
        for (int i = 0; i < 16; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int row = 8 * i + 2 * t + e;
            if (row < B) out[(long long)row * T + col] = acc[4 * i + 2 * h + e];
          }
      }
    }
  }
}

// o = the splits' partials summed in split order, 4 outputs a thread
// (int32 wrapping mod 2^32; f32)
__global__ void dot_probe_merge_int(const uint4* __restrict__ part, uint4* __restrict__ o,
                                    long long n4, int splits) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  uint4 s = make_uint4(0, 0, 0, 0);
  for (int k = 0; k < splits; ++k) {
    const uint4 v = part[k * n4 + i];
    s.x += v.x, s.y += v.y, s.z += v.z, s.w += v.w;
  }
  o[i] = s;
}

__global__ void dot_probe_merge_f32(const float4* __restrict__ part, float4* __restrict__ o,
                                    long long n4, int splits) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k = 0; k < splits; ++k) {
    const float4 v = part[k * n4 + i];
    s.x += v.x, s.y += v.y, s.z += v.z, s.w += v.w;
  }
  o[i] = s;
}

template <int FORM>
cudaError_t launch(const Geometry& g, const void* a, const void* w, void* part, void* o, int B,
                   int D, int T, int NT, cudaStream_t st) {
  using F = Form<FORM>;
  // w as [NT][T][D] in boxes [1][256 or 128 rows][128 bytes], 128-byte swizzled; rows past T zero
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorInvalidValue;
  CUtensorMap tmw;
  const cuuint64_t item = F::WB;
  const cuuint64_t dim[3] = {(cuuint64_t)D, (cuuint64_t)T, (cuuint64_t)NT};
  const cuuint64_t str[2] = {(cuuint64_t)D * item, (cuuint64_t)T * D * item};
  const cuuint32_t box[3] = {(cuuint32_t)g.kc, (cuuint32_t)(stage_bytes(FORM) / ROWB), 1};
  const cuuint32_t ones[3] = {1, 1, 1};
  if (encode(&tmw, item == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8, 3,
             const_cast<void*>(w), dim, str, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(dot_probe_kernel<FORM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);
  if (err != cudaSuccess) return err;
  dot_probe_kernel<FORM><<<dim3((unsigned)g.n_col, (unsigned)g.splits), THREADS, g.smem, st>>>(
      tmw, (const unsigned char*)a, (typename F::Acc*)part, B, D, T, NT, g.splits, g.nst);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long n4 = (long long)B * T / 4;
  const unsigned blocks = (unsigned)((n4 + 255) / 256);
  if (FORM == FORM_INT8)
    dot_probe_merge_int<<<blocks, 256, 0, st>>>((const uint4*)part, (uint4*)o, n4, g.splits);
  else
    dot_probe_merge_f32<<<blocks, 256, 0, st>>>((const float4*)part, (float4*)o, n4, g.splits);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* dot_probe_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// the launch geometry (out[5]: column tiles, splits, k a chunk, ring stages,
// shared memory) of a probe on n_sm SMs; 0, or cudaErrorInvalidValue where
// the contract does not hold
int dot_probe_geometry(int form, int B, int D, int T, int NT, int n_sm, int* out) {
  Geometry g;
  const bool ok = probe_geometry(form, B, D, T, NT, n_sm, g);
  const int v[5] = {g.n_col, g.splits, g.kc, g.nst, g.smem};
  for (int i = 0; i < 5; ++i) out[i] = v[i];
  return ok ? 0 : (int)cudaErrorInvalidValue;
}

// form 0 = int8 (o int32), 1 = bf16, 2 = int8-stored bf16 dot (o f32);
// part is [splits][B][T] scratch of o's type (dot_probe_geometry on n_sm SMs)
int dot_probe_launch(const void* a, const void* w, void* part, void* o, int form, int B, int D,
                     int T, int NT, int n_sm, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  Geometry g;
  if (!probe_geometry(form, B, D, T, NT, n_sm, g)) return (int)cudaErrorInvalidValue;
  if (form == FORM_INT8) return (int)launch<FORM_INT8>(g, a, w, part, o, B, D, T, NT, st);
  if (form == FORM_BF16) return (int)launch<FORM_BF16>(g, a, w, part, o, B, D, T, NT, st);
  return (int)launch<FORM_I8ST>(g, a, w, part, o, B, D, T, NT, st);
}

}  // extern "C"
