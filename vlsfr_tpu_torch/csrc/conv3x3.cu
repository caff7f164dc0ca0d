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
// Layout: x [B][H][W][C], w [3][3][C][wld] (HWIO, JAX's layout, already cast
// to x's type by the wrapper; wld = Cout, or Cout rounded up to 8 with zero
// columns for the streamed and f32 kernels), y [B][H][W][Cout], all
// contiguous, f32 or bf16. y is rounded once from the f32 sum,
// round-to-nearest-even.
//
// Bound (H100 SXM): 2 * B*H*W * 9*C*Cout FLOP against x read and y written
// once. The bench's C = 64 shapes are bytes-bound (0.03-0.12 ms at 3.35
// TB/s); C = 128 at 28^2 and C = 256 / 512 at 14^2 operations-bound at the
// 989 TFLOP/s bf16 rate (0.030, 0.030, 0.120 ms); the f32 form at the 67
// TFLOP/s f32 rate (0.442 ms at [128, 56, 56, 64]).
//
// Four kernels, one geometry (conv_geometry: the kernel, its grid, shared
// memory and statistics partials, mirrored by ops/conv3x3.py:
// conv_geometry). Each is an implicit GEMM: M = output pixels, N = output
// channels, K = 9 * C. The SAME padding is a zero load: no spatially padded
// copy of x is made. mode selects the order of K: taps9 walks tap-major
// (JAX's nine accumulating dots), im2col channel-major (the order of
// PyTorch's unfold), each kernel at its own granularity below. Statistics:
// the block reduces its threads' per-channel sums in a fixed order into one
// partial per (block, channel), part [n_parts][2][Cout]; a second launch
// sums the partials in block order (a warp an output, in 32 runs of
// consecutive blocks). No float atomics: the result is the same on every
// run.
//
// Resident bf16 (conv3x3_bf16_kernel), where the block's weight slice fits
// beside a halo row (C <= 144 at W <= 112): grid (B * H / strip, Cout / 64),
// one block an (image, strip) pair x 64 output channels; mma.sync
// m16n8k16 (csrc/mma_bf16.cuh).
//  * The weight slice, rows (tap, c) of K padded to C16 = C rounded up to
//    16, x 64 channels, is staged once (73.7 KB at C = 64, 147 KB at C =
//    128) and kept across the strip.
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
//    channel-major), chained in the tensor core's accumulator.
//  * 8 warps: 4 along the pixels, each up to 6 m16 slices (taken round
//    robin, so a short group spreads over the warps), x 2 along the
//    channels, 32 each; a slice past the group's pixels is skipped.
//  * Statistics: each thread sums its fragment values (rows g, g + 8 of each
//    m16 slice; two channels per n8 tile) over the block's pixels, the 8
//    lanes that share a channel combine by fixed xor shuffles, and the 4
//    pixel warps in order.
//
// Streamed bf16 (conv3x3_bf16_stream_kernel), every other C (C = 200 at
// any W, 256 and 512): wgmma m64n128k16 (csrc/wgmma.cuh). The grid no
// longer follows strip: a block owns a tile of S_BM = 128 output pixels
// taken in order over all B * H * W (so a tile spans images: 16 images of
// 14^2 are 49 tiles of 64 rows, and [128, 14, 14, C] is 196 tiles with no
// row wasted; only the last tile of a ragged B * H * W is partly masked)
// x S_BN = 128 output channels.
//  * The tile's halo is a range of virtual rows (each image's H + 2 padded
//    rows in order, so that a tile crossing images still reads one
//    contiguous range), at most halo_rows(H, W, S_BM) rows of W + 2 pixels.
//  * K is cut into chunks of CCH = 32 (or 16) channels. One producer
//    thread stages each chunk's weight rows ([9 CCH][128]: two TMA boxes of
//    64 columns, 128-byte swizzled, wgmma's MN-major B layout) and its halo
//    (a TMA box [W + 2][CCH] a virtual row, 64- or 32-byte swizzled: the
//    layout halo_off reads; the padding, rows past the images and channels
//    past C or Cout arrive as zeros) into a ring of nst stages (2-4 as
//    fit); a stage's copies complete on its `full` mbarrier, and the
//    consumers release it on its `empty` mbarrier. No block-wide barrier
//    in the loop.
//  * Two consumer warpgroups, 64 pixel rows each: per k16 step (one tap x
//    16 channels) a warp's A fragment is one ldmatrix x4 out of the halo (a
//    lane's row is its pixel's halo index plus the tap's offset: A's rows
//    are not uniformly strided, so A comes from registers), and B is a
//    descriptor into the stage. A chunk's 9 CCH / 16 steps (taps9:
//    tap-major, im2col: channel-major) chain in the wgmma accumulator from
//    zero; the chunk's sum is then added to an f32 sum in registers,
//    rounded to nearest (a chain of all 288 steps at C = 512 would drift in
//    the truncating accumulator: mma_bf16.cuh's header), and the stage is
//    released. Two 64-register sets a thread; the producer warpgroup gives
//    its registers to the consumers (setmaxnreg).
//  * The epilogue rounds y once into shared memory (the stages' space) and
//    stores 16-byte pieces of rows; the statistics come from the final
//    sums: the 8 lanes of a channel by fixed xor shuffles, then the 8 warps
//    in order.
//
// f32 (conv3x3_f32_kernel): IEEE f32 FMA ("f32 means f32": no TF32, no
// tensor cores). The grid no longer follows strip: a block owns F_BM = 256
// output pixels taken in order over all B * H * W x F_BN = 64 output
// channels, 256 threads, an F_TI x F_TJ = 8 x 8 register tile each.
//  * K is cut into chunks of F_CCH = 8 channels; thread 0 stages each
//    chunk's weight rows ([9 F_CCH][64], one TMA box) and halo ([vr][W +
//    2][F_CCH], a TMA box a virtual row as above, each pixel's 8 channels
//    once, not gathered per tap) through nst = 2-4 stages on `full`
//    mbarriers, the next chunks' copies under this chunk's FMAs; one block
//    barrier a chunk frees the stage the next copy fills.
//  * Orientation: the 16-byte reads run along channels of a pixel (A) and
//    along w's contiguous Cout axis (B), so no tap offset misaligns them. A
//    thread's 8 pixels are ty + 32 i (ty the same in a quarter warp: A
//    reads are broadcasts; the four quarters' pixels, 32 bytes apart, on
//    different banks) and its 8 channels 4 tx .. + 3 and 32 + 4 tx .. + 3
//    (8 consecutive float4 of one w row a quarter warp: no bank conflict).
//  * Per 4 channels of a tap: 8 float4 of A, 8 of B, 256 FMA: 1 byte of
//    shared memory per FMA. Each output is one fmaf chain: chunks in
//    channel order, within a chunk taps9 tap-major over 4-channel steps,
//    im2col channel-major.
//  * Statistics: a thread's 8 pixels, the 4 lanes of a channel set by xor
//    shuffles, the 8 warps in order.
//
// Stem bf16 (conv3x3_stem_kernel), C < 8 (ir50's stem, C = 3): bound by
// writing y (205.5 of the 215 MB at [128, 112, 112, 3] -> 64), so x is read
// at its own C (no padded copy) and K = 9 C real values is padded only to a
// whole k16 step (27 -> 32), not to 9 x 16.
//  * ST_BLOCKS = 264 persistent blocks (two an SM), block x a contiguous
//    range of tiles of ST_BM = 128 output pixels in order over all B * H *
//    W, block y 64 output channels; the block's weight rows [9 C][64] in
//    the mode's K order are staged once.
//  * A tile's halo is one contiguous range of x (pixels p0 - W - 1 .. p0 +
//    128 + W: W C values a row, 672 bytes at W = 112), staged by 16-byte
//    cp.async, the next tile's under this tile's work.
//  * Each pixel's K vector (taps9: k = tap C + c, im2col: k = c 9 + tap;
//    zeros for the SAME padding, by a mask of the taps inside the image,
//    and past 9 C) is built into an A tile [128][64 k] in shared memory; 8
//    warps x 16 pixels x 64 channels on mma.sync m16n8k16, each output one
//    chain of its 2-4 k16 steps.
//  * One block barrier a tile (the halo landed; the next halo's copies are
//    issued right after it). Past it each warp builds, multiplies and
//    stores its own 16 pixels: y is rounded once into the warp's rows of a
//    y tile in shared memory and stored in 16-byte pieces of whole pixel
//    rows (at Cout = 64 a warp's 2 KB of y is one contiguous range). The
//    statistics are summed over the block's tiles in registers: one
//    partial a block.
//
// bf16 C of 8 or more must be a multiple of 8 and f32 C of 4 (16-byte
// pieces of a pixel's channels: the resident kernel's cp.async, the TMA
// boxes' rows): the wrapper pads x's (and w's) channel axis with zeros once
// where it is not, as JAX's wrapper pads x's spatial halo, and the zero
// channels add nothing to the sums. The streamed and f32 kernels take W <=
// 254 (a halo row is one TMA box).

#include <cuda.h>  // CUtensorMap; cuTensorMapEncodeTiled comes from the runtime: no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_bf16.cuh"
#include "wgmma.cuh"

namespace {

constexpr int BN = 64;       // the resident kernel's output channels per block
constexpr int THREADS = 256;
constexpr int MODE_TAPS9 = 0, MODE_IM2COL = 1;
constexpr int KIND_F32 = 0, KIND_RESIDENT = 1, KIND_STREAMED = 2, KIND_STEM = 3;

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

// output rows a halo stage holds: as many as fit (smem(tr) <= the block's
// shared memory), at most one pass of pixels and the strip; 0 where none fits
template <class F>
int fit_rows(int W, int strip, F smem) {
  int tr = min(strip, max(1, PASS_PX / W));
  while (tr > 0 && smem(tr) > BF16_MAX_SMEM) --tr;
  return tr;
}

// The resident plan of a bf16 launch, where the weight slice fits beside a
// halo stage of one row: two stages (the next group's copies under this
// group's products) where they still hold 8 m16 slices (two a pixel warp),
// else one stage of more rows (its copies wait, ~5 % of a group at C =
// 128). tr = 0 where it does not fit: the streamed kernel takes the launch.
void resident_plan(int C, int W, int strip, int& tr, int& n_st) {
  n_st = 2;
  tr = fit_rows(W, strip, [&](int r) { return bf16_smem(C, W, r, 2); });
  if (tr * W < 128) {
    n_st = 1;
    tr = fit_rows(W, strip, [&](int r) { return bf16_smem(C, W, r, 1); });
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
// in the mode's order of k16 steps (taps9: tap-major, im2col: channel-major),
// chained in the tensor core's accumulator (36-72 steps at C = 64-128)
template <int MODE>
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
        mma_bf16(acc[j][2 * nj], a[j], b[0], b[1]);
        mma_bf16(acc[j][2 * nj + 1], a[j], b[2], b[3]);
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
      pass_mma<MODE>(acc, buf, rc, m, hp, live, WP, Ws, CP, CB);
      store_pass<STATS>(acc, y, n, H, W, gr0, p0, npix, Cout, co0, s1, s2);
    }
    __syncthreads();  // the next group's copies go into this group's stage
    if (n_st == 1 && gi + 1 < n_groups) stage(gi + 1);
  }
  cp_async_wait<0>();
  if (STATS) store_stats(s1, s2, red, part, Cout, co0);
}

// ---------------------------------------------- tiles over all B * H * W

// virtual rows (each image's H + 2 padded rows, in image order) that the
// halo of px consecutive output pixels can span: the image rows they touch,
// two padded rows at each image boundary among them, and the rows above
// and below
__host__ __device__ constexpr int halo_rows(int H, int W, int px) {
  return (px + 2 * W - 2) / W + 2 * (((px + 2 * W - 2) / W - 1 + H - 1) / H) + 2;
}

// A tile's output pixels [p0, p0 + px) ∩ [0, B H W): v_lo, its halo's
// first virtual row (image row h0 - 1 of the first pixel's image), and the
// virtual rows its halo spans
__device__ __forceinline__ void tile_halo(long long p0, int px, long long npx, int H, int W,
                                          int& v_lo, int& n_vr) {
  const long long HW = (long long)H * W, p1 = min(p0 + px, npx) - 1;
  const int n0 = (int)(p0 / HW), h0 = (int)(p0 - n0 * HW) / W;
  const int n1 = (int)(p1 / HW), h1 = (int)(p1 - n1 * HW) / W;
  v_lo = n0 * (H + 2) + h0;
  n_vr = n1 * (H + 2) + h1 + 3 - v_lo;
}

// output pixel p's halo index in a tile's halo from virtual row v_lo, wp
// pixels a row (0 for a pixel past the images: any staged row)
__device__ __forceinline__ int halo_index(long long p, long long npx, int H, int W, int wp,
                                          int v_lo) {
  if (p >= npx) return 0;
  const long long HW = (long long)H * W;
  const int n = (int)(p / HW), r = (int)(p - n * HW), h = r / W;
  return (n * (H + 2) + h - v_lo) * wp + r - h * W;
}

// --------------------------------------------- the streamed bf16 kernel

constexpr int S_CW = 2;                      // consumer warpgroups
constexpr int S_THREADS = 128 * (S_CW + 1);  // and one producer warpgroup
constexpr int S_BM = 64 * S_CW;              // a tile's output pixels
constexpr int S_BN = 128;                    // a tile's output channels
constexpr int S_MAX_NST = 4;
constexpr int S_TAIL = 1024 + 2 * 4 * S_CW * S_BN * 4 + 2 * S_MAX_NST * 8;  // align, red, barriers
constexpr int Y_LD = S_BN * 2 + 16;  // a y row's bytes in shared memory (the stages' space)

// the halo's pixels a virtual row: W + 2, rounded up to 8 so that every row
// (a TMA box) starts on the period of the halo's swizzle
__host__ __device__ constexpr int stream_wp(int W) { return (W + 2 + 7) / 8 * 8; }

// a stage: the weight rows [9 cch][S_BN] (two 64-column halves), then the
// halo [vr stream_wp(W)][cch], 1024-byte aligned
__host__ __device__ constexpr int stream_stage(int cch, int W, int vr) {
  return (9 * cch * S_BN * 2 + vr * stream_wp(W) * cch * 2 + 1023) / 1024 * 1024;
}

// byte offset of chunk ch (8 channels) of halo pixel r, rc chunks a pixel
// (rc = 2 or 4): chunk ch ^ (r rc / 8 mod rc), so the eight consecutive
// pixels one ldmatrix address group reads fall in eight bank groups. This
// is TMA's 64-byte (rc = 4) and 32-byte (rc = 2) swizzle of rows of rc
// chunks on a 512-byte-aligned halo.
__device__ __forceinline__ int halo_off(int r, int ch, int rc) {
  return (r * rc + (ch ^ ((r * rc >> 3) & (rc - 1)))) << 4;
}

// Streamed: a producer thread stages the tile's channel chunks by TMA
// through nst stages (full / empty mbarriers): tmw is w as [9][C][wld] in
// boxes [9][CCH][64] (128-byte swizzle), tmx is x as [B][H][W][C] in boxes of
// one image row, columns -1 .. W, CCH channels (64- or 32-byte swizzle);
// two consumer warpgroups chain each chunk's k16 steps in the wgmma
// accumulator and add it to an f32 sum; the epilogue rounds y once and
// takes the statistics (header).
template <int MODE, bool STATS, int CCH>
__global__ void __launch_bounds__(S_THREADS, 1)
    conv3x3_bf16_stream_kernel(const __grid_constant__ CUtensorMap tmw,
                               const __grid_constant__ CUtensorMap tmx,
                               __nv_bfloat16* __restrict__ y, float* __restrict__ part, int B,
                               int H, int W, int C, int Cout, int nst, int vr) {
  constexpr int CB = CCH / 16, RC = CCH / 8;
  constexpr int W_BYTES = 9 * CCH * S_BN * 2, HALF = W_BYTES / 2;  // the weights' 64-column halves
  extern __shared__ __align__(16) unsigned char conv_smem[];
  unsigned char* base = conv_smem + ((1024 - (smem_u32(conv_smem) & 1023)) & 1023);
  const int stage_bytes = stream_stage(CCH, W, vr);
  float* red = reinterpret_cast<float*>(base + nst * stage_bytes);  // [2][4 S_CW][S_BN]
  uint64_t* full = reinterpret_cast<uint64_t*>(red + 2 * 4 * S_CW * S_BN);
  uint64_t* empty = full + S_MAX_NST;

  const int tid = threadIdx.x, WP = stream_wp(W);
  const long long npx = (long long)B * H * W, p0 = (long long)blockIdx.x * S_BM;
  const int co0 = blockIdx.y * S_BN, n_ch = (C + CCH - 1) / CCH;
  int v_lo, n_vr;
  tile_halo(p0, S_BM, npx, H, W, v_lo, n_vr);
  if (tid == 0) {
    for (int s = 0; s < nst; ++s) {
      mbar_init(&full[s], 1);            // the producer's arrival; then its copies' bytes
      mbar_init(&empty[s], 128 * S_CW);  // every consumer thread
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= 128 * S_CW) {  // the producer warpgroup: one thread starts the copies
    regs_dealloc<40>();
    if (tid == 128 * S_CW) {
      for (int i = 0; i < n_ch; ++i) {
        const int s = i % nst, c0 = i * CCH;
        if (i >= nst) mbar_wait(&empty[s], (i / nst - 1) & 1);
        unsigned char* Ws = base + s * stage_bytes;
        unsigned char* Xs = Ws + W_BYTES;
        mbar_expect_tx(&full[s], W_BYTES + n_vr * (W + 2) * CCH * 2);
        tma_load_3d(Ws, &tmw, co0, c0, 0, &full[s]);  // the weight rows, each half
        tma_load_3d(Ws + HALF, &tmw, co0 + 64, c0, 0, &full[s]);
        for (int r = 0; r < n_vr; ++r) {  // the halo, a virtual row (image n, row hh) a box
          const int v = v_lo + r, n = v / (H + 2), hh = v - n * (H + 2) - 1;
          tma_load_4d(Xs + r * WP * CCH * 2, &tmx, c0, -1, hh, n, &full[s]);
        }
      }
    }
  } else {  // the consumer warpgroups: 64 pixel rows each
    regs_alloc<232>();
    const int cw = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
    const int m0 = 64 * cw + 16 * warp;  // the warp's first row
    const int hp = halo_index(p0 + m0 + (lane & 15), npx, H, W, WP, v_lo);  // this lane's A row
    float acc[64], sum[64];
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] = sum[e] = 0.f;
    for (int i = 0; i < n_ch; ++i) {  // chunk i: a chain of 9 CCH / 16 k16 steps
      const int s = i % nst, c0 = i * CCH;
      mbar_wait(&full[s], (i / nst) & 1);
      const unsigned char* Xs = base + s * stage_bytes + W_BYTES;
      const uint32_t wsa = smem_u32(base + s * stage_bytes);
#pragma unroll
      for (int st = 0; st < 9 * CB; ++st) {  // k16 steps in the mode's order
        const int tap = MODE == MODE_TAPS9 ? st / CB : st % 9;
        const int cb = MODE == MODE_TAPS9 ? st % CB : st / 9;
        if (st > 0 && c0 + 16 * cb >= C) continue;  // a block of channels past C
        uint32_t a[4];
        ldsm_x4(a, Xs + halo_off(hp + (tap / 3) * WP + tap % 3, 2 * cb + (lane >> 4), RC));
        wgmma_fence();
        wgmma_m64n128k16(acc, a, sw128_desc(wsa + (tap * CCH + 16 * cb) * 128, HALF, 1024),
                         st > 0);
        wgmma_commit();
        wgmma_wait<1>();
      }
      wgmma_wait<0>();  // the chain's sum added, the stage released
#pragma unroll
      for (int e = 0; e < 64; ++e) {
        fence_operand(acc[e]);
        sum[e] += acc[e];
      }
      mbar_arrive(&empty[s]);
    }

    // y rounded once: each warpgroup's 64 rows into shared memory (rows
    // g and g + 8 of a warp, columns 8 i + 2 t, + 1; a row Y_LD bytes, so
    // the lanes' pairs fall on 32 banks), then stored as 16-byte pieces of
    // rows in order
    const int g = lane >> 2, t = lane & 3;
    asm volatile("bar.sync 1, %0;\n" ::"n"(128 * S_CW) : "memory");  // every stage consumed
    unsigned char* ys = base + cw * 64 * Y_LD;
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<__nv_bfloat162*>(ys + (16 * warp + g + 8 * h) * Y_LD + 16 * i + 4 * t) =
            __floats2bfloat162_rn(sum[4 * i + 2 * h], sum[4 * i + 2 * h + 1]);
    asm volatile("bar.sync %0, 128;\n" ::"r"(2 + cw) : "memory");  // the warpgroup's rows
    for (int q = tid & 127; q < 64 * (S_BN / 8); q += 128) {  // row q / 16, channels 8 (q % 16) ..
      const long long p = p0 + 64 * cw + (q >> 4);
      const int co = co0 + 8 * (q & 15);
      if (p >= npx || co >= Cout) continue;
      const unsigned char* src = ys + (q >> 4) * Y_LD + 16 * (q & 15);
      if ((Cout & 7) == 0) {
        *reinterpret_cast<uint4*>(y + p * Cout + co) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int e = 0; e < 8 && co + e < Cout; ++e)
          y[p * Cout + co + e] = reinterpret_cast<const __nv_bfloat16*>(src)[e];
      }
    }
    const bool live[2] = {p0 + m0 + g < npx, p0 + m0 + g + 8 < npx};
    if (STATS) {  // a column's rows: the thread's two, its 8 lanes, the 8 warps in order
#pragma unroll
      for (int i = 0; i < 16; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float va = live[0] ? sum[4 * i + j] : 0.f, vb = live[1] ? sum[4 * i + 2 + j] : 0.f;
          float s1 = va + vb, s2 = fmaf(vb, vb, va * va);
#pragma unroll
          for (int off = 4; off < 32; off <<= 1) {
            s1 += __shfl_xor_sync(0xffffffffu, s1, off);
            s2 += __shfl_xor_sync(0xffffffffu, s2, off);
          }
          if (g == 0) {
            red[(0 * 4 * S_CW + 4 * cw + warp) * S_BN + 8 * i + 2 * t + j] = s1;
            red[(1 * 4 * S_CW + 4 * cw + warp) * S_BN + 8 * i + 2 * t + j] = s2;
          }
        }
      asm volatile("bar.sync 1, %0;\n" ::"n"(128 * S_CW) : "memory");  // the consumers only
      if (tid < 2 * S_BN) {
        const int which = tid / S_BN, col = tid % S_BN;
        float s = 0.f;
        for (int q = 0; q < 4 * S_CW; ++q) s += red[(which * 4 * S_CW + q) * S_BN + col];
        if (co0 + col < Cout) part[((long long)blockIdx.x * 2 + which) * Cout + co0 + col] = s;
      }
    }
  }
}

// ------------------------------------------------------------ f32 form

constexpr int F_BN = 64, F_THREADS = 256;  // a tile's output channels; threads
constexpr int F_TI = 8, F_TJ = 8;            // a thread's pixels and channels
constexpr int F_TX = F_BN / F_TJ;            // threads along the channels
constexpr int F_TY = F_THREADS / F_TX;       // threads along the pixels
constexpr int F_BM = F_TY * F_TI;            // a tile's output pixels
constexpr int F_CCH = 8;                 // channels a chunk (a halo pixel's floats)
constexpr int F_RED = 2 * 8 * F_BN * 4;  // the statistics' reduction [2][8 warps][F_BN]
constexpr int F_MAX_NST = 4;

// the halo's pixels a virtual row: W + 2, rounded up to 4 so that every row
// (a TMA box) starts 128-byte aligned
__host__ __device__ constexpr int f32_wp(int W) { return (W + 2 + 3) / 4 * 4; }

// a stage's floats: the weight rows [9 F_CCH][F_BN], then the halo [vr f32_wp(W)][F_CCH]
__host__ __device__ constexpr int f32_stage(int W, int vr) {
  return 9 * F_CCH * F_BN + vr * f32_wp(W) * F_CCH;
}

template <int MODE, bool STATS>
__global__ void __launch_bounds__(F_THREADS, 1)
    conv3x3_f32_kernel(const __grid_constant__ CUtensorMap tmw,
                       const __grid_constant__ CUtensorMap tmx, float* __restrict__ y,
                       float* __restrict__ part, int B, int H, int W, int C, int Cout, int nst,
                       int vr) {
  extern __shared__ __align__(16) unsigned char conv_smem[];
  float* smf = reinterpret_cast<float*>(conv_smem + ((128 - (smem_u32(conv_smem) & 127)) & 127));
  const int stage = f32_stage(W, vr), WP = f32_wp(W);
  float* red = smf + nst * stage;
  uint64_t* full = reinterpret_cast<uint64_t*>(red + 2 * 8 * F_BN);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = tid % F_TX, ty = tid / F_TX;  // channels 4 tx + 4 F_TX j; pixels ty + F_TY i
  const long long npx = (long long)B * H * W, p0 = (long long)blockIdx.x * F_BM;
  const int co0 = blockIdx.y * F_BN, n_ch = (C + F_CCH - 1) / F_CCH;
  int v_lo, n_vr;
  tile_halo(p0, F_BM, npx, H, W, v_lo, n_vr);
  int hp[F_TI];
#pragma unroll
  for (int i = 0; i < F_TI; ++i) hp[i] = halo_index(p0 + ty + F_TY * i, npx, H, W, WP, v_lo);

  auto load = [&](int i) {  // chunk i into stage i % nst by TMA (thread 0)
    if (i >= n_ch) return;
    float* Ws = smf + (i % nst) * stage;
    float* Xs = Ws + 9 * F_CCH * F_BN;
    const int c0 = i * F_CCH;
    mbar_expect_tx(&full[i % nst], (9 * F_CCH * F_BN + n_vr * (W + 2) * F_CCH) * 4);
    tma_load_3d(Ws, &tmw, co0, c0, 0, &full[i % nst]);  // the weight rows
    for (int r = 0; r < n_vr; ++r) {  // the halo, a virtual row (image n, row hh) a box
      const int v = v_lo + r, n = v / (H + 2), hh = v - n * (H + 2) - 1;
      tma_load_4d(Xs + r * WP * F_CCH, &tmx, c0, -1, hh, n, &full[i % nst]);
    }
  };
  if (tid == 0) {
    for (int s = 0; s < nst; ++s) mbar_init(&full[s], 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0)
    for (int s = 0; s < nst - 1; ++s) load(s);

  float acc[F_TI][F_TJ];
#pragma unroll
  for (int i = 0; i < F_TI; ++i)
#pragma unroll
    for (int j = 0; j < F_TJ; ++j) acc[i][j] = 0.f;
  for (int i = 0; i < n_ch; ++i) {
    __syncthreads();  // chunk i - 1's stage is free
    if (tid == 0) load(i + nst - 1);
    mbar_wait(&full[i % nst], (i / nst) & 1);  // chunk i landed
    const float* Ws = smf + (i % nst) * stage;
    const float* Xs = Ws + 9 * F_CCH * F_BN;
#pragma unroll
    for (int st = 0; st < 9 * F_CCH / 4; ++st) {  // steps of one tap x 4 channels, the mode's order
      const int tap = MODE == MODE_TAPS9 ? st / (F_CCH / 4) : st % 9;
      const int c4 = MODE == MODE_TAPS9 ? st % (F_CCH / 4) : st / 9;
      const int toff = (tap / 3) * WP + tap % 3;
      float4 a[F_TI];
#pragma unroll
      for (int ii = 0; ii < F_TI; ++ii)
        a[ii] = *reinterpret_cast<const float4*>(Xs + (hp[ii] + toff) * F_CCH + 4 * c4);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float* wr = Ws + (tap * F_CCH + 4 * c4 + q) * F_BN + 4 * tx;
        float bv[F_TJ];
#pragma unroll
        for (int j = 0; j < F_TJ / 4; ++j) {
          const float4 b = *reinterpret_cast<const float4*>(wr + 4 * F_TX * j);
          bv[4 * j] = b.x, bv[4 * j + 1] = b.y, bv[4 * j + 2] = b.z, bv[4 * j + 3] = b.w;
        }
#pragma unroll
        for (int ii = 0; ii < F_TI; ++ii) {
          const float av = q == 0 ? a[ii].x : q == 1 ? a[ii].y : q == 2 ? a[ii].z : a[ii].w;
#pragma unroll
          for (int j = 0; j < F_TJ; ++j) acc[ii][j] = fmaf(av, bv[j], acc[ii][j]);
        }
      }
    }
  }

  float s1[F_TJ] = {}, s2[F_TJ] = {};
#pragma unroll
  for (int ii = 0; ii < F_TI; ++ii) {
    const long long p = p0 + ty + F_TY * ii;
    if (p >= npx) continue;
    float* yp = y + p * Cout;
#pragma unroll
    for (int j4 = 0; j4 < F_TJ / 4; ++j4) {
      const int co = co0 + 4 * tx + 4 * F_TX * j4;
      if ((Cout & 3) == 0 && co + 3 < Cout) {
        *reinterpret_cast<float4*>(yp + co) = make_float4(
            acc[ii][4 * j4], acc[ii][4 * j4 + 1], acc[ii][4 * j4 + 2], acc[ii][4 * j4 + 3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (co + e < Cout) yp[co + e] = acc[ii][4 * j4 + e];
      }
    }
    if (STATS) {
#pragma unroll
      for (int j = 0; j < F_TJ; ++j) {
        s1[j] += acc[ii][j];
        s2[j] = fmaf(acc[ii][j], acc[ii][j], s2[j]);
      }
    }
  }
  if (STATS) {  // a channel's pixels: the thread's, the warp's lanes of its set, the warps in order
#pragma unroll
    for (int j = 0; j < F_TJ; ++j) {
#pragma unroll
      for (int off = F_TX; off < 32; off <<= 1) {
        s1[j] += __shfl_xor_sync(0xffffffffu, s1[j], off);
        s2[j] += __shfl_xor_sync(0xffffffffu, s2[j], off);
      }
      if (lane < F_TX) {
        const int col = 4 * tx + 4 * F_TX * (j >> 2) + (j & 3);
        red[(0 * 8 + warp) * F_BN + col] = s1[j];
        red[(1 * 8 + warp) * F_BN + col] = s2[j];
      }
    }
    __syncthreads();
    if (tid < 2 * F_BN) {
      const int which = tid / F_BN, col = tid % F_BN;
      float s = 0.f;
      for (int q = 0; q < 8; ++q) s += red[(which * 8 + q) * F_BN + col];
      if (co0 + col < Cout) part[((long long)blockIdx.x * 2 + which) * Cout + co0 + col] = s;
    }
  }
}

// ------------------------------------------------------ the bf16 stem kernel

constexpr int ST_THREADS = 256;
constexpr int ST_BM = 128;                   // a tile's output pixels (8 warps x m16)
constexpr int ST_BN = 64;                    // a block's output channels
constexpr int ST_KP = 64;                    // K rows the A tile holds: 9 C <= 63, in k16 steps
constexpr int ST_Y_LD = ST_BN * 2 + 16;      // a y row's bytes in shared memory
constexpr int ST_BLOCKS = 2 * 132;           // persistent blocks: two on each SM of the H100
constexpr int ST_RED = 2 * 8 * ST_BN * 4;    // the statistics' reduction [2][8 warps][ST_BN]

// bytes of a halo stage: x's elements from pixel p0 - W - 1 to p0 + ST_BM +
// W, in 16-byte pieces (the first and last partly outside)
__host__ __device__ constexpr int stem_halo_bytes(int W, int C) {
  return ((ST_BM + 2 * W + 2) * C + 15) / 8 * 16;
}

// the stem kernel's shared memory: the weights [ST_KP][ST_BN], the A tile
// [ST_BM][ST_KP], the y tile, two halo stages, the K table, the reduction
__host__ __device__ constexpr int stem_smem(int W, int C) {
  return ST_KP * ST_BN * 2 + ST_BM * ST_KP * 2 + ST_BM * ST_Y_LD + 2 * stem_halo_bytes(W, C) +
         ST_KP * 8 + ST_RED;
}

// K row k of the mode's order: its tap and channel (tap -1 past 9 C)
template <int MODE>
__device__ __forceinline__ void stem_k(int k, int C, int& tap, int& c) {
  tap = -1, c = 0;
  if (k >= 9 * C) return;
  if (MODE == MODE_TAPS9)
    tap = k / C, c = k - tap * C;
  else
    c = k / 9, tap = k - c * 9;
}

// 16 bytes from global src to shared dst, of which the first n come from
// src and the rest are zeros
__device__ __forceinline__ void cp_async_cg_n(void* dst, const void* src, int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(n)
               : "memory");
}

// The stem (bf16, C < 8: x read at its own C, no padded copy): persistent
// blocks over tiles of ST_BM output pixels in order over B * H * W (block
// x a contiguous range of them) x ST_BN output channels (block y). A tile
// stages the x its halo spans (pixels p0 - W - 1 .. p0 + ST_BM + W,
// contiguous in x) by 16-byte cp.async, the next tile's under this tile's
// work: one block barrier a tile. Past it each warp works alone on its 16
// pixels: builds their K vectors (9 C values in the mode's order, zeros to
// a whole k16 step and for the SAME padding) into its rows of the A tile,
// multiplies them by the 64 channels' weights on mma.sync m16n8k16 (each
// output one chain of its k16 steps), rounds y once into its rows of the y
// tile and stores them as 16-byte pieces of whole pixel rows (a warp's 2 KB
// of y one contiguous range at Cout = 64); the statistics summed over the
// block's tiles in registers.
template <int MODE, bool STATS>
__global__ void __launch_bounds__(ST_THREADS, 2)
    conv3x3_stem_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                        __nv_bfloat16* __restrict__ y, float* __restrict__ part, int B, int H,
                        int W, int C, int Cout, int hb) {
  extern __shared__ __align__(16) unsigned char conv_smem[];
  unsigned char* Ws = conv_smem;                     // [ST_KP][ST_BN], swizzled (8 chunks a row)
  unsigned char* As = Ws + ST_KP * ST_BN * 2;        // [ST_BM][ST_KP], swizzled
  unsigned char* Ys = As + ST_BM * ST_KP * 2;        // [ST_BM][ST_Y_LD]
  unsigned char* Xs = Ys + ST_BM * ST_Y_LD;          // two halo stages of hb bytes
  int2* kt = reinterpret_cast<int2*>(Xs + 2 * hb);  // [ST_KP]: element offset, tap
  float* red = reinterpret_cast<float*>(kt + ST_KP);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const long long HW = (long long)H * W, npx = B * HW, n_el = npx * C;
  const long long n_tiles = (npx + ST_BM - 1) / ST_BM;
  const long long t_lo = n_tiles * blockIdx.x / gridDim.x;
  const long long t_hi = n_tiles * (blockIdx.x + 1) / gridDim.x;
  const int co0 = blockIdx.y * ST_BN, KS = (9 * C + 15) / 16;  // k16 steps

  // the K table (x's offset from the pixel's own element, its tap) and the
  // block's weight rows, zeros past 9 C and Cout
  for (int k = tid; k < ST_KP; k += ST_THREADS) {
    int tap, c;
    stem_k<MODE>(k, C, tap, c);
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    kt[k] = make_int2((dy * W + dx) * C + c, tap);
  }
  for (int i = tid; i < ST_KP * ST_BN; i += ST_THREADS) {
    const int k = i / ST_BN, co = i % ST_BN;
    int tap, c;
    stem_k<MODE>(k, C, tap, c);
    const bool ok = tap >= 0 && co0 + co < Cout;
    *reinterpret_cast<__nv_bfloat16*>(Ws + swz(k, co, ST_BN / 8)) =
        ok ? w[((long long)tap * C + c) * Cout + co0 + co] : __float2bfloat16_rn(0.f);
  }
  // a tile's first staged element: x's 16-byte piece at or below pixel p0 - W - 1
  auto halo_e0 = [&](long long tile) {
    const long long qa = tile * ST_BM - W - 1;
    return (qa < 0 ? 0 : qa * C) / 8 * 8;
  };
  auto stage = [&](long long tile, int buf) {
    const long long e0 = halo_e0(tile), qb = tile * ST_BM + ST_BM + W + 1;
    const long long e1 = (qb < npx ? qb : npx) * C;
    unsigned char* dst = Xs + buf * hb;
    for (int i = tid; 8LL * i < e1 - e0; i += ST_THREADS) {
      const long long e = e0 + 8LL * i;
      cp_async_cg_n(dst + 16 * i, x + e, n_el - e < 8 ? (int)(n_el - e) * 2 : 16);
    }
  };

  float s1[8][2] = {}, s2[8][2] = {};
  if (t_lo < t_hi) stage(t_lo, 0);
  cp_async_commit();
  for (long long tile = t_lo; tile < t_hi; ++tile) {
    const int buf = (int)((tile - t_lo) & 1);
    cp_async_wait<0>();
    __syncthreads();  // this tile's halo landed; every warp is done with the last tile
    if (tile + 1 < t_hi) stage(tile + 1, buf ^ 1);  // under this tile's work
    cp_async_commit();

    // the warp's 16 rows of the A tile: pixel r's K vector, 8 k a lane a
    // step (lanes l and l + 16 of pixel 16 warp + l)
    const long long p0 = tile * ST_BM, e0 = halo_e0(tile);
    {
      const int r = 16 * warp + (lane & 15);
      const long long p = p0 + r;
      int mask = 0;  // the taps inside the image
      int pe = 0;
      if (p < npx) {
        const unsigned pu = (unsigned)p, hw = (unsigned)HW;
        const int n = (int)(pu / hw), rem = (int)(pu - n * hw), h = rem / W, wc = rem - h * W;
        const int rows = (h > 0) | 2 | ((h < H - 1) << 2);
        const int cols = (wc > 0) | 2 | ((wc < W - 1) << 2);
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
          if ((rows >> dy) & 1) mask |= cols << (3 * dy);
        pe = (int)(p * C - e0);
      }
      const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(Xs + buf * hb);
      for (int ch = lane >> 4; ch < 2 * KS; ch += 2) {
        __align__(16) __nv_bfloat16 v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int2 te = kt[8 * ch + e];
          v[e] = te.y >= 0 && ((mask >> te.y) & 1) ? xs[pe + te.x] : __float2bfloat16_rn(0.f);
        }
        *reinterpret_cast<uint4*>(As + swz(r, 8 * ch, ST_KP / 8)) =
            *reinterpret_cast<const uint4*>(v);
      }
    }
    __syncwarp();

    float acc[8][4] = {};
    for (int ks = 0; ks < KS; ++ks) {  // the k16 steps in order, chained in the accumulator
      uint32_t a[4];
      load_a(a, As, ST_KP / 8, 16 * warp, ks);
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        uint32_t b[4];
        load_b_kn(b, Ws, ST_BN / 8, 16 * nj, ks);
        mma_bf16(acc[2 * nj], a, b[0], b[1]);
        mma_bf16(acc[2 * nj + 1], a, b[2], b[3]);
      }
    }
    // y rounded once into the warp's y rows (pixel 16 warp + g + 8 h,
    // channels 8 i + 2 t, + 1); the statistics of the f32 sums
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * warp + g + 8 * h;
      const bool live = p0 + r < npx;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float v0 = acc[i][2 * h], v1 = acc[i][2 * h + 1];
        *reinterpret_cast<__nv_bfloat162*>(Ys + r * ST_Y_LD + 16 * i + 4 * t) =
            __floats2bfloat162_rn(v0, v1);
        if (STATS && live) {
          s1[i][0] += v0;
          s1[i][1] += v1;
          s2[i][0] = fmaf(v0, v0, s2[i][0]);
          s2[i][1] = fmaf(v1, v1, s2[i][1]);
        }
      }
    }
    __syncwarp();
    // row 16 warp + q / 8 of the tile, channels 8 (q % 8) ..
    for (int q = lane; q < 16 * (ST_BN / 8); q += 32) {
      const int r = 16 * warp + (q >> 3);
      const long long p = p0 + r;
      const int co = co0 + 8 * (q & 7);
      if (p >= npx || co >= Cout) continue;
      const unsigned char* src = Ys + r * ST_Y_LD + 16 * (q & 7);
      if ((Cout & 7) == 0) {
        *reinterpret_cast<uint4*>(y + p * Cout + co) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int e = 0; e < 8 && co + e < Cout; ++e)
          y[p * Cout + co + e] = reinterpret_cast<const __nv_bfloat16*>(src)[e];
      }
    }
  }
  cp_async_wait<0>();
  if (STATS) {  // a channel's pixels: the thread's, its 8 lanes, the 8 warps in order
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          s1[i][j] += __shfl_xor_sync(0xffffffffu, s1[i][j], off);
          s2[i][j] += __shfl_xor_sync(0xffffffffu, s2[i][j], off);
        }
        if (g == 0) {
          red[(0 * 8 + warp) * ST_BN + 8 * i + 2 * t + j] = s1[i][j];
          red[(1 * 8 + warp) * ST_BN + 8 * i + 2 * t + j] = s2[i][j];
        }
      }
    __syncthreads();
    if (tid < 2 * ST_BN) {
      const int which = tid / ST_BN, col = tid % ST_BN;
      float sum = 0.f;
      for (int q = 0; q < 8; ++q) sum += red[(which * 8 + q) * ST_BN + col];
      if (co0 + col < Cout) part[((long long)blockIdx.x * 2 + which) * Cout + co0 + col] = sum;
    }
  }
}

// stats [2][Cout] = the partials [n_blocks][2][Cout] summed in block order:
// a warp an output, lane l the blocks [l r, (l + 1) r) in order, then the 32
// runs in order (a fixed order, so the same bits on every run)
__global__ void conv3x3_stats_merge_kernel(const float* __restrict__ part,
                                           float* __restrict__ stats, int n_blocks, int Cout) {
  const int i = (blockIdx.x * blockDim.x + threadIdx.x) >> 5, lane = threadIdx.x & 31;
  if (i >= 2 * Cout) return;
  const int r = (n_blocks + 31) / 32, lo = lane * r, hi = min(n_blocks, lo + r);
  float s = 0.f;
  for (int b = lo; b < hi; ++b) s += part[(long long)b * 2 * Cout + i];
  float total = 0.f;
  for (int l = 0; l < 32; ++l) total += __shfl_sync(0xffffffffu, s, l);
  if (lane == 0) stats[i] = total;
}

// --------------------------------------------------------------- geometry

// The launch of one conv, as ops/conv3x3.py: conv_geometry computes it:
// the kernel, its grid, dynamic shared memory, statistics partials, w's row
// stride, and its plan (resident: tr, n_st; streamed: cch, nst, vr; f32:
// nst, vr; stem: a halo stage's bytes). false where no plan fits the
// shared memory.
struct Geometry {
  int kind, gx, gy, smem, n_parts, wld, p0, p1, p2;
};

bool conv_geometry(int bf16, int B, int H, int W, int C, int Cout, int strip, Geometry& g) {
  const long long npx = (long long)B * H * W;
  const int wld = (Cout + 7) / 8 * 8;  // the new kernels' 16-byte pieces of a w row
  if (bf16 && C < 8) {  // the stem: ST_BLOCKS persistent blocks over the tiles
    const long long n_tiles = (npx + ST_BM - 1) / ST_BM;
    const int gy = (Cout + ST_BN - 1) / ST_BN, per = ST_BLOCKS / gy > 1 ? ST_BLOCKS / gy : 1;
    const int gx = (int)(n_tiles < per ? n_tiles : per);
    g = {KIND_STEM, gx, gy, stem_smem(W, C), gx, Cout, stem_halo_bytes(W, C), 0, 0};
    return stem_smem(W, C) <= BF16_MAX_SMEM && npx < (1LL << 31);  // 32-bit pixel indices
  }
  if (!bf16) {
    const int vr = halo_rows(H, W, F_BM), tail = 128 + F_RED + 8 * F_MAX_NST;  // align, red, bars
    int nst = F_MAX_NST;
    while (nst >= 2 && nst * f32_stage(W, vr) * 4 + tail > BF16_MAX_SMEM) --nst;
    g = {KIND_F32, (int)((npx + F_BM - 1) / F_BM), (Cout + F_BN - 1) / F_BN,
         nst * f32_stage(W, vr) * 4 + tail, (int)((npx + F_BM - 1) / F_BM), wld, nst, vr, 0};
    return nst >= 2 && W + 2 <= 256;  // a halo row is one TMA box
  }
  int tr, n_st;
  resident_plan(C, W, strip, tr, n_st);
  if (tr > 0) {
    g = {KIND_RESIDENT, B * (H / strip), (Cout + BN - 1) / BN, bf16_smem(C, W, tr, n_st),
         B * (H / strip), Cout, tr, n_st, 0};
    return true;
  }
  const int vr = halo_rows(H, W, S_BM);
  if (W + 2 > 256) return false;  // a halo row is one TMA box
  for (int cch = 32; cch >= 16; cch /= 2) {
    const int nst = min(S_MAX_NST, (BF16_MAX_SMEM - S_TAIL) / stream_stage(cch, W, vr));
    g = {KIND_STREAMED, (int)((npx + S_BM - 1) / S_BM), (Cout + S_BN - 1) / S_BN,
         nst * stream_stage(cch, W, vr) + S_TAIL, (int)((npx + S_BM - 1) / S_BM), wld, cch, nst,
         vr};
    if (nst >= 2) return true;
  }
  return false;
}

// the tensor maps of the streamed and f32 kernels: w [9][C][wld] in boxes
// [9][cch][64], x [B][H][W][C] in boxes [1][1][W + 2][cch]; outside the
// tensors, zeros. bf16: w 128-byte swizzled, x 64-byte (cch = 32) or
// 32-byte (16); f32 (cch = 8): not swizzled
bool tensor_maps(CUtensorMap& tmw, CUtensorMap& tmx, const void* w, const void* x, bool bf16,
                 int B, int H, int W, int C, int wld, int cch) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t item = bf16 ? 2 : 4;
  const CUtensorMapDataType type =
      bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const cuuint64_t wdim[3] = {(cuuint64_t)wld, (cuuint64_t)C, 9};
  const cuuint64_t wstr[2] = {(cuuint64_t)wld * item, (cuuint64_t)C * wld * item};
  const cuuint32_t wbox[3] = {64, (cuuint32_t)cch, 9}, ones[4] = {1, 1, 1, 1};
  const cuuint64_t xdim[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t xstr[3] = {(cuuint64_t)C * item, (cuuint64_t)W * C * item,
                              (cuuint64_t)H * W * C * item};
  const cuuint32_t xbox[4] = {(cuuint32_t)cch, (cuuint32_t)W + 2, 1, 1};
  const CUtensorMapSwizzle wsw = bf16 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE;
  const CUtensorMapSwizzle xsw = !bf16 ? CU_TENSOR_MAP_SWIZZLE_NONE
                                 : cch == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                             : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(&tmw, type, 3, const_cast<void*>(w), wdim, wstr, wbox, ones,
                CU_TENSOR_MAP_INTERLEAVE_NONE, wsw, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS &&
         encode(&tmx, type, 4, const_cast<void*>(x), xdim, xstr, xbox, ones,
                CU_TENSOR_MAP_INTERLEAVE_NONE, xsw, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int MODE, bool STATS>
cudaError_t launch_kind(const Geometry& g, const void* x, const void* w, void* y, float* part,
                        int B, int H, int W, int C, int Cout, int strip, cudaStream_t st) {
  const dim3 grid((unsigned)g.gx, (unsigned)g.gy);
  cudaError_t err = cudaSuccess;
  auto smem_for = [&](const void* kernel) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);
    return err == cudaSuccess;
  };
  CUtensorMap tmw, tmx;
  if (g.kind == KIND_F32) {
    auto kernel = conv3x3_f32_kernel<MODE, STATS>;
    if (!tensor_maps(tmw, tmx, w, x, false, B, H, W, C, g.wld, F_CCH)) return cudaErrorInvalidValue;
    if (!smem_for((const void*)kernel)) return err;
    kernel<<<grid, F_THREADS, g.smem, st>>>(tmw, tmx, (float*)y, part, B, H, W, C, Cout, g.p0,
                                            g.p1);
    return cudaGetLastError();
  }
  __nv_bfloat16* yb = (__nv_bfloat16*)y;
  if (g.kind == KIND_STEM) {
    auto kernel = conv3x3_stem_kernel<MODE, STATS>;
    if (!smem_for((const void*)kernel)) return err;
    kernel<<<grid, ST_THREADS, g.smem, st>>>((const __nv_bfloat16*)x, (const __nv_bfloat16*)w, yb,
                                             part, B, H, W, C, Cout, g.p0);
    return cudaGetLastError();
  }
  if (g.kind == KIND_RESIDENT) {
    auto kernel = conv3x3_bf16_kernel<MODE, STATS>;
    if (!smem_for((const void*)kernel)) return err;
    kernel<<<grid, THREADS, g.smem, st>>>((const __nv_bfloat16*)x, (const __nv_bfloat16*)w, yb,
                                          part, H, W, C, Cout, strip, g.p0, g.p1);
    return cudaGetLastError();
  }
  if (!tensor_maps(tmw, tmx, w, x, true, B, H, W, C, g.wld, g.p0)) return cudaErrorInvalidValue;
  auto kernel = g.p0 == 32 ? conv3x3_bf16_stream_kernel<MODE, STATS, 32>
                           : conv3x3_bf16_stream_kernel<MODE, STATS, 16>;
  if (!smem_for((const void*)kernel)) return err;
  kernel<<<grid, S_THREADS, g.smem, st>>>(tmw, tmx, yb, part, B, H, W, C, Cout, g.p1, g.p2);
  return cudaGetLastError();
}

template <bool STATS>
cudaError_t launch_mode(const Geometry& g, int mode, const void* x, const void* w, void* y,
                        float* part, int B, int H, int W, int C, int Cout, int strip,
                        cudaStream_t st) {
  return mode == MODE_TAPS9
             ? launch_kind<MODE_TAPS9, STATS>(g, x, w, y, part, B, H, W, C, Cout, strip, st)
             : launch_kind<MODE_IM2COL, STATS>(g, x, w, y, part, B, H, W, C, Cout, strip, st);
}

}  // namespace

extern "C" {

const char* conv3x3_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// the launch geometry (out[9]: kind 0 f32 / 1 resident / 2 streamed / 3 stem, grid
// x and y, shared memory, statistics partials, w's row stride, the plan's
// three numbers); returns 0, or cudaErrorInvalidValue where nothing fits
int conv3x3_geometry(int x_bf16, int B, int H, int W, int C, int Cout, int strip, int* out) {
  Geometry g;
  const bool ok = conv_geometry(x_bf16, B, H, W, C, Cout, strip, g);
  const int v[9] = {g.kind, g.gx, g.gy, g.smem, g.n_parts, g.wld, g.p0, g.p1, g.p2};
  for (int i = 0; i < 9; ++i) out[i] = v[i];
  return ok ? 0 : (int)cudaErrorInvalidValue;
}

// y = conv3x3(x, w); with stats (part and stats non-null): part is
// [n_parts][2][Cout] f32 scratch (conv3x3_geometry), stats [2][Cout] f32
// (sum, sum of squares). x_bf16 selects the element type of x, w and y;
// mode 0 = taps9, 1 = im2col; strip divides H (the resident kernel's
// blocks); w's rows are wld long (conv3x3_geometry).
int conv3x3_launch(const void* x, const void* w, void* y, float* part, float* stats, int x_bf16,
                   int mode, int B, int H, int W, int C, int Cout, int strip, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  Geometry g;
  if ((x_bf16 ? C >= 8 && C % 8 : C % 4) || !conv_geometry(x_bf16, B, H, W, C, Cout, strip, g))
    return (int)cudaErrorInvalidValue;  // the wrapper pads C (bf16: from 8 up)
  const bool with_stats = stats != nullptr;
  cudaError_t err =
      with_stats ? launch_mode<true>(g, mode, x, w, y, part, B, H, W, C, Cout, strip, st)
                 : launch_mode<false>(g, mode, x, w, y, part, B, H, W, C, Cout, strip, st);
  if (err != cudaSuccess || !with_stats) return (int)err;
  conv3x3_stats_merge_kernel<<<(2 * Cout + 3) / 4, 128, 0, st>>>(part, stats, g.n_parts, Cout);
  return (int)cudaGetLastError();
}

}  // extern "C"
