// Tensor-core building blocks of the port's bf16 kernels (conv3x3.cu,
// quad_margin.cu, margin_ce.cu) for NVIDIA Hopper (sm_90a): 16-byte cp.async copies into
// shared memory (zero-filled where the source lies outside the tensor),
// ldmatrix fragment loads, and the warp-wide mma.sync m16n8k16 product of
// bf16 operands into f32 accumulators.
//
// Shared-memory layout. Operands are staged as bf16, row-major, each row a
// whole number of 16-byte chunks (8 values); a row has rc chunks. Chunk ch
// of row r is stored at chunk r * rc + (ch ^ (r & 7)) (`swz`) where rc is a
// multiple of 8, so the eight consecutive rows that one ldmatrix address
// group reads fall in eight different bank groups: the loads are free of
// bank conflicts (conv3x3.cu's halo rows of fewer chunks XOR fewer bits).
//
// Products. A bf16 x bf16 product is exact in f32; the tensor core sums the
// 16 products of one k16 step and the accumulator it is given, aligned to
// the largest of them and truncated, so a long chain kept in the tensor
// core's accumulator drifts by up to an f32 spacing of the running sum per
// step, all one way. `mma_nt` therefore takes each step's product from a
// zero accumulator (off by at most a spacing of its largest product) and
// adds it to the sum with an f32 add, rounded to nearest. Each output
// element is a chain over the k16 steps in the order the caller walks them,
// so two kernels that walk the same steps in the same order from a zero
// sum produce the same bits, whatever their tiling (the forward and the
// backward of quad_margin.cu and of margin_ce.cu rely on this).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// byte offset of element (r, c) in a swizzled bf16 matrix of rc chunks a
// row; m = 7 for rc a multiple of 8, else below rc's lowest set bit (the
// chunk stays in its row, the spread over the banks as wide as rc allows)
__device__ __forceinline__ int swz(int r, int c, int rc, int m = 7) {
  return ((r * rc + ((c >> 3) ^ (r & m))) << 4) + ((c & 7) << 1);
}

// 16 bytes from global src to shared dst; zeros where !valid (src is then
// not read, but must still be a mapped address). CG: through L2 only, for
// data read once; CA: also through L1, for data the block reads again.
__device__ __forceinline__ void cp_async_cg(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_ca(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// d += a . b for one m16n8k16 tile: a the A fragment (rows g, g + 8; k 2t,
// 2t + 1, 2t + 8, 2t + 9), b0 / b1 the B fragment (k 2t, 2t + 1 / 2t + 8,
// 2t + 9; column g); d[0..1] row g, columns 2t, 2t + 1, d[2..3] row g + 8
// (g = lane / 4, t = lane % 4)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a . b for one m16n8k16 tile, from a zero accumulator
__device__ __forceinline__ void mma_bf16_0(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                           uint32_t b1) {
  const float z = 0.f;
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(z));
}

// acc[j] += a . b[0..1] and acc[j + 1] += a . b[2..3] (two n8 tiles, the
// B fragments as load_b_kn gives them), each product from a zero
// accumulator and added in f32 (header)
template <int NJ>
__device__ __forceinline__ void mma_add(float (&acc)[NJ][4], int j, const uint32_t (&a)[4],
                                        const uint32_t (&b)[4]) {
  float p0[4], p1[4];
  mma_bf16_0(p0, a, b[0], b[1]);
  mma_bf16_0(p1, a, b[2], b[3]);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    acc[j][e] += p0[e];
    acc[j + 1][e] += p1[e];
  }
}

// the A fragment of rows m0 .. m0 + 15, k16 step ks, of a swizzled [m][k]
// matrix with rc chunks a row
__device__ __forceinline__ void load_a(uint32_t (&r)[4], const unsigned char* A, int rc, int m0,
                                       int ks) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(r, A + swz(m0 + (lane & 15), ks * 16 + (lane >> 4) * 8, rc));
}

// the A fragment of rows m0 .. m0 + 15, k16 step ks, of the product A . B
// where A is stored transposed: a swizzled [k][m] matrix with rc chunks a row
__device__ __forceinline__ void load_a_t(uint32_t (&r)[4], const unsigned char* At, int rc, int m0,
                                         int ks) {
  const int lane = threadIdx.x & 31;
  ldsm_x4_t(r, At + swz(ks * 16 + (lane & 7) + ((lane >> 4) << 3), m0 + ((lane >> 3) & 1) * 8, rc));
}

// acc[mi][ni] += sum over k16 steps ks in [0, n_ks), in order, of
// A[m0 + 16 mi + .., ks] . B[n0 + 8 ni + .., ks]: A [m][k] and B [n][k] both
// row-major in k (the product A . B^T), swizzled with rca / rcb chunks a row;
// each step's product added to acc in f32 (header)
template <int MI, int NI>
__device__ __forceinline__ void mma_nt(float (&acc)[MI][NI][4], const unsigned char* A, int rca,
                                       int m0, const unsigned char* B, int rcb, int n0,
                                       int n_ks) {
  static_assert(NI % 2 == 0, "B fragments load two n8 tiles at a time");
  const int lane = threadIdx.x & 31;
#pragma unroll 4
  for (int ks = 0; ks < n_ks; ++ks) {
    uint32_t a[MI][4];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) load_a(a[mi], A, rca, m0 + 16 * mi, ks);
#pragma unroll
    for (int nj = 0; nj < NI / 2; ++nj) {
      uint32_t b[4];
      ldsm_x4(b, B + swz(n0 + 16 * nj + (lane & 7) + (lane >> 4) * 8,
                         ks * 16 + ((lane >> 3) & 1) * 8, rcb));
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        float p0[4], p1[4];
        mma_bf16_0(p0, a[mi], b[0], b[1]);
        mma_bf16_0(p1, a[mi], b[2], b[3]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[mi][2 * nj][e] += p0[e];
          acc[mi][2 * nj + 1][e] += p1[e];
        }
      }
    }
  }
}

// the two B fragments of n8 tiles n0 and n0 + 8 at k16 step ks of a swizzled
// [k][n] matrix (row-major in n) with rc chunks a row: b[0..1] tile n0,
// b[2..3] tile n0 + 8
__device__ __forceinline__ void load_b_kn(uint32_t (&b)[4], const unsigned char* B, int rc, int n0,
                                          int ks) {
  const int lane = threadIdx.x & 31;
  ldsm_x4_t(b, B + swz(ks * 16 + (lane & 15), n0 + (lane >> 4) * 8, rc));
}

}  // namespace
